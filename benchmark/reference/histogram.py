"""Plain reference for `histogram_640x480` (BASELINE.md config 1, the
upstream tutorial's `Histogram` over every frame): per frame and
channel, the 16-bin histogram of the uint8 values, bin = (16 v) // 256,
as int64 counts.  Plain PyTorch; imports nothing of the program.

What is compared: every row that every job of the window stored, against
the reference's counts of the same frame.  Counts are exact integers,
so the limit is 0 rows that differ (a missing row counts as differing).

The control is the same counting with its accumulator in bfloat16, the
step below the float32 in which counts up to 2^24 are still exact: a
count past 256 no longer moves by one, so every row differs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

LIMITS = {"hist_rows_wrong": 0}
BLOCK = 32          # frames counted at once on the device


def prepare(config: Dict, seed: int, device, workdir: str) -> Dict:
    """Nothing beside the frames: the op takes no weights or tables."""
    return {}


def counts(frames: torch.Tensor, bins: int,
           acc: torch.dtype = torch.int64) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, C, bins) counts, accumulated in `acc`."""
    b, _, _, c = frames.shape
    bin_ = (frames.to(torch.int64) * bins) // 256
    base = (torch.arange(b, device=frames.device)[:, None, None, None] * c
            + torch.arange(c, device=frames.device)) * bins
    ids = (base + bin_).reshape(-1)
    if acc == torch.int64:
        out = torch.bincount(ids, minlength=b * c * bins)
    else:
        out = torch.zeros(b * c * bins, dtype=acc, device=frames.device)
        out.index_add_(0, ids, torch.ones(ids.numel(), dtype=acc,
                                          device=frames.device))
    return out.reshape(b, c, bins)


def reference_counts(config: Dict, frames: np.ndarray, device,
                     acc: torch.dtype = torch.int64) -> np.ndarray:
    bins = int(config["bins"])
    out = []
    for i in range(0, len(frames), BLOCK):
        x = torch.from_numpy(frames[i:i + BLOCK]).to(device)
        out.append(counts(x, bins, acc).to(torch.float64).cpu().numpy())
    return np.concatenate(out)


def compare(config: Dict, prepared: Dict, frames: np.ndarray,
            results: Sequence[Tuple[Tuple[int, int], List]],
            device) -> Dict[str, Tuple[float, float]]:
    """{number: (value, limit)} for the jobs' stored rows: `results`
    holds each job's (start, end) clip and its rows in order."""
    ref = reference_counts(config, frames, device)
    wrong = 0
    for (start, end), rows in results:
        want = ref[start:end]
        wrong += abs(len(rows) - len(want))
        for got, exp in zip(rows, want):
            got = np.asarray(got)
            if got.shape != exp.shape or not np.array_equal(got, exp):
                wrong += 1
    return {"hist_rows_wrong": (float(wrong), LIMITS["hist_rows_wrong"])}


def control_results(config: Dict, prepared: Dict, frames: np.ndarray,
                    clips: Sequence[Tuple[int, int]], device) -> List:
    """The control in the program's place: rows counted in bfloat16."""
    low = reference_counts(config, frames, device, acc=torch.bfloat16)
    return [(c, list(low[c[0]:c[1]])) for c in clips]
