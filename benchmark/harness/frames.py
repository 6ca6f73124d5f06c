"""The stored frames every cell reads, made from the seed.

A frozen copy of `chip_smoke.py` `make_frames` and of the pattern it
draws, `scanner_tpu_torch/video/ingest.py` `frame_pattern` (both as of
commit 093baf35): per frame i, R = (16 i) mod 224, G a gradient 0..239
across the width, B a square of side max(4, H/8) at 230 in the top
rows, moving 5 pixels a frame; plus noise uniform in [0, 16) on every
pixel and channel.  The largest value is 239 + 15, so nothing clips.
Made in one call on the device with a generator seeded by `--seed`
(the original used numpy's RandomState frame by frame).
"""

from __future__ import annotations

import numpy as np
import torch


def make_frames(n: int, height: int, width: int, seed: int,
                device) -> torch.Tensor:
    """(n, height, width, 3) uint8 frames on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = torch.randint(0, 16, (n, height, width, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    i = torch.arange(n, device=device)
    out[..., 0] += ((i * 16) % 224).to(torch.uint8)[:, None, None]
    ramp = torch.from_numpy(np.linspace(0, 239, width, dtype=np.uint8))
    out[..., 1] += ramp.to(device)[None, None, :]
    sq = max(4, height // 8)
    x = (i * 5) % max(1, width - sq)
    cols = torch.arange(width, device=device)
    square = (cols[None, :] >= x[:, None]) & (cols[None, :] < x[:, None] + sq)
    out[:, :sq, :, 2] += (square.to(torch.uint8) * 230)[:, None, :]
    return out
