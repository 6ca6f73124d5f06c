"""Shot-boundary detection kernels.

Capability parity: the reference's shot_detection example app
(examples/README.md walkthrough): color-histogram + temporal difference +
threshold.  Here the temporal difference is a stencil op, so the engine's
exact-row scheduling decodes only the frames each boundary test needs.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..common import DeviceType, FrameType
from ..graph.ops import Kernel, register_op
from ..util.coststats import CostDescriptor
from .imgproc import HISTOGRAM_BINS, _frame_shape, histogram


@register_op(device=DeviceType.TPU, stencil=[-1, 0], batch=16)
class HistDiff(Kernel):
    """L1 distance between the color histograms of consecutive frames.

    Convenient single-op form; each frame's histogram is computed twice
    (as `cur` and again as the next row's `prev`).  The cheaper composition
    is Histogram -> HistogramDelta: the engine's stencil element cache
    reuses each histogram, and the stencil data shrinks from full frames to
    3x16 ints."""

    def cost(self, shapes):
        """Two histograms over the (b, 2, ...) stencil window (bins+2
        flops per input element, the Histogram model) plus the per-row
        L1 over 2 * C * bins histogram cells, where C is the trailing
        channel axis.  Reads the window once, emits one float per row
        (the JAX package's model, for the classic (b, 2, H, W, C) frame
        window and for any array window, e.g. Histogram rows)."""
        s = _frame_shape(shapes)
        if s is None or len(s) < 3:
            return None
        b, c = s[0], s[-1]
        px = 1
        for d in s:
            px *= d
        flops = px * (HISTOGRAM_BINS + 2) + b * 2 * c * HISTOGRAM_BINS
        return CostDescriptor(flops=float(flops), bytes_in=float(px),
                              bytes_out=float(b * 8))

    def execute_traced(self, frame):
        """(batch, 2, ..., C) integer window in, (batch,) float32 L1
        distances out, as the JAX package computes them: the trailing
        axis is the channel axis and each member's values are binned by
        (v * 16) // 256 (imgproc.histogram), so a window of uint8
        frames gives colour histograms and a window of Histogram rows
        (batch, 2, 3, 16) bins the counts themselves.  Both members'
        histograms come from one histogram call where the window lives.
        The counts are exact small integers, so the float32 L1 sums are
        exact and the host conversion in finish() is bit-stable."""
        b, c = frame.shape[0], frame.shape[-1]
        flat = frame.reshape((2 * b,) + tuple(frame.shape[2:]))
        h = torch.as_tensor(histogram(flat)).to(
            torch.float32).reshape(b, 2, c, HISTOGRAM_BINS)
        return (h[:, 0] - h[:, 1]).abs().sum(dim=(1, 2))

    def finish(self, result):
        """Host tail: the per-row float list execute() always returned."""
        return [float(x) for x in result.cpu().tolist()]

    def execute(self, frame: Sequence[Sequence[FrameType]]
                ) -> Sequence[Any]:
        from ..engine.batch import is_array_data
        if not is_array_data(frame):
            # per-row window lists (host path): stack to (batch, 2, ...)
            frame = np.stack([np.stack([w[0], w[1]]) for w in frame])
        return self.finish(self.execute_traced(frame))


@register_op(stencil=[-1, 0])
class HistogramDelta(Kernel):
    """L1 distance between consecutive rows of a Histogram stream — the
    efficient shot-detection primitive (each histogram computed once)."""

    def execute(self, hist: Sequence[Any]) -> Any:
        prev = np.concatenate([np.asarray(c) for c in hist[0]]).astype(
            np.float64)
        cur = np.concatenate([np.asarray(c) for c in hist[1]]).astype(
            np.float64)
        return float(np.abs(prev - cur).sum())


@register_op()
class ShotBoundary(Kernel):
    """Thresholds a HistDiff stream into 0/1 boundary flags."""

    def __init__(self, config, threshold: float = 0.0):
        super().__init__(config)
        self.threshold = float(threshold)

    def new_stream(self, threshold: float = None):
        if threshold is not None:
            self.threshold = float(threshold)

    def execute(self, diff: Any) -> Any:
        return bool(diff > self.threshold)


def detect_shots(diffs: np.ndarray, z: float = 2.5,
                 min_gap: int = 8) -> np.ndarray:
    """Offline boundary pick: z-score threshold + minimum shot length
    (the app-level logic of the reference shot_detect example)."""
    diffs = np.asarray(diffs, np.float64)
    mu, sigma = diffs.mean(), diffs.std() + 1e-9
    cand = np.nonzero((diffs - mu) / sigma > z)[0]
    out = []
    for c in cand:
        if not out or c - out[-1] >= min_gap:
            out.append(int(c))
    return np.asarray(out, np.int64)
