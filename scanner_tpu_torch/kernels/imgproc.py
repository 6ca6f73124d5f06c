"""Image-processing kernel stdlib: the color histogram.

Capability parity: the scannertools kernel stdlib the reference tutorials
import (examples/tutorials/00_basic.py `import scannertools.imgproc`) and
tests/test_ops.cpp Histogram:13.  Only Histogram is ported so far;
Resize, Blur, CropResize and OpticalFlow are not.

Kernels are batched: they receive (batch, H, W, C) uint8 frames — a torch
tensor on the client's device when the engine staged the column there, a
numpy array when the client runs on the CPU.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..common import DeviceType, FrameType
from ..graph.ops import Kernel, register_op
from . import cuda_ops

HISTOGRAM_BINS = 16


def histogram_np(frames: np.ndarray) -> np.ndarray:
    """(batch, H, W, C) uint8 -> (batch, C, 16) int32 on the host, one
    numpy bincount per frame over ids offset by channel."""
    b, c = frames.shape[0], frames.shape[-1]
    bins = HISTOGRAM_BINS
    v = (frames >> 4).astype(np.int32)
    v += np.arange(c, dtype=np.int32) * bins
    flat = v.reshape(b, -1)
    out = np.empty((b, c, bins), np.int32)
    for i in range(b):
        out[i] = np.bincount(flat[i], minlength=c * bins).reshape(c, bins)
    return out


def histogram(frames) -> Any:
    """(batch, H, W, C) uint8 -> (batch, C, 16) int32, where the frames
    live: a CUDA tensor launches the histogram kernel
    (cuda_ops.histogram_frames), a CPU tensor takes its plain version,
    a numpy array the numpy flavor."""
    if isinstance(frames, np.ndarray):
        return histogram_np(frames)
    return cuda_ops.histogram_frames(frames, HISTOGRAM_BINS)


@register_op(device=DeviceType.TPU, batch=16)
class Histogram(Kernel):
    """Per-channel 16-bin color histogram; each stored row is a (C, 16)
    int32 array, row[c] being channel c's histogram (scannertools
    parity: UniformList(Histogram, parts=3))."""

    def execute(self, frame: Sequence[FrameType]) -> Sequence[Any]:
        """Returns the (batch, C, bins) int32 counts as ONE batch, left
        on the device: the sink fetches once per task."""
        if not isinstance(frame, (np.ndarray, torch.Tensor)):
            frame = np.stack(frame)
        return histogram(frame)
