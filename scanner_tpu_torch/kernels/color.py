"""YUV420 -> RGB conversion, device (torch) and host (numpy) flavors.

The decode pipeline can ship planar I420 (1.5 B/px) to the accelerator
instead of packed RGB24 (3 B/px) and convert there — halving host->device
bytes, the first-order term of every device pipeline (PERF.md §1).  The
reference did the same on GPU: NV12 frames converted by a CUDA kernel
(reference scanner/util/image.cu:22 nv12_to_rgb); here the conversion is int32
torch arithmetic on the tensor's device, run ahead of the first consumer
kernel.

Both flavors implement the SAME arithmetic — BT.601 limited range with
nearest-neighbor chroma upsampling in 8-bit integer fixed point — so
device and host pipelines are bit-identical on every backend
(test_video.py pins this).  Note
swscale's own yuv420p->RGB24 path (the decoder's "rgb24" output) uses
fixed-point coefficients and bilinear chroma; the two conversions agree
closely but not bit-for-bit, which is why a pipeline picks ONE decode
format end-to-end rather than mixing per stage.
"""

from __future__ import annotations

import numpy as np
import torch

# ITU-R BT.601 studio swing (the default signaled range of the h264/hevc
# streams the engine ingests), in the classic 8-bit fixed-point form:
#   R = (298(Y-16)           + 409(V-128) + 128) >> 8
#   G = (298(Y-16) - 100(U-128) - 208(V-128) + 128) >> 8
#   B = (298(Y-16) + 516(U-128)            + 128) >> 8
# Integer arithmetic is EXACT on every device — float fma/reassociation
# would cost odd one-count rounding differences between host and device
# at some geometries.


def _split_planes(flat, h: int, w: int):
    """Slice flat I420 rows into Y/U/V planes; works identically on
    numpy arrays and torch tensors (shared so the two flavors cannot
    drift)."""
    ch, cw = (h + 1) // 2, (w + 1) // 2
    y = flat[..., : h * w].reshape(*flat.shape[:-1], h, w)
    u = flat[..., h * w: h * w + ch * cw].reshape(*flat.shape[:-1], ch, cw)
    v = flat[..., h * w + ch * cw:].reshape(*flat.shape[:-1], ch, cw)
    return y, u, v


def _combine(y, u, v, xp):
    """Shared fixed-point arithmetic on int32 planes already at full
    resolution; returns int32 0..255."""
    yy = 298 * (y - 16)
    uu = u - 128
    vv = v - 128
    r = (yy + 409 * vv + 128) >> 8
    g = (yy - 100 * uu - 208 * vv + 128) >> 8
    b = (yy + 516 * uu + 128) >> 8
    return xp.clip(xp.stack([r, g, b], -1), 0, 255)


def yuv420_to_rgb_host(flat: np.ndarray, h: int, w: int) -> np.ndarray:
    """(..., yuv420_frame_bytes) uint8 -> (..., h, w, 3) uint8 on host."""
    y, u, v = _split_planes(np.asarray(flat), h, w)
    up = np.repeat(np.repeat(u, 2, axis=-2), 2, axis=-1)[..., :h, :w]
    vp = np.repeat(np.repeat(v, 2, axis=-2), 2, axis=-1)[..., :h, :w]
    out = _combine(y.astype(np.int32), up.astype(np.int32),
                   vp.astype(np.int32), np)
    return out.astype(np.uint8)


def yuv420_to_rgb_device(flat, h: int, w: int):
    """(..., yuv420_frame_bytes) uint8 tensor -> (..., h, w, 3) uint8
    tensor, computed on the tensor's own device."""
    h, w = int(h), int(w)
    y, u, v = _split_planes(flat, h, w)
    up = u.repeat_interleave(2, -2).repeat_interleave(2, -1)[..., :h, :w]
    vp = v.repeat_interleave(2, -2).repeat_interleave(2, -1)[..., :h, :w]
    out = _combine(y.to(torch.int32), up.to(torch.int32),
                   vp.to(torch.int32), torch)
    return out.to(torch.uint8)
