"""Image-processing kernel stdlib: Histogram, Resize, CropResize, Blur,
OpticalFlow.

Capability parity: the scannertools kernel stdlib the reference tutorials
import (examples/tutorials/00_basic.py `import scannertools.imgproc`) and
tests/test_ops.cpp (Histogram:13, Resize:114, Blur:239, OpticalFlow:63).

Kernels are batched: they receive (batch, H, W, C) uint8 frames — a torch
tensor on the client's device when the engine staged the column there, a
numpy array when the client runs on the CPU.  A tensor's result stays
where the tensor lies; a numpy batch gets a numpy result.

Histogram runs the hand-written CUDA kernel on the card.  The resamplers
and the flow solver are plain torch, as the JAX package left them to XLA
in plain jnp: each keeps the JAX package's arithmetic (tap order, edge
handling, float32 throughout, round half to even) so both packages agree
within one uint8 count.  Each op's `cost()` gives the JAX package's
analytical descriptor for the same shapes (the roofline ledger,
util/coststats.py, and the fusion planner read it).
"""

from __future__ import annotations

import functools
from typing import Any, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..common import DeviceType, FrameType
from ..graph.ops import Kernel, register_op
from ..util.coststats import CostDescriptor
from . import cuda_ops

HISTOGRAM_BINS = 16


def _frame_shape(shapes, idx: int = 0):
    """The idx-th input's array shape, or None when the engine handed a
    per-row list (host path): a cost hook then declares nothing rather
    than guess."""
    if idx < len(shapes) and isinstance(shapes[idx], tuple):
        return shapes[idx]
    return None


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


def _bin_ids(x: torch.Tensor) -> torch.Tensor:
    """(n, ..., C) integer values -> (n * C, P) int32 bin ids with the
    JAX package's `_histogram_impl` rules: bin = (v * 16) // 256 in
    int32, below 0 clamped to bin 0 (jnp.bincount clips negatives), 16 or
    more mapped to the padding id 16, which counts nowhere."""
    n, c = x.shape[0], x.shape[-1]
    v = ((x.to(torch.int32) * HISTOGRAM_BINS) >> 8).clamp_(0, HISTOGRAM_BINS)
    return v.reshape(n, -1, c).transpose(1, 2).reshape(n * c, -1) \
        .contiguous()


def histogram(frames) -> Any:
    """(n, ..., C) integer values -> (n, C, 16) int32 counts of each
    channel (the trailing axis), bin = (v * 16) // 256, computed where
    the values live.  uint8 (n, H, W, C) frames with 1 <= C <=
    cuda_ops.MAX_CHANNELS take the kernel's frame entry
    (cuda_ops.histogram_frames); every other integer batch — int32
    frames, more channels, a window of Histogram rows — takes its id
    entry (cuda_ops.histogram_ids) over `_bin_ids`.  A CPU tensor takes
    the plain versions; a numpy batch gets numpy counts (uint8 frames by
    the numpy flavor, histogram_np)."""
    if isinstance(frames, np.ndarray):
        if frames.ndim == 4 and frames.dtype == np.uint8:
            return histogram_np(frames)
        return histogram(torch.from_numpy(np.ascontiguousarray(frames))) \
            .numpy()
    n, c = frames.shape[0], frames.shape[-1]
    if frames.ndim == 4 and frames.dtype == torch.uint8 \
            and 1 <= c <= cuda_ops.MAX_CHANNELS:
        return cuda_ops.histogram_frames(
            frames if frames.is_contiguous() else frames.contiguous(),
            HISTOGRAM_BINS)
    return cuda_ops.histogram_ids(_bin_ids(frames), HISTOGRAM_BINS).reshape(
        n, c, HISTOGRAM_BINS)


@register_op(device=DeviceType.TPU, batch=16)
class Histogram(Kernel):
    """Per-channel 16-bin color histogram; each stored row is a (C, 16)
    int32 array, row[c] being channel c's histogram (scannertools
    parity: UniformList(Histogram, parts=3)).  Any integer (B, H, W, C)
    frames, as the JAX op bins them."""

    def cost(self, shapes):
        """Compare+reduce histogram (the JAX package's model): per
        pixel-channel, one fixed-point binning (2 ops) plus `bins`
        compares and `bins` accumulates.  Reads the uint8 frames once,
        writes (b, C, bins) int32."""
        s = _frame_shape(shapes)
        if s is None or len(s) != 4:
            return None
        b, h, w, c = s
        px = b * h * w * c
        return CostDescriptor(
            flops=float(px * (HISTOGRAM_BINS + 2)),
            bytes_in=float(px),
            bytes_out=float(b * c * HISTOGRAM_BINS * 4))

    def execute_traced(self, frame):
        """Tensor in, (batch, C, bins) int32 tensor out, where the
        tensor lies: the fused chain's tail (engine/evaluate.py)."""
        return histogram(torch.as_tensor(frame))

    def execute(self, frame: Sequence[FrameType]) -> Sequence[Any]:
        """Returns the (batch, C, bins) int32 counts as ONE batch, left
        on the device: the sink fetches once per task.  A numpy batch
        (or a list of frames) gets numpy counts."""
        if not isinstance(frame, (np.ndarray, torch.Tensor)):
            frame = np.stack(frame)
        return histogram(frame)


def _as_tensor(frames) -> Tuple[torch.Tensor, bool]:
    """(tensor, on_host): a numpy batch (or list of frames) as a CPU
    tensor, flagged so the caller hands numpy back."""
    if isinstance(frames, torch.Tensor):
        return frames, False
    if not isinstance(frames, np.ndarray):
        frames = np.stack(frames)
    return torch.from_numpy(np.ascontiguousarray(frames)), True


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint8 as the JAX package rounds: half to even, clipped
    to [0, 255]."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def _resize_band(in_size: int, out_size: int):
    """Contiguous tap indices (out, k) + normalized triangle weights (out,
    k) for one axis of a separable bilinear resize (half-pixel centers,
    antialias width max(scale, 1) — the jax.image.resize bilinear
    kernel), as numpy."""
    scale = in_size / out_size
    centers = (np.arange(out_size) + 0.5) * scale - 0.5
    idx = np.arange(in_size)
    wts = 1.0 - np.abs(centers[:, None] - idx[None, :]) / max(scale, 1.0)
    wts = np.clip(wts, 0.0, None)
    nz = wts > 0
    k = int(nz.sum(1).max())
    start = np.where(nz.any(1), nz.argmax(1), 0)
    start = np.minimum(start, in_size - k)
    taps = start[:, None] + np.arange(k)[None, :]
    tw = np.take_along_axis(wts, taps, 1)
    tw = (tw / tw.sum(1, keepdims=True)).astype(np.float32)
    return taps, tw, k


@functools.lru_cache(maxsize=None)
def _band_on(in_size: int, out_size: int, device: torch.device):
    """_resize_band's taps and weights as tensors on `device`, one per
    tap: [(index (out,), weight (out,))], made once per geometry and
    device so a call uploads nothing.  Never evicted: a fused chain's
    CUDA graph (engine/evaluate.py) reads them by address for the life
    of the process."""
    taps, tw, k = _resize_band(in_size, out_size)
    return [(torch.from_numpy(np.ascontiguousarray(taps[:, j])).to(device),
             torch.from_numpy(np.ascontiguousarray(tw[:, j])).to(device))
            for j in range(k)]


def resize(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, h, w, C) uint8: separable bilinear, the
    rows first, each pass a sum of weighted tap gathers in tap order (the
    JAX package's _resize_impl); gathers read uint8 and convert after."""
    y = None
    for idx, wt in _band_on(frames.shape[1], h, frames.device):
        t = wt[:, None, None] * frames[:, idx].to(torch.float32)
        y = t if y is None else y + t
    o = None
    for idx, wt in _band_on(frames.shape[2], w, frames.device):
        t = wt[:, None] * y[:, :, idx]
        o = t if o is None else o + t
    return _to_u8(o)


@register_op(device=DeviceType.TPU, batch=16)
class Resize(Kernel):
    """Bilinear resize to (width, height) — per-stream args like the
    reference Resize op (test_ops.cpp:114, stream-protobuf args)."""

    def __init__(self, config, width: int = 0, height: int = 0):
        super().__init__(config)
        self.width, self.height = int(width), int(height)

    def new_stream(self, width: int = None, height: int = None):
        if width is not None:
            self.width = int(width)
        if height is not None:
            self.height = int(height)

    def cost(self, shapes):
        """Separable bilinear resample: 4 taps (mul+add) per output
        pixel-channel = 8 flops.  Reads the source frames, writes the
        (b, H, W, c) uint8 result."""
        s = _frame_shape(shapes)
        if s is None or len(s) != 4 or not (self.height and self.width):
            return None
        b, h, w, c = s
        out_px = b * self.height * self.width * c
        return CostDescriptor(flops=float(out_px * 8),
                              bytes_in=float(b * h * w * c),
                              bytes_out=float(out_px))

    def execute_traced(self, frame):
        """Tensor in, tensor out, where the tensor lies: the body a
        fused chain runs and captures (engine/evaluate.py)."""
        return resize(frame, self.height, self.width)

    def execute(self, frame: Sequence[FrameType]) -> Sequence[FrameType]:
        x, on_host = _as_tensor(frame)
        out = self.execute_traced(x)
        return out.numpy() if on_host else out


_EPS32 = float(np.finfo(np.float32).eps)


def _linear_weights(in_size: int, out_size: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """(B, in, out) float32 weight matrices of jax.image.scale_and_translate
    (method="linear", antialias=True) for one axis, one per box
    (jax/_src/image/scale.py compute_weight_mat): the triangle widens by
    1/scale when the box is larger than the output, each output's weights
    are divided by their sum, and an output whose sample falls outside
    [-0.5, in - 0.5] gets none."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)
                 + 0.5) * inv_scale - translation[:, None] * inv_scale
                - 0.5)                                         # (B, out)
    x = torch.abs(sample_f[:, None, :] - torch.arange(
        in_size, dtype=torch.float32, device=dev)[None, :, None]) \
        / kernel_scale[:, None, :]
    weights = torch.clamp_min(1 - x, 0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def crop_resize(frames: torch.Tensor, boxes: torch.Tensor, oh: int,
                ow: int) -> torch.Tensor:
    """Crop unit-coordinate boxes [y1, x1, y2, x2] (B, 4) out of (B, H,
    W, C) uint8 frames and resample each to (oh, ow): the JAX package's
    scale_and_translate (linear, antialiased), built as per-box weight
    matrices (B, H, oh) and (B, W, ow) applied as two batched products.
    Output shapes are fixed whatever the box."""
    B, H, W, C = frames.shape
    boxes = boxes.to(torch.float32)
    y1, x1 = boxes[:, 0] * H, boxes[:, 1] * W
    y2, x2 = boxes[:, 2] * H, boxes[:, 3] * W
    h = torch.clamp_min(y2 - y1, 1.0)
    w = torch.clamp_min(x2 - x1, 1.0)
    wy = _linear_weights(H, oh, oh / h, -y1 * oh / h)          # (B, H, oh)
    wx = _linear_weights(W, ow, ow / w, -x1 * ow / w)          # (B, W, ow)
    x = frames.to(torch.float32).reshape(B, H, W * C)
    t = torch.bmm(wy.transpose(1, 2), x).reshape(B, oh, W, C)
    out = torch.matmul(t.permute(0, 1, 3, 2), wx[:, None])     # (B,oh,C,ow)
    return _to_u8(out.permute(0, 1, 3, 2))


@register_op(device=DeviceType.TPU, batch=16)
class CropResize(Kernel):
    """Crop a per-row box (unit coords [y1, x1, y2, x2]) out of each frame
    and resize to (height, width) — the region-extraction step of the
    reference's re-id/feature apps, with static output shapes so the
    whole op stays on the device.  `size` sets a square output;
    height/width override per axis."""

    def __init__(self, config, size: int = 64, height: int = 0,
                 width: int = 0):
        super().__init__(config)
        self.height = int(height) or int(size)
        self.width = int(width) or int(size)

    def precompile_input(self, name: str):
        # boxes are unit coords, so a full-frame box warms the exact
        # call shapes the real calls hit (engine bucket-ladder warm-up)
        if name == "box":
            return np.asarray([0.0, 0.0, 1.0, 1.0], np.float32)
        return None

    def cost(self, shapes):
        """Crop + bilinear resample to (height, width): like Resize, 4
        taps (mul+add) per output pixel-channel = 8 flops; the per-box
        scale/translate arithmetic is O(b) and ignored.  Reads the
        frames and the (b, 4) float32 boxes, writes the crops."""
        s = _frame_shape(shapes)
        if s is None or len(s) != 4:
            return None
        b, h, w, c = s
        out_px = b * self.height * self.width * c
        return CostDescriptor(flops=float(out_px * 8),
                              bytes_in=float(b * h * w * c + b * 4 * 4),
                              bytes_out=float(out_px))

    def execute_traced(self, frame, box):
        """Frames and (B, 4) float32 boxes in, crops out, on the
        frames' device."""
        return crop_resize(frame, box, self.height, self.width)

    def execute(self, frame: Sequence[FrameType],
                box: Sequence[Any]) -> Sequence[FrameType]:
        x, on_host = _as_tensor(frame)
        if isinstance(box, torch.Tensor):
            boxes = box
        else:
            boxes = torch.from_numpy(np.stack(
                [np.asarray(b, np.float32) for b in box])).to(x.device)
        if boxes.device != x.device:
            raise ValueError(f"boxes on {boxes.device}, frames on "
                             f"{x.device}")
        out = self.execute_traced(x, boxes)
        return out.numpy() if on_host else out


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float32) - r
    k = np.exp(-(x ** 2) / (2.0 * max(sigma, 1e-6) ** 2))
    return (k / k.sum()).astype(np.float32)


def blur(frames: torch.Tensor, kern: Sequence[float]) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, H, W, C) uint8 separable gaussian over
    the edge-replicated image: a shift-add of the taps down the rows,
    then across, each in tap order (the JAX package's _blur_impl)."""
    k = len(kern)
    pad = k // 2
    _, h, w, _ = frames.shape
    x = F.pad(frames.permute(0, 3, 1, 2).to(torch.float32),
              (pad, pad, pad, pad), mode="replicate")
    v = None
    for i in range(k):
        t = kern[i] * x[:, :, i:i + h]
        v = t if v is None else v + t
    o = None
    for j in range(k):
        t = kern[j] * v[:, :, :, j:j + w]
        o = t if o is None else o + t
    return _to_u8(o).permute(0, 2, 3, 1).contiguous()


@register_op(device=DeviceType.TPU, batch=16)
class Blur(Kernel):
    """Gaussian blur (reference tests/test_ops.cpp:239 Blur)."""

    def __init__(self, config, kernel_size: int = 3, sigma: float = 0.5):
        super().__init__(config)
        self.ksize = int(kernel_size) | 1  # odd
        self.kern = [float(v) for v in
                     _gaussian_kernel1d(self.ksize, float(sigma))]

    def cost(self, shapes):
        """Separable gaussian: two 1-D passes of `ksize` taps each —
        2 * ksize * 2 flops per pixel-channel.  uint8 in, uint8 out,
        same geometry."""
        s = _frame_shape(shapes)
        if s is None or len(s) != 4:
            return None
        b, h, w, c = s
        px = b * h * w * c
        return CostDescriptor(flops=float(px * 4 * self.ksize),
                              bytes_in=float(px), bytes_out=float(px))

    def execute_traced(self, frame):
        """Tensor in, tensor out, where the tensor lies: the body a
        fused chain runs and captures (engine/evaluate.py)."""
        return blur(frame, self.kern)

    def execute(self, frame: Sequence[FrameType]) -> Sequence[FrameType]:
        x, on_host = _as_tensor(frame)
        out = self.execute_traced(x)
        return out.numpy() if on_host else out


GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def _grayscale(frames: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) float32 luma, summed in channel order."""
    f = frames.to(torch.float32)
    w = [float(np.float32(v)) for v in GRAY_WEIGHTS]
    return f[..., 0] * w[0] + f[..., 1] * w[1] + f[..., 2] * w[2]


HS_ITERS = 16  # fixed Horn-Schunck iteration count

# the 3x3 neighbourhood average of Horn-Schunck (centre weight 0), taps
# in row-major order
_AVG_TAPS = [(dy, dx, float(np.float32(1 / 12 if dy != 1 and dx != 1
                                       else 1 / 6)))
             for dy in range(3) for dx in range(3) if (dy, dx) != (1, 1)]


def _avg(x: torch.Tensor) -> torch.Tensor:
    """(b, h, w) -> the Horn-Schunck 3x3 average over the edge-padded
    field, as a shift-add in float32."""
    _, h, w = x.shape
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    out = None
    for dy, dx, k in _AVG_TAPS:
        t = k * xp[:, dy:dy + h, dx:dx + w]
        out = t if out is None else out + t
    return out


def horn_schunck(prev: torch.Tensor, nxt: torch.Tensor,
                 iters: int = HS_ITERS, alpha: float = 15.0
                 ) -> torch.Tensor:
    """Classic Horn-Schunck optical flow, batched: (b, h, w) float32
    grayscale in, (b, h, w, 2) float32 flow out, after a fixed number of
    iterations (no data-dependent control flow).  Gradients wrap around
    the frame as jnp.roll does."""
    Ix = (torch.roll(prev, -1, 2) - torch.roll(prev, 1, 2)) * 0.5
    Iy = (torch.roll(prev, -1, 1) - torch.roll(prev, 1, 1)) * 0.5
    It = nxt - prev
    denom = alpha ** 2 + Ix ** 2 + Iy ** 2
    u = torch.zeros_like(Ix)
    v = torch.zeros_like(Iy)
    for _ in range(iters):
        ub, vb = _avg(u), _avg(v)
        t = (Ix * ub + Iy * vb + It) / denom
        u, v = ub - Ix * t, vb - Iy * t
    return torch.stack([u, v], dim=-1)


@register_op(device=DeviceType.TPU, stencil=[-1, 0], batch=4)
class OpticalFlow(Kernel):
    """Dense optical flow between consecutive frames (reference
    scannertools OpticalFlow / test_ops.cpp:63, StenciledKernel).  Output
    per row: float32 (H, W, 2) flow from the previous frame to the
    current."""

    def cost(self, shapes):
        """Horn-Schunck: grayscale both frames (~5 flops/px each),
        gradients (~6/px), then HS_ITERS solver iterations of two 3x3
        averages (36 flops/px) plus ~12 arithmetic ops/px.  Reads the
        (b, 2, H, W, C) uint8 stencil window, writes (b, H, W, 2)
        float32 flow."""
        s = _frame_shape(shapes)
        if s is None or len(s) != 5:
            return None
        b, win, h, w, c = s
        px = b * h * w
        flops = px * (win * 5 + 6 + HS_ITERS * (36 + 12))
        return CostDescriptor(flops=float(flops),
                              bytes_in=float(b * win * h * w * c),
                              bytes_out=float(px * 2 * 4))

    def execute_traced(self, frame):
        """(b, 2, H, W, C) stencil windows in, (b, H, W, 2) float32 flow
        out, where the tensor lies: the body a fused chain runs and
        captures (engine/evaluate.py)."""
        return horn_schunck(_grayscale(frame[:, 0]), _grayscale(frame[:, 1]))

    def execute(self, frame: Sequence[Sequence[FrameType]]
                ) -> Sequence[FrameType]:
        from ..engine.batch import is_array_data
        if not is_array_data(frame):
            frame = np.stack([np.stack([w[0], w[1]]) for w in frame])
        x, on_host = _as_tensor(frame)
        out = self.execute_traced(x)
        return out.numpy() if on_host else out
