"""Segment Anything's image encoder, ViT-H, on torch.

Kirillov et al., "Segment Anything", ICCV 2023 (arXiv:2304.02643); the
encoder is `ImageEncoderViT` of github.com/facebookresearch/
segment-anything (`segment_anything/modeling/image_encoder.py`) as
`build_sam.py` `build_sam_vit_h` builds it: 1024 x 1024 input, 16 x 16
patches, width 1280, 32 pre-norm blocks of 16 heads of 80, MLP 5120,
qkv bias, LayerNorm eps 1e-6, 14 x 14 windows but for the global blocks
7, 15, 23 and 31, a decomposed relative-position bias in every block,
and a neck to 256 channels: 637,026,048 parameters.  The engine op
`SamEmbed` runs per batch of (B, H, W, 3) uint8 RGB frames, on the
device the engine gives it and with no host sync, and gives each frame
its (256, 64, 64) image embedding, the input of SAM's prompt encoder
and mask decoder, which run per interactive prompt against the stored
embeddings and are not part of this op:

  prep  the longest side resized to 1024 (768 x 1024 for 640 x 480),
        bilinear with half-pixel centres, rounded to whole values (as
        SAM's uint8 resize leaves them), normalised by SAM's pixel mean
        and std, zero-padded bottom and right to 1024 x 1024; bf16,
        channels_last;
  net   the patch embedding (a stride-16 convolution) plus the learned
        absolute position embedding; the 32 blocks: norm1, attention,
        residual, norm2, MLP (exact GELU), residual.  A windowed block
        zero-pads the 64 x 64 grid to 70 x 70 after norm1 and attends
        within each of the 25 windows; the padded positions enter as
        keys with k = b_k and v = b_v, unmasked, as SAM's do.  Every
        block's logits get rel_h[q, k_row] + rel_w[q, k_col], taken
        from the unscaled q (`kernels/attention.py`
        `rel_pos_attention`).  The neck: 1x1 conv to 256 (no bias),
        LayerNorm2d, 3x3 conv (no bias), LayerNorm2d.  bf16 weights and
        activations with fp32 accumulation.
  out   (B, 256, 64, 64) float16, left on the card when the frames came
        as a CUDA tensor (the sink fetches once per task).

Departures from the published encoder (the configuration's `assumed`
list names them too): the resize is torch's bilinear on the card where
SAM resizes with PIL on the host; bf16 weights and activations where
SAM runs float32; the embedding stored as float16; LayerNorm2d computed
by `F.layer_norm` over the channels of the channels-last layout, the
same arithmetic as SAM's mean and variance over dim 1.

Weights: `load_encoder` reads a `.npz` keyed by SAM's state-dict names
less the `image_encoder.` prefix, each array the weight's bfloat16 bits
as uint16 (2 bytes a parameter); the sizes (width, depth, heads,
window, the global blocks, the grid) come from the arrays' shapes.
Without one, weights made from `seed` at the published sizes
(`seeded_state`): SAM initialises the position embedding and the
relative-position tables to zero, so they are drawn non-zero here, as
the plain reference (tests/torch_sam_ref.py) draws them.  The weights
one process loads are kept per device and dtype (`weight_cache`), so
the kernel instance every job builds shares them.

The op records two spans in its job's profile, inside
`evaluate:SamEmbed` (util/profiler.py `span`): `sam:prep` and
`sam:net`; and two counters (`count`): `sam_frames`, the frames it
embedded, and `sam_attn_bias_bytes`, the bias bytes its attention
wrote.  With no current profiler (the evaluator's warm-up thread)
neither records.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import DeviceType, FrameType
from ..graph.ops import Kernel, register_op
from ..kernels.attention import rel_pos_attention
from ..util import profiler as _prof
from . import weight_cache
from .infer import DataParallelApply

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
LN_EPS = 1e-6
OUT_DTYPE = torch.float16
FRAMES_COUNTER = "sam_frames"
# the bytes of relative-position bias the attention builds in full
BIAS_BYTES_COUNTER = "sam_attn_bias_bytes"

# build_sam_vit_h
PUBLISHED = {"img_size": 1024, "patch": 16, "width": 1280, "depth": 32,
             "heads": 16, "mlp": 5120, "window": 14,
             "global_blocks": (7, 15, 23, 31), "out": 256}
# seeded weights (as tests/torch_sam_ref.py draws them): each matrix
# N(0, gain^2 / fan_in), the qkv projection's gain making logits spread
# by ~2; biases N(0, BIAS_STD^2), the qkv bias wider so that padded
# keys carry their own k and v; LayerNorm weights 1 + N(0, NORM_STD^2)
QKV_GAIN = 1.5
QKV_BIAS_STD = 0.5
BIAS_STD = 0.1
NORM_STD = 0.1
POS_STD = 0.5


def grid(arch: Dict) -> int:
    return arch["img_size"] // arch["patch"]


def state_shapes(arch: Optional[Dict] = None) -> Dict[str, Tuple[int, ...]]:
    """Every weight's shape by SAM's name, in SAM's order."""
    a = dict(PUBLISHED, **(arch or {}))
    w, p, hd, g = a["width"], a["patch"], a["width"] // a["heads"], grid(a)
    out = {"patch_embed.proj.weight": (w, 3, p, p),
           "patch_embed.proj.bias": (w,), "pos_embed": (1, g, g, w)}
    for i in range(a["depth"]):
        b = f"blocks.{i}."
        size = g if i in a["global_blocks"] else a["window"]
        out.update({
            b + "norm1.weight": (w,), b + "norm1.bias": (w,),
            b + "attn.qkv.weight": (3 * w, w), b + "attn.qkv.bias": (3 * w,),
            b + "attn.proj.weight": (w, w), b + "attn.proj.bias": (w,),
            b + "attn.rel_pos_h": (2 * size - 1, hd),
            b + "attn.rel_pos_w": (2 * size - 1, hd),
            b + "norm2.weight": (w,), b + "norm2.bias": (w,),
            b + "mlp.lin1.weight": (a["mlp"], w),
            b + "mlp.lin1.bias": (a["mlp"],),
            b + "mlp.lin2.weight": (w, a["mlp"]),
            b + "mlp.lin2.bias": (w,)})
    o = a["out"]
    out.update({"neck.0.weight": (o, w, 1, 1), "neck.1.weight": (o,),
                "neck.1.bias": (o,), "neck.2.weight": (o, o, 3, 3),
                "neck.3.weight": (o,), "neck.3.bias": (o,)})
    return out


def arch_of(state: Dict[str, Any]) -> Dict:
    """The sizes a state holds (its arrays' shapes)."""
    w, _, p, _ = state["patch_embed.proj.weight"].shape
    g = state["pos_embed"].shape[1]
    depth = 0
    while f"blocks.{depth}.norm1.weight" in state:
        depth += 1
    rel = [state[f"blocks.{i}.attn.rel_pos_h"].shape[0]
           for i in range(depth)]
    windows = {(r + 1) // 2 for r in rel if r != 2 * g - 1}
    if len(windows) > 1:
        raise ValueError(f"blocks of several window sizes: {windows}")
    return {"img_size": int(g * p), "patch": int(p), "width": int(w),
            "depth": depth,
            "heads": int(w // state["blocks.0.attn.rel_pos_h"].shape[1]),
            "mlp": int(state["blocks.0.mlp.lin1.weight"].shape[0]),
            "window": int(windows.pop()) if windows else 0,
            "global_blocks": tuple(i for i, r in enumerate(rel)
                                   if r == 2 * g - 1),
            "out": int(state["neck.0.weight"].shape[0])}


def attention_flops(arch: Optional[Dict] = None) -> int:
    """Multiply-adds x 2 of one frame's q k^T and p v products."""
    a = dict(PUBLISHED, **(arch or {}))
    g, ws = grid(a), a["window"]
    hp = -(-g // ws) * ws if ws else g
    total = 0
    for i in range(a["depth"]):
        if i in a["global_blocks"] or not ws:
            windows, s = 1, g * g
        else:
            windows, s = (hp // ws) ** 2, ws * ws
        total += 2 * 2 * windows * s * s * a["width"]
    return total


def encoder_flops(arch: Optional[Dict] = None) -> int:
    """Multiply-adds x 2 of one frame through the encoder: the patch
    embedding, qkv and proj over every (padded) token, the MLP, the
    attention's two products, the relative-position terms' products
    (q against each row's and column's table), the neck.  Norms,
    softmax, GELU and the bias additions are not counted."""
    a = dict(PUBLISHED, **(arch or {}))
    g, ws, w, p = grid(a), a["window"], a["width"], a["patch"]
    hp = -(-g // ws) * ws if ws else g
    total = 2 * g * g * w * 3 * p * p
    total += 2 * g * g * (w * a["out"] + a["out"] * a["out"] * 9)
    for i in range(a["depth"]):
        glob = i in a["global_blocks"] or not ws
        tokens, side = (g * g, g) if glob else (hp * hp, ws)
        total += 2 * tokens * 4 * w * w              # qkv, proj
        total += 2 * g * g * 2 * w * a["mlp"]        # lin1, lin2
        total += 2 * tokens * w * 2 * side           # q . rel tables
    return total + attention_flops(a)


def draw(name: str, shape: Tuple[int, ...], gen: torch.Generator,
         device) -> torch.Tensor:
    """One seeded weight, float32 (tests/torch_sam_ref.py `draw`)."""
    z = torch.randn(shape, generator=gen, device=device)
    if name == "pos_embed":
        return z * POS_STD
    if "rel_pos" in name:
        return z / math.sqrt(shape[1])
    if len(shape) == 1:
        if "norm" in name or name in ("neck.1.weight", "neck.3.weight"):
            if name.endswith("weight"):
                return 1.0 + z * NORM_STD
            return z * NORM_STD
        return z * (QKV_BIAS_STD if "qkv" in name else BIAS_STD)
    gain = QKV_GAIN if "qkv" in name else 1.0
    return z * (gain / math.sqrt(math.prod(shape[1:])))


def seeded_state(seed: int, arch: Optional[Dict] = None, device="cpu"
                 ) -> Dict[str, torch.Tensor]:
    """SAM-named float32 weights made from `seed`, each a bfloat16
    value."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return {k: draw(k, s, gen, device).to(torch.bfloat16).float()
            for k, s in state_shapes(arch).items()}


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A weight as the file holds it: its bfloat16 bits as uint16."""
    return t.to(torch.bfloat16).view(torch.int16).cpu().numpy().view(
        np.uint16)


def from_bf16_bits(a: np.ndarray) -> torch.Tensor:
    """`bf16_bits`' inverse: a bfloat16 tensor on the host."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
        torch.bfloat16)


def save_state(state: Dict[str, torch.Tensor], path: str) -> None:
    """Write `state` as the `.npz` load_encoder reads."""
    np.savez(path, **{k: bf16_bits(v) for k, v in state.items()})


# -- the network ---------------------------------------------------------------

def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B * windows, ws, ws, C), zero-padded bottom and
    right to a multiple of ws; and the padded size."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, padded, size):
    """window_partition's inverse, the padding cut off."""
    (hp, wp), (h, w) = padded, size
    b = x.shape[0] // (hp * wp // ws // ws)
    x = x.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :]


def rel_table(size: int, table: torch.Tensor) -> torch.Tensor:
    """(2 size - 1, C) -> (size, size, C): each query row's and key
    row's offset (SAM's get_rel_pos for equal query and key sizes)."""
    q = torch.arange(size, device=table.device)[:, None]
    k = torch.arange(size, device=table.device)[None, :]
    return table[q - k + size - 1]


class Attention(nn.Module):
    """SAM's Attention over a (B, H, W, C) grid (a window, or the whole
    grid in a global block)."""

    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))

    def forward(self, x):
        b, h, w, _ = x.shape
        n = self.heads
        qkv = self.qkv(x).reshape(b, h * w, 3, n, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)                       # (B, heads, S, d)
        r_q = q.reshape(b, n, h, w, -1)
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q,
                             rel_table(h, self.rel_pos_h))
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q,
                             rel_table(w, self.rel_pos_w))
        out = rel_pos_attention(q, k, v, rel_h.reshape(b, n, h * w, h),
                                rel_w.reshape(b, n, h * w, w))
        # rel_pos_attention's (B, heads, S, S) bias in q's dtype
        _prof.count(BIAS_BYTES_COUNTER,
                    b * n * (h * w) ** 2 * q.element_size())
        return self.proj(out.transpose(1, 2).reshape(b, h, w, -1))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class Block(nn.Module):
    """SAM's pre-norm Block; `window` 0 attends over the whole grid."""

    def __init__(self, dim: int, heads: int, mlp: int, window: int,
                 grid_size: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, window or grid_size)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLPBlock(dim, mlp)

    def forward(self, x):
        shortcut, size = x, x.shape[1:3]
        x = self.norm1(x)
        if self.window:
            x, padded = window_partition(x, self.window)
        x = self.attn(x)
        if self.window:
            x = window_unpartition(x, self.window, padded, size)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.Module):
    """SAM's LayerNorm2d (over the channels of (B, C, H, W)), computed
    by F.layer_norm on the channels-last view."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], self.weight,
                         self.bias, LN_EPS)
        return y.permute(0, 3, 1, 2)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)       # (B, G, G, C)


class SamEncoder(nn.Module):
    """SAM's ImageEncoderViT: (B, 3, S, S) net input -> (B, out, S /
    patch, S / patch).  Parameters are named as SAM's encoder's."""

    def __init__(self, img_size: int = 1024, patch: int = 16,
                 width: int = 1280, depth: int = 32, heads: int = 16,
                 mlp: int = 5120, window: int = 14,
                 global_blocks: Sequence[int] = (7, 15, 23, 31),
                 out: int = 256):
        super().__init__()
        self.arch = dict(img_size=img_size, patch=patch, width=width,
                         depth=depth, heads=heads, mlp=mlp, window=window,
                         global_blocks=tuple(global_blocks), out=out)
        g = img_size // patch
        self.patch_embed = PatchEmbed(patch, width)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, width))
        self.blocks = nn.ModuleList([
            Block(width, heads, mlp,
                  0 if i in global_blocks else window, g)
            for i in range(depth)])
        self.neck = nn.Sequential(
            nn.Conv2d(width, out, 1, bias=False), LayerNorm2d(out),
            nn.Conv2d(out, out, 3, padding=1, bias=False), LayerNorm2d(out))

    def forward(self, x):
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


def load_encoder(checkpoint_dir: Optional[str], seed: int, device,
                 dtype: torch.dtype = torch.bfloat16) -> SamEncoder:
    """The encoder in `dtype` on `device`, its convolutions channels_last:
    weights from the `.npz` `checkpoint_dir` (a file, or a directory
    holding one), else made from `seed` at the published sizes.  The
    parameters are built once per process (weight_cache.shared)."""
    device = torch.device(device)

    def build(path):
        if path is not None:
            with np.load(path) as data:
                state = {k: from_bf16_bits(data[k]) for k in data}
        else:
            state = seeded_state(seed)
        arch = arch_of(state)
        params = {}
        for name in state_shapes(arch):
            t = state[name].to(device, dtype)
            if t.dim() == 4:
                t = t.contiguous(memory_format=torch.channels_last)
            params[name] = t
        return arch, params

    arch, params = weight_cache.shared("SamEmbed", checkpoint_dir, seed,
                                       device, dtype, build)
    with torch.device("meta"):
        enc = SamEncoder(**arch)
    enc.load_state_dict(params, assign=True)
    return enc.requires_grad_(False).eval()


def prep(frames: torch.Tensor, img_size: int, mean: torch.Tensor,
         std: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> (B, 3, img_size, img_size) net input in
    `dtype`, channels_last; `mean`, `std` (1, 3, 1, 1) float32 on the
    frames' device."""
    _, h, w, _ = frames.shape
    scale = img_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    x = frames.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(nh, nw), mode="bilinear",
                      align_corners=False)
    x = (torch.round(x).clamp_(0, 255) - mean) / std
    x = F.pad(x, (0, img_size - nw, 0, img_size - nh))
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


class SamEmbedModel(nn.Module):
    """(B, H, W, 3) uint8 RGB frames -> (B, out, grid, grid) OUT_DTYPE
    embeddings, with the op's spans and frame counter."""

    def __init__(self, encoder: SamEncoder):
        super().__init__()
        self.encoder = encoder
        # on the module's device, so that no call copies them from the
        # host (a copy from pageable memory waits for the device)
        self.register_buffer("mean", torch.tensor(PIXEL_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(PIXEL_STD).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, frames):
        with _prof.span("sam:prep"):
            x = prep(frames, self.encoder.arch["img_size"], self.mean,
                     self.std, self.encoder.pos_embed.dtype)
        with _prof.span("sam:net"):
            out = self.encoder(x).to(
                OUT_DTYPE, memory_format=torch.contiguous_format)
        _prof.count(FRAMES_COUNTER, int(frames.shape[0]))
        return out


# -- the engine op ------------------------------------------------------------

@register_op(device=DeviceType.TPU, batch=8)
class SamEmbed(Kernel):
    """Per-frame SAM ViT-H image embeddings, (256, 64, 64) float16 rows,
    replicated over the devices the engine gives this kernel
    (DataParallelApply).

    `checkpoint_dir`: a SAM-named `.npz` of bfloat16 bits (or a
    directory holding one); without it, weights made from `seed` at the
    published sizes."""

    def __init__(self, config, checkpoint_dir: Optional[str] = None,
                 seed: int = 0):
        super().__init__(config)
        devices = config.devices or ["cpu"]
        from .infer import _device
        enc = load_encoder(checkpoint_dir, seed, _device(devices[0]))
        self.arch = enc.arch
        self._dp = DataParallelApply(SamEmbedModel(enc), config.devices)

    def cost(self, shapes):
        """FLOPs of the encoder and the bytes of one call on (B, H, W, 3)
        frames (the prep's resize is not counted)."""
        b, h, w = shapes[0][:3]
        g = grid(self.arch)
        return {"flops": float(b * encoder_flops(self.arch)),
                "bytes_in": float(b * h * w * 3),
                "bytes_out": float(b * self.arch["out"] * g * g * 2)}

    def infer_cost_flops(self, batch):
        """FLOPs of one inference call on `batch` (the encoder's, from
        its shapes)."""
        return self.cost([tuple(np.shape(batch))])["flops"]

    def execute(self, frame: Sequence[FrameType]) -> Sequence[Any]:
        """(B, out, grid, grid) float16 per batch: a tensor left on the
        card when the frames came as a CUDA tensor, a numpy array when
        they came from the host."""
        return self._dp(frame)
