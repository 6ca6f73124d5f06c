"""Neural building blocks shared by the model families, as torch modules.

The counterpart of the JAX package's models/nets.py (flax.linen).  The
modules keep flax's semantics so that the JAX package's weights run
unchanged after models/convert.py:

  * parameters are float32; compute runs in the module's `dtype`
    (bfloat16 by default), inputs and parameters cast per layer as flax
    does;
  * convolutions pad like flax's padding="SAME", which is asymmetric for
    strided convolutions (F.conv2d has no strided 'same');
  * convolutions and dense layers add their bias after the product is
    rounded to `dtype`, as flax does (a fused bias add rounds once, and
    in bfloat16 that moves about 40 % of a backbone's outputs by an ulp);
  * GroupNorm and LayerNorm use eps 1e-6 and take their statistics in
    float32 with E[x^2] - E[x]^2, as flax does;
  * the transposed convolution is flax's (padding "SAME",
    transpose_kernel=False); the converter flips its kernel.

Submodules carry flax's auto names (Conv_0, GroupNorm_1, ResBlock_3, ...)
so a parameter's torch name maps to its flax key path.  Each module's
FLAX_PARAMS says which flax leaf a torch parameter comes from and how
its layout changes (models/convert.py reads it).

Layout: Backbone, DeconvHead and VideoPoseNet take and return NHWC, as
the JAX package does; inside, convolutions run on NCHW views of the
same memory (channels_last), so the permutes copy nothing.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.ring_attention import reference_attention

NORM_EPS = 1e-6  # flax GroupNorm / LayerNorm default


def _hwio_to_oihw(a):
    return a.transpose(3, 2, 0, 1)


def _transpose_conv_kernel(a):
    """flax ConvTranspose kernel (kh, kw, in, out), applied without a
    flip, -> torch conv_transpose2d weight (in, out, kh, kw), which torch
    applies flipped."""
    return a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _dense_kernel(a):
    return a.T


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """lax "SAME" padding of one spatial dim: (low, high)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _lecun_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        w.normal_(0.0, std, generator=gen).clamp_(-2 * std, 2 * std)


class Conv(nn.Module):
    """flax nn.Conv(cout, (k, k), strides=(s, s), padding="SAME") on
    NCHW tensors."""

    FLAX_PARAMS = {"weight": ("kernel", _hwio_to_oihw)}

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def init_(self, gen: torch.Generator) -> None:
        _lecun_(self.weight, self.weight[0].numel(), gen)

    def forward(self, x):
        ph = _same_pads(x.shape[2], self.k, self.stride)
        pw = _same_pads(x.shape[3], self.k, self.stride)
        x = x.to(self.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = (0, 0)
        y = F.conv2d(x, self.weight.to(self.dtype), None, self.stride, pad)
        return y + self.bias.to(self.dtype)[:, None, None]


class ConvTranspose(nn.Module):
    """flax nn.ConvTranspose(cout, (k, k), strides=(s, s)) (padding
    "SAME", transpose_kernel=False) on NCHW tensors: output size s * n."""

    FLAX_PARAMS = {"weight": ("kernel", _transpose_conv_kernel)}

    def __init__(self, cin: int, cout: int, k: int = 4, stride: int = 2,
                 dtype=torch.bfloat16):
        super().__init__()
        # lax.conv_transpose "SAME" pads the dilated input by
        # (pad_a, pad_b); torch pads it by k - 1 - padding on both sides
        pad_len = k + stride - 2
        pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
        if pad_len - pad_a != pad_a:
            raise ValueError(f"ConvTranspose k={k}, stride={stride}: "
                             "asymmetric SAME padding is not supported")
        self.padding = k - 1 - pad_a
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(torch.zeros(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def init_(self, gen: torch.Generator) -> None:
        cin, _, kh, kw = self.weight.shape
        _lecun_(self.weight, cin * kh * kw, gen)

    def forward(self, x):
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                               None, self.stride, self.padding)
        return y + self.bias.to(self.dtype)[:, None, None]


class Dense(nn.Module):
    """flax nn.Dense over the last axis."""

    FLAX_PARAMS = {"weight": ("kernel", _dense_kernel)}

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def init_(self, gen: torch.Generator) -> None:
        _lecun_(self.weight, self.weight.shape[1], gen)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype)) \
            + self.bias.to(self.dtype)


def _normalize(x, mean, var, scale, bias, dtype):
    """flax's _normalize: float32 statistics, result cast to dtype."""
    y = x.float() - mean
    y = y * (torch.rsqrt(var + NORM_EPS) * scale)
    return (y + bias).to(dtype)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm(num_groups) on NCHW tensors."""

    FLAX_PARAMS = {"weight": ("scale", None)}

    def __init__(self, ch: int, groups: int = 8, dtype=torch.bfloat16):
        super().__init__()
        if ch % groups:
            raise ValueError(f"{groups} groups do not divide {ch} channels")
        self.groups, self.dtype = groups, dtype
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        n, c = x.shape[:2]
        g = x.float().reshape(n, self.groups, -1)
        mean = g.mean(dim=2)
        var = torch.clamp_min((g * g).mean(dim=2) - mean * mean, 0.0)
        shape = (n, c) + (1,) * (x.dim() - 2)
        per_ch = lambda t: t.repeat_interleave(c // self.groups, dim=1) \
            .reshape(shape)  # noqa: E731
        bshape = (1, c) + (1,) * (x.dim() - 2)
        return _normalize(x, per_ch(mean), per_ch(var),
                          self.weight.reshape(bshape),
                          self.bias.reshape(bshape), self.dtype)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis."""

    FLAX_PARAMS = {"weight": ("scale", None)}

    def __init__(self, ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True)
                              - mean * mean, 0.0)
        return _normalize(x, mean, var, self.weight, self.bias, self.dtype)


class ResBlock(nn.Module):
    """On NCHW tensors (it sits inside Backbone)."""

    def __init__(self, cin: int, ch: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(cin, ch, 3, stride, dtype)
        self.GroupNorm_0 = GroupNorm(ch, 8, dtype)
        self.Conv_1 = Conv(ch, ch, 3, 1, dtype)
        self.GroupNorm_1 = GroupNorm(ch, 8, dtype)
        self.Conv_2 = Conv(cin, ch, 1, stride, dtype) \
            if (cin != ch or stride != 1) else None

    def forward(self, x):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        h = self.GroupNorm_1(self.Conv_1(h))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return F.relu(x + h)


class Backbone(nn.Module):
    """ResNet-lite feature extractor: (B, H, W, 3) uint8 ->
    (B, H/16, W/16, width * 2^(len(depths)-1))."""

    def __init__(self, width: int = 64, depths: Sequence[int] = (2, 2, 2),
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(3, width, 7, 4, dtype)
        self.GroupNorm_0 = GroupNorm(width, 8, dtype)
        ch, cin, n = width, width, 0
        for stage, depth in enumerate(depths):
            for i in range(depth):
                stride = 2 if (i == 0 and stage > 0) else 1
                setattr(self, f"ResBlock_{n}",
                        ResBlock(cin, ch, stride, dtype))
                cin, n = ch, n + 1
            ch *= 2
        self.blocks = n
        self.out_ch = cin

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype) / 255.0
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        for i in range(self.blocks):
            x = getattr(self, f"ResBlock_{i}")(x)
        return x.permute(0, 2, 3, 1)


class MoEMlp(nn.Module):
    """Top-1 routed mixture-of-experts MLP over (B, T, C) tokens: dense
    experts, selected by the router's one-hot (first index on ties)."""

    def __init__(self, ch: int, num_experts: int = 4, hidden: int = 256,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_experts, self.dtype = num_experts, dtype
        self.router = Dense(ch, num_experts, dtype)
        self.w1 = nn.Parameter(torch.zeros(num_experts, ch, hidden))
        self.w2 = nn.Parameter(torch.zeros(num_experts, hidden, ch))

    def init_(self, gen: torch.Generator) -> None:
        e, c, h = self.w1.shape
        _lecun_(self.w1, c * e, gen)
        _lecun_(self.w2, h * e, gen)

    def forward(self, x):
        gate = self.router(x)
        probs = torch.softmax(gate.float(), dim=-1)
        sel = F.one_hot(probs.argmax(dim=-1), self.num_experts).to(x.dtype)
        h = torch.einsum("btc,ech->bteh", x, self.w1.to(self.dtype))
        h = F.relu(h)
        y = torch.einsum("bteh,ehc->btec", h, self.w2.to(self.dtype))
        return torch.einsum("btec,bte->btc", y, sel)


class TemporalBlock(nn.Module):
    """Pre-norm MHA + MoE-MLP over the time axis of (B, T, C) tokens.
    `attn_fn(q, k, v)` over (B, T, H, D) swaps in ring attention; None
    is plain exact attention."""

    def __init__(self, ch: int, heads: int = 4, dtype=torch.bfloat16,
                 attn_fn: Optional[Callable] = None):
        super().__init__()
        self.heads, self.dtype, self.attn_fn = heads, dtype, attn_fn
        self.LayerNorm_0 = LayerNorm(ch, dtype)
        self.qkv = Dense(ch, 3 * ch, dtype)
        self.proj = Dense(ch, ch, dtype)
        self.LayerNorm_1 = LayerNorm(ch, dtype)
        self.MoEMlp_0 = MoEMlp(ch, dtype=dtype)

    def forward(self, x):
        B, T, C = x.shape
        D = C // self.heads
        h = self.LayerNorm_0(x)
        qkv = self.qkv(h)
        q, k, v = qkv.reshape(B, T, 3 * self.heads, D).split(self.heads,
                                                             dim=2)
        attn = self.attn_fn or reference_attention
        att = attn(q, k, v).reshape(B, T, C)
        x = x + self.proj(att)
        h = self.LayerNorm_1(x)
        return x + self.MoEMlp_0(h)


class DeconvHead(nn.Module):
    """SimpleBaseline-style upsampling head: (N, h, w, C) ->
    (N, 4h, 4w, keypoints) float32 heatmaps."""

    def __init__(self, cin: int, keypoints: int = 17,
                 dtype=torch.bfloat16):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(cin, 128, 4, 2, dtype)
        self.ConvTranspose_1 = ConvTranspose(128, 128, 4, 2, dtype)
        self.Conv_0 = Conv(128, keypoints, 1, 1, torch.float32)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.ConvTranspose_0(x))
        x = F.relu(self.ConvTranspose_1(x))
        return self.Conv_0(x).permute(0, 2, 3, 1)


def init_module_(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from `seed`: LeCun-normal kernels (truncated at two
    standard deviations), zero biases, unit norm scales — the flax
    initializers' distributions, not their bits."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if hasattr(mod, "init_"):
            mod.init_(gen)
    return model
