"""The flash-attention block update, a hand-written CUDA kernel and its
plain version; and the model path's attention with a decomposed
relative-position bias (`rel_pos_attention`).

The counterpart of the JAX package's kernels/pallas_attention.py.  Ring
attention (parallel/ring_attention.py) consumes one arriving K/V block
per ring step with one `flash_block_update`, which updates the
online-softmax state (m, l, acc) of the local queries.  As in
kernels/cuda_ops.py, three parts sit side by side:

  * the wrapper `flash_block_update`, which launches the kernel
    (csrc/flash_attention.cu) on CUDA tensors and runs the plain version
    on CPU tensors.  It raises on anything else: there is no fallback
    from the kernel to the plain version;
  * `flash_block_update_plain`, the Pallas body's formulas line for
    line (pallas_attention.py:63-94), over the same K tiles as the TPU
    grid;
  * `flash_launches`, which the wrapper adds one to where it launches
    the kernel and nowhere else.

The kernel runs both products on the tensor cores in TF32;
`tf32_operand` gives the values it multiplies (`TF32_ROUNDING` says how
each operand gets there), so the plain version fed those operands is
the tight reference the card's checks hold it against.  The kernel is
compiled with nvcc for sm_90a into `_build/` at first use and called
through ctypes on PyTorch's current stream.

`rel_pos_attention` is attention over a grid of keys with a decomposed
relative-position bias, as a ViT with per-axis relative positions has
it (models/sam.py calls it): softmax(q k^T / sqrt(d) + rel_h + rel_w)
v, where the bias of query i and key j is rel_h[i, row of j] +
rel_w[i, column of j].
It builds that bias in full, in the inputs' dtype, and hands it to
`torch.nn.functional.scaled_dot_product_attention` as a float mask
(bf16 on the card, where SDPA picks a kernel that takes a bias; flash
attention takes none).  The JAX package has no counterpart.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .. import native
from .cuda_ops import build_kernel_library

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # csrc/flash_attention.cu kMaxD

# how the kernel turns each f32 input into the TF32 value the tensor
# cores multiply (csrc/flash_attention.cu, "Precision"): q and v are
# rounded to nearest, ties away from zero (cvt.rna), as are the
# probabilities p it computes itself; k is truncated (the tensor core
# drops its low 13 bits as it reads it)
TF32_ROUNDING = {"q": "rna", "k": "trunc", "v": "rna"}

# launches of the flash kernel (csrc/flash_attention.cu) in this process
flash_launches = 0

# rel_pos_attention lays each bias row out at a multiple of this many
# elements: SDPA pads a float mask whose strides (but the last, 1) are
# not multiples of 8 into a new copy before its memory-efficient
# kernel reads it, and S = 196 in a 14 x 14 window is not
BIAS_ALIGN = 8

_SRC = os.path.join(native.PKG_DIR, "csrc", "flash_attention.cu")
_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_counts() -> None:
    global flash_launches
    flash_launches = 0


def load_library():
    """Build (first use only) and load the flash kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_kernel_library("libscanner_flash.so",
                                                   _SRC))
            vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.flash_block_update_f32.argtypes = (
                [vp] * 10 + [ll, ll, ll, ci, ci, ll, ll, ci, vp])
            lib.flash_block_update_f32.restype = ci
            _lib = lib
    return _lib


def _block_size(tl: int, want: int) -> int:
    """Largest divisor of tl that is <= want (pallas_attention.py:97)."""
    if want < 1:
        raise ValueError(f"block size must be >= 1, got {want}")
    b = min(tl, want)
    while tl % b:
        b -= 1
    return b


def tf32_operand(x: torch.Tensor, rounding: str = "rna") -> torch.Tensor:
    """The TF32 value the tensor cores see for each f32 element of x,
    as an f32 tensor with the low 13 mantissa bits zero.

    rounding="rna": round to nearest, ties away from zero, as PTX's
    cvt.rna.tf32.f32 does (the kernel's q, v and p); "trunc": drop the
    low 13 bits (the kernel's k).  inf stays inf, NaN stays NaN; a
    finite value that rounds past the largest TF32 becomes inf, as
    cvt.rna does."""
    if rounding not in ("rna", "trunc"):
        raise ValueError(f"rounding must be 'rna' or 'trunc', got "
                         f"{rounding!r}")
    x = x.float()
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if rounding == "rna":
        bits = bits + 0x1000
    bits = bits & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    out = bits.to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


def _check(q, k, v, m, l, acc) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_block_update wants q (BH, Tq, D) and k, v "
                         "(BH, Tk, D)")
    BH, Tq, D = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tuple(m.shape) != (BH, Tq) or tuple(l.shape) != (BH, Tq) \
            or tuple(acc.shape) != (BH, Tq, D):
        raise ValueError(f"carry shapes m {tuple(m.shape)}, l "
                         f"{tuple(l.shape)}, acc {tuple(acc.shape)} do not "
                         f"match q {tuple(q.shape)}")
    devs = {t.device for t in (q, k, v, m, l, acc)}
    if len(devs) != 1:
        raise ValueError(f"flash_block_update inputs on several devices: "
                         f"{sorted(map(str, devs))}")


def flash_block_update_plain(q, k, v, m, l, acc, q_off, k_off, *,
                             causal: bool = False, block_q: int = 256,
                             block_k: int = 256):
    """The plain version: the Pallas body over K tiles of
    `_block_size(Tk, block_k)` keys, in order (the kv axis of the TPU
    grid).  Returns (m, l, acc) in float32."""
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    _block_size(Tq, block_q)
    bk = _block_size(Tk, block_k)
    qf, kf, vf = q.float(), k.float(), v.float()
    m, l, acc = m.float(), l.float(), acc.float()
    q_pos = q_off + torch.arange(Tq, device=q.device)
    for j in range(Tk // bk):
        ks = kf[:, j * bk:(j + 1) * bk]
        vs = vf[:, j * bk:(j + 1) * bk]
        logits = torch.bmm(qf, ks.transpose(1, 2))        # (BH, Tq, bk)
        if causal:
            k_pos = k_off + j * bk + torch.arange(bk, device=q.device)
            logits = torch.where(q_pos[:, None] >= k_pos[None, :], logits,
                                 NEG_INF)
        m_blk = logits.amax(dim=2)
        m_new = torch.maximum(m, m_blk)
        # fully-masked rows keep m == NEG_INF; exp against a zero pivot
        # and zero correction so they contribute nothing, with no NaN/inf
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.exp(logits - m_safe[..., None])
        p = torch.where(logits <= NEG_INF / 2, 0.0, p)
        corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=2)
        pv = torch.bmm(p, vs)
        m = m_new
        acc = acc * corr[..., None] + pv
    return m, l, acc


def flash_block_update(q, k, v, m, l, acc, q_off, k_off, *,
                       causal: bool = False, block_q: int = 256,
                       block_k: int = 256):
    """One flash update of online-softmax state with a K/V block.

    q: (BH, Tq, D) queries, ALREADY scaled by 1/sqrt(D).
    k, v: (BH, Tk, D) the arriving block.
    m, l: (BH, Tq) running max / normaliser;  acc: (BH, Tq, D).
    q_off, k_off: global positions of q[., 0] / k[., 0] (causal mask).
    `block_q`/`block_k` are validated as the TPU kernel's tiles are; the
    CUDA kernel walks its own tiles (128 queries by 64 keys) and masks
    ragged edges.  Returns new (m, l, acc) in float32.

    CUDA tensors: the hand-written kernel (csrc/flash_attention.cu),
    D <= 128; its products run in TF32 on the tensor cores
    (`TF32_ROUNDING`), with f32 accumulation and an f32 softmax.  Its
    tensor maps need rows of a multiple of 16 bytes, so where D % 4 != 0
    q, k and v are copied into buffers with zero columns up to the next
    multiple of 4 (they change neither q . k nor the kept columns of
    acc, which the kernel reads and writes at width D).  Each call also
    writes V^T into a scratch buffer of (BH, D, Tk) f32.  CPU tensors:
    the plain version."""
    _check(q, k, v, m, l, acc)
    q_off, k_off = int(q_off), int(k_off)
    dev = q.device
    if dev.type == "cpu":
        return flash_block_update_plain(q, k, v, m, l, acc, q_off, k_off,
                                        causal=causal, block_q=block_q,
                                        block_k=block_k)
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {dev}")
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    _block_size(Tq, block_q)
    _block_size(Tk, block_k)
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes head dim <= {MAX_HEAD_DIM}, "
                         f"got {D}")
    Dp = -(-D // 4) * 4
    q, k, v = (_tma_operand(t, Dp) for t in (q, k, v))
    m, l, acc = (t.float().contiguous() for t in (m, l, acc))
    vt = torch.empty((BH, Dp, -(-Tk // 8) * 8), dtype=torch.float32,
                     device=dev)
    m_o = torch.empty_like(m)
    l_o = torch.empty_like(l)
    acc_o = torch.empty_like(acc)
    lib = load_library()
    global flash_launches
    with torch.cuda.device(dev):
        err = lib.flash_block_update_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), vt.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), m_o.data_ptr(),
            l_o.data_ptr(), acc_o.data_ptr(), BH, Tq, Tk, D, Dp, q_off,
            k_off, int(causal), torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise RuntimeError(f"flash kernel: encoding a TMA tensor map "
                           f"failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {err}")
    with _count_lock:
        flash_launches += 1
    return m_o, l_o, acc_o


def _tma_operand(t: torch.Tensor, Dp: int) -> torch.Tensor:
    """t as the kernel's TMA loads want it: contiguous f32 (BH, T, Dp)
    from a 16-byte aligned address, zero columns past t's own D."""
    t = t.float()
    if t.shape[-1] != Dp:
        return torch.nn.functional.pad(t, (0, Dp - t.shape[-1]))
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def rel_pos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      rel_h: torch.Tensor, rel_w: torch.Tensor
                      ) -> torch.Tensor:
    """Attention over a kh x kw grid of keys with a decomposed
    relative-position bias.

    q, k, v: (N, heads, S, d) with S = kh * kw keys in row-major order
    (q may hold as many queries); rel_h: (N, heads, S, kh) and rel_w:
    (N, heads, S, kw), each query's terms for a key's row and column.
    Returns (N, heads, S, d): softmax(q k^T / sqrt(d) + bias) v with
    bias[i, (r, c)] = rel_h[i, r] + rel_w[i, c], built in q's dtype."""
    n, h, s, _ = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    if kh * kw != k.shape[2]:
        raise ValueError(f"rel_h, rel_w give a {kh} x {kw} key grid for "
                         f"{k.shape[2]} keys")
    width = -(-k.shape[2] // BIAS_ALIGN) * BIAS_ALIGN
    bias = torch.empty((n, h, s, width), dtype=q.dtype,
                       device=q.device)[..., :k.shape[2]]
    torch.add(rel_h.to(q.dtype).unsqueeze(-1),
              rel_w.to(q.dtype).unsqueeze(-2),
              out=bias.view(n, h, s, kh, kw))
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=bias)
