"""Ring attention: exact attention over sequences split across ranks.

The counterpart of the JAX package's parallel/ring_attention.py.  Each
rank holds one block of Tl positions of q, k and v (B, Tl, H, D); K/V
blocks rotate one rank down the ring (rank j sends to rank j - 1) while
each rank keeps flash-style online-softmax accumulators (m, l, acc) for
its local queries, so memory is O(T / n) per rank and the result is
exact.  The ring is a `torch.distributed` process group; `group=None` is
a ring of one rank, which needs no communication at all.

Two implementations, as in the JAX package:

  * impl="xla": the plain tiled ring in torch (the JAX package's XLA
    path), differentiable by autograd;
  * impl="cuda": each ring step is one `flash_block_update`
    (kernels/attention.py: the hand-written CUDA kernel on the card, its
    plain version on the CPU).  The kernel has no backward, so the
    backward pass recomputes through the plain ring with autograd, as
    the JAX package's custom_vjp does (ring_attention.py:208-219).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

# the kernel's masked-row guards compare the m carry this module
# initializes against the same sentinel
from ..kernels.attention import NEG_INF, _block_size, flash_block_update


def _flash_block_k(tl: int, block_k: Optional[int]) -> int:
    """Largest divisor of the local block length <= the requested tile."""
    if block_k is not None and block_k < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    return _block_size(tl, block_k or 512)


def _ring(group) -> Tuple[int, int]:
    """(ring size, this rank's index in it); one rank for group=None."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _exchange(xs, group, step: int) -> Tuple[List[torch.Tensor], list]:
    """Send each tensor to ring rank idx + step and receive its
    counterpart from idx - step; returns (receive buffers, pending
    work).  The buffers are valid once every work item has waited."""
    n, idx = _ring(group)
    dst = dist.get_global_rank(group, (idx + step) % n)
    src = dist.get_global_rank(group, (idx - step) % n)
    sends = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in sends]
    ops = [dist.P2POp(dist.isend, x, dst, group) for x in sends]
    ops += [dist.P2POp(dist.irecv, o, src, group) for o in outs]
    return outs, [dist.batch_isend_irecv(ops), sends]


def _wait(pending: list) -> None:
    for works, _ in pending:
        for w in works:
            w.wait()
    pending.clear()


class _Rotate(torch.autograd.Function):
    """K/V one step down the ring (rank j -> j - 1), issued without
    waiting: the caller waits on `pending` after the step's compute.  Its
    gradient travels the other way."""

    @staticmethod
    def forward(ctx, group, pending, *xs):
        ctx.group = group
        outs, work = _exchange(xs, group, -1)
        pending.append(work)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        outs, work = _exchange(grads, ctx.group, +1)
        _wait([work])
        return (None, None) + tuple(outs)


def _ring_attention_block(q, k, v, group, causal: bool,
                          scale: Optional[float],
                          block_k: Optional[int] = None):
    """The plain tiled ring: q, k, v are this rank's (B, Tl, H, D)
    blocks.  Each arriving K/V block is consumed in `block_k`-wide tiles,
    so the logits are (B, H, Tl, block_k) per tile."""
    n, idx = _ring(group)
    B, Tl, H, D = q.shape
    s = scale if scale is not None else (D ** -0.5)
    qf = q.float() * s
    bk = _flash_block_k(Tl, block_k)
    dev = q.device
    m = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=dev)
    q_pos = idx * Tl + torch.arange(Tl, device=dev)

    def tile_update(m, l, acc, ks, vs, k_pos):
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, ks.float())
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # guard fully-masked rows (m_new == NEG_INF) against NaNs
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.exp(logits - m_safe[..., None])
        p = torch.where(torch.isfinite(logits), p, 0.0)
        correction = torch.where(m <= NEG_INF / 2, 0.0,
                                 torch.exp(m - m_safe))
        l_new = l * correction + p.sum(dim=-1)
        acc_new = acc * correction[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vs.float())
        return m_new, l_new, acc_new

    kb, vb = k, v
    pending: list = []
    for i in range(n):
        # the block arriving at step i originated on rank (idx + i) % n
        src = (idx + i) % n
        # issue the rotation FIRST: the tiles below only read the current
        # buffers, so the transfer runs under this step's compute
        if i < n - 1:
            kb_next, vb_next = _Rotate.apply(group, pending, kb, vb)
        for j in range(Tl // bk):
            ks = kb[:, j * bk:(j + 1) * bk]
            vs = vb[:, j * bk:(j + 1) * bk]
            k_pos = src * Tl + j * bk + torch.arange(bk, device=dev)
            m, l, acc = tile_update(m, l, acc, ks, vs, k_pos)
        if i < n - 1:
            _wait(pending)
            kb, vb = kb_next, vb_next
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)  # (B, Tl, H, D)


def _ring_attention_block_cuda(q, k, v, group, causal: bool,
                               scale: Optional[float],
                               block_q: Optional[int] = None,
                               block_k: Optional[int] = None):
    """The kernel ring: each arriving K/V block is consumed by ONE
    flash_block_update, with q_off = rank * Tl and k_off = src * Tl."""
    n, idx = _ring(group)
    B, Tl, H, D = q.shape
    s = scale if scale is not None else (D ** -0.5)
    # (B, Tl, H, D) -> (B*H, Tl, D): per-head rows for the kernel
    qf = (q.float() * s).permute(0, 2, 1, 3).reshape(B * H, Tl, D)
    dev = q.device
    m = torch.full((B * H, Tl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B * H, Tl), dtype=torch.float32, device=dev)
    acc = torch.zeros((B * H, Tl, D), dtype=torch.float32, device=dev)
    bq, bk = block_q or 256, block_k or 256
    kb, vb = k, v
    pending: list = []
    for i in range(n):
        src = (idx + i) % n
        if i < n - 1:
            kb_next, vb_next = _Rotate.apply(group, pending, kb, vb)
        kf = kb.permute(0, 2, 1, 3).reshape(B * H, Tl, D)
        vf = vb.permute(0, 2, 1, 3).reshape(B * H, Tl, D)
        m, l, acc = flash_block_update(qf, kf, vf, m, l, acc, idx * Tl,
                                       src * Tl, causal=causal, block_q=bq,
                                       block_k=bk)
        if i < n - 1:
            _wait(pending)
            kb, vb = kb_next, vb_next
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    out = out.reshape(B, H, Tl, D)
    return out.permute(0, 2, 1, 3).to(q.dtype)  # (B, Tl, H, D)


class _KernelRing(torch.autograd.Function):
    """Forward through the kernel ring; backward recomputes through the
    plain ring with autograd."""

    @staticmethod
    def forward(ctx, q, k, v, fwd, plain):
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain
        return fwd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.plain(*leaves)
        grads = torch.autograd.grad(out, leaves, g)
        return tuple(grads) + (None, None)


def make_ring_attention(group=None, causal: bool = False,
                        scale: Optional[float] = None,
                        block_k: Optional[int] = None, impl: str = "xla",
                        block_q: Optional[int] = None):
    """Returns attn(q, k, v) over this rank's (B, Tl, H, D) blocks of a
    sequence split over the ranks of `group` (None: one rank).  `block_k`
    bounds the plain ring's tile width (default 512, clipped to a
    divisor of the local block).

    impl="cuda" runs each ring step through the flash kernel (forward
    only; the backward recomputes through the plain ring, so gradients
    are those of impl="xla"); `block_q`/`block_k` default to 256 and are
    validated as the TPU kernel's tiles are."""
    def plain(q, k, v):
        return _ring_attention_block(q, k, v, group, causal, scale, block_k)

    if impl == "xla":
        return plain
    if impl != "cuda":
        raise ValueError(f"impl must be 'xla' or 'cuda', got {impl!r}")
    for name, b in (("block_q", block_q), ("block_k", block_k)):
        if b is not None and b < 1:
            raise ValueError(f"{name} must be >= 1, got {b}")

    def fwd(q, k, v):
        return _ring_attention_block_cuda(q, k, v, group, causal, scale,
                                          block_q, block_k)

    def attn(q, k, v):
        return _KernelRing.apply(q, k, v, fwd, plain)

    return attn


def reference_attention(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Single-rank exact attention for testing ring equivalence (and the
    temporal block's attention when it is given no attn_fn)."""
    B, T, H, D = q.shape
    s = scale if scale is not None else (D ** -0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * s, k.float())
    if causal:
        mask = torch.arange(T, device=q.device)[:, None] \
            >= torch.arange(T, device=q.device)[None, :]
        logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return out.permute(0, 2, 1, 3).to(q.dtype)
