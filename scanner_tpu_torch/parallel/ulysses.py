"""Ulysses-style sequence parallelism: all-to-all head-sharded attention.

The counterpart of the JAX package's parallel/ulysses.py and the
complement of ring attention (`ring_attention.py`) for sequences split
across ranks.  Where the ring rotates K/V blocks around the `sp` group
(n steps of neighbor traffic, memory O(T/n)), Ulysses re-shards ONCE: an
all-to-all turns time-sharded/full-heads blocks into head-sharded/
full-time ones, each rank runs plain full attention for its head group,
and a reverse all-to-all restores the time sharding (DeepSpeed Ulysses,
Jacobs et al. 2023).  Both all-to-alls are differentiable
(parallel/collectives.py), so gradients flow back the same way.

Trade-offs: two all-to-alls per call against the ring's n point-to-point
steps; heads % ranks == 0 is required and the full (T, T) logits of
H / n heads are materialized, so the regime is moderate T with spare
head parallelism; the ring wins at extreme T.

Both share the (B, Tl, H, D) per-rank contract, so model code
(`TemporalBlock(attn_fn=...)`) can swap them freely.
"""

from __future__ import annotations

from typing import Optional

from .collectives import all_to_all
from .ring_attention import reference_attention


def make_ulysses_attention(mesh, axis: str = "sp", causal: bool = False,
                           scale: Optional[float] = None):
    """Returns attn(q, k, v) over this rank's (B, Tl, H, D) blocks of a
    sequence split over `axis` of the DeviceMesh `mesh` — the same
    contract as make_ring_attention, interchangeable in
    TemporalBlock(attn_fn=...)."""
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def to_heads(x):
        # (B, Tl, H, D) -> (B, T, H/n, D): head group j goes to rank j,
        # rank j's time block comes back as block j of T
        B, Tl, H, D = x.shape
        x = x.reshape(B, Tl, n, H // n, D).permute(2, 0, 1, 3, 4)
        x = all_to_all(x, group)                  # (n, B, Tl, H/n, D)
        return x.permute(1, 0, 2, 3, 4).reshape(B, n * Tl, H // n, D)

    def from_heads(x):
        # (B, T, H/n, D) -> (B, Tl, H, D): the reverse exchange
        B, T, h, D = x.shape
        x = x.reshape(B, n, T // n, h, D).permute(1, 0, 2, 3, 4)
        x = all_to_all(x, group)                  # (n, B, Tl, H/n, D)
        return x.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * h, D)

    def attn(q, k, v):
        H = q.shape[2]
        if H % n:
            raise ValueError(
                f"ulysses attention needs heads ({H}) divisible by the "
                f"'{axis}' axis size ({n}); use ring attention otherwise")
        # full-T plain attention on the local head group — shared math
        # with the single-rank path so masking/scaling can never diverge
        out = reference_attention(to_heads(q), to_heads(k), to_heads(v),
                                  causal=causal, scale=scale)
        return from_heads(out)

    return attn
