"""Stencil halo exchange between neighbor processes of a process group.

Capability parity: the reference's stencil scheduling gives each task the
extra boundary rows its temporal window needs (derive_stencil_requirements,
dag_analysis.cpp:1328; REPEAT_EDGE boundary).  When a stream's rows are
instead split over the members of a gang (engine/gang.py sharded
members), the same boundary rows move as a **halo exchange between
neighbor shards**: a pair of point-to-point shifts over the gang's
process group (`dist.batch_isend_irecv`, the pattern
parallel/ring_attention.py uses), edge shards repeating their own edge
rows.  `sharded_stencil_map` and `temporal_diff` do the same over device
tensors: a DTensor split on its rows over a mesh axis, the shifts
point-to-point ops on that axis's group.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np

# message tags of the two shifts, so a pair of neighbors exchanging
# both halos never matches one shift's block against the other's
_TAG_LEFT, _TAG_RIGHT = 1, 2


def _bytes_tensor(a: np.ndarray):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)
                            .view(np.uint8))


def _halo_exchange_block(x: np.ndarray, lo: int, hi: int, group,
                         ) -> np.ndarray:
    """Extend this rank's row block `x` with `lo` trailing rows of the
    left neighbor and `hi` leading rows of the right neighbor.  Edge
    shards repeat their own edge (REPEAT_EDGE, matching the engine's
    stencil boundary).  Every rank of `group` calls this together with
    the same (lo, hi) and blocks of one shape and dtype."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    r = dist.get_rank(group)

    def peer(q):
        return dist.get_global_rank(group, q)

    x = np.ascontiguousarray(x)
    left = np.repeat(x[:1], lo, axis=0)
    right = np.repeat(x[-1:], hi, axis=0)
    ops = []
    # left halo: my last lo rows go right, my left neighbor's come in
    if lo > 0 and r < n - 1:
        ops.append(dist.P2POp(dist.isend, _bytes_tensor(x[-lo:]),
                              peer(r + 1), group, _TAG_LEFT))
    if lo > 0 and r > 0:
        left = np.empty_like(left)
        ops.append(dist.P2POp(dist.irecv, _bytes_tensor(left),
                              peer(r - 1), group, _TAG_LEFT))
    # right halo: my first hi rows go left, my right neighbor's come in
    if hi > 0 and r > 0:
        ops.append(dist.P2POp(dist.isend, _bytes_tensor(x[:hi]),
                              peer(r - 1), group, _TAG_RIGHT))
    if hi > 0 and r < n - 1:
        right = np.empty_like(right)
        ops.append(dist.P2POp(dist.irecv, _bytes_tensor(right),
                              peer(r + 1), group, _TAG_RIGHT))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return np.concatenate([left, x, right], axis=0)


def warm_halo_exchange(mesh, shape, dtype, lo: int, hi: int,
                       axis: str = "hosts") -> None:
    """Run one throwaway exchange on zeros of the real block geometry so
    the group's first point-to-point setup between each neighbor pair
    (gloo connects a pair on its first exchange) happens OUTSIDE any
    timed region.  Every process of the mesh axis must call this
    together, with identical arguments."""
    exchange_row_halo(mesh, np.zeros(shape, dtype), lo, hi, axis)


def exchange_row_halo(mesh, local_block, lo: int, hi: int,
                      axis: str = "hosts") -> Tuple[np.ndarray,
                                                    np.ndarray]:
    """Exchange boundary rows of a row-sharded block between neighbor
    processes and return (left_halo, right_halo) as host ndarrays —
    THIS process's view of its neighbors' edges.

    `local_block` is this process's (chunk, ...) rows of a sequence laid
    out contiguously over the mesh's `axis` (every process passes the
    SAME chunk count; the gang pads uneven tails before calling).  Edge
    shards see REPEAT_EDGE copies of their own rows in the returned
    halos — callers that own real data beyond the global boundary must
    source those rows themselves.
    """
    local_block = np.ascontiguousarray(local_block)
    chunk = int(local_block.shape[0])
    if max(lo, hi) > chunk:
        raise ValueError(
            f"halo ({lo},{hi}) exceeds the per-shard block of {chunk} "
            f"rows; multi-hop halos are not supported")
    out = _halo_exchange_block(local_block, lo, hi, mesh.get_group(axis))
    return out[:lo], out[lo + chunk:lo + chunk + hi]


def _halo_exchange_tensor(x, lo: int, hi: int, group):
    """`_halo_exchange_block` over a tensor on this rank's device: the
    same two shifts, the same REPEAT_EDGE at the edge shards."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group)
    r = dist.get_rank(group)

    def peer(q):
        return dist.get_global_rank(group, q)

    x = x.contiguous()
    left = x[:1].repeat((lo,) + (1,) * (x.dim() - 1))
    right = x[-1:].repeat((hi,) + (1,) * (x.dim() - 1))
    ops = []
    if lo > 0 and r < n - 1:
        ops.append(dist.P2POp(dist.isend, x[-lo:].contiguous(), peer(r + 1),
                              group, _TAG_LEFT))
    if lo > 0 and r > 0:
        ops.append(dist.P2POp(dist.irecv, left, peer(r - 1), group,
                              _TAG_LEFT))
    if hi > 0 and r > 0:
        ops.append(dist.P2POp(dist.isend, x[:hi].contiguous(), peer(r - 1),
                              group, _TAG_RIGHT))
    if hi > 0 and r < n - 1:
        ops.append(dist.P2POp(dist.irecv, right, peer(r + 1), group,
                              _TAG_RIGHT))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([left, x, right], dim=0)


def sharded_stencil_map(fn: Callable, stencil: Sequence[int], mesh,
                        axis: str = "sp"):
    """Lift a per-window function to a sequence-sharded DTensor.

    fn(window_block) maps a block of shape (m + lo + hi, ...) to outputs
    (m, ...) where lo = -min(stencil), hi = max(stencil); the returned
    callable takes a DTensor whose rows (dim 0) are split over `axis` of
    the DeviceMesh `mesh` and returns one placed alike, every output row
    computed with the neighbor halos exchanged between the axis's ranks.
    """
    from torch.distributed.tensor import DTensor, Shard

    lo = max(0, -min(stencil))
    hi = max(0, max(stencil))
    i = mesh.mesh_dim_names.index(axis)
    n = mesh.size(i)

    def wrapper(x):
        if not isinstance(x, DTensor) or x.placements[i] != Shard(0):
            raise ValueError(f"sharded_stencil_map takes a DTensor with "
                             f"its rows split over '{axis}'")
        block = x.shape[0] // n
        if max(lo, hi) > block:
            raise ValueError(
                f"stencil halo ({lo},{hi}) exceeds the per-shard block of "
                f"{block} rows ({x.shape[0]} rows over {n} '{axis}' shards);"
                f" multi-hop halos are not supported — use fewer shards or "
                f"a narrower stencil")
        padded = _halo_exchange_tensor(x.to_local(), lo, hi,
                                       mesh.get_group(i))
        return DTensor.from_local(fn(padded), mesh, x.placements,
                                  run_check=False)

    return wrapper


def temporal_diff(mesh, axis: str = "sp"):
    """Example/standard op: frame-to-previous-frame difference over a
    sequence sharded across ranks (the shot-detection primitive)."""
    def block(padded):
        # padded has 1 halo row on the left
        return padded[1:] - padded[:-1]

    return sharded_stencil_map(block, stencil=[-1, 0], mesh=mesh, axis=axis)
