"""In-program pipeline parallelism (the 'pp' mesh axis).

The counterpart of the JAX package's parallel/pp.py.  The engine's task
pipeline already gives inter-node pipelining; this module adds the
in-program counterpart for models whose repeated trunk is too large for
one card: a GPipe microbatch schedule —

* stage parameters are stacked on a leading axis that is split over
  'pp' (Shard(0) there), so each pp rank holds exactly its stage;
* the M + S - 1 schedule steps run in order; every step each rank
  applies its stage and hands its activation to the next rank with one
  point-to-point hop (`_Shift`, whose backward hands the cotangent back,
  as ring attention's `_Rotate` does);
* bubble steps compute on clamped inputs and are masked out of the
  output, so their cotangents are zero.  Every rank runs the same ops in
  the same order, so the backward passes' hops pair up across ranks.

Composes with 'dp' (each dp row of the mesh runs its own pipeline over
its pp group).  The stage function must be collective-free.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from .collectives import all_reduce


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> List[Any]:
    out: List[Any] = []
    _tree_map(out.append, tree)
    return out


def stack_stage_params(params_list: Sequence[Any]):
    """Stack S per-stage parameter trees (dicts / lists of tensors) into
    one tree whose leaves have a leading stage axis (the axis
    `make_pipeline` splits over 'pp').  All stages share a structure."""
    first = params_list[0]
    flat = [_leaves(p) for p in params_list]
    stacked = iter([torch.stack([torch.as_tensor(f[i]) for f in flat])
                    for i in range(len(flat[0]))])
    return _tree_map(lambda _: next(stacked), first)


class _Shift(torch.autograd.Function):
    """Activation hop stage r -> r + 1 along the pp group: rank r sends
    `y` to r + 1 and returns what r - 1 sent (zeros on rank 0).  The
    backward sends the cotangent back to r - 1."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _hop(y.contiguous(), group, +1)

    @staticmethod
    def backward(ctx, g):
        return _hop(g.contiguous(), ctx.group, -1), None


def _hop(x: torch.Tensor, group, step: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.zeros_like(x)
    ops = []
    if 0 <= r + step < n:
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, r + step), group))
    if 0 <= r - step < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, r - step), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def make_pipeline(mesh, stage_fn: Callable[[Any, Any], Any],
                  num_microbatches: int, axis: str = "pp"):
    """Build `pipe(stacked_params, x) -> y` running `stage_fn`
    sequentially across the ranks of `axis` of the DeviceMesh `mesh`
    with a microbatched GPipe schedule.

    stage_fn(stage_params, x) must map (mb, ...) -> (mb, ...) with an
    unchanged shape/dtype (a repeated trunk block).  The leaves of
    `stacked_params` carry a leading stage axis of S: DTensors or
    sharded parameters (distributed.shard_params_) split on it over
    `axis` (each rank reads its own stage), or whole stacks (rank r
    reads entry r).  x is this rank's (b, ...) batch shard, b
    divisible by num_microbatches; the result equals
    stage_{S-1}(... stage_0(x)) on every rank of `axis` (a
    differentiable all-reduce of the last stage's masked output).
    """
    i = mesh.mesh_dim_names.index(axis)
    S = mesh.size(i)
    M = int(num_microbatches)
    if M < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {M}")
    rank = mesh.get_local_rank(i)
    group = mesh.get_group(i)

    def stages(a):
        """(stages, this rank's stage) of a stacked leaf: a DTensor, a
        sharded parameter (distributed.shard_params_) or a whole stack."""
        if isinstance(a, DTensor):
            full, mine, split = a.shape, a.to_local(), a.placements[i]
        elif hasattr(a, "sharding"):
            full, mine, split = a.global_shape, a, a.sharding.placements[i]
        else:
            return a.shape[0], a[rank]
        return full[0], mine[0] if split == Shard(0) else mine[rank]

    def pipe(stacked_params, x):
        split = [stages(a) for a in _leaves(stacked_params)]
        for n_stages, _ in split:
            if n_stages != S:
                raise ValueError(
                    f"stacked stage axis has {n_stages} stages but "
                    f"mesh axis '{axis}' has {S} ranks; they must match "
                    f"(each rank runs exactly one stage)")
        b = x.shape[0]
        if b % M:
            raise ValueError(
                f"per-shard batch {b} not divisible by "
                f"num_microbatches {M}")
        mine = iter([m for _, m in split])
        p_loc = _tree_map(lambda _: next(mine), stacked_params)
        xm = x.reshape((M, b // M) + tuple(x.shape[1:]))
        if S > 1:
            first = torch.tensor(rank == 0, device=x.device)
            buf = torch.zeros_like(xm[0])
        outs = [None] * M
        for t in range(M + S - 1):
            # stage 0 injects microbatch t (clamped in bubble steps);
            # later stages consume the hop buffer
            x_in = xm[min(t, M - 1)]
            if S > 1:
                x_in = torch.where(first, x_in, buf)
            y = stage_fn(p_loc, x_in)
            if S > 1 and t < M + S - 2:
                buf = _Shift.apply(y, group)
            # the last stage retires microbatch t - (S - 1)
            if t >= S - 1:
                outs[t - (S - 1)] = y
        out = torch.stack(outs)
        if S > 1:
            # results live on the last rank; the sum of the masked value
            # replicates them over the pipeline axis
            out = all_reduce(out * float(rank == S - 1), group)
        return out.reshape(x.shape)

    return pipe
