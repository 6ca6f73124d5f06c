"""Differentiable collectives for in-program sharding, and the helpers
the model layers read off a sharded parameter.

The JAX package leaves every collective of its sharded train step to
GSPMD.  Here each one is explicit, as a `torch.autograd.Function` whose
backward is the collective's adjoint:

    all_reduce   sum over a group; backward: sum of the cotangents
    all_gather   concatenate every rank's block along a dim; backward:
                 this rank's block of the summed cotangents
    all_to_all   equal blocks of dim 0, block j to rank j; backward: the
                 same exchange of the cotangents

With adjoints, a rank's backward pass gives the gradient of the SUM of
every rank's loss, and a parameter replicated over an axis gets its
total gradient from a sum over that axis (models/pose.py
make_sharded_train_step).  Every rank of `group` calls each of these
together, in the same order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def shard_group(t) -> Optional[Tuple[object, int, int, int]]:
    """(group, rank in it, ranks, tensor dim) of the mesh dimension over
    which the parameter `t` is split (its `sharding`, set by
    distributed.shard_params_), when that dimension has more than one
    rank; None for a whole tensor, a replicated one, or one split over a
    single rank (so a one-rank mesh adds no collective)."""
    sh = getattr(t, "sharding", None)
    if sh is None:
        return None
    mesh = sh.mesh
    for i, p in enumerate(sh.placements):
        if p.is_shard() and mesh.size(i) > 1:
            return (mesh.get_group(i), mesh.get_local_rank(i), mesh.size(i),
                    p.dim)
    return None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.rank = group, dim, dist.get_rank(group)
        ctx.width = x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter as all-reduce + slice: gloo has no reduce-scatter
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.width,
                        ctx.width).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over the ranks of `group`."""
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in rank order."""
    return _AllGather.apply(x, dim % x.dim(), group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block j of dim 0 (of `ranks` equal blocks) goes to rank j; block j
    of the result came from rank j."""
    return _AllToAll.apply(x, group)


def gather_sharded(y: torch.Tensor, weight, dim: int) -> torch.Tensor:
    """The output `y` of a layer whose `weight` may be split over its
    output channels: the full channels, gathered along `dim` of `y`; `y`
    itself when the weight is whole on this rank."""
    sg = shard_group(weight)
    return y if sg is None else all_gather(y, dim, sg[0])
