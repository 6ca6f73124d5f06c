"""Multi-process groups (torch.distributed) for gang members.

The reference scales across nodes with one worker process per node and
NCCL/MPI underneath (scanner/engine/worker.cpp:484 topology,
master.cpp:1558-1607 task sharding).  The gang-scheduled tasks of
engine/gang.py join one `torch.distributed` process group per gang
epoch: member 0's TCPStore serves at the coordinator address, every
member names its rank and the world size itself (nothing on a host
tells a program of a cluster), and `shutdown()` tears the group down
between epochs so a surviving member can re-form at a NEW coordinator.

The backend is the caller's explicit choice, never a probe of what the
machine has: the gang passes "gloo", because every gang collective
moves host data (a digest, pickled output shards, halo row blocks).

Failure classification: a rendezvous that does not complete raises
`RendezvousError` — the engine treats it as TRANSIENT (the peer set
changed under us: a member died, a coordinator moved), so the task
requeues strike-free instead of striking a healthy job
(engine/service.py `_is_transient_failure`).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional, Sequence

from ..common import ScannerException

# default bound on how long initialize() may block in the rendezvous
# when the caller passes no explicit timeout: an unbounded default
# would let one lost peer pin every survivor in init_process_group
# forever.  Gang members pass the much tighter [gang] init_timeout_s
# per gang instead (engine/gang.py).  The same bound is the process
# group's collective timeout, so no collective waits on gloo's own
# 30-minute default either.
DEFAULT_INIT_TIMEOUT_S = 300.0


class RendezvousError(ScannerException):
    """Joining (or re-joining) the process group failed: the
    coordinator is unreachable, a peer never arrived, or the bounded
    initialization timeout elapsed.  Classified transient by the engine
    — the gang re-forms on the remaining capacity, no blacklist
    strike."""


@dataclass
class CoordinatorConfig:
    """Multi-process wiring for one gang member.

    address: "host:port" of process 0's TCPStore.
    num_processes: total participating processes (the world size).
    process_id: this process's rank in [0, num_processes).
    local_device_ids: kept for the JAX package's signature; a torch
        process names its card itself (engine/gang.py passes the
        worker's device to the member's executor).
    """

    address: str
    num_processes: int
    process_id: int
    local_device_ids: Optional[Sequence[int]] = None


_init_config: Optional[CoordinatorConfig] = None


def initialize(config: CoordinatorConfig,
               init_timeout: Optional[float] = None,
               backend: str = "gloo") -> None:
    """Join the process group (idempotent per process for the SAME
    config; a different config while initialized is an error, not a
    silent no-op — call `shutdown()` first to re-form at a new
    coordinator).

    `init_timeout` bounds the rendezvous and every later collective of
    the group; None applies DEFAULT_INIT_TIMEOUT_S — never unbounded, so
    one lost peer cannot pin the survivors forever.  A failed or
    timed-out rendezvous raises `RendezvousError` (transient to the
    engine).  `backend` is passed to `init_process_group` as given.
    """
    global _init_config
    if _init_config is not None:
        if _init_config != config:
            raise ScannerException(
                f"torch.distributed already initialized with "
                f"{_init_config}; cannot re-initialize with {config} — "
                f"call shutdown() first to rendezvous at a new "
                f"coordinator")
        return
    import torch.distributed as dist

    if init_timeout is None:
        init_timeout = DEFAULT_INIT_TIMEOUT_S
    # timestamped rendezvous events onto the caller's current span
    # (engine/gang.py runs this under its gang.rendezvous span):
    # connect -> initialized brackets the actual coordinator wait, so
    # a slow member's join cost is readable off the merged timeline
    from ..util import tracing as _tracing
    _tracing.add_event("rendezvous.connect", address=config.address,
                       process_id=config.process_id,
                       num_processes=config.num_processes)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{config.address}",
            world_size=int(config.num_processes),
            rank=int(config.process_id),
            timeout=datetime.timedelta(seconds=float(init_timeout)))
    except Exception as e:  # noqa: BLE001 — the store raises
        # DistStoreError / RuntimeError / TimeoutError depending on
        # where the join broke; all are the same transient peer-set
        # failure to the engine
        _tracing.add_event("rendezvous.failed",
                           error=f"{type(e).__name__}")
        raise RendezvousError(
            f"torch.distributed.init_process_group failed for "
            f"process {config.process_id}/{config.num_processes} at "
            f"{config.address}: {e}") from e
    _tracing.add_event("rendezvous.initialized",
                       process_id=config.process_id)
    _init_config = config


def shutdown() -> None:
    """Leave the process group and RESET the re-init latch, so a
    follow-up `initialize()` with a NEW config (new coordinator, new
    num_processes) is legal.  Gang members run one process per epoch
    (engine/gang.py), so this is the in-process case.  Idempotent;
    never raises."""
    global _init_config
    if _init_config is None:
        return
    from .mesh import clear_host_meshes
    clear_host_meshes()
    try:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — a dead peer must not wedge the
        pass           # teardown path
    _init_config = None


def is_initialized() -> bool:
    return _init_config is not None


def current_config() -> Optional[CoordinatorConfig]:
    """The config this process is initialized with, or None."""
    return _init_config


def ceil_chunk(n_rows: int, num_shards: int) -> int:
    """Rows per shard under the ceil-chunk layout (the uneven-staging
    unit: every shard holds `chunk` rows except a short or empty tail)."""
    if num_shards <= 0:
        raise ScannerException(f"num_shards must be > 0, got {num_shards}")
    return -(-max(int(n_rows), 0) // num_shards) if n_rows > 0 else 0


def shard_rows(n_rows: int, rank: int, num_shards: int) -> tuple:
    """Contiguous row shard [lo, hi) of rank `rank` under the ceil-chunk
    layout: equal `ceil(n/num)` chunks with the remainder on the LAST
    non-empty shard (tail shards may be empty).  This is the one row
    layout shared by `shard_range` on the data plane (engine/gang.py)
    and the uneven `host_local_array` staging below — data decoded per
    this split stages with zero re-indexing."""
    chunk = ceil_chunk(n_rows, num_shards)
    lo = min(rank * chunk, n_rows)
    hi = min((rank + 1) * chunk, n_rows)
    return lo, hi


def host_local_array(mesh, spec, local_data, global_rows: Optional[int]
                     = None):
    """THIS process's block of a row-sharded host array, as a tensor.

    `local_data` is the numpy block this process contributes (its slice
    along the sharded leading dim); `spec` names the mesh axis the
    leading dim is sharded over (("hosts",) for the gang layout of
    parallel/mesh.host_mesh).

    `global_rows` engages the UNEVEN staging path for row counts not
    divisible by the axis size (the last-shard-remainder case
    `shard_rows` produces): each process passes only its own rows —
    possibly fewer than a full chunk, possibly zero — and gets its block
    zero-padded to `ceil_chunk` rows, so every rank holds the same
    shape (collectives need equal shapes).  Callers slice logical rows
    back out after any gather (`all_gather_rows` does this for you);
    zero padding is also identity-safe under the digest-sum collectives.
    """
    import numpy as np
    import torch

    local_data = np.ascontiguousarray(local_data)
    if global_rows is None:
        return torch.from_numpy(local_data)
    spec = tuple(spec) if isinstance(spec, (tuple, list)) else (spec,)
    axis = spec[0] if len(spec) else None
    if not isinstance(axis, str):
        raise ScannerException(
            "uneven host_local_array staging requires the leading dim "
            f"sharded over one named mesh axis, got spec {spec}")
    num = int(mesh.size(mesh.mesh_dim_names.index(axis)))
    chunk = ceil_chunk(int(global_rows), num)
    if len(local_data) > chunk:
        raise ScannerException(
            f"host block of {len(local_data)} rows exceeds the "
            f"ceil-chunk of {chunk} ({global_rows} rows over {num} "
            f"'{axis}' shards)")
    padded = np.zeros((chunk,) + local_data.shape[1:], local_data.dtype)
    if len(local_data):
        padded[:len(local_data)] = local_data
    return torch.from_numpy(padded)


def all_gather_rows(mesh, axis: str, local_block,
                    global_rows: Optional[int] = None):
    """All-gather per-process row blocks into one full host ndarray on
    EVERY process: stage this process's block via `host_local_array`
    (uneven-aware when `global_rows` is passed) and gather the blocks of
    the axis's process group in rank order (`dist.all_gather`).  The
    transport primitive sharded gang members assemble their output
    shards through (engine/gang.py)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    block = host_local_array(mesh, (axis,), local_block,
                             global_rows=global_rows)
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if n == 1:
        parts = [block]
    else:
        parts = [torch.empty_like(block) for _ in range(n)]
        dist.all_gather(parts, block.contiguous(), group=group)
    out = np.concatenate([p.numpy() for p in parts], axis=0)
    return out[:global_rows] if global_rows is not None else out


def local_block(sh, full_data):
    """This rank's block of `full_data` (an array or tensor, the same on
    every rank) under the placements of `sh` (a mesh.Sharding), copied
    onto the mesh's device.  A dim split over several mesh dimensions
    takes them in mesh order, as DTensor does; the split must be even."""
    import torch

    from .mesh import mesh_device

    mesh = sh.mesh
    full = torch.as_tensor(full_data)
    coord = mesh.get_coordinate()
    index = [slice(None)] * full.dim()
    for d in range(full.dim()):
        block, parts = 0, 1
        for i, p in enumerate(sh.placements):
            if p.is_shard() and p.dim == d:
                block = block * mesh.size(i) + coord[i]
                parts *= mesh.size(i)
        if full.shape[d] % parts:
            raise ValueError(f"dim {d} of size {full.shape[d]} does not "
                             f"split evenly into {parts} shards")
        k = full.shape[d] // parts
        index[d] = slice(block * k, (block + 1) * k)
    return full[tuple(index)].to(mesh_device(mesh), copy=True).contiguous()


def place(sh, full_data):
    """`full_data` (the same on every rank) as a DTensor with the
    placements of `sh`, built from this rank's own block: no bytes move
    between ranks."""
    import torch
    from torch.distributed.tensor import DTensor

    shape = tuple(torch.as_tensor(full_data).shape)
    return DTensor.from_local(
        local_block(sh, full_data), sh.mesh, sh.placements,
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def replicate_to_global(mesh, spec, full_data):
    """Place an identical host array (present on every rank) as a global
    sharded DTensor with the placements of `spec` (mesh.sharding's
    spec) — convenient for params/targets in tests and small inputs.
    Every rank must pass the same `full_data`; each keeps only its own
    block, so no bytes move."""
    from .mesh import sharding

    spec = (spec,) if isinstance(spec, str) else tuple(spec)
    return place(sharding(mesh, *spec), full_data)


def shard_params_(model, shardings) -> None:
    """Replace each parameter of `model` (the same full values on every
    rank) by this rank's block of it under shardings[name] (a
    mesh.Sharding; every parameter needs one), on the mesh's device.
    Each new parameter is a plain tensor carrying `sharding` and
    `global_shape`: the layers compute on it directly
    (parallel/collectives.py shard_group), so no DTensor dispatch runs
    in a step; models/checkpoint.py saves it as a DTensor."""
    import torch

    names = [n for n, _ in model.named_parameters()]
    missing = sorted(set(names) - set(shardings))
    if missing:
        raise ValueError(f"no sharding for parameters {missing}")
    for name in names:
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        full = getattr(mod, leaf).detach()
        p = torch.nn.Parameter(local_block(shardings[name], full))
        p.sharding, p.global_shape = shardings[name], tuple(full.shape)
        mod.register_parameter(leaf, p)


def gather_full(t, sh):
    """The full tensor of which `t` is this rank's block under the
    mesh.Sharding `sh`: all-gathers over each mesh dim that splits it,
    the innermost first.  Every rank of the mesh calls this together."""
    from .collectives import all_gather

    for i in reversed(range(len(sh.placements))):
        p = sh.placements[i]
        if p.is_shard() and sh.mesh.size(i) > 1:
            t = all_gather(t, p.dim, sh.mesh.get_group(i))
    return t
