"""Device-mesh layouts and the gang's host mesh.

The reference scales by sharding (job, task) lists over worker processes
(SURVEY §2.6); in-program parallelism lays a job's kernel out over a
device mesh with named axes:

    dp — data/batch parallel        sp — sequence/context parallel
    tp — tensor/model parallel      pp — in-program pipeline parallel

`make_mesh` keeps the JAX package's factoring rules and returns the
layout (devices reshaped under axis names).  `device_mesh` turns a
layout into a `DeviceMesh` over the caller's process group, one rank per
device; `sharding` and `shard_batch` place tensors over it as DTensors
(the counterparts of `NamedSharding` and `jax.device_put`).  `host_mesh`
is the gang's ("hosts", "local") mesh over its process group, one
device per member (engine/gang.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..common import ScannerException

AXIS_ORDER = ("dp", "sp", "tp")


@dataclass(frozen=True, eq=False)
class MeshLayout:
    """Devices laid out under named axes: `devices` is an object array
    of shape `tuple(shape.values())`, axis i named `axis_names[i]` (the
    layout of a jax Mesh, without placement)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _cuda_devices():
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise ScannerException(
            "make_mesh: no CUDA card is available (pass devices= to lay "
            "out other devices)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[Any]] = None) -> MeshLayout:
    """Lay `devices` (default: every CUDA card) out under the given axis
    sizes; missing axes get size 1, and a single unconstrained axis
    absorbs the remaining device count.  Optional axes — 'pp' (pipeline
    stages) and 'ep' (expert parallelism) — are appended only when
    requested so existing dp/sp/tp meshes keep their rank."""
    if devices is None:
        devices = _cuda_devices()
    axes = dict(axes or {})
    order = AXIS_ORDER + tuple(a for a in ("pp", "ep") if a in axes)
    unknown = set(axes) - set(order)
    if unknown:
        raise ValueError(
            f"unknown mesh axes {sorted(unknown)}; valid: {order}")
    sizes = [axes.get(a, 0) for a in order]
    known = [s for s in sizes if s > 0]
    prod = math.prod(known) if known else 1
    if 0 not in sizes and prod <= len(devices):
        # fully specified: use a prefix of the device list
        devices = list(devices)[:prod]
    n = len(devices)
    if 0 in sizes:
        rem = n // prod
        if prod * rem != n:
            raise ValueError(
                f"cannot factor {n} devices into axes {axes}")
        # the first unspecified axis absorbs the remainder; others get 1
        seen_unknown = False
        fixed = []
        for s in sizes:
            if s > 0:
                fixed.append(s)
            elif not seen_unknown:
                fixed.append(rem)
                seen_unknown = True
            else:
                fixed.append(1)
        sizes = fixed
    if math.prod(sizes) != n:
        raise ValueError(
            f"mesh axes {dict(zip(order, sizes))} need "
            f"{math.prod(sizes)} devices, have {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = list(devices)
    return MeshLayout(arr.reshape(sizes), order)


# one host mesh per (num_processes, device type) for the life of the
# process group: building a DeviceMesh creates the "local" dimension's
# sub-groups, a collective step every member must take together, so
# the gang builds it once per epoch and distributed.shutdown() drops it
_host_meshes: Dict[Tuple[int, str], Any] = {}


def host_mesh(num_processes: int, device_type: str = "cpu"):
    """The gang mesh: a ("hosts", "local") DeviceMesh over the gang's
    process group whose row p is process p's one device.  Built by every
    gang member after the rendezvous (parallel/distributed.initialize);
    host_local_array staging and the gang's collectives (digest
    reduction, output-shard all-gather, halo exchange — engine/gang.py)
    all key off the "hosts" axis.  `device_type` "cpu" is the gloo
    group the gang's host-data collectives run on.  Requires the group's
    world size to equal `num_processes`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    num = int(num_processes)
    if not dist.is_initialized():
        raise ValueError("host_mesh needs the gang's process group "
                         "(parallel/distributed.initialize first)")
    world = dist.get_world_size()
    if num <= 0 or world != num:
        raise ValueError(
            f"cannot split {world} processes over {num} hosts")
    key = (num, device_type)
    mesh = _host_meshes.get(key)
    if mesh is None:
        mesh = _host_meshes[key] = init_device_mesh(
            device_type, (num, 1), mesh_dim_names=("hosts", "local"))
    return mesh


def clear_host_meshes() -> None:
    """Forget the cached host meshes (their process group is gone)."""
    _host_meshes.clear()


def auto_axes(n: int) -> Dict[str, int]:
    """Factor n devices into a balanced (dp, sp, tp) assignment."""
    def split(x):
        f = int(math.sqrt(x))
        while x % f:
            f -= 1
        return f, x // f
    a, rest = split(n)
    b, c = split(rest)
    return {"dp": a, "sp": b, "tp": c}


def device_mesh(layout: MeshLayout):
    """The DeviceMesh of `layout` over the default process group, which
    the caller formed (`torch.distributed.init_process_group`) with one
    rank per device of the layout: rank r runs on the layout's r-th
    device (row-major), which becomes its current CUDA device, and the
    mesh's dimension names are the layout's axis names.  Raises unless
    the group's world size equals the layout's device count.  Building
    one creates each dimension's sub-groups, a step every rank takes
    together; the gang's host meshes are cached apart (`host_mesh`)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = layout.devices.size
    if not dist.is_initialized():
        raise ValueError("device_mesh needs the caller's process group "
                         "(torch.distributed.init_process_group first)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the process group has {world} ranks but the "
                         f"mesh {layout.shape} lays out {n} devices")
    devs = [torch.device(d) for d in layout.devices.reshape(-1)]
    kinds = {d.type for d in devs}
    if len(kinds) != 1:
        raise ValueError(f"a mesh lays out devices of one type, got "
                         f"{sorted(kinds)}")
    mine = devs[dist.get_rank()]
    if mine.type == "cuda":
        torch.cuda.set_device(mine)
    return DeviceMesh(mine.type, torch.arange(n).reshape(
        layout.devices.shape), mesh_dim_names=layout.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: ranks} of a DeviceMesh or a MeshLayout."""
    if isinstance(mesh, MeshLayout):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh):
    """This rank's device on `mesh` (device_mesh made it current)."""
    import torch
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Sharding(NamedTuple):
    """A mesh and one DTensor placement per mesh dimension."""

    mesh: Any
    placements: Tuple[Any, ...]


def sharding(mesh, *spec) -> Sharding:
    """The counterpart of `NamedSharding(mesh, P(*spec))`: spec[d] names
    the mesh axis (or a tuple of axes, in mesh order) that tensor dim d
    is split over, or None; every mesh dimension no entry names is
    Replicate().  `mesh` is a DeviceMesh or a MeshLayout (placements
    alone need only the axis names)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(axis_sizes(mesh))
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in "
                                 f"the mesh's {names}")
            if placements[names.index(a)] != Replicate():
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of one dim must "
                             f"be in the mesh's order {names}")
        for i in idx:
            placements[i] = Shard(dim)
    return Sharding(mesh, tuple(placements))


def shard_batch(mesh, arr, axis: str = "dp"):
    """Place a host array, the same on every rank, as a DTensor with its
    leading dim sharded over one mesh axis."""
    from .distributed import replicate_to_global
    return replicate_to_global(mesh, (axis,), arr)
