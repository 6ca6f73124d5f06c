"""Data-parallel inference for engine kernels: one model replicated over
the devices the engine hands the kernel.

The counterpart of the JAX package's models/infer.py.  There,
`DataParallelApply` replicates the params over every chip of a host
once and dp-shards each batch's leading axis under one jitted program.
Here the module is copied once per entry of the kernel's device list
(KernelConfig.devices: the instance's partition of the host's cards,
engine/evaluate.py `instance_devices`) at construction; each call pads
the batch with zeros to a multiple of the replica count, as the JAX
package does, runs one contiguous shard on each replica — launched
from this one thread under each card's device context, so the cards'
work overlaps — and gathers the outputs on the first device (the
instance's own) before slicing the padding off.  An entry may repeat a
device (`["cpu"] * 4`, or two replicas on one card): each still gets
its own copy.

`lowered_flops` / `DataParallelApply.cost_flops` are the FLOP probes
behind the model ops' `infer_cost_flops` (the JAX package's MFU probe):
they count one call of the whole batch on one replica with
torch.utils.flop_counter.FlopCounterMode, which counts matrix products
and convolutions — where XLA's cost analysis also counts elementwise
work, so the two differ by a stated ratio
(tests/test_torch_detection.py).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode


def lowered_flops(fn, *args) -> Optional[float]:
    """FLOPs of one call fn(*args), counted by FlopCounterMode (matrix
    products and convolutions); None when it counts none."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = counter.get_total_flops()
    return float(flops) if flops > 0 else None


def _device(d: Any) -> torch.device:
    """A replica's device, resolved as a client's is: "cuda" becomes the
    current card, and a card that is not there raises."""
    from ..engine.evaluate import resolve_device
    return resolve_device(d)


def _on(dev: torch.device):
    """The device context a replica's launches run under."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _gather(outs: List[Any], dev: torch.device, rows: int):
    """The replicas' output trees concatenated leaf by leaf on `dev`,
    the padding rows sliced off."""
    leaves, spec = zip(*(pytree.tree_flatten(o) for o in outs))
    cat = [torch.cat([leaf.to(dev, non_blocking=True) for leaf in group])
           [:rows] for group in zip(*leaves)]
    return pytree.tree_unflatten(cat, spec[0])


class DataParallelApply:
    """`module` replicated once per entry of `devices` (the CPU when
    empty), each copy in eval mode; calling it runs a batch without
    autograd, split over the replicas."""

    def __init__(self, module: nn.Module,
                 devices: Optional[Sequence[Any]] = None):
        self.devices = [_device(d) for d in (devices or ["cpu"])]
        self.device = self.devices[0]
        # copies first, then placement: every replica starts from the
        # module as the caller built it, before any call could cache
        # device state on it
        copies = [module] + [copy.deepcopy(module)
                             for _ in self.devices[1:]]
        self.replicas = [m.to(d).eval()
                         for m, d in zip(copies, self.devices)]
        self.module = self.replicas[0]

    def _host_batch(self, batch) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            batch if isinstance(batch, np.ndarray) else np.stack(batch)))

    def cost_flops(self, batch) -> Optional[float]:
        """FLOPs of one call on the whole of `batch` on the first
        replica (lowered_flops): the JAX count is the sharded program's
        total."""
        x = batch if isinstance(batch, torch.Tensor) \
            else self._host_batch(batch)
        return lowered_flops(self.module, x.to(self.device))

    def _apply(self, x: torch.Tensor):
        n, rows = len(self.replicas), x.shape[0]
        if n == 1 or rows == 0:
            return self.module(x.to(self.device))
        pad = (-rows) % n
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        outs = []
        for m, dev, shard in zip(self.replicas, self.devices, x.chunk(n)):
            with _on(dev):
                outs.append(m(shard.to(dev, non_blocking=True)))
        return _gather(outs, self.device, rows)

    def __call__(self, batch):
        """A host batch (numpy array or list of frames) is split over
        the replicas and the result comes back as numpy; a tensor must
        lie on a replica's device, and the result stays on the first
        device (the sink fetches it once per task)."""
        if isinstance(batch, torch.Tensor):
            if batch.device not in self.devices:
                owners = ", ".join(map(str, dict.fromkeys(self.devices)))
                raise ValueError(
                    f"batch on {batch.device}, model on {owners}")
            with torch.no_grad():
                return self._apply(batch)
        with torch.no_grad():
            out = self._apply(self._host_batch(batch))
        return pytree.tree_map(lambda t: t.cpu().numpy(), out)
