"""Model inference for engine kernels: one model on the device the engine
hands the kernel.

The counterpart of the JAX package's models/infer.py.  There,
`DataParallelApply` replicates the params over every chip of a host and
shards each batch's leading axis.  The port runs one card per kernel
instance (the engine gives each pipeline instance its own card), so this
class places the model on that one device and moves batches to it; more
than one device raises.  `lowered_flops` / `DataParallelApply.cost_flops`
are the FLOP probes behind the model ops' `infer_cost_flops` (the JAX
package's MFU probe): they count one call with
torch.utils.flop_counter.FlopCounterMode, which counts matrix products
and convolutions — where XLA's cost analysis also counts elementwise
work, so the two differ by a stated ratio (tests/test_torch_detection.py).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode


def lowered_flops(fn, *args) -> Optional[float]:
    """FLOPs of one call fn(*args), counted by FlopCounterMode (matrix
    products and convolutions); None when it counts none."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = counter.get_total_flops()
    return float(flops) if flops > 0 else None


class DataParallelApply:
    """`module` on the one device of `devices` (the CPU when empty), in
    eval mode; calling it runs the module on a batch without autograd."""

    def __init__(self, module: nn.Module,
                 devices: Optional[Sequence[Any]] = None):
        devices = list(devices or [])
        if len(devices) > 1:
            raise NotImplementedError(
                f"DataParallelApply over {len(devices)} devices is not "
                f"ported (ROADMAP Queue A.8); give each kernel one card")
        self.device = torch.device(devices[0]) if devices \
            else torch.device("cpu")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.module = module.to(self.device).eval()

    def _device_batch(self, batch) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            batch if isinstance(batch, np.ndarray) else np.stack(batch))) \
            .to(self.device)

    def cost_flops(self, batch) -> Optional[float]:
        """FLOPs of one call of the module on `batch` (lowered_flops)."""
        x = batch if isinstance(batch, torch.Tensor) \
            else self._device_batch(batch)
        return lowered_flops(self.module, x)

    def __call__(self, batch):
        """A host batch (numpy array or list of frames) is moved to the
        device and the result comes back as numpy; a tensor must already
        lie on the device, and the result stays there (the sink fetches
        it once per task)."""
        if isinstance(batch, torch.Tensor):
            if batch.device != self.device:
                raise ValueError(f"batch on {batch.device}, model on "
                                 f"{self.device}")
            with torch.no_grad():
                return self.module(batch)
        with torch.no_grad():
            return self.module(self._device_batch(batch)).cpu().numpy()
