"""Training-state checkpoints and the portable weight file.

The counterpart of the JAX package's models/checkpoint.py, where orbax
keeps params + optimizer state + step.  Here a step is one
torch.distributed.checkpoint (DCP) directory holding the model's and the
optimizer's state dicts as `get_state_dict` gives them, so optimizer
state is keyed by parameter name, and DCP needs no process group:

    <directory>/<step>/.metadata, __0_0.distcp   DCP's files
    <directory>/<step>/scanner_tpu_torch.json    {"step", "format"}

A step is written under a temporary name and renamed when complete, so
`latest_step` never sees half of one; steps past `max_to_keep` are
pruned, oldest first.  An orbax directory written by the JAX package is
refused with a ValueError that names the route:
scanner_tpu.models.checkpoint.export_params_npz writes the `.npz` weight
file that every model op of the port loads.  `export_params_npz` here
writes the same format from a port model (flax keys, flax layouts), so
the JAX package's `import_params_npz` reads what the port trained.

A sharded model (parameters holding this rank's block,
parallel/distributed.py shard_params_; models/pose.py
make_sharded_train_step) saves and restores its blocks and its Adam
state's as DTensors through the same calls, every rank of its process
group together: rank 0 names the step's directory and completes it, and
DCP writes each rank's blocks into it.  `restore_params` reads such a step
into a plain one-device model (DCP reassembles the blocks), converting
a pipelined trunk's stacked stages to the plain blocks.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import warnings
from typing import Optional

import numpy as np
from torch import nn

from .convert import flax_params, load_npz, shipped_weights  # noqa: F401
from .nets import init_module_

FORMAT = "torch.distributed.checkpoint"
MARKER = "scanner_tpu_torch.json"
ORBAX_ROUTE = ("scanner_tpu.models.checkpoint.export_params_npz: export "
               "the JAX package's params to an .npz and load that")


def _group_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _from_rank0(fn):
    """fn() on rank 0 of the process group, its result on every rank
    (fn() alone without a group of several ranks)."""
    import torch.distributed as dist
    if _group_size() == 1:
        return fn()
    box = [fn() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _as_dtensors(model: nn.Module, model_sd: dict, optim_sd: dict):
    """Copies of the two state dicts in which the state of each sharded
    parameter and its Adam moments (tensors of the parameter's local
    shape) are DTensors with the parameter's placements; each shares its
    tensor's storage, so DCP reads into the state dicts' tensors.  (The
    optimizer's state_dict holds its live per-parameter dicts: they are
    copied, not changed.)"""
    import torch
    from torch.distributed.tensor import DTensor

    model_sd = dict(model_sd)
    optim_sd = dict(optim_sd, state={
        name: dict(st) for name, st in optim_sd["state"].items()})
    for name, p in model.named_parameters():
        sh = getattr(p, "sharding", None)
        if sh is None:
            continue

        def wrap(t):
            if not isinstance(t, torch.Tensor) or t.shape != p.shape:
                return t
            return DTensor.from_local(
                t, sh.mesh, sh.placements, run_check=False,
                shape=p.global_shape,
                stride=torch.empty(p.global_shape, device="meta").stride())
        model_sd[name] = wrap(model_sd[name])
        state = optim_sd["state"].get(name, {})
        for key in state:
            state[key] = wrap(state[key])
    return model_sd, optim_sd


def _as_local(sd):
    """The inverse of _as_dtensors on one state dict (nested)."""
    from torch.distributed.tensor import DTensor
    if isinstance(sd, dict):
        return {k: _as_local(v) for k, v in sd.items()}
    return sd.to_local() if isinstance(sd, DTensor) else sd


@contextlib.contextmanager
def _quiet_dcp():
    """DCP warns on every call made without a process group that it
    assumes one process; that is this module's case by design."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message=".*assuming the intent is to")
        yield


class TrainCheckpointer:
    """Save and restore (model, optimizer) training state by step under
    `directory`; restores load in place."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, MARKER)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> str:
        """The directory of the complete step `step` (None: the latest);
        raises ValueError at an orbax directory, else FileNotFoundError
        without that step."""
        steps = self._steps()
        if step is None and steps:
            step = steps[-1]
        if step is not None and step in steps:
            return os.path.join(self.directory, str(step))
        if any(n.isdigit() and os.path.isfile(os.path.join(
                self.directory, n, "_CHECKPOINT_METADATA"))
               for n in os.listdir(self.directory)):
            raise ValueError(
                f"{self.directory} is an orbax checkpoint of the JAX "
                f"package, which the port does not read; the route is "
                f"{ORBAX_ROUTE}")
        raise FileNotFoundError(
            f"no checkpoint{'' if step is None else f' at step {step}'} "
            f"under {self.directory}")

    def save(self, step: int, model: nn.Module, optimizer) -> None:
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.state_dict import get_state_dict

        model_sd, optim_sd = _as_dtensors(
            model, *get_state_dict(model, optimizer))

        def make_tmp():
            os.makedirs(self.directory, exist_ok=True)
            return tempfile.mkdtemp(prefix=f".tmp-{step}-",
                                    dir=self.directory)

        tmp = _from_rank0(make_tmp)
        first = _rank() == 0
        try:
            with _quiet_dcp():
                dcp.save({"model": model_sd, "optim": optim_sd},
                         checkpoint_id=tmp)
            if first:
                with open(os.path.join(tmp, MARKER), "w") as f:
                    json.dump({"step": int(step), "format": FORMAT}, f)
                final = os.path.join(self.directory, str(int(step)))
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
        except BaseException:
            if first:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        if first:
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        if _group_size() > 1:
            import torch.distributed as dist
            dist.barrier()

    def restore(self, model: nn.Module, optimizer,
                step: Optional[int] = None) -> int:
        """Load the model's parameters and the optimizer's state of
        `step` (None: the latest) in place; returns the step."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, get_state_dict, set_state_dict)

        path = self._step_dir(step)
        model_sd, optim_sd = get_state_dict(model, optimizer)
        # get_state_dict gives a fresh optimizer state for every
        # parameter; the saved one has none for a parameter that never had
        # a gradient (the MoE router, behind its argmax), which must stay
        # without
        stored = dcp.FileSystemReader(path).read_metadata() \
            .state_dict_metadata
        optim_sd["state"] = {
            name: st for name, st in optim_sd["state"].items()
            if all(f"optim.state.{name}.{key}" in stored for key in st)}
        model_sd, optim_sd = _as_dtensors(model, model_sd, optim_sd)
        state = {"model": model_sd, "optim": optim_sd}
        with _quiet_dcp():
            dcp.load(state, checkpoint_id=path)
        # strict=False lets those parameters stay without state; every
        # model key was read above (dcp.load raises on a missing one)
        set_state_dict(model, optimizer,
                       model_state_dict=_as_local(state["model"]),
                       optim_state_dict=_as_local(state["optim"]),
                       options=StateDictOptions(strict=False))
        return int(os.path.basename(path))

    def restore_params(self, model: nn.Module,
                       step: Optional[int] = None) -> nn.Module:
        """Load only the model's parameters (inference: a model op keeps
        no optimizer state); the model may lack parameters that the
        saved one had (a training-only head).  A step saved from a
        pipelined pose model restores into the plain one: its stacked
        stages fill TemporalBlock_i (models/pose.py pp_state_to_plain)."""
        import torch
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.metadata import \
            TensorStorageMetadata
        from torch.distributed.checkpoint.state_dict import (
            get_model_state_dict, set_model_state_dict)

        path = self._step_dir(step)
        want = get_model_state_dict(model)
        stored = dcp.FileSystemReader(path).read_metadata() \
            .state_dict_metadata
        load = {k: v for k, v in want.items() if f"model.{k}" in stored}
        lacking = len(load) < len(want)
        if lacking:
            # what the model lacks, read whole in the stored layout
            for key, meta in stored.items():
                name = key[len("model."):]
                if key.startswith("model.") and name not in want \
                        and isinstance(meta, TensorStorageMetadata):
                    load[name] = torch.empty(meta.size,
                                             dtype=meta.properties.dtype)
        state = {"model": load}
        with _quiet_dcp():
            dcp.load(state, checkpoint_id=path)
        got = state["model"]
        if lacking:
            from .pose import pp_state_to_plain
            got = pp_state_to_plain(got)
            missing = sorted(k for k in want if k not in got)
            if missing:
                raise KeyError(f"checkpoint {path} lacks parameters "
                               f"{missing[:5]}")
            got = {k: got[k] for k in want}
        set_model_state_dict(model, got)
        return model

    def close(self) -> None:
        """Nothing is held open between calls; kept for the reference's
        interface."""


def load_params(directory: str, model: nn.Module,
                step: Optional[int] = None) -> nn.Module:
    """Load weights into `model` from an exported `.npz` weight file or
    a checkpoint directory the port's TrainCheckpointer wrote."""
    if directory.endswith(".npz"):
        return import_params_npz(directory, model)
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory: {directory}")
    return TrainCheckpointer(directory).restore_params(model, step=step)


def init_or_restore(model: nn.Module, checkpoint_dir: Optional[str],
                    seed: int) -> nn.Module:
    """The model op's weight path: `checkpoint_dir` loaded when given,
    else random weights made from `seed`."""
    if checkpoint_dir:
        return load_params(checkpoint_dir, model)
    return init_module_(model, seed)


def export_params_npz(model: nn.Module, path: str) -> None:
    """Write `model`'s parameters as the portable `.npz` weight file:
    flax keys and layouts, float32 (convert.flax_params)."""
    np.savez_compressed(path, **flax_params(model))


def import_params_npz(path: str, model: nn.Module) -> nn.Module:
    """Load an exported `.npz` weight file into `model`; a missing key
    raises KeyError and a mis-shaped one ValueError."""
    return load_npz(model, path)
