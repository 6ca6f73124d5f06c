"""The JAX package's model parameters <-> the port's module state.

Input is either the flat `.npz` key contract of the JAX package's
exported weight files ({"params/Backbone_0/Conv_0/kernel": ndarray, ...},
scanner_tpu/models/checkpoint.py export_params_npz) or a nested flax
parameter tree of arrays ({"params": {"Backbone_0": {...}}}).  A torch
parameter `A.B.weight` of a module whose FLAX_PARAMS maps "weight" to
("kernel", fn, inv) comes from the flax key `params/A/B/kernel`, with
`fn` changing its layout (HWIO -> OIHW for convolutions, a transpose for
dense kernels, a flip for transposed convolutions: models/nets.py);
`flax_params` goes the other way with `inv`, for the `.npz` files that
models/checkpoint.py exports.  A stack of identical stages (a module
with a `stage_template`, models/pose.py PipelinedTemporalStack) holds
each template parameter stacked on a leading stage axis, under the flax
key `<stack>/stages/params/<template key>`; its layout changes apply
stage by stage.

Only numpy reads the weight files; nothing of the JAX package is
imported.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .. import native

WEIGHTS_DIR = os.path.join(native.REPO_DIR, "scanner_tpu", "models",
                           "weights")


def shipped_weights(filename: str) -> str:
    """Path of a weight file shipped with the repository; raises if it
    is not there."""
    path = os.path.join(WEIGHTS_DIR, filename)
    if not os.path.exists(path):
        raise FileNotFoundError(f"shipped weight file missing: {path}")
    return path


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested flax tree (or an already-flat dict) -> {"a/b/c": array}."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in params.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_params(val, name))
        else:
            flat[name] = np.asarray(val)
    return flat


def _per_stage(fn):
    return None if fn is None else (
        lambda a: np.stack([fn(x) for x in a]))


def _flax_entries(model: nn.Module):
    """(flax key, torch name, parameter, layout in, layout out) of each
    parameter of `model` that has a flax counterpart; a FLAX_PARAMS rule
    of None marks a training-only parameter (detect_train's classifier)."""
    stack = None
    for mod_name, mod in model.named_modules():
        if stack is not None and mod_name.startswith(stack):
            continue
        template = getattr(mod, "stage_template", None)
        if template is not None:
            stack = f"{mod_name}."
            base = "/".join(["params"] + mod_name.split(".")
                            + ["stages", "params"])
            for path, name, _, fn, inv in _flax_entries(template):
                full = f"{mod_name}.stages.{name}"
                yield (base + path[len("params"):], full,
                       model.get_parameter(full), _per_stage(fn),
                       _per_stage(inv))
            continue
        rules = getattr(mod, "FLAX_PARAMS", {})
        for pname, p in mod.named_parameters(recurse=False):
            rule = rules.get(pname, (pname, None, None))
            if rule is None:
                continue
            leaf, fn, inv = rule
            path = "/".join(["params"] + (mod_name.split(".") if mod_name
                                          else []) + [leaf])
            name = f"{mod_name}.{pname}" if mod_name else pname
            yield path, name, p, fn, inv


def torch_state(params: Any, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The state dict of `model` built from JAX-package parameters; a
    missing key raises KeyError and a mis-shaped one ValueError, each
    naming the flax key."""
    flat = flatten_params(params)
    state: Dict[str, torch.Tensor] = {}
    for path, name, p, fn, _ in _flax_entries(model):
        if path not in flat:
            raise KeyError(f"weights are missing parameter {path}")
        arr = flat[path]
        if fn is not None:
            arr = fn(arr)
        shape = tuple(getattr(p, "global_shape", p.shape))
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"{path}: weight shape {np.asarray(flat[path]).shape} "
                f"does not give {shape} (width mismatch?)")
        state[name] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))
    return state


def flax_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of torch_state: `model`'s parameters under their flax
    keys ("params/Backbone_0/Conv_0/kernel") in flax layouts, float32.
    A sharded parameter (parallel/distributed.py shard_params_) is
    gathered whole: every rank of its mesh calls this together."""
    from ..parallel.distributed import gather_full
    out = {}
    for path, _, p, _, inv in _flax_entries(model):
        if hasattr(p, "sharding"):
            p = gather_full(p.detach(), p.sharding)
        arr = p.detach().float().cpu().numpy()
        out[path] = np.ascontiguousarray(inv(arr) if inv is not None
                                         else arr)
    return out


def load_params(model: nn.Module, params: Any) -> nn.Module:
    """Load JAX-package parameters (tree or flat dict) into `model`; a
    training-only parameter (no flax counterpart) keeps its value.  A
    sharded parameter (parallel/distributed.py shard_params_) takes this
    rank's block of the full value."""
    # torch_state raises on any flax-mapped parameter it cannot fill, so
    # the keys strict loading would miss are the training-only ones
    from ..parallel.distributed import local_block
    state = torch_state(params, model)
    for name, value in state.items():
        p = model.get_parameter(name)
        if hasattr(p, "sharding"):
            state[name] = local_block(p.sharding, value)
    model.load_state_dict(state, strict=False)
    return model


def load_npz(model: nn.Module, path: str) -> nn.Module:
    """Load an exported `.npz` weight file into `model`."""
    with np.load(path) as data:
        flat = dict(data)
    return load_params(model, flat)


def load_weights(model: nn.Module, shipped: Optional[str],
                 checkpoint_dir: Optional[str], seed: int) -> nn.Module:
    """A model op's weights: `checkpoint_dir` (an exported `.npz` or a
    checkpoint directory the port's TrainCheckpointer wrote), else the
    shipped file `shipped` (None: no shipped weights fit), else random
    weights from `seed`."""
    from .checkpoint import init_or_restore
    return init_or_restore(model, checkpoint_dir or (
        shipped_weights(shipped) if shipped else None), seed)
