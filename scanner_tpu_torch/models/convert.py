"""The JAX package's model parameters -> the port's module state.

Input is either the flat `.npz` key contract of the JAX package's
exported weight files ({"params/Backbone_0/Conv_0/kernel": ndarray, ...},
scanner_tpu/models/checkpoint.py export_params_npz) or a nested flax
parameter tree of arrays ({"params": {"Backbone_0": {...}}}).  A torch
parameter `A.B.weight` of a module whose FLAX_PARAMS maps "weight" to
("kernel", fn) comes from the flax key `params/A/B/kernel`, with `fn`
changing its layout (HWIO -> OIHW for convolutions, a transpose for
dense kernels, a flip for transposed convolutions: models/nets.py).

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
from .nets import init_module_

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


def torch_state(params: Any, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The state dict of `model` built from JAX-package parameters; a
    missing key raises KeyError and a mis-shaped one ValueError, each
    naming the flax key."""
    flat = flatten_params(params)
    state: Dict[str, torch.Tensor] = {}
    for mod_name, mod in model.named_modules():
        rules = getattr(mod, "FLAX_PARAMS", {})
        for pname, p in mod.named_parameters(recurse=False):
            leaf, fn = rules.get(pname, (pname, None))
            path = "/".join(["params"] + (mod_name.split(".") if mod_name
                                          else []) + [leaf])
            if path not in flat:
                raise KeyError(f"weights are missing parameter {path}")
            arr = flat[path]
            if fn is not None:
                arr = fn(arr)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"{path}: weight shape {np.asarray(flat[path]).shape} "
                    f"does not give {tuple(p.shape)} (width mismatch?)")
            name = f"{mod_name}.{pname}" if mod_name else pname
            state[name] = torch.from_numpy(
                np.array(arr, dtype=np.float32, order="C"))
    return state


def load_params(model: nn.Module, params: Any) -> nn.Module:
    """Load JAX-package parameters (tree or flat dict) into `model`."""
    model.load_state_dict(torch_state(params, model))
    return model


def load_npz(model: nn.Module, path: str) -> nn.Module:
    """Load an exported `.npz` weight file into `model`."""
    with np.load(path) as data:
        flat = dict(data)
    return load_params(model, flat)


def load_weights(model: nn.Module, shipped: Optional[str],
                 checkpoint_dir: Optional[str], seed: int,
                 op: str) -> nn.Module:
    """A model op's weights: an exported `.npz` at `checkpoint_dir`, else
    the shipped file `shipped` (None: no shipped weights fit), else
    random weights from `seed`."""
    path = checkpoint_dir or (shipped_weights(shipped) if shipped else None)
    if path is None:
        return init_module_(model, seed)
    if not path.endswith(".npz"):
        raise ValueError(f"{op} loads exported .npz weight files; orbax "
                         f"checkpoint directories are not ported ({path})")
    return load_npz(model, path)
