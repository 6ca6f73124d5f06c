"""One copy per process of a model op's weights on a device.

The engine builds a kernel instance per job, so a model op that loaded
its weights in its constructor would read and place them again every
job: about 105 MB for OpenPose, 1.27 GB for SAM's ViT-H encoder.
`shared` keeps what an op built for one device and dtype, for the life
of the process; every later instance gets the same tensors.  The
weights come from a `.npz` file (named directly, or the one in a
directory) or, with no file, from a seed the op draws them from.

A process keeps one copy per op, device and dtype.  A source that
differs from the kept one (another file; the same file rewritten, so
that its real path, size or modification time differ; another seed)
replaces it, so a worker that meets a second checkpoint does not keep
the first on the card beside it.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch

# (op, device, dtype) -> (the source's key, what the op built from it)
_CACHE: Dict[Tuple[str, str, str], Tuple[Tuple, Any]] = {}
_lock = threading.Lock()


def _npz_file(checkpoint_dir: str) -> str:
    """A weight file named directly, or the one `.npz` in a directory."""
    if os.path.isdir(checkpoint_dir):
        found = sorted(f for f in os.listdir(checkpoint_dir)
                       if f.endswith(".npz"))
        if len(found) != 1:
            raise ValueError(f"{checkpoint_dir}: expected one .npz weight "
                             f"file, found {found}")
        return os.path.join(checkpoint_dir, found[0])
    return checkpoint_dir


def shared(op: str, checkpoint_dir: Optional[str], seed: int,
           device, dtype: torch.dtype,
           build: Callable[[Optional[str]], Any]) -> Any:
    """What `build(path)` returns for `op`'s weights on `device` in
    `dtype`.  `path` is the `.npz` that `checkpoint_dir` names (a file,
    or a directory holding one), or None where `checkpoint_dir` is
    empty, and `build` then draws the weights from `seed`.  Built the
    first time this process asks for that source, and kept until `op`
    asks for another on the same device and dtype."""
    if checkpoint_dir:
        path = os.path.realpath(_npz_file(checkpoint_dir))
        st = os.stat(path)
        src: Tuple = (path, st.st_size, st.st_mtime_ns)
    else:
        path, src = None, ("seed", int(seed))
    slot = (op, str(torch.device(device)), str(dtype))
    with _lock:
        kept = _CACHE.get(slot)
        if kept is None or kept[0] != src:
            # drop the old copy before the new one is placed
            _CACHE.pop(slot, None)
            kept = _CACHE[slot] = (src, build(path))
        return kept[1]
