"""Builds the port's native libraries from the checkout's sources.

Both native layers are shared libraries with a plain C interface, loaded
with ctypes: `libscvid` (the video layer, `cpp/scvid.cpp`, built with
g++) and the CUDA kernels (`csrc/*.cu`, built with nvcc for sm_90a).
They are built at first use into `scanner_tpu_torch/_build/`, which git
ignores.  A build runs under an exclusive flock, so concurrent processes
(pytest-xdist workers, loader threads) build once; the compiler writes to
a temporary name that is renamed into place, so no process can dlopen a
half-linked file.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import time
from typing import List, Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# seconds each library took to build in this process (0.0 = up to date)
build_seconds = {}


class BuildError(RuntimeError):
    """A native library could not be built."""


def _stale(out: str, sources: Sequence[str]) -> bool:
    if not os.path.exists(out):
        return True
    mtime = os.path.getmtime(out)
    return any(os.path.getmtime(s) > mtime for s in sources)


def build_shared(name: str, sources: Sequence[str],
                 command: List[str]) -> str:
    """Build `_build/<name>` from `sources` with `command` unless it is
    up to date; returns its path.  `command` names the output as the
    placeholder "{out}".  Raises BuildError with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, name)
    with open(os.path.join(BUILD_DIR, name + ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not _stale(out, sources):
            build_seconds.setdefault(name, 0.0)
            return out
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [tmp if a == "{out}" else a for a in command]
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise BuildError(f"cannot build {name}: {e}") from e
        if r.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise BuildError(f"building {name} failed:\n{' '.join(cmd)}\n"
                             f"{r.stdout}{r.stderr}")
        os.replace(tmp, out)
        build_seconds[name] = time.time() - t0
        return out
