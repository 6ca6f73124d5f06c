"""Hand-written CUDA kernels for hot ops, and their plain versions.

The counterpart of the JAX package's kernels/pallas_ops.py.  Each kernel
here has three parts side by side:

  * the wrapper, which checks its input and launches the kernel on a
    CUDA tensor, or runs the plain version on a CPU tensor.  It raises
    on anything else: there is no fallback from the kernel to the plain
    version;
  * the plain PyTorch version of the same function, which the CPU tests
    hold against the JAX package and `chip_smoke.py` holds the kernel
    against on the card;
  * a launch counter, a plain integer the wrapper adds one to where it
    launches the kernel and nowhere else.  A gang member runs in a child
    process of its worker; the worker adds the child's counters to its
    own when the member returns (`fold_counts`, engine/gang.py).

Kernel sources live in `scanner_tpu_torch/csrc/`, are compiled with nvcc
for sm_90a into a shared library with a plain C interface at first use
(scanner_tpu_torch/native.py), and are called through ctypes on
PyTorch's current stream.

A wrapper called while a CUDA graph is being captured (the evaluator's
fused chains, engine/evaluate.py) records its kernel into the graph
instead of launching it: `capture_launches` tallies those launches on
the capturing thread, and `count_replay` adds them to the counters each
time the graph is replayed, which is when the kernel runs.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import shutil
import threading
import time

import torch

from .. import native
from ..util import coststats as _cs

MAX_BINS = 128
MAX_CHANNELS = 4  # csrc/histogram.cu kMaxChannels
# the least of a row a block takes
MIN_BLOCK_BYTES = 16384

# launches of the histogram kernel (csrc/histogram.cu) in this process,
# through either entry, of those through the id entry (histogram_ids),
# and of those by replays of CUDA graphs that hold it
histogram_launches = 0
histogram_ids_launches = 0
histogram_replay_launches = 0

_SRC = os.path.join(native.PKG_DIR, "csrc", "histogram.cu")
_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
# per thread: the [launches, id launches] tally of the CUDA graph this
# thread is capturing, or None
_capture = threading.local()
# the most blocks (one thread-block cluster) that share a row
MAX_CLUSTER = 16  # csrc/histogram.cu kMaxCluster
# per card index: caps[k - 1], how many clusters of k blocks the card
# holds at once (csrc/histogram.cu hist_cluster_caps)
_cards = {}


def reset_counts() -> None:
    global histogram_launches, histogram_ids_launches, \
        histogram_replay_launches
    histogram_launches = histogram_ids_launches = 0
    histogram_replay_launches = 0


@contextlib.contextmanager
def capture_launches():
    """Around a CUDA graph capture on this thread: the wrappers record
    their kernels into the graph without counting them; yields the
    [launches, id launches] tally that one replay of the graph makes."""
    tally = [0, 0]
    prev = getattr(_capture, "tally", None)
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = prev


def counts() -> dict:
    """This process's launch counters by name."""
    return {"histogram_launches": histogram_launches,
            "histogram_ids_launches": histogram_ids_launches,
            "histogram_replay_launches": histogram_replay_launches}


def fold_counts(other: dict) -> None:
    """Add another process's launch counters (`counts()` of a gang
    member child, engine/gang.py) to this process's: the launches its
    kernels made for this process's work."""
    global histogram_launches, histogram_ids_launches, \
        histogram_replay_launches
    with _count_lock:
        histogram_launches += int(other.get("histogram_launches", 0))
        histogram_ids_launches += int(
            other.get("histogram_ids_launches", 0))
        histogram_replay_launches += int(
            other.get("histogram_replay_launches", 0))


def count_replay(tally) -> None:
    """Count the launches one replay of a captured graph makes (its
    `capture_launches` tally)."""
    global histogram_launches, histogram_ids_launches, \
        histogram_replay_launches
    with _count_lock:
        histogram_launches += tally[0]
        histogram_ids_launches += tally[1]
        histogram_replay_launches += tally[0]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_kernel_library(name: str, src: str) -> str:
    """Build (first use only) `_build/<name>` from one CUDA source with
    nvcc for sm_90a, as a shared library with a plain C interface;
    returns its path."""
    return native.build_shared(
        name, [src],
        [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-o", "{out}", src])


def bind_library(path: str):
    """Load a histogram library and declare its C entries' types."""
    lib = ctypes.CDLL(path)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hist_u8_frames.argtypes = [vp, vp, ll, ll, ci, ci, ci, vp]
    lib.hist_u8_frames.restype = ci
    lib.hist_i32_ids.argtypes = [vp, vp, ll, ll, ci, ci, vp]
    lib.hist_i32_ids.restype = ci
    lib.hist_cluster_caps.argtypes = [vp, ci]
    lib.hist_cluster_caps.restype = ci
    return lib


def load_library():
    """Build (first use only) and load the histogram kernel library.  The
    first load is a compile in the compile ledger (util/coststats.py):
    "hit" when the library was already built, "uncached" when nvcc ran."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                t0 = time.time()
                path = build_kernel_library("libscanner_hist.so", _SRC)
                _lib = bind_library(path)
                built = native.build_seconds.get("libscanner_hist.so", 0.0)
                _cs.note_compile(time.time() - t0,
                                 "uncached" if built else "hit", "library",
                                 os.path.getsize(path))
    return _lib


def cluster_caps(index: int, lib=None) -> tuple:
    """caps[k - 1]: how many clusters of k blocks of the kernel card
    `index` holds at once, k = 1..MAX_CLUSTER; asked once per card."""
    caps = _cards.get(index)
    if caps is None:
        lib = lib or load_library()
        buf = (ctypes.c_int * MAX_CLUSTER)()
        with torch.cuda.device(index):
            err = lib.hist_cluster_caps(buf, MAX_CLUSTER)
        if err:
            raise RuntimeError(f"histogram kernel setup failed: CUDA error "
                               f"{err}")
        caps = _cards[index] = tuple(buf)
    return caps


@functools.lru_cache(maxsize=256)
def blocks_per_row(rows: int, row_bytes: int, caps: tuple) -> int:
    """How many blocks (one thread-block cluster) share each row: the
    most for which the card holds all `rows` clusters at once
    (caps[k - 1] >= rows: one wave, no SM with two blocks' work), with
    at least MIN_BLOCK_BYTES of the row each; 1 where the rows outnumber
    what the card holds."""
    best = 1
    for k in range(2, len(caps) + 1):
        if caps[k - 1] >= rows and row_bytes // k >= MIN_BLOCK_BYTES:
            best = k
    return best


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _offset_bincount(ids: torch.Tensor, valid, rows: int,
                     bins: int) -> torch.Tensor:
    """(rows, n) int ids -> (rows, bins) int32 counts of the ids where
    `valid` holds, by one bincount over ids offset by row."""
    off = ids.to(torch.int64) + (torch.arange(
        rows, device=ids.device, dtype=torch.int64) * bins)[:, None]
    if valid is not None:
        off = off[valid]
    counts = torch.bincount(off.reshape(-1), minlength=rows * bins)
    return counts.to(torch.int32).reshape(rows, bins)


def histogram_ids_plain(vals: torch.Tensor, bins: int = 16) -> torch.Tensor:
    """(R, P) int32 bin ids -> (R, bins) int32; ids outside [0, bins)
    count nowhere (pallas_histogram's padding contract)."""
    R = vals.shape[0]
    return _offset_bincount(vals, (vals >= 0) & (vals < bins), R, bins)


def histogram_frames_plain(frames: torch.Tensor,
                           bins: int = 16) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, C, bins) int32 with bin = (v*bins)//256."""
    b, c = frames.shape[0], frames.shape[-1]
    vals = (frames.to(torch.int32) * bins) >> 8
    vals = vals.reshape(b, -1, c).transpose(1, 2).reshape(b * c, -1)
    return _offset_bincount(vals, None, b * c, bins).reshape(b, c, bins)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_bins(bins: int) -> None:
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"bins must be in [1, {MAX_BINS}], got {bins}")


def _launch(fn, t: torch.Tensor, rows: int, n: int, shape, *args,
            ids: bool = False):
    """Launches `fn` over `rows` rows of `n` elements of `t` on the
    current stream of t's card; returns the output of `shape`, which the
    kernel writes whole.  Raises on a CUDA error.  `ids` counts the
    launch as the id entry's too."""
    global histogram_launches, histogram_ids_launches
    index = t.device.index
    k = blocks_per_row(rows, n * t.element_size(), cluster_caps(index))
    out = torch.empty(shape, dtype=torch.int32, device=t.device)
    call = (t.data_ptr(), out.data_ptr(), rows, n, *args, k,
            torch.cuda.current_stream(index).cuda_stream)
    if index == torch.cuda.current_device():
        err = fn(*call)
    else:
        with torch.cuda.device(index):
            err = fn(*call)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error "
                           f"{err}")
    tally = getattr(_capture, "tally", None)
    if tally is not None:   # recorded into a graph: counted at replay
        tally[0] += 1
        tally[1] += ids
        return out
    with _count_lock:
        histogram_launches += 1
        histogram_ids_launches += ids
    return out


def histogram_frames(frames: torch.Tensor, bins: int = 16) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, C, bins) int32 counts.

    CUDA tensor: the hand-written kernel (csrc/histogram.cu,
    hist_u8_frames), one launch that writes the whole output.  CPU
    tensor: the plain version."""
    _check_bins(bins)
    if frames.dim() != 4:
        raise ValueError(f"histogram_frames wants (B, H, W, C) frames, got "
                         f"shape {tuple(frames.shape)}")
    if frames.dtype != torch.uint8:
        raise TypeError(f"histogram_frames wants uint8, got {frames.dtype}")
    if frames.device.type == "cpu":
        return histogram_frames_plain(frames, bins)
    if frames.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {frames.device}")
    b, h, w, c = frames.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"histogram kernel takes 1..{MAX_CHANNELS} "
                         f"channels (HWC layout), got C={c}")
    if not frames.is_contiguous():
        raise ValueError("histogram kernel wants a contiguous HWC tensor")
    if not b:
        return torch.empty((0, c, bins), dtype=torch.int32,
                           device=frames.device)
    return _launch((_lib or load_library()).hist_u8_frames, frames, b,
                   h * w * c, (b, c, bins), c, bins)


def histogram_ids(vals: torch.Tensor, bins: int = 16) -> torch.Tensor:
    """(R, P) int32 bin ids -> (R, bins) int32 counts; ids outside
    [0, bins) count nowhere.

    CUDA tensor: the hand-written kernel (csrc/histogram.cu,
    hist_i32_ids), one launch that writes the whole output.  CPU tensor:
    the plain version."""
    _check_bins(bins)
    if vals.dim() != 2:
        raise ValueError(f"histogram_ids wants (R, P) ids, got shape "
                         f"{tuple(vals.shape)}")
    if vals.dtype != torch.int32:
        raise TypeError(f"histogram_ids wants int32, got {vals.dtype}")
    if vals.device.type == "cpu":
        return histogram_ids_plain(vals, bins)
    if vals.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {vals.device}")
    if not vals.is_contiguous():
        raise ValueError("histogram kernel wants a contiguous tensor")
    R, P = vals.shape
    if not R:
        return torch.empty((0, bins), dtype=torch.int32, device=vals.device)
    return _launch((_lib or load_library()).hist_i32_ids, vals, R, P,
                   (R, bins), bins, ids=True)
