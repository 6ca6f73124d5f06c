"""Compute-efficiency observability: per-op cost model, roofline
attribution, and a compile ledger.

The counterpart of the JAX package's util/coststats.py.  The time plane
(util/tracing.py, util/profiler.py) says an op took 3.1 ms on a card;
the memory plane (util/memstats.py) says whose bytes live there.
Neither says whether 3.1 ms is *good*.  Two halves:

  * **The compile ledger** — what costs seconds the first time an (op,
    device, bucket) signature runs.  In this package that is one of two
    things: the first-use nvcc build and ctypes bind of a kernel library
    (`native.build_shared` via `cuda_ops.load_library`; cache ``hit``
    when the library was already built, else ``uncached``), and the
    capture of a fused chain's CUDA graph (engine/evaluate.py; always
    ``uncached``).  The engine wraps exactly the calls that can pay one
    — each warm-up rung and the first call of a new signature — in
    :func:`observe_compiles`; the compile sites report into it with
    :func:`note_compile`.  Entries go to a bounded per-process ring, the
    ``scanner_tpu_compile_*`` series, and an ``xla.compile`` trace event
    (the JAX package's event name).  ``Client.compile_report()`` serves
    them.
  * **Roofline attribution** — an analytical per-op cost descriptor
    (FLOPs and bytes in/out as a function of the call shape, declared
    via the ``Kernel.cost(shapes)`` hook, else the observed argument
    bytes) joined with the measured seconds of each call, into achieved
    FLOP/s, achieved bytes/s and a compute-vs-memory-bound verdict per
    (op, device, bucket) — the ``scanner_tpu_op_*`` efficiency gauges.

Timing without a stall: the JAX package blocks on each measured call's
result.  Here a timed call on a card is bracketed by a pair of CUDA
events on the current stream (:class:`CallTimer`); the pair is read
later — at the end of the task once its end event has completed, and at
the latest when the evaluator closes — so the ledger adds no host sync.
On the CPU, where calls run synchronously, the host clock times the
call.  The first measured call of each (op, bucket) is timed, then one
in TIME_EVERY: the roofline rows' `calls` and `rows` count timed calls.

Knobs: ``SCANNER_TPU_COSTSTATS=0`` disables both halves;
``SCANNER_TPU_COMPILE_LEDGER`` sizes the ring (default 1024 entries).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import metrics as _mx
from . import tracing as _tracing
from .log import get_logger

_log = get_logger("coststats")

# -- live series (the JAX package's names) ----------------------------------

_M_COMPILES = _mx.registry().counter(
    "scanner_tpu_compile_total",
    "Compiles observed at the engine's dispatch/warm-up sites — kernel "
    "library builds and CUDA graph captures — by op, device and cache "
    "outcome (hit = the library was already built, uncached = built or "
    "captured now).",
    labels=["op", "device", "cache"])
_M_COMPILE_SECONDS = _mx.registry().counter(
    "scanner_tpu_compile_seconds_total",
    "Wall seconds spent in observed compiles per op and device.",
    labels=["op", "device"])
_M_COMPILE_EXEC_BYTES = _mx.registry().counter(
    "scanner_tpu_compile_executable_bytes_total",
    "Bytes of kernel libraries bound at observed compiles, per op and "
    "device (0 for graph captures).",
    labels=["op", "device"])
_M_OP_FLOPS = _mx.registry().gauge(
    "scanner_tpu_op_achieved_flops",
    "Achieved FLOP/s per (op, device, bucket): analytical FLOPs from "
    "the op's cost descriptor divided by measured call seconds "
    "(compile-bearing first calls excluded).  0 when the descriptor "
    "declares no FLOPs (pure data movement).",
    labels=["op", "device", "bucket"])
_M_OP_BW = _mx.registry().gauge(
    "scanner_tpu_op_achieved_bandwidth_bytes",
    "Achieved bytes/s per (op, device, bucket): descriptor bytes "
    "in+out over measured call seconds.",
    labels=["op", "device", "bucket"])
_M_OP_EFF = _mx.registry().gauge(
    "scanner_tpu_op_efficiency_ratio",
    "Roofline efficiency per (op, device, bucket): achieved rate over "
    "the device's peak for the binding resource.  1.0 = at the "
    "roofline.",
    labels=["op", "device", "bucket"])
_M_OP_BOUND = _mx.registry().gauge(
    "scanner_tpu_op_compute_bound",
    "Roofline classification per (op, device, bucket): 1 = "
    "compute-bound (operational intensity above the device ridge "
    "point), 0 = memory-bound (below it, or FLOPs unknown).",
    labels=["op", "device", "bucket"])

_ENABLED = _tracing._env_on("SCANNER_TPU_COSTSTATS")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Programmatic override (tests); the SCANNER_TPU_COSTSTATS env var
    is read at import and is the per-process default."""
    global _ENABLED
    _ENABLED = bool(on)


def _env_ring_size() -> int:
    try:
        return max(16, int(os.environ.get("SCANNER_TPU_COMPILE_LEDGER",
                                          "1024") or 1024))
    except ValueError:
        return 1024


# ---------------------------------------------------------------------------
# Cost descriptors
# ---------------------------------------------------------------------------

@dataclass
class CostDescriptor:
    """Analytical cost of ONE kernel call: floating-point operations
    and bytes moved in/out as the kernel's ``cost(shapes)`` hook
    declared them (``source="hook"``), or as the dispatch site observed
    from live argument bytes when there is no hook
    (``source="observed"``: bytes only, FLOPs unknown)."""

    flops: Optional[float] = None
    bytes_in: Optional[float] = None
    bytes_out: Optional[float] = None
    source: str = "hook"

    @property
    def bytes_total(self) -> float:
        return float(self.bytes_in or 0.0) + float(self.bytes_out or 0.0)


# ---------------------------------------------------------------------------
# Device peaks (the roofline)
# ---------------------------------------------------------------------------

# (substring of torch.cuda.get_device_name, peak FLOP/s, peak bytes/s):
# NVIDIA's published figures for the H100 SXM5 — dense BF16 tensor-core
# rate and HBM3 bandwidth (H100 data sheet).  A card whose name matches
# no row takes the host fallback below; set_device_peaks calibrates it.
DEVICE_PEAKS = (
    ("H100", 989.4e12, 3.35e12),
)
# host fallback: order-of-magnitude for a few AVX cores — CPU EFF% is
# indicative only (tests pin behavior through set_device_peaks)
_CPU_PEAK = (2e11, 5e10)

_peak_lock = threading.Lock()
_peak_overrides: Dict[str, Tuple[float, float]] = {}
_peak_cache: Dict[str, Tuple[float, float]] = {}


def set_device_peaks(device_label: str, peak_flops: float,
                     peak_bytes_per_s: float) -> None:
    """Override the roofline for one device label (calibration from a
    measured microbench, or a synthetic peak in tests)."""
    with _peak_lock:
        _peak_overrides[device_label] = (float(peak_flops),
                                         float(peak_bytes_per_s))
        _peak_cache.pop(device_label, None)


def _device_kind(device_label: str) -> str:
    """The card's name for a "cuda:N" label; "" for anything else."""
    if not device_label.startswith("cuda") or not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(torch.device(device_label))


def device_peaks(device_label: str) -> Tuple[float, float]:
    """(peak FLOP/s, peak bytes/s) for a device label: explicit
    override > a DEVICE_PEAKS row matched on the card's name > the host
    fallback."""
    with _peak_lock:
        if device_label in _peak_overrides:
            return _peak_overrides[device_label]
        if device_label in _peak_cache:
            return _peak_cache[device_label]
    kind = _device_kind(device_label).lower()
    peak = _CPU_PEAK
    for sub, f, b in DEVICE_PEAKS:
        if sub.lower() in kind:
            peak = (f, b)
            break
    with _peak_lock:
        _peak_cache[device_label] = peak
    return peak


def classify(device_label: str, flops: Optional[float],
             bytes_total: float, seconds: float
             ) -> Optional[Dict[str, Any]]:
    """Roofline verdict for measured work: achieved rates plus the
    binding resource and its efficiency.  None when there is nothing
    to judge (no time, or neither FLOPs nor bytes known)."""
    if seconds <= 0:
        return None
    peak_f, peak_b = device_peaks(device_label)
    f_rate = (flops or 0.0) / seconds
    b_rate = bytes_total / seconds
    if flops and bytes_total:
        # operational intensity vs the ridge point decides the bound
        compute = (flops / bytes_total) >= (peak_f / peak_b)
    elif flops:
        compute = True
    elif bytes_total:
        compute = False
    else:
        return None
    eff = (f_rate / peak_f) if compute else (b_rate / peak_b)
    return {"flops_per_s": f_rate, "bytes_per_s": b_rate,
            "bound": "compute" if compute else "memory",
            "eff": eff}


# ---------------------------------------------------------------------------
# Timing measured calls
# ---------------------------------------------------------------------------

# a timer times the first measured call of each (op, bucket) and then
# one in TIME_EVERY: each timed call on a card makes three more CUDA
# runtime calls (two event records and a query), and each lets the
# loader threads take the interpreter lock from the evaluation thread —
# timing every call lengthened config 1's Histogram span by about 0.5 ms
# a call on an H100 (PERF.md §6, tools/torch_main_path_ab.py)
TIME_EVERY = 8


class CallTimer:
    """Times measured calls without a host sync per call.

    `due(key)` says whether the next call under `key` is timed (the
    first, then one in TIME_EVERY).  `start(device)` / `stop(token,
    done)` bracket one call: on a CUDA device with a pair of timing
    events on the current stream, whose elapsed seconds reach
    `done(seconds)` once the end event has completed — `resolve()`
    reads every finished pair without waiting, `resolve(wait=True)`
    waits for the rest.  On the CPU the host clock times the call and
    `done` runs at `stop`.  One timer belongs to one thread (the
    evaluator's)."""

    def __init__(self):
        self._pending: List[Tuple[Any, Any, Callable[[float], None]]] = []
        self._seen: Dict[Any, int] = {}

    def due(self, key: Any) -> bool:
        n = self._seen.get(key, 0)
        self._seen[key] = n + 1
        return n % TIME_EVERY == 0

    def start(self, device: Optional[torch.device]) -> Any:
        if device is not None and device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            return ev, device
        return time.perf_counter()

    def stop(self, token: Any, done: Callable[[float], None]) -> None:
        if isinstance(token, float):
            done(time.perf_counter() - token)
            return
        start, device = token
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(device))
        self._pending.append((start, end, done))

    def resolve(self, wait: bool = False) -> None:
        keep = []
        for start, end, done in self._pending:
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append((start, end, done))
                continue
            done(start.elapsed_time(end) / 1e3)
        self._pending = keep


# ---------------------------------------------------------------------------
# The compile ledger
# ---------------------------------------------------------------------------

_tls = threading.local()


class _CompileCtx:
    """One observe_compiles() block's scratch, on the observing thread
    (library builds and graph captures run on the calling thread)."""

    __slots__ = ("op", "device", "bucket", "signature", "members",
                 "compiles")

    def __init__(self, op: str, device: str, bucket: int, signature: str,
                 members: Optional[Sequence[str]] = None):
        self.op = op
        self.device = device
        self.bucket = int(bucket)
        self.signature = signature
        self.members = list(members) if members is not None else None
        # (seconds, cache, kind, executable bytes)
        self.compiles: List[Tuple[float, str, str, int]] = []


_ledger_lock = threading.Lock()
_ledger: deque = deque(maxlen=_env_ring_size())
_ledger_seq = 0


@contextlib.contextmanager
def observe_compiles(op: str, device: str, bucket: int, signature: str,
                     members: Optional[Sequence[str]] = None):
    """Attribute any compile inside the block to (op, device, bucket):
    the engine wraps exactly the calls that can compile — each warm-up
    rung, and the first call of a new signature.  Nothing is recorded
    when no compile fires.  No-op when coststats is disabled.  Fused
    chains pass `members` (graph/fusion.py) so entries under the chain
    id stay explainable op by op."""
    if not _ENABLED:
        yield
        return
    prev = getattr(_tls, "ctx", None)
    ctx = _CompileCtx(op, device, bucket, signature, members=members)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev
        if ctx.compiles:
            _record_compiles(ctx)


def note_compile(seconds: float, cache: str, kind: str,
                 exec_bytes: int = 0) -> None:
    """Report one compile from the site that paid it: `kind` "library"
    (an nvcc build and bind; `cache` "hit" when it was already built,
    else "uncached") or "graph" (a CUDA graph capture, "uncached").  It
    lands in the innermost observe_compiles block on this thread; a
    compile outside any block is not recorded."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.compiles.append((float(seconds), cache, kind, int(exec_bytes)))


def _record_compiles(ctx: _CompileCtx) -> None:
    global _ledger_seq
    total_s = sum(c[0] for c in ctx.compiles)
    caches = [c[1] for c in ctx.compiles]
    cache = "hit" if all(c == "hit" for c in caches) else "uncached"
    exec_bytes = sum(c[3] for c in ctx.compiles)
    task, trace_id = None, None
    attrs = _tracing.current_span_attrs()
    if "task" in attrs:
        task = f"{attrs.get('job')},{attrs.get('task')}"
    cur = _tracing.current_context()
    if cur is not None:
        trace_id = cur.trace_id
    entry = {
        "op": ctx.op, "device": ctx.device, "bucket": ctx.bucket,
        "signature": ctx.signature, "compiles": len(ctx.compiles),
        "kinds": [c[2] for c in ctx.compiles],
        "compile_s": round(total_s, 6), "cache": cache,
        "exec_bytes": exec_bytes,
        "time": time.time(), "task": task, "trace_id": trace_id,
    }
    if ctx.members is not None:
        entry["members"] = list(ctx.members)
    with _ledger_lock:
        _ledger_seq += 1
        entry["seq"] = _ledger_seq
        _ledger.append(entry)
    # metric/tracing work outside the ledger lock
    for _s, c, _k, _b in ctx.compiles:
        _M_COMPILES.labels(op=ctx.op, device=ctx.device, cache=c).inc()
    _M_COMPILE_SECONDS.labels(op=ctx.op, device=ctx.device).inc(total_s)
    if exec_bytes:
        _M_COMPILE_EXEC_BYTES.labels(op=ctx.op, device=ctx.device).inc(
            exec_bytes)
    _tracing.add_event("xla.compile", op=ctx.op, device=ctx.device,
                       bucket=ctx.bucket, seconds=round(total_s, 4),
                       cache=cache)


def compile_ledger(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """Ledger entries, oldest first (the newest `n` when given)."""
    with _ledger_lock:
        items = list(_ledger)
    return items[-n:] if n else items


def ledger_summary() -> Dict[str, Any]:
    """Aggregate ledger view: totals, per-cache-outcome counts, and the
    share of library builds found already built (None when no entry had
    a library)."""
    with _ledger_lock:
        items = list(_ledger)
        total_seen = _ledger_seq
    by_cache: Dict[str, int] = {}
    secs = 0.0
    compiles = 0
    for e in items:
        by_cache[e["cache"]] = by_cache.get(e["cache"], 0) + 1
        secs += e["compile_s"]
        compiles += e["compiles"]
    hit = by_cache.get("hit", 0)
    libs = sum("library" in e["kinds"] for e in items)
    rate = hit / libs if libs else None
    return {"entries": len(items), "entries_seen": total_seen,
            "compiles": compiles, "compile_seconds": round(secs, 4),
            "by_cache": by_cache, "cache_hit_rate": rate}


# ---------------------------------------------------------------------------
# Per-op cost descriptors at the dispatch site
# ---------------------------------------------------------------------------

def descriptor_for(kernel: Any, op: str, device: str, bucket: int,
                   args: Sequence[Any]) -> Optional[CostDescriptor]:
    """The cost of one kernel call: the kernel's ``cost(shapes)`` hook
    first; else bytes observed from the live args (FLOPs unknown).  None
    when coststats is off."""
    if not _ENABLED:
        return None
    shapes: List[Any] = []
    for a in args:
        shp = getattr(a, "shape", None)
        shapes.append(tuple(shp) if shp is not None else len(a))
    try:
        d = kernel.cost(shapes)
        if d is not None:
            # conversion stays inside the guard: a hook returning a
            # malformed dict is as broken as one that raises
            if isinstance(d, dict):
                d = CostDescriptor(**d)
            d.source = "hook"
            return d
    except Exception:  # noqa: BLE001 — a broken hook must not fail a task
        _log.debug("cost() hook of %s failed", op, exc_info=True)
    nb = 0
    for a in args:
        if isinstance(a, torch.Tensor):
            nb += a.numel() * a.element_size()
        else:
            nb += int(getattr(a, "nbytes", 0) or 0)
    if not nb:
        return None
    return CostDescriptor(flops=None, bytes_in=float(nb),
                          bytes_out=None, source="observed")


# ---------------------------------------------------------------------------
# Roofline accumulation
# ---------------------------------------------------------------------------

_op_lock = threading.Lock()
# (op, device, bucket) -> [calls, rows, seconds, flops, bytes_in,
#                          bytes_out, source]
_op_stats: Dict[Tuple[str, str, int], List[Any]] = {}


def record_op_call(op: str, device: str, bucket: int, rows: int,
                   seconds: float, desc: Optional[CostDescriptor]
                   ) -> Optional[Dict[str, Any]]:
    """Fold one measured, compile-free call into the (op, device,
    bucket) aggregate and refresh the efficiency gauges.  Returns the
    cumulative classification (classify() shape) or None when there is
    nothing to judge."""
    if not _ENABLED or desc is None or seconds <= 0:
        return None
    key = (op, device, int(bucket))
    with _op_lock:
        st = _op_stats.get(key)
        if st is None:
            st = _op_stats[key] = [0, 0, 0.0, 0.0, 0.0, 0.0, desc.source]
        st[0] += 1
        st[1] += int(rows)
        st[2] += float(seconds)
        st[3] += float(desc.flops or 0.0)
        st[4] += float(desc.bytes_in or 0.0)
        st[5] += float(desc.bytes_out or 0.0)
        st[6] = desc.source
        calls, _rows, secs, flops, b_in, b_out, _src = st
    cls = classify(device, flops or None, b_in + b_out, secs)
    if cls is None:
        return None
    b = str(int(bucket))
    _M_OP_FLOPS.labels(op=op, device=device, bucket=b).set(
        cls["flops_per_s"])
    _M_OP_BW.labels(op=op, device=device, bucket=b).set(
        cls["bytes_per_s"])
    _M_OP_EFF.labels(op=op, device=device, bucket=b).set(cls["eff"])
    _M_OP_BOUND.labels(op=op, device=device, bucket=b).set(
        1.0 if cls["bound"] == "compute" else 0.0)
    return cls


def op_efficiency() -> List[Dict[str, Any]]:
    """The roofline table: one row per (op, device, bucket) with
    measured rates, the bound classification and EFF%."""
    with _op_lock:
        items = sorted(_op_stats.items())
    out = []
    for (op, device, bucket), (calls, rows, secs, flops, b_in, b_out,
                               src) in items:
        cls = classify(device, flops or None, b_in + b_out, secs)
        if cls is None:
            continue
        peak_f, peak_b = device_peaks(device)
        out.append({
            "op": op, "device": device, "bucket": bucket,
            "calls": calls, "rows": rows, "seconds": round(secs, 6),
            "flops_per_s": round(cls["flops_per_s"], 2),
            "bytes_per_s": round(cls["bytes_per_s"], 2),
            "bound": cls["bound"],
            "efficiency": round(cls["eff"], 6),
            "peak_flops": peak_f, "peak_bytes_per_s": peak_b,
            "cost_source": src,
        })
    return out


def status_dict() -> Dict[str, Any]:
    """The /statusz Efficiency panel: the roofline table plus the
    compile-ledger summary."""
    return {"enabled": _ENABLED,
            "ops": op_efficiency(),
            "compile": ledger_summary()}


def compile_report() -> Dict[str, Any]:
    """One process's full efficiency report: the bounded ledger, its
    summary, and the roofline table."""
    return {"ledger": compile_ledger(),
            "summary": ledger_summary(),
            "op_efficiency": op_efficiency()}
