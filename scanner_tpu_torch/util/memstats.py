"""Memory observability: per-device memory accounting + allocation ledger.

The counterpart of the JAX package's util/memstats.py.  Staged source
columns (`ColumnBatch.to_device`), bucket-ladder warm-up inputs
(engine/evaluate.py precompile) and sink batches waiting for their fetch
all hold device memory; an out-of-memory error names no owner by
itself.  This module is the accountant, with two sources of truth that
cross-check each other:

  * **The allocator's own stats** — `torch.cuda.memory_stats(index)`
    (`allocated_bytes.all.current` / `.peak`) and
    `torch.cuda.mem_get_info(index)` (the card's capacity) for every
    card this process has used, sampled at scrape time as the
    ``scanner_tpu_device_hbm_*`` gauges.  Absent on the CPU, and never
    the thing that initializes CUDA.
  * **The allocation ledger** — every engine-owned device buffer
    registers ``(bytes, device, kind, task, trace_id)`` on create and
    releases when the tensor is collected (``track_array`` hangs a
    ``weakref.finalize`` off the tensor, so a leaked staging batch is a
    *visible* live ledger entry).  Live bytes and a high watermark are
    kept per (device, kind) and mirrored into the ``scanner_tpu_ledger_*``
    series.

On `torch.cuda.OutOfMemoryError` (or the engine's own DeviceOutOfMemory,
which the ``memory.pressure`` fault site raises on the CPU) the
staging/dispatch sites call :func:`note_oom`, which builds a one-shot
**memory report** — device stats, the top-N ledger entries by bytes with
their owning task and trace id, and the tail of the tracing flight
recorder — logs it, and keeps it for ``Client.memory_report()``.

Knobs: ``SCANNER_TPU_MEMSTATS=0`` disables ledger tracking (the device
gauges stay — they cost only a scrape-time sample);
``SCANNER_TPU_MEMSTATS_TOPN`` sizes the report's top-entry list
(default 10).
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..common import DeviceOutOfMemory
from . import metrics as _mx
from . import tracing as _tracing
from .log import get_logger

_log = get_logger("memstats")

# -- live series (the JAX package's names) ----------------------------------

# allocator-reported device memory, sampled at scrape time
# (set_function children installed per card this process has used)
_M_HBM_USE = _mx.registry().gauge(
    "scanner_tpu_device_hbm_bytes_in_use",
    "Device memory the caching allocator holds in tensors "
    "(torch.cuda.memory_stats allocated_bytes.all.current), sampled at "
    "scrape time.  Absent on the CPU.",
    labels=["device"])
_M_HBM_PEAK = _mx.registry().gauge(
    "scanner_tpu_device_hbm_peak_bytes",
    "Peak device memory in tensors since process start (or the last "
    "torch.cuda.reset_peak_memory_stats), allocated_bytes.all.peak.",
    labels=["device"])
_M_HBM_LIMIT = _mx.registry().gauge(
    "scanner_tpu_device_hbm_limit_bytes",
    "The card's memory capacity (torch.cuda.mem_get_info total).",
    labels=["device"])

# the allocation ledger's own view — engine-owned buffers only, so
# (hbm_bytes_in_use - ledger_live_bytes) is the non-engine remainder
# (model weights, graph pools, scratch)
_M_LEDGER_LIVE = _mx.registry().gauge(
    "scanner_tpu_ledger_live_bytes",
    "Bytes of engine-owned device buffers currently registered in the "
    "allocation ledger, per device and buffer kind (staging / warmup / "
    "sink).",
    labels=["device", "kind"])
_M_LEDGER_PEAK = _mx.registry().gauge(
    "scanner_tpu_ledger_peak_bytes",
    "High watermark of ledger live bytes per (device, kind) since "
    "process start.",
    labels=["device", "kind"])
_M_LEDGER_ALLOCS = _mx.registry().counter(
    "scanner_tpu_ledger_allocs_total",
    "Device buffers registered in the allocation ledger, per device "
    "and kind.",
    labels=["device", "kind"])
_M_LEDGER_RELEASES = _mx.registry().counter(
    "scanner_tpu_ledger_releases_total",
    "Ledger entries released (buffer collected or explicitly freed), "
    "per device and kind.  allocs - releases = live entry count.",
    labels=["device", "kind"])
_M_OOM = _mx.registry().counter(
    "scanner_tpu_device_oom_events_total",
    "Device out-of-memory events observed at engine staging/dispatch "
    "sites (real ones, or memory.pressure fault injections), by site.",
    labels=["site"])


_ENABLED = _tracing._env_on("SCANNER_TPU_MEMSTATS")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Programmatic override (tests); the SCANNER_TPU_MEMSTATS env var
    is read at import."""
    global _ENABLED
    _ENABLED = bool(on)


def _env_top_n() -> Optional[int]:
    v = os.environ.get("SCANNER_TPU_MEMSTATS_TOPN", "")
    try:
        n = int(v) if v else None
    except ValueError:
        return None
    # a report must stay bounded (negative values would flip the
    # top-entries slice into "all but N")
    return max(1, n) if n is not None else None


_REPORT_TOP_N = _env_top_n() or 10


def report_top_n() -> int:
    return _REPORT_TOP_N


def set_report_top_n(n: int) -> None:
    """[memory] report_top_n config wiring; the SCANNER_TPU_MEMSTATS_TOPN
    env var (read at import) wins when set."""
    global _REPORT_TOP_N
    if _env_top_n() is None:
        _REPORT_TOP_N = max(1, int(n))


def device_label(device: Optional[Any]) -> str:
    """Stable label for a torch device ("cuda:0", "cpu"); "default" for
    no device (host kernels).  The one implementation — the evaluator
    takes it from here, so metrics, ledger entries and trace attrs key
    devices identically."""
    return "default" if device is None else str(device)


def array_device_label(arr: Any) -> str:
    """Label of the device a tensor lives on; "default" for anything
    that is not a tensor."""
    if isinstance(arr, torch.Tensor):
        return device_label(arr.device)
    return "default"


# ---------------------------------------------------------------------------
# The allocation ledger
# ---------------------------------------------------------------------------

class _Entry:
    __slots__ = ("eid", "nbytes", "device", "kind", "task", "trace_id",
                 "created")

    def __init__(self, eid: int, nbytes: int, device: str, kind: str,
                 task: Optional[str], trace_id: Optional[str]):
        self.eid = eid
        self.nbytes = int(nbytes)
        self.device = device
        self.kind = kind
        self.task = task
        self.trace_id = trace_id
        self.created = time.time()

    def to_dict(self) -> Dict[str, Any]:
        return {"id": self.eid, "bytes": self.nbytes,
                "device": self.device, "kind": self.kind,
                "task": self.task, "trace_id": self.trace_id,
                "age_s": round(time.time() - self.created, 3)}


# RLock, not Lock: release() runs from weakref finalizers, which the
# cyclic GC may fire at any allocation point — including one inside a
# locked register() on the same thread.  Lock-order rule: NOTHING
# acquires a metrics lock while holding this one (and the finalizer path
# touches no metric locks at all).
_lock = threading.RLock()
_entries: Dict[int, _Entry] = {}
_next_id = 0
_live: Dict[Tuple[str, str], int] = {}
_peak: Dict[Tuple[str, str], int] = {}
# (device, kind) keys whose ledger gauges already have scrape-time
# samplers, and release counts awaiting a counter flush from a normal
# (non-finalizer) thread
_gauged_keys: set = set()
_pending_releases: Dict[Tuple[str, str], int] = {}


def _install_ledger_gauges(key: Tuple[str, str]) -> None:
    """Scrape-time samplers for one (device, kind)'s live/peak gauges;
    the live sampler also flushes deferred release counts, so a scrape
    of an idle process shows allocs - releases = live entries."""
    d, k = key

    def live_sample(key=key):
        _flush_release_counts()
        return float(_live.get(key, 0))

    _M_LEDGER_LIVE.labels(device=d, kind=k).set_function(live_sample)
    _M_LEDGER_PEAK.labels(device=d, kind=k).set_function(
        lambda key=key: float(_peak.get(key, 0)))


def _flush_release_counts() -> None:
    """Mirror deferred release counts into the releases counter (the
    finalizer path defers it: metric locks are unsafe there)."""
    with _lock:
        if not _pending_releases:
            return
        pending = dict(_pending_releases)
        _pending_releases.clear()
    for (d, k), n in pending.items():
        _M_LEDGER_RELEASES.labels(device=d, kind=k).inc(n)


def _current_owner() -> Tuple[Optional[str], Optional[str]]:
    """(task, trace_id) from the active tracing context: the task spans
    carry job/task attrs, so a buffer registered under one inherits its
    owner."""
    ctx = _tracing.current_context()
    trace_id = ctx.trace_id if ctx is not None else None
    attrs = _tracing.current_span_attrs()
    task = None
    if "task" in attrs:
        task = f"{attrs.get('job')},{attrs.get('task')}"
    return task, trace_id


def register(nbytes: int, device: str, kind: str,
             task: Optional[str] = None,
             trace_id: Optional[str] = None) -> Optional[int]:
    """Record an engine-owned device buffer; returns the entry id (None
    when memstats is disabled).  Pair with :func:`release`, or use
    :func:`track_array`, which releases when the tensor is collected."""
    if not _ENABLED:
        return None
    if task is None and trace_id is None:
        task, trace_id = _current_owner()
    global _next_id
    key = (device, kind)
    with _lock:
        eid = _next_id
        _next_id += 1
        e = _Entry(eid, nbytes, device, kind, task, trace_id)
        _entries[eid] = e
        live = _live.get(key, 0) + e.nbytes
        _live[key] = live
        if live > _peak.get(key, 0):
            _peak[key] = live
        new_key = key not in _gauged_keys
        if new_key:
            _gauged_keys.add(key)
    # metric work strictly outside the ledger lock
    if new_key:
        _install_ledger_gauges(key)
    _M_LEDGER_ALLOCS.labels(device=device, kind=kind).inc()
    _flush_release_counts()
    _tracing.add_event("mem.register", kind=kind, bytes=int(nbytes),
                       device=device)
    return eid


def release(eid: Optional[int]) -> None:
    """Drop a ledger entry.  Runs from weakref finalizers: only the
    reentrant ledger lock and plain dict work in here."""
    if eid is None:
        return
    with _lock:
        e = _entries.pop(eid, None)
        if e is None:
            return  # double release (finalizer + explicit): idempotent
        key = (e.device, e.kind)
        _live[key] = max(_live.get(key, 0) - e.nbytes, 0)
        _pending_releases[key] = _pending_releases.get(key, 0) + 1


def track_array(arr: Any, kind: str,
                device: Optional[str] = None) -> Optional[int]:
    """Register a tensor's bytes and release them when the tensor is
    collected (weakref.finalize), so the ledger stays byte-accurate with
    no manual pairing on the engine's hot paths.  Returns the entry id,
    or None (disabled, empty, or not a tensor)."""
    if not isinstance(arr, torch.Tensor):
        return None
    if arr.device.type == "cuda":
        _maybe_install_device_gauges()
    if not _ENABLED:
        return None
    nbytes = arr.numel() * arr.element_size()
    if not nbytes:
        return None
    eid = register(int(nbytes), device or array_device_label(arr), kind)
    if eid is not None:
        weakref.finalize(arr, release, eid)
    return eid


def live_bytes(device: Optional[str] = None,
               kind: Optional[str] = None) -> int:
    with _lock:
        return sum(v for (d, k), v in _live.items()
                   if (device is None or d == device)
                   and (kind is None or k == kind))


def watermark_bytes(device: Optional[str] = None,
                    kind: Optional[str] = None) -> int:
    with _lock:
        return sum(v for (d, k), v in _peak.items()
                   if (device is None or d == device)
                   and (kind is None or k == kind))


def top_entries(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """The N largest live entries by bytes — the "who owns the device
    memory" answer a report leads with."""
    with _lock:
        es = sorted(_entries.values(), key=lambda e: -e.nbytes)
        return [e.to_dict() for e in es[:n or _REPORT_TOP_N]]


def ledger_summary() -> List[Dict[str, Any]]:
    _flush_release_counts()
    with _lock:
        keys = sorted(set(_live) | set(_peak))
        counts: Dict[Tuple[str, str], int] = {}
        for e in _entries.values():
            k = (e.device, e.kind)
            counts[k] = counts.get(k, 0) + 1
        return [{"device": d, "kind": k,
                 "live_bytes": _live.get((d, k), 0),
                 "peak_bytes": _peak.get((d, k), 0),
                 "entries": counts.get((d, k), 0)}
                for d, k in keys]


# ---------------------------------------------------------------------------
# Allocator-reported device stats
# ---------------------------------------------------------------------------

def _cuda_ready() -> bool:
    """True only when this process has already initialized CUDA: a
    status read must never be what creates a context on a card."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _read_stats(index: int) -> Optional[Dict[str, int]]:
    """{bytes_in_use, peak_bytes, limit_bytes} of card `index`, or None
    for a card this process never allocated on."""
    st = torch.cuda.memory_stats(index)
    if not st:
        return None
    _free, total = torch.cuda.mem_get_info(index)
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes": int(st.get("allocated_bytes.all.peak", 0)),
            "limit_bytes": int(total)}


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{device_label: {bytes_in_use, peak_bytes, limit_bytes}} for every
    card this process allocated on; {} on the CPU and in processes that
    never initialized CUDA."""
    if not _cuda_ready():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        st = _read_stats(i)
        if st is not None:
            out[device_label(torch.device("cuda", i))] = st
    if out:
        _maybe_install_device_gauges()
    return out


_gauges_installed = False


def _maybe_install_device_gauges() -> None:
    """Install scrape-time samplers for the device gauges, once, for
    every card; lazy, so importing this module never touches CUDA."""
    global _gauges_installed
    if _gauges_installed or not _cuda_ready():
        return
    _gauges_installed = True
    for i in range(torch.cuda.device_count()):
        lbl = device_label(torch.device("cuda", i))
        for gauge, stat in ((_M_HBM_USE, "bytes_in_use"),
                            (_M_HBM_PEAK, "peak_bytes"),
                            (_M_HBM_LIMIT, "limit_bytes")):
            gauge.labels(device=lbl).set_function(
                lambda i=i, s=stat: float((_read_stats(i) or {}).get(s, 0)))


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

def is_oom(exc: BaseException) -> bool:
    """True for device memory exhaustion: the engine's own
    DeviceOutOfMemory (also what the memory.pressure fault site raises)
    or PyTorch's torch.cuda.OutOfMemoryError."""
    return isinstance(exc, (DeviceOutOfMemory, torch.cuda.OutOfMemoryError))


# the flight recorder an OOM report snapshots; components with their own
# tracer (the cluster Worker) install it so the report shows what THAT
# process was doing, not the default client tracer
_tracer: Optional[Any] = None


def set_tracer(tracer: Any) -> None:
    global _tracer
    _tracer = tracer


_report_lock = threading.Lock()
_last_report: Optional[Dict[str, Any]] = None
_report_seq = 0
_last_log_time = 0.0
LOG_INTERVAL = 60.0  # full-report log lines at most this often


def memory_report(reason: str = "",
                  site: str = "") -> Dict[str, Any]:
    """One forensic snapshot: device stats, the ledger summary, the
    top-N live entries by bytes (with owning task + trace id), and the
    tail of the flight recorder.  A plain dict."""
    tracer = _tracing.current_tracer() or _tracer \
        or _tracing.default_tracer()
    recent = [{"name": d.get("name"), "trace_id": d.get("trace_id"),
               "span_id": d.get("span_id"), "node": d.get("node"),
               "start": d.get("start"), "end": d.get("end"),
               "status": d.get("status")}
              for d in tracer.recent(20)]
    return {
        "time": time.time(),
        "reason": reason,
        "site": site,
        "node": getattr(tracer, "node", None),
        "devices": device_memory_stats(),
        "ledger": ledger_summary(),
        "top_entries": top_entries(),
        "recent_spans": recent,
    }


def note_oom(exc: BaseException, site: str,
             detail: str = "") -> Dict[str, Any]:
    """Record one out-of-memory observation: count it, attach it to the
    current task's trace span, build the memory report, keep it for
    Client.memory_report(), and log it — the full report at most once
    per LOG_INTERVAL, a one-liner always."""
    global _last_report, _report_seq, _last_log_time
    _M_OOM.labels(site=site).inc()
    _tracing.add_event("mem.oom", site=site,
                       error=f"{type(exc).__name__}: {str(exc)[:200]}")
    report = memory_report(
        reason=f"{type(exc).__name__}: {str(exc)[:300]}", site=site)
    if detail:
        report["detail"] = detail
    with _report_lock:
        _report_seq += 1
        report["seq"] = _report_seq
        _last_report = report
        now = time.time()
        log_full = now - _last_log_time >= LOG_INTERVAL
        if log_full:
            _last_log_time = now
    top = report["top_entries"][:3]
    _log.error(
        "device memory exhausted at %s (%s); ledger live=%d bytes, "
        "top entries: %s",
        site, report["reason"], live_bytes(),
        ", ".join(f"{e['bytes']}B {e['kind']}@{e['device']} "
                  f"task={e['task']}" for e in top) or "none")
    if log_full:
        _log.error("memory report: %s", json.dumps(report, default=str))
    return report


def last_report() -> Optional[Dict[str, Any]]:
    with _report_lock:
        return dict(_last_report) if _last_report else None


_shipped_seq = 0


def take_unshipped_report() -> Optional[Dict[str, Any]]:
    """The newest report, handed out at most once (a GLOBAL claim-once
    cursor: report state is process-wide, so when several in-process
    Workers poll, exactly one ships each report instead of each
    duplicating it)."""
    global _shipped_seq
    with _report_lock:
        if _last_report is not None and _report_seq > _shipped_seq:
            _shipped_seq = _report_seq
            return dict(_last_report)
        return None


def status_dict() -> Dict[str, Any]:
    """The compact live view (the JAX package's /statusz Memory panel
    keys; full top-entries detail stays on the report path)."""
    with _report_lock:
        last = ({"time": _last_report["time"],
                 "site": _last_report.get("site"),
                 "reason": _last_report.get("reason")}
                if _last_report else None)
        oom_events = _report_seq
    return {
        "enabled": _ENABLED,
        "devices": device_memory_stats(),
        "ledger": ledger_summary(),
        "ledger_live_bytes": live_bytes(),
        "oom_events": oom_events,
        "last_oom": last,
    }
