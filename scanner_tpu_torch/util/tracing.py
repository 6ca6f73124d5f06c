"""Distributed tracing: end-to-end task spans with cross-host assembly.

The Profiler (util/profiler.py) answers "where did this NODE's time go";
the metrics registry (util/metrics.py) answers "what is the cluster doing
right now".  Neither answers the causal question a distributed system
actually debug-loops on: *which* task was slow, and *where* its time went
across client → master → worker → pipeline stage → device op.  This
module adds that third leg:

  * A low-overhead span API: every span carries a 128-bit ``trace_id``
    shared by everything one job caused, a 64-bit ``span_id``, and its
    parent's span id — the assembled tree is the job's causal timeline.
  * W3C-traceparent-style context propagation: ``RpcClient.call``
    injects the current span context into call metadata
    (``_traceparent`` payload key) and the server side re-establishes it
    around the handler, so one trace_id follows a job from
    ``Client.run`` through master scheduling, worker task pull and
    every pipeline stage without any handler changing its signature.
  * A bounded in-memory ring buffer — the **flight recorder** — that
    always holds the most recent completed spans, even when no
    collector is configured: after an incident you can still dump what
    the process was doing (``Tracer.recent``, tools/scanner_trace.py).
  * Export buffers workers drain to ship completed spans to the master
    (engine/service.py ``ShipSpans``), which assembles one merged
    Perfetto/Chrome trace per bulk and computes straggler analytics.

Hot paths are instrumented ONCE: ``Profiler.span`` interval recording
doubles as trace-span recording whenever a trace context is active on
the current thread (see util/profiler.py), so the existing
load/evaluate/save/per-op instrumentation emits both views.

Knobs: ``SCANNER_TPU_TRACING=0`` disables span recording process-wide
(propagation headers stop being injected too); ``SCANNER_TPU_TRACE_RING``
sizes the flight recorder (default 8192 spans); the ``[trace] enabled``
config key is the per-deployment default the env var overrides
(docs/observability.md).
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import re
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from . import metrics as _mx

# every recorded span counts here, so span volume (and ring/export
# overflow) is visible on /metrics next to everything else
_M_SPANS = _mx.registry().counter(
    "scanner_tpu_trace_spans_total",
    "Trace spans completed and recorded by this process's tracers "
    "(flight recorder and/or export buffer).")
_M_SPAN_DROPS = _mx.registry().counter(
    "scanner_tpu_trace_spans_dropped_total",
    "Trace spans evicted from a full flight-recorder ring or dropped "
    "from a full export buffer before shipping.",
    labels=["buffer"])

# payload key RpcClient/RpcServer use to carry the context; popped by
# the server glue before the handler sees the request
TRACEPARENT_KEY = "_traceparent"

_TP_RE = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default) not in ("0", "false", "")


_ENABLED = _env_on("SCANNER_TPU_TRACING")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Flip recording process-wide.  The env var is read at import; this
    is the programmatic override (config key, tests, A/B runs)."""
    global _ENABLED
    _ENABLED = bool(on)


def _ring_capacity() -> int:
    try:
        return max(64, int(os.environ.get("SCANNER_TPU_TRACE_RING",
                                          "8192") or 8192))
    except ValueError:
        return 8192


def new_trace_id() -> str:
    return "%032x" % random.getrandbits(128)


def new_span_id() -> str:
    return "%016x" % random.getrandbits(64)


class SpanContext:
    """The (trace_id, span_id) pair that travels; a remote parent."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __repr__(self) -> str:  # debugging aid only
        return f"SpanContext({self.trace_id[:8]}…, {self.span_id[:8]}…)"


def parse_traceparent(s: Optional[str]) -> Optional[SpanContext]:
    """W3C-shaped ``00-<32hex>-<16hex>-<2hex>`` -> SpanContext, or None
    for anything malformed (a bad header must never fail a call)."""
    if not s or not isinstance(s, str):
        return None
    m = _TP_RE.match(s)
    if m is None:
        return None
    return SpanContext(m.group(1), m.group(2))


class Span:
    """One timed operation.  Completed spans are recorded as plain dicts
    (msgpack-able — they cross RPC) via :meth:`to_dict`."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "node", "thread", "attrs", "events", "status")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], start: float, node: str,
                 thread: str, attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end = 0.0
        self.node = node
        self.thread = thread
        self.attrs = attrs
        self.events: List[Dict[str, Any]] = []
        self.status = "ok"

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def add_event(self, name: str, **attrs: Any) -> None:
        ev: Dict[str, Any] = {"name": name, "t": time.time()}
        if attrs:
            ev["attrs"] = attrs
        self.events.append(ev)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "start": self.start, "end": self.end, "node": self.node,
            "thread": self.thread, "status": self.status,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.events:
            d["events"] = list(self.events)
        return d


class Tracer:
    """Per-component span sink: a bounded flight-recorder ring (always
    on) plus an optional export buffer a shipper drains (workers ship to
    the master; the master drains its own into the bulk's span store).
    One Master/Worker/Client each own a Tracer so in-process clusters
    (tests) keep their components' spans separate."""

    EXPORT_CAP = 65536

    def __init__(self, node: str = "proc", export: bool = False,
                 ring: Optional[int] = None):
        self.node = node
        self._ring: deque = deque(maxlen=ring or _ring_capacity())
        self._export: Optional[List[dict]] = [] if export else None
        self._lock = threading.Lock()

    def record(self, span: Span) -> None:
        d = span.to_dict()
        _M_SPANS.inc()
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                _M_SPAN_DROPS.labels(buffer="ring").inc()
            self._ring.append(d)
            if self._export is not None:
                if len(self._export) < self.EXPORT_CAP:
                    self._export.append(d)
                else:
                    _M_SPAN_DROPS.labels(buffer="export").inc()

    def drain_export(self) -> List[dict]:
        """Take (and clear) the export buffer — the shipper's pull."""
        if self._export is None:
            return []
        with self._lock:
            out, self._export = self._export, []
        return out

    def recent(self, n: int = 50) -> List[dict]:
        """Newest-first tail of the flight recorder."""
        with self._lock:
            items = list(self._ring)
        return list(reversed(items[-n:]))

    def spans_for_trace(self, trace_id: str) -> List[dict]:
        with self._lock:
            return [d for d in self._ring if d["trace_id"] == trace_id]


_DEFAULT = Tracer(node="client")


def default_tracer() -> Tracer:
    """The process-default tracer (local-mode client/executor spans)."""
    return _DEFAULT


# ---------------------------------------------------------------------------
# Context propagation (per-thread via contextvars)
# ---------------------------------------------------------------------------

# (tracer, Span-or-SpanContext); None = not inside any trace
_CURRENT: ContextVar[Optional[Tuple[Tracer,
                                    Union[Span, SpanContext]]]] = \
    ContextVar("scanner_tpu_trace", default=None)


def _ids(obj: Union[Span, SpanContext]) -> Tuple[str, str]:
    return obj.trace_id, obj.span_id


def current_context() -> Optional[SpanContext]:
    cur = _CURRENT.get()
    if cur is None:
        return None
    t, s = _ids(cur[1])
    return SpanContext(t, s)


def current_tracer() -> Optional[Tracer]:
    """The tracer owning the current context, or None.  The calling
    thread's component identity: a span opened by a Worker's executor
    runs under THAT worker's tracer, so ambient consumers (memstats OOM
    reports) can attribute work to the right node even when several
    components share a process."""
    cur = _CURRENT.get()
    return cur[0] if cur is not None else None


def current_span_attrs() -> Dict[str, Any]:
    """Attrs of the current LIVE span, or {} (no span / remote context).
    The stage/task spans on the engine hot paths carry job/task attrs,
    so ambient consumers (the memstats allocation ledger) can attribute
    work to its owning task without new plumbing."""
    cur = _CURRENT.get()
    if cur is None or not isinstance(cur[1], Span):
        return {}
    return dict(cur[1].attrs or {})


def current_traceparent() -> Optional[str]:
    """The header to inject, or None (disabled / outside any trace)."""
    if not _ENABLED:
        return None
    cur = _CURRENT.get()
    if cur is None:
        return None
    t, s = _ids(cur[1])
    return f"00-{t}-{s}-01"


def add_event(name: str, **attrs: Any) -> None:
    """Attach an event to the current live span, if any — the hook fault
    injection (util/faults.py) and transient retries (util/retry.py)
    use, so failures land ON the affected task's timeline."""
    if not _ENABLED:
        return
    cur = _CURRENT.get()
    if cur is None or not isinstance(cur[1], Span):
        return
    cur[1].add_event(name, **attrs)


@contextlib.contextmanager
def use_span(tracer: Tracer, span: Optional[Span]):
    """Make an already-open span current on this thread (stage threads
    resume a task span that was opened on another thread)."""
    if span is None or not _ENABLED:
        yield
        return
    tok = _CURRENT.set((tracer, span))
    try:
        yield
    finally:
        _CURRENT.reset(tok)


@contextlib.contextmanager
def use_context(tracer: Tracer, ctx: Optional[SpanContext]):
    """Make a remote parent current (children attach under it)."""
    if ctx is None or not _ENABLED:
        yield
        return
    tok = _CURRENT.set((tracer, ctx))
    try:
        yield
    finally:
        _CURRENT.reset(tok)


def open_span(tracer: Tracer, name: str,
              parent: Optional[Union[Span, SpanContext]] = None,
              **attrs: Any) -> Optional[Span]:
    """Manually open a span (caller closes with :func:`close_span`).
    ``parent=None`` starts a new root trace.  Returns None when tracing
    is disabled — every consumer treats that as "no span"."""
    if not _ENABLED:
        return None
    if parent is None:
        trace_id, parent_id = new_trace_id(), None
    else:
        # a SpanContext with an empty span_id joins an existing trace
        # as a root-level span (e.g. the master scheduling for a bulk
        # whose submitting client was untraced)
        trace_id, parent_id = _ids(parent)
        parent_id = parent_id or None
    return Span(name, trace_id, new_span_id(), parent_id, time.time(),
                node=tracer.node,
                thread=threading.current_thread().name,
                attrs=attrs or None)


def record_instant(tracer: Tracer, name: str, **attrs: Any) -> None:
    """Record a zero-duration span directly into a tracer's flight
    recorder — point-in-time facts with no span of their own (alert
    firing/resolving transitions from util/health.py land here, so a
    post-incident `tracer.recent()` shows the judgment next to the
    work).  Attaches under the current trace context when one is
    active; otherwise records as a standalone root."""
    if not _ENABLED:
        return
    cur = _CURRENT.get()
    span = open_span(tracer, name, parent=cur[1] if cur else None,
                     **attrs)
    close_span(tracer, span)


def close_span(tracer: Tracer, span: Optional[Span],
               status: Optional[str] = None) -> None:
    if span is None:
        return
    span.end = time.time()
    if status is not None:
        span.status = status
    tracer.record(span)


@contextlib.contextmanager
def start_span(tracer: Tracer, name: str,
               parent: Optional[Union[Span, SpanContext]] = None,
               **attrs: Any):
    """Open a span, make it current, close on exit (status=error on an
    exception).  The ``with``-shaped API for single-thread spans.
    ``parent=None`` nests under the current context when one is active
    (a fresh root otherwise); pass an explicit parent to override —
    use :func:`open_span` when a root is wanted unconditionally."""
    if parent is None:
        cur = _CURRENT.get()
        if cur is not None:
            parent = cur[1]
    span = open_span(tracer, name, parent=parent, **attrs)
    if span is None:
        yield None
        return
    tok = _CURRENT.set((tracer, span))
    try:
        yield span
    except BaseException as e:
        span.status = "error"
        span.add_event("error", type=type(e).__name__, message=str(e)[:200])
        raise
    finally:
        _CURRENT.reset(tok)
        close_span(tracer, span)


# -- the Profiler integration (one instrumentation, two views) --------------

def begin_interval(name: str, attrs: Optional[Dict[str, Any]]):
    """Called by Profiler._Span.__enter__: open a child span of the
    current context (or nothing when there is none — profiler spans
    outside any trace stay trace-free).  Returns an opaque token for
    :func:`end_interval`."""
    cur = _CURRENT.get()
    if cur is None:
        return None
    tracer, parent = cur
    trace_id, parent_id = _ids(parent)
    span = Span(name, trace_id, new_span_id(), parent_id, time.time(),
                node=tracer.node,
                thread=threading.current_thread().name,
                attrs=dict(attrs) if attrs else None)
    tok = _CURRENT.set((tracer, span))
    return (tracer, span, tok)


def record_interval(name: str, start: float, end: float,
                    attrs: Optional[Dict[str, Any]] = None) -> None:
    """Record an interval the caller has already timed as a closed child
    span of the current context (nothing outside any trace).  Called by
    Profiler.add_phase."""
    cur = _CURRENT.get()
    if cur is None or not _ENABLED:
        return
    tracer, parent = cur
    trace_id, parent_id = _ids(parent)
    span = Span(name, trace_id, new_span_id(), parent_id, start,
                node=tracer.node,
                thread=threading.current_thread().name,
                attrs=dict(attrs) if attrs else None)
    span.end = end
    tracer.record(span)


def end_interval(token, exc: Optional[BaseException] = None) -> None:
    if token is None:
        return
    tracer, span, tok = token
    _CURRENT.reset(tok)
    if exc is not None:
        span.status = "error"
        span.add_event("error", type=type(exc).__name__,
                       message=str(exc)[:200])
    close_span(tracer, span)


# ---------------------------------------------------------------------------
# Assembly: Chrome/Perfetto export + straggler analytics
# ---------------------------------------------------------------------------

def chrome_events(span_dicts: Iterable[dict]) -> List[dict]:
    """Span dicts -> Chrome trace events: one pid per node, one tid per
    (node, thread); span events become instant events on the same row;
    trace/span/parent ids ride in args so Perfetto queries can rebuild
    the tree."""
    events: List[dict] = []
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    for d in span_dicts:
        node = d.get("node", "?")
        pid = pids.get(node)
        if pid is None:
            pid = pids[node] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "args": {"name": f"node {node}"}})
        tkey = (node, d.get("thread", "?"))
        tid = tids.get(tkey)
        if tid is None:
            tid = tids[tkey] = \
                sum(1 for k in tids if k[0] == node) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": tkey[1]}})
        args = {"trace_id": d["trace_id"], "span_id": d["span_id"],
                "parent_id": d.get("parent_id") or ""}
        for k, v in (d.get("attrs") or {}).items():
            args[k] = str(v)
        if d.get("status") and d["status"] != "ok":
            args["status"] = d["status"]
        events.append({
            "name": d["name"], "ph": "X", "pid": pid, "tid": tid,
            "ts": d["start"] * 1e6,
            "dur": max(d.get("end", 0.0) - d["start"], 0.0) * 1e6,
            "args": args})
        for ev in d.get("events", ()):
            events.append({
                "name": ev.get("name", "event"), "ph": "i", "s": "t",
                "pid": pid, "tid": tid, "ts": ev.get("t", d["start"]) * 1e6,
                "args": {k: str(v)
                         for k, v in (ev.get("attrs") or {}).items()}})
    return events


def write_chrome_trace(span_dicts: Iterable[dict], path: str,
                       device_events: Iterable[dict] = ()) -> str:
    """One merged Perfetto/Chrome JSON: assembled spans from every node,
    plus (optionally) XLA device timelines (util/jaxprof.py)."""
    events = chrome_events(span_dicts)
    events.extend(device_events)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path


def fold_op_efficiency(span_dict: dict,
                       acc: Dict[str, List[float]]) -> None:
    """Fold one span's `op.efficiency` events (the roofline verdicts
    engine/evaluate.py stamps on evaluate:<op> spans) into the shared
    [eff_sum, n, memory_bound_n] aggregate — used both by the master's
    incremental per-bulk folding (engine/service.py) and the full-dump
    path below, so the two consumers cannot drift."""
    name = span_dict.get("name", "")
    if not isinstance(name, str) or not name.startswith("evaluate:"):
        return
    for ev in span_dict.get("events", ()):
        if ev.get("name") != "op.efficiency":
            continue
        a = ev.get("attrs") or {}
        try:
            eff = float(a.get("eff") or 0.0)
        except (TypeError, ValueError):
            continue
        es = acc.setdefault(name, [0.0, 0, 0])
        es[0] += eff
        es[1] += 1
        if a.get("bound") == "memory":
            es[2] += 1


def op_efficiency_summary(es: Optional[List[float]]) -> Dict[str, float]:
    """One aggregate's reporting shape ({} when nothing was folded)."""
    if not es or not es[1]:
        return {}
    return {"eff_mean": round(es[0] / es[1], 4),
            "memory_bound_frac": round(es[2] / es[1], 4)}


def straggler_summary(span_dicts: Iterable[dict],
                      top_n: int = 10) -> Dict[str, Any]:
    """Per-span-name duration stats + the top-N slowest task spans (with
    their trace ids, so one jump lands in the merged trace).  Used by
    tools/scanner_trace.py on full dumps; the master maintains the same
    shape incrementally (engine/service.py) for GetJobStatus//statusz."""
    span_dicts = list(span_dicts)  # iterated twice (gang fold below)
    per: Dict[str, List[float]] = {}
    tasks: List[Tuple[float, dict]] = []
    # roofline verdicts from op.efficiency events on evaluate:<op>
    # spans — the same fold the master maintains incrementally
    # (engine/service.py uses these exact helpers)
    eff: Dict[str, List[float]] = {}
    for d in span_dicts:
        dur = max(d.get("end", 0.0) - d.get("start", 0.0), 0.0)
        per.setdefault(d["name"], []).append(dur)
        if d["name"] == "task":
            tasks.append((dur, d))
        fold_op_efficiency(d, eff)
    tasks.sort(key=lambda x: -x[0])
    out_stages = {}
    for name, durs in sorted(per.items()):
        out_stages[name] = {
            "count": len(durs), "total_s": round(sum(durs), 4),
            "max_s": round(max(durs), 4),
            "mean_s": round(sum(durs) / len(durs), 4)}
        out_stages[name].update(op_efficiency_summary(eff.get(name)))
    slowest = []
    for dur, d in tasks[:top_n]:
        a = d.get("attrs") or {}
        row = {"job": a.get("job"), "task": a.get("task"),
               "seconds": round(dur, 4), "node": d.get("node"),
               "trace_id": d["trace_id"],
               "span_id": d["span_id"]}
        # gang member task spans carry their gang/epoch/member rank
        # (engine/gang.py): surfacing them keeps a slow HOST inside a
        # co-scheduled gang attributable, not just a slow task
        if a.get("gang") is not None:
            row["gang"] = a.get("gang")
            row["member"] = a.get("member")
        slowest.append(row)
    out = {"per_stage": out_stages, "slowest_tasks": slowest}
    gangs = gang_skew_summary(
        d for d in span_dicts
        if d.get("name") in ("gang.barrier", "gang.collective"))
    if gangs:
        out["gangs"] = gangs
    return out


def gang_skew_summary(span_dicts: Iterable[dict]) -> List[dict]:
    """Per-(gang, epoch) straggler attribution from a full span dump —
    the same rows the master folds incrementally from absorbed
    gang.barrier/gang.collective spans (engine/service.py
    `_fold_gang_phase_locked`): barrier-arrival skew (max - min member
    entry), the slowest member's node and lag vs the median arrival,
    and whether the gang step was barrier-bound or collective-bound.
    Assumes timestamps are already on one clock (the master rebases
    remote spans before handing out the dump); newest epochs last."""
    folds: Dict[Tuple[Any, Any], dict] = {}
    for d in span_dicts:
        name = d.get("name")
        if name not in ("gang.barrier", "gang.collective"):
            continue
        a = d.get("attrs") or {}
        if a.get("gang") is None or a.get("member") is None:
            continue
        rec = folds.setdefault((a.get("gang"), a.get("epoch")), {
            "num": a.get("num"), "job": a.get("job"),
            "task": a.get("task"),
            "arrive": {}, "wait": {}, "collective": {}, "node": {}})
        m = a.get("member")
        rec["node"][m] = d.get("node")
        dur = max(float(d.get("end") or 0.0)
                  - float(d.get("start") or 0.0), 0.0)
        if name == "gang.barrier":
            rec["arrive"][m] = float(d.get("start") or 0.0)
            rec["wait"][m] = dur
        else:
            rec["collective"][m] = dur
    rows = []
    for (gid, ep), rec in sorted(folds.items(),
                                 key=lambda kv: (str(kv[0][0]),
                                                 str(kv[0][1]))):
        num = rec.get("num")
        if not rec["arrive"] or not rec["collective"] \
                or (num and (len(rec["arrive"]) < num
                             or len(rec["collective"]) < num)):
            continue  # incomplete fold (aborted gang / partial dump)
        arrivals = sorted(rec["arrive"].items(), key=lambda kv: kv[1])
        vals = [t for _, t in arrivals]
        skew = vals[-1] - vals[0]
        median = vals[len(vals) // 2] if len(vals) % 2 \
            else (vals[len(vals) // 2 - 1] + vals[len(vals) // 2]) / 2.0
        slow_member, slow_t = arrivals[-1]
        coll_max = max(rec["collective"].values())
        rows.append({
            "gang": gid, "epoch": ep,
            "job": rec["job"], "task": rec["task"],
            "skew_s": round(skew, 4),
            "slowest": rec["node"].get(slow_member),
            "member": slow_member,
            "lag_s": round(slow_t - median, 4),
            "bound": "barrier" if skew >= coll_max else "collective",
            "barrier_wait_max_s": round(max(rec["wait"].values()), 4),
            "collective_max_s": round(coll_max, 4),
        })
    return rows


def verify_chain(span_dicts: Iterable[dict]) -> Dict[str, Any]:
    """Audit an assembled trace: for every task span, is its parent
    chain unbroken back to the root under one trace_id, and does it own
    stage children (load/evaluate/save) and at least one op span?
    Returns {tasks, complete, broken: [...]} — the test suite and
    scanner_trace --verify share this."""
    by_id = {d["span_id"]: d for d in span_dicts}
    trace_ids = {d["trace_id"] for d in by_id.values()}
    kids: Dict[str, List[dict]] = {}
    for d in by_id.values():
        if d.get("parent_id"):
            kids.setdefault(d["parent_id"], []).append(d)
    # per-op spans inherit the profiler's level filter (hot paths are
    # instrumented once): at profiler_level=0 no op span exists
    # anywhere, and their absence is a recording choice, not a break
    has_op_spans = any(d["name"].startswith("evaluate:")
                       for d in by_id.values())
    broken = []
    n_tasks = 0
    for d in by_id.values():
        if d["name"] != "task":
            continue
        n_tasks += 1
        a = d.get("attrs") or {}
        label = f"({a.get('job')},{a.get('task')})"
        # walk to the root
        seen = set()
        cur = d
        while cur.get("parent_id"):
            if cur["span_id"] in seen:
                broken.append(f"task {label}: parent cycle")
                break
            seen.add(cur["span_id"])
            nxt = by_id.get(cur["parent_id"])
            if nxt is None:
                broken.append(
                    f"task {label}: parent {cur['parent_id'][:8]} of "
                    f"`{cur['name']}` missing from the assembled trace")
                break
            cur = nxt
        if d.get("status") != "ok":
            # an errored/revoked attempt legitimately stops mid-chain
            # (a fault during evaluate leaves no save span); only its
            # ancestry is audited
            continue
        stages = {k["name"] for k in kids.get(d["span_id"], ())}
        for want in ("load", "evaluate", "save"):
            if want not in stages:
                broken.append(f"task {label}: no `{want}` stage span")
        evs = [k for k in kids.get(d["span_id"], ())
               if k["name"] == "evaluate"]
        if has_op_spans and evs and not any(
                k["name"].startswith("evaluate:")
                for e in evs for k in kids.get(e["span_id"], ())):
            broken.append(f"task {label}: no per-op span under evaluate")
    # an EMPTY trace must not audit as complete: "100% of zero tasks"
    # is exactly the vacuous pass a tracing outage would produce
    return {"tasks": n_tasks, "trace_ids": sorted(trace_ids),
            "complete": n_tasks > 0 and not broken
            and len(trace_ids) == 1,
            "broken": broken}
