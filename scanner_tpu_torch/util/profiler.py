"""Interval profiler with Chrome-trace export.

Capability parity: reference scanner/util/profiler.{h,cpp} (per-thread
interval recorder, nanosecond timestamps) + scannerpy/profiler.py
(Profile.write_trace Chrome trace JSON :57-199, statistics :214).

Besides intervals, a profiler keeps a job's phases (`add_phase`): the
stretches of a job that no stage span covers — its set-up, the
pipeline's drain, the table commit.  They are kept apart
from `intervals()`, whose earliest start and latest end are the
envelope of the job's stage work, and are counted by
`Profile.statistics()` under their own names.

A kernel records spans of its own in its job's profile through the
module-level `span()`: the evaluator makes its profiler this thread's
current one (`recording_into`) around its kernel calls, so those spans
land inside the op's `evaluate:<op>` span; with no current profiler
(a kernel called outside the engine, or by the evaluator's warm-up
thread) they record nothing.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from . import metrics as _mx
from . import tracing as _tracing

# every profiler counter event mirrors into this live series, so the
# post-mortem trace counters and the /metrics endpoint can never
# disagree on event counts (docs/observability.md)
_M_EVENTS = _mx.registry().counter(
    "scanner_tpu_profiler_events_total",
    "Profiler counter events (state_carry_miss, stream_chunks, ...); "
    "mirrors Profiler.count so traces and live metrics agree.",
    labels=["event"])


# the Chrome-trace track that carries a job's phases
PHASE_TRACK = "job"

# the profiler a kernel called on this thread records its spans in
_current = threading.local()


@dataclass
class Interval:
    name: str
    start: float
    end: float
    thread: str
    args: Optional[Dict[str, Any]] = None


class Profiler:
    """Low-overhead interval/counter recorder; one instance per process,
    safe for concurrent threads (append-only per-thread lists).

    `level` filters recording like the reference's profiler_level
    (rpc.proto:270-275): spans declare a detail level (0 = coarse stage
    spans, 1 = per-task detail, 2 = verbose) and only spans at or below
    the active level are kept.  `max_intervals` bounds memory for
    long-running jobs — overflow increments the `profiler_dropped`
    counter instead of growing without limit (the reference streams to
    per-thread binary files; here the master ships profiles over RPC, so
    a hard cap is the honest contract)."""

    def __init__(self, node: str = "0", base_time: Optional[float] = None,
                 level: int = 1, max_intervals: int = 200_000):
        self.node = node
        self.base_time = base_time if base_time is not None else time.time()
        self.level = level
        self.max_intervals = max_intervals
        self._local = threading.local()
        self._all_lists: List[List[Interval]] = []
        self._phases: List[Interval] = []
        self._counters: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        # torch.profiler captures recorded around jobs at level >= 2
        # ({"path": trace_file, "t0", "t1"}; util/torchprof.py)
        self.device_traces: List[Dict[str, Any]] = []

    def _list(self) -> List[Interval]:
        lst = getattr(self._local, "intervals", None)
        if lst is None:
            lst = []
            self._local.intervals = lst
            with self._lock:
                self._all_lists.append(lst)
        return lst

    def _room(self) -> bool:
        # approximate (per-thread lists are append-only; len is O(1))
        if sum(len(lst) for lst in self._all_lists) < self.max_intervals:
            return True
        self.count("profiler_dropped")
        return False

    def span(self, name: str, level: int = 1, **args):
        if level > self.level:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def add_interval(self, name: str, start: float, end: float,
                     level: int = 1, **args) -> None:
        if level > self.level or not self._room():
            return
        self._list().append(Interval(
            name, start, end, threading.current_thread().name, args or None))

    def add_phase(self, name: str, start: float, end: float,
                  **args) -> None:
        """Record a job phase timed by the caller, at every level.  It
        also lands in the flight recorder as a child of the current
        trace context (the job's root span), like a span would."""
        iv = Interval(name, start, end, threading.current_thread().name,
                      args or None)
        with self._lock:
            self._phases.append(iv)
        _tracing.record_interval(name, start, end, args or None)

    def phases(self) -> List[Interval]:
        with self._lock:
            return sorted(self._phases, key=lambda iv: iv.start)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n
        _M_EVENTS.labels(event=name).inc(n)

    def intervals(self) -> List[Interval]:
        with self._lock:
            out: List[Interval] = []
            for lst in self._all_lists:
                out.extend(lst)
        return sorted(out, key=lambda iv: iv.start)

    @property
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    # -- serialization (profiles travel from workers to the master) --------

    def to_dict(self) -> dict:
        return {
            "node": self.node,
            "base_time": self.base_time,
            "level": self.level,
            "max_intervals": self.max_intervals,
            "counters": self.counters,
            "device_traces": list(self.device_traces),
            "intervals": [_iv_dict(iv) for iv in self.intervals()],
            "phases": [_iv_dict(iv) for iv in self.phases()],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Profiler":
        # level/max_intervals must survive the round-trip: a merged
        # worker profile re-filtered or re-capped on the master would
        # silently drop spans the worker already admitted (older
        # serializations lack the keys; keep their recording intact)
        p = cls(node=d["node"], base_time=d["base_time"],
                level=int(d.get("level", 99)),
                max_intervals=int(d.get("max_intervals", 2 ** 63 - 1)))
        p._list().extend(_iv_from(iv) for iv in d["intervals"])
        p._phases.extend(_iv_from(iv) for iv in d.get("phases", []))
        for k, v in d["counters"].items():
            p._counters[k] = v
        p.device_traces = list(d.get("device_traces", []))
        return p


def _iv_dict(iv: Interval) -> dict:
    return {"name": iv.name, "start": iv.start, "end": iv.end,
            "thread": iv.thread, "args": iv.args}


def _iv_from(d: dict) -> Interval:
    return Interval(d["name"], d["start"], d["end"], d["thread"],
                    d.get("args"))


class _NullSpan:
    """Span filtered out by the active profiler level."""

    __slots__ = ()

    def __enter__(self):
        return self

    def set_args(self, **args) -> None:
        pass

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("prof", "name", "args", "start", "_trace")

    def __init__(self, prof: Profiler, name: str, args):
        self.prof = prof
        self.name = name
        self.args = args

    def __enter__(self):
        self.start = time.time()
        # hot paths are instrumented ONCE: when a trace context is
        # active on this thread (util/tracing.py), the same with-block
        # also records a distributed-trace span — the stage/op timings
        # in the flight recorder and the profile can never disagree
        self._trace = _tracing.begin_interval(self.name, self.args) \
            if _tracing.enabled() else None
        return self

    def set_args(self, **args) -> None:
        """Add args known only once the span's work is done (bytes
        read, say); they reach the flight recorder's span too."""
        self.args = {**(self.args or {}), **args}
        if self._trace is not None:
            span = self._trace[1]
            span.attrs = {**(span.attrs or {}), **args}

    def __exit__(self, exc_type, exc, tb):
        if self.prof._room():
            self.prof._list().append(Interval(
                self.name, self.start, time.time(),
                threading.current_thread().name, self.args))
        if self._trace is not None:
            _tracing.end_interval(self._trace, exc)
        return False


@contextlib.contextmanager
def recording_into(prof: Optional["Profiler"]):
    """Make `prof` this thread's current profiler inside the block."""
    prev = getattr(_current, "prof", None)
    _current.prof = prof
    try:
        yield prof
    finally:
        _current.prof = prev


def span(name: str, level: int = 1, **args):
    """A span in this thread's current profiler (`recording_into`), or
    one that records nothing when there is none."""
    prof = getattr(_current, "prof", None)
    return _NULL_SPAN if prof is None else prof.span(name, level, **args)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of this thread's current profiler
    (`recording_into`); nothing when there is none."""
    prof = getattr(_current, "prof", None)
    if prof is not None:
        prof.count(name, n)


class Profile:
    """Aggregated job profile (reference scannerpy/profiler.py Profile)."""

    def __init__(self, profilers: List[Profiler]):
        self.profilers = profilers

    def write_trace(self, path: str, merge_device: bool = True) -> None:
        """Emit Chrome trace JSON (chrome://tracing, perfetto).

        Device traces captured at profiler_level >= 2 (util/torchprof.py)
        are merged into the same file — host stage spans and the card's
        kernel timeline in one view — unless merge_device=False or the
        trace file is not readable from this host."""
        events = []
        pids = {}
        for p in self.profilers:
            pid = pids.setdefault(p.node, len(pids) + 1)
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "args": {"name": f"node {p.node}"}})
            tids: Dict[str, int] = {}
            # the job's phases on a track of their own
            tracked = [(iv, iv.thread) for iv in p.intervals()] \
                + [(iv, PHASE_TRACK) for iv in p.phases()]
            for iv, track in tracked:
                tid = tids.setdefault(track, len(tids) + 1)
                ev = {"name": iv.name, "ph": "X", "pid": pid, "tid": tid,
                      "ts": iv.start * 1e6, "dur": (iv.end - iv.start) * 1e6}
                if iv.args:
                    ev["args"] = {k: str(v) for k, v in iv.args.items()}
                events.append(ev)
            for thread, tid in tids.items():
                events.append({"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": tid, "args": {"name": thread}})
        if merge_device:
            from .torchprof import DEVICE_PID_BASE, load_device_events
            base = DEVICE_PID_BASE
            for p in self.profilers:
                for rec in p.device_traces:
                    got = load_device_events(rec, pid_base=base)
                    events.extend(got)
                    if got:
                        # disjoint pid block per capture
                        base += 1000
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)

    def statistics(self) -> Dict[str, Dict[str, float]]:
        """Total/mean seconds per interval label, and per job phase,
        across all nodes."""
        totals: Dict[str, List[float]] = defaultdict(list)
        for p in self.profilers:
            for iv in p.intervals() + p.phases():
                totals[iv.name].append(iv.end - iv.start)
        out = {}
        for name, durs in sorted(totals.items()):
            out[name] = {"count": len(durs), "total_s": sum(durs),
                         "mean_s": sum(durs) / len(durs)}
        counters: Dict[str, int] = defaultdict(int)
        for p in self.profilers:
            for k, v in p.counters.items():
                counters[k] += v
        if counters:
            out["_counters"] = dict(counters)  # type: ignore[assignment]
        return out
