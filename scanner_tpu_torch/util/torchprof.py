"""Device-side trace capture for the engine profiler (torch.profiler).

The counterpart of the JAX package's ``scanner_tpu/util/jaxprof.py``:
the host profiler records interval spans, and the device's own timeline
— kernel execution, host<->device copies, the CPU operators that
launched them — must be seen beside them, or claims like "the copy
rides under decode" stay inferences from wall clocks.  At
``profiler_level >= 2`` the engine wraps a job's execution in a
``torch.profiler.profile`` session (the CPU activity, and the CUDA
activity where a card is present), exports it as Chrome-trace JSON and
records the file on the host profiler; ``Profile.write_trace`` then
merges the device timeline into the same Chrome-trace JSON so host stage
spans and kernels land in ONE perfetto view.

Alignment: torch.profiler's ``ts`` values are microseconds on the
profiler's own clock, whose base is not the host wall clock.  The
capture therefore opens with a ``record_function`` marker (``ANCHOR``)
taken at the host's ``t0``; loading shifts every event so that the
marker lands on ``t0``.  Device processes are renumbered into a
distinct pid range (``DEVICE_PID_BASE``) so they never collide with the
host profiler's node pids.

torch allows one active profiler per process; concurrent jobs (several
in-process executors in tests) serialize on a module lock — the first
job gets the device trace, the rest run untraced rather than erroring.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

_log = logging.getLogger("scanner_tpu_torch.torchprof")

# one active torch.profiler session per process
_ACTIVE = threading.Lock()

# Trace dumps run to tens of MB; auto-created dirs (no explicit out_dir)
# are deleted when this process exits so a long session of level-2 jobs
# cannot fill the temp dir.  Callers who want to keep a capture pass
# out_dir.
_AUTO_DIRS: List[str] = []


def _cleanup_auto_dirs() -> None:
    for d in _AUTO_DIRS:
        shutil.rmtree(d, ignore_errors=True)


atexit.register(_cleanup_auto_dirs)

# pid offset for merged device processes (host profiler pids are 1..N)
DEVICE_PID_BASE = 1000
# the record_function marker opened at the host's t0 (alignment anchor)
ANCHOR = "scanner_tpu_devtrace_t0"
# embed_device_events keeps at most this many events of one capture
_MAX_EVENTS = 200000


@contextlib.contextmanager
def device_trace(profiler, out_dir: Optional[str] = None):
    """Capture the torch.profiler trace around a job when the profiler
    runs at level >= 2; no-op otherwise (and on any profiler failure — a
    broken tracer must never take down the job).  Appends
    ``{"path", "t0", "t1"}`` to ``profiler.device_traces``."""
    if getattr(profiler, "level", 1) < 2:
        yield
        return
    if not _ACTIVE.acquire(blocking=False):
        _log.info("device trace already active in this process; "
                  "running untraced")
        yield
        return
    try:
        trace_dir = None
        auto = out_dir is None
        try:
            import torch
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            trace_dir = out_dir or tempfile.mkdtemp(prefix="sc_devtrace_")
            if auto:
                _AUTO_DIRS.append(trace_dir)
            prof = profile(activities=acts,
                           experimental_config=_all_threads_config())
            prof.__enter__()
            # the first marker of a session pays the profiler's lazy
            # set-up (about a millisecond between its timestamp and the
            # host clock read); the anchor is the second, within tens of
            # microseconds of t0
            with record_function(ANCHOR + "_warm"):
                pass
            with record_function(ANCHOR):
                t0 = time.time()
        except Exception as e:  # noqa: BLE001
            _log.warning("torch.profiler start failed: %s", e)
            yield
            return
        try:
            yield
        finally:
            try:
                prof.__exit__(None, None, None)
                # t0/t1 bound the capture window on the host wall clock;
                # consumers align against THIS window, not the host
                # profiler's first span
                t1 = time.time()
                path = os.path.join(trace_dir,
                                    f"device_trace_{int(t0 * 1e6)}.json")
                prof.export_chrome_trace(path)
                profiler.device_traces.append(
                    {"path": path, "t0": t0, "t1": t1})
            except Exception as e:  # noqa: BLE001
                _log.warning("torch.profiler stop/export failed: %s", e)
    finally:
        _ACTIVE.release()


def _all_threads_config():
    """Record the operators of every thread — the job's loaders and
    evaluators run on threads of their own — where this torch has the
    option (a card's kernels are recorded device-wide either way)."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def _is_python(ev: Dict[str, Any]) -> bool:
    return ev.get("cat") == "python_function"


def _read_raw_events(rec: Dict[str, Any],
                     include_python: bool = False) -> List[Dict[str, Any]]:
    """Unshifted device-trace events for one capture record: the
    embedded ``events`` list when present (a profile that crossed
    hosts), else read from the local trace file."""
    if "events" in rec:
        return rec["events"]
    try:
        with open(rec["path"]) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        _log.warning("unreadable device trace %s: %s", rec.get("path"), e)
        return []
    return [ev for ev in doc.get("traceEvents", [])
            if include_python or not _is_python(ev)]


def embed_device_events(rec: Dict[str, Any],
                        max_events: Optional[int] = None
                        ) -> Dict[str, Any]:
    """Serialize the capture's device events INTO the record (mutates
    and returns it) so the profile survives crossing hosts.  Bounded by
    `max_events` (default _MAX_EVENTS, longest-first truncation recorded
    in ``events_dropped``)."""
    if "events" in rec:
        return rec
    evs = _read_raw_events(rec)
    cap = _MAX_EVENTS if max_events is None else max_events
    # Chrome 'M' metadata (process/thread names) and the alignment
    # anchor are exempt from the cap: without them the lanes render as
    # bare numbers and nothing can be aligned
    keep = [e for e in evs if e.get("ph") == "M" or e.get("name") == ANCHOR]
    rest = [e for e in evs
            if e.get("ph") != "M" and e.get("name") != ANCHOR]
    if len(rest) > cap:
        # keep the longest slices: truncation should cost the noise
        # floor, not the dominant kernels
        rest.sort(key=lambda e: -float(e.get("dur", 0.0) or 0.0))
        rec["events_dropped"] = len(rest) - cap
        rest = rest[:cap]
    rec["events"] = keep + rest
    return rec


def load_device_events(rec: Dict[str, Any],
                       pid_base: int = DEVICE_PID_BASE,
                       include_python: bool = False
                       ) -> List[Dict[str, Any]]:
    """Load one recorded device trace as Chrome trace events, shifted to
    the host wall clock (the ``ANCHOR`` marker lands on ``rec["t0"]``)
    and renumbered into the pid block starting at `pid_base` (one pid
    per process of the capture, in order of first appearance: the CPU
    process, then each card).

    ``rec`` is a ``{"path": ..., "t0": ...}`` entry from
    ``Profiler.device_traces``; records that crossed hosts carry their
    events inline (``embed_device_events``).  Returns [] when neither
    embedded events nor a readable local file exist, or when the capture
    lacks its anchor (it cannot be aligned)."""
    raw = _read_raw_events(rec, include_python=include_python)
    anchor = next((ev for ev in raw if ev.get("name") == ANCHOR
                   and ev.get("ph") == "X"), None)
    if anchor is None:
        if raw:
            _log.warning("device trace %s has no %s marker; not merged",
                         rec.get("path"), ANCHOR)
        return []
    shift_us = rec["t0"] * 1e6 - float(anchor["ts"])
    pids: Dict[Any, int] = {}
    out: List[Dict[str, Any]] = []
    for ev in raw:
        if not include_python and _is_python(ev):
            continue
        ev = dict(ev)
        if "pid" in ev:
            ev["pid"] = pids.setdefault(ev["pid"], pid_base + len(pids))
        if "ts" in ev and ev.get("ph") != "M":
            ev["ts"] = float(ev["ts"]) + shift_us
        out.append(ev)
    return out
