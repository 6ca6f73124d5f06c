"""The traced run's device timeline: torch.profiler over a slice of the
window, read back onto the host clock.

The capture opens with a marker (`ANCHOR`) taken at a host time read
inside it, as `scanner_tpu_torch/util/torchprof.py` aligns its
captures; every event is shifted so that the marker lands on that host
time, so the device's events and the program's spans (which use
`time.time()`) share one clock.  Device activity is every kernel, copy
and memset on the card; the card is idle where none runs.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

ANCHOR = "benchmark_trace_t0"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
Span = Tuple[float, float]


@dataclass
class DeviceTrace:
    """What the traced slice held, in host-clock seconds."""
    t0: float
    t1: float
    events: List[Tuple[float, float, str]]   # device (start, end, name)
    busy: List[Span] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for s, e, name in self.events:
            out[name] += e - s
        return dict(out)

    def idle_gaps(self) -> List[Span]:
        gaps, at = [], self.t0
        for s, e in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps


def union(spans: Sequence[Span], lo: float, hi: float) -> List[Span]:
    """The spans clipped to [lo, hi] and merged where they overlap."""
    out: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Capture:
    """torch.profiler around part of a window: start() and stop() in
    it, read() once it has closed (None where the profiler gave no
    trace)."""

    def __init__(self, workdir: str):
        self.path = os.path.join(workdir, "device_trace.json")
        self.result: Optional[DeviceTrace] = None
        self._prof = None
        self.t0 = self.t1 = None

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """One empty session: the profiler's first start loads and sets
        up its tracer (seconds), which belongs to set-up, not to the
        window."""
        from torch.profiler import record_function
        with self._profile():
            with record_function(ANCHOR + "_warm"):
                pass

    def start(self) -> None:
        import torch
        from torch.profiler import record_function
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof = self._profile()
        self._prof.__enter__()
        # the first marker of a session pays the profiler's lazy set-up
        with record_function(ANCHOR + "_warm"):
            pass
        with record_function(ANCHOR):
            self.t0 = time.time()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.time()
        self._prof.__exit__(None, None, None)

    def read(self) -> Optional[DeviceTrace]:
        """Export and read the capture (after the window has closed)."""
        if self._prof is None:
            return None
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self.result = read_chrome_trace(self.path, self.t0, self.t1)
        os.unlink(self.path)
        return self.result


def read_chrome_trace(path: str, t0: float, t1: float
                      ) -> Optional[DeviceTrace]:
    """The device events of an exported trace on the host clock, the
    marker ANCHOR at t0; None when the marker is missing."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents", [])
    anchor = [e for e in evs if e.get("name") == ANCHOR and "ts" in e]
    if not anchor:
        return None
    shift = t0 - float(anchor[0]["ts"]) / 1e6
    dev = []
    for e in evs:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            s = float(e["ts"]) / 1e6 + shift
            dev.append((s, s + float(e.get("dur", 0.0)) / 1e6,
                        str(e.get("name", "?"))))
    tr = DeviceTrace(t0, t1, dev)
    tr.busy = union([(s, e) for s, e, _ in dev], t0, t1)
    return tr


def label_gaps(gaps: Sequence[Span],
               spans: Sequence[Tuple[float, float, str]],
               outside: str, around: str = "") -> Dict[str, float]:
    """Idle seconds by what the host was doing: each gap is cut at the
    host spans' edges, and each piece is named by the spans open over
    it (their names sorted and joined with '+'; `around`, a span that
    holds the others, only where no other is open), or `outside` where
    none is."""
    edges = sorted({t for s, e, _ in spans for t in (s, e)})
    # the name of each piece between two neighbouring edges
    names = []
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2
        open_ = sorted({n for s, e, n in spans if s <= mid < e})
        if len(open_) > 1 and around in open_:
            open_.remove(around)
        names.append("+".join(open_) if open_ else outside)
    out: Dict[str, float] = defaultdict(float)
    for gs, ge in gaps:
        # the gap's own cuts: its ends and the edges inside it
        lo, hi = bisect.bisect_right(edges, gs), bisect.bisect_left(edges, ge)
        cuts = [gs] + edges[lo:hi] + [ge]
        for k, (a, b) in enumerate(zip(cuts, cuts[1:])):
            piece = lo - 1 + k       # the edge interval [a, b] lies in
            inside = 0 <= piece < len(names)
            out[names[piece] if inside else outside] += b - a
    return dict(out)


def top(seconds: Dict[str, float], n: int = 10,
        width: int = 160) -> List[List]:
    """The n largest entries as [name, seconds], names cut to `width`."""
    return [[k[:width], v] for k, v in
            sorted(seconds.items(), key=lambda kv: -kv[1])[:n]]
