"""Cross-host clock synchronization (docs/observability.md §Cross-host
time).

A gang's merged trace interleaves spans stamped by N unsynchronized
wall clocks: two hosts whose clocks disagree by 80 ms render a barrier
that "ends before it starts".  This module estimates each worker's
clock offset relative to the master with the classic NTP four-timestamp
exchange, piggybacked on the heartbeat RPC the worker already sends
every second — no new control-plane traffic:

    worker stamps t0 just before the Heartbeat call
    master stamps t1 on arrival and t2 when it builds the reply
    worker stamps t3 on receipt

    offset = ((t1 - t0) + (t2 - t3)) / 2     # master_time - worker_time
    rtt    = (t3 - t0) - (t2 - t1)

The offset estimate assumes symmetric network delay; the error from
asymmetry is bounded by rtt/2, so the estimator keeps only the K
lowest-RTT samples from a sliding window (low-RTT exchanges are the
least likely to have been queued asymmetrically) and EWMA-smooths the
offset over them.  The published uncertainty is max(rtt_best/2,
offset spread across the kept samples) — an honest bound, not a
variance estimate.

Consumers:
  * the master publishes `scanner_tpu_clock_offset_seconds{node}` /
    `scanner_tpu_clock_offset_uncertainty_seconds{node}` gauges from
    the estimate each worker advertises on its next heartbeat;
  * every ShipSpans/FinishedWork span batch carries the shipping
    worker's contemporaneous estimate, so trace assembly
    (engine/service.py GetTrace) can rebase remote span timestamps
    onto master time (`rebase_spans` below) — unless the uncertainty
    exceeds `rebase_max_uncertainty_s`, in which case the raw
    timestamps are kept (a wrong correction is worse than none);
  * the master's barrier-skew histogram corrects member arrival
    timestamps with these offsets before computing max-min.

Knobs: env `SCANNER_TPU_CLOCKSYNC` (0 disables estimation; wins over
config), `[trace] clocksync_enabled`, `[trace] rebase_clocks` (default
on; `--raw-clocks` on the CLI / `raw_clocks=True` on GetTrace is the
per-call escape hatch).
"""

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from . import metrics as _mx

# [trace] keys owned by this module (scanner-check SC314 cross-checks
# these against config.py's [trace] section and docs/guide.md rows)
CONFIG_KEYS = ("clocksync_enabled", "rebase_clocks")

# series owned by this module (SC314 cross-checks registrations and the
# observability.md clocksync-series marker table against this tuple)
CLOCKSYNC_SERIES = (
    "scanner_tpu_clock_offset_seconds",
    "scanner_tpu_clock_offset_uncertainty_seconds",
)

_G_OFFSET = _mx.registry().gauge(
    "scanner_tpu_clock_offset_seconds",
    "Estimated clock offset of a worker vs the master "
    "(master_time - worker_time), from the NTP-style heartbeat "
    "exchange", labels=["node"])
_G_UNCERT = _mx.registry().gauge(
    "scanner_tpu_clock_offset_uncertainty_seconds",
    "Uncertainty bound on the worker clock-offset estimate "
    "(max of best-RTT/2 and kept-sample spread)", labels=["node"])

# estimation on/off: env wins over config (mirrors SCANNER_TPU_TRACING)
_env = os.environ.get("SCANNER_TPU_CLOCKSYNC")
_ENABLED = _env != "0" if _env is not None else True

# rebase-at-read-time default (GetTrace); per-call raw_clocks overrides
_REBASE = True

# above this uncertainty a rebase would smear spans by more than it
# aligns them — trace assembly falls back to raw timestamps per node
REBASE_MAX_UNCERTAINTY_S = 0.25


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def rebase_enabled() -> bool:
    return _REBASE


def set_rebase_enabled(on: bool) -> None:
    global _REBASE
    _REBASE = bool(on)


class OffsetEstimator:
    """Per-peer NTP offset estimator over piggybacked heartbeat stamps.

    Keeps a sliding window of (offset, rtt) samples, selects the K
    lowest-RTT ones, and EWMA-smooths the offset over them.  A step
    change in the peer clock (VM migration, ntpd slew) flushes the
    window once the new samples disagree with the old estimate by more
    than the uncertainty bound, so convergence after a step is one
    window, not one EWMA half-life.
    """

    WINDOW = 32          # sliding window of recent exchanges
    KEEP = 8             # K lowest-RTT samples the estimate uses
    ALPHA = 0.25         # EWMA weight of the newest best-K mean

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: List[Tuple[float, float]] = []  # (offset, rtt)
        self._offset: Optional[float] = None
        self._uncertainty: Optional[float] = None
        self._at: float = 0.0

    def add_sample(self, t0: float, t1: float, t2: float,
                   t3: float) -> None:
        rtt = (t3 - t0) - (t2 - t1)
        if rtt < 0:
            return            # non-causal stamps: clock stepped mid-RPC
        offset = ((t1 - t0) + (t2 - t3)) / 2.0
        with self._lock:
            # step-change detection: if the new sample disagrees with
            # the converged estimate by far more than the bound, the
            # peer clock moved — restart from the new regime instead of
            # EWMA-dragging through stale samples for a whole window
            if (self._offset is not None
                    and self._uncertainty is not None
                    and abs(offset - self._offset)
                    > 4 * max(self._uncertainty, rtt / 2.0, 1e-4)):
                self._samples = []
                self._offset = None
                self._uncertainty = None
            self._samples.append((offset, rtt))
            if len(self._samples) > self.WINDOW:
                self._samples = self._samples[-self.WINDOW:]
            best = sorted(self._samples, key=lambda s: s[1])[:self.KEEP]
            mean = sum(o for o, _ in best) / len(best)
            spread = max(o for o, _ in best) - min(o for o, _ in best) \
                if len(best) > 1 else 0.0
            # asymmetry error bound: half the best (smallest) RTT kept
            bound = max(best[0][1] / 2.0, spread)
            if self._offset is None:
                self._offset = mean
            else:
                self._offset += self.ALPHA * (mean - self._offset)
            self._uncertainty = bound
            self._at = t3

    def estimate(self) -> Optional[dict]:
        """{"offset", "uncertainty", "at"} or None before any sample."""
        with self._lock:
            if self._offset is None:
                return None
            return {"offset": self._offset,
                    "uncertainty": self._uncertainty,
                    "at": self._at}


def publish(node: str, est: Optional[dict]) -> None:
    """Publish a worker's advertised estimate as the two gauges (called
    on the master, which is the scrape point for cluster metrics)."""
    if not est:
        return
    _G_OFFSET.labels(node=node).set(float(est.get("offset", 0.0)))
    _G_UNCERT.labels(node=node).set(
        float(est.get("uncertainty", 0.0)))


def unpublish(node: str) -> None:
    """Drop a departed node's gauge children.  Worker ids are never
    reused, so a stale offset sample would sit in every scrape of a
    long-lived master — and in an embedding process that outlives the
    master (test suites), the node-labeled children would leak into a
    later owner's view of the shared registry."""
    _G_OFFSET.remove_labels(node=node)
    _G_UNCERT.remove_labels(node=node)


def should_rebase(est: Optional[dict],
                  max_uncertainty_s: Optional[float] = None) -> bool:
    """True when an estimate is trustworthy enough to correct spans
    with: present, and uncertainty within the alignment threshold."""
    if not est:
        return False
    limit = REBASE_MAX_UNCERTAINTY_S if max_uncertainty_s is None \
        else max_uncertainty_s
    try:
        return float(est.get("uncertainty", float("inf"))) <= limit
    except (TypeError, ValueError):
        return False


def rebase_spans(span_dicts: Sequence[dict],
                 offsets: Dict[str, dict],
                 max_uncertainty_s: Optional[float] = None) -> list:
    """Return copies of span dicts with start/end (and event "t"
    stamps) shifted onto master time by each span's node offset.

    `offsets` maps node -> {"offset", "uncertainty", "at"}.  Nodes
    without a trustworthy estimate (missing, or uncertainty above the
    threshold) keep raw timestamps; the caller reports which nodes were
    corrected.  Durations are offset-invariant, so per-stage stats
    computed from raw spans stay valid.
    """
    out = []
    for d in span_dicts:
        est = offsets.get(d.get("node"))
        if not should_rebase(est, max_uncertainty_s):
            out.append(d)
            continue
        off = float(est["offset"])
        c = dict(d)
        if c.get("start") is not None:
            c["start"] = c["start"] + off
        if c.get("end") is not None:
            c["end"] = c["end"] + off
        if c.get("events"):
            c["events"] = [dict(ev, t=ev["t"] + off) if "t" in ev
                           else dict(ev) for ev in c["events"]]
        c["clock_rebased"] = True
        out.append(c)
    return out
