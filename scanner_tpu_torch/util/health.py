"""Health & SLO engine: declarative alert rules over live metrics.

The port of the JAX package's ``scanner_tpu/util/health.py``, rule for
rule: the metrics registry (util/metrics.py) records and memstats
(util/memstats.py) accounts; this module renders the judgment — a stage
is backpressured, a card is saturated or near its memory limit, task
latency is burning its budget.

  * **Rules** are declarative: (series selector, window, predicate) over
    the in-process ``MetricsRegistry``, supporting threshold (``value``,
    with ``ratio_to`` for ratios), rate-of-change (``rate``),
    histogram-quantile (``p50``/``p90``/``p99``, estimated from bucket
    counts via ``metrics.histogram_quantile``), multi-window burn-rate
    (``burn``) and the composite ``backpressure`` form (queue-depth
    watermark + producer/consumer fps imbalance).
  * A built-in **default ruleset** (``DEFAULT_RULES``, the same names as
    the JAX package's) covers stage backpressure, worker liveness,
    per-device saturation and HBM pressure, task-latency SLO burn, and
    recompile storms; user rules ride in through ``configure`` in the
    ``[alerts]`` clause grammar (``parse_rules``).
  * **Firing/resolving alerts are first-class**: counted as
    ``scanner_tpu_alerts_firing`` / ``scanner_tpu_alerts_transitions_total``,
    recorded as instants on the tracing flight recorder, served on the
    ``/alertz`` endpoint, rolled up into the ``ok|degraded|unhealthy``
    status ``/healthz`` and ``/readyz`` report, and read by
    ``Client.health()``; transition listeners (engine/controller.py)
    act on them.

One engine per process (like the registry it reads), sampling on a
daemon thread.  ``SCANNER_TPU_HEALTH=0`` disables it and
``SCANNER_TPU_HEALTH_INTERVAL`` sets its sampling period in seconds.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

from ..common import ScannerException
from . import metrics as _mx
from . import tracing as _tr
from .log import get_logger

_log = get_logger("health")

# alert-state telemetry: the
# gauge holds how many instances of each rule fire right now; the
# counter records every state transition so dashboards can rate() on
# flappiness even between scrapes
_M_FIRING = _mx.registry().gauge(
    "scanner_tpu_alerts_firing",
    "Alert instances currently firing per rule (health engine; 0 = "
    "the rule is quiet).",
    labels=["rule", "severity"])
_M_TRANSITIONS = _mx.registry().counter(
    "scanner_tpu_alerts_transitions_total",
    "Alert state transitions (pending->firing and firing->resolved) "
    "per rule.",
    labels=["rule", "state"])

SEVERITIES = ("warning", "critical")
FORMS = ("value", "rate", "p50", "p90", "p99", "burn", "backpressure")
# clause option keys the [alerts] rules grammar accepts
RULE_OPTION_KEYS = ("window", "for", "severity", "by", "objective",
                    "budget", "short")

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

# backpressure form: the producer stage whose completion rate is
# compared against each queued stage's own
_BP_TASKS_SERIES = "scanner_tpu_stage_tasks_total"
_BP_UPSTREAM = {"evaluate": "load", "save": "evaluate"}
_BP_IMBALANCE = 1.5   # producer fps > 1.5x consumer fps counts as skew


class HealthConfigError(ScannerException):
    """Malformed [alerts] rule spec."""


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default) not in ("0", "false", "")


_ENABLED = _env_on("SCANNER_TPU_HEALTH")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """The programmatic override; the SCANNER_TPU_HEALTH env var is
    read at import."""
    global _ENABLED
    _ENABLED = bool(on)


def _env_interval() -> float:
    try:
        return max(0.05, float(os.environ.get(
            "SCANNER_TPU_HEALTH_INTERVAL", "1.0") or 1.0))
    except ValueError:
        return 1.0


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

@dataclass
class AlertRule:
    """One declarative alert: evaluate `form` over `series` (filtered by
    `match`, grouped by `by`), compare with `op value`, hold the verdict
    `for_seconds` before firing."""

    name: str
    series: str = ""
    form: str = "value"
    op: str = ">"
    value: float = 0.0
    # lookback for rate/quantile forms; the LONG window for burn
    window: float = 60.0
    # hold-down: the condition must stay true this long before firing
    for_seconds: float = 0.0
    severity: str = "warning"
    # label names each alert instance is keyed by (one alert per group)
    by: Tuple[str, ...] = ()
    # label filters applied before grouping
    match: Dict[str, str] = field(default_factory=dict)
    # value form only: divide by this series' matching group (ratios
    # like hbm_in_use / hbm_limit)
    ratio_to: str = ""
    # burn form: latency objective (seconds), allowed error-budget
    # fraction, and the SHORT window (window doubles as the long one);
    # `value` is the burn-rate multiple both windows must exceed
    objective: float = 0.0
    budget: float = 0.05
    short_window: float = 60.0
    description: str = ""

    def validate(self) -> "AlertRule":
        if not re.fullmatch(r"[a-z0-9_]+", self.name or ""):
            raise HealthConfigError(
                f"alert rule name {self.name!r} must be [a-z0-9_]+")
        if self.form not in FORMS:
            raise HealthConfigError(
                f"rule {self.name}: unknown form {self.form!r} "
                f"(known: {', '.join(FORMS)})")
        if self.op not in _OPS:
            raise HealthConfigError(
                f"rule {self.name}: unknown op {self.op!r}")
        if self.severity not in SEVERITIES:
            raise HealthConfigError(
                f"rule {self.name}: severity must be one of "
                f"{', '.join(SEVERITIES)}")
        if not self.series:
            raise HealthConfigError(f"rule {self.name}: needs a series")
        return self


# The built-in ruleset every process evaluates.  Names are a contract
# shared with the JAX package's DEFAULT_RULES.
DEFAULT_RULES = (
    AlertRule(
        name="stage_backpressure", form="backpressure",
        series="scanner_tpu_stage_queue_depth",
        op=">=", value=3.0, window=10.0, for_seconds=1.5,
        severity="warning", by=("stage",),
        description="a pipeline stage's input queue sits at its high "
                    "watermark (or its producer sustainably outruns it "
                    "with a backlog standing): the stage is the "
                    "bottleneck and upstream work is piling up"),
    AlertRule(
        name="worker_heartbeat_stale",
        series="scanner_tpu_worker_heartbeat_age_seconds",
        form="value", op=">", value=4.0, window=10.0, for_seconds=0.0,
        severity="critical", by=("worker",),
        description="a registered worker has missed several heartbeats "
                    "(master view); past WORKER_STALE_AFTER it will be "
                    "deactivated and its tasks requeued"),
    AlertRule(
        name="device_saturation",
        series="scanner_tpu_device_busy_seconds_total",
        form="rate", op=">", value=0.9, window=15.0, for_seconds=5.0,
        severity="warning", by=("device",),
        description="a chip's evaluate-stage busy fraction is ~1.0 "
                    "sustained: the device is compute-saturated (the "
                    "autoscaling up-signal, not by itself a fault)"),
    AlertRule(
        name="hbm_pressure",
        series="scanner_tpu_device_hbm_bytes_in_use",
        ratio_to="scanner_tpu_device_hbm_limit_bytes",
        form="value", op=">", value=0.92, window=10.0, for_seconds=2.0,
        severity="critical", by=("device",),
        description="allocator-reported device memory is within ~8% "
                    "of the card's limit: the next staging or dispatch "
                    "is likely to run out of memory (see the memstats "
                    "ledger for who owns the bytes)"),
    AlertRule(
        name="task_latency_slo_burn",
        series="scanner_tpu_task_latency_seconds",
        form="burn", op=">", value=2.0, objective=30.0, budget=0.05,
        short_window=60.0, window=300.0, for_seconds=0.0,
        severity="critical",
        description="end-to-end task latency is burning its error "
                    "budget (share of tasks over the objective exceeds "
                    "burn_rate x budget in BOTH the short and the long "
                    "window — sustained burn, not a transient spike)"),
    AlertRule(
        name="recompile_storm",
        series="scanner_tpu_op_recompiles_total",
        form="rate", op=">", value=0.5, window=30.0, for_seconds=5.0,
        severity="warning",
        description="kernel recompiles (library builds, CUDA graph "
                    "captures) are arriving continuously — bucketed "
                    "dispatch should bound them at one ladder per (op, "
                    "device); a sustained rate means a ragged call path "
                    "keeps minting new shapes"),
)


def default_rules() -> List[AlertRule]:
    return list(DEFAULT_RULES)


# -- [alerts] rules clause grammar ------------------------------------------
#
#   name:form(series[{label=v,...}][/ratio_series])OP VALUE[:opt=v...]
#
# clauses separated by ';'.  Example:
#   eval_hot:value(scanner_tpu_stage_queue_depth{stage=evaluate})>=8
#       :for=5:severity=critical
#   slow_rpc:p99(scanner_tpu_rpc_latency_seconds)>0.5:window=120

_EXPR_RE = re.compile(
    r"^(?P<form>" + "|".join(FORMS) + r")\("
    r"(?P<series>scanner_tpu_[a-z0-9_]+)"
    r"(?:\{(?P<match>[^}]*)\})?"
    r"(?:/(?P<ratio>scanner_tpu_[a-z0-9_]+))?"
    r"\)(?P<op>>=|<=|>|<)(?P<val>-?[0-9.]+(?:e-?[0-9]+)?)$")


def parse_rules(spec: str) -> List[AlertRule]:
    """Parse an [alerts] rules spec into AlertRules; raises
    HealthConfigError on anything malformed (a typo'd rule must fail at
    configure time, not silently alert on nothing)."""
    rules: List[AlertRule] = []
    for clause in (spec or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        if len(parts) < 2:
            raise HealthConfigError(
                f"alert clause {clause!r} needs name:expr")
        name, expr, opts = parts[0].strip(), parts[1].strip(), parts[2:]
        m = _EXPR_RE.match(expr.replace(" ", ""))
        if m is None:
            raise HealthConfigError(
                f"alert clause {name!r}: cannot parse expr {expr!r} "
                "(want form(series[{l=v}][/ratio])OP VALUE)")
        match: Dict[str, str] = {}
        for pair in (m.group("match") or "").split(","):
            pair = pair.strip()
            if not pair:
                continue
            k, sep, v = pair.partition("=")
            if not sep or not k:
                raise HealthConfigError(
                    f"alert clause {name!r}: bad label filter {pair!r}")
            match[k.strip()] = v.strip()
        rule = AlertRule(
            name=name, form=m.group("form"), series=m.group("series"),
            match=match, ratio_to=m.group("ratio") or "",
            op=m.group("op"), value=float(m.group("val")))
        if rule.form == "backpressure":
            rule.by = ("stage",)
        for opt in opts:
            k, sep, v = opt.partition("=")
            k = k.strip()
            if not sep or k not in RULE_OPTION_KEYS:
                raise HealthConfigError(
                    f"alert clause {name!r}: unknown option {opt!r} "
                    f"(known: {', '.join(RULE_OPTION_KEYS)})")
            try:
                if k == "window":
                    rule.window = float(v)
                elif k == "for":
                    rule.for_seconds = float(v)
                elif k == "severity":
                    rule.severity = v.strip()
                elif k == "by":
                    rule.by = tuple(x for x in v.split("+") if x)
                elif k == "objective":
                    rule.objective = float(v)
                elif k == "budget":
                    rule.budget = float(v)
                elif k == "short":
                    rule.short_window = float(v)
            except ValueError as e:
                raise HealthConfigError(
                    f"alert clause {name!r}: bad value for {k}: {v!r}"
                ) from e
        rules.append(rule.validate())
    return rules


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

_ROLLUP_ORDER = {"ok": 0, "degraded": 1, "unhealthy": 2}
# severity of a firing alert -> health status it degrades the roll-up to
_SEVERITY_STATUS = {"warning": "degraded", "critical": "unhealthy"}

# hard bound on retained samples regardless of window math — a
# mis-configured tiny interval with an hour-long window must not grow
# process memory without bound
_MAX_SAMPLES = 10_000


def _hist_zero(n: int) -> Dict[str, Any]:
    return {"buckets": [0] * n, "sum": 0.0, "count": 0}


class HealthEngine:
    """Evaluates a ruleset over windowed registry samples; tracks alert
    state (pending -> firing -> resolved) with hold-downs; exposes the
    ok|degraded|unhealthy roll-up.  One per process via `engine()`;
    tests build private ones over private registries and drive `tick`
    by hand."""

    def __init__(self, reg: Optional[_mx.MetricsRegistry] = None,
                 rules: Optional[Sequence[AlertRule]] = None,
                 interval: Optional[float] = None):
        self._reg = reg if reg is not None else _mx.registry()
        self._rules: List[AlertRule] = (list(rules) if rules is not None
                                        else default_rules())
        self._user_rules: List[AlertRule] = []
        self._interval = interval if interval is not None \
            else _env_interval()
        # (t, {series: snapshot-entry}) ring; only series the ruleset
        # references are retained, trimmed to the longest rule window
        self._samples: Deque[Tuple[float, Dict[str, dict]]] = deque()
        # (rule name, group key) -> {"state", "since", "fired_at",
        #                            "value", "labels"}
        self._states: Dict[Tuple[str, Tuple[str, ...]], Dict[str, Any]] = {}
        # reentrant: evaluate() holds it across rule evaluation, which
        # reads the sample ring through the same-locked accessors
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_tick = 0.0
        # alert-transition listeners: the alerts -> actuation seam
        # (ROADMAP item 5).  Called OUTSIDE the state lock with each
        # transition dict; an actuator (e.g. the frame cache's
        # hbm_pressure shrink, engine/framecache.py) reacts here
        # instead of polling the firing list.
        self._listeners: List[Callable[[dict], None]] = []
        # the flight recorder alert transitions land on (None = the
        # process default tracer; a cluster Worker routes them to its
        # own, node-labeled recorder)
        self._tracer: Optional[Any] = None

    # -- configuration ------------------------------------------------------

    def set_tracer(self, tracer: Any) -> None:
        """Route alert transition instants to a specific component's
        flight recorder (a Worker's tracer labels them with its node)."""
        self._tracer = tracer

    def set_user_rules(self, rules: Sequence[AlertRule]) -> None:
        """Replace the user (config-supplied) rules; the built-in
        defaults stay.  Alert states of rules no longer in the ruleset
        are resolved on the spot — evaluate() only visits current
        rules, so without this a removed rule's firing state would
        degrade the roll-up forever."""
        removed: List[Tuple[str, str, Dict[str, Any]]] = []
        with self._lock:
            old_sev = {r.name: r.severity for r in self._user_rules}
            self._user_rules = list(rules)
            keep = {r.name for r in self._rules} \
                | {r.name for r in self._user_rules}
            for skey in [k for k in self._states if k[0] not in keep]:
                st = self._states.pop(skey)
                if st["state"] == "firing":
                    removed.append((skey[0],
                                    old_sev.get(skey[0], "warning"),
                                    st["labels"]))
        for name, sev, labels in removed:
            _M_FIRING.labels(rule=name, severity=sev).set(0)
            _M_TRANSITIONS.labels(rule=name, state="resolved").inc()
            _log.info("alert resolved (rule removed): %s%s", name,
                      labels or "")

    def set_interval(self, seconds: float) -> None:
        self._interval = max(0.05, float(seconds))

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        """Register an alert-transition actuator (idempotent per
        function object).  `fn` receives each transition dict
        ({"state", "rule", "severity", "labels", "value"}) after the
        metric/tracer side effects, outside the engine lock; exceptions
        are swallowed (a broken actuator must not kill alerting)."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def rules(self) -> List[AlertRule]:
        with self._lock:
            return list(self._rules) + list(self._user_rules)

    # -- sampling -----------------------------------------------------------

    def _needed_series(self, rules: Sequence[AlertRule]) -> set:
        need = set()
        for r in rules:
            need.add(r.series)
            if r.ratio_to:
                need.add(r.ratio_to)
            if r.form == "backpressure":
                need.add(_BP_TASKS_SERIES)
        return need

    def _max_window(self, rules: Sequence[AlertRule]) -> float:
        w = 30.0
        for r in rules:
            w = max(w, r.window, r.short_window if r.form == "burn"
                    else 0.0)
        return w

    def sample(self, now: Optional[float] = None) -> None:
        """Record one observation of every rule-referenced series."""
        now = now if now is not None else time.time()
        rules = self.rules()
        need = self._needed_series(rules)
        snap = self._reg.snapshot()
        data = {name: snap[name] for name in need if name in snap}
        keep_after = now - (self._max_window(rules)
                            + 5 * self._interval + 5.0)
        with self._lock:
            self._samples.append((now, data))
            while self._samples and (
                    self._samples[0][0] < keep_after
                    or len(self._samples) > _MAX_SAMPLES):
                self._samples.popleft()

    # -- windowed series access (callers hold no locks; samples are
    # snapshots, append-only per tick) --------------------------------------

    def _latest(self) -> Optional[Tuple[float, Dict[str, dict]]]:
        with self._lock:
            return self._samples[-1] if self._samples else None

    def _at_or_before(self, t: float) \
            -> Optional[Tuple[float, Dict[str, dict]]]:
        """Newest sample taken at or before `t`; the oldest retained one
        when the window predates the history (rates then cover the
        actually-observed span)."""
        with self._lock:
            best = None
            for ts, data in self._samples:
                if ts <= t:
                    best = (ts, data)
                else:
                    break
            if best is None and self._samples:
                best = self._samples[0]
            return best

    @staticmethod
    def _groups(entry: Optional[dict], match: Dict[str, str],
                by: Tuple[str, ...]) -> Dict[Tuple[str, ...], Any]:
        """Aggregate a series entry's samples into by-label groups:
        scalars sum; histograms merge buckets/sum/count."""
        out: Dict[Tuple[str, ...], Any] = {}
        if not entry:
            return out
        is_hist = entry.get("kind") == "histogram"
        n_b = len(entry.get("uppers") or ()) + 1
        for s in entry.get("samples", []):
            lbls = s.get("labels") or {}
            if any(lbls.get(k) != v for k, v in match.items()):
                continue
            key = tuple(str(lbls.get(b, "")) for b in by)
            if is_hist:
                acc = out.setdefault(key, _hist_zero(n_b))
                for i, b in enumerate(s.get("buckets") or ()):
                    if i < n_b:
                        acc["buckets"][i] += b
                acc["sum"] += s.get("sum", 0.0)
                acc["count"] += s.get("count", 0)
            else:
                out[key] = out.get(key, 0.0) + float(s.get("value", 0.0))
        return out

    def _series_groups(self, sample, series: str, rule: AlertRule
                       ) -> Dict[Tuple[str, ...], Any]:
        return self._groups(sample[1].get(series), rule.match, rule.by)

    # -- rule forms ---------------------------------------------------------

    def _eval_value(self, rule: AlertRule, now_s) \
            -> Dict[Tuple[str, ...], float]:
        groups = self._series_groups(now_s, rule.series, rule)
        if not rule.ratio_to:
            return groups
        denom = self._series_groups(now_s, rule.ratio_to, rule)
        out = {}
        for key, num in groups.items():
            d = denom.get(key)
            if d:
                out[key] = num / d
        return out

    def _eval_rate(self, rule: AlertRule, now_s, then_s) \
            -> Dict[Tuple[str, ...], float]:
        if then_s is None:
            return {}
        dt = now_s[0] - then_s[0]
        if dt < max(0.5, self._interval / 2):
            return {}
        cur = self._series_groups(now_s, rule.series, rule)
        old = self._series_groups(then_s, rule.series, rule)
        return {key: max(v - old.get(key, 0.0), 0.0) / dt
                for key, v in cur.items()}

    def _eval_quantile(self, rule: AlertRule, q: float, now_s, then_s) \
            -> Dict[Tuple[str, ...], float]:
        """Quantile over the observations that arrived inside the
        window (bucket deltas); cumulative-since-start when the history
        is younger than the window."""
        entry = now_s[1].get(rule.series)
        if not entry or entry.get("kind") != "histogram":
            return {}
        uppers = list(entry.get("uppers") or ())
        cur = self._series_groups(now_s, rule.series, rule)
        old = self._series_groups(then_s, rule.series, rule) \
            if then_s is not None else {}
        out = {}
        for key, h in cur.items():
            o = old.get(key)
            buckets = [b - (o["buckets"][i] if o else 0)
                       for i, b in enumerate(h["buckets"])]
            v = _mx.histogram_quantile(uppers, buckets, q)
            if v is not None:
                out[key] = v
        return out

    @staticmethod
    def _count_over(uppers: Sequence[float], buckets: Sequence[float],
                    objective: float) -> float:
        """Observations above `objective`, interpolating inside the
        bucket that straddles it (same estimate histogram_quantile
        makes, inverted)."""
        total = float(sum(buckets))
        if total <= 0:
            return 0.0
        below = 0.0
        lo = 0.0
        for i, upper in enumerate(uppers):
            c = float(buckets[i])
            if upper <= objective:
                below += c
                lo = upper
                continue
            if lo < objective:
                span = upper - lo
                if span > 0:
                    below += c * (objective - lo) / span
            break
        return max(total - below, 0.0)

    def _eval_burn(self, rule: AlertRule, now, now_s) \
            -> Dict[Tuple[str, ...], float]:
        """Multi-window burn-rate: the share of observations over the
        latency objective, in BOTH the short and the long window, must
        exceed `value` x `budget` — the short window triggers fast, the
        long window keeps one spike from paging.  Returned value is the
        short-window burn multiple (error_frac / budget)."""
        entry = now_s[1].get(rule.series)
        if not entry or entry.get("kind") != "histogram":
            return {}
        uppers = list(entry.get("uppers") or ())
        out = {}
        cur = self._series_groups(now_s, rule.series, rule)
        windows = (rule.short_window, rule.window)
        for key, h in cur.items():
            burns = []
            for w in windows:
                then_s = self._at_or_before(now - w)
                if then_s is None \
                        or then_s[0] > now - w + 2 * self._interval:
                    # the history doesn't actually span this window
                    # (young engine: _at_or_before fell back to the
                    # oldest sample).  Without the check, both burn
                    # windows would collapse onto the same short
                    # delta and a transient spike would page as a
                    # "sustained" burn — exactly what the long
                    # window exists to veto.
                    burns = None
                    break
                o = self._series_groups(then_s, rule.series, rule) \
                    .get(key)
                buckets = [b - (o["buckets"][i] if o else 0)
                           for i, b in enumerate(h["buckets"])]
                n = sum(buckets)
                if n <= 0:
                    burns = None   # no traffic in this window: no burn
                    break
                frac = self._count_over(uppers, buckets, rule.objective) / n
                burns.append(frac / rule.budget if rule.budget > 0
                             else 0.0)
            if burns is not None:
                # fires only when every window exceeds the multiple;
                # report the short-window burn (the actionable number)
                out[key] = burns[0] if min(burns) > rule.value \
                    else min(burns)
        return out

    def _eval_backpressure(self, rule: AlertRule, now_s, then_s) \
            -> Dict[Tuple[str, ...], Tuple[float, bool]]:
        """Composite: per stage, fires when the stage's input queue sits
        at the watermark, OR a backlog is standing (depth >= 1) while
        the producer stage completes tasks > _BP_IMBALANCE x faster —
        either way, downstream cannot keep up.  Returns
        {key: (depth, fired)}."""
        depths = self._series_groups(now_s, rule.series, rule)
        rates: Dict[Tuple[str, ...], float] = {}
        if then_s is not None:
            dt = now_s[0] - then_s[0]
            if dt >= max(0.5, self._interval / 2):
                cur = self._groups(now_s[1].get(_BP_TASKS_SERIES),
                                   rule.match, ("stage",))
                old = self._groups(then_s[1].get(_BP_TASKS_SERIES),
                                   rule.match, ("stage",))
                rates = {k: max(v - old.get(k, 0.0), 0.0) / dt
                         for k, v in cur.items()}
        out = {}
        for key, depth in depths.items():
            stage = key[rule.by.index("stage")] if "stage" in rule.by \
                else (key[0] if key else "")
            fired = _OPS[rule.op](depth, rule.value)
            up = _BP_UPSTREAM.get(stage)
            if not fired and depth >= 1 and up is not None:
                up_rate = rates.get((up,), 0.0)
                my_rate = rates.get((stage,), 0.0)
                fired = up_rate > 0 \
                    and up_rate > my_rate * _BP_IMBALANCE
            out[key] = (depth, fired)
        return out

    # -- evaluation + state machine -----------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Run every rule against the sample history; update alert
        states; bump metrics and record flight-recorder instants for
        each transition.  Returns the transition list (tests)."""
        now = now if now is not None else time.time()
        now_s = self._latest()
        if now_s is None:
            return []
        rules = self.rules()
        transitions: List[dict] = []
        with self._lock:
            states = self._states
            for rule in rules:
                then_s = self._at_or_before(now - rule.window)
                if rule.form == "backpressure":
                    results = self._eval_backpressure(rule, now_s, then_s)
                else:
                    if rule.form == "value":
                        vals = self._eval_value(rule, now_s)
                    elif rule.form == "rate":
                        vals = self._eval_rate(rule, now_s, then_s)
                    elif rule.form in ("p50", "p90", "p99"):
                        q = {"p50": 0.5, "p90": 0.9, "p99": 0.99}[rule.form]
                        vals = self._eval_quantile(rule, q, now_s, then_s)
                    elif rule.form == "burn":
                        vals = self._eval_burn(rule, now, now_s)
                    else:   # unreachable post-validate
                        vals = {}
                    results = {k: (v, _OPS[rule.op](v, rule.value))
                               for k, v in vals.items()}
                seen = set()
                for key, (val, fired) in results.items():
                    skey = (rule.name, key)
                    seen.add(skey)
                    st = states.get(skey)
                    if fired:
                        if st is None:
                            st = states[skey] = {
                                "state": "pending", "since": now,
                                "labels": dict(zip(rule.by, key))}
                        st["value"] = val
                        if st["state"] == "pending" \
                                and now - st["since"] >= rule.for_seconds:
                            st["state"] = "firing"
                            st["fired_at"] = now
                            transitions.append({
                                "state": "firing", "rule": rule.name,
                                "severity": rule.severity,
                                "labels": st["labels"], "value": val})
                    elif st is not None:
                        if st["state"] == "firing":
                            transitions.append({
                                "state": "resolved", "rule": rule.name,
                                "severity": rule.severity,
                                "labels": st["labels"], "value": val})
                        del states[skey]
                # groups that vanished from the series (a departed
                # worker's gauge child, a finished pipeline's queue
                # sampler) resolve like any condition going false
                for skey in [k for k in states
                             if k[0] == rule.name and k not in seen]:
                    st = states[skey]
                    if st["state"] == "firing":
                        transitions.append({
                            "state": "resolved", "rule": rule.name,
                            "severity": rule.severity,
                            "labels": st["labels"],
                            "value": st.get("value")})
                    del states[skey]
                n_firing = sum(1 for (rn, _k), st in states.items()
                               if rn == rule.name
                               and st["state"] == "firing")
                _M_FIRING.labels(rule=rule.name,
                                 severity=rule.severity).set(n_firing)
            self._last_tick = now
        # transition side effects outside the state lock: the metric
        # children and the tracer ring have locks of their own
        tracer = self._tracer or _tr.default_tracer()
        for t in transitions:
            _M_TRANSITIONS.labels(rule=t["rule"], state=t["state"]).inc()
            _tr.record_instant(tracer, f"alert.{t['state']}",
                               rule=t["rule"], severity=t["severity"],
                               **(t["labels"] or {}))
            if t["state"] == "firing":
                _log.warning("ALERT firing: %s%s (value=%s)", t["rule"],
                             t["labels"] or "", t.get("value"))
            else:
                _log.info("alert resolved: %s%s", t["rule"],
                          t["labels"] or "")
        if transitions:
            with self._lock:
                listeners = list(self._listeners)
            for fn in listeners:
                for t in transitions:
                    try:
                        fn(t)
                    except Exception:  # noqa: BLE001 — actuator bug
                        # must not kill the alerting loop
                        _log.exception("alert listener failed")
        return transitions

    def tick(self, now: Optional[float] = None) -> List[dict]:
        now = now if now is not None else time.time()
        self.sample(now)
        return self.evaluate(now)

    # -- consumers ----------------------------------------------------------

    def firing(self) -> List[dict]:
        sev = {r.name: r.severity for r in self.rules()}
        desc = {r.name: r.description for r in self.rules()}
        with self._lock:
            out = []
            for (rn, _key), st in sorted(self._states.items()):
                if st["state"] != "firing":
                    continue
                out.append({
                    "rule": rn,
                    "severity": sev.get(rn, "warning"),
                    "labels": dict(st["labels"]),
                    "since": st.get("fired_at", st["since"]),
                    "value": st.get("value"),
                    "description": desc.get(rn, "")})
        return out

    def status_dict(self) -> Dict[str, Any]:
        """The health roll-up + firing alerts: /statusz Health panels,
        GetHealth, Client.health()."""
        firing = self.firing()
        status = "ok"
        reasons = []
        for f in firing:
            s = _SEVERITY_STATUS.get(f["severity"], "degraded")
            if _ROLLUP_ORDER[s] > _ROLLUP_ORDER[status]:
                status = s
            lbl = ",".join(f"{k}={v}"
                           for k, v in sorted(f["labels"].items()))
            reasons.append(f"{f['rule']}[{lbl}]" if lbl else f["rule"])
        return {"status": status, "reasons": sorted(reasons),
                "firing": firing, "enabled": _ENABLED,
                "rules": len(self.rules()),
                "last_tick": self._last_tick}

    def alertz_dict(self) -> Dict[str, Any]:
        """The /alertz body: the roll-up plus the full rule table (so
        an operator can see what WOULD fire, not just what is)."""
        out = self.status_dict()
        out["rule_table"] = [{
            "name": r.name, "form": r.form, "series": r.series,
            "op": r.op, "value": r.value, "window": r.window,
            "for": r.for_seconds, "severity": r.severity,
            "by": list(r.by), "description": r.description,
        } for r in self.rules()]
        return out

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="health-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a rule bug must not
                # kill the engine thread (and with it all alerting)
                _log.exception("health tick failed")


# ---------------------------------------------------------------------------
# Process-wide singleton (mirrors metrics.registry())
# ---------------------------------------------------------------------------

_ENGINE: Optional[HealthEngine] = None
_ENGINE_LOCK = threading.Lock()


def engine() -> HealthEngine:
    """The process-wide engine (created on first use; started by
    ensure_started)."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = HealthEngine()
        return _ENGINE


def ensure_started() -> Optional[HealthEngine]:
    """Start the process engine's sampling thread (idempotent); no-op
    when SCANNER_TPU_HEALTH=0."""
    if not _ENABLED:
        return None
    e = engine()
    e.start()
    return e


def configure(rules_spec: str) -> None:
    """Install user rules from an [alerts] rules spec (replacing any
    previously configured user rules)."""
    engine().set_user_rules(parse_rules(rules_spec))


def add_listener(fn: Callable[[dict], None]) -> None:
    """Register an alert-transition actuator with the process engine
    (see HealthEngine.add_listener)."""
    engine().add_listener(fn)


def set_interval(seconds: float) -> None:
    engine().set_interval(seconds)


def set_tracer(tracer: Any) -> None:
    engine().set_tracer(tracer)


def _quiet(extra_enabled: bool) -> Dict[str, Any]:
    return {"status": "ok", "reasons": [], "firing": [],
            "enabled": extra_enabled, "rules": 0, "last_tick": 0.0}


def status_dict() -> Dict[str, Any]:
    """Process health status; quiet-ok when the engine never started
    (a scrape must not spin one up as a side effect)."""
    if _ENGINE is None:
        return _quiet(_ENABLED)
    return _ENGINE.status_dict()


def rollup() -> Dict[str, Any]:
    """The minimal /healthz payload: status + reason codes."""
    st = status_dict()
    return {"status": st["status"], "reasons": st["reasons"]}


def firing_rules() -> List[str]:
    """Names of the rules currently firing in this process (sorted,
    deduped; [] when no engine ever started).  The compact form worker
    heartbeats advertise every beat so the master can fold worker-side
    alerts into cluster-level remediation transitions without a second
    RPC (engine/service.py; engine/controller.py acts on them)."""
    if _ENGINE is None:
        return []
    return sorted({f["rule"] for f in _ENGINE.firing()
                   if f.get("rule")})


def alertz_dict() -> Dict[str, Any]:
    if _ENGINE is None:
        out = _quiet(_ENABLED)
        out["rule_table"] = []
        return out
    return _ENGINE.alertz_dict()


def merge_status(nodes: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-node status dicts into one cluster view: worst-of
    status, node-prefixed reason codes, each node's firing alerts
    stamped with their node.  The ONE place the ok<degraded<unhealthy
    ordering lives for aggregation — the master's GetHealth and the
    local-mode Client.health() both use it."""
    status = "ok"
    reasons: List[str] = []
    firing: List[Dict[str, Any]] = []
    for node in sorted(nodes):
        h = nodes[node]
        s = h.get("status", "ok")
        if _ROLLUP_ORDER.get(s, 0) > _ROLLUP_ORDER.get(status, 0):
            status = s
        reasons.extend(f"{node}:{r}" for r in h.get("reasons", ()))
        firing.extend(dict(f, node=node) for f in h.get("firing", ()))
    return {"status": status, "reasons": reasons, "firing": firing,
            "nodes": nodes}
