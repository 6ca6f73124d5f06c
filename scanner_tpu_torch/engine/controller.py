"""Remediation controller: alerts -> actions, closed-loop.

The port of the JAX package's ``scanner_tpu/engine/controller.py``: the
actuator layer over the health engine (util/health.py).

  * **Playbooks** are declarative: each maps one alert rule's
    firing/resolved transitions to a named **action**, with a
    per-playbook cooldown, a resolve-side hysteresis hold, a rate
    limit, and a dry-run mode.  The built-in set (``DEFAULT_PLAYBOOKS``,
    the JAX package's names):

      - ``autoscale_up``        device_saturation -> nudge the autoscaler
      - ``admission_pause``     stage_backpressure -> shed load (pause
                                job admission; resume on resolve after
                                hysteresis) instead of melting
      - ``ladder_rewarm``       recompile_storm -> re-warm the bucket
                                ladders (engine/evaluate.py)
      - ``frame_cache_shrink``  hbm_pressure -> shrink + evict the paged
                                frame cache (engine/framecache.py)

  * **Actions are late-bound**: playbooks name actions; the component
    that owns the capability registers the callable
    (``register_action``) — the frame cache registers its shrink, this
    module registers the ladder re-warm.  A playbook whose action is
    unbound in this process records outcome ``unbound`` and does
    nothing (a local run has no admission to pause).

  * **Every decision is audited**: a bounded in-process audit ring
    (``audit()``, surfaced on /statusz) and
    ``scanner_tpu_remediations_total{playbook,action,outcome}``
    (outcomes: applied | dry_run | cooldown | rate_limited | unbound |
    error) — a remediation that fired, was vetoed, or broke is always
    attributable after the fact.

  * The **autoscaler** (``Autoscaler``) folds device saturation, queue
    depth and worker liveness into a desired replica count within
    ``[min, max]`` bounds and invokes a pluggable actuator callable.
    Scale-down happens only when the cluster is idle and one replica
    at a time: in-flight tasks are never killed.

``SCANNER_TPU_REMEDIATION=0`` is the kill switch: the controller never
binds to the health engine and the system returns to signal-only
behavior — alerts fire, humans act.  ``set_dry_run(True)`` keeps the
whole decision pipeline live but stops short of invoking actions.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..util import health as _health
from ..util import metrics as _mx
from ..util.log import get_logger
from ..util.tracing import _env_on

_log = get_logger("controller")

AUDIT_RING = 256

_M_REMEDIATIONS = _mx.registry().counter(
    "scanner_tpu_remediations_total",
    "Remediation-playbook decisions by playbook, action and outcome "
    "(applied | dry_run | cooldown | rate_limited | unbound | error) — "
    "the audit counter of the alerts->actuation loop "
    "(engine/controller.py).",
    labels=["playbook", "action", "outcome"])
_M_DESIRED = _mx.registry().gauge(
    "scanner_tpu_autoscale_desired_replicas",
    "Worker replica count the autoscaler currently wants (within its "
    "[min,max] bounds); compare against "
    "the live worker count to see convergence.")


# the shared kill-switch truthiness helper (util/tracing.py)
_ENABLED = _env_on("SCANNER_TPU_REMEDIATION")
_DRY_RUN = False


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """The programmatic override; the SCANNER_TPU_REMEDIATION env var
    is read at import.  Disabling after start is honored at transition
    time — the controller checks the flag on every delivery."""
    global _ENABLED
    _ENABLED = bool(on)


def set_dry_run(on: bool) -> None:
    """Dry run: decisions run end to end (cooldown, hysteresis, rate
    limit, audit, metrics) but no action is invoked."""
    global _DRY_RUN
    _DRY_RUN = bool(on)


def dry_run() -> bool:
    return _DRY_RUN


# ---------------------------------------------------------------------------
# Playbooks
# ---------------------------------------------------------------------------

@dataclass
class Playbook:
    """One alert->action binding.

    `action` runs on the alert's `firing` transition; `resolve_action`
    (optional) runs once the alert has stayed resolved for
    `hysteresis_s` (checked on tick(); a re-fire cancels the pending
    resolve) — the flap damper for reversible actions like admission
    pause/resume.  `cooldown_s` is per (playbook, alert-label-group):
    hbm_pressure on chip A must not block remediation of chip B.
    `max_per_window` actions per `window_s` is the global runaway
    brake per playbook."""

    name: str
    alert: str                       # a health DEFAULT_RULES name
    action: str
    resolve_action: str = ""
    cooldown_s: float = 30.0
    hysteresis_s: float = 0.0
    max_per_window: int = 6
    window_s: float = 600.0
    description: str = ""


# The built-in playbook set every process evaluates when remediation is
# on.  Names and alert bindings are the JAX package's; every `alert`
# names a health DEFAULT_RULES rule.
DEFAULT_PLAYBOOKS = (
    Playbook(
        name="autoscale_up", alert="device_saturation",
        action="autoscale", cooldown_s=15.0, max_per_window=12,
        description="sustained chip saturation nudges the autoscaler "
                    "to re-evaluate its desired replica count now "
                    "(the periodic master observe loop is the "
                    "fallback); scale-up within [min,max] bounds"),
    Playbook(
        name="admission_pause", alert="stage_backpressure",
        action="pause_admission", resolve_action="resume_admission",
        cooldown_s=5.0, hysteresis_s=2.0, max_per_window=12,
        description="sustained backpressure pauses new-job admission "
                    "on the master (NewJob answers retryable "
                    "admission_paused) instead of letting queues melt; "
                    "admission resumes once the alert has stayed "
                    "resolved for the hysteresis hold"),
    Playbook(
        name="ladder_rewarm", alert="recompile_storm",
        action="rewarm_ladders", cooldown_s=60.0, max_per_window=6,
        description="a sustained recompile rate re-warms every "
                    "live evaluator's bucket ladder on a background "
                    "thread (engine/evaluate.py rewarm_all) so steady "
                    "state returns to zero compiles per task"),
    Playbook(
        name="frame_cache_shrink", alert="hbm_pressure",
        action="shrink_frame_cache", cooldown_s=5.0, max_per_window=12,
        description="HBM occupancy near the device limit shrinks the "
                    "paged frame cache's capacity target and evicts "
                    "down NOW, before OOM strikes a task"),
)


def default_playbooks() -> List[Playbook]:
    return list(DEFAULT_PLAYBOOKS)


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------

def _labels_key(labels: Optional[Dict[str, Any]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


class RemediationController:
    """Delivers alert transitions to playbooks and invokes their bound
    actions under cooldown/hysteresis/rate-limit/dry-run discipline.

    One per process via `controller()`, bound to the health engine by
    `ensure_started()`; tests build private ones with a synthetic
    clock and drive `on_transition`/`tick` by hand.  Actions run
    OUTSIDE the controller lock (they may take seconds — a kubectl
    scale, a cache eviction sweep) and their exceptions are absorbed
    into outcome=error: a broken actuator must never kill alert
    delivery."""

    def __init__(self, playbooks: Optional[List[Playbook]] = None,
                 clock: Callable[[], float] = time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._playbooks: Dict[str, Playbook] = {}
        self._actions: Dict[str, Callable[[dict], Any]] = {}
        # (playbook, labels-key) -> last applied-action time (cooldown)
        self._last_action: Dict[Tuple[str, Tuple], float] = {}
        # playbook -> deque of applied-action times (rate limit window)
        self._recent: Dict[str, Deque[float]] = {}
        # playbook -> label-groups currently firing: alerts fire per
        # (rule, label-group), so "resolved" only means resolved once
        # EVERY group has resolved — one stage recovering must not
        # resume admission while another is still backpressured
        self._firing_groups: Dict[str, set] = {}
        # playbook -> resolved-at time awaiting the hysteresis hold
        self._pending_resolve: Dict[str, Tuple[float, dict]] = {}
        self._audit: Deque[dict] = deque(maxlen=AUDIT_RING)
        for pb in (default_playbooks() if playbooks is None
                   else playbooks):
            self._playbooks[pb.name] = pb

    # -- registration -------------------------------------------------------

    def register(self, playbook: Playbook) -> None:
        with self._lock:
            self._playbooks[playbook.name] = playbook

    def unregister(self, name: str) -> None:
        with self._lock:
            self._playbooks.pop(name, None)
            self._pending_resolve.pop(name, None)
            self._firing_groups.pop(name, None)

    def playbooks(self) -> List[Playbook]:
        with self._lock:
            return list(self._playbooks.values())

    def register_action(self, name: str,
                        fn: Callable[[dict], Any]) -> None:
        """Bind the callable behind an action name.  `fn` receives the
        triggering transition dict ({"state","rule","labels","value"});
        its return value is recorded in the audit entry's detail."""
        with self._lock:
            self._actions[name] = fn

    def unregister_action(self, name: str,
                          owner: Optional[Callable] = None) -> None:
        """Remove an action binding.  With `owner` given, remove only
        if the CURRENT binding is that callable — a stopped component
        must not strip a newer same-process sibling's re-registration
        (two Masters in one test process: latest wins, the old one's
        stop() may run later)."""
        with self._lock:
            if owner is not None and self._actions.get(name) != owner:
                return
            self._actions.pop(name, None)

    # -- bookkeeping shared with the autoscaler -----------------------------

    def record(self, playbook: str, action: str, outcome: str,
               detail: Any = None,
               labels: Optional[Dict[str, Any]] = None) -> None:
        """One audited remediation decision (the metric + audit-ring
        write every path funnels through, including the autoscaler's)."""
        _M_REMEDIATIONS.labels(playbook=playbook, action=action,
                               outcome=outcome).inc()
        entry = {"t": self._clock(), "playbook": playbook,
                 "action": action, "outcome": outcome,
                 "labels": dict(labels or {}),
                 "detail": detail}
        with self._lock:
            self._audit.append(entry)
        log = _log.warning if outcome in ("applied", "error") \
            else _log.info
        log("remediation %s/%s -> %s%s", playbook, action, outcome,
            f" ({detail})" if detail not in (None, "") else "")

    def audit(self, n: int = AUDIT_RING) -> List[dict]:
        with self._lock:
            return list(self._audit)[-n:]

    def status_dict(self) -> Dict[str, Any]:
        """The /statusz Remediation panel: enabled/dry-run flags, the
        playbook table, and the newest audit entries."""
        with self._lock:
            pbs = [{"name": p.name, "alert": p.alert,
                    "action": p.action,
                    "resolve_action": p.resolve_action,
                    "cooldown_s": p.cooldown_s,
                    "hysteresis_s": p.hysteresis_s,
                    "bound": p.action in self._actions}
                   for p in self._playbooks.values()]
            audit = list(self._audit)[-16:]
        return {"enabled": _ENABLED, "dry_run": _DRY_RUN,
                "playbooks": pbs, "audit": audit}

    # -- the action gate ----------------------------------------------------

    def _invoke(self, pb: Playbook, action: str, transition: dict,
                gate_cooldown: bool) -> str:
        now = self._clock()
        lkey = (pb.name, _labels_key(transition.get("labels")))
        with self._lock:
            fn = self._actions.get(action)
            if fn is None:
                outcome = "unbound"
            elif gate_cooldown and now - self._last_action.get(
                    lkey, -math.inf) < pb.cooldown_s:
                outcome = "cooldown"
            else:
                recent = self._recent.setdefault(pb.name, deque())
                while recent and recent[0] <= now - pb.window_s:
                    recent.popleft()
                if gate_cooldown and len(recent) >= pb.max_per_window:
                    outcome = "rate_limited"
                else:
                    # dry-run still records cooldown/rate-limit state:
                    # the staging mode must produce the same DECISION
                    # sequence production would (applied, cooldown,
                    # rate_limited, ...), only with the invocation
                    # swapped for an audit entry
                    outcome = "dry_run" if _DRY_RUN else "applied"
                    self._last_action[lkey] = now
                    recent.append(now)
        detail = None
        if outcome == "applied":
            try:
                detail = fn(transition)
            except Exception as e:  # noqa: BLE001 — a broken actuator
                # must not kill alert delivery
                outcome = "error"
                detail = f"{type(e).__name__}: {e}"
                _log.exception("remediation action %s failed", action)
        self.record(pb.name, action, outcome, detail=detail,
                    labels=transition.get("labels"))
        return outcome

    # -- delivery -----------------------------------------------------------

    def on_transition(self, transition: dict) -> None:
        """The health-engine listener (HealthEngine.add_listener): one
        alert state transition in.  Firing -> run the playbook's action
        (cooldown/rate-limit gated); resolved -> arm the hysteresis
        hold, executed by tick()."""
        if not _ENABLED:
            return
        rule = transition.get("rule")
        state = transition.get("state")
        lkey = _labels_key(transition.get("labels"))
        with self._lock:
            matched = [p for p in self._playbooks.values()
                       if p.alert == rule]
        for pb in matched:
            if state == "firing":
                with self._lock:
                    self._firing_groups.setdefault(pb.name,
                                                   set()).add(lkey)
                    self._pending_resolve.pop(pb.name, None)
                self._invoke(pb, pb.action, transition,
                             gate_cooldown=True)
            elif state == "resolved":
                with self._lock:
                    groups = self._firing_groups.get(pb.name)
                    if groups is not None:
                        groups.discard(lkey)
                    # one label-group resolving is not the alert
                    # resolving: the reversal waits until EVERY group
                    # is clear (stage=save recovering must not resume
                    # admission while stage=load still backpressures)
                    still_firing = bool(groups)
                if not pb.resolve_action or still_firing:
                    continue
                if pb.hysteresis_s <= 0:
                    self._invoke(pb, pb.resolve_action, transition,
                                 gate_cooldown=False)
                else:
                    with self._lock:
                        self._pending_resolve[pb.name] = (
                            self._clock(), dict(transition))

    def tick(self, now: Optional[float] = None) -> None:
        """Run pending resolve actions whose hysteresis hold elapsed.
        Driven by the master's scan loop (and tests); processes with
        fire-only playbooks never need it."""
        if not _ENABLED:
            return
        now = now if now is not None else self._clock()
        due: List[Tuple[Playbook, dict]] = []
        with self._lock:
            for name, (t0, transition) in list(
                    self._pending_resolve.items()):
                pb = self._playbooks.get(name)
                if pb is None:
                    del self._pending_resolve[name]
                    continue
                if now - t0 >= pb.hysteresis_s:
                    del self._pending_resolve[name]
                    due.append((pb, transition))
        for pb, transition in due:
            self._invoke(pb, pb.resolve_action, transition,
                         gate_cooldown=False)


# ---------------------------------------------------------------------------
# Autoscaler
# ---------------------------------------------------------------------------

@dataclass
class AutoscaleConfig:
    """Bounds + pacing for the master-side replica loop.  The desired
    count derives from backlog (queued+outstanding tasks over
    `queue_per_worker`) and saturation; scale-down requires the
    cluster idle for `idle_grace_s` and steps one replica at a time —
    preemptible capacity comes back cheap, killed work does not."""

    min_replicas: int = 1
    max_replicas: int = 8
    # one worker per this many backlog tasks (the queue-depth signal)
    queue_per_worker: float = 4.0
    up_cooldown_s: float = 30.0
    down_cooldown_s: float = 120.0
    # the cluster must be fully idle this long before a scale-down
    idle_grace_s: float = 60.0


class Autoscaler:
    """Folds saturation + queue depth + liveness into a desired replica
    count and invokes the actuator through the controller's audited
    action gate.  The actuator contract is `scale(n)` where the
    deployment layer reduces capacity only by draining
    (deploy.Cluster.scale -> kubernetes SIGTERM -> Worker.drain):
    this loop never kills in-flight work, and additionally refuses to
    scale down while any task is queued or outstanding."""

    def __init__(self, config: AutoscaleConfig,
                 actuator: Optional[Callable[[int], Any]] = None,
                 controller: Optional[RemediationController] = None,
                 clock: Callable[[], float] = time.time):
        self.config = config
        self._actuator = actuator
        self._controller = controller
        self._clock = clock
        self._lock = threading.Lock()
        self._desired: Optional[int] = None
        self._last_up = -math.inf
        self._last_down = -math.inf
        self._idle_since: Optional[float] = None

    def desired(self) -> Optional[int]:
        with self._lock:
            return self._desired

    def _clamp(self, n: int) -> int:
        return max(self.config.min_replicas,
                   min(self.config.max_replicas, n))

    def _apply(self, target: int, direction: str, detail: str) -> bool:
        """Invoke the actuator; False means the desired count must roll
        back (a failed kubectl/API call would otherwise latch _desired
        at the new target and every later observation would see
        nothing left to do while the cluster stays under-provisioned)."""
        ctrl = self._controller or controller()
        playbook = f"autoscale_{direction}"
        if self._actuator is None:
            ctrl.record(playbook, "scale", "unbound", detail=detail)
            return True
        if _DRY_RUN:
            ctrl.record(playbook, "scale", "dry_run", detail=detail)
            return True
        try:
            self._actuator(target)
        except Exception as e:  # noqa: BLE001 — audited, never fatal
            ctrl.record(playbook, "scale", "error",
                        detail=f"{type(e).__name__}: {e}")
            _log.exception("autoscale actuator failed (target=%d)",
                           target)
            return False
        ctrl.record(playbook, "scale", "applied", detail=detail)
        return True

    def observe(self, *, workers: int, queued: int, outstanding: int,
                saturated_workers: int = 0,
                now: Optional[float] = None) -> Optional[int]:
        """One observation of the cluster -> possibly one scale action.
        Returns the new desired count when a scale was decided (even in
        dry-run), else None.  Called from the master's scan loop and by
        the `autoscale` playbook on a device_saturation firing."""
        if not _ENABLED:
            return None
        now = now if now is not None else self._clock()
        cfg = self.config
        acted: Optional[int] = None
        prev_desired: Optional[int] = None
        with self._lock:
            if self._desired is None:
                self._desired = self._clamp(max(workers,
                                                cfg.min_replicas))
            backlog = int(queued) + int(outstanding)
            need = math.ceil(backlog / cfg.queue_per_worker) \
                if backlog else 0
            target = need
            if saturated_workers > 0 and queued > 0:
                # chips saturated AND work waiting: one more replica
                # even if the backlog math alone is satisfied
                target = max(target, self._desired + 1)
            target = self._clamp(target) if target else cfg.min_replicas
            up = target > self._desired
            idle = backlog == 0 and saturated_workers == 0
            if not idle:
                self._idle_since = None
            elif self._idle_since is None:
                self._idle_since = now
            if up and now - self._last_up >= cfg.up_cooldown_s:
                prev_desired = self._desired
                self._desired = target
                self._last_up = now
                self._idle_since = None
                acted = target
                direction, why = "up", (
                    f"backlog={backlog} saturated={saturated_workers} "
                    f"workers={workers} -> {target}")
            elif (idle and self._desired > cfg.min_replicas
                    and self._idle_since is not None
                    and now - self._idle_since >= cfg.idle_grace_s
                    and now - self._last_down >= cfg.down_cooldown_s):
                # idle long enough: step down ONE replica via drain
                prev_desired = self._desired
                self._desired -= 1
                self._last_down = now
                self._idle_since = now
                acted = self._desired
                direction, why = "down", (
                    f"idle >= {cfg.idle_grace_s:.0f}s "
                    f"-> {self._desired} (drain)")
            desired = self._desired
        _M_DESIRED.set(desired)
        if acted is not None:
            if not self._apply(acted, direction, why):
                # failed actuation: roll back so later observations
                # keep retrying toward the target (the cooldown just
                # consumed paces the retries — a broken actuator is
                # not hammered every scan pass)
                with self._lock:
                    self._desired = prev_desired
                _M_DESIRED.set(prev_desired)
                return None
        return acted


# ---------------------------------------------------------------------------
# Process-wide singleton (mirrors health.engine())
# ---------------------------------------------------------------------------

_CONTROLLER: Optional[RemediationController] = None
_CONTROLLER_LOCK = threading.Lock()


def controller() -> RemediationController:
    global _CONTROLLER
    with _CONTROLLER_LOCK:
        if _CONTROLLER is None:
            _CONTROLLER = RemediationController()
        return _CONTROLLER


def ensure_started() -> Optional[RemediationController]:
    """Bind the process controller to the health engine (idempotent);
    no-op when SCANNER_TPU_REMEDIATION=0 — alerts stay signal-only.
    Also registers the actions this module owns itself (the
    bucket-ladder re-warm)."""
    if not _ENABLED:
        return None
    c = controller()
    c.register_action("rewarm_ladders", _rewarm_ladders)
    _health.add_listener(c.on_transition)
    return c


def register_action(name: str, fn: Callable[[dict], Any]) -> None:
    controller().register_action(name, fn)


def unregister_action(name: str,
                      owner: Optional[Callable] = None) -> None:
    controller().unregister_action(name, owner=owner)


# [remediation] autoscale_min/max: the replica bounds a
# Master(autoscale=True) reads
_AUTOSCALE_BOUNDS = (1, 8)


def set_autoscale_bounds(min_replicas: int, max_replicas: int) -> None:
    """[remediation] autoscale_min/max config wiring (deployment
    defaults read by Master(autoscale=True))."""
    global _AUTOSCALE_BOUNDS
    _AUTOSCALE_BOUNDS = (max(0, int(min_replicas)),
                         max(1, int(max_replicas)))


def autoscale_bounds() -> Tuple[int, int]:
    return _AUTOSCALE_BOUNDS


def status_dict() -> Dict[str, Any]:
    """Process remediation status; quiet when the controller was never
    created (a scrape must not spin one up as a side effect)."""
    if _CONTROLLER is None:
        return {"enabled": _ENABLED, "dry_run": _DRY_RUN,
                "playbooks": [], "audit": []}
    return _CONTROLLER.status_dict()


def _rewarm_ladders(transition: dict) -> str:
    """The recompile_storm playbook's action: re-schedule the bucket
    ladder warm-up on every live evaluator (best-effort)."""
    from . import evaluate as _evaluate
    n = _evaluate.rewarm_all()
    return f"rewarmed {n} kernel ladder(s)"
