"""The remediation controller of the port
(scanner_tpu_torch/engine/controller.py) held against the JAX package's
(scanner_tpu/engine/controller.py).

The same seeded stream of alert transitions, on one fake clock, goes
into a private RemediationController of each package with the same
action bindings (one that succeeds, one that raises, the rest unbound);
the audit rings must record identical outcomes (applied, dry_run,
cooldown, rate_limited, unbound, error) for the same playbooks, actions
and labels at the same times.  The same seeded observations go into an
Autoscaler of each package and must give identical decisions.  The kill
switch and dry run are flipped the same way in both.  Private
controllers only: nothing binds to a process health engine.
"""

import numpy as np
import pytest

from scanner_tpu.engine import controller as jc
from scanner_tpu_torch.engine import controller as tc

RULES = ["device_saturation", "stage_backpressure", "recompile_storm",
         "hbm_pressure", "worker_heartbeat_stale"]


@pytest.fixture(autouse=True)
def _flags():
    saved = [(m, m._ENABLED, m._DRY_RUN) for m in (jc, tc)]
    yield
    for m, en, dr in saved:
        m._ENABLED, m._DRY_RUN = en, dr


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _stream(seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        rule = RULES[rng.randint(len(RULES))]
        lbl = ({"device": f"cuda:{rng.randint(2)}"}
               if rule in ("device_saturation", "hbm_pressure")
               else {"stage": ("load", "evaluate", "save")[rng.randint(3)]}
               if rule == "stage_backpressure" else {})
        out.append({"dt": float(rng.choice([0.5, 1.0, 3.0, 8.0, 40.0])),
                    "transition": {
                        "state": "firing" if rng.rand() < 0.6
                        else "resolved",
                        "rule": rule, "severity": "warning",
                        "labels": lbl, "value": float(rng.rand())},
                    "flip": rng.randint(20)})
    return out


def _drive(mod, stream):
    clock = _Clock()
    c = mod.RemediationController(clock=clock)
    c.register_action("shrink_frame_cache", lambda t: "shrunk")

    def boom(t):
        raise RuntimeError("boom")
    c.register_action("rewarm_ladders", boom)
    c.register_action("pause_admission", lambda t: None)
    c.register_action("resume_admission", lambda t: None)
    for k, step in enumerate(stream):
        clock.t += step["dt"]
        if step["flip"] == 0:
            mod.set_dry_run(not mod.dry_run())
        elif step["flip"] == 1:
            mod.set_enabled(not mod.enabled())
        c.on_transition(dict(step["transition"]))
        c.tick()
    mod.set_dry_run(False)
    mod.set_enabled(True)
    return [(a["t"], a["playbook"], a["action"], a["outcome"],
             a["labels"], a["detail"]) for a in c.audit()]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_audit_outcomes_equal(seed):
    stream = _stream(seed, 160)
    got = _drive(tc, stream)
    want = _drive(jc, stream)
    assert got == want
    outcomes = {a[3] for a in got}
    assert {"applied", "cooldown", "unbound", "error"} <= outcomes, outcomes


def test_every_outcome_reached_with_dry_run_and_rate_limit():
    """A hand stream that reaches dry_run and rate_limited too, and the
    kill switch dropping deliveries, in both packages alike."""
    def drive(mod):
        clock = _Clock()
        c = mod.RemediationController(
            playbooks=[mod.Playbook(name="shrink", alert="hbm_pressure",
                                    action="shrink_frame_cache",
                                    cooldown_s=1.0, max_per_window=2,
                                    window_s=100.0)],
            clock=clock)
        c.register_action("shrink_frame_cache", lambda t: "ok")
        fire = {"state": "firing", "rule": "hbm_pressure",
                "labels": {"device": "cuda:0"}}
        for dt in (0.0, 0.5, 2.0, 2.0, 2.0):
            clock.t += dt
            c.on_transition(dict(fire))
        mod.set_dry_run(True)
        clock.t += 200.0
        c.on_transition(dict(fire))
        mod.set_dry_run(False)
        mod.set_enabled(False)
        clock.t += 200.0
        c.on_transition(dict(fire))
        mod.set_enabled(True)
        return [(a["t"], a["outcome"]) for a in c.audit()]
    got, want = drive(tc), drive(jc)
    assert got == want
    assert [o for _, o in got] == ["applied", "cooldown", "applied",
                                   "rate_limited", "rate_limited",
                                   "dry_run"]


def test_hysteresis_resolve_equal():
    def drive(mod):
        clock = _Clock()
        c = mod.RemediationController(clock=clock)
        calls = []
        c.register_action("pause_admission", lambda t: calls.append("p"))
        c.register_action("resume_admission", lambda t: calls.append("r"))
        bp = lambda st, s: {"state": st, "rule": "stage_backpressure",  # noqa
                            "labels": {"stage": s}}
        c.on_transition(bp("firing", "load"))
        c.on_transition(bp("firing", "save"))
        clock.t += 1
        c.on_transition(bp("resolved", "save"))
        c.tick()
        clock.t += 5
        c.on_transition(bp("resolved", "load"))
        clock.t += 1
        c.tick()
        clock.t += 2
        c.tick()
        return calls, [(a["t"], a["playbook"], a["action"], a["outcome"])
                       for a in c.audit()]
    assert drive(tc) == drive(jc)
    # one pause per stage (cooldown is per label group), one resume once
    # both resolved and the hold elapsed
    assert drive(tc)[0] == ["p", "p", "r"]


def _observations(seed, n):
    rng = np.random.RandomState(seed)
    t = 0.0
    out = []
    for _ in range(n):
        t += float(rng.choice([5.0, 20.0, 45.0, 90.0]))
        busy = rng.rand() < 0.5
        out.append(dict(workers=int(rng.randint(1, 6)),
                        queued=int(rng.randint(0, 30)) if busy else 0,
                        outstanding=int(rng.randint(0, 8)) if busy else 0,
                        saturated_workers=int(rng.randint(0, 3))
                        if busy else 0,
                        now=t))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_autoscaler_decisions_equal(seed):
    obs = _observations(seed, 80)

    def drive(mod):
        clock = _Clock(0.0)
        ctrl = mod.RemediationController(clock=clock)
        n = [0]

        def actuator(target):
            n[0] += 1
            if n[0] % 4 == 0:
                raise RuntimeError("scale failed")
        a = mod.Autoscaler(mod.AutoscaleConfig(min_replicas=1,
                                               max_replicas=6,
                                               idle_grace_s=60.0),
                           actuator=actuator, controller=ctrl, clock=clock)
        out = []
        for o in obs:
            clock.t = o["now"]
            out.append((a.observe(**o), a.desired()))
        return out, [(x["playbook"], x["outcome"]) for x in ctrl.audit()]
    got, want = drive(tc), drive(jc)
    assert got == want
    assert any(d is not None for d, _ in got[0])
    assert {"applied", "error"} <= {o for _, o in got[1]}


def test_default_playbooks_equal():
    def fields(p):
        return (p.name, p.alert, p.action, p.resolve_action, p.cooldown_s,
                p.hysteresis_s, p.max_per_window, p.window_s)
    assert [fields(p) for p in tc.DEFAULT_PLAYBOOKS] == \
        [fields(p) for p in jc.DEFAULT_PLAYBOOKS]
