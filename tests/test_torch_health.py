"""The health/SLO engine of the port (scanner_tpu_torch/util/health.py)
held against the JAX package's (scanner_tpu/util/health.py).

The same rule specs go through both packages' `parse_rules` (equal
rules; the same malformed specs rejected), and the same seeded series
sequence goes into two private engines — each over a private registry
of its own package — ticked on one fake clock.  The alert transitions
must be equal (rule, state, labels exactly; values within 1e-9), and so
must `status_dict`, `rollup`, `alertz_dict` and `merge_status`.  The
rule descriptions are left out of the comparison: two of the port's
name the card's terms (allocator, kernel recompiles) where the JAX
package's name XLA's.  The scenario reaches every rule form and
`ratio_to`.  Private engines only: no process engine thread is started.
"""

import dataclasses

import numpy as np
import pytest

from scanner_tpu.util import health as jh
from scanner_tpu.util import metrics as jm
from scanner_tpu_torch.util import health as th
from scanner_tpu_torch.util import metrics as tm

TOL = 1e-9

SPECS = [
    "eval_hot:value(scanner_tpu_stage_queue_depth{stage=evaluate})>=3"
    ":for=1:severity=critical",
    "hbm_ratio:value(scanner_tpu_device_hbm_bytes_in_use"
    "/scanner_tpu_device_hbm_limit_bytes)>0.95:by=device",
    "busy_rate:rate(scanner_tpu_device_busy_seconds_total)>0.7"
    ":window=3:by=device",
    "lat_p50:p50(scanner_tpu_task_latency_seconds)>2:window=4",
    "lat_p90:p90(scanner_tpu_task_latency_seconds)>8:window=4",
    "lat_p99:p99(scanner_tpu_task_latency_seconds)>20:window=6",
    "lat_burn:burn(scanner_tpu_task_latency_seconds)>1.5:objective=10"
    ":budget=0.2:short=3:window=9",
    "bp:backpressure(scanner_tpu_stage_queue_depth)>=4:window=3:for=0.5",
]

BAD_SPECS = [
    "nocolon",
    "x:bogus(scanner_tpu_a)>1",
    "x:value(not_scanner)>1",
    "x:value(scanner_tpu_a{stage})>1",
    "x:value(scanner_tpu_a)>1:speed=3",
    "x:value(scanner_tpu_a)>1:window=abc",
    "x:value(scanner_tpu_a)>1:severity=page",
    "Bad-Name:value(scanner_tpu_a)>1",
    "x:value(scanner_tpu_a)=>1",
]


def _rule_fields(r):
    return {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
            for k, v in dataclasses.asdict(r).items()}


def test_parse_rules_equal():
    got = th.parse_rules(";".join(SPECS))
    want = jh.parse_rules(";".join(SPECS))
    assert [_rule_fields(r) for r in got] == \
        [_rule_fields(r) for r in want]
    assert len(got) == len(SPECS)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_specs_rejected_by_both(spec):
    with pytest.raises(jh.HealthConfigError):
        jh.parse_rules(spec)
    with pytest.raises(th.HealthConfigError):
        th.parse_rules(spec)


def test_default_rules_equal():
    strip = lambda r: {k: v for k, v in _rule_fields(r).items()  # noqa
                       if k != "description"}
    assert [strip(r) for r in th.DEFAULT_RULES] == \
        [strip(r) for r in jh.DEFAULT_RULES]


def _registry(mx):
    reg = mx.MetricsRegistry()
    return reg, {
        "depth": reg.gauge("scanner_tpu_stage_queue_depth", "d",
                           labels=["stage"]),
        "tasks": reg.counter("scanner_tpu_stage_tasks_total", "t",
                             labels=["stage"]),
        "hb": reg.gauge("scanner_tpu_worker_heartbeat_age_seconds", "h",
                        labels=["worker"]),
        "busy": reg.counter("scanner_tpu_device_busy_seconds_total", "b",
                            labels=["device"]),
        "use": reg.gauge("scanner_tpu_device_hbm_bytes_in_use", "u",
                         labels=["device"]),
        "limit": reg.gauge("scanner_tpu_device_hbm_limit_bytes", "l",
                           labels=["device"]),
        "lat": reg.histogram(
            "scanner_tpu_task_latency_seconds", "lat",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0, 300.0, 600.0)),
        "recomp": reg.counter("scanner_tpu_op_recompiles_total", "r",
                              labels=["op", "device"]),
    }


def _steps(seed, n):
    """One seeded list of per-tick updates, fed to both packages."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        phase_hot = (k // 12) % 2 == 1      # alternate calm / hot spans
        out.append({
            "depth": {s: float(rng.randint(3, 7) if phase_hot
                               else rng.randint(0, 3))
                      for s in ("evaluate", "save")},
            "tasks": {s: float(rng.randint(0, 6)) for s in
                      ("load", "evaluate", "save")},
            "hb": {w: float(rng.uniform(0, 8)) for w in ("w0", "w1")},
            "busy": {d: float(rng.uniform(0.2, 1.0) if phase_hot
                              else rng.uniform(0.0, 0.5))
                     for d in ("cuda:0", "cuda:1")},
            "use": {d: float(rng.uniform(0.9, 1.0) if phase_hot
                             else rng.uniform(0.5, 0.9)) * 1e9
                    for d in ("cuda:0", "cuda:1")},
            "lat": [float(v) for v in (
                rng.exponential(15.0 if phase_hot else 1.0,
                                rng.randint(1, 6)))],
            "recomp": float(rng.randint(0, 4) if phase_hot else 0),
        })
    return out


def _drive(mx, health, steps, interval=0.5):
    reg, m = _registry(mx)
    for d in ("cuda:0", "cuda:1"):
        m["limit"].labels(device=d).set(1e9)
    eng = health.HealthEngine(
        reg, rules=list(health.DEFAULT_RULES) + health.parse_rules(
            ";".join(SPECS)), interval=interval)
    transitions = []
    t = 1000.0
    for st in steps:
        for s, v in st["depth"].items():
            m["depth"].labels(stage=s).set(v)
        for s, v in st["tasks"].items():
            m["tasks"].labels(stage=s).inc(v)
        for w, v in st["hb"].items():
            m["hb"].labels(worker=w).set(v)
        for d, v in st["busy"].items():
            m["busy"].labels(device=d).inc(v * interval)
        for d, v in st["use"].items():
            m["use"].labels(device=d).set(v)
        for v in st["lat"]:
            m["lat"].observe(v)
        m["recomp"].labels(op="Histogram", device="cuda:0").inc(
            st["recomp"])
        transitions.extend(eng.tick(now=t))
        t += interval
    return eng, transitions


def _strip_desc(obj):
    if isinstance(obj, dict):
        return {k: _strip_desc(v) for k, v in obj.items()
                if k != "description"}
    if isinstance(obj, list):
        return [_strip_desc(v) for v in obj]
    return obj


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transitions_and_rollups_equal(seed):
    steps = _steps(seed, 72)
    te, tt = _drive(tm, th, steps)
    je, jt = _drive(jm, jh, steps)
    assert [(x["rule"], x["state"], x["labels"]) for x in tt] == \
        [(x["rule"], x["state"], x["labels"]) for x in jt]
    _close([x["value"] for x in tt], [x["value"] for x in jt])
    fired = {x["rule"] for x in tt if x["state"] == "firing"}
    # the scenario reaches every form, ratio_to included
    assert {"eval_hot", "hbm_ratio", "busy_rate", "bp", "lat_p50",
            "lat_p90", "lat_p99", "lat_burn"} <= fired, fired
    _close(_strip_desc(te.status_dict()), _strip_desc(je.status_dict()))
    _close(_strip_desc(te.alertz_dict()), _strip_desc(je.alertz_dict()))
    merged_t = th.merge_status({"a": te.status_dict(),
                                "b": {"status": "degraded",
                                      "reasons": ["x"], "firing": []}})
    merged_j = jh.merge_status({"a": je.status_dict(),
                                "b": {"status": "degraded",
                                      "reasons": ["x"], "firing": []}})
    _close(_strip_desc(merged_t), _strip_desc(merged_j))


def test_process_rollup_matches_when_quiet():
    """The module-level forms before any engine exists in either
    package's process state are the same quiet dicts."""
    if th._ENGINE is None and jh._ENGINE is None:
        assert th.rollup() == jh.rollup()
        assert th.alertz_dict() == jh.alertz_dict()
    assert th.merge_status({}) == jh.merge_status({})


def test_listener_sees_transitions_and_user_rules_resolve_on_removal():
    reg, m = _registry(tm)
    m["depth"].labels(stage="evaluate").set(9.0)
    eng = th.HealthEngine(reg, rules=[], interval=0.5)
    eng.set_user_rules(th.parse_rules(
        "q:value(scanner_tpu_stage_queue_depth{stage=evaluate})>5"))
    seen = []
    eng.add_listener(seen.append)
    eng.tick(now=10.0)
    assert [(t["rule"], t["state"]) for t in seen] == [("q", "firing")]
    assert eng.status_dict()["status"] == "degraded"
    eng.set_user_rules([])
    assert eng.status_dict()["status"] == "ok"


@pytest.mark.parametrize("seconds", [0.01, 0.05, 0.3, 2])
def test_module_set_interval_matches_jax(seconds):
    """The module-level set_interval reaches the process engine and
    clamps as the JAX package's does (no engine thread is started)."""
    engines = (jh.engine(), th.engine())
    before = [e._interval for e in engines]
    try:
        jh.set_interval(seconds)
        th.set_interval(seconds)
        assert th.engine()._interval == jh.engine()._interval
    finally:
        for e, v in zip(engines, before):
            e._interval = v
