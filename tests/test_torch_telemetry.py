"""Live telemetry of the port: the MetricsServer endpoints
(scanner_tpu_torch/util/metrics.py), `Client(metrics_port=)`,
`Client.health()` against the JAX package's local `Client.health()`,
and the device trace of a `profiler_level=2` job (util/torchprof.py)
merged into the host profile.

On the CPU the device trace holds the CPU activity only (the operators
the job ran); the merge, the pid range and the alignment to the host
window are what is checked here.  tests/test_torch_cuda.py checks the
card's kernels by name in the same trace.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import scanner_tpu as sj
import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.engine import controller as tctl
from scanner_tpu_torch.engine.executor import LocalExecutor
from scanner_tpu_torch.util import health as th
from scanner_tpu_torch.util import metrics as tm
from scanner_tpu_torch.util import torchprof
from scanner_tpu_torch.util.profiler import Profile, Profiler
from torch_model_checks import stop_process_engine  # noqa: F401

N, W, H = 16, 64, 48



def _get(port, path):
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                   timeout=10)
        return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_metrics_server_endpoints_and_readyz_503():
    reg = tm.MetricsRegistry()
    reg.counter("scanner_tpu_test_things_total", "things").inc(3)
    state = {"status": "ok", "reasons": []}
    ready = {"v": True}
    srv = tm.MetricsServer(
        port=0, reg=reg, statusz=lambda: {"x": 1},
        healthz=lambda: {"role": "t"}, health=lambda: dict(state),
        ready=lambda: ready["v"],
        alertz=lambda: {"status": state["status"], "rule_table": []})
    try:
        code, body = _get(srv.port, "/metrics")
        assert code == 200 and b"scanner_tpu_test_things_total 3" in body
        code, body = _get(srv.port, "/healthz")
        assert code == 200 and json.loads(body) == {
            "ok": True, "status": "ok", "reasons": [], "role": "t"}
        assert _get(srv.port, "/readyz")[0] == 200
        assert json.loads(_get(srv.port, "/statusz")[1]) == {"x": 1}
        assert _get(srv.port, "/nope")[0] == 404
        state.update(status="unhealthy", reasons=["hbm_pressure"])
        code, body = _get(srv.port, "/healthz")
        # liveness stays 200; the body carries the roll-up
        assert code == 200 and json.loads(body)["ok"] is False
        code, body = _get(srv.port, "/readyz")
        assert code == 503 and json.loads(body)["ready"] is False
        assert json.loads(_get(srv.port, "/alertz")[1])["status"] \
            == "unhealthy"
        state.update(status="degraded", reasons=[])
        assert _get(srv.port, "/readyz")[0] == 200
        ready["v"] = False
        assert _get(srv.port, "/readyz")[0] == 503
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    from scanner_tpu import video as scv
    root = tmp_path_factory.mktemp("torch_telemetry")
    clip = str(root / "clip.mp4")
    scv.synthesize_video(clip, num_frames=N, width=W, height=H, fps=24,
                         keyint=8)
    cj = sj.Client(db_path=str(root / "db_jax"))
    ct = st.Client(db_path=str(root / "db_torch"), device="cpu",
                   metrics_port=0)
    for c in (cj, ct):
        _, failed = c.ingest_videos([("clip", clip)])
        assert not failed
    yield cj, ct
    cj.stop()
    ct.stop()
    assert ct._metrics_server is None


def _hist_job(sc, pkg, name):
    frame = sc.io.Input([pkg.NamedVideoStream(sc, "clip")])
    return sc.io.Output(sc.ops.Histogram(frame=frame),
                        [pkg.NamedStream(sc, name)])


def test_client_metrics_port_serves_the_run(clients):
    _, ct = clients
    ct.run(_hist_job(ct, st, "tel_hist"), st.PerfParams.manual(8, 8),
           show_progress=False, cache_mode=st.CacheMode.Overwrite)
    port = ct._metrics_server.port
    code, body = _get(port, "/metrics")
    text = body.decode()
    assert code == 200
    assert 'scanner_tpu_stage_tasks_total{stage="evaluate"}' in text
    assert 'scanner_tpu_device_busy_seconds_total{device="cpu"}' in text
    code, body = _get(port, "/statusz")
    st_ = json.loads(body)
    assert code == 200
    assert {"health", "memory", "framecache", "efficiency",
            "remediation"} <= set(st_)
    assert st_["remediation"]["enabled"] == tctl.enabled()
    assert {p["name"] for p in st_["remediation"]["playbooks"]} == \
        {"autoscale_up", "admission_pause", "ladder_rewarm",
         "frame_cache_shrink"}
    code, body = _get(port, "/alertz")
    assert code == 200
    assert {r["name"] for r in json.loads(body)["rule_table"]} >= \
        {r.name for r in th.DEFAULT_RULES}
    assert _get(port, "/healthz")[0] == 200
    assert _get(port, "/readyz")[0] in (200, 503)


def _shape(obj):
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(obj[0])] if obj else []
    return type(obj).__name__


def test_client_health_shape_matches_jax(clients):
    cj, ct = clients
    got, want = ct.health(), cj.health()
    assert set(got) == set(want) == {"status", "reasons", "firing",
                                     "nodes"}
    assert set(got["nodes"]) == set(want["nodes"]) == {"client"}
    assert set(got["nodes"]["client"]) == set(want["nodes"]["client"])
    assert got["status"] in ("ok", "degraded", "unhealthy")
    assert _shape(got["nodes"]["client"]["enabled"]) == \
        _shape(want["nodes"]["client"]["enabled"])
    with pytest.raises(st.ScannerException):
        ct.job_status()
    with pytest.raises(sj.ScannerException):
        cj.job_status()


def test_level2_job_merges_device_events_in_host_window(clients,
                                                        tmp_path):
    _, ct = clients
    prof = Profiler(level=2)
    ex = LocalExecutor(ct._db, prof, torch.device("cpu"), stage=True)
    perf = st.PerfParams.manual(8, 8)
    perf.profiler_level = 2
    ex.run([_hist_job(ct, st, "tel_l2")], perf,
           cache_mode=st.CacheMode.Overwrite)
    assert len(prof.device_traces) == 1
    rec = prof.device_traces[0]
    assert rec["t0"] <= rec["t1"]
    path = str(tmp_path / "merged.json")
    Profile([prof]).write_trace(path)
    events = json.load(open(path))["traceEvents"]
    dev = [e for e in events if e.get("pid", 0) >= torchprof.DEVICE_PID_BASE
           and e.get("ph") == "X"]
    host = [e for e in events if e.get("pid", 0) < torchprof.DEVICE_PID_BASE
            and e.get("ph") == "X"]
    assert dev and host
    lo, hi = rec["t0"] * 1e6, rec["t1"] * 1e6
    ops = [e for e in dev if e.get("cat") == "cpu_op"]
    assert ops, "the capture holds none of the job's operators"
    # the job's operators ran inside the capture window (1 ms slack for
    # the anchor's own placement)
    assert all(lo - 1e3 <= e["ts"] and e["ts"] + e.get("dur", 0)
               <= hi + 1e3 for e in ops)
    # and the host's evaluate spans lie in the same window
    evals = [e for e in host if e["name"].startswith("evaluate")]
    assert evals and all(lo <= e["ts"] <= hi for e in evals)
    # merge_device=False keeps the host spans only
    Profile([prof]).write_trace(path, merge_device=False)
    assert all(e.get("pid", 0) < torchprof.DEVICE_PID_BASE
               for e in json.load(open(path))["traceEvents"])
    # the profile's round trip keeps the capture record
    again = Profiler.from_dict(prof.to_dict())
    assert again.device_traces == prof.device_traces


def test_client_trace_carries_device_events(clients, tmp_path):
    _, ct = clients
    perf = st.PerfParams.manual(8, 8)
    perf.profiler_level = 2
    job = ct.run(_hist_job(ct, st, "tel_trace"), perf,
                 show_progress=False, cache_mode=st.CacheMode.Overwrite)
    path = ct.trace(job, str(tmp_path / "t.json"))
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("pid", 0) >= torchprof.DEVICE_PID_BASE
               for e in events)
    assert any(e.get("name") == "job" for e in events)


def test_embedded_events_survive_without_the_file(tmp_path):
    prof = Profiler(level=2)
    with torchprof.device_trace(prof, out_dir=str(tmp_path)):
        torch.ones(8).sum()
    rec = dict(prof.device_traces[0])
    want = torchprof.load_device_events(rec)
    emb = torchprof.embed_device_events(dict(rec), max_events=2)
    emb.pop("path")
    got = torchprof.load_device_events(emb)
    assert got and len(got) <= len(want)
    assert any(e.get("name") == torchprof.ANCHOR for e in got)
    assert np.isclose(
        next(e["ts"] for e in got if e.get("name") == torchprof.ANCHOR),
        rec["t0"] * 1e6)


@pytest.mark.parametrize("value", [None, "7", "", "junk"])
def test_devtrace_event_cap_follows_the_jax_rule(monkeypatch, value):
    """SCANNER_TPU_DEVTRACE_MAX_EVENTS caps the port's embedded device
    events as it caps the JAX package's: unset, empty or unparsable
    gives 200000."""
    from scanner_tpu.util import jaxprof
    if value is None:
        monkeypatch.delenv("SCANNER_TPU_DEVTRACE_MAX_EVENTS", raising=False)
    else:
        monkeypatch.setenv("SCANNER_TPU_DEVTRACE_MAX_EVENTS", value)
    assert torchprof._devtrace_event_cap() \
        == jaxprof._devtrace_event_cap() \
        == (7 if value == "7" else 200000)


def test_devtrace_event_cap_truncates_longest_first(monkeypatch, tmp_path):
    evs = [{"ph": "X", "name": f"k{i}", "dur": float(i), "pid": 0}
           for i in range(10)]
    meta = [{"ph": "M", "name": "process_name", "pid": 0},
            {"ph": "i", "name": torchprof.ANCHOR, "pid": 0}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": meta + evs}))
    monkeypatch.setenv("SCANNER_TPU_DEVTRACE_MAX_EVENTS", "3")
    rec = torchprof.embed_device_events({"path": str(path)})
    assert rec["events_dropped"] == 7
    assert rec["events"][:2] == meta
    assert [e["name"] for e in rec["events"][2:]] == ["k9", "k8", "k7"]
    # an explicit max_events still wins over the environment
    rec = torchprof.embed_device_events({"path": str(path)}, max_events=5)
    assert rec["events_dropped"] == 5
