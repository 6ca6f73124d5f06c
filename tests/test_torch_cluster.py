"""The cluster control plane (engine/service.py, engine/rpc.py): an
in-process Master and Worker(device="cpu") of the port over gRPC on
localhost, beside the JAX package's in-process cluster on its own copy
of the same clip.  Histogram and HistDiff rows must be the same bytes
as the JAX cluster's and as the port's local Client run; a worker whose
task fails (fault injection) still gives the same rows; an op that
always fails is blacklisted after MAX_TASK_FAILURES strikes; a gang bulk
is refused at admission; the worker's task path (WorkerPipeline) runs
from a local task list; the cluster forms of job_status, health,
metrics and trace work; shutdown_cluster stops every server thread.
Every server binds port 0."""

import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest

import scanner_tpu as sj
import scanner_tpu.kernels  # noqa: F401
from scanner_tpu import video as scv
from scanner_tpu.engine import service as jservice

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.engine import service as tservice
from scanner_tpu_torch.util import faults as tfaults
from torch_model_checks import stop_process_engine  # noqa: F401

# test kernels travel inside the job spec
cloudpickle.register_pickle_by_value(sys.modules[__name__])

N, W, H = 40, 96, 64
PERF = dict(work_packet_size=4, io_packet_size=8)


@st.register_op(name="TorchTestClusterFail")
class _AlwaysFail(st.Kernel):
    def execute(self, frame: st.FrameType) -> bytes:
        raise RuntimeError("deliberate failure")


def _graph(sc, pkg, kind, out_name):
    frame = sc.io.Input([pkg.NamedVideoStream(sc, "clip")])
    if kind == "config1":
        col = sc.ops.Histogram(frame=frame)
    elif kind == "histdiff":
        col = sc.ops.HistDiff(frame=frame)
    else:
        col = sc.ops.TorchTestClusterFail(frame=frame)
    return sc.io.Output(col, [pkg.NamedStream(sc, out_name)])


def _stored(db, table):
    desc = db.table_descriptor(table)
    return list(db.load_column(table, desc.columns[0].name))


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cluster")
    clip = str(root / "clip.mp4")
    scv.synthesize_video(clip, num_frames=N, width=W, height=H, fps=24,
                         keyint=8)
    paths = {k: str(root / f"db_{k}") for k in ("jax", "torch", "local")}
    seed_j = sj.Client(db_path=paths["jax"])
    assert not seed_j.ingest_videos([("clip", clip)])[1]
    seed_j.stop()
    local = st.Client(db_path=paths["local"], device="cpu")
    assert not local.ingest_videos([("clip", clip)])[1]
    seed_t = st.Client(db_path=paths["torch"], device="cpu")
    assert not seed_t.ingest_videos([("clip", clip)])[1]
    seed_t.stop()
    jm = jservice.Master(db_path=paths["jax"], no_workers_timeout=60.0)
    jw = jservice.Worker(f"localhost:{jm.port}", db_path=paths["jax"])
    jc = sj.Client(db_path=paths["jax"], master=f"localhost:{jm.port}")
    tm = tservice.Master(db_path=paths["torch"], no_workers_timeout=60.0)
    tw = tservice.Worker(f"localhost:{tm.port}", db_path=paths["torch"],
                         device="cpu")
    tc = st.Client(db_path=paths["torch"], master=f"localhost:{tm.port}")
    yield {"jax": jc, "torch": tc, "local": local,
           "tpath": paths["torch"]}
    tfaults.clear()
    for c in (jc, tc, local):
        c.stop()
    for w in (jw, tw):
        w.stop()
    jm.stop()
    tm.stop()


def _run(sc, pkg, kind, name, **perf_kw):
    return sc.run(_graph(sc, pkg, kind, name),
                  pkg.PerfParams.manual(**PERF, **perf_kw),
                  show_progress=False, cache_mode=pkg.CacheMode.Overwrite)


# first in the module, before the `clusters` fixture starts its servers:
# their RPC pools add threads on demand while they live, which would
# read as threads this test's cluster left behind
def test_shutdown_cluster_stops_every_server_thread(tmp_path):
    """A blocking master and worker (each in wait_for_shutdown, as a
    deployment runs them) exit on shutdown_cluster(), and none of the
    threads they started (RPC handlers, scan, heartbeat, work loop)
    outlives them."""
    db = str(tmp_path / "db")
    before = set(threading.enumerate())
    m = tservice.Master(db_path=db)
    w = tservice.Worker(f"localhost:{m.port}", db_path=db, device="cpu")
    waits = [threading.Thread(target=x.wait_for_shutdown)
             for x in (m, w)]
    for t in waits:
        t.start()
    sc = st.Client(db_path=db, master=f"localhost:{m.port}")
    assert sc.shutdown_cluster() == 1
    sc.stop()
    for t in waits:
        t.join(timeout=30)
        assert not t.is_alive()
    started = lambda: [t.name for t in threading.enumerate()  # noqa: E731
                       if t not in before and t.name != "health-engine"]
    deadline = time.time() + 15
    while time.time() < deadline and started():
        time.sleep(0.05)
    assert started() == []


@pytest.mark.parametrize("kind", ["config1", "histdiff"])
def test_cluster_rows_equal_jax_cluster_and_local(clusters, kind):
    name = f"{kind}_rows"
    _run(clusters["jax"], sj, kind, name)
    _run(clusters["torch"], st, kind, name)
    _run(clusters["local"], st, kind, name)
    want = _stored(clusters["jax"]._db, name)
    assert len(want) == N
    assert _stored(clusters["torch"]._db, name) == want
    assert _stored(clusters["local"]._db, name) == want


def test_failed_task_is_retried_with_same_rows(clusters):
    """The first evaluated task raises (util/faults, the chaos tests'
    rule form); the master requeues it and the rows stay the same."""
    tc = clusters["torch"]
    _run(clusters["local"], st, "config1", "fault_base")
    tfaults.install("pipeline.eval:raise:exc=runtime:n=1:times=1")
    try:
        _run(tc, st, "config1", "fault_rows")
        assert tfaults.fired("pipeline.eval") == 1
    finally:
        tfaults.clear()
    st_ = tc.job_status()
    assert st_["finished"] and st_["failed_jobs"] == []
    assert st_["task_failures"] == 1
    assert st_["tasks_done"] == st_["total_tasks"] == N // 8
    assert _stored(tc._db, "fault_rows") == \
        _stored(clusters["local"]._db, "fault_base")


def test_always_failing_job_is_blacklisted(clusters):
    tc = clusters["torch"]
    assert tservice.MAX_TASK_FAILURES == jservice.MAX_TASK_FAILURES
    with pytest.raises(st.JobException, match="blacklisted"):
        _run(tc, st, "fail", "never")
    s = tc.job_status()
    assert s["finished"] and s["failed_jobs"] == [0]
    assert s["per_job"][0]["blacklisted"]
    assert s["task_failures"] >= tservice.MAX_TASK_FAILURES


def test_gang_bulk_refused_at_admission(clusters):
    with pytest.raises(st.JobException, match="A.7"):
        _run(clusters["torch"], st, "config1", "gang", gang_hosts=2)


def test_worker_pipeline_from_a_local_source(clusters):
    """WorkerPipeline, the task path every Worker runs a bulk through,
    fed from a task list with no master: rows the same bytes as the
    local Client run's."""
    import torch
    from scanner_tpu_torch.engine.executor import LocalExecutor, TaskItem
    from scanner_tpu_torch.util.profiler import Profiler
    local = clusters["local"]
    _run(local, st, "config1", "wp_ref")
    out = _graph(local, st, "config1", "wp")
    perf = st.PerfParams.manual(**PERF)
    db = local._db
    cpu = torch.device("cpu")
    LocalExecutor(db, Profiler(), cpu).prepare([out], perf,
                                               st.CacheMode.Overwrite)
    pipe = tservice.WorkerPipeline(LocalExecutor(db, Profiler(), cpu), cpu)
    pipe.join([out], perf, Profiler())
    todo = iter([TaskItem(job, t, rows) for job in pipe.jobs
                 for t, rows in enumerate(job.tasks)])
    done = []
    pipe.run(lambda: next(todo, None), on_done=lambda w: done.append(w))
    pipe.close()
    for job in pipe.jobs:
        for desc, _c, _k, _e in job.sink_tables.values():
            db.commit_table(desc.id)
    assert len(done) == sum(len(j.tasks) for j in pipe.jobs) > 1
    assert _stored(db, "wp") == _stored(db, "wp_ref")


def test_cluster_telemetry(clusters, tmp_path):
    """job_status, health, metrics, trace(raw_clocks=) and stragglers in
    cluster mode: the master's views, with the worker's samples."""
    import json
    tc = clusters["torch"]
    job = _run(tc, st, "config1", "telemetry_rows")
    s = tc.job_status()
    assert s["finished"] and s["num_workers"] >= 1
    assert s["trace_id"]
    h = tc.health()
    assert h["status"] in ("ok", "degraded", "unhealthy")
    assert any(n.startswith("worker") for n in h["nodes"])
    m = tc.metrics()
    nodes = {smp["labels"].get("node")
             for e in m.values() for smp in e.get("samples", [])}
    assert "master" in nodes and any(str(n).startswith("worker")
                                     for n in nodes)
    for raw in (False, True):
        path = tc.trace(job, str(tmp_path / f"t{raw}.json"),
                        raw_clocks=raw)
        events = json.load(open(path))["traceEvents"]
        names = {e.get("name") for e in events}
        assert {"job", "task"} <= names
    assert tc.stragglers(job)["per_stage"]["task"]["count"] == N // 8
    assert tc.compile_report() and tc.memory_report()
    with pytest.raises(st.ScannerException):
        clusters["local"].job_status()


def test_client_from_config_path(clusters, tmp_path):
    """Client(config_path=) reads the JAX package's TOML: [storage] and
    [network] pick the database and the master, and the process-wide
    sections ([remediation] bounds here) land as in the JAX package."""
    from scanner_tpu.engine import controller as jctl
    from scanner_tpu_torch.engine import controller as tctl
    port = clusters["torch"]._master_address.rsplit(":", 1)[1]
    cfg = tmp_path / "cluster.toml"
    cfg.write_text(f"""
[storage]
db_path = "{clusters['tpath']}"
[network]
master = "localhost"
master_port = {port}
[remediation]
autoscale_min = 2
autoscale_max = 5
""")
    saved = (jctl.autoscale_bounds(), tctl.autoscale_bounds())
    try:
        tc = st.Client(config_path=str(cfg))
        jc = sj.Client(db_path=str(tmp_path / "jdb"), config_path=str(cfg))
        assert tc.device is None and tc._cluster is not None
        assert tc.job_status()["num_workers"] >= 1
        assert tctl.autoscale_bounds() == jctl.autoscale_bounds() == (2, 5)
        tc.stop()
        jc.stop()
    finally:
        jctl.set_autoscale_bounds(*saved[0])
        tctl.set_autoscale_bounds(*saved[1])


def test_cluster_client_takes_no_device(clusters):
    with pytest.raises(st.ScannerException, match="device"):
        st.Client(db_path=clusters["tpath"], master="localhost:1",
                  device="cpu")
