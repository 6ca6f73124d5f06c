"""How the port's threaded pipeline (`LocalExecutor.run_pipeline`) ends.

The end of the stream travels down the stage queues as end markers: the
last loader to end puts one per evaluator, the last evaluator one per
saver.  A normal finish therefore waits on no queue poll: the
`pipeline.drain` phase (last save to every stage thread joined) is a
few ms, and the profiler count `pipeline.poll_exits` (a stage thread
that left its loop on a poll's timeout, its marker missed) stays 0.
When a task fails, `stop` ends every stage thread and the job raises.

Every pipeline here runs on a thread joined with a timeout, so a hang
fails its test rather than the suite.  Over a small table of pickled
frames on the CPU.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.engine import executor as ex_mod
from scanner_tpu_torch.engine import service
from scanner_tpu_torch.engine.executor import LocalExecutor, TaskItem
from scanner_tpu_torch.util import faults
from scanner_tpu_torch.util.profiler import Profiler
from torch_model_checks import stop_process_engine  # noqa: F401

N, H, W = 24, 16, 24
PERF = dict(work_packet_size=2, io_packet_size=4)   # six tasks a job
JOIN_S = 60.0
# a normal finish's drain: the evaluator's close and the joins; a
# drain that waits out one 0.25 s poll reads above it
DRAIN_MAX_S = 0.2
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def client(tmp_path_factory):
    sc = st.Client(db_path=str(tmp_path_factory.mktemp("drain") / "db"),
                   device="cpu")
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
    sc.new_table("frames", ["frame"], [[f] for f in frames],
                 codecs={"frame": "pickle"})
    yield sc
    sc.stop()


def _graph(sc, out):
    frame = sc.io.Input([st.NamedStream(sc, "frames")])
    return sc.io.Output(sc.ops.Histogram(frame=frame),
                        [st.NamedStream(sc, out)])


def _stored(db, table):
    desc = db.table_descriptor(table)
    return list(db.load_column(table, desc.columns[0].name))


def _within(fn, *args, **kw):
    """Run fn on a thread joined with a timeout: (result, exception)."""
    out = {}

    def body():
        try:
            out["result"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001
            out["error"] = e

    t = threading.Thread(target=body, name="drain-test", daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), f"pipeline still running after {JOIN_S} s"
    return out.get("result"), out.get("error")


def _assert_ended_by_markers(prof: Profiler, entries: int = 1):
    drains = [p for p in prof.phases() if p.name == "pipeline.drain"]
    assert len(drains) == entries
    assert all(p.end - p.start < DRAIN_MAX_S for p in drains), \
        [p.end - p.start for p in drains]
    assert prof.counters.get("pipeline.poll_exits", 0) == 0


@pytest.fixture(scope="module")
def reference(client):
    """The rows of a NO_PIPELINING run: the serial path has no queues."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SCANNER_TPU_NO_PIPELINING", "1")
    try:
        client.run(_graph(client, "ref"), st.PerfParams.manual(**PERF),
                   show_progress=False, cache_mode=st.CacheMode.Overwrite)
    finally:
        mp.undo()
    rows = _stored(client._db, "ref")
    assert len(rows) == N
    return rows


def test_a_local_job_drains_without_a_poll(client, reference):
    jid, err = _within(client.run, _graph(client, "local"),
                       st.PerfParams.manual(**PERF), show_progress=False,
                       cache_mode=st.CacheMode.Overwrite)
    assert err is None
    prof, = client.get_profile(jid).profilers
    _assert_ended_by_markers(prof)
    assert _stored(client._db, "local") == reference


@pytest.mark.parametrize("width", [3, 16])
@pytest.mark.parametrize("queues", ["shared", "per_instance"])
def test_instances_and_savers_store_every_row(client, reference, queues,
                                              width, monkeypatch):
    """`width` loaders, evaluator instances and savers (16: more threads
    a stage than cores, and than tasks, with the interpreter switching
    threads every microsecond), on one shared queue, or (instances on
    distinct devices) on a queue per instance: one marker per evaluator
    either way, and the last thread of a stage sends them."""
    if queues == "per_instance":
        monkeypatch.setattr(ex_mod, "assigned_device",
                            lambda device, i: torch.device("cpu", i))
    seen = set()
    save_task = LocalExecutor._save_task

    def spy(self, info, w):
        seen.add(w.instance)
        return save_task(self, info, w)

    monkeypatch.setattr(LocalExecutor, "_save_task", spy)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    prof = Profiler()
    ex = LocalExecutor(client._db, prof, CPU, num_load_workers=width,
                       num_save_workers=width, pipeline_instances=width)
    out = f"instances_{queues}_{width}"
    try:
        _, err = _within(ex.run, [_graph(client, out)],
                         st.PerfParams.manual(
                             **PERF, queue_size_per_pipeline=1),
                         cache_mode=st.CacheMode.Overwrite)
    finally:
        sys.setswitchinterval(switch)
    assert err is None
    assert len(seen) > 1
    _assert_ended_by_markers(prof)
    assert _stored(client._db, out) == reference


@pytest.mark.parametrize("site", ["pipeline.eval", "pipeline.save"])
def test_a_failed_task_ends_the_pipeline_and_raises(client, site):
    """The second task's evaluation or save raises: `stop` ends every
    stage thread, those blocked on a full queue included, and the job
    raises the task's error."""
    prof = Profiler()
    ex = LocalExecutor(client._db, prof, CPU, num_load_workers=2,
                       num_save_workers=2, pipeline_instances=2)
    faults.install(f"{site}:raise:exc=runtime:msg=drain-test:n=2:times=1")
    try:
        _, err = _within(ex.run, [_graph(client, f"fail_{site}")],
                         st.PerfParams.manual(
                             **PERF, queue_size_per_pipeline=1),
                         cache_mode=st.CacheMode.Overwrite)
        assert faults.fired(site) == 1
    finally:
        faults.clear()
    assert isinstance(err, RuntimeError) and "drain-test" in str(err)
    assert prof.counters.get("pipeline.poll_exits", 0) == 0


def test_a_worker_pipeline_entered_twice_ends_each_entry(client, reference):
    """The cluster worker's task path (close_evaluators=False, the
    evaluators kept across entries) over two halves of a job's tasks."""
    out = _graph(client, "worker")
    perf = st.PerfParams.manual(**PERF)
    db = client._db
    LocalExecutor(db, Profiler(), CPU).prepare([out], perf,
                                               st.CacheMode.Overwrite)
    pipe = service.WorkerPipeline(LocalExecutor(db, Profiler(), CPU), CPU)
    prof = Profiler()
    pipe.join([out], perf, prof)
    tasks = [TaskItem(job, t, rows) for job in pipe.jobs
             for t, rows in enumerate(job.tasks)]
    half = len(tasks) // 2
    done = []
    for entry, part in enumerate((tasks[:half], tasks[half:]), 1):
        todo = iter(part)
        _, err = _within(pipe.run, lambda: next(todo, None),
                         on_done=done.append)
        assert err is None
        assert pipe._evaluators
        _assert_ended_by_markers(prof, entries=entry)
    pipe.close()
    for job in pipe.jobs:
        for desc, _c, _k, _e in job.sink_tables.values():
            db.commit_table(desc.id)
    assert len(done) == len(tasks) > 2
    assert _stored(db, "worker") == reference
