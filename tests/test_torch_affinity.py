"""The executor's one carry-miss fallback and its whole-task load, held
against the JAX package (tests/test_affinity.py, tests/test_streaming.py).

A counting op with unbounded state runs over a stored table of 96
pickled rows (no video) under stateful task affinity.  Handing the
pipeline task 1 before task 0 breaks the chain's premise: task 2's plan
carries state from row 15, but the instance last ran task 0.  The
evaluator raises StateCarryMiss, and the executor re-runs that chunk
self-contained — on a whole task (work packet = io packet) and on a
streamed one (work packet under the io packet), threaded and serial.
The stored rows must equal the JAX package's rows, and the miss must be
counted.

`run_single_task` (the gang member's path) loads a task whole even where
its job streams, and stores the rows a threaded run stores.
"""

import pickle
import struct
import types

import numpy as np
import pytest
import torch

import scanner_tpu as sj

import scanner_tpu_torch as st
from scanner_tpu_torch.engine.evaluate import StateCarryMiss, TaskEvaluator
from scanner_tpu_torch.engine.executor import LocalExecutor, TaskItem
from scanner_tpu_torch.graph import analysis as A
from scanner_tpu_torch.util.profiler import Profiler
from torch_model_checks import stop_process_engine  # noqa: F401

N_ROWS = 96
IO = 8


def _counter(pkg):
    """A kernel emitting its running row position (state: the count of
    rows it has executed since its last reset)."""

    class Counter(pkg.Kernel):
        def __init__(self, config):
            super().__init__(config)
            self.reset()

        def reset(self):
            self.x = 0

        def execute(self, row: bytes) -> bytes:
            v = self.x
            self.x += 1
            return struct.pack("=q", v)

    return Counter


st.register_op(name="TorchAffinityCounter", unbounded_state=True)(
    _counter(st))
sj.register_op(name="TorchAffinityCounter", unbounded_state=True)(
    _counter(sj))

ROWS = [pickle.dumps(i, protocol=pickle.HIGHEST_PROTOCOL)
        for i in range(N_ROWS)]


def _stored(db, table):
    desc = db.table_descriptor(table)
    return list(db.load_column(table, desc.columns[0].name))


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_affinity")
    cj = sj.Client(db_path=str(root / "db_jax"))
    ct = st.Client(db_path=str(root / "db_torch"), device="cpu")
    # the same item bytes: the port reads them as a pickle column, the
    # JAX package (raw rows only) as bytes; the op ignores its input
    cj.new_table("rows", ["x"], [[r] for r in ROWS])
    ct.new_table("rows", ["x"], [[pickle.loads(r)] for r in ROWS],
                 codecs={"x": "pickle"})
    cj.run(_graph(cj, sj, "count"), sj.PerfParams.manual(IO, IO),
           show_progress=False)
    want = _stored(cj._db, "count")
    assert [struct.unpack("=q", b)[0] for b in want] == list(range(N_ROWS))
    yield ct, want
    cj.stop()
    ct.stop()


def _graph(sc, pkg, out):
    col = sc.ops.TorchAffinityCounter(
        row=sc.io.Input([pkg.NamedStream(sc, "rows")]))
    return sc.io.Output(col, [pkg.NamedStream(sc, out)])


def _swap_first_tasks(ex):
    """Hand the pipeline task 1 before task 0."""
    run_pipeline = ex._run_pipeline

    def swapped(info, work, *args, **kwargs):
        work[0], work[1] = work[1], work[0]
        return run_pipeline(info, work, *args, **kwargs)

    ex._run_pipeline = swapped


@pytest.mark.parametrize("driver", ["threads", "serial"])
@pytest.mark.parametrize("wp", [IO, IO // 2], ids=["whole", "streamed"])
def test_carry_miss_reruns_self_contained(tables, monkeypatch, driver, wp):
    ct, want = tables
    if driver == "serial":
        monkeypatch.setenv("SCANNER_TPU_NO_PIPELINING", "1")
    ex = LocalExecutor(ct._db, Profiler(), torch.device("cpu"))
    _swap_first_tasks(ex)
    out = f"miss_{driver}_{wp}"
    ex.run([_graph(ct, st, out)],
           st.PerfParams.manual(wp, IO, stateful_task_affinity=True))
    assert _stored(ct._db, out) == want
    counters = ex.profiler.counters
    assert counters.get("state_carry_miss") == 1
    # chunks are counted for streamed tasks only
    assert counters.get("stream_chunks", 0) == \
        (N_ROWS // wp if wp < IO else 0)


def test_fallback_reloads_a_whole_task(tables):
    """A carry plan on a fresh evaluator raises StateCarryMiss; the
    fallback reloads the task's rows and runs it self-contained."""
    ct, want = tables
    ex = LocalExecutor(ct._db, Profiler(), torch.device("cpu"))
    info, jobs = ex.prepare([_graph(ct, st, "unit")],
                            st.PerfParams.manual(IO, IO),
                            cache_mode=st.CacheMode.Overwrite)
    job = jobs[0]
    nid = next(n.id for n in info.ops
               if n.spec is not None and n.spec.unbounded_state)
    te = TaskEvaluator(info, ex.profiler, ex.device, instance=0)
    try:
        w = TaskItem(job, 2, (16, 24))
        w.plan = A.derive_task_streams(info, job.jr, (16, 24), job_idx=0,
                                       task_idx=2, carry={(nid, 0): 15})
        w.elements = ex._load_sources(info, w, types.SimpleNamespace())
        with pytest.raises(StateCarryMiss):
            te.execute_task(job.jr, w.plan, w.elements)
        w.elements = ex._load_sources(info, w, types.SimpleNamespace())
        ex._evaluate_stage(info, te, w, types.SimpleNamespace())
    finally:
        te.close()
    sink = info.sinks[0].id
    assert ex._sink_rows(w.results[sink], 16, 24) == want[16:24]
    assert ex.profiler.counters.get("state_carry_miss") == 1
    assert w.elements is None


def test_run_single_task_loads_the_whole_task(tables):
    """The job streams (4-row work packets in 16-row tasks), but
    run_single_task loads each task whole; its rows equal a threaded
    run's."""
    ct, _ = tables
    perf = st.PerfParams.manual(4, 16)
    ex = LocalExecutor(ct._db, Profiler(), torch.device("cpu"))
    ex.run([_graph(ct, st, "single_ref")], perf)
    ref = _stored(ct._db, "single_ref")
    info, jobs = ex.prepare([_graph(ct, st, "single")], perf,
                            cache_mode=st.CacheMode.Overwrite)
    job = jobs[0]
    assert job.stream_work_packets
    streamed = ex.load_task(info, TaskItem(job, 1, tuple(job.tasks[1])),
                            types.SimpleNamespace())
    assert streamed.chunk_plans is not None
    sink = info.sinks[0].id
    for t, (start, end) in enumerate(job.tasks):
        w = ex.run_single_task(info, TaskItem(job, t, (start, end)),
                               save=False)
        assert w.chunk_plans is None and w.plan is not None
        assert ex._sink_rows(w.results[sink], start, end) == \
            ref[start:end]
