"""A local job's phases (`job.setup`, `pipeline.drain`, `job.commit`)
and the loader's spans (`load:read`, `load:decode`, `load:stage`) in the
port's profiler (util/profiler.py) and flight recorder
(util/tracing.py), over a small table of pickled frames on the CPU.

The phases are kept out of `Profiler.intervals()`: the earliest start
and latest end of a job's intervals stay those of its stage spans,
which is what the benchmark's `job_overhead_s.clips` subtracts from the
job's wall time.
"""

import json
import time

import numpy as np
import pytest
import torch

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.engine.executor import LocalExecutor
from scanner_tpu_torch.util import tracing
from scanner_tpu_torch.util.profiler import PHASE_TRACK, Profile, Profiler
from torch_model_checks import stop_process_engine  # noqa: F401

N, H, W = 12, 16, 24
PHASES = ("job.setup", "pipeline.drain", "job.commit")
LOADER_SPANS = ("load:read", "load:decode", "load:stage")
STAGES = ("load", "evaluate", "save")


@pytest.fixture(scope="module")
def client(tmp_path_factory):
    sc = st.Client(db_path=str(tmp_path_factory.mktemp("phases") / "db"),
                   device="cpu")
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
    sc.new_table("frames", ["frame"], [[f] for f in frames],
                 codecs={"frame": "pickle"})
    yield sc
    sc.stop()


def _graph(sc, out):
    frame = sc.io.Input([st.NamedStream(sc, "frames")])
    return sc.io.Output(sc.ops.Histogram(frame=frame),
                        [st.NamedStream(sc, out)])


@pytest.fixture(scope="module", params=["threads", "serial"])
def job(request, client):
    """One job through Client.run, threaded and NO_PIPELINING: (id,
    profiler, wall start, wall end)."""
    mp = pytest.MonkeyPatch()
    if request.param == "serial":
        mp.setenv("SCANNER_TPU_NO_PIPELINING", "1")
    try:
        t0 = time.time()
        jid = client.run(_graph(client, f"ph_{request.param}"),
                         st.PerfParams.manual(2, 4), show_progress=False,
                         cache_mode=st.CacheMode.Overwrite)
        t1 = time.time()
    finally:
        mp.undo()
    prof, = client.get_profile(jid).profilers
    return jid, prof, t0, t1


def test_each_phase_once_inside_the_wall_of_client_run(job):
    _, prof, t0, t1 = job
    ph = prof.phases()
    assert [p.name for p in ph] == list(PHASES)
    assert all(t0 <= p.start <= p.end <= t1 for p in ph)
    setup, drain, commit = ph
    ivs = prof.intervals()
    # set-up ends before any stage work; the drain starts at the last
    # save's end or later, the commit after the drain
    assert setup.end <= min(iv.start for iv in ivs)
    last_save = max(iv.end for iv in ivs if iv.name == "save")
    assert last_save <= drain.start <= drain.end <= commit.start


def test_phases_out_of_intervals_and_in_statistics(job):
    _, prof, _, _ = job
    assert not {iv.name for iv in prof.intervals()} & set(PHASES)
    stats = Profile([prof]).statistics()
    for name, p in zip(PHASES, prof.phases()):
        assert stats[name]["count"] == 1
        assert stats[name]["total_s"] == pytest.approx(p.end - p.start)


def test_phases_are_kept_at_every_level():
    prof = Profiler(level=0)
    with prof.span("load:read", level=1):
        pass
    prof.add_phase("job.commit", 1.0, 2.5, tables=1)
    assert prof.intervals() == []
    ph, = prof.phases()
    assert (ph.name, ph.end - ph.start, ph.args) == \
        ("job.commit", 1.5, {"tables": 1})


def test_the_envelope_of_intervals_is_that_of_the_stage_spans(job):
    """Guards job_overhead_s.clips: no phase widens the job's
    envelope."""
    _, prof, _, _ = job
    ivs = prof.intervals()
    stages = [iv for iv in ivs if iv.name in STAGES]
    assert min(iv.start for iv in ivs) == min(iv.start for iv in stages)
    assert max(iv.end for iv in ivs) == max(iv.end for iv in stages)


def test_phases_survive_the_round_trip_and_reach_the_chrome_trace(
        job, tmp_path):
    _, prof, _, _ = job
    again = Profiler.from_dict(json.loads(json.dumps(prof.to_dict())))
    assert again.phases() == prof.phases()
    assert again.intervals() == prof.intervals()
    path = str(tmp_path / "t.json")
    Profile([again]).write_trace(path, merge_device=False)
    events = json.load(open(path))["traceEvents"]
    track = next(e["tid"] for e in events
                 if e["name"] == "thread_name"
                 and e["args"]["name"] == PHASE_TRACK)
    on_track = [e for e in events if e.get("ph") == "X"
                and e["tid"] == track]
    assert [e["name"] for e in on_track] == list(PHASES)
    # older serializations carry no phases
    d = prof.to_dict()
    del d["phases"]
    assert Profiler.from_dict(d).phases() == []


def test_phases_in_the_flight_recorder_under_the_job_root(job, client):
    jid, prof, _, _ = job
    spans = tracing.default_tracer().spans_for_trace(
        client._job_traces[jid]["trace_id"])
    root, = [d for d in spans if d["name"] == "job"]
    got = sorted((d for d in spans if d["name"] in PHASES),
                 key=lambda d: d["start"])
    assert [d["name"] for d in got] == list(PHASES)
    assert all(d["parent_id"] == root["span_id"] for d in got)
    assert [(d["start"], d["end"]) for d in got] == \
        [(p.start, p.end) for p in prof.phases()]
    assert root["start"] <= got[0]["start"] \
        and got[-1]["end"] <= root["end"]
    reads = [d for d in spans if d["name"] == "load:read"]
    assert reads and all(d["attrs"]["bytes"] > 0 for d in reads)


@pytest.mark.parametrize("work,io", [(2, 4), (4, 4)],
                         ids=["streamed", "whole_task"])
def test_loader_spans_lie_inside_a_load_span_of_their_task(client, work,
                                                           io):
    """Staged onto the (CPU) device as the card's executor stages: every
    loader span sits inside a `load` span on its thread, carrying its
    rows and bytes."""
    prof = Profiler()
    ex = LocalExecutor(client._db, prof, torch.device("cpu"), stage=True)
    ex.run([_graph(client, f"ph_load_{work}")],
           st.PerfParams.manual(work, io), cache_mode=st.CacheMode.Overwrite)
    ivs = prof.intervals()
    loads = [iv for iv in ivs if iv.name == "load"]
    inner = [iv for iv in ivs if iv.name in LOADER_SPANS]
    assert {iv.name for iv in inner} == set(LOADER_SPANS)
    for iv in inner:
        assert any(ld.thread == iv.thread and ld.start <= iv.start
                   and iv.end <= ld.end for ld in loads), iv
    rows = {name: sum(iv.args["rows"] for iv in inner if iv.name == name)
            for name in ("load:read", "load:decode")}
    assert rows == {"load:read": N, "load:decode": N}
    frame_bytes = H * W * 3
    assert sum(iv.args["bytes"] for iv in inner
               if iv.name == "load:stage") == N * frame_bytes
    # a pickled frame is its pixels and a little more
    assert sum(iv.args["bytes"] for iv in inner
               if iv.name == "load:read") > N * frame_bytes
    # one span a chunk or task, never one a row
    assert len(inner) == 3 * (N // work)
    # LocalExecutor.run called directly records the phases too
    assert [p.name for p in prof.phases()] == list(PHASES)
