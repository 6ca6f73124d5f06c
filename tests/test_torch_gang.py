"""Gang-scheduled execution (engine/gang.py, parallel/{distributed,mesh,
halo}.py, the master's gang scheduling in engine/service.py): the
port beside the JAX package on the same seeded inputs.

Layers:
  * pure units, each held against the JAX function — shard math, the
    uint32 digest bit for bit, the mesh factoring, the halo plan of one
    graph over one clip, the frame cache's shard-scoped pages, the
    config gates and the gang metric series;
  * the member's loud failures (no card, no rendezvous) and the gloo
    interface rule;
  * in-process port master units, mirroring the JAX package's
    tests/test_gang.py and test_gang_sharded.py: formation and roles,
    the form-timeout singleton, stale-epoch NACKs on both sides, abort
    on GangFailed / preemption / worker loss / task timeout, the abort
    cap, the shard commit fold, and a journal round trip across a
    master failover with no double commit;
  * journal cross-replay of gang records between the packages;
  * the collectives over two and three gloo ranks (spawned from
    tests/torch_gang_worker.py): halos against the JAX package's
    `_halo_exchange_block` under shard_map, uneven all-gather, the
    digest sum and the byte all-gather.
"""

import os
import socket
import struct
import subprocess
import sys
import time
from typing import Sequence

import cloudpickle
import numpy as np
import pytest

import scanner_tpu as sj
import scanner_tpu.kernels  # noqa: F401
from scanner_tpu import video as scv
from scanner_tpu.engine import gang as jgang
from scanner_tpu.engine import journal as jjournal
from scanner_tpu.parallel import distributed as jdist
from scanner_tpu.parallel import mesh as jmesh
from scanner_tpu.util import metrics as jmx

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.engine import framecache as tfc
from scanner_tpu_torch.engine import gang as tgang
from scanner_tpu_torch.engine import journal as tjournal
from scanner_tpu_torch.engine.service import (MAX_TASK_FAILURES,
                                              MAX_TRANSIENT_FAILURES,
                                              Master, Worker)
from scanner_tpu_torch.parallel import distributed as tdist
from scanner_tpu_torch.parallel import mesh as tmesh
from scanner_tpu_torch.storage.backend import MemoryStorage as TMemory
from scanner_tpu_torch.util import faults as tfaults
from scanner_tpu_torch.util import metrics as tmx
from scanner_tpu.storage.backend import MemoryStorage as JMemory
from torch_model_checks import stop_process_engine  # noqa: F401

cloudpickle.register_pickle_by_value(sys.modules[__name__])

pytestmark = pytest.mark.chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 8


def _pk(v: int) -> bytes:
    return struct.pack("<q", v)


@st.register_op(name="TorchGangDouble")
class _GangDouble(st.Kernel):
    def execute(self, x: bytes) -> bytes:
        return _pk(2 * struct.unpack("<q", x)[0])


@st.register_op(name="TorchGangWide", stencil=[-2, 0, 1])
class _TorchWide(st.Kernel):
    def execute(self, frame: Sequence[st.FrameType]) -> bytes:
        return _pk(len(frame))


@sj.register_op(name="TorchGangWide", stencil=[-2, 0, 1])
class _JaxWide(sj.Kernel):
    def execute(self, frame: Sequence[sj.FrameType]) -> bytes:
        return _pk(len(frame))


def _counter(name: str, **labels) -> float:
    entry = tmx.registry().snapshot().get(name, {})
    return sum(s["value"] for s in entry.get("samples", [])
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True)
def _clean_state():
    tfaults.clear()
    tfc.set_host_shard(None)
    yield
    tfaults.clear()
    tfc.set_host_shard(None)


# ---------------------------------------------------------------------------
# pure units against the JAX package
# ---------------------------------------------------------------------------

def test_shard_range_and_ceil_chunk_equal_jax():
    for n in (0, 1, 5, 8, 10, 17, 64):
        for num in (1, 2, 3, 4, 7, 9):
            assert tdist.ceil_chunk(n, num) == jdist.ceil_chunk(n, num)
            for p in range(num):
                assert tgang.shard_range(n, p, num) == \
                    jgang.shard_range(n, p, num) == \
                    tdist.shard_rows(n, p, num)
    with pytest.raises(st.ScannerException):
        tdist.ceil_chunk(4, 0)


def test_host_local_array_validation_and_single_rank_gather():
    """The uneven staging contracts of the JAX test_gang_sharded.py, on a
    one-rank gloo group: a named leading axis is required, a block
    larger than the ceil-chunk is rejected, short blocks pad with zeros,
    and a one-rank gather is the identity."""
    tdist.initialize(tdist.CoordinatorConfig(
        f"127.0.0.1:{_free_port()}", 1, 0), init_timeout=30)
    try:
        mesh = tmesh.host_mesh(1)
        assert tuple(mesh.mesh_dim_names) == ("hosts", "local")
        block = np.arange(12, dtype=np.float32).reshape(3, 4)
        with pytest.raises(st.ScannerException, match="named mesh axis"):
            tdist.host_local_array(mesh, (None,), block, global_rows=3)
        with pytest.raises(st.ScannerException, match="exceeds"):
            tdist.host_local_array(mesh, ("hosts",), np.zeros((5, 2)),
                                   global_rows=3)
        padded = tdist.host_local_array(mesh, ("hosts",), block[:2],
                                        global_rows=3)
        assert padded.shape == (3, 4) and not padded[2].any()
        out = tdist.all_gather_rows(mesh, "hosts", block, global_rows=3)
        assert np.array_equal(out, block)
        assert tgang._collective_digest_sum(1, 0, 0xFFFFFFFF) == 0xFFFFFFFF
        with pytest.raises(ValueError, match="cannot split"):
            tmesh.host_mesh(2)
    finally:
        tdist.shutdown()
    assert not tdist.is_initialized()
    tdist.shutdown()  # idempotent


def _rows(kind: str, rng, pkg):
    if kind == "bytes":
        return [bytes(rng.randint(0, 256, rng.randint(0, 40)).astype(
            np.uint8)) for _ in range(9)]
    if kind == "arrays":
        dts = (np.uint8, np.int32, np.float32, np.float64, np.int64)
        return [rng.randn(*rng.randint(1, 5, 2)).astype(dts[i % 5])
                for i in range(9)]
    if kind == "null":
        return [pkg.NullElement() if i % 3 == 0 else _pk(i)
                for i in range(9)]
    return [np.array([object(), i], dtype=object) for i in range(4)] \
        + [{"k": 1}, _pk(3), bytearray(b"xy")]


@pytest.mark.parametrize("kind", ["bytes", "arrays", "null", "object"])
def test_digest_rows_equal_jax_bit_for_bit(kind):
    for seed in range(3):
        jr = _rows(kind, np.random.RandomState(seed), sj)
        tr = _rows(kind, np.random.RandomState(seed), st)
        d = tgang._digest_rows(tr)
        assert d == jgang._digest_rows(jr)
        assert 0 <= d <= 0xFFFFFFFF
        # shard digests compose mod 2**32, the member-0 cross-check
        num = 3
        parts = [tgang._digest_rows(tr[slice(*tgang.shard_range(
            len(tr), p, num))]) for p in range(num)]
        assert sum(parts) & 0xFFFFFFFF == d


def test_auto_axes_and_make_mesh_factoring_equal_jax():
    for n in range(1, 17):
        assert tmesh.auto_axes(n) == jmesh.auto_axes(n)
    import jax
    jdevs = jax.devices()
    assert len(jdevs) == 8
    for axes in ({}, {"dp": 2}, {"sp": 4}, {"dp": 2, "sp": 2, "tp": 2},
                 {"dp": 1, "sp": 2}, {"tp": 8}, {"dp": 2, "pp": 2},
                 {"ep": 4}, {"dp": 2, "sp": 2, "tp": 1}):
        jm = jmesh.make_mesh(axes, devices=jdevs)
        tm = tmesh.make_mesh(axes, devices=list(range(8)))
        assert tm.shape == dict(jm.shape), axes
        assert tuple(tm.axis_names) == tuple(jm.axis_names)
        assert [int(d) for d in tm.devices.flat] == \
            [d.id for d in jm.devices.flat]
    for bad in ({"dp": 3}, {"xx": 2}):
        with pytest.raises(ValueError):
            jmesh.make_mesh(bad, devices=jdevs)
        with pytest.raises(ValueError):
            tmesh.make_mesh(bad, devices=list(range(8)))


@pytest.fixture(scope="module")
def clip_dbs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gang_clip")
    clip = str(root / "clip.mp4")
    scv.synthesize_video(clip, num_frames=24, width=32, height=24, fps=24,
                         keyint=8)
    jc = sj.Client(db_path=str(root / "jdb"))
    assert not jc.ingest_videos([("clip", clip)])[1]
    tc = st.Client(db_path=str(root / "tdb"), device="cpu")
    assert not tc.ingest_videos([("clip", clip)])[1]
    yield jc, tc
    jc.stop()
    tc.stop()


def _halo_graph(sc, pkg, kind):
    frame = sc.io.Input([pkg.NamedVideoStream(sc, "clip")])
    if kind == "config2":
        col = sc.ops.HistogramDelta(hist=sc.ops.Histogram(frame=frame))
    else:
        col = sc.ops.TorchGangWide(frame=frame)
    return sc.io.Output(col, [pkg.NamedStream(sc, f"halo_{kind}")])


@pytest.mark.parametrize("kind,num,io", [("config2", 2, 12),
                                         ("config2", 3, 12),
                                         ("wide", 2, 8), ("wide", 3, 24)])
def test_plan_halo_equal_jax(clip_dbs, kind, num, io):
    """One graph over one clip, planned by each package: `_plan_halo`
    gives the same exchange extents and the same dropped rows for every
    task."""
    from scanner_tpu.engine.executor import LocalExecutor as JEx
    from scanner_tpu_torch.engine.executor import LocalExecutor as TEx
    jc, tc = clip_dbs
    perf = {"jax": sj.PerfParams.manual(4, io),
            "torch": st.PerfParams.manual(4, io)}
    ji, jj = JEx(jc._db).prepare(
        [_halo_graph(jc, sj, kind)], perf["jax"], sj.CacheMode.Overwrite)
    ti, tj = TEx(tc._db).prepare(
        [_halo_graph(tc, st, kind)], perf["torch"], st.CacheMode.Overwrite)
    assert [j.tasks for j in jj] == [j.tasks for j in tj]
    planned = 0
    for jjob, tjob in zip(jj, tj):
        for t, (s, e) in enumerate(jjob.tasks):
            jp = jgang._plan_halo(ji, jjob, t, num, int(s), int(e))
            tp = tgang._plan_halo(ti, tjob, t, num, int(s), int(e))
            assert len(jp) == len(tp)
            for (jn, jv), (tn, tv) in zip(sorted(jp.items()),
                                          sorted(tp.items())):
                assert jv["need"] == tv["need"]
                assert len(jv["drops"]) == len(tv["drops"]) == num
                for a, b in zip(jv["drops"], tv["drops"]):
                    assert np.array_equal(a, b)
            planned += len(tp)
    assert planned > 0


def test_framecache_pages_scoped_by_host_shard():
    """Pages staged under one shard identity never serve another (or
    the unsharded identity), as in the JAX package."""
    import torch
    pool = tfc.FrameCache()
    old_pf = tfc._page_frames_cfg
    tfc.set_page_frames(4)
    try:
        rows = np.arange(4)
        block = torch.arange(12, dtype=torch.uint8).reshape(4, 3)
        tfc.set_host_shard("s0of2")
        assert tfc.host_shard() == "s0of2"
        p = pool.plan(None, ("db", 1), "frame", 0, "rgb", rows, 4)
        assert p.skey[0] == "s0of2" and not p.hit_mask.any()
        pool._offer_block(p, rows, block, (1, 3))
        p.lease.release()
        warm = pool.plan(None, ("db", 1), "frame", 0, "rgb", rows, 4)
        assert warm.hit_mask.all(), "page never completed"
        warm.lease.release()
        tfc.set_host_shard("s1of2")
        other = pool.plan(None, ("db", 1), "frame", 0, "rgb", rows, 4)
        assert not other.hit_mask.any()
        other.lease.release()
        tfc.set_host_shard(None)
        plain = pool.plan(None, ("db", 1), "frame", 0, "rgb", rows, 4)
        assert plain.skey == (("db", 1), "frame", 0, "rgb")
        assert not plain.hit_mask.any()
        plain.lease.release()
    finally:
        tfc.set_page_frames(old_pf)


def test_config_gates_and_metric_series_equal_jax():
    assert tgang.CONFIG_KEYS == jgang.CONFIG_KEYS
    assert tgang.GANG_PHASE_SERIES == jgang.GANG_PHASE_SERIES
    assert tgang.GANG_SHARD_SERIES == jgang.GANG_SHARD_SERIES
    old = (tgang.sharded_enabled(), tgang.halo_enabled(),
           tgang.init_timeout_s(), tgang.form_timeout_s())
    try:
        tgang.set_sharded(False)
        tgang.set_halo(False)
        tgang.set_init_timeout_s(0.1)
        tgang.set_form_timeout_s(0.0)
        assert not tgang.sharded_enabled() and not tgang.halo_enabled()
        # the same clamps as the JAX setters
        assert tgang.init_timeout_s() == 1.0
        assert tgang.form_timeout_s() == 0.05
    finally:
        tgang.set_sharded(old[0])
        tgang.set_halo(old[1])
        tgang.set_init_timeout_s(old[2])
        tgang.set_form_timeout_s(old[3])
    assert tgang.member_timeout_s(0) is None
    assert tgang.member_timeout_s(10) == jgang.member_timeout_s(10) \
        or tgang.init_timeout_s() != jgang.init_timeout_s()
    # a scrape of a port worker shows every gang series the JAX package
    # declares (both register them at import of engine/gang.py)
    names = {m.name for m in jmx.registry().metrics()
             if m.name.startswith("scanner_tpu_gang_")}
    assert len(names) == 11
    assert names <= {m.name for m in tmx.registry().metrics()}


# ---------------------------------------------------------------------------
# the member's loud failures
# ---------------------------------------------------------------------------

def _member_req(**kw):
    req = {"process_id": 1, "num_processes": 2, "gang_id": 0, "epoch": 1,
           "coordinator": f"127.0.0.1:{_free_port()}", "init_timeout": 1,
           "device": "cpu"}
    req.update(kw)
    return req


def test_member_without_its_card_fails_loudly():
    """A "cuda" worker's member on a host without a card raises at its
    device: it never rendezvouses and never evaluates on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    res = tgang.run_member(_member_req(device="cuda:0"))
    assert res["ok"] is False and res["stage"] == "device"
    assert "CUDA" in res["error"] and not tdist.is_initialized()


def test_failed_rendezvous_is_transient_never_a_one_host_gang(tmp_path):
    """Nobody serves the coordinator: the member gives up after its
    init_timeout with stage "rendezvous", transient, and the child's
    exit code says it failed."""
    t0 = time.time()
    res = tgang.run_member(_member_req())
    assert time.time() - t0 < 20
    assert res["ok"] is False and res["stage"] == "rendezvous"
    assert res["transient"] is True and "ready_at" in res
    assert not tdist.is_initialized()
    req, out = str(tmp_path / "req.bin"), str(tmp_path / "res.bin")
    with open(req, "wb") as fh:
        fh.write(cloudpickle.dumps(_member_req()))
    assert tgang.main([req, out]) == 3
    with open(out, "rb") as fh:
        assert cloudpickle.loads(fh.read())["stage"] == "rendezvous"


def test_spawn_member_rendezvous_fault_and_gloo_interface():
    tfaults.install("gang.rendezvous:raise:n=1:times=1")
    res = tgang.spawn_member(_member_req())
    assert res["stage"] == "rendezvous" and res["transient"]
    assert tfaults.fired("gang.rendezvous") == 1
    # a loopback coordinator binds gloo to the loopback interface
    assert tgang.gloo_interface("127.0.0.1:1234") == "lo"
    assert tgang.gloo_interface("localhost:1234") == "lo"
    assert tgang.BACKEND == "gloo"


# ---------------------------------------------------------------------------
# in-process master units (the JAX package's tests/test_gang.py)
# ---------------------------------------------------------------------------

def _seed_db(tmp_path, name="db"):
    db_path = str(tmp_path / name)
    sc = st.Client(db_path=db_path, device="cpu")
    sc.new_table("gang_src", ["output"],
                 [[_pk(100 + i)] for i in range(N_ROWS)])
    return sc, db_path


def _spec_blob(sc, out_name, gang_hosts=2, io=4, **perf_kw):
    col = sc.io.Input([st.NamedStream(sc, "gang_src")])
    col = sc.ops.TorchGangDouble(x=col)
    node = sc.io.Output(col, [st.NamedStream(sc, out_name)])
    return cloudpickle.dumps({
        "outputs": [node],
        "perf": st.PerfParams.manual(2, io, gang_hosts=gang_hosts,
                                     **perf_kw),
        "cache_mode": st.CacheMode.Overwrite.value})


def _register(master, n, base_port=7100):
    return [master._rpc_register_worker(
        {"address": "", "gang_address": f"localhost:{base_port + i}"}
    )["worker_id"] for i in range(n)]


def _form(master, bid, wids):
    """Pull until a gang forms; returns {wid: role} for every member."""
    roles = {}
    deadline = time.time() + 10
    while time.time() < deadline and len(roles) < len(wids):
        for wid in wids:
            r = master._rpc_next_work({"worker_id": wid, "bulk_id": bid})
            if r.get("status") == "gang":
                roles[wid] = r
        if not roles:
            time.sleep(0.02)
    assert roles, "no gang formed"
    return roles


@pytest.fixture()
def master(tmp_path):
    sc, db_path = _seed_db(tmp_path)
    m = Master(db_path=db_path, no_workers_timeout=60.0)
    yield sc, m
    m.stop()
    sc.stop()


def _coords(roles, w0, w1):
    m0 = w0 if roles[w0]["process_id"] == 0 else w1
    return m0, (w1 if m0 == w0 else w0)


def test_gang_formation_roles_and_coordinator(master):
    sc, m = master
    w0, w1 = _register(m, 2)
    bid = m._rpc_new_job({"spec": _spec_blob(sc, "g_form"),
                          "token": "t"})["bulk_id"]
    r0 = m._rpc_next_work({"worker_id": w0, "bulk_id": bid})
    assert r0["status"] == "wait"
    formed0 = _counter("scanner_tpu_gang_formed_total")
    roles = _form(m, bid, [w0, w1])
    a, b = roles[w0], roles[w1]
    assert a["gang_id"] == b["gang_id"] and a["epoch"] == b["epoch"]
    assert {a["process_id"], b["process_id"]} == {0, 1}
    assert a["num_processes"] == 2
    m0, _ = _coords(roles, w0, w1)
    with m._lock:
        g = m._bulk.gangs[a["gang_id"]]
        assert g.members[0] == m0
        assert a["coordinator"] == m._workers[m0].gang_address
    assert a["traceparent"] == b["traceparent"]
    assert a["sharded"] is True and a["halo"] is True
    assert _counter("scanner_tpu_gang_formed_total") == formed0 + 1
    panel = m._statusz()["gang"]
    assert panel["gang_hosts"] == 2 and len(panel["live"]) == 1


def test_form_timeout_forms_smaller_gang(master):
    sc, m = master
    old = tgang.form_timeout_s()
    tgang.set_form_timeout_s(0.05)
    try:
        (w0,) = _register(m, 1)
        bid = m._rpc_new_job({"spec": _spec_blob(sc, "g_small",
                                                 gang_hosts=3),
                              "token": "t"})["bulk_id"]
        assert m._rpc_next_work({"worker_id": w0,
                                 "bulk_id": bid})["status"] == "wait"
        time.sleep(0.1)
        r = m._rpc_next_work({"worker_id": w0, "bulk_id": bid})
        assert r["status"] == "gang", r
        assert r["num_processes"] == 1 and r["process_id"] == 0
        # a singleton gang has nothing to shard
        assert r["sharded"] is False
    finally:
        tgang.set_form_timeout_s(old)


def test_stale_epoch_nack_master_side(master):
    sc, m = master
    w0, w1 = _register(m, 2)
    bid = m._rpc_new_job({"spec": _spec_blob(sc, "g_nack"),
                          "token": "t"})["bulk_id"]
    roles = _form(m, bid, [w0, w1])
    r = roles[w0]
    m0, m1 = _coords(roles, w0, w1)
    base = dict(bulk_id=bid, gang_id=r["gang_id"], job_idx=r["job_idx"],
                task_idx=r["task_idx"], attempt=r["attempt"])
    nacks0 = _counter("scanner_tpu_gang_stale_nacks_total")
    stale = dict(base, epoch=r["epoch"] - 1)
    assert m._rpc_gang_member_done(dict(stale, worker_id=m1)
                                   ).get("gang_stale")
    assert m._rpc_gang_failed(dict(stale, worker_id=m1, transient=True)
                              ).get("gang_stale")
    assert m._rpc_finished_work(dict(stale, worker_id=m0)
                                ).get("gang_stale")
    assert m._rpc_finished_work(dict(base, epoch=r["epoch"],
                                     worker_id=m1)).get("gang_stale")
    assert _counter("scanner_tpu_gang_stale_nacks_total") >= nacks0 + 4
    with m._lock:
        assert not m._bulk.done and r["gang_id"] in m._bulk.gangs
    assert m._rpc_finished_work(dict(base, epoch=r["epoch"],
                                     worker_id=m0)) == {"ok": True}
    assert m._rpc_gang_member_done(dict(base, epoch=r["epoch"],
                                        worker_id=m1)) == {"ok": True}
    with m._lock:
        assert (r["job_idx"], r["task_idx"]) in m._bulk.done
        assert not m._bulk.held


def test_stale_master_gang_assignment_nacked_worker_side(tmp_path):
    sc, db_path = _seed_db(tmp_path)
    sc.stop()
    master = Master(db_path=db_path, no_workers_timeout=60.0)
    worker = Worker(f"localhost:{master.port}", db_path=db_path,
                    device="cpu")
    try:
        gen = master.generation
        orig = worker.master.try_call

        def fake(method, timeout=None, retries=None, **kw):
            if method == "Heartbeat":
                return {"reregister": False, "active_bulk": 7,
                        "generation": gen + 1}
            if method == "NextWork":
                return {"status": "gang", "gang_id": 0, "epoch": 1,
                        "process_id": 0, "num_processes": 2,
                        "coordinator": "localhost:1", "job_idx": 0,
                        "task_idx": 0, "attempt": 0, "generation": gen}
            return orig(method, timeout=timeout, retries=retries, **kw)

        worker.master.try_call = fake
        deadline = time.time() + 10
        while time.time() < deadline and worker._gen.highest() <= gen:
            time.sleep(0.05)
        base = _counter("scanner_tpu_stale_master_rejections_total",
                        side="worker")
        worker._hb_reply = {"active_bulk": 7, "generation": gen + 1}
        assert worker._next_gang(7) == "wait"
        assert _counter("scanner_tpu_stale_master_rejections_total",
                        side="worker") > base
        assert worker._gang_address.startswith("localhost:")
    finally:
        worker.stop()
        master.stop()


def test_gang_failed_aborts_and_reforms_at_higher_epoch(master):
    sc, m = master
    w0, w1 = _register(m, 2)
    bid = m._rpc_new_job({"spec": _spec_blob(sc, "g_reform"),
                          "token": "t"})["bulk_id"]
    r = _form(m, bid, [w0, w1])[w0]
    strikes0 = _counter("scanner_tpu_blacklist_strikes_total")
    aborted0 = _counter("scanner_tpu_gang_aborted_total",
                        reason="member_failed:collective")
    assert m._rpc_gang_failed({
        "worker_id": w1, "bulk_id": bid, "gang_id": r["gang_id"],
        "epoch": r["epoch"], "stage": "collective", "transient": True,
        "error": "peer lost"}) == {"ok": True}
    with m._lock:
        b = m._bulk
        assert not b.gangs and not b.outstanding and not b.held
        assert b.gang_epoch == r["epoch"] + 1
    assert _counter("scanner_tpu_gang_aborted_total",
                    reason="member_failed:collective") == aborted0 + 1
    assert _counter("scanner_tpu_blacklist_strikes_total") == strikes0
    reforms0 = _counter("scanner_tpu_gang_reforms_total")
    r2 = next(iter(_form(m, bid, [w0, w1]).values()))
    assert r2["epoch"] > r["epoch"]
    assert _counter("scanner_tpu_gang_reforms_total") == reforms0 + 1


def test_fenced_master_preemption_keeps_gang(master):
    sc, m = master
    w0, w1 = _register(m, 2)
    bid = m._rpc_new_job({"spec": _spec_blob(sc, "g_fence_pre"),
                          "token": "t"})["bulk_id"]
    r = _form(m, bid, [w0, w1])[w0]
    aborted0 = _counter("scanner_tpu_gang_aborted_total",
                        reason="preempted")
    m._fence.set()
    m._rpc_heartbeat({"worker_id": w1, "preempting": True})
    with m._lock:
        assert m._workers[w1].preempting
        assert m._bulk.gangs and m._bulk.gang_epoch == r["epoch"]
    assert _counter("scanner_tpu_gang_aborted_total",
                    reason="preempted") == aborted0


def test_preemption_notice_aborts_member_gang(master):
    sc, m = master
    w0, w1 = _register(m, 2)
    bid = m._rpc_new_job({"spec": _spec_blob(sc, "g_preempt"),
                          "token": "t"})["bulk_id"]
    r = _form(m, bid, [w0, w1])[w0]
    hb = m._rpc_heartbeat({"worker_id": w1, "preempting": True})
    assert hb.get("gangs") == []
    with m._lock:
        assert not m._bulk.gangs
        assert m._bulk.gang_epoch == r["epoch"] + 1
    assert _counter("scanner_tpu_gang_aborted_total",
                    reason="preempted") >= 1


def test_worker_loss_aborts_member_gang(master):
    sc, m = master
    w0, w1 = _register(m, 2)
    bid = m._rpc_new_job({"spec": _spec_blob(sc, "g_loss"),
                          "token": "t"})["bulk_id"]
    roles = _form(m, bid, [w0, w1])
    r = roles[w0]
    _, m1 = _coords(roles, w0, w1)
    with m._lock:
        m._workers[m1].active = False
        m._requeue_worker_tasks(m1)
        b = m._bulk
        assert not b.gangs and b.gang_epoch == r["epoch"] + 1
        assert b.q_has_work() and not b.outstanding and not b.held
    assert _counter("scanner_tpu_gang_aborted_total",
                    reason="member_lost") >= 1


def test_gang_task_timeout_aborts_whole_gang(master):
    sc, m = master
    w0, w1 = _register(m, 2)
    bid = m._rpc_new_job({"spec": _spec_blob(sc, "g_tmo",
                                             task_timeout=0.6),
                          "token": "t"})["bulk_id"]
    r = _form(m, bid, [w0, w1])[w0]
    deadline = time.time() + 10
    while time.time() < deadline:
        with m._lock:
            if not m._bulk.gangs:
                break
        time.sleep(0.1)
    with m._lock:
        assert not m._bulk.gangs, "timeout scan never aborted"
        assert m._bulk.gang_epoch >= r["epoch"] + 1
    assert _counter("scanner_tpu_gang_aborted_total",
                    reason="timeout") >= 1


def test_gang_abort_cap_terminates_bulk(master):
    sc, m = master
    old = tgang.form_timeout_s()
    tgang.set_form_timeout_s(0.01)
    try:
        (w0,) = _register(m, 1)
        bid = m._rpc_new_job({"spec": _spec_blob(sc, "g_cap",
                                                 gang_hosts=1),
                              "token": "t"})["bulk_id"]
        for _ in range(MAX_TRANSIENT_FAILURES + MAX_TASK_FAILURES + 2):
            r = None
            deadline = time.time() + 5
            while r is None and time.time() < deadline:
                got = m._rpc_next_work({"worker_id": w0, "bulk_id": bid})
                if got.get("status") == "gang":
                    r = got
                elif got.get("status") in ("none", "done"):
                    r = "over"
                else:
                    time.sleep(0.01)
            if r == "over" or r is None:
                break
            m._rpc_gang_failed({
                "worker_id": w0, "bulk_id": bid, "gang_id": r["gang_id"],
                "epoch": r["epoch"], "stage": "rendezvous",
                "transient": True, "error": "never forms"})
        with m._lock:
            b = m._bulk
            assert b.finished and b.blacklisted_jobs == {0}
            assert "exhausted" in b.error
    finally:
        tgang.set_form_timeout_s(old)


def test_gang_journal_roundtrip_and_failover_no_double_commit(tmp_path):
    sc, db_path = _seed_db(tmp_path)
    m1 = Master(db_path=db_path, no_workers_timeout=60.0)
    w0, w1 = _register(m1, 2)
    bid = m1._rpc_new_job({"spec": _spec_blob(sc, "g_fo"),
                           "token": "tok-G"})["bulk_id"]
    roles = _form(m1, bid, [w0, w1])
    ra = roles[w0]
    m0a, _ = _coords(roles, w0, w1)
    assert m1._rpc_finished_work({
        "worker_id": m0a, "bulk_id": bid, "gang_id": ra["gang_id"],
        "epoch": ra["epoch"], "job_idx": ra["job_idx"],
        "task_idx": ra["task_idx"],
        "attempt": ra["attempt"]}) == {"ok": True}
    roles_b = _form(m1, bid, [w0, w1])
    rb = roles_b[w0]
    m0b, _ = _coords(roles_b, w0, w1)
    m1.stop()  # abrupt: no checkpoint clear
    m2 = Master(db_path=db_path, no_workers_timeout=60.0)
    try:
        with m2._lock:
            b = m2._bulk
            assert b is not None and b.bulk_id == bid
            assert b.gang_hosts == 2
            assert (ra["job_idx"], ra["task_idx"]) in b.done
            assert (rb["job_idx"], rb["task_idx"]) not in b.done
            assert b.q_has_work() and b.gang_epoch >= rb["epoch"]
            done0 = len(b.done)
        late = m2._rpc_finished_work({
            "worker_id": m0b, "bulk_id": bid, "gang_id": rb["gang_id"],
            "epoch": rb["epoch"], "job_idx": rb["job_idx"],
            "task_idx": rb["task_idx"], "attempt": rb["attempt"]})
        assert late.get("gang_stale"), late
        with m2._lock:
            assert len(m2._bulk.done) == done0, "double-commit!"
        v0, v1 = _register(m2, 2)
        roles_c = _form(m2, bid, [v0, v1])
        rc = roles_c[v0]
        assert rc["epoch"] > rb["epoch"]
        m0c, _ = _coords(roles_c, v0, v1)
        assert m2._rpc_finished_work({
            "worker_id": m0c, "bulk_id": bid, "gang_id": rc["gang_id"],
            "epoch": rc["epoch"], "job_idx": rc["job_idx"],
            "task_idx": rc["task_idx"],
            "attempt": rc["attempt"]}) == {"ok": True}
        with m2._lock:
            assert len(m2._bulk.done) == done0 + 1
    finally:
        m2.stop()
        sc.stop()


# -- the JAX package's tests/test_gang_sharded.py master units ---------------

def test_role_reply_carries_master_decided_mode(tmp_path):
    """PerfParams.gang_sharded=False and the master's [gang] sharded
    gate each turn sharding off, on the role reply every member reads."""
    old = tgang.sharded_enabled()
    try:
        for name, gate, perf_kw in (("perf", True, {"gang_sharded": False}),
                                    ("gate", False, {})):
            tgang.set_sharded(gate)
            sc, db_path = _seed_db(tmp_path, f"db_{name}")
            m = Master(db_path=db_path, no_workers_timeout=60.0)
            try:
                w0, w1 = _register(m, 2)
                bid = m._rpc_new_job({"spec": _spec_blob(
                    sc, f"mode_{name}", **perf_kw), "token": name}
                )["bulk_id"]
                roles = _form(m, bid, [w0, w1])
                assert all(r["sharded"] is False for r in roles.values())
            finally:
                m.stop()
                sc.stop()
    finally:
        tgang.set_sharded(old)


def test_shard_commit_fold_ok_mismatch_partial(master):
    sc, m = master
    w0, w1 = _register(m, 2)
    # io=2 over 8 rows -> 4 tasks -> 4 gangs; a fifth scenario re-forms
    bid = m._rpc_new_job({"spec": _spec_blob(sc, "fold", io=2),
                          "token": "t"})["bulk_id"]
    strikes0 = _counter("scanner_tpu_blacklist_strikes_total")

    def run_gang(ack, digest, shard_digests):
        roles = _form(m, bid, [w0, w1])
        r = next(iter(roles.values()))
        m0, m1 = _coords(roles, w0, w1)
        base = dict(bulk_id=bid, gang_id=r["gang_id"], epoch=r["epoch"],
                    job_idx=r["job_idx"], task_idx=r["task_idx"],
                    attempt=r["attempt"])
        if ack is not None:
            assert m._rpc_gang_member_done(
                dict(base, worker_id=m1, shard_digest=ack))["ok"]
        assert m._rpc_finished_work(
            dict(base, worker_id=m0, digest=digest,
                 shard_digests=shard_digests)) == {"ok": True}

    def fold(result):
        return _counter("scanner_tpu_gang_shard_commit_folds_total",
                        result=result)

    ok0, mis0, par0 = fold("ok"), fold("mismatch"), fold("partial")
    run_gang(7, 12, [5, 7])
    assert fold("ok") == ok0 + 1
    run_gang(None, 12, [5, 8])
    assert fold("mismatch") == mis0 + 1
    run_gang(9, 12, [5, 7])
    assert fold("mismatch") == mis0 + 2
    run_gang(None, 12, [12])
    assert fold("partial") == par0 + 1
    assert _counter("scanner_tpu_blacklist_strikes_total") == strikes0


# ---------------------------------------------------------------------------
# journal cross-replay of gang records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_gang_records_cross_replay_to_same_high_water(writer):
    """A journal of gang formations and aborts written by one package
    replays in the other to the same records and the same epoch high
    water (the floor a recovering master mints above)."""
    recs = [{"t": "admit", "b": 3},
            {"t": "gang", "g": 0, "e": 1, "j": 0, "k": 0,
             "members": [0, 1]},
            {"t": "done", "j": 0, "k": 0},
            {"t": "gang", "g": 1, "e": 2, "j": 0, "k": 1,
             "members": [1, 0]},
            {"t": "gang_abort", "g": 1, "e": 2},
            {"t": "gang", "g": 2, "e": 4, "j": 0, "k": 1,
             "members": [0]}]
    pk = {"jax": (jjournal, JMemory), "torch": (tjournal, TMemory)}
    wmod, wstore = pk[writer]
    rmod = pk["torch" if writer == "jax" else "jax"][0]
    backend = wstore()
    j = wmod.BulkJournal(backend, generation=3, rotate=4)
    for r in recs:
        j.append(r)
    got, stats = rmod.replay(backend, 3)
    assert got == recs and stats["corrupt"] == 0
    assert rmod.gang_epoch_high_water(got) == \
        wmod.gang_epoch_high_water(recs) == 4


# ---------------------------------------------------------------------------
# the collectives over two and three gloo ranks
# ---------------------------------------------------------------------------

CASES = np.array([(1, 1), (2, 0), (0, 2), (2, 1), (1, 2)], np.int64)


def _jax_halos(x, world, lo, hi):
    """The JAX package's `_halo_exchange_block` under shard_map over a
    CPU mesh of `world` devices, as its tests/test_parallel.py runs it:
    each shard's padded block (lo + chunk + hi rows)."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from scanner_tpu.parallel.halo import _halo_exchange_block
    from scanner_tpu.util.jaxenv import shard_map
    mesh = jmesh.make_mesh({"sp": world, "dp": 1, "tp": 1},
                           devices=jax.devices()[:world])
    f = shard_map(functools.partial(_halo_exchange_block, lo=lo, hi=hi,
                                    axis_name="sp"),
                  mesh=mesh, in_specs=P("sp"), out_specs=P("sp"))
    out = np.asarray(jax.jit(f)(jnp.asarray(x)))
    return np.split(out, world)


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_over_gloo_ranks_equal_jax(tmp_path, world):
    chunk = 3
    rng = np.random.RandomState(world)
    x = rng.randint(0, 256, (world * chunk, 2, 3)).astype(np.float32)
    digests = rng.randint(0, 2 ** 32, world).astype(np.int64)
    src = str(tmp_path / "in.npz")
    np.savez(src, x=x, cases=CASES, digests=digests)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "torch_gang_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(world), str(port), src,
         str(tmp_path / f"out{r}.npz")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [np.load(str(tmp_path / f"out{r}.npz")) for r in range(world)]
    for lo, hi in CASES:
        want = _jax_halos(x, world, int(lo), int(hi))
        for r in range(world):
            got = np.concatenate([outs[r][f"left_{lo}_{hi}"],
                                  x[r * chunk:(r + 1) * chunk],
                                  outs[r][f"right_{lo}_{hi}"]])
            assert np.array_equal(got, want[r]), (lo, hi, r)
    blobs = b"".join(bytes([r]) * (r + 1) for r in range(world))
    for r in range(world):
        assert np.array_equal(outs[r]["gathered"], x[:-1])
        assert int(outs[r]["digest"]) == int(digests.sum()) & 0xFFFFFFFF
        assert outs[r]["blobs"].tobytes() == blobs
