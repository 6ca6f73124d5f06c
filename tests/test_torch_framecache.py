"""The paged frame cache of the port (scanner_tpu_torch/engine/
framecache.py) held against the JAX package's
(scanner_tpu/engine/framecache.py).

Unit cases: the cases of tests/test_framecache.py, each driven through
a private FrameCache of both packages — CPU tensors in the port, JAX CPU
arrays in the reference — on the same seeded rows; the miss rows, the
page keys in LRU order, the status panels and the assembled bytes must
be equal exactly.

End to end: stencil (HistDiff, stencil [-1, 0]), Gather and
null-interleaved jobs over a synthesized clip through
`LocalExecutor(..., torch.device("cpu"), stage=True)` — the tensor path
the card takes, which is the one the cache serves.  With the cache on
(cold, then warm) and off the stored rows must be bit-identical and
equal to the JAX package's rows, the warm run must hit, and no pin may
outlive the jobs.
"""

import gc

import numpy as np
import pytest
import torch

import scanner_tpu as sj
import scanner_tpu.kernels  # noqa: F401
from scanner_tpu import video as scv
from scanner_tpu.engine import framecache as jfc

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.engine import framecache as tfc
from scanner_tpu_torch.engine.executor import LocalExecutor
from scanner_tpu_torch.util import metrics as tmx
from scanner_tpu_torch.util.profiler import Profiler
from torch_model_checks import stop_process_engine  # noqa: F401

N_FRAMES, W, H = 48, 64, 48


@pytest.fixture(autouse=True, scope="module")
def _release_jax_frame_cache():
    """Clear the JAX package's frame cache after this file: its pages
    are live entries of the JAX allocation ledger, which a later file in
    the same worker process reads (tests/test_memstats.py)."""
    yield
    jfc.cache().clear()
    gc.collect()


@pytest.fixture(autouse=True)
def _cache_state():
    saved = [(m, m._ENABLED, m._capacity_mb, m._page_frames_cfg)
             for m in (jfc, tfc)]
    yield
    for m, en, cap, pf in saved:
        m._ENABLED, m._capacity_mb, m._page_frames_cfg = en, cap, pf
        if m._CACHE is not None:
            m._CACHE.clear()


def _rowdata(rows, shape=(2, 2, 3)):
    out = np.zeros((len(rows),) + shape, np.uint8)
    for i, r in enumerate(rows):
        out[i].fill(r % 251)
    return out


class _Probe:
    """Drives one package's FrameCache and records what it shows."""

    def __init__(self, fc):
        self.fc = fc
        self.c = fc.FrameCache()
        self.log = []

    def plan(self, rows, total=64, keyint=0, table=("db", 1)):
        p = self.c.plan(None, table, "frame", 0, "rgb24",
                        np.asarray(rows, np.int64), total_rows=total,
                        keyint=keyint)
        self.log.append(("plan", p.page_frames, p.miss_rows.tolist(),
                         p.hit_mask.tolist()))
        return p

    def assemble(self, p, fresh_rows=None, data=None):
        if fresh_rows is None:
            fresh_rows = p.miss_rows
            data = _rowdata(p.miss_rows)
        out = self.c.assemble(p, np.asarray(fresh_rows, np.int64), data)
        arr = out.numpy() if isinstance(out, torch.Tensor) \
            else np.asarray(out)
        self.log.append(("assemble", arr.shape, arr.tobytes()))
        return arr

    def snap(self):
        self.log.append(("pages", [k[1:] + (k[0],)
                                   for k in self.c._pages.keys()]))
        self.log.append(("status", self.c.status_dict()))


def _case_roundtrip(pr):
    pr.fc.set_page_frames(4)
    p = pr.plan(np.arange(8), total=10)
    pr.assemble(p)
    p.lease.release()
    p2 = pr.plan([1, 2, 5, 7], total=10)
    pr.assemble(p2, [], np.zeros((0, 1), np.uint8))
    p2.lease.release()
    pr.snap()


def _case_partial_offers(pr):
    pr.fc.set_page_frames(8)
    ps = [pr.plan(np.arange(0, 4), total=16)]
    pr.assemble(ps[-1])
    pr.snap()
    ps.append(pr.plan(np.arange(4, 8), total=16))
    pr.assemble(ps[-1])
    pr.snap()
    ps.append(pr.plan(np.arange(8), total=16))
    pr.assemble(ps[-1], [], np.zeros((0, 1), np.uint8))
    for p in ps:
        p.lease.release()
    pr.snap()


def _case_tail_page(pr):
    pr.fc.set_page_frames(8)
    p = pr.plan(np.arange(8, 13), total=13)
    pr.assemble(p)
    p.lease.release()
    pr.plan([12], total=13).lease.release()
    pr.snap()


def _case_lru(pr):
    pr.fc.set_page_frames(4)
    pr.c._target["default"] = 4 * 2 * 2 * 3 * 2
    for base in (0, 4, 8):
        p = pr.plan(np.arange(base, base + 4), total=16)
        pr.assemble(p)
        p.lease.release()
        pr.snap()
    pr.plan(np.arange(0, 12), total=16).lease.release()
    pr.plan(np.arange(4, 8), total=16).lease.release()
    p = pr.plan(np.arange(12, 16), total=16)
    pr.assemble(p)
    p.lease.release()
    pr.plan(np.arange(4, 12), total=16).lease.release()
    pr.snap()


def _case_pinned(pr):
    pr.fc.set_page_frames(4)
    pr.c._target["default"] = 4 * 2 * 2 * 3
    p1 = pr.plan(np.arange(4), total=16)
    pr.assemble(p1)
    p2 = pr.plan(np.arange(4, 8), total=16)
    pr.assemble(p2)
    pr.plan(np.arange(4), total=16).lease.release()
    pr.snap()
    p1.lease.release()
    p2.lease.release()
    p1.lease.release()
    p3 = pr.plan(np.arange(8, 12), total=16)
    pr.assemble(p3)
    p3.lease.release()
    pr.snap()


def _case_pressure_shrink(pr):
    pr.fc.set_page_frames(4)
    for base in range(0, 16, 4):
        p = pr.plan(np.arange(base, base + 4), total=16)
        pr.assemble(p)
        p.lease.release()
    pr.log.append(("shrink", pr.c.pressure_shrink("default")))
    pr.snap()
    pr.c._live["default"] = pr.fc.MIN_CAPACITY_BYTES * 4
    pr.c._target["default"] = pr.fc.MIN_CAPACITY_BYTES * 4
    pr.log.append(("shrink", pr.c.pressure_shrink("default")))
    pr.snap()


def _case_fill_fragments(pr):
    pr.fc.set_page_frames(8)
    pr.c._target["default"] = 8 * 2 * 2 * 3
    for base in range(0, 64, 8):
        p = pr.plan(np.arange(base, base + 4), total=64)
        pr.assemble(p)
        p.lease.release()
    pr.snap()
    p = pr.plan(np.arange(0, 8), total=64)
    pr.assemble(p)
    p.lease.release()
    pr.snap()


def _case_redirect(pr):
    pr.fc.set_page_frames(4)
    for base in (0, 4):
        p = pr.plan(np.arange(base, base + 4), total=8)
        pr.assemble(p)
        p.lease.release()
    pr.log.append(("shrink", pr.c.pressure_shrink("cuda:0")))
    pr.snap()


def _case_page_size(pr):
    pr.plan([0], keyint=12)
    pr.plan([0], keyint=32, table=("db", 2))
    pr.plan([0], keyint=0, table=("db", 3))
    pr.fc.set_page_frames(8)
    pr.plan([0], keyint=12, table=("db", 4))
    pr.snap()


def _case_gather_and_mixed(pr):
    """Sparse rows over resident pages and fresh rows in one assemble:
    the gather (index tensor on the page's device) and the staged runs
    interleave in row order."""
    pr.fc.set_page_frames(4)
    p = pr.plan(np.arange(0, 8), total=32)
    pr.assemble(p)
    p.lease.release()
    p = pr.plan([1, 3, 6, 9, 10, 17, 22], total=32)
    pr.assemble(p)
    p.lease.release()
    pr.snap()


CASES = [_case_roundtrip, _case_partial_offers, _case_tail_page, _case_lru,
         _case_pinned, _case_pressure_shrink, _case_fill_fragments,
         _case_redirect, _case_page_size, _case_gather_and_mixed]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[6:])
def test_unit_case_matches_jax(case):
    got, want = _Probe(tfc), _Probe(jfc)
    case(got)
    case(want)
    assert len(got.log) == len(want.log) > 0
    for a, b in zip(got.log, want.log):
        assert a == b


def test_pages_own_their_storage():
    """A page built from a fragment of a staged block is not a view of
    the block: the block can be freed, and the ledger bills the page's
    own bytes."""
    tfc.set_page_frames(4)
    c = tfc.FrameCache()
    p = c.plan(None, ("db", 9), "frame", 0, "rgb24", np.arange(0, 6),
               total_rows=16)
    c.assemble(p, p.miss_rows, _rowdata(range(6)))
    p.lease.release()
    page = next(iter(c._pages.values()))
    assert page.data._base is None
    assert page.data.untyped_storage().nbytes() == page.nbytes
    for buf in c._fill.values():
        for frag, _ in buf.values():
            assert frag._base is None


def test_on_alert_filters_and_reports():
    calls = []
    orig = tfc.FrameCache.pressure_shrink
    tfc.cache()
    try:
        tfc.FrameCache.pressure_shrink = \
            lambda self, dev: calls.append(dev) or 0
        assert tfc._on_alert({"rule": "hbm_pressure", "state": "firing",
                              "labels": {"device": "cuda:3"}}) \
            == "cuda:3: 0 page(s) evicted"
        tfc._on_alert({"rule": "hbm_pressure", "state": "resolved",
                       "labels": {"device": "cuda:3"}})
        tfc._on_alert({"rule": "recompile_storm", "state": "firing",
                       "labels": {}})
        assert calls == ["cuda:3"]
    finally:
        tfc.FrameCache.pressure_shrink = orig


# ---------------------------------------------------------------------------
# end to end: the tensor path over a synthesized clip
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_framecache")
    clip = str(root / "clip.mp4")
    scv.synthesize_video(clip, num_frames=N_FRAMES, width=W, height=H,
                         fps=24, keyint=8)
    cj = sj.Client(db_path=str(root / "db_jax"))
    ct = st.Client(db_path=str(root / "db_torch"), device="cpu")
    for c in (cj, ct):
        _, failed = c.ingest_videos([("fcvid", clip)])
        assert not failed
    yield cj, ct
    cj.stop()
    ct.stop()


def _hits() -> float:
    entry = tmx.registry().snapshot().get(
        "scanner_tpu_framecache_hits_total", {})
    return sum(s["value"] for s in entry.get("samples", []))


def _stored(db, table):
    return list(db.load_column(table, db.table_descriptor(table)
                               .columns[0].name))


def _dense(sc, frames):
    return sc.ops.Histogram(frame=frames)


def _stencil(sc, frames):
    return sc.ops.HistDiff(frame=frames)


def _gather(sc, frames):
    return sc.ops.Histogram(
        frame=sc.streams.Gather(frames, [[0, 3, 9, 17, 18, 33, 47]]))


def _nulls(sc, frames):
    spaced = sc.streams.RepeatNull(sc.streams.Range(frames, [(0, 16)]),
                                   [2])
    return sc.ops.Histogram(frame=spaced)


def _graph(sc, pkg, build, name):
    frames = sc.io.Input([pkg.NamedVideoStream(sc, "fcvid")])
    return sc.io.Output(build(sc, frames), [pkg.NamedStream(sc, name)])


def _run_torch(ct, build, name, wp=4, io=8):
    ex = LocalExecutor(ct._db, Profiler(), torch.device("cpu"), stage=True)
    ex.run([_graph(ct, st, build, name)], st.PerfParams.manual(wp, io),
           cache_mode=st.CacheMode.Overwrite)
    return _stored(ct._db, name)


def _run_jax(cj, build, name, monkeypatch, wp=4, io=8):
    with monkeypatch.context() as m:
        m.setenv("SCANNER_TPU_YUV_DEVICE", "force")
        cj.run(_graph(cj, sj, build, name), sj.PerfParams.manual(wp, io),
               cache_mode=sj.CacheMode.Overwrite, show_progress=False)
    return _stored(cj._db, name)


def _ab(ct, build, tag):
    """Cache on twice (cold, warm) and off; returns the three row lists
    and the (cold, warm) hit counts."""
    tfc.set_enabled(True)
    h0 = _hits()
    cold = _run_torch(ct, build, f"{tag}_on1")
    h1 = _hits()
    warm = _run_torch(ct, build, f"{tag}_on2")
    h2 = _hits()
    tfc.set_enabled(False)
    off = _run_torch(ct, build, f"{tag}_off")
    return cold, warm, off, h1 - h0, h2 - h1


def _no_pins():
    gc.collect()
    devs = tfc.cache().status_dict()["devices"]
    return all(d["pinned_bytes"] == 0 for d in devs.values()), devs


def test_stencil_serial_bit_exact_and_hits(clients, monkeypatch):
    """HistDiff's window reaches one row back into the preceding task:
    in the serial path (NO_PIPELINING, tasks in order) each task's
    back-reach row hits the page its predecessor completed, and the
    warm run serves every frame from pages."""
    cj, ct = clients
    tfc.set_page_frames(4)
    monkeypatch.setenv("SCANNER_TPU_NO_PIPELINING", "1")
    cold, warm, off, h_cold, h_warm = _ab(ct, _stencil, "sten")
    monkeypatch.delenv("SCANNER_TPU_NO_PIPELINING")
    want = _run_jax(cj, _stencil, "sten", monkeypatch)
    assert cold == warm == off == want
    assert len(want) == N_FRAMES
    assert h_warm >= N_FRAMES
    assert h_cold >= N_FRAMES // 8 - 1
    ok, devs = _no_pins()
    assert ok, devs


def test_gather_hits_hot_pages_bit_exact(clients, monkeypatch):
    cj, ct = clients
    tfc.set_page_frames(4)
    tfc.set_enabled(True)
    _run_torch(ct, _dense, "g_dense")
    h0 = _hits()
    on = _run_torch(ct, _gather, "g_on")
    hits = _hits() - h0
    tfc.set_enabled(False)
    off = _run_torch(ct, _gather, "g_off")
    want = _run_jax(cj, _gather, "g", monkeypatch)
    assert on == off == want and len(want) == 7
    assert hits == 7
    ok, devs = _no_pins()
    assert ok, devs


def test_null_interleaved_bit_exact(clients, monkeypatch):
    cj, ct = clients
    tfc.set_page_frames(4)
    cold, warm, off, _h_cold, h_warm = _ab(ct, _nulls, "nulls")
    want = _run_jax(cj, _nulls, "nulls", monkeypatch)
    assert cold == warm == off == want
    assert h_warm >= 16
    ok, devs = _no_pins()
    assert ok, devs


def test_whole_task_path_bit_exact(clients, monkeypatch):
    """io == work packet: tasks load whole (no streaming feed), through
    _load_video_cached."""
    cj, ct = clients
    tfc.set_page_frames(8)
    tfc.set_enabled(True)
    cold = _run_torch(ct, _dense, "whole_on1", wp=8, io=8)
    h0 = _hits()
    warm = _run_torch(ct, _dense, "whole_on2", wp=8, io=8)
    hits = _hits() - h0
    tfc.set_enabled(False)
    off = _run_torch(ct, _dense, "whole_off", wp=8, io=8)
    want = _run_jax(cj, _dense, "whole", monkeypatch, wp=8, io=8)
    assert cold == warm == off == want
    assert hits == N_FRAMES
    ok, devs = _no_pins()
    assert ok, devs
