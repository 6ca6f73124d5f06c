"""Whole-pipeline fusion in the port (graph/fusion.py planner +
engine/evaluate.py FusedKernelInstance), held against the JAX package.

1. **Planner** — the cases of tests/test_fusion.py, each graph built in
   both packages: the same chain ids, windows and widths.
2. **Equivalence** — the golden Resize -> Blur -> Histogram -> HistDiff
   chain over a synthesized video through the port's card path on CPU
   tensors (`LocalExecutor(..., torch.device("cpu"), stage=True)`), fused
   and staged: the two store the same rows, and those equal the JAX
   package's fused rows on the same YUV420 wire (tolerance 0: HistDiff
   rows are sums of integer counts).  The chain's frames are within the
   ROADMAP bound of one count of the JAX package's, and its Histogram
   rows the exact histogram of the port's own frames.  Also a stencil
   head, interleaved nulls and a gather-sampled stream, fused against
   staged (and against the JAX package where the rows are counts).
3. **One ladder per chain** — the kill switch restores staged metrics, a
   fused run mints signatures under the chain id only, the members stay
   silent, and the warm-up warms the chain's ladder.
"""

import gc
from typing import Sequence

import numpy as np
import pytest
import torch

import scanner_tpu as sj
import scanner_tpu.kernels  # noqa: F401  (registers the stdlib ops)
from scanner_tpu import video as scv
from scanner_tpu.engine import framecache as jfc
from scanner_tpu.graph import analysis as JA
from scanner_tpu.graph import fusion as jfusion
from scanner_tpu.graph import ops as JO
from scanner_tpu.graph.streams_dsl import IOGenerator as JIO

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.engine.evaluate import TaskEvaluator, bucket_ladder
from scanner_tpu_torch.engine.executor import LocalExecutor
from scanner_tpu_torch.graph import analysis as TA
from scanner_tpu_torch.graph import fusion as tfusion
from scanner_tpu_torch.graph import ops as TO
from scanner_tpu_torch.graph.streams_dsl import IOGenerator as TIO
from scanner_tpu_torch.util.metrics import registry
from scanner_tpu_torch.util.profiler import Profiler
from torch_model_checks import stop_process_engine  # noqa: F401

N_FRAMES = 50
W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def _release_jax_frame_cache():
    """Clear the JAX package's frame cache after this file: its pages
    are live entries of the JAX allocation ledger, which a later file in
    the same worker process reads (tests/test_memstats.py)."""
    yield
    jfc.cache().clear()
    gc.collect()


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class FakeStream:
    is_video = False

    def __init__(self, n):
        self.n = n


# -- planner fixtures, registered in both packages --------------------------

def _cost(self, shapes):
    return {"flops": 1.0, "bytes_in": 1.0, "bytes_out": 1.0}


def _identity(self, frame):
    return frame  # pragma: no cover


def _register(pkg, name, device, cost=True, **kw):
    body = {"execute": _identity}
    if cost:
        body["cost"] = _cost
    _identity.__annotations__ = {"frame": Sequence[pkg.FrameType],
                                 "return": Sequence[pkg.FrameType]}
    pkg.register_op(name=name, device=device, batch=8, **kw)(
        type(name, (pkg.Kernel,), body))


for _pkg in (sj, st):
    _register(_pkg, "TFzA", _pkg.DeviceType.TPU)
    _register(_pkg, "TFzB", _pkg.DeviceType.TPU)
    _register(_pkg, "TFzC", _pkg.DeviceType.TPU)
    _register(_pkg, "TFzHost", _pkg.DeviceType.CPU)
    _register(_pkg, "TFzState", _pkg.DeviceType.TPU, bounded_state=0)
    _register(_pkg, "TFzNoCost", _pkg.DeviceType.TPU, cost=False)

# the two packages' planner modules, with what builds a graph in each
PACKAGES = {"jax": (JIO(), JO.OpGenerator(), JA, jfusion),
            "torch": (TIO(), TO.OpGenerator(), TA, tfusion)}


def _chain(*names, **kw):
    """Input -> names[0] -> names[1] -> ... -> Output; a name "X!" is X
    with fuse=False."""
    def build(io, ops):
        col = io.Input([FakeStream(24)])
        for nm in names:
            fuse = {"fuse": False} if nm.endswith("!") else {}
            col = getattr(ops, nm.rstrip("!"))(frame=col, **fuse)
        return [io.Output(col, [FakeStream(0)])]
    return build, kw


def _external(io, ops):
    # TFzB's output is read by TFzC AND by a second Output: it
    # materializes, so the chain ends at TFzB
    a = ops.TFzA(frame=io.Input([FakeStream(24)]))
    b = ops.TFzB(frame=a)
    c = ops.TFzC(frame=b)
    return [io.Output(c, [FakeStream(0)]), io.Output(b, [FakeStream(0)])]


def _golden_graph(io, ops):
    r = ops.Resize(frame=io.Input([FakeStream(24)]), width=[32],
                   height=[24])
    b = ops.Blur(frame=r, kernel_size=3, sigma=1.0)
    return [io.Output(ops.HistDiff(frame=ops.Histogram(frame=b)),
                      [FakeStream(0)])]


def _windowed_head(io, ops):
    a = ops.TFzA(frame=io.Input([FakeStream(24)]))
    return [io.Output(ops.TFzB(frame=ops.HistDiff(frame=a)),
                      [FakeStream(0)])]


def _probe(kind):
    return {"none": lambda n: None, "compute": lambda n: "compute",
            "mixed": lambda n: "memory" if n.name == "TFzB"
            else "compute"}[kind]


# (case, graph builder, plan kwargs, expected [(chain id, windows, width)])
PLANNER_CASES = [
    ("basic", *_chain("TFzA", "TFzB", "TFzC"),
     [("TFzA+TFzB+TFzC", [0, 0, 0], 1)]),
    ("host_op", *_chain("TFzA", "TFzHost", "TFzB"), []),
    ("stateful", *_chain("TFzA", "TFzState", "TFzB"), []),
    ("fuse_false_mid", *_chain("TFzA", "TFzB!", "TFzC"), []),
    ("fuse_false_tail", *_chain("TFzA", "TFzB", "TFzC!"),
     [("TFzA+TFzB", [0, 0], 1)]),
    ("missing_cost", *_chain("TFzA", "TFzNoCost", "TFzB"), []),
    ("external_consumer", _external, {}, [("TFzA+TFzB", [0, 0], 1)]),
    ("min_chain_2", *_chain("TFzA", "TFzB"), [("TFzA+TFzB", [0, 0], 1)]),
    ("min_chain_3", *_chain("TFzA", "TFzB", min_chain=3), []),
    ("all_compute_bound", *_chain("TFzA", "TFzB", probe="compute"), []),
    ("one_memory_bound", *_chain("TFzA", "TFzB", probe="mixed"),
     [("TFzA+TFzB", [0, 0], 1)]),
    ("golden", _golden_graph, {}, [("Resize+Blur+Histogram", [0, 0, 0], 1)]),
    ("windowed_op_heads", _windowed_head, {},
     [("HistDiff+TFzB", [2, 0], 2)]),
]


@pytest.mark.parametrize("case,build,kw,want", PLANNER_CASES,
                         ids=[c[0] for c in PLANNER_CASES])
def test_planner_matches_jax(case, build, kw, want):
    got = {}
    for name, (io, ops, analysis, fusion) in PACKAGES.items():
        info = analysis.analyze(build(io, ops))
        plan_kw = dict(kw)
        plan_kw["probe"] = _probe(plan_kw.get("probe", "none"))
        chains = fusion.plan_chains(info, **plan_kw)
        got[name] = [(c.chain_id, c.windows(), c.width()) for c in chains]
    assert got["torch"] == got["jax"] == want


def test_min_chain_knob():
    old = tfusion.fusion_min_chain()
    try:
        tfusion.set_min_chain(3)
        io, ops, analysis, fusion = PACKAGES["torch"]
        build, _ = _chain("TFzA", "TFzB")
        info = analysis.analyze(build(io, ops))
        assert fusion.plan_chains(info, probe=lambda n: None) == []
        tfusion.set_min_chain(0)  # clamps to 2: a singleton IS staged
        assert tfusion.fusion_min_chain() == 2
    finally:
        tfusion.set_min_chain(old)


# ---------------------------------------------------------------------------
# equivalence over a synthesized clip
# ---------------------------------------------------------------------------

@st.register_op(device=st.DeviceType.TPU, batch=16)
class TorchFusionFrameRows(st.Kernel):
    """Hands a frame column on as rows the sink pickles (it would encode
    a frame column with H.264)."""

    def execute(self, frame: Sequence[st.FrameType]) -> Sequence[object]:
        return frame


@sj.register_op(device=sj.DeviceType.TPU, batch=16)
class JaxFusionFrameRows(sj.Kernel):
    """The JAX package's decoded frames as pickled rows."""

    def execute(self, frame: Sequence[sj.FrameType]) -> Sequence[object]:
        return [np.asarray(f) for f in np.asarray(frame)]


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fusion")
    clip = str(root / "clip.mp4")
    scv.synthesize_video(clip, num_frames=N_FRAMES, width=W, height=H,
                         fps=24, keyint=12)
    cj = sj.Client(db_path=str(root / "db_jax"))
    ct = st.Client(db_path=str(root / "db_torch"), device="cpu")
    for c in (cj, ct):
        _, failed = c.ingest_videos([("clip", clip)])
        assert not failed
    yield cj, ct
    cj.stop()
    ct.stop()


def _golden(s, f):
    r = s.ops.Resize(frame=f, width=[32], height=[24])
    b = s.ops.Blur(frame=r, kernel_size=3, sigma=1.1)
    return s.ops.HistDiff(frame=s.ops.Histogram(frame=b))


def _run_torch(ct, build, name, fused, wp=8, io_=16):
    """The port's card path on CPU tensors, fused or staged; the stored
    rows."""
    tfusion.set_enabled(fused)
    try:
        frame = ct.io.Input([st.NamedVideoStream(ct, "clip")])
        out = st.NamedStream(ct, name)
        ex = LocalExecutor(ct._db, Profiler(), torch.device("cpu"),
                           stage=True)
        ex.run([ct.io.Output(build(ct, frame), [out])],
               st.PerfParams.manual(wp, io_),
               cache_mode=st.CacheMode.Overwrite)
    finally:
        tfusion.set_enabled(True)
    return list(out.load())


def _run_jax(cj, build, name, wp=8, io_=16):
    """The JAX package's fused rows, on its YUV420 wire (which its CPU
    backend takes only when forced) — the wire the port's card path
    decodes to, converted by the same integer BT.601."""
    frame = cj.io.Input([sj.NamedVideoStream(cj, "clip")])
    out = sj.NamedStream(cj, name)
    with pytest.MonkeyPatch.context() as m:
        m.setenv("SCANNER_TPU_YUV_DEVICE", "force")
        cj.run(cj.io.Output(build(cj, frame), [out]),
               sj.PerfParams.manual(wp, io_),
               cache_mode=sj.CacheMode.Overwrite, show_progress=False)
    return list(out.load())


def _assert_rows_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        nx = type(x).__name__ == "NullElement"
        ny = type(y).__name__ == "NullElement"
        if nx or ny:
            assert nx and ny, i
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y)), i
        else:
            assert x == y, i


# rows straddle bucket boundaries: below the smallest bucket (3), an
# exact bucket (16), a bucket and a tail (21), the whole clip with a
# ragged tail (50)
@pytest.mark.parametrize("rows", [3, 16, 21, N_FRAMES])
def test_golden_chain_fused_matches_staged_and_jax(clients, rows):
    cj, ct = clients

    def build(s, f):
        if rows < N_FRAMES:
            f = s.streams.Range(f, [(0, rows)])
        return _golden(s, f)

    fused = _run_torch(ct, build, f"golden{rows}_fused", True)
    staged = _run_torch(ct, build, f"golden{rows}_staged", False)
    want = _run_jax(cj, build, f"golden{rows}")
    assert len(fused) == rows
    _assert_rows_equal(fused, staged)
    _assert_rows_equal(fused, want)


def test_golden_chain_pixels_and_histograms(clients):
    """The chain's own outputs: the Resize -> Blur frames (fused as
    Resize+Blur, the tail read by a frame-rows op) within one count of
    the JAX package's; the Histogram rows (Resize+Blur+Histogram) equal
    the staged run's and the plain histogram of the fused run's own
    frames.  (A pixel one count apart can cross a bin edge, so the rows
    are not compared with the JAX package's frames' histograms.)"""
    cj, ct = clients

    def small(s, f):
        return s.ops.Blur(frame=s.ops.Resize(frame=f, width=[32],
                                             height=[24]),
                          kernel_size=3, sigma=1.1)

    frames = np.stack(_run_torch(
        ct, lambda s, f: s.ops.TorchFusionFrameRows(frame=small(s, f)),
        "px_fused", True))
    src = np.stack(_run_jax(
        cj, lambda s, f: s.ops.JaxFusionFrameRows(frame=f), "px_src"))
    import jax.numpy as jnp
    from scanner_tpu.common import DeviceType
    from scanner_tpu.graph.ops import KernelConfig
    from scanner_tpu.kernels import imgproc as jimg
    want = np.asarray(jimg.Blur(KernelConfig(device=DeviceType.CPU),
                                kernel_size=3, sigma=1.1).execute(
        jimg._resize_impl(jnp.asarray(src), 24, 32)))
    d = np.abs(frames.astype(np.int32) - want.astype(np.int32))
    assert frames.shape == want.shape and d.max() <= 1

    def hist(s, f):
        return s.ops.Histogram(frame=small(s, f))

    fused = _run_torch(ct, hist, "hist_fused", True)
    _assert_rows_equal(fused, _run_torch(ct, hist, "hist_staged", False))
    np.testing.assert_array_equal(
        np.stack(fused), jimg.Histogram._histogram_np(frames))


def test_stencil_head_fused_matches_staged(clients):
    """OpticalFlow's [-1, 0] window heads a chain into Blur: the composed
    gather reads the window once and the flow never materializes."""
    _, ct = clients

    def build(s, f):
        flow = s.ops.OpticalFlow(frame=s.streams.Range(f, [(0, 12)]))
        return s.ops.TorchFusionFrameRows(frame=s.ops.Blur(
            frame=flow, kernel_size=3, sigma=0.8))

    fused = _run_torch(ct, build, "flowblur_fused", True, wp=4)
    staged = _run_torch(ct, build, "flowblur_staged", False, wp=4)
    assert len(fused) == 12
    _assert_rows_equal(fused, staged)


def test_null_interleaved_fused_matches_staged_and_jax(clients):
    """A tail row is null iff ANY transitively read head row is null."""
    cj, ct = clients

    def build(s, f):
        return _golden(s, s.streams.RepeatNull(
            s.streams.Range(f, [(0, 6)]), [3]))

    fused = _run_torch(ct, build, "nulls_fused", True)
    staged = _run_torch(ct, build, "nulls_staged", False)
    assert sum(type(e).__name__ == "NullElement" for e in fused) > 0
    _assert_rows_equal(fused, staged)
    _assert_rows_equal(fused, _run_jax(cj, build, "nulls"))


def test_gather_sampled_fused_matches_staged_and_jax(clients):
    cj, ct = clients

    def build(s, f):
        return _golden(s, s.streams.Gather(f, [[0, 7, 8, 23, 24, 49]]))

    fused = _run_torch(ct, build, "gather_fused", True)
    assert len(fused) == 6
    _assert_rows_equal(fused, _run_torch(ct, build, "gather_staged",
                                         False))
    _assert_rows_equal(fused, _run_jax(cj, build, "gather"))


# ---------------------------------------------------------------------------
# chain-level attribution: one ladder, silent members, warm chains
# ---------------------------------------------------------------------------

def _op_counter(series: str):
    out = {}
    for s in registry().snapshot().get(series, {}).get("samples", []):
        lab = s["labels"]
        k = lab.get("op") or lab.get("chain")
        out[k] = out.get(k, 0) + s["value"]
    return out


CHAIN = "Resize+Blur+Histogram"


def test_kill_switch_restores_staged_metrics(clients):
    _, ct = clients
    before = _op_counter("scanner_tpu_op_rows_total")
    _run_torch(ct, _golden, "kill", False)
    after = _op_counter("scanner_tpu_op_rows_total")
    assert after.get(CHAIN, 0) == before.get(CHAIN, 0)
    assert after.get("Resize", 0) > before.get("Resize", 0)


def test_one_ladder_per_chain_and_silent_members(clients):
    """A fused run mints signatures under the CHAIN id only, bounded by
    the chain ladder; the members mint none and never dispatch.
    HistDiff stays staged (windowed, not a head) and keeps its own row
    accounting."""
    _, ct = clients
    wp = 8
    before_sig = _op_counter("scanner_tpu_op_recompiles_total")
    before_rows = _op_counter("scanner_tpu_op_rows_total")
    _run_torch(ct, _golden, "ladder", True, wp=wp)
    after_sig = _op_counter("scanner_tpu_op_recompiles_total")
    after_rows = _op_counter("scanner_tpu_op_rows_total")
    assert 0 < after_sig.get(CHAIN, 0) - before_sig.get(CHAIN, 0) \
        <= len(bucket_ladder(wp))
    for member in ("Resize", "Blur", "Histogram"):
        assert after_sig.get(member, 0) == before_sig.get(member, 0), member
        assert after_rows.get(member, 0) == before_rows.get(member, 0), \
            member
    assert after_rows.get(CHAIN, 0) - before_rows.get(CHAIN, 0) >= N_FRAMES
    assert after_rows.get("HistDiff", 0) - before_rows.get(
        "HistDiff", 0) >= N_FRAMES
    planned = {s["labels"]["chain"]: s["value"] for s in registry()
               .snapshot()["scanner_tpu_fusion_chains_planned"]["samples"]}
    assert planned.get(CHAIN) == 3


def test_warmup_warms_the_chain_ladder(clients, monkeypatch):
    """The warm-up thread runs ONE chain ladder, not the members': the
    precompile gauge appears under the chain id and the members stay
    unwarmed individually, though Resize changes the geometry inside
    the chain (the chain runs from source-geometry head frames)."""
    _, ct = clients
    monkeypatch.setenv("SCANNER_TPU_PRECOMPILE", "1")
    frame = ct.io.Input([st.NamedVideoStream(ct, "clip")])
    r = ct.ops.Resize(frame=frame, width=[32], height=[24])
    h = ct.ops.Histogram(frame=ct.ops.Blur(frame=r, kernel_size=3,
                                           sigma=1.1))
    info = TA.analyze([ct.io.Output(h, [st.NamedStream(ct, "warm")])])
    te = TaskEvaluator(info, Profiler(), torch.device("cpu"), stage=True,
                       precompile=(H, W, 8))
    try:
        (fki,) = te.fused.values()
        assert fki.chain_id == CHAIN
        assert te._precompile_thread is not None
        te._precompile_thread.join(timeout=60)
        assert not te._precompile_thread.is_alive()
        assert fki._warm_state == "done"
        assert CHAIN in _op_counter("scanner_tpu_op_precompile_seconds")
        for ki in te.kernels.values():
            assert ki._warm_state == "idle", ki.node.name
        # every rung ran the composition at its bucket
        assert sorted(k[0][0] for k in fki._member_shapes) == \
            [b * fki.width for b in bucket_ladder(8)]
    finally:
        te.close()
