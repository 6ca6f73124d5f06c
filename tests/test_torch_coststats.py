"""The port's compute-efficiency ledger (util/coststats.py) against the
JAX package's: every ported `cost()` hook gives the JAX hook's
descriptor for the same shapes (tolerance 0: both count from the
shapes alone), `classify` gives the same verdict under the same peaks,
and the compile ledger records a compile on the first call of a
signature and not on a repeat call."""

from typing import Sequence

import numpy as np
import pytest
import torch

from scanner_tpu.common import DeviceType
from scanner_tpu.graph.ops import KernelConfig as JConfig
from scanner_tpu.kernels import imgproc as jimg
from scanner_tpu.kernels import shot as jshot
from scanner_tpu.util import coststats as jcs

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch import native
from scanner_tpu_torch.engine.executor import LocalExecutor
from scanner_tpu_torch.graph.ops import KernelConfig as TConfig
from scanner_tpu_torch.kernels import cuda_ops
from scanner_tpu_torch.kernels import imgproc as timg
from scanner_tpu_torch.kernels import shot as tshot
from scanner_tpu_torch.util import coststats as tcs
from scanner_tpu_torch.util.profiler import Profiler
from torch_model_checks import stop_process_engine  # noqa: F401

CPU_J, CPU_T = JConfig(device=DeviceType.CPU), TConfig(device=DeviceType.CPU)


def _resize(pkg, cfg):
    k = pkg.Resize(cfg)
    k.new_stream(width=320, height=240)
    return k


# (op, make the JAX kernel, make the port's, shapes)
COST_CASES = [
    ("Histogram", lambda: jimg.Histogram(CPU_J),
     lambda: timg.Histogram(CPU_T), [(16, 480, 640, 3)]),
    ("Histogram_list", lambda: jimg.Histogram(CPU_J),
     lambda: timg.Histogram(CPU_T), [16]),
    ("Histogram_rank3", lambda: jimg.Histogram(CPU_J),
     lambda: timg.Histogram(CPU_T), [(16, 3, 16)]),
    ("Resize", lambda: _resize(jimg, CPU_J), lambda: _resize(timg, CPU_T),
     [(8, 480, 640, 3)]),
    ("Resize_unbound", lambda: jimg.Resize(CPU_J),
     lambda: timg.Resize(CPU_T), [(8, 480, 640, 3)]),
    ("CropResize", lambda: jimg.CropResize(CPU_J, size=64),
     lambda: timg.CropResize(CPU_T, size=64), [(16, 480, 640, 3), 16]),
    ("CropResize_hw", lambda: jimg.CropResize(CPU_J, height=32, width=48),
     lambda: timg.CropResize(CPU_T, height=32, width=48),
     [(4, 48, 64, 3), 4]),
    ("Blur3", lambda: jimg.Blur(CPU_J, kernel_size=3, sigma=1.1),
     lambda: timg.Blur(CPU_T, kernel_size=3, sigma=1.1),
     [(8, 240, 320, 3)]),
    ("Blur7", lambda: jimg.Blur(CPU_J, kernel_size=6, sigma=2.0),
     lambda: timg.Blur(CPU_T, kernel_size=6, sigma=2.0),
     [(2, 37, 53, 3)]),
    ("OpticalFlow", lambda: jimg.OpticalFlow(CPU_J),
     lambda: timg.OpticalFlow(CPU_T), [(4, 2, 480, 640, 3)]),
    ("OpticalFlow_rank4", lambda: jimg.OpticalFlow(CPU_J),
     lambda: timg.OpticalFlow(CPU_T), [(4, 480, 640, 3)]),
    ("HistDiff_frames", lambda: jshot.HistDiff(CPU_J),
     lambda: tshot.HistDiff(CPU_T), [(16, 2, 240, 320, 3)]),
    ("HistDiff_rows", lambda: jshot.HistDiff(CPU_J),
     lambda: tshot.HistDiff(CPU_T), [(16, 2, 3, 16)]),
    ("HistDiff_short", lambda: jshot.HistDiff(CPU_J),
     lambda: tshot.HistDiff(CPU_T), [(16, 2)]),
]


@pytest.mark.parametrize("case,make_j,make_t,shapes", COST_CASES,
                         ids=[c[0] for c in COST_CASES])
def test_cost_hooks_match_jax(case, make_j, make_t, shapes):
    want = make_j().cost(shapes)
    got = make_t().cost(shapes)
    if want is None:
        assert got is None
        return
    assert (got.flops, got.bytes_in, got.bytes_out) == \
        (want.flops, want.bytes_in, want.bytes_out)
    assert got.bytes_total == want.bytes_total


def test_crop_resize_precompile_input_matches_jax():
    j, t = jimg.CropResize(CPU_J), timg.CropResize(CPU_T)
    np.testing.assert_array_equal(t.precompile_input("box"),
                                  j.precompile_input("box"))
    assert t.precompile_input("frame") is None
    assert timg.Resize(CPU_T).precompile_input("frame") is None


@pytest.mark.parametrize("flops,nbytes,secs", [
    (1e9, 1e6, 1e-3),     # compute-bound against the synthetic ridge
    (1e6, 1e9, 1e-3),     # memory-bound
    (None, 1e9, 2e-3),    # bytes only
    (1e9, 0.0, 1e-3),     # flops only
    (None, 0.0, 1e-3),    # nothing to judge
    (1e9, 1e9, 0.0),      # no time
])
def test_classify_matches_jax_under_set_peaks(flops, nbytes, secs):
    label = "peaks-test:0"
    jcs.set_device_peaks(label, 1e12, 1e10)
    tcs.set_device_peaks(label, 1e12, 1e10)
    assert tcs.device_peaks(label) == jcs.device_peaks(label)
    assert tcs.classify(label, flops, nbytes, secs) == \
        jcs.classify(label, flops, nbytes, secs)


def test_peaks_table_holds_only_the_h100():
    assert [row[0] for row in tcs.DEVICE_PEAKS] == ["H100"]
    assert tcs.DEVICE_PEAKS[0][1:] == (989.4e12, 3.35e12)
    # a label with no card behind it takes the host fallback
    assert tcs.device_peaks("cpu") == tcs._CPU_PEAK


def test_record_op_call_and_efficiency_table():
    tcs.set_device_peaks("eff-test:0", 1e12, 1e10)
    d = tcs.CostDescriptor(flops=2e9, bytes_in=1e6, bytes_out=1e6)
    tcs.record_op_call("EffOp", "eff-test:0", 8, 8, 1e-2, d)
    cls = tcs.record_op_call("EffOp", "eff-test:0", 8, 8, 1e-2, d)
    assert cls["bound"] == "compute"
    assert cls["eff"] == pytest.approx(4e9 / 2e-2 / 1e12)
    (row,) = [r for r in tcs.op_efficiency() if r["op"] == "EffOp"]
    assert row["calls"] == 2 and row["rows"] == 16
    assert row["efficiency"] == pytest.approx(0.2)
    assert set(tcs.compile_report()) == set(jcs.compile_report())


def test_descriptor_for_falls_back_to_observed_bytes():
    class NoCost:
        def cost(self, shapes):
            return None

    x = torch.zeros((4, 8, 8, 3), dtype=torch.uint8)
    d = tcs.descriptor_for(NoCost(), "NoCost", "cpu", 4, [x])
    assert d.source == "observed" and d.bytes_in == x.numel()
    d = tcs.descriptor_for(timg.Histogram(CPU_T), "Histogram", "cpu", 4, [x])
    assert d.source == "hook" and d.flops == 4 * 8 * 8 * 3 * 18


def test_call_timer_times_host_calls():
    timer, got = tcs.CallTimer(), []
    tok = timer.start(torch.device("cpu"))
    timer.stop(tok, got.append)
    timer.resolve(wait=True)
    assert len(got) == 1 and got[0] >= 0


# -- the compile ledger -----------------------------------------------------

@st.register_op(device=st.DeviceType.TPU, batch=8)
class TorchCostCompiles(st.Kernel):
    """Reports a compile on every call, as a first-use library build
    does: only calls the engine observes may land in the ledger."""

    def cost(self, shapes):
        return {"flops": 1.0, "bytes_in": 1.0, "bytes_out": 1.0}

    def execute(self, frame: Sequence[st.FrameType]) -> Sequence[object]:
        tcs.note_compile(0.001, "uncached", "library", 64)
        return [0] * len(frame)


def test_compile_ledger_on_first_call_of_a_signature(tmp_path):
    """21 rows at work packet 8, io packet 16: tasks of 16 and 5 rows,
    chunks of 8, 8 and 5, each called at bucket 8 — one signature, one
    entry, though every call reports a compile.  A 3-row run calls at
    bucket 4: one more entry."""
    f = np.random.RandomState(1).randint(0, 256, (21, 8, 8, 3)) \
        .astype(np.uint8)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    try:
        sc.new_table("frames", ["frame"], [[x] for x in f],
                     codecs={"frame": "pickle"})
        src = sc.io.Input([st.NamedStream(sc, "frames")])
        before = [e for e in tcs.compile_ledger()
                  if e["op"] == "TorchCostCompiles"]
        assert before == []
        ex = LocalExecutor(sc._db, Profiler(), torch.device("cpu"),
                           stage=True)
        out = sc.io.Output(sc.ops.TorchCostCompiles(frame=src),
                           [st.NamedStream(sc, "c1")])
        ex.run([out], st.PerfParams.manual(8, 16),
               cache_mode=st.CacheMode.Overwrite)
        got = [e for e in tcs.compile_ledger()
               if e["op"] == "TorchCostCompiles"]
        assert [(e["bucket"], e["kinds"], e["cache"]) for e in got] == \
            [(8, ["library"], "uncached")]
        assert got[0]["exec_bytes"] == 64 and got[0]["device"] == "cpu"
        ex.run([sc.io.Output(sc.ops.TorchCostCompiles(
                    frame=sc.streams.Range(src, [(0, 3)])),
                    [st.NamedStream(sc, "c2")])],
               st.PerfParams.manual(8, 16),
               cache_mode=st.CacheMode.Overwrite)
        got = [e for e in tcs.compile_ledger()
               if e["op"] == "TorchCostCompiles"]
        assert [e["bucket"] for e in got] == [8, 4]
        # the measured (non-first) calls folded into the roofline table
        rows = [r for r in tcs.op_efficiency()
                if r["op"] == "TorchCostCompiles"]
        assert rows and all(r["cost_source"] == "hook" for r in rows)
    finally:
        sc.stop()


def test_library_load_is_a_compile(monkeypatch, tmp_path):
    """cuda_ops.load_library reports its first load: "hit" when the
    library was already built, "uncached" when nvcc ran."""
    lib = tmp_path / "libscanner_hist.so"
    lib.write_bytes(b"\0" * 100)
    for built, cache in ((0.0, "hit"), (3.0, "uncached")):
        monkeypatch.setattr(cuda_ops, "_lib", None)
        monkeypatch.setattr(cuda_ops, "build_kernel_library",
                            lambda name, src: str(lib))
        monkeypatch.setattr(cuda_ops, "bind_library", lambda path: object())
        monkeypatch.setitem(native.build_seconds, "libscanner_hist.so",
                            built)
        with tcs.observe_compiles("LoadTest", "cuda:0", 16, "sig"):
            cuda_ops.load_library()
        e = tcs.compile_ledger(1)[0]
        assert (e["op"], e["kinds"], e["cache"], e["exec_bytes"]) == \
            ("LoadTest", ["library"], cache, 100)
    # outside any observed call a load records nothing
    monkeypatch.setattr(cuda_ops, "_lib", None)
    n = tcs.ledger_summary()["entries_seen"]
    cuda_ops.load_library()
    assert tcs.ledger_summary()["entries_seen"] == n
