"""The port's bucket-ladder warm-up (engine/evaluate.py precompile /
ensure_warm / rewarm) on the CPU, where it is off unless
SCANNER_TPU_PRECOMPILE=1 forces it: the same ladders as the JAX
package's, the warm-up thread runs every rung of each eligible op, a
real call claims a warm-up that has not started, and consumers of a
geometry-changing op are not warmed."""

from typing import Any, Sequence

import numpy as np
import pytest
import torch

from scanner_tpu.engine import evaluate as jev

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.engine import evaluate as tev
from scanner_tpu_torch.graph import analysis as TA
from scanner_tpu_torch.graph import fusion as tfusion
from scanner_tpu_torch.util.metrics import registry
from scanner_tpu_torch.util.profiler import Profiler

H, W = 24, 32


@pytest.mark.parametrize("cap", [1, 3, 4, 5, 8, 16, 17, 96])
def test_ladder_matches_jax(cap):
    assert tev.bucket_ladder(cap) == jev.bucket_ladder(cap)
    for k in range(1, cap + 1):
        assert tev.bucket_for(k, tev.bucket_ladder(cap)) == \
            jev.bucket_for(k, jev.bucket_ladder(cap))


def test_precompile_default_and_env(monkeypatch):
    monkeypatch.delenv("SCANNER_TPU_PRECOMPILE", raising=False)
    assert not tev._precompile_enabled(torch.device("cpu"))
    assert tev._precompile_enabled(torch.device("cuda", 0))
    monkeypatch.setenv("SCANNER_TPU_PRECOMPILE", "1")
    assert tev._precompile_enabled(torch.device("cpu"))
    monkeypatch.setenv("SCANNER_TPU_PRECOMPILE", "0")
    assert not tev._precompile_enabled(torch.device("cuda", 0))


@st.register_op(device=st.DeviceType.TPU, batch=16)
class TorchBucketBoxes(st.Kernel):
    def execute(self, frame: Sequence[st.FrameType]) -> Sequence[Any]:
        return [np.asarray([0.1, 0.1, 0.9, 0.9], np.float32)] * len(frame)


class _Stream:
    is_video = False

    def __init__(self, n):
        self.n = n


def _info(build):
    from scanner_tpu_torch.graph.ops import OpGenerator
    from scanner_tpu_torch.graph.streams_dsl import IOGenerator
    io, ops = IOGenerator(), OpGenerator()
    src = io.Input([_Stream(40)])
    return TA.analyze([io.Output(build(ops, src), [_Stream(0)])])


def _precompile_gauge():
    return {s["labels"]["op"] for s in registry().snapshot().get(
        "scanner_tpu_op_precompile_seconds", {}).get("samples", [])}


def _warmed(te):
    te._precompile_thread.join(timeout=60)
    assert not te._precompile_thread.is_alive()


def test_warmup_runs_every_rung(monkeypatch):
    """CropResize warms its ladder (its box column from
    precompile_input); a real call afterwards finds it done and waits
    for nothing."""
    monkeypatch.setenv("SCANNER_TPU_PRECOMPILE", "1")
    info = _info(lambda ops, src: ops.CropResize(
        frame=src, box=ops.TorchBucketBoxes(frame=src), size=8))
    calls = []
    te = tev.TaskEvaluator(info, Profiler(), torch.device("cpu"),
                           stage=True, precompile=(H, W, 8))
    try:
        _warmed(te)
        by_name = {ki.node.name: ki for ki in te.kernels.values()}
        crop = by_name["CropResize"]
        assert crop._warm_state == "done"
        assert "CropResize" in _precompile_gauge()
        orig = crop.kernel.execute
        crop.kernel.execute = lambda *a: calls.append(a) or orig(*a)
        crop.ensure_warm()      # done: returns at once
        assert calls == []
    finally:
        te.close()


def test_warmup_runs_ladder_shapes(monkeypatch):
    monkeypatch.setenv("SCANNER_TPU_PRECOMPILE", "1")
    seen = []
    info = _info(lambda ops, src: ops.Histogram(frame=src))
    te = tev.TaskEvaluator(info, Profiler(), torch.device("cpu"),
                           stage=True, precompile=(H, W, 8))
    try:
        _warmed(te)
        (ki,) = te.kernels.values()
        assert ki._warm_state == "done"
        # a re-warm runs the ladder again, as real calls of each rung
        orig = ki.kernel.execute
        ki.kernel.execute = lambda x: seen.append(tuple(x.shape)) or orig(x)
        assert te.rewarm() == 1
        _warmed(te)
        assert seen == [(b, H, W, 3) for b in tev.bucket_ladder(8)]
        assert tev.rewarm_all() >= 1
        _warmed(te)
    finally:
        te.close()


def test_real_call_claims_a_pending_warmup():
    """ensure_warm on a pending warm-up claims it: the warm-up thread
    then skips the kernel."""
    info = _info(lambda ops, src: ops.Histogram(frame=src))
    te = tev.TaskEvaluator(info, Profiler(), torch.device("cpu"),
                           stage=True)
    try:
        (ki,) = te.kernels.values()
        assert ki._warm_state == "idle"
        ki._warm_state = "pending"
        ki.ensure_warm()
        assert ki._warm_state == "done" and ki._warm_done.is_set()
        ki.kernel.execute = None     # a warm-up call would fail loudly
        ki.precompile([4, 8], H, W)  # skipped: claimed
    finally:
        te.close()


def test_geometry_changing_producer_stops_warmup(monkeypatch):
    """Staged Resize -> Blur: Resize warms at source geometry; Blur's
    frames come out of Resize, so it is not warmed."""
    monkeypatch.setenv("SCANNER_TPU_PRECOMPILE", "1")
    tfusion.set_enabled(False)
    try:
        info = _info(lambda ops, src: ops.Blur(frame=ops.Resize(
            frame=src, width=[16], height=[12])))
        te = tev.TaskEvaluator(info, Profiler(), torch.device("cpu"),
                               stage=True, precompile=(H, W, 8))
    finally:
        tfusion.set_enabled(True)
    try:
        _warmed(te)
        states = {ki.node.name: ki._warm_state
                  for ki in te.kernels.values()}
        assert states == {"Resize": "done", "Blur": "idle"}
    finally:
        te.close()


def test_no_warmup_on_the_cpu_by_default(monkeypatch):
    monkeypatch.delenv("SCANNER_TPU_PRECOMPILE", raising=False)
    info = _info(lambda ops, src: ops.Histogram(frame=src))
    te = tev.TaskEvaluator(info, Profiler(), torch.device("cpu"),
                           stage=True, precompile=(H, W, 8))
    try:
        assert te._precompile_thread is None
        assert te.rewarm() == 0
    finally:
        te.close()
