"""Whole runs on the CPU at a tiny size, the look for a card skipped:
a sound run comes out correct, and a run whose timed path is broken
underneath (an answer altered where it is produced) comes out not
correct.  The cells here run no training and no exchange between chips,
so those faults do not apply."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from bench_tiny import run_tiny, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("bench")))


def _altered(out, at):
    """`out` with one value changed: `at(array)` changes it in place."""
    if isinstance(out, torch.Tensor):
        out = out.clone()
    else:
        out = np.array(out)
    at(out)
    return out


def _bump_count(a):
    a[0, 0, 0] += 1


BREAKS = {
    "hist.bulk": ("scanner_tpu_torch.kernels.imgproc", "Histogram",
                  _bump_count),
    "hist.clips": ("scanner_tpu_torch.kernels.imgproc", "Histogram",
                   _bump_count),
}


@pytest.mark.parametrize("workload", sorted(BREAKS))
def test_sound_run_is_correct(root, capsys, workload):
    rc, out = run_tiny(root, workload, capsys, trace=1)
    assert rc == 0 and out["correct"] and out["failed"] == 0, out
    assert out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload", sorted(BREAKS))
def test_altered_answer_is_not_correct(root, capsys, monkeypatch, workload):
    import importlib
    mod, cls, change = BREAKS[workload]
    op = getattr(importlib.import_module(mod), cls)
    sound = op.execute

    def broken(self, *args, **kw):
        return _altered(sound(self, *args, **kw), change)

    monkeypatch.setattr(op, "execute", broken)
    rc, out = run_tiny(root, workload, capsys)
    assert rc == 0 and out is not None
    assert out["correct"] is False, out


def test_no_card_no_result(root, capsys):
    from benchmark import run
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    capsys.readouterr()
    rc = run.main(["--workload", "hist.bulk", "--seed", "1", "--seconds",
                   "1", "--trace", "0"], root=root)
    assert rc != 0
    assert "correct" not in capsys.readouterr().out


@pytest.mark.parametrize("when", ["before", "judge"])
def test_jax_loaded_no_result(root, capsys, monkeypatch, when):
    """JAX in sys.modules by the time the result would print: loaded
    before the run, or by the judge once the window has closed."""
    if when == "before":
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    else:
        from benchmark import run
        sound = run.Session.judge

        def judge(self, results):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return sound(self, results)

        monkeypatch.setattr(run.Session, "judge", judge)
    rc, out = run_tiny(root, "hist.clips", capsys)
    assert rc != 0 and out is None


def test_benchmark_alone_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    (no program) exits nonzero and prints no result."""
    root = tiny_root(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "hist.bulk", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert not any(ln.startswith("{") and '"correct"' in ln
                   for ln in r.stdout.splitlines())
