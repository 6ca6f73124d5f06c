"""A traced run on the CPU at a tiny size reports the six metrics read
from the program's job phases and loader spans, each in the cells
BENCHMARK.json lists it for."""

import pytest

from bench_tiny import run_tiny, tiny_root
from benchmark.harness import spec

NEW = ("job_setup_s", "job_drain_s", "job_commit_s",
       "load_read_ms_per_frame", "load_decode_ms_per_frame",
       "load_stage_ms_per_frame")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture()
def staged(monkeypatch):
    """The executor staging device kernels' inputs on the CPU as it
    does on the card, so the `load:stage` span is recorded here too."""
    from scanner_tpu_torch.engine import executor
    init = executor.LocalExecutor.__init__

    def staging_init(self, *a, **kw):
        init(self, *a, **kw)
        self.stage = True

    monkeypatch.setattr(executor.LocalExecutor, "__init__", staging_init)


@pytest.mark.parametrize("workload", ["hist.bulk", "hist.clips"])
def test_traced_run_reports_the_phase_and_loader_metrics(root, capsys,
                                                         staged, workload):
    rc, out = run_tiny(root, workload, capsys, trace=1)
    assert rc == 0 and out["correct"], out
    want = {m["name"] for m in spec.resolve(root, workload).per_layer
            } & set(NEW)
    assert want == (set(NEW) if workload == "hist.bulk"
                    else {"job_setup_s", "job_drain_s", "job_commit_s"})
    got = out["metrics"]
    assert want <= set(got)
    assert all(got[n]["value"] > 0 for n in want)
