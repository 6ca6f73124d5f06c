"""BENCHMARK.json against the contract's limits, and every cell's files
found by name."""

import json
import os
import subprocess
import sys

import pytest

from bench_tiny import REPO, run_tiny, tiny_root
from benchmark.harness import spec


def doc():
    return spec.load_doc(REPO)


def test_contract_limits_hold():
    assert spec.contract_errors(doc()) == []


@pytest.mark.parametrize("bad", [
    {"name": "a b"}, {"name": "x/y"}, {"unit": "tokens per s"},
    {"unit": "µs"}, {"better": "up"}, {"source": "guess"},
    {"bound": 0.3}, {"why": "x" * 201}])
def test_contract_errors_catch(bad):
    d = doc()
    key = next(iter(bad))
    sec = "workloads" if key == "why" else "end_to_end"
    d[sec][0] = dict(d[sec][0], **bad)
    assert spec.contract_errors(d)


def test_names_units_characters():
    d = doc()
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in d[sec]:
            assert spec.NAME_RE.match(e["name"]), e["name"]
            if "unit" in e:
                assert spec.UNIT_RE.match(e["unit"]), e["unit"]
    for w in d["workloads"]:
        assert spec.NAME_RE.match(w["config"])
        assert spec.NAME_RE.match(w["traffic"])


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_doc(REPO)["workloads"]])
def test_each_cell_resolves(workload):
    cell = spec.resolve(REPO, workload)
    assert cell.config["reference"]
    assert hasattr(cell.reference, "compare")
    assert hasattr(cell.reference, "control_results")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.readers[m["name"]].read)


def test_every_metric_and_config_is_used():
    d = doc()
    cells = {w["name"] for w in d["workloads"]}
    assert {w["config"] for w in d["workloads"]} == \
        {c["name"] for c in d["configs"]}
    for m in d["per_layer"] + d["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
        if "moves" in m:
            moved = next(e for e in d["end_to_end"] if e["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_dummy_cell_from_new_files_alone(tmp_path, capsys):
    """A new cell, configuration, traffic mix and per-layer metric, added
    as entries and new files, runs with no file of the harness edited."""
    root = tiny_root(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "histogram_640x480.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "histogram_dummy"
    with open(os.path.join(bench, "configs", "histogram_dummy.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "dummy.json"), "w") as f:
        json.dump({"loop": "closed", "clients": 1, "frames_per_job": 12,
                   "work_packet_size": 4, "io_packet_size": 12}, f)
    with open(os.path.join(bench, "metrics", "dummy_jobs.py"), "w") as f:
        f.write("def read(rec):\n    return float(len(rec.jobs))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        d = json.load(f)
    d["configs"].append({"name": "histogram_dummy", "source": "x",
                         "file": "benchmark/configs/histogram_dummy.json",
                         "reduced": [], "why": "a test's"})
    d["workloads"].append({"name": "dummy.cell", "config": "histogram_dummy",
                           "traffic": "dummy", "chips": 1, "why": "a test's"})
    d["per_layer"].append({"name": "dummy_jobs", "unit": "jobs",
                           "better": "higher", "source": "host_clock",
                           "layer": "client", "moves": "frames_per_s",
                           "workloads": ["dummy.cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(d, f)
    assert spec.contract_errors(d) == []
    rc, out = run_tiny(root, "dummy.cell", capsys, trace=1)
    assert rc == 0 and out["correct"], out
    assert out["metrics"]["dummy_jobs"]["value"] >= 1


DUMMY_GENERATOR = '''
from benchmark.harness import traffic, window

SENT, LOOPS = [], []


def clips(mix, table_frames):
    n = mix["frames_per_job"]
    return [(k, k + n) for k in range(0, table_frames - n + 1, n // 2)]


def job_order(mix, table_frames, seed):
    while True:
        for clip in clips(mix, table_frames):
            SENT.append(clip)
            yield clip


def loop(send, order, seconds, tracer=None):
    LOOPS.append(seconds)
    return window.closed_loop(send, order, seconds, tracer=tracer)
'''

DUMMY_DEPLOYMENT = '''
import os

STARTED, RUNS = [], []


def start(st, db_path, device, config):
    class Recording(st.Client):
        def run(self, *args, **kw):
            RUNS.append(kw.get("task_timeout"))
            return super().run(*args, **kw)

    STARTED.append(os.environ.get("BENCH_DUMMY_ENV"))
    return Recording(db_path=db_path, device=device, **config["client"])


def stop(client):
    STARTED.append("stopped")
    client.stop()
'''

DUMMY_READER = '''
def read(rec):
    gen, dep = rec.cell.generator, rec.cell.deployment
    if dep.STARTED != ["on", "stopped"] or not gen.LOOPS:
        return None
    if not dep.RUNS or any(t != 600.0 for t in dep.RUNS):
        return None
    return float(len(gen.SENT))
'''


def test_dummy_cell_with_its_own_generator_and_deployment(tmp_path, capsys,
                                                          monkeypatch):
    """A cell whose traffic names a generator module of its own (its
    clips overlap, its loop wraps the closed one) and whose
    configuration names a deployment module, the program's environment
    and `Client` arguments, with `Client.run` arguments in the mix: all
    new files and entries, no file of the harness edited."""
    monkeypatch.setenv("BENCH_DUMMY_ENV", "off")
    root = tiny_root(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "histogram_640x480.json")) as f:
        cfg = json.load(f)
    cfg.update(name="histogram_deployed", deployment="dummy_local",
               env={"BENCH_DUMMY_ENV": "on"},
               client={"num_load_workers": 1})
    files = {
        "configs/histogram_deployed.json": json.dumps(cfg),
        "traffic/overlap.json": json.dumps(
            {"generator": "overlap_gen", "frames_per_job": 8,
             "work_packet_size": 4, "io_packet_size": 8,
             "run": {"task_timeout": 600.0}}),
        "traffic/overlap_gen.py": DUMMY_GENERATOR,
        "deployments/dummy_local.py": DUMMY_DEPLOYMENT,
        "metrics/dummy_deployed.py": DUMMY_READER,
    }
    for rel, text in files.items():
        os.makedirs(os.path.dirname(os.path.join(bench, rel)), exist_ok=True)
        with open(os.path.join(bench, rel), "w") as f:
            f.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        d = json.load(f)
    d["configs"].append({"name": "histogram_deployed", "source": "x",
                         "file": "benchmark/configs/histogram_deployed.json",
                         "reduced": [], "why": "a test's"})
    d["workloads"].append({"name": "dummy.deployed",
                           "config": "histogram_deployed",
                           "traffic": "overlap", "chips": 1,
                           "why": "a test's"})
    d["per_layer"].append({"name": "dummy_deployed", "unit": "jobs",
                           "better": "higher", "source": "host_clock",
                           "layer": "client", "moves": "frames_per_s",
                           "workloads": ["dummy.deployed"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(d, f)
    assert spec.contract_errors(d) == []
    rc, out = run_tiny(root, "dummy.deployed", capsys, trace=1)
    assert rc == 0 and out["correct"], out
    assert out["metrics"]["dummy_deployed"]["value"] >= 1


FORBIDDEN_CHECK = r"""
import sys
sys.path.insert(0, {repo!r})
{imports}
bad = sorted({{m.split('.')[0] for m in sys.modules}} & set({names!r}))
print(bad)
"""


def _loaded_top_names(imports: str, names) -> list:
    code = FORBIDDEN_CHECK.format(repo=REPO, imports=imports,
                                  names=list(names))
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"'))


def test_run_path_loads_no_jax():
    """What a run imports (the harness, every reference and reader, and
    the program) loads neither JAX nor the JAX package, compared by
    whole top-level names: scanner_tpu_torch is not scanner_tpu."""
    imports = "\n".join([
        "import benchmark.run, benchmark.harness.readings",
        "from benchmark.harness import spec",
        "for w in spec.load_doc(sys.path[0])['workloads']:",
        "    spec.resolve(sys.path[0], w['name'])",
        "import scanner_tpu_torch, scanner_tpu_torch.kernels",
        "import scanner_tpu_torch.models"])
    assert _loaded_top_names(imports, ("jax", "jaxlib", "flax",
                                       "scanner_tpu")) == []


def test_references_load_nothing_of_the_program():
    imports = "\n".join([
        "from benchmark.harness import spec",
        "import glob, os",
        "for p in glob.glob(os.path.join(sys.path[0], 'benchmark',",
        "                                'reference', '*.py')):",
        "    spec.load_module(p, 'r_' + os.path.basename(p)[:-3])"])
    assert _loaded_top_names(imports, ("jax", "jaxlib", "flax", "scanner_tpu",
                                       "scanner_tpu_torch")) == []
