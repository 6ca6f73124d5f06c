"""The port's cluster tools (tools/torch_top.py, torch_trace.py,
torch_cost.py, torch_chaos_run.py) against the JAX package's
(tools/scanner_top.py, scanner_trace.py, scanner_cost.py, chaos_run.py).

  * the pure functions of both packages' tools, fed the same snapshot,
    ledger and straggler dicts (the port cluster's own), give the same
    output;
  * one port cluster on the CPU (an in-process Master and
    Worker(device="cpu") that ran config 1), shared by the --once,
    --json and --verify smokes of the three tools (their main()s; top
    --json also as a process of its own);
  * the chaos tool lists the JAX tool's plans, refuses a card that is
    not there, and runs one worker-crash drill end to end on the CPU
    (the one process-spawning drill here: such tests add load beside
    the load-timed JAX tests).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.common import ScannerException
from scanner_tpu_torch.engine import service as tservice
from torch_model_checks import stop_process_engine  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
N, H, W = 16, 48, 64


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_tool(name, *args, timeout=180):
    return subprocess.run([sys.executable, os.path.join(TOOLS, name), *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """A port master and one CPU worker over gRPC that ran config 1
    (Histogram over a stored table of seeded frames)."""
    db_path = str(tmp_path_factory.mktemp("torch_tools") / "db")
    frames = np.random.RandomState(0).randint(
        0, 256, (N, H, W, 3)).astype(np.uint8)
    seed = st.Client(db_path=db_path, device="cpu")
    seed.new_table("frames", ["frame"], [[f] for f in frames],
                   codecs={"frame": "pickle"})
    seed.stop()
    m = tservice.Master(db_path=db_path, no_workers_timeout=60.0)
    w = tservice.Worker(f"localhost:{m.port}", db_path=db_path,
                        device="cpu")
    sc = st.Client(db_path=db_path, master=f"localhost:{m.port}")
    col = sc.ops.Histogram(frame=sc.io.Input([st.NamedStream(sc,
                                                             "frames")]))
    job = sc.run(sc.io.Output(col, [st.NamedStream(sc, "hist")]),
                 st.PerfParams.manual(4, 8), show_progress=False,
                 cache_mode=st.CacheMode.Overwrite)
    yield {"client": sc, "addr": f"localhost:{m.port}", "job": job,
           "rows": list(st.NamedStream(sc, "hist").load())}
    sc.stop()
    w.stop()
    m.stop()


def test_cluster_ran_config1(cluster):
    rows = cluster["rows"]
    assert len(rows) == N
    assert all(np.asarray(r).shape == (3, 16)
               and int(np.asarray(r).sum()) == 3 * H * W for r in rows)


# -- the pure functions, both packages on the same input --------------------

def test_top_digest_and_json_doc_equal_the_jax_tools(cluster, monkeypatch):
    sc = cluster["client"]
    snap = sc.metrics()
    status = sc.job_status()
    health = sc.health()
    jtop, ttop = _tool("scanner_top"), _tool("torch_top")
    for mod in (jtop, ttop):
        monkeypatch.setattr(mod.time, "time", lambda: 1.0e9)
    jcur, tcur = jtop.digest(snap), ttop.digest(snap)
    assert tcur == jcur
    assert any(n.startswith("worker") and d["eval_r"] > 0
               for n, d in tcur["nodes"].items())
    assert ttop.json_doc(status, tcur, "m:1", health) \
        == jtop.json_doc(status, jcur, "m:1", health)
    rendered = ttop.render(status, tcur, None, "m:1", health)
    assert rendered.splitlines()[1:] == jtop.render(
        status, jcur, None, "m:1", health).splitlines()[1:]


def test_cost_render_equals_the_jax_tool(cluster):
    nodes = cluster["client"].compile_report()["nodes"]
    assert any((r or {}).get("op_efficiency") for r in nodes.values())
    jcost, tcost = _tool("scanner_cost"), _tool("torch_cost")
    for n in (0, 3, 10):
        assert tcost.render(nodes, n) == jcost.render(nodes, n)
    for node, rep in nodes.items():
        assert tcost.render_ops(node, rep.get("op_efficiency")) \
            == jcost.render_ops(node, rep.get("op_efficiency"))
        assert tcost.render_ledger(rep.get("ledger"), 5) \
            == jcost.render_ledger(rep.get("ledger"), 5)


def test_cost_detail_nodes_equal_the_jax_tool(tmp_path):
    path = tmp_path / "detail.json"
    path.write_text(json.dumps([{"config": "op_efficiency",
                                 "compile": {"compiles": 2},
                                 "ops": [{"op": "Histogram"}]}]))
    assert _tool("torch_cost").detail_nodes(str(path)) \
        == _tool("scanner_cost").detail_nodes(str(path))


def test_trace_stragglers_format_equals_the_jax_tool(cluster):
    s = cluster["client"].stragglers(cluster["job"])
    s["spans"], s["spans_dropped"] = 7, 1
    assert _tool("torch_trace")._fmt_stragglers("t", s) \
        == _tool("scanner_trace")._fmt_stragglers("t", s)


# -- the three tools against the cluster ------------------------------------

def test_top_json_as_a_process(cluster):
    """The tool as an operator runs it: its own process, the checkout
    made importable by the tool itself."""
    r = _run_tool("torch_top.py", "--master", cluster["addr"], "--json")
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout)
    workers = {n: d for n, d in doc["nodes"].items()
               if n.startswith("worker")}
    assert workers and any(d["eval_rows"] >= N for d in workers.values())
    assert any("cpu" in d["devices"] for d in workers.values())
    assert doc["status"]["finished"]


def test_top_once(cluster, capsys):
    assert _tool("torch_top").main(["--master", cluster["addr"],
                                    "--once"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("torch-top  master=") and "Histogram" in out


def test_trace_verify_and_dump(cluster, tmp_path, capsys):
    trace = _tool("torch_trace")
    assert trace.main(["--master", cluster["addr"], "--verify",
                       "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["complete"] and rep["tasks"] == N // 8
    out = tmp_path / "bulk.json"
    assert trace.main(["--master", cluster["addr"], "-o", str(out)]) == 0
    names = {e.get("name") for e in json.load(open(out))["traceEvents"]}
    assert {"job", "task"} <= names


def test_cost_json(cluster, capsys):
    assert _tool("torch_cost").main(["--master", cluster["addr"],
                                     "--json"]) == 0
    nodes = json.loads(capsys.readouterr().out)["nodes"]
    ops = [o for rep in nodes.values()
           for o in (rep or {}).get("op_efficiency") or []]
    assert any(o["op"] == "Histogram" and o["device"] == "cpu"
               for o in ops), ops


@pytest.mark.parametrize("tool", ["torch_top", "torch_trace", "torch_cost"])
def test_tools_exit_2_when_the_master_is_unreachable(tool):
    assert _tool(tool).main(["--master", "localhost:1", "--json"]) == 2


# -- the chaos tool ---------------------------------------------------------

def test_chaos_list_equals_the_jax_tools():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    got = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "torch_chaos_run.py"),
         "--list"], capture_output=True, text=True, timeout=120, env=env)
    want = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "chaos_run.py"), "--list"],
        capture_output=True, text=True, timeout=120, env=env)
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert got.stdout == want.stdout and "worker-crash" in got.stdout


def test_chaos_cuda_without_a_card_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chaos = _tool("torch_chaos_run")
    with pytest.raises(ScannerException, match="no CUDA card"):
        chaos.main(["worker-crash"])


def test_chaos_refuses_plans_the_device_cannot_run(monkeypatch):
    chaos = _tool("torch_chaos_run")
    assert chaos.main(["memory-pressure", "--device", "cpu"]) == 2
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert chaos.main(["gang-host-loss", "--device", "cuda"]) == 2


def test_chaos_worker_crash_on_the_cpu(tmp_path):
    """The worker-crash plan end to end: two CPU worker processes, the
    armed one dies mid-task, the survivor finishes, the rows are
    bit-exact to the clean run, and no process is left to kill."""
    r = _run_tool("torch_chaos_run.py", "worker-crash", "--device", "cpu",
                  "--rows", "12", "--db", str(tmp_path / "db"),
                  timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["fired"] and res["bit_exact"] and res["rows"] == 12
    assert res["killed"] == 0 and res["processes"] == 3
    assert "injected-crashes=1" in r.stdout
