"""The port's static analysis (scanner_tpu_torch/analysis/static/,
tools/torch_check.py) against the JAX package's (scanner_tpu/analysis/).

  * the gate — the port analyzer over scanner_tpu_torch/ with
    tools/torch_check_baseline.json reports zero unsuppressed findings
    and no stale entry, and every entry carries the JAX twin's
    justification where the code is the JAX package's;
  * the shared families (SC2xx concurrency, SC3xx contracts, SC4xx
    durability) give the same (code, path, line, message) as the JAX
    analyzer on the JAX suite's own fixture sources (one bad and one
    good case per code), and the same SC2xx/SC4xx findings over the
    port's own tree;
  * the tracer family, which in the port looks at what a CUDA-graph
    capture records: each of SC101–SC106 fires on a minimal bad snippet
    and stays silent on its good twin;
  * the docs side that differs: docs/torch/ pages and the
    reference-only table;
  * the CLI's exit codes.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import test_static_analysis as jsa
from scanner_tpu.analysis import static as jstatic
from scanner_tpu_torch.analysis import static as tstatic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "scanner_tpu_torch")
BASELINE = os.path.join(REPO, "tools", "torch_check_baseline.json")
CHECK = os.path.join(REPO, "tools", "torch_check.py")


def _write(root, rel, src):
    path = os.path.join(str(root), rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(src))
    return path


def _key(findings):
    return [(f.code, f.path, f.line, f.message) for f in findings]


# ---------------------------------------------------------------------------
# (a) the gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_analysis():
    """Every pass over scanner_tpu_torch/ once: (project, raw findings)."""
    return tstatic.analyze([PKG], root=REPO)


def test_port_is_clean(port_analysis):
    """THE port's gate: torch-check over scanner_tpu_torch/ reports zero
    unsuppressed findings and no stale baseline entry.  load_baseline
    rejects an entry without a justification (or a TODO one)."""
    baseline = tstatic.load_baseline(BASELINE)
    proj, findings = port_analysis
    res = tstatic.split_findings(proj, findings, baseline)
    assert not res.unsuppressed, "torch-check found:\n" + "\n".join(
        f.format() for f in res.unsuppressed)
    assert not res.stale_baseline, res.stale_baseline
    assert baseline and res.baselined


def test_baseline_entries_carry_their_jax_twins_justification():
    """Every accepted finding is in code the port copied from the JAX
    package, so its justification is the JAX twin's, word for word."""
    jax = {(e["code"], e["path"].split("/", 1)[1], e["scope"]):
           e["justification"] for e in json.load(open(os.path.join(
               REPO, "tools", "scanner_check_baseline.json")))["entries"]}
    for e in json.load(open(BASELINE))["entries"]:
        assert e["path"].startswith("scanner_tpu_torch/")
        assert jax[(e["code"], e["path"].split("/", 1)[1], e["scope"])] \
            == e["justification"], e["fingerprint"]


def test_baseline_rejects_todo_entries(tmp_path):
    doc = json.load(open(BASELINE))
    doc["entries"][0]["justification"] = "TODO: justify"
    bad = tmp_path / "baseline.json"
    bad.write_text(json.dumps(doc))
    with pytest.raises(tstatic.BaselineError):
        tstatic.load_baseline(str(bad))


def test_write_baseline_round_trips_over_the_port(tmp_path, port_analysis):
    """A baseline written over the port loads: twin findings of one
    scope and snippet (the two legacy checkpoint deletes) share a
    fingerprint and get one entry."""
    proj, findings = port_analysis
    res = tstatic.split_findings(proj, findings)
    path = str(tmp_path / "baseline.json")
    tstatic.write_baseline(path, res.unsuppressed,
                           justification="accepted for the test")
    baseline = tstatic.load_baseline(path)
    assert len(baseline) == len(json.load(open(BASELINE))["entries"])
    res = tstatic.split_findings(proj, findings, baseline)
    assert not res.unsuppressed and not res.stale_baseline


# ---------------------------------------------------------------------------
# (b) the shared families against the JAX analyzer
# ---------------------------------------------------------------------------

CONTRACT_CLEAN = {
    "docs/observability.md": """
        | `scanner_tpu_good_total` | counter | documented |
    """,
    "docs/guide.md": """
        `SCANNER_TPU_DOCUMENTED` is a knob.  `[net] port` is config.
    """,
    "pkg/config.py": """
        def default_config():
            return {"net": {"port": 1}}
    """,
    "pkg/util/faults.py": """
        SITES = ("rpc.call",)
        MODES = ("raise", "delay")
        _EXC = {"fault": lambda m: Exception(m)}
        NAMED_PLANS = {"p1": "rpc.call:raise"}
        ACTIVE = False

        def inject(site, data=None, detail=""):
            return data
    """,
    "pkg/m.py": """
        import os
        from .util import faults as _faults

        RPC_CONTRACTS = {"Reg": {"timeout_s": 1.0, "idempotent": True}}

        def registry():
            return None

        M_GOOD = registry().counter("scanner_tpu_good_total", "ok")

        def knobs(cfg):
            return os.environ.get("SCANNER_TPU_DOCUMENTED"), \\
                cfg["net"]["port"]

        def hooks(data):
            return _faults.inject("rpc.call", data)

        class RpcServer:
            def __init__(self, name, methods, port=0):
                pass

        def serve(handler):
            return RpcServer("svc", {"Reg": handler})

        def client(c):
            return c.call("Reg")
    """,
}


def _files(root, files):
    _write(root, "setup.py", "# root marker\n")
    for rel, src in files.items():
        _write(root, rel, src)
    return "pkg"


def _one(rel, src):
    def build(root):
        _write(root, rel, src)
        return None
    return build


def _repo(make, **kw):
    def build(root):
        make(root, **kw)
        return "pkg"
    return build


def _sc406(anchors, transitions):
    def build(root):
        jsa._sc406_repo(root, anchors, transitions)
        return "pkg"
    return build


# (id, a function writing the case -> analyzed subdir or None for the
# whole root, the code the bad case must raise / the good case must not)
SHARED_CASES = [
    ("SC201-bad", _one("svc.py", jsa.CONC_BAD), "SC201", True),
    ("SC201-good", _one("svc.py", jsa.CONC_CLEAN), "SC201", False),
    ("SC202-bad", _one("svc.py", jsa.CONC_BAD), "SC202", True),
    ("SC202-good", _one("svc.py", jsa.CONC_CLEAN), "SC202", False),
    ("SC203-bad", _one("svc.py", jsa.CONC_BAD), "SC203", True),
    ("SC203-good", _one("svc.py", jsa.CONC_CLEAN), "SC203", False),
] + [
    (f"{code}-{kind}",
     _repo(jsa._contract_repo) if kind == "bad"
     else (lambda root: _files(root, CONTRACT_CLEAN)),
     code, kind == "bad")
    for code in ("SC301", "SC302", "SC303", "SC304", "SC305", "SC306",
                 "SC307")
    for kind in ("bad", "good")
] + [
    ("SC308-bad", _repo(jsa._alert_repo, doc_rules=("rule_a", "rule_ghost"),
                        code_rules=("rule_a", "rule_undoc")), "SC308", True),
    ("SC308-good", _repo(jsa._alert_repo), "SC308", False),
    ("SC309-bad", _repo(jsa._cost_repo, kernel_has_cost=False), "SC309",
     True),
    ("SC309-good", _repo(jsa._cost_repo), "SC309", False),
    ("SC310-bad", _repo(jsa._framecache_repo,
                        doc_series=("scanner_tpu_framecache_a",)),
     "SC310", True),
    ("SC310-good", _repo(jsa._framecache_repo), "SC310", False),
    ("SC311-bad", _repo(jsa._remediation_repo, with_markers=False),
     "SC311", True),
    ("SC311-good", _repo(jsa._remediation_repo), "SC311", False),
    ("SC312-bad", _repo(jsa._fence_repo, wrap_mut=False), "SC312", True),
    ("SC312-good", _repo(jsa._fence_repo), "SC312", False),
    ("SC313-bad", _repo(jsa._gang_repo, wrap_gang=False), "SC313", True),
    ("SC313-good", _repo(jsa._gang_repo), "SC313", False),
    ("SC314-bad", _repo(jsa._clocksync_repo, with_series_markers=False),
     "SC314", True),
    ("SC314-good", _repo(jsa._clocksync_repo), "SC314", False),
    ("SC315-bad", _repo(jsa._gang_shard_repo, with_markers=False), "SC315",
     True),
    ("SC315-good", _repo(jsa._gang_shard_repo), "SC315", False),
    ("SC316-bad", _repo(jsa._shardmap_repo, with_markers=False), "SC316",
     True),
    ("SC316-good", _repo(jsa._shardmap_repo), "SC316", False),
    ("SC317-bad", _repo(jsa._fusion_repo, with_markers=False), "SC317",
     True),
    ("SC317-good", _repo(jsa._fusion_repo), "SC317", False),
    ("SC401-bad", _one("m.py", jsa.DUR_WRITE_AHEAD_BAD), "SC401", True),
    ("SC401-good", _one("m.py", jsa.DUR_WRITE_AHEAD_CLEAN), "SC401", False),
    ("SC402-bad", _one("m.py", jsa.DUR_FENCE_BAD), "SC402", True),
    ("SC402-good", _one("m.py", jsa.DUR_FENCE_CLEAN), "SC402", False),
    ("SC403-bad", _one("m.py", jsa.DUR_STALE_BAD), "SC403", True),
    ("SC403-good", _one("m.py", jsa.DUR_STALE_CLEAN), "SC403", False),
    ("SC404-bad", _one("j.py", jsa.DUR_JOURNAL_BAD), "SC404", True),
    ("SC404-good", _one("j.py", jsa.DUR_JOURNAL_CLEAN), "SC404", False),
    ("SC405-bad", _one("m.py", jsa.DUR_LOCK_BAD), "SC405", True),
    ("SC405-good", _one("m.py", jsa.DUR_LOCK_CLEAN), "SC405", False),
    ("SC406-bad", _sc406({"finished_work": "FinishedWork", "ghost": "Ping"},
                         ["finished_work"]), "SC406", True),
    ("SC406-good", _sc406({"finished_work": "FinishedWork"},
                          ["finished_work"]), "SC406", False),
]


@pytest.mark.parametrize("build,code,bad",
                         [c[1:] for c in SHARED_CASES],
                         ids=[c[0] for c in SHARED_CASES])
def test_shared_family_matches_jax(tmp_path, build, code, bad):
    sub = build(tmp_path)
    paths = [os.path.join(str(tmp_path), sub)] if sub else [str(tmp_path)]
    family = [code[:3]]
    _, jf = jstatic.analyze(paths, root=str(tmp_path), select=family)
    _, tf = tstatic.analyze(paths, root=str(tmp_path), select=family)
    assert _key(tf) == _key(jf)
    assert any(f.code == code for f in tf) == bad, _key(tf)


def test_port_tree_concurrency_and_durability_match_jax():
    """Over the port's own tree the two analyzers give the same SC2xx
    and SC4xx findings (SC406 anchors the port's copy of the protocol
    model to the port's RPC_CONTRACTS)."""
    _, jf = jstatic.analyze([PKG], root=REPO, select=["SC2", "SC4"])
    _, tf = tstatic.analyze([PKG], root=REPO, select=["SC2", "SC4"])
    assert _key(tf) == _key(jf)
    assert any(f.code == "SC202" for f in tf)


def test_model_anchors_the_ports_rpc_contracts():
    """SC406 over the port finds the port's protocol model and the
    port's engine/service.py, and the anchors hold."""
    from scanner_tpu_torch.analysis.model import RPC_ANCHORS
    from scanner_tpu_torch.engine.service import RPC_CONTRACTS
    proj, findings = tstatic.analyze([PKG], root=REPO, select=["SC406"])
    assert proj.module("analysis/model/protocol.py").relpath \
        == "scanner_tpu_torch/analysis/model/protocol.py"
    assert proj.module("engine/service.py").relpath \
        == "scanner_tpu_torch/engine/service.py"
    assert findings == []
    assert set(RPC_ANCHORS.values()) <= set(RPC_CONTRACTS)


# ---------------------------------------------------------------------------
# docs: docs/torch/ and the reference-only table
# ---------------------------------------------------------------------------

def test_port_pages_and_reference_only_table():
    proj = tstatic.Project([PKG], root=REPO)
    ref = proj.reference_only()
    assert "SCANNER_TPU_PALLAS" in ref and all(ref.values())
    for name in ("scanner_tpu_fusion_graph_captures_total",
                 "scanner_tpu_fusion_graph_replays_total"):
        assert name in proj.doc_page("observability.md")
        # the JAX analyzer reads only top-level docs/*.md
        assert name not in jstatic.Project(
            [os.path.join(REPO, "scanner_tpu")], root=REPO).docs_text()


def _ref_repo(root, reads):
    _write(root, "setup.py", "# root\n")
    _write(root, "docs/guide.md", "`SCANNER_TPU_A` and `SCANNER_TPU_B`.\n")
    _write(root, "docs/torch/reference-only.md", """
        <!-- reference-only:begin -->
        | Name | Kind | Why |
        |---|---|---|
        | `SCANNER_TPU_B` | env | the port has no such knob |
        <!-- reference-only:end -->
    """)
    _write(root, "pkg/m.py", "import os\n" + "".join(
        f"{v} = os.environ.get('SCANNER_TPU_{v}')\n" for v in reads))


@pytest.mark.parametrize("reads,flagged", [
    (("A",), []),
    (("A", "B"), ["read here but the port's reference-only table"]),
    ((), ["`SCANNER_TPU_A` but nothing reads it"]),
])
def test_reference_only_env_vars(tmp_path, reads, flagged):
    """A reference-only name counts as documented and not read; reading
    one is flagged; any other documented name nothing reads still is."""
    _ref_repo(tmp_path, reads)
    if not reads:
        _write(tmp_path, "pkg/other.py",
               "import os\nX = os.environ.get('SCANNER_TPU_C')\n")
        _write(tmp_path, "docs/guide.md",
               "`SCANNER_TPU_A`, `SCANNER_TPU_B`, `SCANNER_TPU_C`.\n")
    _, f = tstatic.analyze([str(tmp_path / "pkg")], root=str(tmp_path),
                           select=["SC303"])
    msgs = [x.message for x in f]
    assert len(msgs) == len(flagged), msgs
    for want in flagged:
        assert any(want in m for m in msgs), msgs


# ---------------------------------------------------------------------------
# (c) the tracer family: what a CUDA-graph capture records
# ---------------------------------------------------------------------------

CAPTURE_HEAD = """
    import random
    import time

    import numpy as np
    import torch

    _SCALE = {}

    def set_scale(v):
        _SCALE["k"] = v

"""

TRACER_CASES = {
    "SC101": ("""
        class K:
            def execute_traced(self, frame):
                return torch.as_tensor(np.clip(frame, 0, 255))
    """, """
        class K:
            def execute_traced(self, frame):
                lut = np.arange(4)         # numpy on constants: fine
                return frame.clamp(0, 255) + int(lut[0])
    """),
    "SC102": ("""
        class K:
            def execute_traced(self, frame):
                return _helper(frame)

        def _helper(x):
            if x.sum() > 0:            # host branch on a tensor's value
                x = x * 2
            return x
    """, """
        class K:
            def execute_traced(self, frame):
                return _helper(frame)

            def finish(self, result):
                return [float(v) for v in result.cpu().tolist()]

        def _helper(x):
            if x.ndim == 4 and x.shape[0] > 1:   # static: fine
                x = x * 2
            return torch.where(x > 0, x, -x)
    """),
    "SC103": ("""
        class K:
            def execute_traced(self, frame):
                return frame + torch.rand(frame.shape, device=frame.device)
    """, """
        class K:
            def __init__(self):
                self.g = torch.Generator()

            def execute_traced(self, frame):
                return frame + torch.rand(frame.shape, generator=self.g,
                                          device=frame.device)
    """),
    "SC104": ("""
        class K:
            def execute_traced(self, frame):
                return frame * _SCALE.get("k", 1)
    """, """
        TABLE = {"a": 1}   # never mutated from a function

        class K:
            def execute_traced(self, frame, scale=1):
                return frame * scale * TABLE["a"]
    """),
}

SC105_BAD = """
    def run_chunk(ki, frames, k):
        return ki.kernel.execute(frames[:k])
"""
SC105_GOOD = """
    def bucket_for(k, ladder):
        return min(b for b in ladder if b >= k)

    def _call(ki, frames):
        return ki.kernel.execute(frames)

    def run_chunk(ki, frames, k, ladder):
        pad = bucket_for(k, ladder) - k
        return _call(ki, frames[:k + pad])
"""
SC106_BAD = """
    import torch

    def place(x):
        dev = torch.device("cuda")
        return x.to(dev)
"""
SC106_GOOD = """
    import torch

    def place(x, device):
        dev = torch.device(device)
        if dev.index == torch.cuda.current_device():   # a comparison
            pass
        return x.to(dev)
"""


def _tracer(root, rel, src):
    _write(root, rel, src)
    proj, f = tstatic.analyze([str(root)], root=str(root), select=["SC1"])
    assert not proj.parse_errors, proj.parse_errors
    return f


@pytest.mark.parametrize("code", sorted(TRACER_CASES))
@pytest.mark.parametrize("bad", [True, False], ids=["bad", "good"])
def test_capture_body_codes(tmp_path, code, bad):
    src = textwrap.dedent(CAPTURE_HEAD) + textwrap.dedent(
        TRACER_CASES[code][0 if bad else 1])
    f = _tracer(tmp_path, "kernels/k.py", src)
    codes = [x.code for x in f]
    if bad:
        assert codes == [code], _key(f)
        assert "captured `" in f[0].message
    else:
        assert codes == [], _key(f)


@pytest.mark.parametrize("bad", [True, False], ids=["bad", "good"])
def test_sc105_ladder_in_the_evaluator(tmp_path, bad):
    f = _tracer(tmp_path, "engine/evaluate.py",
                SC105_BAD if bad else SC105_GOOD)
    assert [x.code for x in f] == (["SC105"] if bad else []), _key(f)


def test_sc105_kernel_execute_outside_the_evaluator(tmp_path):
    f = _tracer(tmp_path, "engine/other.py", SC105_GOOD)
    assert [x.code for x in f] == ["SC105"], _key(f)


@pytest.mark.parametrize("bad", [True, False], ids=["bad", "good"])
def test_sc106_default_card_placement(tmp_path, bad):
    f = _tracer(tmp_path, "models/m.py", SC106_BAD if bad else SC106_GOOD)
    assert [x.code for x in f] == (["SC106"] if bad else []), _key(f)


@pytest.mark.parametrize("snippet", [
    "x.cuda()",
    "torch.zeros(3, device='cuda')",
    "torch.cuda.current_device()",
    "torch.device('cuda' if torch.cuda.is_available() else 'cpu')",
])
def test_sc106_forms(tmp_path, snippet):
    src = f"import torch\n\ndef f(x):\n    return {snippet}\n"
    f = _tracer(tmp_path, "kernels/k.py", src)
    assert [x.code for x in f] == ["SC106"], _key(f)
    # outside engine/, kernels/, models/ (host tooling) it is not flagged
    f = _tracer(tmp_path, "tools_dir/k.py", src)
    assert [x.code for x in f if x.path == "tools_dir/k.py"] == []


def test_sc102_forms_and_host_only_branches(tmp_path):
    """Each sync form fires once; a branch only a numpy batch takes is
    not captured."""
    src = textwrap.dedent(CAPTURE_HEAD) + textwrap.dedent("""
        class K:
            def execute_traced(self, frame):
                if isinstance(frame, np.ndarray):
                    return frame.sum().item()     # host-only: skipped
                a = frame.sum().item()
                b = frame.tolist()
                c = frame.cpu()
                d = frame.numpy()
                e = bool(frame.any())
                torch.cuda.synchronize()
                while frame.max() > 1:
                    frame = frame // 2
                return frame, a, b, c, d, e
    """)
    f = _tracer(tmp_path, "kernels/k.py", src)
    assert [x.code for x in f] == ["SC102"] * 7, _key(f)


INHERITED_CASES = {
    # the default Kernel.execute_traced runs execute(): its host tail is
    # captured
    "inherited": ("""
        class K(Kernel):
            def cost(self, shapes):
                return None

            def execute(self, frame: Sequence[FrameType]):
                return (frame * 2).cpu()
    """, ["SC102"]),
    # its own execute_traced is the captured body; execute stays host
    "overridden": ("""
        class K(Kernel):
            def cost(self, shapes):
                return None

            def execute_traced(self, frame):
                return frame * 2

            def execute(self, frame: Sequence[FrameType]):
                return self.execute_traced(frame).cpu()
    """, []),
    # no cost(): never fused (graph/fusion.py fusable), never captured
    "not-fusable": ("""
        class K(Kernel):
            def execute(self, frame: Sequence[FrameType]):
                return (frame * 2).cpu()
    """, []),
}


@pytest.mark.parametrize("case", sorted(INHERITED_CASES))
def test_inherited_execute_traced_captures_execute(tmp_path, case):
    """A fusable Kernel that keeps the default execute_traced has its
    execute() captured, whatever row types it declares."""
    body, want = INHERITED_CASES[case]
    src = textwrap.dedent("""
        from typing import Sequence

        from scanner_tpu_torch.common import FrameType
        from scanner_tpu_torch.graph.ops import Kernel
    """) + textwrap.dedent(body)
    f = _tracer(tmp_path, "kernels/k.py", src)
    assert [x.code for x in f] == want, _key(f)
    if want:
        assert "inherited Kernel.execute_traced" in f[0].message


def test_port_capture_bodies_are_found():
    """The port's captured bodies are what the pass looks at: the
    execute_traced methods and the module functions they reach."""
    from scanner_tpu_torch.analysis.static import tracer
    found = set()
    for rel in ("kernels/imgproc.py", "kernels/shot.py", "graph/ops.py"):
        mod = tstatic.ModuleInfo.parse(os.path.join(PKG, rel), REPO)
        found |= {(rel, c.fn.name) for c in tracer._find_capture_contexts(
            mod, tracer._import_aliases(mod))}
    assert {("kernels/imgproc.py", "execute_traced"),
            ("kernels/imgproc.py", "histogram"),
            ("kernels/imgproc.py", "_bin_ids"),
            ("kernels/imgproc.py", "resize"),
            ("kernels/imgproc.py", "crop_resize"),
            ("kernels/imgproc.py", "blur"),
            ("kernels/imgproc.py", "horn_schunck"),
            ("kernels/shot.py", "execute_traced"),
            ("graph/ops.py", "execute_traced")} <= found
    assert not any(name == "finish" for _, name in found)


# ---------------------------------------------------------------------------
# (d) the CLI
# ---------------------------------------------------------------------------

def _check(*args):
    return subprocess.run([sys.executable, CHECK, *args],
                          capture_output=True, text=True, timeout=300)


def test_cli_list_codes():
    r = _check("--list-codes")
    assert r.returncode == 0, r.stderr
    for code in ("SC101", "SC106", "SC201", "SC317", "SC406"):
        assert code in r.stdout


def test_cli_json_select_and_exit_codes(tmp_path):
    _write(tmp_path, "setup.py", "# root\n")
    bad = _write(tmp_path, "pkg/s.py", jsa.SLEEPY)
    r = _check(bad, "--root", str(tmp_path), "--json")
    assert r.returncode == 1, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    assert doc["counts"] == {"SC202": 1}
    assert doc["findings"][0]["path"] == "pkg/s.py"
    r = _check(bad, "--root", str(tmp_path), "--json", "--select", "SC3")
    assert r.returncode == 0 and json.loads(r.stdout)["counts"] == {}
    r = _check(bad, "--root", str(tmp_path), "--select", "SC3",
               "--write-baseline")
    assert r.returncode == 2 and "erase" in r.stderr
    todo = tmp_path / "todo.json"
    todo.write_text(json.dumps({"entries": [
        {"fingerprint": "x", "justification": "TODO"}]}))
    r = _check(bad, "--root", str(tmp_path), "--baseline", str(todo))
    assert r.returncode == 2 and "justification" in r.stderr
    clean = _write(tmp_path, "pkg/ok.py", "x = 1\n")
    r = _check(clean, "--root", str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
