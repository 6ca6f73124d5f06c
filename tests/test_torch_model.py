"""torch-model: the port's copy of the bounded-interleaving protocol
checker (scanner_tpu_torch/analysis/model/, tools/torch_model.py),
explored beside the JAX package's: every scenario, clean and with each
injected defect, gives the same report — states, edges, interleavings,
depth, exhaustion and the minimal counterexample — and the CLI keeps
scanner_model.py's exit codes.  torch-check SC406 anchors the port's
model to the port's RPC_CONTRACTS
(tests/test_torch_static_analysis.py)."""

import json
import os
import subprocess
import sys

import pytest

from scanner_tpu.analysis import model as jmodel
from scanner_tpu_torch.analysis import model as tmodel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BROKEN = ("ack_before_commit", "skip_dedup", "ignore_fence")


def test_same_scenarios_anchors_and_bounds():
    assert sorted(tmodel.SCENARIOS) == sorted(jmodel.SCENARIOS)
    assert tmodel.RPC_ANCHORS == jmodel.RPC_ANCHORS
    assert (tmodel.DEFAULT_DEPTH, tmodel.DEFAULT_MAX_STATES) \
        == (jmodel.DEFAULT_DEPTH, jmodel.DEFAULT_MAX_STATES)


@pytest.mark.parametrize("broken", (None,) + BROKEN)
@pytest.mark.parametrize("name", sorted(jmodel.SCENARIOS))
def test_reports_equal_the_jax_packages(name, broken):
    t = tmodel.explore_scenario(name, broken)
    assert t.to_dict() == jmodel.explore_scenario(name, broken).to_dict()
    if broken is None:
        assert t.ok and t.exhausted


def _cli(*args):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_model.py"),
         *args], capture_output=True, text=True, timeout=300)


def test_cli_exhausts_every_scenario():
    r = _cli("--json")
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    assert sorted(d["scenario"] for d in doc) == sorted(jmodel.SCENARIOS)
    assert all(d["ok"] and d["exhausted"] for d in doc)


@pytest.mark.parametrize("broken", BROKEN)
def test_cli_finds_each_injected_defect(broken):
    scen = "failover" if broken == "ignore_fence" else "crash"
    r = _cli("--scenario", scen, "--broken", broken)
    assert r.returncode == 1, r.stdout + r.stderr
    assert f"BROKEN {broken}" in r.stdout


def test_cli_truncated_bound_exits_2():
    r = _cli("--scenario", "crash", "--depth", "3")
    assert r.returncode == 2, r.stdout + r.stderr
