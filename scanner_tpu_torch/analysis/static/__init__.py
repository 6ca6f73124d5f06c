"""The port's static analysis (torch-check): the JAX package's
scanner-check, kept as the port's own copy and pointed at the port.

Four pass families over the scanner_tpu_torch source:

  * tracer.py      — SC101–SC106: CUDA-graph capture safety of
                     `execute_traced` bodies, bucketed dispatch and
                     explicit card placement
  * concurrency.py — SC201–SC203: lock order, blocking-under-lock,
                     unguarded shared writes
  * contracts.py   — SC301–SC307: metric/env/config/fault/RPC contracts
  * durability.py  — SC401–SC406: write-ahead/fencing data-flow and
                     journal round-trip discipline, plus anchoring of
                     the analysis.model protocol model to RPC_CONTRACTS

Run via `python tools/torch_check.py`, or programmatically::

    from scanner_tpu_torch.analysis.static import run_analysis
    findings = run_analysis(["scanner_tpu_torch/"])

The tier-1 gate (tests/test_torch_static_analysis.py) fails on any
finding not inline-suppressed or baselined with a justification.  Docs:
docs/static-analysis.md (the shared codes) and docs/torch/analysis.md
(what differs in the port).
"""

from .core import (AnalysisPass, BaselineError, CallGraph, Finding,
                   ModuleInfo, PathSimulator, Project, find_repo_root,
                   load_baseline, split_findings, write_baseline)
from .tracer import TracerSafetyPass
from .concurrency import ConcurrencyPass
from .contracts import ContractPass
from .durability import DurabilityPass
from .cli import (DEFAULT_BASELINE, all_passes, analyze, changed_paths,
                  main, run_analysis)

__all__ = [
    "AnalysisPass", "BaselineError", "CallGraph", "Finding",
    "ModuleInfo", "PathSimulator", "Project",
    "TracerSafetyPass", "ConcurrencyPass", "ContractPass",
    "DurabilityPass",
    "find_repo_root", "load_baseline", "split_findings",
    "write_baseline", "all_passes", "analyze", "changed_paths",
    "run_analysis", "main", "DEFAULT_BASELINE",
]
