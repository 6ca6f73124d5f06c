"""torch-check: the port's static-analysis CLI.

    python tools/torch_check.py [paths...]   # human output, exit 1 on findings
    python tools/torch_check.py --json       # machine output
    python tools/torch_check.py --write-baseline   # accept current findings
    python tools/torch_check.py --list-codes       # what the passes check

Invoked as `python tools/torch_check.py` or by the tier-1 gate test
(tests/test_torch_static_analysis.py).  Default target is the
scanner_tpu_torch package of the repo the CLI runs from; default
baseline is tools/torch_check_baseline.json.  Exit codes: 0 clean,
1 unsuppressed findings, 2 usage or baseline error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence

from .core import (BaselineError, Finding, Project, find_repo_root,
                   load_baseline, split_findings, write_baseline)
from .tracer import TracerSafetyPass
from .concurrency import ConcurrencyPass
from .contracts import ContractPass
from .durability import DurabilityPass

DEFAULT_BASELINE = os.path.join("tools", "torch_check_baseline.json")
# the analyzed package, relative to the repo root
PACKAGE = "scanner_tpu_torch"

# modules --changed always re-analyzes alongside the touched set: the
# cross-module passes (SC31x fence routing, SC404 journal round-trip,
# SC406 model anchoring) read these for context, so a restricted run
# reports the same findings for a touched module as a full run would
_CHANGED_COMPANIONS = (
    "scanner_tpu_torch/engine/service.py",
    "scanner_tpu_torch/engine/journal.py",
    "scanner_tpu_torch/engine/shardmap.py",
    "scanner_tpu_torch/engine/gang.py",
    "scanner_tpu_torch/engine/controller.py",
    "scanner_tpu_torch/config.py",
    "scanner_tpu_torch/analysis/model/protocol.py",
)


def all_passes(select: Optional[Sequence[str]] = None):
    """Every pass family — or, with `select` code prefixes, only the
    families owning a matching code (the shared-Project speed path:
    `--select SC2` must not pay for the tracer or contract walks)."""
    passes = [TracerSafetyPass(), ConcurrencyPass(), ContractPass(),
              DurabilityPass()]
    if select:
        passes = [p for p in passes
                  if any(code.startswith(s)
                         for code in p.codes for s in select)]
    return passes


def analyze(paths: Sequence[str], root: Optional[str] = None,
            select: Optional[Sequence[str]] = None
            ) -> "tuple[Project, List[Finding]]":
    """THE run protocol, shared by the CLI, bench.py, and the tests:
    build ONE Project shared by every pass family, seed findings with
    parse errors, run the (select-filtered) passes, sort."""
    project = Project(paths, root=root)
    findings: List[Finding] = list(project.parse_errors)
    for p in all_passes(select):
        findings.extend(p.run(project))
    if select:
        findings = [f for f in findings
                    if any(f.code.startswith(s) for s in select)]
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return project, findings


def changed_paths(root: str) -> Optional[List[str]]:
    """Analysis targets for --changed: the working tree's touched
    scanner_tpu_torch/*.py files (vs HEAD, plus untracked) together with
    the cross-module companion set.  Returns None when the analyzer
    itself (scanner_tpu_torch/analysis/ or tools/) is among the changes
    — those affect every finding, so the caller falls back to a full
    run."""
    def git(*args: str) -> List[str]:
        try:
            res = subprocess.run(
                ["git", *args], cwd=root, capture_output=True,
                text=True, timeout=30, check=True)
        except Exception:  # noqa: BLE001 — no git ⇒ full run
            return []
        return [ln.strip() for ln in res.stdout.splitlines()
                if ln.strip()]

    changed = set(git("diff", "--name-only", "HEAD"))
    changed |= set(git("ls-files", "--others", "--exclude-standard"))
    if not changed and not os.path.isdir(os.path.join(root, ".git")):
        return None  # not a checkout — nothing to scope by
    touched = [c for c in changed
               if c.endswith(".py") and c.startswith(PACKAGE + "/")]
    if any(c.startswith(PACKAGE + "/analysis/") for c in touched) \
            or any(c.startswith("tools/") for c in changed):
        return None
    if not touched:
        return []
    targets = dict.fromkeys(list(touched) + [
        c for c in _CHANGED_COMPANIONS
        if os.path.exists(os.path.join(root, c))])
    return [os.path.join(root, c) for c in targets]


def run_analysis(paths: Sequence[str], root: Optional[str] = None,
                 select: Optional[Sequence[str]] = None) -> List[Finding]:
    """analyze() without the project — raw findings, suppression not
    yet applied."""
    return analyze(paths, root=root, select=select)[1]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch-check",
        description="static analysis of the PyTorch/CUDA port "
                    "(docs/torch/analysis.md)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: the repo's "
                         "scanner_tpu_torch/ package)")
    ap.add_argument("--root", default=None,
                    help="repo root (docs/, tests/ context); default: "
                         "auto-detected from the first path")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default <root>/"
                         f"{DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (show everything)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current unsuppressed findings into the "
                         "baseline (keeps existing justifications; new "
                         "entries need one before the file loads again)")
    ap.add_argument("--justification", default="TODO: justify",
                    help="justification recorded for NEW baseline "
                         "entries with --write-baseline")
    ap.add_argument("--select", action="append", default=None,
                    metavar="CODE",
                    help="only run/report codes with this prefix "
                         "(repeatable): --select SC2 --select SC301")
    ap.add_argument("--changed", action="store_true",
                    help="analyze only modules touched vs git (plus "
                         "the cross-module companion set); falls back "
                         "to a full run when the analyzer itself "
                         "changed")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--list-codes", action="store_true",
                    help="list finding codes and exit")
    args = ap.parse_args(argv)

    if args.list_codes:
        for p in all_passes():
            print(f"[{p.name}]")
            for code, desc in sorted(p.codes.items()):
                print(f"  {code}  {desc}")
        return 0

    if args.paths:
        paths = args.paths
        root = args.root or find_repo_root(paths[0])
    else:
        root = args.root or find_repo_root(
            os.path.dirname(os.path.abspath(__file__)))
        paths = [os.path.join(root, PACKAGE)]

    restricted = False
    if args.changed:
        if args.write_baseline:
            print("torch-check: --write-baseline cannot be combined "
                  "with --changed (a restricted run would erase "
                  "baseline entries outside it)", file=sys.stderr)
            return 2
        scoped = changed_paths(root)
        if scoped is not None:
            if not scoped:
                print("torch-check: --changed: no scanner_tpu_torch "
                      "modules touched")
                return 0
            paths = scoped
            restricted = True

    if args.write_baseline and args.select:
        # a selected subset cannot see the other codes' findings, so a
        # rewrite would silently drop their (justified) baseline entries
        print("torch-check: --write-baseline cannot be combined with "
              "--select (it would erase baseline entries outside the "
              "selection)", file=sys.stderr)
        return 2

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    try:
        baseline = {} if args.no_baseline else load_baseline(baseline_path)
    except BaselineError as e:
        print(f"torch-check: baseline error: {e}", file=sys.stderr)
        return 2

    project, findings = analyze(paths, root=root, select=args.select)
    res = split_findings(project, findings, baseline)
    if args.select or restricted:
        # a selected/--changed run can't see the other codes'/files'
        # findings, so their baseline entries would all look stale —
        # don't claim they are
        res.stale_baseline = []

    if args.write_baseline:
        new = write_baseline(baseline_path,
                             res.unsuppressed + res.baselined,
                             previous=baseline,
                             justification=args.justification)
        n = len({f.fingerprint for f in res.unsuppressed + res.baselined})
        print(f"torch-check: baseline written to {baseline_path} "
              f"({n} entries, {new} new)")
        if new and args.justification.upper().startswith("TODO"):
            print("torch-check: new entries carry a TODO justification "
                  "— edit them in or the baseline will not load",
                  file=sys.stderr)
        return 0

    counts: dict = {}
    for f in res.unsuppressed:
        counts[f.code] = counts.get(f.code, 0) + 1

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in res.unsuppressed],
            "counts": counts,
            "baselined": len(res.baselined),
            "inline_suppressed": len(res.inline_suppressed),
            "stale_baseline": res.stale_baseline,
            "files_analyzed": len(project.modules),
        }, indent=1))
    else:
        for f in res.unsuppressed:
            print(f.format())
        bits = [f"{len(project.modules)} files",
                f"{len(res.unsuppressed)} finding(s)"]
        if res.baselined:
            bits.append(f"{len(res.baselined)} baselined")
        if res.inline_suppressed:
            bits.append(f"{len(res.inline_suppressed)} suppressed inline")
        if res.stale_baseline:
            bits.append(f"{len(res.stale_baseline)} STALE baseline "
                        "entries (prune with --write-baseline)")
        print("torch-check: " + ", ".join(bits))

    return 1 if res.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
