#!/usr/bin/env python3
"""torch-model: exhaustively explore the port's control-plane protocol.

    python tools/torch_model.py                      # every scenario
    python tools/torch_model.py --scenario failover
    python tools/torch_model.py --scenario crash --broken ack_before_commit
    python tools/torch_model.py --json

Explores every interleaving of the abstract Master/Worker/Journal
state machine (scanner_tpu_torch/analysis/model/, the port's copy
of the JAX package's model, anchored to the port's RPC_CONTRACTS) up to a depth bound and
asserts the durability/fencing invariants at every reachable state.
Exit 1 with a minimal counterexample schedule on violation, exit 2 if
a bound truncated the exploration (widen --depth / --max-states).
`--broken` injects a known defect; the explorer is expected to find
it — used by tests/test_torch_model.py to prove the checker has
teeth.  See docs/static-analysis.md (scanner-model section) and
docs/torch/analysis.md.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from scanner_tpu_torch.analysis.model import (  # noqa: E402
    DEFAULT_DEPTH, DEFAULT_MAX_STATES, SCENARIOS, explore_scenario)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="torch-model",
        description="bounded-interleaving checker for the port's "
                    "control plane (docs/static-analysis.md)")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS),
                    action="append", default=None,
                    help="scenario(s) to explore (default: all)")
    ap.add_argument("--broken",
                    choices=("ack_before_commit", "skip_dedup",
                             "ignore_fence"),
                    default=None,
                    help="inject a known defect — the explorer must "
                         "find it")
    ap.add_argument("--depth", type=int, default=DEFAULT_DEPTH,
                    help=f"schedule depth bound (default "
                         f"{DEFAULT_DEPTH})")
    ap.add_argument("--max-states", type=int,
                    default=DEFAULT_MAX_STATES,
                    help=f"state-count bound (default "
                         f"{DEFAULT_MAX_STATES})")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    names = args.scenario or sorted(SCENARIOS)
    reports = [explore_scenario(n, args.broken, depth=args.depth,
                                max_states=args.max_states)
               for n in names]

    if args.as_json:
        print(json.dumps([r.to_dict() for r in reports], indent=1))
    else:
        for r in reports:
            tag = "BROKEN " + r.broken if r.broken else "ok"
            bound = "exhausted" if r.exhausted else "TRUNCATED"
            print(f"[{r.scenario}] {r.states} states, {r.edges} edges, "
                  f"{r.schedules} interleavings, depth "
                  f"{r.max_depth_seen} ({bound}) [{tag}]")
            if r.violation is not None:
                print(r.violation.format())

    if any(not r.ok for r in reports):
        return 1
    if any(not r.exhausted for r in reports):
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
