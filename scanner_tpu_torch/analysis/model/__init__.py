"""torch-model: bounded-interleaving checker for the control plane.

An abstract Master/Worker/Journal state machine (protocol.py) anchored
to the engine's RPC_CONTRACTS via RPC_ANCHORS — torch-check SC406
pins model and source in sync both directions — explored exhaustively
over every schedule up to a depth bound (explorer.py), asserting at
every reachable state:

  I1  no acknowledged task is ever lost (write-ahead),
  I2  no committed task is ever double-applied (retry dedup),
  I3  no stale master mutates past the fence (generation monotonicity).

CLI: `python tools/torch_model.py --scenario failover`.
Docs: docs/static-analysis.md (torch-model section).
"""

from .protocol import (RPC_ANCHORS, Config, Record, SCENARIOS, State,
                       enabled, invariants, lineage, scenario)
from .explorer import (DEFAULT_DEPTH, DEFAULT_MAX_STATES, Report,
                       Violation, explore, explore_scenario)

__all__ = [
    "RPC_ANCHORS", "Config", "Record", "SCENARIOS", "State",
    "enabled", "invariants", "lineage", "scenario",
    "DEFAULT_DEPTH", "DEFAULT_MAX_STATES", "Report", "Violation",
    "explore", "explore_scenario",
]
