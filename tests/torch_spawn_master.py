"""A port master in a process of its own, for the chaos tool
(tools/torch_chaos_run.py) and restart drills: the counterpart of
tests/spawn_master.py, on scanner_tpu_torch.

Usage: python torch_spawn_master.py <db_path> <port> [shard_id num_shards]

The optional shard args spawn one shard of a horizontally sharded
control plane (docs/robustness.md §Sharded control plane).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from scanner_tpu_torch.engine.service import start_master  # noqa: E402

if __name__ == "__main__":
    db_path = sys.argv[1]
    port = int(sys.argv[2])
    kw = {}
    if len(sys.argv) > 4:
        kw["shard_id"] = int(sys.argv[3])
        kw["num_shards"] = int(sys.argv[4])
    start_master(db_path, port=port, no_workers_timeout=60.0, block=True,
                 **kw)
