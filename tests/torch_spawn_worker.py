"""A port worker in a process of its own, for the chaos tool
(tools/torch_chaos_run.py): the counterpart of tests/spawn_worker.py,
on scanner_tpu_torch, on the device it is given.

Usage: python torch_spawn_worker.py <master> <db_path> [--device D]
                                    [--port P] [--counts-out PATH]

`--device` is "cuda" (the default: the current card; no card raises),
"cuda:N" or "cpu".  With `--counts-out` the worker writes its kernel
launch counts (kernels/cuda_ops.py) there as JSON when it shuts down
cleanly; a worker that crashed writes nothing.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from scanner_tpu_torch.engine.service import start_worker  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("master")
    ap.add_argument("db_path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--counts-out", default=None)
    args = ap.parse_args()
    start_worker(args.master, db_path=args.db_path, port=args.port,
                 device=args.device, block=True)
    if args.counts_out:
        from scanner_tpu_torch.kernels import cuda_ops
        tmp = args.counts_out + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"histogram_launches": cuda_ops.histogram_launches,
                       "histogram_ids_launches":
                           cuda_ops.histogram_ids_launches}, f)
        os.replace(tmp, args.counts_out)
