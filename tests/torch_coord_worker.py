"""One Worker(device="cpu", coordinator=...) of the port in a process of
its own, for tests/test_torch_multicard.py (a process holds one default
process group, so each member of a lifetime group is a process):

    python tests/torch_coord_worker.py MASTER DB COORDINATOR RANK WORLD OUT

It joins the gloo group at COORDINATOR as RANK of WORLD for its
lifetime, serves MASTER until shutdown_cluster, leaves the group, and
writes to OUT (JSON) the group it joined and whether it left it.  Not a
test module."""

import json
import os
import sys


def main() -> int:
    master, db, coordinator, rank, world, out = sys.argv[1:7]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch.distributed as dist

    import scanner_tpu_torch.kernels  # noqa: F401  (registers the ops)
    from scanner_tpu_torch.engine.service import Worker
    from scanner_tpu_torch.parallel.distributed import CoordinatorConfig
    w = Worker(master, db_path=db, device="cpu",
               coordinator=CoordinatorConfig(coordinator, int(world),
                                             int(rank)))
    info = dict(backend=dist.get_backend(),
                world_size=dist.get_world_size(), rank=dist.get_rank(),
                join_s=w.group_join_s)
    w.wait_for_shutdown()
    info["left_group"] = not dist.is_initialized()
    with open(out, "w") as fh:
        json.dump(info, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
