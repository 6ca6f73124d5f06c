"""One rank of a gang's process group over gloo, for
tests/test_torch_gang.py: the port's gang collectives on seeded blocks.

Usage: python torch_gang_worker.py <rank> <world> <port> <in.npz> <out.npz>

Joins the group through parallel/distributed.initialize (TCPStore at
127.0.0.1:<port>), builds parallel/mesh.host_mesh, and for every
(lo, hi) in in.npz's "cases" exchanges the halos of this rank's block
of in.npz's "x" (parallel/halo.exchange_row_halo).  Then it gathers the
uneven row shards of "x" (distributed.all_gather_rows with
global_rows), reduces in.npz's per-rank "digests" (gang
_collective_digest_sum) and all-gathers a payload of rank + 1 bytes
(gang _all_gather_bytes).  Writes this rank's results to out.npz.
"""

import sys

import numpy as np


def main(argv) -> None:
    rank, world, port = int(argv[1]), int(argv[2]), int(argv[3])
    src, dst = argv[4], argv[5]
    from scanner_tpu_torch.engine import gang
    from scanner_tpu_torch.parallel import distributed as dist
    from scanner_tpu_torch.parallel.halo import exchange_row_halo
    from scanner_tpu_torch.parallel.mesh import host_mesh

    data = np.load(src)
    x, cases = data["x"], data["cases"]
    dist.initialize(dist.CoordinatorConfig(f"127.0.0.1:{port}", world,
                                           rank), init_timeout=60)
    out = {}
    try:
        mesh = host_mesh(world)
        chunk = len(x) // world
        block = x[rank * chunk:(rank + 1) * chunk]
        for lo, hi in cases:
            left, right = exchange_row_halo(mesh, block, int(lo), int(hi))
            out[f"left_{lo}_{hi}"] = left
            out[f"right_{lo}_{hi}"] = right
        n = len(x) - 1  # uneven: the last shard is short
        lo_r, hi_r = dist.shard_rows(n, rank, world)
        out["gathered"] = dist.all_gather_rows(mesh, "hosts", x[lo_r:hi_r],
                                               global_rows=n)
        out["digest"] = np.int64(gang._collective_digest_sum(
            world, rank, int(data["digests"][rank])))
        blobs = gang._all_gather_bytes(world, bytes([rank]) * (rank + 1))
        out["blobs"] = np.frombuffer(b"".join(blobs), np.uint8)
        np.savez(dst, **out)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main(sys.argv)
