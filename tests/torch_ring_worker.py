"""One rank of a ring of the port's ring attention over torch.distributed
(gloo, on the CPU), for tests/test_torch_attention.py.

Usage: python torch_ring_worker.py <rank> <world> <init_file> <in.npz>
                                   <out.npz>

Reads q, k, v (B, T, H, D) and a cotangent w of the same shape from
in.npz, takes this rank's block of T / world positions, and for each
impl ("xla", "cuda": the plain path on CPU tensors) and causal flag runs
the ring forward and backward (loss = sum(out * w)).  Writes this rank's
outputs and gradients to out.npz under "<impl>_<causal>_{out,dq,dk,dv}".
"""

import sys

import numpy as np
import torch
import torch.distributed as dist


def main(argv) -> None:
    rank, world = int(argv[1]), int(argv[2])
    init_file, src, dst = argv[3], argv[4], argv[5]
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    from scanner_tpu_torch.parallel.ring_attention import \
        make_ring_attention

    data = np.load(src)
    T = data["q"].shape[1]
    tl = T // world
    blk = slice(rank * tl, (rank + 1) * tl)
    out = {}
    try:
        for impl in ("xla", "cuda"):
            for causal in (False, True):
                ring = make_ring_attention(dist.group.WORLD, causal=causal,
                                           impl=impl, block_q=4, block_k=4)
                q, k, v = (torch.from_numpy(data[n][:, blk].copy())
                           .requires_grad_() for n in ("q", "k", "v"))
                w = torch.from_numpy(data["w"][:, blk].copy())
                o = ring(q, k, v)
                (o * w).sum().backward()
                key = f"{impl}_{int(causal)}"
                out[f"{key}_out"] = o.detach().numpy()
                out[f"{key}_dq"] = q.grad.numpy()
                out[f"{key}_dk"] = k.grad.numpy()
                out[f"{key}_dv"] = v.grad.numpy()
        np.savez(dst, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
