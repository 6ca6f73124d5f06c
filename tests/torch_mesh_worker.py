"""One rank of a gloo group running the port's in-program sharding on the
CPU, for tests/test_torch_parallel.py and tests/test_torch_pose_sharded.py.

Usage: python torch_mesh_worker.py <parallel|pose> <rank> <world>
                                   <init_file> <in.npz> <out_dir>
(the tests call start_ranks / finish_ranks below).

Every rank runs every case of its mode in the same order (the cases'
collectives pair up across ranks) and writes out_dir/rank<r>.npz:

  parallel  placements (shard_batch, replicate_to_global), temporal_diff
            and a wide sharded_stencil_map, Ulysses at sp 4 and 2,
            make_pipeline at dp 2 x pp 2 (M 2 and 4), and the error
            messages of the rejections; inputs from in.npz;
  pose      make_sharded_train_step at width 8, clip (4, 4, 32, 32, 3)
            on dp2 x tp2, dp2 x sp2 (ring, ulysses) and dp2 x pp2, with
            and without remat; a DCP save, a restore on the four ranks
            and the next step's loss; then the JAX package's weights
            (in.npz, written by the test once it has them: the rank
            waits for the file) through one dp2 x tp2 step.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

CLIP = (4, 4, 32, 32, 3)
WIDTH = 8
STEPS = 3
WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_ranks(mode, src, out_dir):
    """Spawn the WORLD ranks of `mode` (each logs to out_dir/log<r>)."""
    env = dict(os.environ, PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"log{r}"), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, str(r),
                 str(WORLD), os.path.join(out_dir, "rdv"), src, out_dir],
                env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    return procs


def finish_ranks(procs, out_dir, timeout=240):
    """Wait for the ranks (killing them past `timeout` seconds); raise
    with a rank's log if one failed; return each rank's results."""
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"log{r}")) as f:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                   + f.read()[-4000:])
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(WORLD)]


def mesh_of(axes):
    from scanner_tpu_torch.parallel import device_mesh, make_mesh
    return device_mesh(make_mesh(axes, devices=["cpu"] * WORLD))


def error_of(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def parallel_cases(data, out):
    from scanner_tpu_torch.parallel import (make_pipeline,
                                            make_ulysses_attention,
                                            replicate_to_global,
                                            shard_batch, sharded_stencil_map,
                                            sharding, temporal_diff)

    # -- placements ------------------------------------------------------
    x = data["placed"]
    m = mesh_of({"dp": 2, "sp": 2, "tp": 1})
    out["coord_dp_sp"] = np.array(m.get_coordinate())
    out["place_dp"] = shard_batch(m, x).to_local().numpy()
    out["place_dp_sp"] = replicate_to_global(m, ("dp", "sp"), x) \
        .to_local().numpy()
    out["placements_dp_sp"] = np.array(
        [f"Shard({p.dim})" if p.is_shard() else "Replicate()"
         for p in sharding(m, "dp", "sp").placements])
    m = mesh_of({"dp": 2, "sp": 1, "tp": 2})
    out["coord_dp_tp"] = np.array(m.get_coordinate())
    out["place_none_tp"] = replicate_to_global(m, (None, "tp"), x) \
        .to_local().numpy()

    # -- halo: temporal_diff on 32 rows and a wide stencil on 16, sp 4 ---
    m = mesh_of({"dp": 1, "sp": 4, "tp": 1})
    out["diff"] = temporal_diff(m)(shard_batch(m, data["rows"], "sp")) \
        .to_local().numpy()
    wide = sharded_stencil_map(
        lambda p: p[:-3] + p[2:-1] + p[3:], stencil=[-2, 0, 1], mesh=m)
    out["wide"] = wide(shard_batch(m, data["rows"][:16], "sp")) \
        .to_local().numpy()
    far = sharded_stencil_map(lambda p: p[5:], stencil=[-5, 0], mesh=m)
    out["err_multihop"] = np.array(error_of(
        lambda: far(shard_batch(m, data["rows"][:16], "sp"))))

    # -- Ulysses: sp 4 over the world, sp 2 in each dp row ---------------
    for tag, axes in (("sp4", {"dp": 1, "sp": 4, "tp": 1}),
                      ("sp2", {"dp": 2, "sp": 2, "tp": 1})):
        m = mesh_of(axes)
        n, r = axes["sp"], m.get_local_rank("sp")
        for causal in (False, True):
            uly = make_ulysses_attention(m, "sp", causal=causal)
            tl = data[f"{tag}_q"].shape[1] // n
            blk = slice(r * tl, (r + 1) * tl)
            q, k, v = (torch.from_numpy(data[f"{tag}_{a}"][:, blk].copy())
                       .requires_grad_() for a in "qkv")
            o = uly(q, k, v)
            (o * torch.from_numpy(data[f"{tag}_w"][:, blk])).sum() \
                .backward()
            key = f"uly_{tag}_{int(causal)}"
            out[f"{key}_out"] = o.detach().numpy()
            for a, t in zip("qkv", (q, k, v)):
                out[f"{key}_d{a}"] = t.grad.numpy()
    m = mesh_of({"dp": 1, "sp": 4, "tp": 1})
    z = torch.zeros(1, 4, 3, 8)
    out["err_heads"] = np.array(error_of(
        lambda: make_ulysses_attention(m, "sp")(z, z, z)))

    # -- GPipe: dp 2 x pp 2 ---------------------------------------------
    m = mesh_of({"dp": 2, "sp": 1, "tp": 1, "pp": 2})
    out["coord_dp_pp"] = np.array(m.get_coordinate())
    d, S = m.get_local_rank("dp"), 2
    xs = data["pipe_x"]
    b = xs.shape[0] // 2

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    for M in (2, 4):
        stacked = {k: replicate_to_global(m, ("pp",), data[f"pipe_{k}"])
                   .requires_grad_() for k in ("w", "b")}
        x = torch.from_numpy(xs[d * b:(d + 1) * b].copy()).requires_grad_()
        pipe = make_pipeline(m, stage, num_microbatches=M)
        y = pipe(stacked, x)
        # each pp rank holds the replicated output: its loss counts 1/S
        ((y ** 2).sum() / S).backward()
        out[f"pipe_{M}_out"] = y.detach().numpy()
        out[f"pipe_{M}_dx"] = x.grad.numpy()
        for k in ("w", "b"):
            out[f"pipe_{M}_d{k}"] = stacked[k].grad.to_local().numpy()
    eye = {"w": torch.eye(8).expand(2, 8, 8)}
    out["err_micro"] = np.array(error_of(
        lambda: make_pipeline(m, lambda p, h: h @ p["w"], 3)(
            eye, torch.zeros(4, 2, 8))))
    out["err_stages"] = np.array(error_of(
        lambda: make_pipeline(m, lambda p, h: h @ p["w"], 2)(
            {"w": torch.eye(8).expand(4, 8, 8)}, torch.zeros(4, 2, 8))))
    out["err_m0"] = np.array(error_of(
        lambda: make_pipeline(m, stage, num_microbatches=0)))


def losses(axes, **kw):
    from scanner_tpu_torch.models.pose import make_sharded_train_step
    step, model, opt, (clip, target) = make_sharded_train_step(
        mesh_of(axes), clip_shape=CLIP, width=WIDTH, **kw)
    return [float(step(clip, target)) for _ in range(STEPS)], \
        (step, model, opt, clip, target)


def pose_cases(in_path, out_dir, rank, out):
    from scanner_tpu_torch.models.checkpoint import TrainCheckpointer
    from scanner_tpu_torch.models.convert import flax_params, load_params
    from scanner_tpu_torch.models.pose import make_sharded_train_step

    tp = {"dp": 2, "sp": 1, "tp": 2}
    pp = {"dp": 2, "sp": 1, "tp": 1, "pp": 2}
    sp = {"dp": 2, "sp": 2, "tp": 1}
    out["tp"], _ = losses(tp)
    out["tp_remat"], _ = losses(tp, remat=True)
    out["sp_ring"], _ = losses(sp, attn_scheme="ring")
    out["sp_ulysses"], _ = losses(sp, attn_scheme="ulysses")
    out["pp_remat"], _ = losses(pp, remat=True)
    out["pp"], (step, model, opt, clip, target) = losses(pp)
    # a pipelined step saved for the restore into the plain model
    TrainCheckpointer(os.path.join(out_dir, "ckpt_pp")).save(
        STEPS, model, opt)
    full = flax_params(model)
    if rank == 0:
        np.savez(os.path.join(out_dir, "pp_params.npz"), **full)

    # -- DCP: save after one step, restore on the four ranks, step again
    step, model, opt, (clip, target) = make_sharded_train_step(
        mesh_of(tp), clip_shape=CLIP, width=WIDTH)
    step(clip, target)
    ckpt = TrainCheckpointer(os.path.join(out_dir, "ckpt_tp"))
    ckpt.save(1, model, opt)
    full = flax_params(model)
    if rank == 0:
        np.savez(os.path.join(out_dir, "tp_params.npz"), **full)
    uninterrupted = float(step(clip, target))
    step, model, opt, (clip, target) = make_sharded_train_step(
        mesh_of(tp), clip_shape=CLIP, width=WIDTH)
    out["restored_step"] = ckpt.restore(model, opt)
    out["resume"] = [uninterrupted, float(step(clip, target))]

    # -- the JAX package's weights, once the test has written them -------
    deadline = time.time() + 240
    while not os.path.exists(in_path):
        if time.time() > deadline:
            raise TimeoutError(f"{in_path} never appeared")
        time.sleep(0.2)
    with np.load(in_path) as f:
        weights = dict(f)
    step, model, opt, (clip, target) = make_sharded_train_step(
        mesh_of(tp), clip_shape=CLIP, width=WIDTH)
    load_params(model, weights)
    out["jax_weights_first"] = [float(step(clip, target))]


def main(argv) -> None:
    mode, rank, world = argv[1], int(argv[2]), int(argv[3])
    init_file, src, out_dir = argv[4], argv[5], argv[6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    out = {}
    try:
        if mode == "parallel":
            parallel_cases(dict(np.load(src)), out)
        else:
            pose_cases(src, out_dir, rank, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
