#!/usr/bin/env python3
"""Configs 1 and 2 of chip_smoke.py's main path, run by two checkouts in
turns on one card: frames/s and stage spans per turn.

    python3 tools/torch_main_path_ab.py --tree parent=path/to/checkout
        [--pairs 6] [--frames 600] [--seed 0] [--out FILE]
        [--this-env KEY=VALUE ...]

"this" is the checkout the tool lives in; --tree names another, whose
scanner_tpu_torch/ is imported in its place.  The turns run this, other,
other, this, this, other, ... until each has run `--pairs` times.  Each
turn is a process of its own: it builds its checkout's histogram kernel
and calls it once, stores chip_smoke.py's main-path frames (make_frames,
from --seed) as a pickled-frame table, and runs config 1, then config 2,
through Client(device="cuda") (chip_smoke.py's run_config).  It prints one
JSON line: frames/s, histogram launches and the stage spans of each
config.  The last lines give each checkout's frames/s in turn order.
--this-env sets an environment variable in this checkout's turns only
(e.g. SCANNER_TPU_COSTSTATS=0 to run its port with a ledger off).
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(tree: str, n: int, seed: int) -> int:
    """One turn: the main path's configs 1 and 2 on `tree`'s port."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "_main_path_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    import scanner_tpu_torch as st
    import scanner_tpu_torch.kernels  # noqa: F401  (registers the ops)
    from scanner_tpu_torch.kernels import cuda_ops
    if not os.path.abspath(cuda_ops.__file__).startswith(
            os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {cuda_ops.__file__}, not {tree}'s")
    frames = smoke.make_frames(n, seed)
    # the build and the card's first launch stay out of the timed runs
    cuda_ops.histogram_frames(torch.from_numpy(frames[:16]).cuda())
    torch.cuda.synchronize()
    work = tempfile.mkdtemp(prefix="main_path_ab_")
    try:
        client = st.Client(db_path=os.path.join(work, "db"), device="cuda")
        client.new_table("frames", ["frame"], [[f] for f in frames],
                         codecs={"frame": "pickle"})
        out = {}
        for cfg in (1, 2):
            cuda_ops.reset_counts()
            wall, stages = smoke.run_config(client, st, cfg, f"config{cfg}")
            out[f"config{cfg}_fps"] = n / wall
            out[f"config{cfg}_launches"] = cuda_ops.histogram_launches
            out[f"config{cfg}_stage_s"] = stages
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out, sort_keys=True), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="NAME=path to a checkout")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--this-env", action="append", default=[],
                    help="KEY=VALUE set in this checkout's turns only")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.frames, args.seed)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    other, path = args.tree.split("=", 1)
    trees = {"this": ROOT, other: os.path.abspath(path)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    this_env = dict(os.environ, **dict(kv.split("=", 1)
                                       for kv in args.this_env))
    lines = [f"card: {card}", f"this-env: {args.this_env}"]
    print("\n".join(lines), flush=True)
    order = ["this", other, other, "this"] * ((args.pairs + 1) // 2)
    fps = {name: {1: [], 2: []} for name in trees}
    for turn, name in enumerate(order[:2 * args.pairs]):
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", args.tree,
             "--worker", trees[name], "--frames", str(args.frames),
             "--seed", str(args.seed)], capture_output=True, text=True,
            env=this_env if name == "this" else None)
        if r.returncode:
            print(r.stderr, file=sys.stderr)
            raise RuntimeError(f"turn {turn} ({name}) failed")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        for cfg in (1, 2):
            fps[name][cfg].append(round(res[f"config{cfg}_fps"], 3))
        lines.append(f"turn {turn} {name}: {json.dumps(res, sort_keys=True)}")
        print(lines[-1], flush=True)
    for name in trees:
        lines.append(f"{name}: config1_fps {fps[name][1]} config2_fps "
                     f"{fps[name][2]}")
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
