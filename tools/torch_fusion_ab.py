#!/usr/bin/env python3
"""Fused against staged on one card: the golden chain's call, then its
jobs, in turns.

    python3 tools/torch_fusion_ab.py [--rounds 5] [--frames 96] [--seed 1]
        [--trace GRAPH --trace-dir DIR] [--out FILE]

Two measurements, both in this process on the one card:

  * the call: the Resize(320, 240) -> Blur(3, 1.1) -> Histogram chain on
    8 frames of 640 x 480 (the bucket [golden] calls it at), as one fused
    call (engine/evaluate.py FusedKernelInstance: a CUDA graph replay)
    and as the three ops called one after another — wall milliseconds
    per call by the host clock over calls that end in a synchronize,
    device milliseconds by CUDA events, and, from torch.profiler, the
    kernels one call runs and their device time.  The two must give the
    same counts.
  * the jobs: chip_smoke.py's [golden] graphs (a) Resize -> Blur, (b) +
    Histogram, (c) + HistDiff over `--frames` stored frames through
    Client(device="cuda"), fused and staged (fusion.set_enabled) in the
    turns fused, staged, staged, fused, ... for `--rounds` pairs:
    frames/s and the evaluate spans of each run.

With --trace a, b or c and --trace-dir DIR, three more fused and three
more staged runs of that graph, in turns, each write the host spans of
every pipeline thread (Profile.write_trace, Chrome trace JSON) to DIR,
and their start times and walls are printed.

Prints one JSON line per measurement and per turn, then the medians.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "_fusion_ab_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def chain_call(smoke, st, seed: int) -> dict:
    """The chain's call on one bucket, fused and staged."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from scanner_tpu_torch.engine.evaluate import (TaskEvaluator,
                                                   resolve_device)
    from scanner_tpu_torch.graph import analysis
    from scanner_tpu_torch.graph.ops import OpGenerator
    from scanner_tpu_torch.graph.streams_dsl import IOGenerator
    from scanner_tpu_torch.util.profiler import Profiler

    class Stream:
        is_video = False
        n = 64

    io, ops = IOGenerator(), OpGenerator()
    col = ops.Histogram(frame=ops.Blur(frame=ops.Resize(
        frame=io.Input([Stream()]), width=[smoke.W // 2],
        height=[smoke.H // 2]), kernel_size=3, sigma=1.1))
    te = TaskEvaluator(analysis.analyze([io.Output(col, [Stream()])]),
                       Profiler(), resolve_device("cuda"))
    (fki,) = te.fused.values()
    fki.bind_stream(0, 0)
    x = torch.from_numpy(smoke.make_frames(BATCH, seed)).cuda()

    def staged():
        y = x
        for ki in fki.members:
            y = ki.kernel.execute(y)
        return y

    calls = {"fused": lambda: fki.execute(x), "staged": staged}
    out = {}
    check = {k: f().cpu() for k, f in calls.items()}
    if not np.array_equal(check["fused"].numpy(), check["staged"].numpy()):
        raise RuntimeError("the fused call's counts differ from the staged "
                           "ops'")
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        n = 200
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        ms = smoke.cuda_ms(fn, n)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        dev_ms = kernels = 0.0
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                dev_ms += e.self_device_time_total / 1e3 / 20
                kernels += e.count / 20
        out[name] = dict(wall_ms=wall_ms, event_ms=ms, device_ms=dev_ms,
                         kernels_per_call=kernels)
    te.close()
    return out


def jobs(smoke, st, rounds: int, frames: int, seed: int,
         trace: str = "", trace_dir: str = ""):
    """[golden]'s graphs fused and staged, in turns; then, with `trace`,
    three runs of that graph in each mode whose host spans go to
    `trace_dir`."""
    from scanner_tpu_torch.graph import fusion
    smoke.register_smoke_ops(st)
    work = tempfile.mkdtemp(prefix="fusion_ab_")
    try:
        gpu = st.Client(db_path=os.path.join(work, "db"), device="cuda")
        gpu.new_table("golden", ["frame"],
                      [[f] for f in smoke.make_frames(frames, seed)],
                      codecs={"frame": "pickle"})

        def graph(what):
            src = gpu.io.Input([st.NamedStream(gpu, "golden")])
            col = gpu.ops.Blur(frame=gpu.ops.Resize(
                frame=src, width=[smoke.W // 2], height=[smoke.H // 2]),
                kernel_size=3, sigma=1.1)
            if what == "a":
                return gpu.ops.FrameRows(frame=col)
            col = gpu.ops.Histogram(frame=col)
            return col if what == "b" else gpu.ops.HistDiff(frame=col)

        order = []
        for r in range(rounds):
            order += ["fused", "staged"] if r % 2 == 0 else ["staged",
                                                              "fused"]
        fps = {(m, w): [] for m in ("fused", "staged") for w in "abc"}
        for turn, mode in enumerate(order):
            fusion.set_enabled(mode == "fused")
            try:
                row = {"turn": turn, "mode": mode}
                for what in "abc":
                    t0 = time.time()
                    job = gpu.run(gpu.io.Output(graph(what), [
                        st.NamedStream(gpu, f"{what}_{turn}")]),
                        st.PerfParams.manual(8, 16), show_progress=False,
                        cache_mode=st.CacheMode.Overwrite)
                    f = frames / (time.time() - t0)
                    fps[(mode, what)].append(f)
                    row[f"{what}_fps"] = f
                    row[f"{what}_stage_s"] = {
                        k: round(v["total_s"], 4) for k, v in
                        gpu.get_profile(job).statistics().items()
                        if k in ("load", "evaluate")
                        or k.startswith("evaluate:")}
                print(json.dumps(row, sort_keys=True), flush=True)
            finally:
                fusion.set_enabled(True)
        traces = {}
        for i in range(3 if trace else 0):
            for mode in ("fused", "staged"):
                fusion.set_enabled(mode == "fused")
                try:
                    t0 = time.time()
                    job = gpu.run(gpu.io.Output(graph(trace), [
                        st.NamedStream(gpu, f"{trace}_trace_{mode}")]),
                        st.PerfParams.manual(8, 16), show_progress=False,
                        cache_mode=st.CacheMode.Overwrite)
                    wall = time.time() - t0
                finally:
                    fusion.set_enabled(True)
                path = os.path.join(trace_dir, f"{trace}_{mode}_{i}.json")
                gpu.get_profile(job).write_trace(path)
                traces[f"{trace}_{mode}_{i}"] = dict(start=t0, wall_s=wall)
        return {f"{w}_{m}_median_fps": statistics.median(v)
                for (m, w), v in fps.items()} | {
            f"{w}_{m}_fps": v for (m, w), v in fps.items()} | traces
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--trace", default="", choices=["", "a", "b", "c"])
    ap.add_argument("--trace-dir", default=".")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import scanner_tpu_torch as st
    import scanner_tpu_torch.kernels  # noqa: F401  (registers the ops)
    smoke = load_smoke()
    lines = [smoke.card_line(),
             json.dumps({"call": chain_call(smoke, st, args.seed)}),
             json.dumps({"jobs": jobs(smoke, st, args.rounds, args.frames,
                                      args.seed, args.trace,
                                      args.trace_dir)})]
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
