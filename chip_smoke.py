#!/usr/bin/env python3
"""Drive scanner_tpu_torch's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--frames 600] [--seed 0]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Phases, each printed on its own line; any failure exits non-zero:

  1. environment  torch / CUDA versions, the card's name and power limit,
                  which optional libraries were found;
  2. build        the CUDA histogram kernel (nvcc, sm_90a) from the
                  checkout's sources, and libscvid where libav is present;
  3. kernel       the kernel against its plain PyTorch version, bit for
                  bit, at the main path's shape (16 x 480 x 640 x 3), a
                  ragged shape, flat frames, and the int32-id entry;
  4. color        the YUV420 -> RGB conversion on the card against the
                  host numpy flavor, bit for bit;
  5. main path    configs 1 (Histogram) and 2 (Histogram ->
                  HistogramDelta), and HistDiff -> ShotBoundary, over 600
                  frames of 640 x 480 with PerfParams.manual(32, 96)
                  through Client(device="cuda");
                  the stored rows must equal the port's own
                  Client(device="cpu") run byte for byte, and the kernel's
                  launch counter must move in each run;
  6. timings      the kernel, its bound, its plain version and one
                  torch.bincount call at the main path's shape.

The frames are made from --seed (the repo's deterministic test pattern
plus seeded noise) and stored with Client.new_table as a pickled-frame
column: the card's machine has no libav, so the main path reads a stored
frame table, not a video stream (PERF.md, "H100 port").  Everything else
— Client.run -> executor -> evaluator -> kernel -> sink — is the path a
user's job takes.

The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet) for the bound: HBM3 bytes
# per second, and the int32 ALU rate, taken as half the 67 TFLOP/s fp32
# rate (Hopper issues int32 on half as many lanes as fp32)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# integer operations per input byte in the kernel: multiply, shift, add
HIST_OPS_PER_BYTE = 3

W, H, C, BINS = 640, 480, 3, 16
WORK, IO = 32, 96
# L1 histogram distance (of 3 x 640 x 480 counts) that flags a boundary
SHOT_THRESHOLD = 100000.0


class PhaseError(RuntimeError):
    pass


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def have_module(name: str) -> bool:
    import importlib.util
    return importlib.util.find_spec(name) is not None


def have_libav() -> bool:
    r = subprocess.run(["pkg-config", "--exists", "libavformat",
                        "libavcodec", "libavutil", "libswscale"],
                       capture_output=True) if shutil.which("pkg-config") \
        else None
    return r is not None and r.returncode == 0


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events around
    `iters` calls after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def make_frames(n: int, seed: int):
    """(n, 480, 640, 3) uint8: the repo's per-frame test pattern (flat
    color planes, a gradient, a moving square) plus seeded noise in
    [0, 16)."""
    import numpy as np
    from scanner_tpu_torch.video.ingest import frame_pattern
    rng = np.random.RandomState(seed)
    out = np.empty((n, H, W, C), np.uint8)
    for i in range(n):
        f = frame_pattern(i, H, W).astype(np.int16)
        f += rng.randint(0, 16, (H, W, C), dtype=np.int16)
        out[i] = np.minimum(f, 255)
    return out


def stored_items(db, table: str):
    desc = db.table_descriptor(table)
    return list(db.load_column(table, desc.columns[0].name))


def run_config(client, st, config, out: str):
    """Run config 1, config 2 or "shot" (HistDiff -> ShotBoundary) into
    table `out`; returns (wall seconds, the job's stage seconds {load,
    evaluate, save, evaluate:<op>})."""
    src = client.io.Input([st.NamedStream(client, "frames")])
    if config == "shot":
        col = client.ops.ShotBoundary(diff=client.ops.HistDiff(frame=src),
                                      threshold=[SHOT_THRESHOLD])
    else:
        col = client.ops.Histogram(frame=src)
    if config == 2:
        col = client.ops.HistogramDelta(hist=col)
    t0 = time.time()
    job = client.run(client.io.Output(col, [st.NamedStream(client, out)]),
                     st.PerfParams.manual(WORK, IO), show_progress=False,
                     cache_mode=st.CacheMode.Overwrite)
    wall = time.time() - t0
    stats = client.get_profile(job).statistics()
    return wall, {k: round(v["total_s"], 4) for k, v in stats.items()
                  if k in ("load", "evaluate", "save")
                  or k.startswith("evaluate:")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "scanner_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(scanner_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: chip_smoke.py measures the card and has no "
              "CPU mode", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import scanner_tpu_torch as st
    import scanner_tpu_torch.kernels  # noqa: F401
    from scanner_tpu_torch import native
    from scanner_tpu_torch.kernels import color, cuda_ops

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    libav = have_libav()
    phase("environment", python=sys.version.split()[0],
          torch=torch.__version__, cuda=torch.version.cuda,
          card=repr(card), libav=libav,
          msgpack=have_module("msgpack"),
          cloudpickle=have_module("cloudpickle"),
          google_crc32c=have_module("google_crc32c"),
          main_path_source="stored-frame-table")

    # -- build ----------------------------------------------------------
    cuda_ops.load_library()
    scvid = "skipped (no libav; the main path reads a stored frame table)"
    if libav:
        from scanner_tpu_torch.video import lib as vlib
        vlib.get_lib()
        scvid = f"{native.build_seconds.get('libscvid.so', 0.0):.2f}s"
    phase("build", histogram_kernel_s=round(
        native.build_seconds.get("libscanner_hist.so", 0.0), 3),
        libscvid=repr(scvid))

    # -- kernel check ---------------------------------------------------
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(args.seed)
    max_err = 0

    def compare(got, want, what):
        nonlocal max_err
        torch.cuda.synchronize()
        err = int((got.cpu().to(torch.int64)
                   - want.to(torch.int64)).abs().max()) \
            if want.numel() else 0
        max_err = max(max_err, err)
        check(err == 0 and torch.equal(got.cpu(), want),
              f"histogram kernel disagrees with its plain version: {what}")

    for shape in [(16, H, W, C), (3, 97, 131, 3)]:
        f = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
        compare(cuda_ops.histogram_frames(f.to(dev)),
                cuda_ops.histogram_frames_plain(f), f"frames {shape}")
        compare(cuda_ops.histogram_frames(f.to(dev)[1:]),
                cuda_ops.histogram_frames_plain(f[1:]),
                f"unaligned view {shape}")
    flat = torch.full((16, H, W, C), 200, dtype=torch.uint8)
    compare(cuda_ops.histogram_frames(flat.to(dev)),
            cuda_ops.histogram_frames_plain(flat), "flat frames")
    ids = torch.randint(-2, BINS + 3, (48, 30001), generator=g,
                        dtype=torch.int32)
    compare(cuda_ops.histogram_ids(ids.to(dev), BINS),
            cuda_ops.histogram_ids_plain(ids, BINS), "int32 ids + padding")
    phase("kernel", checks=5, max_abs_err=max_err, tolerance=0)

    # -- color check ----------------------------------------------------
    rng = np.random.RandomState(args.seed)
    for h, w in [(H, W), (97, 129)]:
        n = h * w + 2 * ((h + 1) // 2) * ((w + 1) // 2)
        yuv = rng.randint(0, 256, (4, n)).astype(np.uint8)
        got = color.yuv420_to_rgb_device(torch.from_numpy(yuv).to(dev),
                                         h, w)
        check(bool((got.cpu().numpy()
                    == color.yuv420_to_rgb_host(yuv, h, w)).all()),
              f"yuv420 conversion on the card differs at {h}x{w}")
    phase("color", geometries="480x640,97x129", tolerance=0)

    # -- main path ------------------------------------------------------
    frames = make_frames(args.frames, args.seed)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        db_path = os.path.join(work, "db")
        gpu = st.Client(db_path=db_path, device="cuda")
        gpu.new_table("frames", ["frame"], [[f] for f in frames],
                      codecs={"frame": "pickle"})
        secs, stages, launches = {}, {}, {}
        for cfg in (1, 2, "shot"):
            cuda_ops.reset_counts()
            secs[cfg], stages[cfg] = run_config(gpu, st, cfg,
                                                f"config{cfg}_cuda")
            launches[cfg] = cuda_ops.histogram_launches
            check(launches[cfg] > 0,
                  f"config {cfg}: the histogram kernel never launched")
        cpu = st.Client(db_path=db_path, device="cpu")
        for cfg in (1, 2, "shot"):
            run_config(cpu, st, cfg, f"config{cfg}_cpu")
            a = stored_items(cpu._db, f"config{cfg}_cuda")
            b = stored_items(cpu._db, f"config{cfg}_cpu")
            check(len(a) == len(b) == args.frames,
                  f"config {cfg}: {len(a)} vs {len(b)} stored rows")
            check(a == b, f"config {cfg}: stored rows differ between "
                          f"device=cuda and device=cpu")
        hist = np.stack(list(st.NamedStream(cpu, "config1_cuda").load()))
        check(hist.shape == (args.frames, C, BINS)
              and hist.dtype == np.int32
              and bool((hist.sum(axis=2) == H * W).all()),
              "config 1 output is not one (3, 16) count per frame")
        delta = np.asarray(list(st.NamedStream(cpu, "config2_cuda").load()))
        check(bool(np.isfinite(delta).all()) and delta[0] == 0.0,
              "config 2 output is not finite L1 deltas")
        shots = list(st.NamedStream(cpu, "configshot_cuda").load())
        check(all(isinstance(b, bool) for b in shots) and not shots[0],
              "HistDiff -> ShotBoundary output is not one flag per frame")
        phase("main_path", frames=args.frames, geometry=f"{W}x{H}",
              perf=f"manual({WORK},{IO})", rows_identical_to_cpu=True,
              config1_fps=round(args.frames / secs[1], 3),
              config2_fps=round(args.frames / secs[2], 3),
              shot_fps=round(args.frames / secs["shot"], 3),
              config1_launches=launches[1], config2_launches=launches[2],
              shot_launches=launches["shot"],
              config1_wall_s=round(secs[1], 4),
              config1_stage_s=json.dumps(stages[1], sort_keys=True),
              config2_stage_s=json.dumps(stages[2], sort_keys=True))

        # -- timings at the main path's shape -------------------------
        x = torch.from_numpy(frames[:16]).to(dev)
        b, hh, ww, c = x.shape
        ms = cuda_ms(lambda: cuda_ops.histogram_frames(x), 200)
        plain_ms = cuda_ms(lambda: cuda_ops.histogram_frames_plain(x), 50)
        off = (((x.to(torch.int64) * BINS) >> 8)
               + torch.arange(c, device=dev) * BINS).reshape(b, -1) \
            + (torch.arange(b, device=dev) * (c * BINS))[:, None]
        off = off.reshape(-1)
        library_ms = cuda_ms(
            lambda: torch.bincount(off, minlength=b * c * BINS), 50)
        nbytes = x.numel() + b * c * BINS * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = x.numel() * HIST_OPS_PER_BYTE / INT32_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        phase("timings", shape=f"{b}x{hh}x{ww}x{c}", kernel_ms=ms,
              plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
              launches_per_600_frame_run=launches[1], card=repr(card))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "histogram_frames",
        "route": "cuda",
        "source": "scanner_tpu_torch/csrc/histogram.cu",
        "replaces": "scanner_tpu/kernels/pallas_ops.py:33",
        "launches": launches[1],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
