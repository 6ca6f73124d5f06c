#!/usr/bin/env python3
"""Where the time of the port's pose train step goes, on one CUDA card.

    python3 tools/torch_profile_pose.py [--out FILE]

Builds the step `chip_smoke.py`'s [pose_train] phase drives
(VideoPoseNet width 32, two temporal blocks, ring attention on one rank
through the flash kernel, Adam, one clip batch of chip_smoke.py's shape,
(2, 2048, 64, 64, 3), from seed 0),
warms it up, then traces three steps with torch.profiler (CPU and
CUDA activities).  Prints the step's wall time, the summed device time
of its kernels, the device's busy share (summed kernel time over wall;
overlapping kernels would count twice, and one stream runs here), and
the 25 kernels with the most device time; with --out, writes the
profiler's full table of ops to FILE.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, TOP = 3, 25


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="file for the profiler's full table")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: this tool measures the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from chip_smoke import TRAIN_BATCH, TRAIN_SIZE, TRAIN_TIME
    from torch.profiler import ProfilerActivity, profile

    from scanner_tpu_torch.models import pose, pose_train
    from scanner_tpu_torch.parallel import make_ring_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    clip, target, _ = pose_train.synth_batch(np.random.RandomState(0),
                                             TRAIN_BATCH, TRAIN_TIME,
                                             TRAIN_SIZE)
    clip = torch.from_numpy(clip).to(dev)
    target = torch.from_numpy(target).to(dev)
    model = pose.init_params(0, device=dev, width=32, temporal_layers=2,
                             attn_fn=make_ring_attention(impl="cuda"))
    _, step = pose.make_train_step(model)
    for _ in range(3):
        step(clip, target)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(STEPS):
            step(clip, target)
        torch.cuda.synchronize()
        wall = (time.time() - t0) / STEPS
    # device-side kernels only: the CPU ops that launched them, and
    # annotated ranges on the device (the optimizer's step), carry the
    # same time again
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    if not events:
        print("the trace holds no device time", file=sys.stderr)
        return 1
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 \
        / STEPS
    print(f"card: {card}")
    print(f"clip {TRAIN_BATCH}x{TRAIN_TIME}x{TRAIN_SIZE}x{TRAIN_SIZE}x3, "
          f"{STEPS} traced steps: "
          f"wall {wall * 1e3:.3f} ms/step, device {device_ms:.3f} ms/step, "
          f"busy share {device_ms / (wall * 1e3):.3f}")
    print(f"{'ms/step':>9} {'share':>6} {'calls/step':>10}  kernel")
    for e in events[:TOP]:
        ms = e.self_device_time_total / 1e3 / STEPS
        print(f"{ms:9.3f} {ms / device_ms:6.3f} "
              f"{e.count / STEPS:10.1f}  {e.key[:100]}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=80))
    return 0


if __name__ == "__main__":
    sys.exit(main())
