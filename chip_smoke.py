#!/usr/bin/env python3
"""Drive scanner_tpu_torch's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--frames 600] [--seed 0]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Phases, each printed on its own line; any failure exits non-zero:

  1. environment  torch / CUDA versions, the card's name and power limit,
                  which optional libraries were found;
  2. build        the CUDA histogram and flash-attention kernels (nvcc,
                  sm_90a, both started together) from the checkout's
                  sources, and libscvid where libav is present; with
                  cuobjdump, the count of HGMMA (wgmma) and UTMALDG (TMA
                  load) instructions in the flash library's SASS and the
                  instructions per input byte of the histogram's hot
                  loop; the card's SM count, how many clusters of each
                  size the histogram kernel fits at once, and the blocks
                  per frame it takes at the batch sizes checked;
  3. kernel       the histogram kernel against its plain PyTorch version,
                  bit for bit: 480 x 640 x 3 batches of 1, 8, 16, 32 and
                  33 frames, C = 1..4 with 1, 16, 17 and 128 bins, an
                  unaligned view, views at byte offsets 0..15 of one
                  buffer, channels flat at 0, 255 and 128, a flat
                  1920 x 1080 frame, and the int32-id entry with padding
                  ids;
  4. attention_kernel  the flash-attention kernel (TF32 on the tensor
                  cores) against its plain version fed the same TF32
                  operands (m, l: rtol 2e-4, atol 2e-5; acc / l: rtol
                  2e-4, atol 2 * 2^-11 * max|v|) at (BH, T, D) = (16,
                  2048, 128) causal and not, D = 8, D = 32 causal and not
                  (the train step's call), a ragged Tq != Tk, nonzero
                  offsets, D % 4 != 0, D = 128 with Tq, Tk that no tile
                  divides, more blocks than one wave, a causal block
                  wholly before the queries, a fully masked block (the
                  carry bit for bit) and a chained two-block update;
  5. color        the YUV420 -> RGB conversion on the card against the
                  host numpy flavor, bit for bit;
  6. main path    configs 1 (Histogram) and 2 (Histogram ->
                  HistogramDelta), and HistDiff -> ShotBoundary, over 600
                  frames of 640 x 480 with PerfParams.manual(32, 96)
                  through Client(device="cuda");
                  the stored rows must equal the port's own
                  Client(device="cpu") run byte for byte, and the kernel's
                  launch counter must move in each run.  Around it, on
                  the same client (which serves telemetry on an
                  ephemeral loopback port and starts the process health
                  engine and remediation controller):
     health       what the engine sampled while configs 1, 2 and shot
                  ran (ticks, firing rules, Client.health(), the card's
                  memory in use, which must be > 0, and busy seconds),
                  then configs 1 and 2 with the engine and controller off
                  against on, in turns; the host time of each engine tick;
     telemetry    config 1 with /metrics scraped every 0.1 s, then
                  /metrics, /healthz, /readyz, /alertz, /statusz once:
                  the card's device="cuda:N" series and the statusz
                  panels health, memory, framecache, efficiency and
                  remediation must be there; scrape times;
     device_trace config 1 at profiler_level=2: torch.profiler's capture
                  merged by Profile.write_trace must hold the histogram
                  kernel by name once per counted launch, each inside
                  the host window and tied by the trace's correlation id
                  to the runtime call that launched it, which must lie
                  inside an evaluate:Histogram span; each kernel's start
                  after its span's end, after its launch call and after
                  its launch's first kernel, and the alignment anchor's
                  duration; the card's busy share of that window
                  (kernels, copies, fills);
     serial       config 1 under SCANNER_TPU_NO_PIPELINING=1: rows the
                  same bytes as the pipelined run's;
     worker_task  config 1 through a cluster worker's task path on
                  cuda:0 with no RPC: the master's admission (tables
                  created on the host), then service.WorkerPipeline,
                  the code a Worker runs each bulk through, fed the
                  tasks from a local list in place of the master's
                  queue; rows the same bytes as config 1's, and as many
                  histogram launches;
     cluster      a Master and a Worker(device="cuda:0") in this
                  process, each with a gRPC server on 127.0.0.1 at an
                  ephemeral port, and Client(master=...): configs 1 and
                  2 over the same 600 frames (a table of their own
                  database), rows the same bytes as the main path's;
                  frames/s, tasks, and the worker's histogram
                  launches, which must equal the main path's.  Then
                  a fault drill: a second worker on cuda:0, the first
                  evaluated task raises (util/faults,
                  "pipeline.eval:raise:n=1:times=1"), and the job must
                  finish with the same rows and the retry in
                  Client.job_status().  Last shutdown_cluster(): every
                  RPC, scan, heartbeat and work-loop thread must stop.
                  Skipped, and said so, when the machine lacks grpcio
                  (decided from the environment before the phase);
     gang         gang bulks (gang_hosts=2, PerfParams.manual(32, 320):
                  two tasks a job) through a Master and two
                  Worker(device="cuda:0") in this process: each task
                  runs on two member child processes sharing the card
                  (the card's compute mode must allow a second context),
                  joined in one gloo group.  Configs 1 and 2 sharded,
                  config 1 replicated, and a drill whose first member
                  fails at its collective once (parent-side
                  "gang.collective:raise:n=1:times=1"): the gang must
                  re-form at a higher epoch with no strike.  Rows the
                  same bytes as the main path's, every member result ok
                  (but the drill's one), each member's histogram
                  launches (folded from its child) at least one per
                  non-empty shard, no member left running, every server
                  thread stopped; frames/s per job, the spawn time and
                  the medians of the rendezvous, stage, barrier,
                  collective and assemble phases, gather bytes, decode
                  rows and epochs (spawn = the member process up to
                  its entry point, device = its card's context).
                  Skipped with [cluster];
     coordinator  a Master in this process and one
                  Worker(device="cuda:N", coordinator=CoordinatorConfig(
                  <free port>, 1, 0)) in a child process (one process
                  holds one default group, and [sharded] forms its own
                  here): the worker joins a one-rank NCCL group for its
                  lifetime before it registers, runs config 1 over the
                  600 frames, and leaves the group when shut down.  Rows
                  the same bytes as the main path's, the child's
                  histogram launches equal config 1's, its group nccl of
                  world size 1 with the join seconds, no child left.
                  Skipped with [cluster];
     chaos        tools/torch_chaos_run.py --device cuda:N, its master
                  and two worker processes sharing the card, for the
                  memory-pressure plan (a host-to-card staging OOM in one
                  worker; Histogram over a stored table of 24 seeded
                  640 x 480 frames) and then worker-crash: each plan must
                  fire, its rows be bit-exact to the clean run, no
                  process of the tool's tree be left; the workers'
                  histogram launches (each writes its count when shut
                  down) must be > 0 for memory-pressure; the seconds of
                  each run.  Skipped with [cluster];
     tools        a Master here and a Worker(device="cuda:N") run config
                  1 over the 600 frames, then tools/torch_top.py --once
                  --json, tools/torch_trace.py --verify --json and
                  tools/torch_cost.py --json as processes against it:
                  each exits 0; top's document names the worker's node
                  and the card with nonzero eval rows, trace's chains
                  are complete, cost lists Histogram on the card; the
                  rows equal [main_path]'s; the seconds of each call.
                  Skipped with [cluster];
  7. pose_serve   PoseDetect(width=8) with the shipped weights over a
                  stored table of 48 x 48 blob frames through
                  Client(device="cuda"): mean localization error under
                  5 px, keypoints against the port's Client(device="cpu")
                  run, frames/s;
  8. pose_train   VideoPoseNet(width=32, temporal_layers=2) trained five
                  Adam steps on one (2, 2048, 64, 64, 3) clip batch with
                  ring attention on one rank through the flash kernel
                  (impl="cuda"): finite, decreasing losses, two kernel
                  launches per step, the first two losses within rel
                  1e-3 of impl="xla" (the plain ring), step time; the
                  kernel against its plain version on the q, k, v that
                  the first step's first temporal block gave it;
  8a. train     every train loop of the port on the card at the shipped
                  configurations and the reference's step counts
                  (train_pose 300 with the one-rank "cuda" ring,
                  train_detector 300 on rect and on face scenes,
                  train_embedding 300, train_segmenter 400), each saving
                  through TrainCheckpointer and exporting its .npz:
                  finite losses, the last below the first, the flash
                  kernel launched once per temporal block and pose step
                  and held against its plain version on the q, k, v the
                  first step gave it, then timed at that shape; steps/s
                  and frames/s per loop, the save seconds, the card's
                  idle share over one profiled step each.  Pose trained
                  20 steps, saved, restored into a fresh model and Adam
                  and trained 10 more, against an uninterrupted 30-step
                  run (rel 1e-4, deterministic cuDNN).  PoseDetect on the
                  pose checkpoint and ObjectDetect on the detector's
                  .npz through Client(device="cuda") against the
                  in-memory trained models, with the keypoint error and
                  the recall beside the shipped and random weights';
  9. model_serve  ObjectDetect, FaceEmbedding and InstanceSegment (width
                  8, the shipped weights) over 128 stored 640 x 480
                  frames through Client(device="cuda"): frames/s of two
                  card runs and of the port's CPU run, and a torch.profiler
                  trace of one call each (the device's busy share, the
                  kernels with the most device time).  Then the shipped
                  tasks' scenes (64 x 64, 40 each) on the card and on the
                  CPU: ObjectDetect and FaceDetect recall >= 0.7 at IoU
                  0.3, FaceEmbedding recall@1 >= 0.75 over 8 identities,
                  InstanceSegment recall >= 0.7, mask IoU >= 0.55 and the
                  right shape kind ahead by 0.05 (tests/test_models.py's
                  bounds); against the CPU's rows, every CPU box met
                  within IoU 0.9 on >= 95 % of frames, embeddings at
                  cosine >= 0.99, masks at IoU >= 0.9 where matched;
  9a. dp_apply   ObjectDetect (13 frames of 640 x 480, and 39 of the
                  rect scenes at score_thresh 0.3) and PoseDetect (13
                  blob frames of 48 x 48), width 8, shipped weights,
                  through DataParallelApply over every card (two entries
                  of cuda:0 on a one-card machine; odd batches over two
                  replicas pad one) against the same op on one device,
                  with [model_serve]'s bounds where it applies them:
                  boxes within IoU 0.9 on >= 95 % of the rect scenes, the
                  blob keypoint within one heatmap cell; the 640 x 480
                  agreement at score_thresh 0.05 printed with the
                  highest score of an unmatched box; on one card every
                  op's rows the same bytes as one device's run on the
                  replicas' shards; the gathered rows on the first device; ms per call on one device and
                  over the replicas, cost_flops of each (equal);
 10. golden       the bench's Resize(320, 240) -> Blur(3, 1.1) ->
                  Histogram -> HistDiff chain, CropResize (64 x 64, boxes
                  from 4 % to 94 % of the frame) and OpticalFlow over 96
                  stored 640 x 480 frames, on the card and on the CPU:
                  pixels within 1 count of the CPU's, every Histogram row
                  the plain histogram of the card's own Resize -> Blur
                  frame, every HistDiff row the plain version's over those
                  rows, flow within atol 1e-3, and the histogram kernel
                  launched through both its entries (frames, ids).  The
                  chain graphs (a) Resize -> Blur, (b) + Histogram, (c) +
                  HistDiff run twice on the card: fused (the default: the
                  Resize+Blur[+Histogram] chain replays one CUDA graph per
                  bucket) and staged (fusion off), whose rows must be the
                  same bytes; it prints the chains planned, graphs
                  captured and replayed, the histogram launches made by
                  replays (at least one) and both runs' frames/s.  One
                  more fused (b) job at profiler_level=2: its trace must
                  show the histogram kernel once per counted launch (the
                  graph replays' launches), each launched by a
                  cudaGraphLaunch inside the chain's span (as in
                  [device_trace]);
 11. ledgers      after configs 1, 2 and shot, and again after [golden]:
                  Client.memory_report()'s live and watermark bytes by
                  buffer kind beside torch.cuda.max_memory_allocated, and
                  Client.compile_report()'s compile entries and roofline
                  rows (Histogram, HistDiff; then Resize, Blur and the
                  chains); any roofline efficiency above 1.05 fails (a
                  count or a time would be wrong);
 12. warmup       the golden (b) graph, resized to 160 x 120 (no graph of
                  [golden] serves it: chain graphs are kept per process),
                  over 32 stored frames through an executor that hands
                  its evaluator the hint
                  precompile=(480, 640, 8) (a stored frame table carries
                  no video geometry): every rung of the chain's bucket
                  ladder must be captured by the warm-up, and the first
                  real call must capture nothing;
 13. timings      each kernel at its timing shape with its bound, its
                  plain version and one library call (torch.bincount;
                  F.scaled_dot_product_attention in f32), by CUDA events
                  around wrapper calls, and the kernel's device time
                  alone from torch.profiler, per event, with the events
                  per call beside it; the flash kernel also at the
                  train step's shape.  The histogram is also timed cold
                  (calls cycle over 8 distinct batches, past the L2), on
                  flat frames, at B = 8 and 32, and with every kernel a
                  wrapper call runs (it must be one).
 13a. sharded    in-program sharding on a one-rank NCCL group on the card
                  (formed in the phase, destroyed before it ends): (a) a
                  (dp, sp, tp) = (1, 1, 1) DeviceMesh from make_mesh's
                  layout, shard_batch and replicate_to_global of config
                  1's stored rows, temporal_diff over them bit for bit
                  against the plain row difference; (b) Ulysses on the
                  one-rank sp group at (2, 2048, 4, 32) f32 against
                  reference_attention (rtol 2e-4, atol 2e-5); (c)
                  make_pipeline at pp 1, M 2 against its stage, and a
                  one-stage pipelined VideoPoseNet against the plain
                  layout after pp_params_to_plain (within 1e-2 of the
                  output's scale, bf16); (d) make_sharded_train_step at
                  the JAX package's defaults (clip (8, 8, 64, 64, 3),
                  width 32), six steps without and with remat under
                  deterministic cuDNN: steps/s, step ms, peak bytes
                  (and the part above what was allocated at the reset),
                  the bytes one forward holds for its backward, and
                  losses of each; the losses equal, falling, the first
                  within rel 1e-3 of the unsharded make_train_step's;
                  (e) a DCP save of (d)'s sharded state and a restore
                  into a fresh step: the next loss bit for bit;
 14. framecache   the process frame cache on the card at 256 MB over the
                  600 frames in the YUV420 wire (460,800 B each): a
                  stencil pass, two dense passes of 96-frame tasks and a
                  Gather of a hot clip, each task's tensor equal to
                  direct staging; hits, LRU eviction at capacity, no
                  leaked pins; a 96-frame page gather against staging
                  from the host.  Then the closed loop: device memory
                  past 93 % of the card's must fire hbm_pressure and the
                  controller's frame_cache_shrink must shrink the pool to
                  half its occupancy within 15 s (audited "applied").
                  Last, because its ballast fills the card.

The frames are made from --seed (the repo's deterministic test pattern
plus seeded noise) and stored with Client.new_table as a pickled-frame
column: the card's machine has no libav, so the main path reads a stored
frame table, not a video stream (PERF.md, "H100 port").  Everything else
— Client.run -> executor -> evaluator -> kernel -> sink — is the path a
user's job takes.

The line before the last is a JSON object {"kernels": [...]}; the
histogram's `launches` counts config 1's run, [worker_task]'s,
[cluster]'s, [gang]'s, [coordinator]'s, [chaos]'s and [tools]' runs (a
gang member's launches, made in its child process, are folded into this
process's count by its worker; [coordinator]'s child and [chaos]'s
workers report their own), and
the golden phase's card runs, fused and staged (a
graph replay counts the launches the graph holds:
cuda_ops.count_replay); the flash kernel's counts [pose_train]'s five
steps and [train]'s 300 pose steps.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import itertools
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet) for the bound: HBM3 bytes
# per second, and the INT32 rate: 132 SMs x 64 INT32 lanes x 1.98 GHz
# (each SM issues 4 x 32 lanes a cycle, half of them INT32; the data
# sheet's 67 TFLOP/s fp32 counts an FMA as two operations).  The
# histogram's bytes bind it: 4.4 us against 2.6 us of INT32 work at the
# main path's shape.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12
# integer operations per input byte in the kernel: multiply, shift, add
HIST_OPS_PER_BYTE = 3
# distinct batches a cold timing cycles over: 8 x 14.7 MB at the main
# path's shape, past the H100's 50 MB L2
COLD_BATCHES = 8
# the flash kernel's products run on the tensor cores in TF32: the H100
# SXM's dense TF32 rate (NVIDIA data sheet); its exponentials run on the
# special-function units, about 3.9e12 per second on an H100 SXM5
# (FlashAttention-3, Shah et al. 2024)
TF32_FLOPS_PER_S = 495e12
EXP_PER_S = 3.9e12
# The kernel multiplies TF32 operands (kernels/attention.py
# TF32_ROUNDING), so it is held against the plain version fed those same
# operands (tf32_operand).  The logits then differ only in f32 summation
# order: m and l keep the f32 tolerance of tests/test_parallel.py.  The
# kernel also rounds the probabilities p to TF32 for p . V (relative
# error at most 2^-11 each) and the plain version does not, so acc / l
# takes atol 2 * 2^-11 * max|v| beside rtol 2e-4.
FLASH_RTOL, FLASH_ATOL = 2e-4, 2e-5
TF32_UNIT = 2.0 ** -11
FLASH_SHAPE = (16, 2048, 128)   # (BH, T, D), tools/tpu_window.py's
POSE_SIZE, TRAIN_SIZE, TRAIN_BATCH, TRAIN_STEPS = 48, 64, 2, 5
TRAIN_TIME = 2048               # frames per train clip: a long clip
# (B * heads, T, D) of the train step's flash call: width 32 gives 128
# channels in 4 heads of 32
TRAIN_FLASH_SHAPE = (TRAIN_BATCH * 4, TRAIN_TIME, 32)

W, H, C, BINS = 640, 480, 3, 16
WORK, IO = 32, 96
# [model_serve]: the bench's model configs 4, 5 and 7 (bench.py
# N_MODEL_FRAMES) at width 8, and the shipped tasks' scenes (64 x 64)
MODEL_FRAMES, SCENES = 128, 40
MODEL_OPS = ("ObjectDetect", "FaceEmbedding", "InstanceSegment")
# [golden]: the bench's Resize -> Blur -> Histogram -> HistDiff chain
# (bench.py, PerfParams.manual(8, 16)) over stored 640 x 480 frames
GOLDEN_FRAMES, CROP = 96, 64
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


def device_ms(fn, iters: int, names) -> dict:
    """Device milliseconds per event of each kernel whose name holds one
    of `names`, from torch.profiler over `iters` calls of fn() after a
    warm-up: its summed self device time over the count of its events,
    so a record the profiler drops does not read as a faster kernel.
    Also "events per call" of each of `names`, "all kernels", the device
    time per call of every kernel, fill or copy the calls ran, "kernels
    per call", how many events of those one call ran, and "others", the
    names of those that match none of `names`.  The trace is taken again,
    twice at most, while one of `names` has fewer events than calls (now
    and then a trace comes back with some device records, or all of them,
    missing; seen on an H100), and the take with the most events of
    `names` is read.  A name none of the takes holds reads None (not
    measured), as does "all kernels" when no take holds a device record;
    "empty takes" counts the takes without one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best, empty = None, 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        time_ms = {n: 0.0 for n in names}
        events = {n: 0 for n in names}
        total = count = 0.0
        others = []
        for e in prof.key_averages():
            if not str(e.device_type).endswith("CUDA"):
                continue
            total += e.self_device_time_total / 1e3 / iters
            count += e.count / iters
            hit = [n for n in names if n in e.key]
            for n in hit:
                time_ms[n] += e.self_device_time_total / 1e3
                events[n] += e.count
            if not hit:
                others.append(e.key)
        empty += not count
        take = (time_ms, events, total, count, others)
        if best is None or sum(events.values()) > sum(best[1].values()):
            best = take
        if all(events[n] >= iters for n in names):
            break
    time_ms, events, total, count, others = best
    out = {n: time_ms[n] / events[n] if events[n] else None for n in names}
    out["events per call"] = {n: events[n] / iters for n in names}
    out["all kernels"] = total if count else None
    out["kernels per call"] = count
    out["others"] = others
    out["empty takes"] = empty
    return out


def ratio(a, b):
    """a / b, or None (not measured) when either is."""
    return None if a is None or b is None else a / b


def frame_batches(n: int, shape, seed: int, dev, flat: bool = False):
    """`n` distinct uint8 batches of `shape` made on the card from
    `seed`: uniform random bytes, or each batch one flat value."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    if flat:
        vals = torch.randint(0, 256, (n,), generator=g, device=dev)
        return [torch.full(shape, int(v), dtype=torch.uint8, device=dev)
                for v in vals]
    return [torch.randint(0, 256, shape, generator=g, device=dev,
                          dtype=torch.uint8) for _ in range(n)]


def cycling(fn, batches):
    """A call of fn on the next of `batches` in turn: each batch comes
    back only after the others have passed through the L2."""
    it = itertools.cycle(batches)
    return lambda: fn(next(it))


def hot_loop(lib: str, function: str):
    """(instructions, 16-byte global loads, instructions per input byte)
    of the innermost loop of `function` in the SASS of `lib` that holds
    16-byte global loads (LDG...128): each load brings 16 input bytes.
    None where there is no cuobjdump or no such loop."""
    import re
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                     "cuobjdump")
    if not os.path.exists(tool):
        return None
    r = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                       timeout=300)
    check(r.returncode == 0, f"cuobjdump failed: {r.stderr.strip()}")
    body = None
    for part in r.stdout.split("Function : ")[1:]:
        if function in part.splitlines()[0]:
            body = part
    if body is None:
        return None
    insts, labels, pending = [], {}, []
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
        insts.append((addr, text.split()[0], text))
    best = None
    for addr, op, text in insts:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2),
                                                               16)
        if target is None or target > addr:
            continue
        loop = [o for a, o, _ in insts if target <= a <= addr]
        loads = sum(o.startswith("LDG") and ".128" in o for o in loop)
        if loads and (best is None or len(loop) < best[0]):
            best = (len(loop), loads)
    if best is None:
        return None
    return best[0], best[1], best[0] / (16 * best[1])


def sass_counts(lib: str, opcodes):
    """{opcode: count of instructions} in the SASS of `lib`, by cuobjdump
    from the PATH or the CUDA home; None where there is no cuobjdump."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                     "cuobjdump")
    if not os.path.exists(tool):
        return None
    r = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                       timeout=300)
    check(r.returncode == 0, f"cuobjdump failed: {r.stderr.strip()}")
    lines = r.stdout.splitlines()
    return {op: sum(op in x for x in lines) for op in opcodes}


def flash_bound(BH: int, Tq: int, Tk: int, D: int):
    """(bound ms, what binds, flops) of one flash update: the bound is
    the largest of its TF32 flops, its exponentials and its bytes at the
    card's peaks."""
    flops = 4.0 * BH * Tq * Tk * D
    exps = float(BH * Tq * Tk)
    # q, k, v and the carry (m, l, acc) read once, (m, l, acc) written
    nbytes = 4.0 * (BH * Tq * D + 2 * BH * Tk * D
                    + 2 * (BH * Tq * D + 2 * BH * Tq))
    times = {"operations(TF32 flops at 495 TFLOP/s)":
             flops / TF32_FLOPS_PER_S * 1e3,
             "operations(exp at 3.9e12/s)": exps / EXP_PER_S * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    what = max(times, key=times.get)
    return times[what], what, flops


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


def run_config(client, st, config, out: str, level: int = 1,
               job_ids: list = None, perf=None):
    """Run config 1, config 2 or "shot" (HistDiff -> ShotBoundary) into
    table `out` at profiler level `level` (with `perf`, default
    PerfParams.manual(WORK, IO)); returns (wall seconds, the job's stage
    seconds {load, evaluate, save, evaluate:<op>}); appends the job id
    to `job_ids` when given."""
    src = client.io.Input([st.NamedStream(client, "frames")])
    if config == "shot":
        col = client.ops.ShotBoundary(diff=client.ops.HistDiff(frame=src),
                                      threshold=[SHOT_THRESHOLD])
    else:
        col = client.ops.Histogram(frame=src)
    if config == 2:
        col = client.ops.HistogramDelta(hist=col)
    perf = perf or st.PerfParams.manual(WORK, IO)
    perf.profiler_level = level
    t0 = time.time()
    job = client.run(client.io.Output(col, [st.NamedStream(client, out)]),
                     perf, show_progress=False,
                     cache_mode=st.CacheMode.Overwrite)
    wall = time.time() - t0
    if job_ids is not None:
        job_ids.append(job)
    stats = client.get_profile(job).statistics()
    return wall, {k: round(v["total_s"], 4) for k, v in stats.items()
                  if k in ("load", "evaluate", "save")
                  or k.startswith("evaluate:")}


def flash_inputs(g, BH, Tq, Tk, D, carry, dev):
    """Seeded q (pre-scaled), k, v and a carry: empty (m = NEG_INF,
    l = 0, acc = 0) or set (the state after an earlier block)."""
    import torch
    from scanner_tpu_torch.kernels.attention import NEG_INF
    q = torch.randn(BH, Tq, D, generator=g) * D ** -0.5
    k = torch.randn(BH, Tk, D, generator=g)
    v = torch.randn(BH, Tk, D, generator=g)
    if carry:
        m = torch.randn(BH, Tq, generator=g)
        l = torch.rand(BH, Tq, generator=g) * 2.5 + 0.5
        acc = torch.randn(BH, Tq, D, generator=g)
    else:
        m = torch.full((BH, Tq), NEG_INF)
        l = torch.zeros(BH, Tq)
        acc = torch.zeros(BH, Tq, D)
    return [t.to(dev) for t in (q, k, v, m, l, acc)]


def flash_reference(args, q_off, k_off, causal=False):
    """The plain version on the operands the kernel multiplies: q, k, v
    turned into TF32 as the kernel turns them (kernels/attention.py
    TF32_ROUNDING)."""
    from scanner_tpu_torch.kernels import attention
    q, k, v = (attention.tf32_operand(t, attention.TF32_ROUNDING[n])
               for n, t in zip("qkv", args[:3]))
    return attention.flash_block_update_plain(q, k, v, *args[3:], q_off,
                                              k_off, causal=causal)


def compare_flash(got, args, q_off, k_off, causal, what: str,
                  errs: dict) -> None:
    """Holds the kernel's (m, l, acc) on `args` against flash_reference:
    m and l within FLASH_RTOL / FLASH_ATOL, acc / l within FLASH_RTOL
    and 2 * TF32_UNIT * max|v|.  Raises each entry of `errs` to the
    largest |kernel - reference| seen, and "f32_out" to the largest
    |acc / l| difference from the plain version on the unrounded
    inputs (information, not a check)."""
    import torch
    from scanner_tpu_torch.kernels import attention
    torch.cuda.synchronize()
    want = flash_reference(args, q_off, k_off, causal)
    exact = attention.flash_block_update_plain(*args, q_off, k_off,
                                               causal=causal)
    v_max = float(args[2].abs().max()) if args[2].numel() else 0.0

    def out(state):
        return state[2] / state[1].clamp_min(1e-30)[..., None]
    pairs = {"m": (got[0], want[0], FLASH_ATOL),
             "l": (got[1], want[1], FLASH_ATOL),
             "out": (out(got), out(want), 2 * TF32_UNIT * v_max)}
    for name, (a, b, atol) in pairs.items():
        check(bool(torch.isfinite(a).all()),
              f"flash kernel: non-finite {name} ({what})")
        err = float((a - b).abs().max()) if a.numel() else 0.0
        errs[name] = max(errs[name], err)
        check(bool(((a - b).abs() <= atol + FLASH_RTOL * b.abs()).all()),
              f"flash kernel disagrees with its plain version on TF32 "
              f"operands on {name}: {what} (max abs err {err}, atol "
              f"{atol})")
    if got[1].numel():
        errs["f32_out"] = max(errs["f32_out"], float(
            (out(got) - out(exact)).abs().max()))


def check_attention_kernel(dev, seed: int, errs: dict) -> int:
    """The flash kernel against flash_block_update_plain on the card;
    returns the number of checks."""
    import torch
    from scanner_tpu_torch.kernels import attention
    g = torch.Generator().manual_seed(seed)

    BH, T, D = FLASH_SHAPE
    cases = [  # (what, BH, Tq, Tk, D, q_off, k_off, causal, carry)
        ("16x2048x128", BH, T, T, D, 0, 0, False, False),
        ("16x2048x128 causal", BH, T, T, D, 0, 0, True, False),
        ("D=8 causal", 8, 512, 512, 8, 0, 0, True, False),
        ("D=32 causal", 8, 2048, 2048, 32, 0, 0, True, False),
        ("D=32, the train step's call", 8, 2048, 2048, 32, 0, 0, False,
         False),
        ("ragged Tq=193 Tk=77", 3, 193, 77, 40, 0, 0, False, True),
        ("offsets q_off=100 k_off=37", 5, 130, 150, 64, 100, 37, True,
         True),
        ("D=6, padded to 8", 2, 100, 90, 6, 0, 0, True, True),
        ("D=128, Tq=300 Tk=250, q_off=37 k_off=11", 3, 300, 250, 128, 37,
         11, True, True),
        ("BH=40 T=1024 D=64, 320 blocks", 40, 1024, 1024, 64, 0, 0, False,
         False),
        ("causal, K wholly before the queries", 4, 256, 256, 32, 1024, 0,
         True, True),
    ]
    for what, bh, tq, tk, d, qo, ko, causal, carry in cases:
        args = flash_inputs(g, bh, tq, tk, d, carry, dev)
        compare_flash(attention.flash_block_update(*args, qo, ko,
                                                   causal=causal),
                      args, qo, ko, causal, what, errs)
    for carry in (False, True):   # a block after every query: no change
        args = flash_inputs(g, 4, 100, 64, 32, carry, dev)
        got = attention.flash_block_update(*args, 0, 500, causal=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, args[3:])),
              f"flash kernel changed the state on a fully masked block "
              f"(carry={carry})")
    q, k, v, m, l, acc = flash_inputs(g, 4, 256, 512, 32, True, dev)
    state = (m, l, acc)
    for blk, k_off in ((slice(0, 256), 256), (slice(256, 512), 0)):
        args = [q, k[:, blk], v[:, blk], *state]
        state = attention.flash_block_update(*args, 256, k_off,
                                             causal=True)
        compare_flash(state, args, 256, k_off, True,
                      f"chained two-block update, k_off={k_off}", errs)
    return len(cases) + 4


def run_pose(client, st, out: str, **kw) -> float:
    """PoseDetect(width=8; the shipped weights unless `kw` says other)
    over the "blob" table into `out`; returns wall seconds."""
    poses = client.ops.PoseDetect(
        frame=client.io.Input([st.NamedStream(client, "blob")]), width=8,
        **kw)
    t0 = time.time()
    client.run(client.io.Output(poses, [st.NamedStream(client, out)]),
               st.PerfParams.manual(64, 256), show_progress=False,
               cache_mode=st.CacheMode.Overwrite)
    return time.time() - t0


def pose_serve(st, work: str, seed: int, n: int = 512) -> dict:
    """The serve path: PoseDetect on the card against the port's CPU run
    and against the blobs' true centers."""
    import numpy as np
    from scanner_tpu_torch.kernels import attention, cuda_ops
    from scanner_tpu_torch.models import pose_train
    clips, _, centers = pose_train.synth_batch(
        np.random.RandomState(seed), n // 8, 8, POSE_SIZE)
    frames = clips.reshape(n, POSE_SIZE, POSE_SIZE, 3)
    centers = centers.reshape(n, 2)
    db_path = os.path.join(work, "pose_db")
    gpu = st.Client(db_path=db_path, device="cuda")
    gpu.new_table("blob", ["frame"], [[f] for f in frames],
                  codecs={"frame": "pickle"})
    cuda_ops.reset_counts()
    attention.reset_counts()
    wall = run_pose(gpu, st, "poses_cuda")
    launches = (cuda_ops.histogram_launches, attention.flash_launches)
    wall2 = run_pose(gpu, st, "poses_cuda2")
    cpu = st.Client(db_path=db_path, device="cpu")
    cpu_wall = run_pose(cpu, st, "poses_cpu")
    got = np.stack(list(st.NamedStream(cpu, "poses_cuda").load()))
    ref = np.stack(list(st.NamedStream(cpu, "poses_cpu").load()))
    check(got.shape == ref.shape == (n, 17, 3)
          and bool(np.isfinite(got).all()),
          f"PoseDetect output {got.shape} is not one finite (17, 3) "
          f"keypoint set per frame")
    err = np.hypot(got[:, 0, 0] * 4 - centers[:, 0],
                   got[:, 0, 1] * 4 - centers[:, 1])
    check(float(err.mean()) < 5.0,
          f"PoseDetect mean localization error {err.mean():.3f} px >= 5")
    same = float((got[:, 0, :2] == ref[:, 0, :2]).all(axis=1).mean())
    step = float(np.abs(got[:, 0, :2] - ref[:, 0, :2]).max())
    score_err = float(np.abs(got[:, :, 2] - ref[:, :, 2]).max())
    check(step <= 1.0, f"blob keypoint differs by {step} heatmap cells "
                       f"between device=cuda and device=cpu")
    return dict(frames=n, geometry=f"{POSE_SIZE}x{POSE_SIZE}",
                mean_err_px=float(err.mean()),
                cpu_mean_err_px=float(np.hypot(
                    ref[:, 0, 0] * 4 - centers[:, 0],
                    ref[:, 0, 1] * 4 - centers[:, 1]).mean()),
                kp0_identical_to_cpu=same, kp0_max_cell_diff=step,
                max_score_diff_vs_cpu=score_err,
                fps_first_run=n / wall, fps_second_run=n / wall2,
                cpu_fps=n / cpu_wall, histogram_launches=launches[0],
                flash_launches=launches[1])


def flash_on_ring_inputs(q, k, v, dev, what: str, errs: dict):
    """The flash kernel against its plain version on the q, k, v a train
    step gave the ring, laid out as the one-rank kernel ring lays them
    out: (B, T, H, D) -> (B * H, T, D), q pre-scaled, from an empty
    carry, not causal.  Folds the errors into `errs`; returns the call's
    arguments and its own errors."""
    import torch
    from scanner_tpu_torch.kernels import attention
    from scanner_tpu_torch.kernels.attention import NEG_INF
    B, T, H, D = q.shape

    def rows(x, s=1.0):
        return (x.float() * s).permute(0, 2, 1, 3).reshape(B * H, T, D)
    args = [rows(q, D ** -0.5), rows(k), rows(v),
            torch.full((B * H, T), NEG_INF, device=dev),
            torch.zeros(B * H, T, device=dev),
            torch.zeros(B * H, T, D, device=dev)]
    own = {"m": 0.0, "l": 0.0, "out": 0.0, "f32_out": 0.0}
    compare_flash(attention.flash_block_update(*args, 0, 0), args, 0, 0,
                  False, what, own)
    for name, err in own.items():
        errs[name] = max(errs[name], err)
    return args, own


def pose_train(dev, seed: int, errs: dict) -> dict:
    """The train path: five Adam steps with ring attention through the
    flash kernel, against two steps through the plain ring; then the
    kernel against its plain version on the q, k, v that the first
    step's first temporal block passed to the ring."""
    import numpy as np
    import torch
    from scanner_tpu_torch.kernels import attention, cuda_ops
    from scanner_tpu_torch.models import pose as pose_mod
    from scanner_tpu_torch.models import pose_train as ptrain
    from scanner_tpu_torch.parallel import make_ring_attention
    clip, target, _ = ptrain.synth_batch(np.random.RandomState(seed),
                                         TRAIN_BATCH, TRAIN_TIME, TRAIN_SIZE)
    clip = torch.from_numpy(clip).to(dev)
    target = torch.from_numpy(target).to(dev)
    seen = []   # (q, k, v) of the ring's first call

    def model(impl):
        ring = make_ring_attention(impl=impl)

        def attn(q, k, v):
            if not seen:
                seen.append((q.detach(), k.detach(), v.detach()))
            return ring(q, k, v)
        return pose_mod.init_params(seed, device=dev, width=32,
                                    temporal_layers=2, attn_fn=attn)

    ref = model("xla")
    _, step = pose_mod.make_train_step(ref)
    xla_losses = [float(step(clip, target)) for _ in range(2)]
    del ref, step
    seen.clear()
    net = model("cuda")
    C = net.Backbone_0.out_ch
    heads = net.TemporalBlock_0.heads
    _, step = pose_mod.make_train_step(net)
    losses, secs = [], []
    cuda_ops.reset_counts()
    attention.reset_counts()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        losses.append(float(step(clip, target)))
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
    launches = attention.flash_launches
    hist = cuda_ops.histogram_launches
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    check(losses[1] < losses[0] and losses[-1] < losses[0],
          f"loss did not decrease: {losses}")
    check(launches == 2 * TRAIN_STEPS,
          f"flash kernel launched {launches} times in {TRAIN_STEPS} "
          f"steps; 2 per forward on one rank expected")
    for a, b in zip(losses[:2], xla_losses):
        check(abs(a - b) <= 1e-3 * abs(b),
              f"impl=cuda losses {losses[:2]} differ from impl=xla "
              f"{xla_losses} by more than rel 1e-3")
    step_s = float(np.mean(secs[2:]))
    q, k, v = seen[0]
    B, T, H, D = q.shape
    check((B, T, H * D) == (TRAIN_BATCH, TRAIN_TIME, C) and H == heads
          and (B * H, T, D) == TRAIN_FLASH_SHAPE,
          f"the ring saw q {tuple(q.shape)}, not (B, T, heads, C / heads) "
          f"with (B * heads, T, D) = {TRAIN_FLASH_SHAPE}")
    args, step_errs = flash_on_ring_inputs(
        q, k, v, dev, "the first train step's q, k, v", errs)
    flash_ms = cuda_ms(lambda: attention.flash_block_update(*args, 0, 0),
                       20)
    return dict(clip=f"{TRAIN_BATCH}x{TRAIN_TIME}x{TRAIN_SIZE}x"
                     f"{TRAIN_SIZE}x3", width=32, channels=C, heads=heads,
                head_dim=D, losses=json.dumps(losses),
                xla_losses=json.dumps(xla_losses),
                step_s=json.dumps([round(x, 4) for x in secs]),
                steady_step_s=step_s,
                frames_per_s=TRAIN_BATCH * TRAIN_TIME / step_s,
                flash_launches=launches, histogram_launches=hist,
                step_inputs_max_abs_err=json.dumps(step_errs),
                flash_ms_at_step_shape=flash_ms,
                flash_share_of_step=2 * flash_ms / (step_s * 1e3))


# [train]: every trainer of the port at its shipped configuration and the
# reference's default step count (scanner_tpu/models/*_train.py), and the
# frames one step of each reads
TRAIN_RUNS = {"pose": 300, "detect": 300, "face": 300, "embed": 300,
              "seg": 400}
TRAIN_FRAMES_PER_STEP = {"pose": 4 * 2, "detect": 4, "face": 4,
                         "embed": 16, "seg": 4}
RESUME_STEPS = (20, 10)     # pose: N steps, save, restore, k more
SERVE_BLOBS, SERVE_SCENES = 256, 64
STEP_MARK = "chip_smoke_train_step_end"


class StepLog(logging.Handler):
    """Each logged train step's loss and host time; at each a profiler
    marker, so a trace shows where a step ends (a loop logs a step after
    reading its loss, which waits for the card)."""

    def __init__(self):
        super().__init__()
        self.losses, self.times = [], []

    def emit(self, record):
        import torch
        self.losses.append(float(record.args[-1]))
        self.times.append(time.time())
        with torch.profiler.record_function(STEP_MARK):
            pass


@contextlib.contextmanager
def step_log():
    """A StepLog on the port's train logger, which logs every step at
    log_every=1 (kept off stderr)."""
    log = logging.getLogger("scanner_tpu_torch.train")
    handler, level, propagate = StepLog(), log.level, log.propagate
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False
    try:
        yield handler
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
        log.propagate = propagate


def step_idle_share(run, path: str) -> dict:
    """run(3) — three train steps — under torch.profiler; over the third
    step (between the second and third step markers) the step's wall
    ms, the card's busy ms (the union of kernels, copies and fills) and
    its idle share.  Taken again, twice at most, when the trace holds no
    device event in the step."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with step_log():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run(3)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        marks = sorted(e["ts"] for e in events
                       if e.get("name") == STEP_MARK and e.get("ph") == "X")
        check(len(marks) == 3, f"{len(marks)} step markers in a 3-step "
                               f"trace")
        a, b = marks[1], marks[2]
        spans = sorted((max(e["ts"], a), min(e["ts"] + e["dur"], b))
                       for e in events
                       if e.get("cat") in ("kernel", "gpu_memcpy",
                                           "gpu_memset")
                       and e["ts"] < b and e["ts"] + e["dur"] > a)
        busy, end = 0.0, a
        for x, y in spans:
            busy += max(0.0, y - max(x, end))
            end = max(end, y)
        if busy:
            break
    check(busy > 0, "the profiled train step holds no device time")
    return dict(step_ms=round((b - a) / 1e3, 4),
                device_busy_ms=round(busy / 1e3, 4),
                device_idle_share=round(1.0 - busy / (b - a), 4),
                device_events=len(spans))


def train_phase(st, dev, work: str, seed: int, errs: dict) -> dict:
    """The port's train loops on the card at the shipped configurations
    and the reference's step counts: each saves through TrainCheckpointer
    and exports its `.npz`; finite losses, the last below the first, and
    for pose (the one-rank "cuda" ring) the flash kernel launched once per
    temporal block and step and held against its plain version on the q,
    k, v the first step gave it.  Then pose trained N steps, saved,
    restored into a fresh model and Adam and trained k more, against an
    uninterrupted N + k run; then PoseDetect on the pose checkpoint and
    ObjectDetect on the detector's `.npz` through the engine, against the
    in-memory trained models and beside the shipped and random weights."""
    import numpy as np
    import torch
    from scanner_tpu_torch.kernels import attention
    from scanner_tpu_torch.models import checkpoint
    from scanner_tpu_torch.models import detect_train as dt
    from scanner_tpu_torch.models import detection, pose
    from scanner_tpu_torch.models import pose_train as pt
    from scanner_tpu_torch.models import seg_train as sg
    from scanner_tpu_torch.parallel import make_ring_attention
    root = os.path.join(work, "train")
    os.makedirs(root)
    seen, made = [], {}     # the ring's first q, k, v; the models trained
    ring = make_ring_attention(impl="cuda")

    def attn(q, k, v):
        if not seen:
            seen.append((q.detach(), k.detach(), v.detach()))
        return ring(q, k, v)

    def keep(name, fn):
        def made_by(*args):
            made[name] = fn(*args)
            return made[name]
        return made_by
    saves = []
    real_save = checkpoint.TrainCheckpointer.save

    def timed_save(self, *args):
        torch.cuda.synchronize()
        t0 = time.time()
        real_save(self, *args)
        saves.append(time.time() - t0)
    runs = {
        "pose": lambda d, n: pt.train_pose(d, steps=n, log_every=1,
                                           attn_fn=attn, device=dev),
        "detect": lambda d, n: dt.train_detector(
            d, dt.render_rect_scene, steps=n, seed=0, log_every=1,
            export_npz=d + ".npz", device=dev),
        "face": lambda d, n: dt.train_detector(
            d, dt.render_face_scene, steps=n, seed=1, log_every=1,
            export_npz=d + ".npz", device=dev),
        "embed": lambda d, n: dt.train_embedding(
            d, steps=n, seed=2, log_every=1, export_npz=d + ".npz",
            device=dev),
        "seg": lambda d, n: sg.train_segmenter(
            d, steps=n, log_every=1, export_npz=d + ".npz", device=dev)}
    out, trained = {}, {}
    t_phase = time.time()
    real = (pt._initial_state, dt._initial_detector, real_save)
    pt._initial_state = keep("pose", pt._initial_state)
    dt._initial_detector = keep("detect", dt._initial_detector)
    checkpoint.TrainCheckpointer.save = timed_save
    try:
        for name, run in runs.items():
            steps, d = TRAIN_RUNS[name], os.path.join(root, name)
            attention.reset_counts()
            saves.clear()
            with step_log() as sl:
                t0 = time.time()
                final = run(d, steps)
                call_s = time.time() - t0
            launches = attention.flash_launches
            if name in made:   # the in-memory model this run trained
                trained[name] = made.pop(name)
            losses = sl.losses
            check(len(losses) == steps and final == losses[-1]
                  and bool(np.isfinite(losses).all()),
                  f"[train] {name}: {len(losses)} logged losses for {steps} "
                  f"steps, final {final}, finite "
                  f"{bool(np.isfinite(losses).all())}")
            check(losses[-1] < losses[0], f"[train] {name}: the last loss "
                                          f"{losses[-1]} is not below the "
                                          f"first {losses[0]}")
            if name == "pose":
                blocks = len([m for m in trained["pose"].modules()
                              if type(m).__name__ == "TemporalBlock"])
                check(launches == blocks * steps,
                      f"[train] pose launched the flash kernel {launches} "
                      f"times in {steps} steps of {blocks} temporal blocks")
                out["pose_flash_launches"] = launches
                checkpoint.export_params_npz(checkpoint.load_params(
                    d, pose.VideoPoseNet(width=pt.WIDTH)), d + ".npz")
            else:
                check(launches == 0, f"[train] {name} launched the flash "
                                     f"kernel {launches} times")
            check(checkpoint.TrainCheckpointer(d).latest_step() == steps
                  and os.path.isfile(d + ".npz"),
                  f"[train] {name}: no checkpoint at step {steps} or no "
                  f".npz")
            steady = (len(sl.times) - 1) / (sl.times[-1] - sl.times[0])
            out[f"{name}_steps"] = steps
            out[f"{name}_loss_first_last"] = json.dumps(
                [losses[0], losses[-1]])
            out[f"{name}_call_s"] = round(call_s, 4)
            out[f"{name}_steps_per_s"] = round(steady, 3)
            out[f"{name}_frames_per_s"] = round(
                steady * TRAIN_FRAMES_PER_STEP[name], 3)
            out[f"{name}_save_s"] = round(saves[0], 4)
        out["train_s"] = round(time.time() - t_phase, 3)
        for name, run in runs.items():
            out[f"{name}_step_profile"] = json.dumps(step_idle_share(
                lambda n: run(os.path.join(root, f"{name}_profiled"), n),
                os.path.join(root, f"{name}_step_trace.json")))
    finally:
        (pt._initial_state, dt._initial_detector,
         checkpoint.TrainCheckpointer.save) = real

    # -- the flash kernel on the train path's own q, k, v -------------
    q, k, v = seen[0]
    B, T, H, D = q.shape
    args, own = flash_on_ring_inputs(q, k, v, dev,
                                     "[train]'s first step's q, k, v", errs)

    def kernel_call():
        attention.flash_block_update(*args, 0, 0)
    f_dev = device_ms(kernel_call, 50, ["flash_tf32_kernel",
                                        "transpose_v_kernel"])
    fq, fk, fv = args[:3]
    bound_ms, bound_by, _ = flash_bound(B * H, T, T, D)
    out.update(
        flash_shape=f"{B * H}x{T}x{T}x{D}",
        flash_max_abs_err=json.dumps(own),
        flash_ms=cuda_ms(kernel_call, 50),
        flash_device_ms=f_dev["flash_tf32_kernel"],
        flash_transpose_device_ms=f_dev["transpose_v_kernel"],
        flash_events_per_call=json.dumps(f_dev["events per call"]),
        flash_empty_takes=f_dev["empty takes"],
        flash_plain_ms=cuda_ms(lambda: attention.flash_block_update_plain(
            *args, 0, 0), 50),
        flash_library_ms=cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                fq, fk, fv, scale=1.0), 50),
        flash_bound_ms=bound_ms, flash_bound_by=repr(bound_by))

    # -- resume: N steps, save, restore into a fresh model + Adam, k more
    n, extra = RESUME_STEPS
    torch.backends.cudnn.deterministic = True
    try:
        with step_log() as full:
            pt.train_pose(os.path.join(root, "resume_full"), steps=n + extra,
                          log_every=1, attn_fn=ring, device=dev)
        with step_log() as part:
            pt.train_pose(os.path.join(root, "resume_part"), steps=n,
                          log_every=1, attn_fn=ring, device=dev)
        model = pose.init_params(seed + 1, device=dev, width=pt.WIDTH,
                                 attn_fn=ring)
        opt, step = pose.make_train_step(model)
        ckpt = checkpoint.TrainCheckpointer(os.path.join(root,
                                                         "resume_part"))
        torch.cuda.synchronize()
        t0 = time.time()
        at = ckpt.restore(model, opt)
        torch.cuda.synchronize()
        restore_s = time.time() - t0
        check(at == n, f"[train] resume restored step {at}, not {n}")
        rng = np.random.RandomState(0)      # train_pose's default seed
        for _ in range(n):
            pt.synth_batch(rng, 4, 2, pt.SIZE)
        resumed = []
        for _ in range(extra):
            clips, targets, _ = pt.synth_batch(rng, 4, 2, pt.SIZE)
            resumed.append(float(step(torch.from_numpy(clips).to(dev),
                                      torch.from_numpy(targets).to(dev))))
    finally:
        torch.backends.cudnn.deterministic = False
    want = full.losses[n:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, want))
    check(part.losses == full.losses[:n] or max(
        abs(a - b) / abs(b) for a, b in zip(part.losses, full.losses)) <= 1e-4,
        "[train] resume: the N-step run's losses differ from the first N "
        "of the uninterrupted run by more than rel 1e-4")
    check(rel <= 1e-4, f"[train] resume: the {extra} steps after the "
                       f"restore differ from the uninterrupted run's by "
                       f"rel {rel} > 1e-4")
    out.update(resume=f"{n}+{extra}", resume_bit_equal=resumed == want,
               resume_max_rel_diff=rel, restore_s=round(restore_s, 4))

    # -- serve what was trained, through the engine on the card ---------
    out.update(serve_checks(st, dev, work, seed, trained, root))
    out["phase_s"] = round(time.time() - t_phase, 3)
    return out


def serve_checks(st, dev, work: str, seed: int, trained: dict,
                 root: str) -> dict:
    """PoseDetect on the trained pose checkpoint and ObjectDetect on the
    trained detector's `.npz` through Client(device="cuda"): their rows
    against the in-memory trained models' outputs, and their quality
    beside the shipped and random weights' on the same frames."""
    import numpy as np
    import torch
    from scanner_tpu_torch.models import detect_train as dt
    from scanner_tpu_torch.models import detection, pose
    from scanner_tpu_torch.models import pose_train as pt
    clips, _, centers = pt.synth_batch(np.random.RandomState(seed + 5),
                                       SERVE_BLOBS // 8, 8, pt.SIZE)
    blobs = clips.reshape(SERVE_BLOBS, pt.SIZE, pt.SIZE, 3)
    centers = centers.reshape(SERVE_BLOBS, 2)
    rng = np.random.RandomState(seed + 6)
    scenes = [dt.render_rect_scene(rng) for _ in range(SERVE_SCENES)]
    gpu = st.Client(db_path=os.path.join(work, "train_db"), device=str(dev))
    gpu.new_table("blob", ["frame"], [[f] for f in blobs],
                  codecs={"frame": "pickle"})
    gpu.new_table("rect", ["frame"], [[sc[0]] for sc in scenes],
                  codecs={"frame": "pickle"})
    out = {}
    for what, kw in (("trained", {"checkpoint_dir": os.path.join(root,
                                                                 "pose")}),
                     ("shipped", {}), ("random", {"pretrained": False})):
        run_pose(gpu, st, f"poses_{what}", **kw)
        kp = np.stack(rows_of(gpu, st, f"poses_{what}"))
        out[f"pose_{what}_err_px"] = float(np.hypot(
            kp[:, 0, 0] * 4 - centers[:, 0],
            kp[:, 0, 1] * 4 - centers[:, 1]).mean())
        if what == "trained":
            served = kp
    ref = pose.VideoPoseNet(width=pt.WIDTH)
    ref.load_state_dict(trained["pose"].state_dict())
    ref = ref.to(dev).eval()
    with torch.no_grad():
        mem = np.concatenate([pose.apply_and_peaks(
            ref, torch.from_numpy(blobs[i:i + 8]).to(dev)[:, None])
            .cpu().numpy() for i in range(0, SERVE_BLOBS, 8)])
    step = float(np.abs(served[:, 0, :2] - mem[:, 0, :2]).max())
    score = float(np.abs(served[:, :, 2] - mem[:, :, 2]).max())
    check(step <= 1.0 and score <= 1e-3,
          f"[train] PoseDetect on the checkpoint differs from the in-memory "
          f"model: kp0 by {step} cells, scores by {score}")
    check(out["pose_trained_err_px"] < out["pose_random_err_px"],
          f"[train] the trained pose model's error "
          f"{out['pose_trained_err_px']:.3f} px is not below a random "
          f"model's {out['pose_random_err_px']:.3f}")
    out.update(pose_served_identical_share=float(
        (served == mem).all(axis=(1, 2)).mean()),
        pose_served_max_cell_diff=step, pose_served_max_score_diff=score)
    truth = [sc[1] for sc in scenes]
    for what, kw in (("trained", {"checkpoint_dir": os.path.join(
            root, "detect.npz")}), ("shipped", {}),
            ("random", {"pretrained": False})):
        run_op(gpu, st, "rect", "ObjectDetect", f"det_{what}", width=8,
               score_thresh=0.3, **kw)
        rows = np.stack(rows_of(gpu, st, f"det_{what}"))
        hits, total = dt.recall(rows, truth, detection.unpack_detections)
        out[f"detect_{what}_recall"] = hits / total
        if what == "trained":
            served = rows
    net = detection.AnchoredModel(trained["detect"], 0.3).eval()
    frames = torch.from_numpy(np.stack([sc[0] for sc in scenes])).to(dev)
    with torch.no_grad():
        mem = np.concatenate([net(frames[i:i + 8]).cpu().numpy()
                              for i in range(0, SERVE_SCENES, 8)])
    agree = min(dt.boxes_agree(served, mem, detection.unpack_detections),
                dt.boxes_agree(mem, served, detection.unpack_detections))
    check(agree >= 0.95, f"[train] ObjectDetect on the .npz agrees with "
                         f"the in-memory detector on {agree:.3f} of "
                         f"frames < 0.95")
    check(out["detect_trained_recall"] > out["detect_random_recall"],
          f"[train] the trained detector's recall "
          f"{out['detect_trained_recall']:.3f} is not above a random "
          f"model's {out['detect_random_recall']:.3f}")
    out.update(detect_served_boxes_agree=agree,
               detect_served_max_abs_diff=float(np.abs(served - mem).max()))
    gpu.stop()
    return out


def register_smoke_ops(st):
    """Two helper ops of this script, on the device the engine gives them:
    FrameRows hands frames on as a pickled column (the sink would encode
    a frame column with H.264, and the card's machine has no libav);
    GoldenBoxes makes one CropResize box per frame from the frame's first
    pixel, from 4 % to 94 % of the frame: smaller and larger than the
    crop's 64 x 64 output."""
    from typing import Any, Sequence

    import numpy as np
    import torch

    def frame_rows(self, frame):
        return frame

    def golden_boxes(self, frame):
        x = torch.as_tensor(frame if isinstance(frame, torch.Tensor)
                            else np.asarray(frame))
        s = x[:, 0, 0, 0].to(torch.float32) / 255.0 * 0.9 + 0.04
        box = torch.stack([torch.full_like(s, 0.02),
                           torch.full_like(s, 0.03), 0.02 + s,
                           0.03 + s * 0.95], dim=1)
        return box if isinstance(frame, torch.Tensor) else box.numpy()

    # this module's annotations are strings (PEP 563) that register_op
    # would evaluate in its globals, where `st` is not: give it objects
    for name, fn in (("FrameRows", frame_rows),
                     ("GoldenBoxes", golden_boxes)):
        fn.__annotations__ = {"frame": Sequence[st.FrameType],
                              "return": Sequence[Any]}
        st.register_op(name=name, device=st.DeviceType.TPU, batch=16)(
            type(name, (st.Kernel,), {"execute": fn}))


def run_op(client, st, table: str, op: str, out: str, work: int = 16,
           **kw):
    """`op` over the stored table into `out`; returns (wall seconds, the
    job's stage seconds {load, evaluate, save, evaluate:<op>})."""
    col = getattr(client.ops, op)(
        frame=client.io.Input([st.NamedStream(client, table)]), **kw)
    t0 = time.time()
    job = client.run(client.io.Output(col, [st.NamedStream(client, out)]),
                     st.PerfParams.manual(work, 4 * work),
                     show_progress=False, cache_mode=st.CacheMode.Overwrite)
    wall = time.time() - t0
    stats = client.get_profile(job).statistics()
    return wall, {k: round(v["total_s"], 4) for k, v in stats.items()
                  if k in ("load", "evaluate", "save")
                  or k.startswith("evaluate:")}


def rows_of(client, st, table: str) -> list:
    return list(st.NamedStream(client, table).load())


def profile_model_op(st, op: str, frames) -> dict:
    """One execute() of `op` (width 8, shipped weights) on the card over
    `frames`, traced by torch.profiler after a warm-up: the device's busy
    time against the call's wall time, and the three kernels with the
    most device time, each with its share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from scanner_tpu_torch import models
    from scanner_tpu_torch.graph.ops import KernelConfig
    k = getattr(models, op)(KernelConfig(device=st.DeviceType.TPU,
                                         devices=[torch.device("cuda", 0)]),
                            width=8)
    x = torch.from_numpy(frames).cuda()
    for _ in range(2):
        k.execute(x)
    torch.cuda.synchronize()
    for _ in range(3):   # a trace may come back without device records
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            k.execute(x)
            torch.cuda.synchronize()
            wall = time.time() - t0
        by_name, launches = {}, 0
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                by_name[e.key] = by_name.get(e.key, 0.0) \
                    + e.self_device_time_total / 1e3
                launches += e.count
        busy = sum(by_name.values())
        if busy:
            break
    check(busy > 0, f"{op}: the profiler trace holds no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return dict(batch=len(frames), wall_ms=wall * 1e3, device_ms=busy,
                device_share=busy / (wall * 1e3), kernels=launches,
                top=[(name[:60], round(ms / busy, 3)) for name, ms in top])


def model_serve(st, work: str, seed: int) -> dict:
    """The model zoo through Client(device="cuda") with the shipped
    weights at width 8: frames/s on the bench geometry (two card runs,
    one CPU run), the shipped tasks' quality bounds on the card, and the
    card's rows against the port's CPU rows.  Every card run comes before
    the CPU client opens the database (two clients must not both create
    tables in it)."""
    import numpy as np
    from scanner_tpu_torch.models import detect_train as dt
    from scanner_tpu_torch.models import seg_train as sg
    from scanner_tpu_torch.models.detection import unpack_detections
    from scanner_tpu_torch.models.segmentation import unpack_instances
    rng = np.random.RandomState(21)
    rect = [dt.render_rect_scene(rng) for _ in range(SCENES)]
    rng = np.random.RandomState(22)
    faces = [dt.render_face_scene(rng) for _ in range(SCENES)]
    rng = np.random.RandomState(31)
    shapes = [sg.render_shape_scene(rng) for _ in range(SCENES)]
    rng = np.random.RandomState(99)
    views = [dt.render_identity(i, rng) for i in range(8)] \
        + [dt.render_identity(i, rng) for i in range(8)]
    frames = make_frames(MODEL_FRAMES, seed + 2)
    # (op, table, keyword arguments, how to unpack its rows)
    runs = [(op, "model_frames", {}, None) for op in MODEL_OPS] + [
        ("ObjectDetect", "rect", {"score_thresh": 0.3}, unpack_detections),
        ("FaceDetect", "faces", {"score_thresh": 0.3}, unpack_detections),
        ("InstanceSegment", "shapes", {"score_thresh": 0.3},
         unpack_instances),
        ("FaceEmbedding", "views", {}, None)]
    db_path = os.path.join(work, "model_db")
    gpu = st.Client(db_path=db_path, device="cuda")
    for name, fr in (("model_frames", frames),
                     ("rect", [sc[0] for sc in rect]),
                     ("faces", [sc[0] for sc in faces]),
                     ("shapes", [sc[0] for sc in shapes]),
                     ("views", views)):
        gpu.new_table(name, ["frame"], [[f] for f in fr],
                      codecs={"frame": "pickle"})
    secs, out = {}, {}
    for op, table, kw, _ in runs:
        secs[(op, table, "cuda")] = run_op(gpu, st, table, op,
                                           f"{op}_{table}_cuda", width=8,
                                           **kw)[0]
        if table == "model_frames":   # a second run: warm cuDNN plans
            secs[(op, table, "cuda2")], stages = run_op(
                gpu, st, table, op, f"{op}_{table}_cuda2", width=8, **kw)
            out[f"{op.lower()}_stage_s"] = json.dumps(stages,
                                                      sort_keys=True)
            out[f"{op.lower()}_profile"] = json.dumps(profile_model_op(
                st, op, frames[:{"ObjectDetect": 8, "FaceEmbedding": 16,
                                 "InstanceSegment": 4}[op]]))
    cpu = st.Client(db_path=db_path, device="cpu")
    for op, table, kw, _ in runs:
        secs[(op, table, "cpu")] = run_op(cpu, st, table, op,
                                          f"{op}_{table}_cpu", width=8,
                                          **kw)[0]
    rows = {k: np.stack(rows_of(cpu, st, f"{k[0]}_{k[1]}_{k[2]}"))
            for k in secs}
    for op, table, kw, unpack in runs:
        got, ref = rows[(op, table, "cuda")], rows[(op, table, "cpu")]
        check(got.shape == ref.shape and bool(np.isfinite(got).all()),
              f"{op} on {table}: card rows {got.shape} are not finite rows "
              f"like the CPU's {ref.shape}")
        if table == "model_frames":
            check(np.array_equal(got, rows[(op, table, "cuda2")]),
                  f"{op}: two card runs stored different rows")
            key = op.lower()
            out[f"{key}_fps"] = json.dumps([
                MODEL_FRAMES / secs[(op, table, d)] for d in ("cuda",
                                                               "cuda2")])
            out[f"{key}_cpu_fps"] = MODEL_FRAMES / secs[(op, table, "cpu")]
            if op == "FaceEmbedding":
                cos = float((got * ref).sum(axis=1).min())
                check(cos >= 0.99, f"FaceEmbedding: cosine {cos} < 0.99 "
                                   f"between the card and the CPU")
                out["embedding_min_cosine_640x480"] = cos
            else:   # information: many near-tied low scores at 0.05
                out[f"{key}_boxes_agree_640x480"] = dt.boxes_agree(
                    ref, got, unpack_detections if op == "ObjectDetect"
                    else unpack_instances)
        elif op == "FaceEmbedding":
            r1 = float(((got[8:] @ got[:8].T).argmax(1)
                        == np.arange(8)).mean())
            cos = float((got * ref).sum(axis=1).min())
            check(r1 >= 0.75 and cos >= 0.99,
                  f"FaceEmbedding on the card: recall@1 {r1} (>= 0.75), "
                  f"cosine to the CPU {cos} (>= 0.99)")
            out.update(views_recall_at_1=r1, views_min_cosine_vs_cpu=cos)
        else:
            scenes = {"rect": rect, "faces": faces, "shapes": shapes}[table]
            if op == "InstanceSegment":
                m, total, iou_c, iou_w = sg.segment_quality(
                    got, [(sc[1], sc[2]) for sc in scenes])
                check(m >= 0.7 * total and iou_c >= 0.55
                      and iou_c > iou_w + 0.05,
                      f"InstanceSegment on the card: recall {m}/{total}, "
                      f"mask IoU {iou_c:.3f} (wrong kind {iou_w:.3f})")
                ious = sg.matched_mask_ious(ref, got)
                check(len(ious) > 0 and float(np.mean(ious)) >= 0.9,
                      f"InstanceSegment: mask IoU card vs CPU "
                      f"{np.mean(ious) if ious else 0:.3f} < 0.9")
                out.update(shapes_recall=m / total, shapes_mask_iou=iou_c,
                           shapes_mask_iou_wrong_kind=iou_w,
                           shapes_mask_iou_vs_cpu=float(np.mean(ious)))
            else:
                truth = [sc[1] for sc in scenes]
                hits, total = dt.recall(got, truth, unpack)
                check(hits >= 0.7 * total, f"{op}: recall {hits}/{total} "
                                           f"on the card < 0.7")
                out[f"{table}_recall"] = hits / total
                out[f"{table}_recall_cpu"] = \
                    dt.recall(ref, truth, unpack)[0] / total
            share = dt.boxes_agree(ref, got, unpack)
            check(share >= 0.95, f"{op}: the CPU's boxes met within IoU "
                                 f"0.9 on {share:.3f} of frames < 0.95")
            out[f"{table}_boxes_agree_vs_cpu"] = share
    return out


def series_sum(name: str) -> dict:
    """{label values: value} of one series of the port's metrics
    registry, the node label left out."""
    from scanner_tpu_torch.util.metrics import registry
    out = {}
    for smp in registry().snapshot().get(name, {}).get("samples", []):
        key = ",".join(str(v) for k, v in sorted(smp["labels"].items())
                       if k != "node")
        out[key] = out.get(key, 0.0) + smp["value"]
    return out


def graph_counts():
    """(CUDA graphs captured, graph replays) of fused chains so far."""
    return (sum(series_sum("scanner_tpu_fusion_graph_captures_total")
                .values()),
            sum(series_sum("scanner_tpu_fusion_graph_replays_total")
                .values()))


def same_bytes(a: list, b: list) -> bool:
    """Two tables' rows are the same bytes: arrays of one dtype and
    shape with equal bytes, or equal Python values."""
    import numpy as np
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            if x.dtype != y.dtype or x.shape != y.shape \
                    or x.tobytes() != y.tobytes():
                return False
        elif x != y:
            return False
    return True


def golden(st, work: str, seed: int) -> dict:
    """The golden chain and the other resamplers over stored 640 x 480
    frames through Client(device="cuda") and Client(device="cpu"):
    (a) Resize(W/2, H/2) -> Blur(3, 1.1), (b) + Histogram, (c) +
    HistDiff, CropResize with boxes of several sizes, OpticalFlow.  On
    the card (a), (b) and (c) run fused (the default) and staged."""
    import numpy as np
    import torch
    from scanner_tpu_torch.graph import fusion
    from scanner_tpu_torch.kernels import cuda_ops, shot
    db_path = os.path.join(work, "golden_db")
    gpu = st.Client(db_path=db_path, device="cuda")
    frames = make_frames(GOLDEN_FRAMES, seed + 1)
    gpu.new_table("golden", ["frame"], [[f] for f in frames],
                  codecs={"frame": "pickle"})

    def graph(client, what):
        src = client.io.Input([st.NamedStream(client, "golden")])
        if what == "crop":
            return client.ops.FrameRows(frame=client.ops.CropResize(
                frame=src, box=client.ops.GoldenBoxes(frame=src),
                size=CROP))
        if what == "flow":
            return client.ops.OpticalFlow(frame=src)
        col = client.ops.Blur(frame=client.ops.Resize(
            frame=src, width=[W // 2], height=[H // 2]), kernel_size=3,
            sigma=1.1)
        if what == "a":
            return client.ops.FrameRows(frame=col)
        col = client.ops.Histogram(frame=col)
        return col if what == "b" else client.ops.HistDiff(frame=col)

    def run(client, dev, whats, level=1):
        for what in whats:
            perf = st.PerfParams.manual(8, 16)
            perf.profiler_level = level
            t0 = time.time()
            job = client.run(client.io.Output(graph(client, what), [
                st.NamedStream(client, f"{what}_{dev}")]),
                perf, show_progress=False,
                cache_mode=st.CacheMode.Overwrite)
            secs[(what, dev)] = time.time() - t0
            jobs[(what, dev)] = job
            spans[(what, dev)] = {
                k: round(v["total_s"], 4) for k, v in
                client.get_profile(job).statistics().items()
                if k in ("load", "evaluate", "save")
                or k.startswith("evaluate:")}

    secs, spans, jobs = {}, {}, {}
    cuda_ops.reset_counts()
    captures0, replays0 = graph_counts()
    run(gpu, "cuda", ("a", "b", "c", "crop", "flow"))
    captures, replays = graph_counts()
    captures, replays = captures - captures0, replays - replays0
    replay_launches = cuda_ops.histogram_replay_launches
    # one fused (b) job at profiler level 2: the histogram kernels that
    # the chain's graph replays run, as the device trace shows them
    counted0 = cuda_ops.histogram_launches
    run(gpu, "cuda_level2", ("b",), level=2)
    counted = cuda_ops.histogram_launches - counted0
    by_replay = cuda_ops.histogram_replay_launches - replay_launches
    traced = traced_histograms(
        gpu.get_profile(jobs[("b", "cuda_level2")]),
        os.path.join(work, "golden_b_level2_trace.json"),
        "evaluate:Resize+Blur+Histogram")
    check(by_replay > 0 and traced["histogram_kernel_events"] == counted,
          f"[golden] (b) at level 2: the trace shows "
          f"{traced['histogram_kernel_events']} histogram kernels for "
          f"{counted} counted launches ({by_replay} by graph replays)")
    fusion.set_enabled(False)
    try:
        run(gpu, "cuda_staged", ("a", "b", "c"))
    finally:
        fusion.set_enabled(True)
    launches = cuda_ops.histogram_launches
    ids = cuda_ops.histogram_ids_launches
    # the CPU client opens the database once the card's runs are in it
    cpu = st.Client(db_path=db_path, device="cpu")
    run(cpu, "cpu", ("a", "b", "c", "crop", "flow"))
    check(ids > 0 and launches - ids > 0,
          f"[golden]: the histogram kernel launched {launches - ids} times "
          f"through the frame entry and {ids} through the id entry")
    check(replay_launches > 0 and replays > 0,
          f"[golden]: {replays} graph replays launched the histogram "
          f"kernel {replay_launches} times")
    get = {k: rows_of(cpu, st, f"{k[0]}_{k[1]}") for k in secs}
    check(same_bytes(get[("b", "cuda")], get[("b", "cuda_level2")]),
          "[golden] (b): the level-2 rows differ from the level-1 rows")
    for what in ("a", "b", "c"):
        check(same_bytes(get[(what, "cuda")], get[(what, "cuda_staged")]),
              f"[golden] ({what}): the fused rows on the card differ from "
              f"the staged rows")
    out = dict(frames=GOLDEN_FRAMES, geometry=f"{W}x{H}",
               histogram_launches=launches, ids_launches=ids,
               chains_planned=json.dumps(sorted(series_sum(
                   "scanner_tpu_fusion_chains_planned"))),
               graphs_captured=captures, graph_replays=replays,
               histogram_replay_launches=replay_launches,
               fused_rows_identical_to_staged=True,
               b_level2_launches_counted=counted,
               b_level2_replay_launches=by_replay,
               b_level2_fps=round(GOLDEN_FRAMES / secs[("b", "cuda_level2")],
                                  3),
               **{f"b_level2_{k}": v for k, v in traced.items()})
    for what in ("a", "crop"):
        a = np.stack(get[(what, "cuda")]).astype(np.int32)
        b = np.stack(get[(what, "cpu")]).astype(np.int32)
        check(a.shape == b.shape and len(a) == GOLDEN_FRAMES,
              f"[golden] {what}: {a.shape} vs {b.shape}")
        d = np.abs(a - b)
        check(int(d.max()) <= 1, f"[golden] {what}: pixels differ by "
                                 f"{int(d.max())} counts card vs CPU")
        out[f"{what}_pixels_differing_vs_cpu"] = float((d > 0).mean())
    small = np.stack(get[("a", "cuda")])
    check(small.shape == (GOLDEN_FRAMES, H // 2, W // 2, C),
          f"[golden] Resize -> Blur gave {small.shape}")
    hist = np.stack(get[("b", "cuda")])
    want = cuda_ops.histogram_frames_plain(torch.from_numpy(small)).numpy()
    check(np.array_equal(hist, want), "[golden] Histogram rows on the card "
                                      "differ from the plain histogram of "
                                      "its own Resize -> Blur frames")
    win = np.stack([hist[np.maximum(np.arange(GOLDEN_FRAMES) - 1, 0)],
                    hist], axis=1)
    diff = get[("c", "cuda")]
    check(diff == shot.HistDiff(None).execute(win),
          "[golden] HistDiff rows on the card differ from the plain "
          "version's over the Histogram rows")
    flow = np.stack(get[("flow", "cuda")])
    ref = np.stack(get[("flow", "cpu")])
    check(flow.shape == ref.shape == (GOLDEN_FRAMES, H, W, 2)
          and bool(np.isfinite(flow).all()), f"[golden] flow {flow.shape}")
    err = float(np.abs(flow - ref).max())
    check(err <= 1e-3, f"[golden] flow differs from the CPU by {err}")
    out["flow_max_abs_err_vs_cpu"] = err
    out["histdiff_nonzero_rows"] = int(sum(x != 0 for x in diff))
    for what in ("a", "b", "c", "crop", "flow"):
        out[f"{what}_fps"] = GOLDEN_FRAMES / secs[(what, "cuda")]
        if (what, "cuda_staged") in secs:
            out[f"{what}_staged_fps"] = \
                GOLDEN_FRAMES / secs[(what, "cuda_staged")]
            out[f"{what}_stage_s"] = json.dumps(spans[(what, "cuda")],
                                                sort_keys=True)
            out[f"{what}_staged_stage_s"] = json.dumps(
                spans[(what, "cuda_staged")], sort_keys=True)
        out[f"{what}_cpu_fps"] = GOLDEN_FRAMES / secs[(what, "cpu")]
    return out


def ledgers(client, ops, after: str) -> dict:
    """[ledgers]: the memory ledger's live and watermark bytes on the card
    by buffer kind beside the allocator's own peak, the compile ledger,
    and the roofline rows of `ops` on the card (each must have one).  A
    roofline efficiency above 1.05 fails: the cost counted or the time
    measured would be wrong."""
    import torch
    mem = client.memory_report()["memory"]
    live, peak = {}, {}
    for r in mem["ledger"]:
        if r["device"].startswith("cuda"):
            live[r["kind"]] = live.get(r["kind"], 0) + r["live_bytes"]
            peak[r["kind"]] = peak.get(r["kind"], 0) + r["peak_bytes"]
    rep = client.compile_report()["nodes"]["client"]
    rows = [r for r in rep["op_efficiency"] if r["device"].startswith("cuda")]
    worst = max(rows, key=lambda r: r["efficiency"], default=None)
    check(worst is None or worst["efficiency"] <= 1.05,
          f"[ledgers] {worst and worst['op']} at bucket "
          f"{worst and worst['bucket']} reads roofline efficiency "
          f"{worst and worst['efficiency']} > 1.05")
    missing = [op for op in ops if not any(r["op"] == op for r in rows)]
    check(not missing, f"[ledgers] no roofline row on the card for "
                       f"{missing}")
    return dict(
        after=after,
        ledger_live_bytes=json.dumps(live, sort_keys=True),
        ledger_watermark_bytes=json.dumps(peak, sort_keys=True),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        allocator=json.dumps(mem["devices"], sort_keys=True),
        compile_entries=json.dumps([
            {k: e[k] for k in ("op", "bucket", "signature", "kinds",
                               "cache", "compile_s", "members")
             if k in e} for e in rep["ledger"]]),
        compile_summary=json.dumps(rep["summary"], sort_keys=True),
        roofline=json.dumps([
            {k: r[k] for k in ("op", "bucket", "calls", "rows", "seconds",
                               "bytes_per_s", "flops_per_s", "bound",
                               "efficiency")}
            for r in rows if r["op"] in ops]),
        max_efficiency=worst and worst["efficiency"])


def warmup(st, work: str, seed: int) -> dict:
    """[warmup]: the golden (b) graph, resized to a quarter so that no
    graph of [golden] serves it (chain graphs are kept per process),
    through an executor whose evaluator gets precompile=(H, W, 8) —
    what a video source's geometry would give it — over 32 stored
    frames.  The warm-up must capture the chain's graph at every rung of
    its ladder, and the first real call must capture none."""
    import numpy as np
    import torch
    from scanner_tpu_torch.engine.evaluate import bucket_ladder
    from scanner_tpu_torch.engine.executor import LocalExecutor
    from scanner_tpu_torch.util import coststats
    from scanner_tpu_torch.util.profiler import Profiler

    class WarmExecutor(LocalExecutor):
        @staticmethod
        def precompile_hint(jobs):
            return (H, W, 8)

    chain, n = "Resize+Blur+Histogram", 32
    gpu = st.Client(db_path=os.path.join(work, "warm_db"), device="cuda")
    gpu.new_table("warm", ["frame"], [[f] for f in make_frames(n, seed + 3)],
                  codecs={"frame": "pickle"})
    src = gpu.io.Input([st.NamedStream(gpu, "warm")])
    col = gpu.ops.Histogram(frame=gpu.ops.Blur(frame=gpu.ops.Resize(
        frame=src, width=[W // 4], height=[H // 4]), kernel_size=3,
        sigma=1.1))
    seen = coststats.ledger_summary()["entries_seen"]
    captures0, replays0 = graph_counts()
    ex = WarmExecutor(gpu._db, Profiler(),
                      torch.device("cuda", torch.cuda.current_device()))
    t0 = time.time()
    ex.run([gpu.io.Output(col, [st.NamedStream(gpu, "warm_b")])],
           st.PerfParams.manual(8, 16), cache_mode=st.CacheMode.Overwrite)
    wall = time.time() - t0
    captures, replays = graph_counts()
    entries = [e for e in coststats.compile_ledger()
               if e["seq"] > seen and e["op"] == chain]
    ladder = bucket_ladder(8)
    warmed = sorted(e["bucket"] for e in entries
                    if e["signature"].startswith("warmup:")
                    and "graph" in e["kinds"])
    later = [e for e in entries if not e["signature"].startswith("warmup:")]
    check(warmed == ladder, f"[warmup] the warm-up captured the chain at "
                            f"buckets {warmed}, not at every rung {ladder}")
    check(not later, f"[warmup] a real call captured: {later}")
    check(captures - captures0 == len(ladder),
          f"[warmup] {captures - captures0} captures for a ladder of "
          f"{len(ladder)}")
    rows = np.stack(rows_of(gpu, st, "warm_b"))
    check(rows.shape == (n, C, BINS) and bool(
        (rows.sum(axis=2) == (H // 4) * (W // 4)).all()),
        f"[warmup] rows {rows.shape} are not one count per pixel")
    return dict(ladder=json.dumps(ladder), captured_by_warmup=json.dumps(
        warmed), capture_s=json.dumps([e["compile_s"] for e in entries]),
        first_call_captures=len(later), graph_replays=replays - replays0,
        wall_s=wall)


# the main path's instance of the histogram kernel (C = 3, 16 bins)
# [framecache]: the default pool over one item of the main path's
# frames in the YUV420 wire the loader stages (460,800 B a frame);
# dense tasks are the main path's io packets, stencil tasks reach 8 rows
# back into the task before them
CACHE_OVERLAP = 8
# [framecache] closed loop: device memory in use over the card's limit
# past hbm_pressure's 0.92, and the longest wait for the shrink
PRESSURE, LOOP_WAIT_S, LOOP_INTERVAL_S = 0.93, 15.0, 0.2


def engine_sample(eng, series: str, device: str):
    """Every value the health engine sampled of `series` on `device`,
    oldest first (the engine keeps only the series its rules read)."""
    out = []
    for _t, data in list(eng._samples):
        for smp in (data.get(series) or {}).get("samples", []):
            if smp.get("labels", {}).get("device") == device:
                out.append(float(smp["value"]))
    return out


def time_ticks(eng):
    """From now on, the host seconds of each tick the process health
    engine runs (its loop calls eng.tick(), here wrapped in a clock):
    returns (the list the ticks append to, the clock's start)."""
    spent, inner = [], eng.tick

    def tick(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t0)
    eng.tick = tick
    return spent, time.perf_counter()


def health_phase(gpu, st, dev_label: str, n_frames: int,
                 ticks) -> dict:
    """What the process health engine saw while configs 1, 2 and shot
    ran, then configs 1 and 2 with the engine and the controller off
    (what SCANNER_TPU_HEALTH=0 SCANNER_TPU_REMEDIATION=0 select at
    import) against on, in turns on, off, off, on.  `ticks` is what
    time_ticks returned when the main path's client started the engine:
    the host cost of each tick on this card's host."""
    from scanner_tpu_torch.engine import controller
    from scanner_tpu_torch.util import health
    eng = health.engine()
    in_use = engine_sample(eng, "scanner_tpu_device_hbm_bytes_in_use",
                           dev_label)
    busy = engine_sample(eng, "scanner_tpu_device_busy_seconds_total",
                         dev_label)
    check(len(eng._samples) > 0, "the health engine never sampled")
    check(bool(in_use) and max(in_use) > 0,
          f"the health engine sampled no {dev_label} memory in use")
    check(bool(busy) and max(busy) > 0,
          f"the health engine sampled no {dev_label} busy seconds")
    status = gpu.health()
    out = dict(ticks=len(eng._samples),
               firing=json.dumps(sorted({f["rule"]
                                         for f in status["firing"]})),
               client_health=status["status"],
               hbm_bytes_in_use_last=int(in_use[-1]),
               hbm_bytes_in_use_max=int(max(in_use)),
               busy_seconds_total_last=round(busy[-1], 4))
    fps = {"on": {1: [], 2: []}, "off": {1: [], 2: []}}
    for mode in ("on", "off", "off", "on"):
        on = mode == "on"
        health.set_enabled(on)
        controller.set_enabled(on)
        if on:
            health.ensure_started()
            controller.ensure_started()
        else:
            eng.stop()
        for cfg in (1, 2):
            wall, _ = run_config(gpu, st, cfg, f"config{cfg}_health")
            fps[mode][cfg].append(round(n_frames / wall, 3))
    health.set_enabled(True)
    controller.set_enabled(True)
    health.ensure_started()
    controller.ensure_started()
    for mode in fps:
        for cfg in (1, 2):
            out[f"config{cfg}_fps_engine_{mode}"] = json.dumps(fps[mode][cfg])
    spent, since = ticks
    check(len(spent) > 0, "no engine tick was timed")
    spent = sorted(spent)
    out.update(ticks_timed=len(spent),
               tick_ms_median=spent[len(spent) // 2] * 1e3,
               tick_ms_max=spent[-1] * 1e3,
               tick_host_share=sum(spent) / (time.perf_counter() - since))
    return out


def scrape(port: int, path: str):
    """(status, body, seconds) of one GET on the loopback server."""
    import urllib.error
    import urllib.request
    t0 = time.time()
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                   timeout=30)
        code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, time.time() - t0


def telemetry_phase(gpu, st, dev_label: str, n_frames: int) -> dict:
    """Config 1 through the main path's client, which serves telemetry
    on an ephemeral loopback port: /metrics scraped every 0.1 s while
    the job runs, then every endpoint once."""
    import threading
    port = gpu._metrics_server.port
    during, stop = [], threading.Event()

    def scraper():
        while not stop.is_set():
            code, _body, secs = scrape(port, "/metrics")
            during.append((code, secs))
            stop.wait(0.1)
    t = threading.Thread(target=scraper, name="scraper")
    t.start()
    try:
        wall, _ = run_config(gpu, st, 1, "config1_telemetry")
    finally:
        stop.set()
        t.join(timeout=60)
    check(not t.is_alive(), "the /metrics scraper did not stop")
    check(bool(during) and all(c == 200 for c, _ in during),
          f"/metrics scrapes during config 1: {during[:5]}")
    got = {}
    for path in ("/metrics", "/healthz", "/readyz", "/alertz", "/statusz"):
        got[path] = scrape(port, path)
    code, body, _ = got["/metrics"]
    text = body.decode()
    for series in ("scanner_tpu_device_hbm_bytes_in_use",
                   "scanner_tpu_device_hbm_limit_bytes",
                   "scanner_tpu_device_busy_seconds_total"):
        check(f'{series}{{device="{dev_label}"}}' in text,
              f"/metrics lacks {series} on {dev_label}")
    check(got["/healthz"][0] == 200, "/healthz did not answer 200")
    check(got["/readyz"][0] in (200, 503), "/readyz answered neither "
                                          "200 nor 503")
    check(got["/alertz"][0] == 200
          and "rule_table" in json.loads(got["/alertz"][1]),
          "/alertz has no rule table")
    statusz = json.loads(got["/statusz"][1])
    missing = {"health", "memory", "framecache", "efficiency",
               "remediation"} - set(statusz)
    check(got["/statusz"][0] == 200 and not missing,
          f"/statusz lacks {sorted(missing)}")
    secs = sorted(s for _, s in during)
    return dict(port=port, config1_fps=round(n_frames / wall, 3),
                scrapes_during_run=len(during),
                scrape_ms_during_run_median=round(
                    secs[len(secs) // 2] * 1e3, 3),
                scrape_ms_during_run_max=round(secs[-1] * 1e3, 3),
                metrics_bytes=len(body),
                readyz=got["/readyz"][0],
                healthz=json.loads(got["/healthz"][1])["status"],
                healthz_reasons=json.dumps(
                    json.loads(got["/healthz"][1])["reasons"]),
                scrape_ms_after=json.dumps(
                    {p: round(v[2] * 1e3, 3) for p, v in got.items()}))


def device_trace_phase(gpu, st, work: str, n_frames: int,
                       level1_fps: float) -> dict:
    """Config 1 at profiler_level=2: the job's torch.profiler capture
    merged into Profile.write_trace.  The histogram kernel's events by
    name: as many as the launches counted, each inside the capture's
    host window and launched by a runtime call inside a host
    evaluate:Histogram span (traced_histograms).  One capture, as a
    user's job takes it."""
    from scanner_tpu_torch.kernels import cuda_ops
    path = os.path.join(work, "config1_level2_trace.json")
    jobs = []
    cuda_ops.reset_counts()
    wall, _ = run_config(gpu, st, 1, "config1_level2", level=2,
                         job_ids=jobs)
    launches = cuda_ops.histogram_launches
    got = traced_histograms(gpu.get_profile(jobs[0]), path,
                            "evaluate:Histogram")
    check(got["histogram_kernel_events"] == launches,
          f"the trace shows {got['histogram_kernel_events']} histogram "
          f"kernels for {launches} counted launches")
    return dict(level2_fps=round(n_frames / wall, 3),
                level1_fps=level1_fps, launches_counted=launches, **got)


def traced_histograms(prof, path: str, span: str) -> dict:
    """Write one job's profile with its single device capture merged
    (pid >= DEVICE_PID_BASE) to `path`; checks that the capture holds
    device events and histogram kernels, every one of them inside the
    host window, and each tied by the trace's correlation id to the
    runtime call that launched it (cudaLaunchKernel*, or cudaGraphLaunch
    for a kernel of a graph replay), and that call lies inside a host
    span named `span`.  The correlation id is what orders a kernel after
    its call: a kernel's time in the trace is the card's timer converted
    to the host's clock, which can read a kernel tens to hundreds of
    microseconds before the call that launched it, so those times are
    reported, not compared.  The kernel itself may start after the span
    has ended: a launch returns before the card runs it, and a graph
    replay runs its nodes in order.
    Returns the counts, the window, the card's busy share over it, and
    what ties each kernel to its span: its start after the span's end
    and after its launch call's start and end (and, over every kernel
    of the capture launched by a runtime call, the least start after
    its call's start and how many read before it), its start after the
    first kernel of the same launch (a graph's earlier nodes), the
    launch calls' margins inside their spans, and the anchor marker's
    duration (torchprof aligns the capture by the marker's start; the
    host clock is read inside it, so the alignment is off by at most
    that duration)."""
    from scanner_tpu_torch.util.torchprof import (ANCHOR, DEVICE_PID_BASE,
                                                  _read_raw_events)
    recs = [r for p in prof.profilers for r in p.device_traces]
    check(len(recs) == 1, f"a level-2 job captured {len(recs)} device "
                          f"traces, not 1")
    prof.write_trace(path, merge_device=True)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("pid", 0) >= DEVICE_PID_BASE
           and e.get("ph") == "X"]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    hist = [e for e in kernels if "hist" in e.get("name", "")]
    check(bool(dev), "the merged trace has no device events")
    check(bool(hist), "the merged trace shows no histogram kernel "
                      f"(kernels: {sorted({e['name'] for e in kernels})[:8]})")
    lo, hi = recs[0]["t0"] * 1e6, recs[0]["t1"] * 1e6
    outside = [e for e in hist if not lo <= e["ts"] <= hi]
    check(not outside, f"{len(outside)} histogram kernels lie outside "
                       f"the host window")
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("pid", 0) < DEVICE_PID_BASE and e.get("name") == span]

    def corr(e):
        return (e.get("args") or {}).get("correlation")
    calls = {corr(e): e for e in dev if e.get("cat") in (
        "cuda_runtime", "cuda_driver") and corr(e) is not None}
    first = {}
    for e in kernels:
        if corr(e) is not None:
            first[corr(e)] = min(first.get(corr(e), e["ts"]), e["ts"])
    lags, leads, delays, in_launch, margins, names = [], [], [], [], [], \
        set()
    for e in hist:
        call = calls.get(corr(e))
        check(call is not None, f"histogram kernel at {e['ts']:.1f} us has "
                                f"no launch call of correlation {corr(e)} "
                                f"in the trace")
        check(call["name"].startswith(LAUNCH_CALLS),
              f"histogram kernel at {e['ts']:.1f} us is tied to "
              f"{call['name']}, not a launch call")
        names.add(call["name"])
        c0, c1 = call["ts"], call["ts"] + call["dur"]
        holder = [(a, b) for a, b in spans if a <= c0 and c1 <= b]
        check(bool(holder), f"the {call['name']} that launched a histogram "
                            f"kernel ({c0:.1f}-{c1:.1f} us) lies outside "
                            f"every host {span} span")
        a, b = holder[0]
        lags.append(e["ts"] - b)
        leads.append(e["ts"] - c0)
        delays.append(e["ts"] - c1)
        in_launch.append(e["ts"] - first[corr(e)])
        margins.append(min(c0 - a, b - c1))
    # every kernel of the capture against the runtime call that
    # launched it: how far the trace's clocks disagree
    every = [e["ts"] - calls[corr(e)]["ts"] for e in kernels
             if calls.get(corr(e)) is not None]
    raw = _read_raw_events(recs[0])
    anchor = next(e for e in raw if e.get("name") == ANCHOR
                  and e.get("ph") == "X")

    def us(xs):
        return json.dumps([round(x, 1) for x in sorted(xs)])
    # the card's busy share over the capture: kernels, copies and fills
    busy_us = sum(e.get("dur", 0.0) for e in dev if e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset"))
    return dict(device_events=len(dev), kernel_events=len(kernels),
                histogram_kernel_events=len(hist),
                histogram_kernel_name=repr(hist[0]["name"][:80]),
                histogram_kernels_launched_in_spans=len(hist),
                launch_calls=repr(sorted(names)), spans=len(spans),
                kernel_start_after_span_end_us=us(lags),
                kernel_start_after_launch_start_us=us(leads),
                kernel_start_after_launch_end_us=us(delays),
                any_kernel_start_after_launch_start_us_min=round(
                    min(every), 1),
                any_kernel_before_launch=sum(x < 0 for x in every),
                any_kernel_launches=len(every),
                kernel_start_after_launch_first_kernel_us=us(in_launch),
                launch_call_margin_in_span_us_min=round(min(margins), 1),
                anchor_marker_us=round(float(anchor.get("dur", 0.0)), 1),
                window_s=round((hi - lo) / 1e6, 4),
                device_busy_ms=round(busy_us / 1e3, 4),
                device_busy_share=round(busy_us / (hi - lo), 6),
                trace_bytes=os.path.getsize(path))


def serial_phase(gpu, st, db, n_frames: int) -> dict:
    """Config 1 under SCANNER_TPU_NO_PIPELINING=1: every stage inline on
    one thread; its rows against the pipelined run's."""
    os.environ["SCANNER_TPU_NO_PIPELINING"] = "1"
    try:
        wall, stages = run_config(gpu, st, 1, "config1_serial")
    finally:
        del os.environ["SCANNER_TPU_NO_PIPELINING"]
    a = stored_items(db, "config1_serial")
    b = stored_items(db, "config1_cuda")
    check(len(a) == len(b) == n_frames and same_bytes(a, b),
          "config 1's serial rows differ from the pipelined rows")
    return dict(rows_identical_to_pipelined=True,
                config1_serial_fps=round(n_frames / wall, 3),
                stage_s=json.dumps(stages, sort_keys=True))


def worker_task_phase(gpu, st, n_frames: int, cuda_ops) -> dict:
    """Config 1 through a cluster worker's task path on cuda:0, with no
    RPC: the master's admission on the host (plan the tasks, create the
    output table), then service.WorkerPipeline — the code a Worker runs
    each bulk through — joined to the spec and fed the tasks one at a
    time from a local list, and the master's commit."""
    import torch
    from scanner_tpu_torch.engine.executor import LocalExecutor, TaskItem
    from scanner_tpu_torch.engine.service import WorkerPipeline
    from scanner_tpu_torch.util.profiler import Profiler
    db = gpu._db
    src = gpu.io.Input([st.NamedStream(gpu, "frames")])
    out = gpu.io.Output(gpu.ops.Histogram(frame=src),
                        [st.NamedStream(gpu, "config1_worker_task")])
    perf = st.PerfParams.manual(WORK, IO)
    LocalExecutor(db, Profiler(), torch.device("cpu")).prepare(
        [out], perf, st.CacheMode.Overwrite)
    dev = torch.device("cuda", torch.cuda.current_device())
    pipe = WorkerPipeline(LocalExecutor(db, Profiler(), dev), dev)
    cuda_ops.reset_counts()
    t0 = time.time()
    pipe.join([out], perf, Profiler(node="worker_task"))
    # the loaders call the source concurrently: a list iterator hands
    # each task out once
    todo = iter([TaskItem(job, t, rows) for job in pipe.jobs
                 for t, rows in enumerate(job.tasks)])
    done, errors = [], []

    def on_task_error(w, exc):
        errors.append((w.task_idx, repr(exc)))
        return True

    pipe.run(lambda: next(todo, None),
             on_done=lambda w: done.append(w.task_idx),
             on_task_error=on_task_error)
    wall = time.time() - t0
    launches = cuda_ops.histogram_launches
    pipe.close()
    check(not errors, f"[worker_task] tasks failed: {errors}")
    for job in pipe.jobs:
        for desc, _c, _k, _e in job.sink_tables.values():
            db.commit_table(desc.id)
    db.write_megafile()
    a = stored_items(db, "config1_worker_task")
    b = stored_items(db, "config1_cuda")
    check(len(a) == len(b) == n_frames and same_bytes(a, b),
          "[worker_task] rows differ from config 1's")
    return dict(tasks=len(done), launches=launches,
                rows_identical_to_config1=True,
                fps=round(n_frames / wall, 3))


CLUSTER_THREADS = ("rpc-", "master-", "worker-")
# the runtime and driver calls that launch kernels (a trace event's name
# starts with one of them)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaGraphLaunch", "cuLaunchKernel",
                "cuGraphLaunch")


def cluster_phase(st, frames, work: str, main_rows: dict,
                  main_launches: dict, cuda_ops, faults) -> dict:
    """Configs 1 and 2 through an in-process Master and
    Worker(device="cuda:0") over gRPC on 127.0.0.1, rows and histogram
    launches against the main path's; a fault drill with a second
    worker; shutdown_cluster and every server thread stopped."""
    import threading

    import torch
    from scanner_tpu_torch.engine.service import Master, Worker
    from scanner_tpu_torch.storage import Database, PosixStorage
    before = set(threading.enumerate())
    db_path = os.path.join(work, "cluster_db")
    Database(PosixStorage(db_path)).new_table(
        "frames", ["frame"], [[f] for f in frames],
        codecs={"frame": "pickle"})
    dev = f"cuda:{torch.cuda.current_device()}"
    t0 = time.time()
    master = Master(db_path=db_path, advertise_host="127.0.0.1")
    addr = f"127.0.0.1:{master.port}"
    workers = [Worker(addr, db_path=db_path, device=dev,
                      advertise_host="127.0.0.1")]
    client = st.Client(db_path=db_path, master=addr)
    up_s = time.time() - t0
    out = {"device": dev, "startup_s": round(up_s, 3)}
    try:
        for cfg in (1, 2):
            cuda_ops.reset_counts()
            wall, stages = run_config(client, st, cfg, f"cluster{cfg}")
            s = client.job_status()
            # where the job's wall goes: the client's root span against
            # the worker's task spans (one host clock)
            spans = client._cluster.get_trace(
                client._cluster.last_bulk_id)["spans"]
            root = next(d for d in spans if d["name"] == "job")
            tasks = [d for d in spans if d["name"] == "task"]
            out[f"config{cfg}_to_first_task_s"] = round(
                min(d["start"] for d in tasks) - root["start"], 4)
            out[f"config{cfg}_tasks_span_s"] = round(
                max(d["end"] for d in tasks)
                - min(d["start"] for d in tasks), 4)
            out[f"config{cfg}_after_last_task_s"] = round(
                root["end"] - max(d["end"] for d in tasks), 4)
            rows = stored_items(client._db, f"cluster{cfg}")
            check(len(rows) == len(frames)
                  and same_bytes(rows, main_rows[cfg]),
                  f"[cluster] config {cfg} rows differ from the main "
                  f"path's")
            check(s["finished"] and s["failed_jobs"] == []
                  and s["task_failures"] == 0,
                  f"[cluster] config {cfg} status: {s}")
            out[f"config{cfg}_fps"] = round(len(frames) / wall, 3)
            out[f"config{cfg}_tasks"] = s["total_tasks"]
            out[f"config{cfg}_launches"] = cuda_ops.histogram_launches
            out[f"config{cfg}_stage_s"] = json.dumps(stages,
                                                     sort_keys=True)
            check(cuda_ops.histogram_launches == main_launches[cfg],
                  f"[cluster] config {cfg}: the worker launched the "
                  f"histogram kernel {cuda_ops.histogram_launches} "
                  f"times, the main path {main_launches[cfg]}")
        # fault drill: a second worker joins; the first evaluated task
        # raises and is requeued by the master
        workers.append(Worker(addr, db_path=db_path, device=dev,
                              advertise_host="127.0.0.1"))
        deadline = time.time() + 30
        while client.job_status()["num_workers"] < 2:
            check(time.time() < deadline, "second worker never joined")
            time.sleep(0.1)
        cuda_ops.reset_counts()
        faults.install("pipeline.eval:raise:exc=runtime:n=1:times=1")
        try:
            wall, _stages = run_config(client, st, 1, "cluster_drill")
            fired = faults.fired("pipeline.eval")
        finally:
            faults.clear()
        s = client.job_status()
        rows = stored_items(client._db, "cluster_drill")
        check(fired == 1, f"the drill's fault fired {fired} times")
        check(s["finished"] and s["failed_jobs"] == []
              and s["task_failures"] == 1
              and s["tasks_done"] == s["total_tasks"],
              f"[cluster] drill status: {s}")
        check(same_bytes(rows, main_rows[1]),
              "[cluster] drill rows differ from the main path's")
        # the fault fires before the failed attempt's evaluation, so
        # the retry leaves the launch count where config 1 has it
        check(cuda_ops.histogram_launches == main_launches[1],
              f"[cluster] drill: {cuda_ops.histogram_launches} histogram "
              f"launches, the main path {main_launches[1]}")
        out.update(drill_fps=round(len(frames) / wall, 3),
                   drill_task_failures=s["task_failures"],
                   drill_workers=s["num_workers"],
                   drill_launches=cuda_ops.histogram_launches,
                   rows_identical_to_main_path=True)
        notified = client.shutdown_cluster()
        check(notified == len(workers),
              f"shutdown_cluster notified {notified} of "
              f"{len(workers)} workers")
    finally:
        client.stop()
        for w in workers:
            w.stop()
        master.stop()

    def left():
        return sorted(t.name for t in threading.enumerate()
                      if t not in before
                      and t.name.startswith(CLUSTER_THREADS))
    deadline = time.time() + 15
    while left() and time.time() < deadline:
        time.sleep(0.05)
    check(not left(), f"[cluster] threads still running: {left()}")
    out["threads_stopped"] = True
    return out


def compute_mode() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
        and r.stdout.strip() else "unknown"


def member_children() -> list:
    """Live gang member runners (python -m scanner_tpu_torch.engine.gang)
    started by this process."""
    me, out = os.getpid(), []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as fh:
                ppid = int(fh.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == me and b"scanner_tpu_torch.engine.gang" in cmd:
            out.append(int(pid))
    return out


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return (xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2) \
        if n else None


def gang_phase(st, frames, work: str, main_rows: dict, cuda_ops,
               faults, dev: str) -> dict:
    """Gang bulks (PerfParams.gang_hosts=2) through an in-process Master
    and two Worker(device=dev) over gRPC on 127.0.0.1: each task
    runs on a gang of two member child processes sharing the card, each
    with its own CUDA context.  Configs 1 and 2 sharded, config 1
    replicated ([gang] sharded=false on the master), and a drill whose
    first member run fails at its collective once.  Rows against the
    main path's, every member result, histogram launches per member
    (folded from the children), no member left running, every server
    thread stopped."""
    import threading

    from scanner_tpu_torch.engine import gang
    from scanner_tpu_torch.engine.service import Master, Worker
    from scanner_tpu_torch.storage import Database, PosixStorage
    mode = compute_mode()
    check(mode not in ("Exclusive_Process", "Exclusive_Thread",
                       "Prohibited"),
          f"[gang] the card's compute mode {mode} forbids a second "
          f"process's context: two members cannot share it")
    before = set(threading.enumerate())
    db_path = os.path.join(work, "gang_db")
    Database(PosixStorage(db_path)).new_table(
        "frames", ["frame"], [[f] for f in frames],
        codecs={"frame": "pickle"})
    runs = []
    in_flight = [0]     # spawn_member calls not yet returned
    lock = threading.Lock()
    spawn = gang.spawn_member

    def recording(request, **kw):
        t0 = time.time()
        with lock:
            in_flight[0] += 1
        try:
            res = spawn(request, **kw)
            runs.append({
                "pid": request["process_id"], "gang": request["gang_id"],
                "epoch": request["epoch"], "task": request["task_idx"],
                "sharded": request["sharded"], "ok": res.get("ok"),
                "stage": res.get("stage"), "error": res.get("error"),
                "phases": dict(res.get("phases") or {}),
                "shard": dict(res.get("shard") or {}),
                "launches": int((res.get("cuda_ops") or {})
                                .get("histogram_launches", 0)),
                "wall_s": time.time() - t0})
            return res
        finally:
            with lock:
                in_flight[0] -= 1

    gang.spawn_member = recording
    sharded0 = gang.sharded_enabled()
    out = {"compute_mode": mode, "device": dev, "members": 2,
           "perf": "manual(32,320)"}
    master = Master(db_path=db_path, advertise_host="127.0.0.1")
    addr = f"127.0.0.1:{master.port}"
    workers = [Worker(addr, db_path=db_path, device=dev,
                      advertise_host="127.0.0.1") for _ in range(2)]
    client = st.Client(db_path=db_path, master=addr)
    all_runs, launches = [], 0
    try:
        deadline = time.time() + 30
        while client.job_status()["num_workers"] < 2:
            check(time.time() < deadline, "[gang] workers never joined")
            time.sleep(0.1)
        for name, cfg, sharded, plan in (
                ("config1", 1, True, None), ("config2", 2, True, None),
                ("config1_replicated", 1, False, None),
                ("drill", 1, True, "gang.collective:raise:n=1:times=1")):
            gang.set_sharded(sharded)
            cuda_ops.reset_counts()
            runs.clear()
            strikes0 = sum(series_sum(
                "scanner_tpu_blacklist_strikes_total").values())
            if plan:
                faults.install(plan)
            try:
                wall, _stages = run_config(
                    client, st, cfg, f"gang_{name}",
                    perf=st.PerfParams.manual(32, 320, gang_hosts=2))
                fired = faults.fired("gang.collective") if plan else 0
            finally:
                faults.clear()
            # the job ends once the task's result is in; a member's
            # spawn_member may still be reaping its child and reading its
            # result file, so its run is recorded a moment later
            deadline = time.time() + 30
            while in_flight[0] and time.time() < deadline:
                time.sleep(0.05)
            s = client.job_status()
            rows = stored_items(client._db, f"gang_{name}")
            check(len(rows) == len(frames)
                  and same_bytes(rows, main_rows[cfg]),
                  f"[gang] {name} rows differ from the main path's")
            check(s["finished"] and s["failed_jobs"] == [],
                  f"[gang] {name} status: {s}")
            check(not member_children(),
                  f"[gang] {name}: member runners still alive")
            ok = [r for r in runs if r["ok"]]
            failed = [r for r in runs if not r["ok"]]
            strikes = sum(series_sum(
                "scanner_tpu_blacklist_strikes_total").values()) - strikes0
            check(strikes == 0, f"[gang] {name}: {strikes} strikes")
            if plan:
                # the armed member's gang aborts; its partner's run
                # fails at the same (gang, epoch) or is reaped
                lost = {(r["gang"], r["epoch"]) for r in failed}
                check(fired == 1 and len(lost) == 1
                      and any(r["stage"] == "collective" for r in failed),
                      f"[gang] drill: fault fired {fired}, failed "
                      f"members {failed}")
                retried = [r for r in ok if r["task"] == failed[0]["task"]]
                check(retried and min(r["epoch"] for r in retried)
                      > failed[0]["epoch"],
                      f"[gang] drill: task {failed[0]['task']} never "
                      f"re-formed at a higher epoch: {runs}")
                out["drill_failed_stages"] = json.dumps(
                    sorted(r["stage"] for r in failed))
            else:
                check(not failed, f"[gang] {name} member failures: "
                                  f"{failed}")
            check(len(ok) == 2 * 2,
                  f"[gang] {name}: {len(ok)} member runs completed, "
                  f"want 2 tasks x 2 members")
            for r in ok:
                nonempty = (not r["sharded"]) or r["shard"].get("rows", 0)
                check(not nonempty or r["launches"] >= 1,
                      f"[gang] {name}: member {r['pid']} of task "
                      f"{r['task']} launched the histogram kernel "
                      f"{r['launches']} times")
            check(cuda_ops.histogram_launches
                  == sum(r["launches"] for r in runs),
                  f"[gang] {name}: folded launches "
                  f"{cuda_ops.histogram_launches} != the members' "
                  f"{sum(r['launches'] for r in runs)}")
            launches += cuda_ops.histogram_launches
            all_runs += runs
            out[f"{name}_fps"] = round(len(frames) / wall, 3)
            out[f"{name}_wall_s"] = round(wall, 3)
            out[f"{name}_launches"] = cuda_ops.histogram_launches
            out[f"{name}_member_launches"] = json.dumps(
                [r["launches"] for r in runs])
            out[f"{name}_epochs"] = json.dumps(
                sorted({r["epoch"] for r in runs}))
            if sharded:
                out[f"{name}_gather_bytes"] = sum(
                    r["shard"].get("gather_bytes", 0) for r in ok
                    if r["pid"] == 0)
                out[f"{name}_decode_rows"] = json.dumps(
                    [r["shard"].get("decode_rows") for r in ok])
        for ph in ("spawn", "device", "rendezvous", "stage", "barrier",
                   "collective", "assemble", "teardown"):
            vals = [r["phases"][ph] for r in all_runs
                    if ph in r["phases"]]
            out[f"{ph}_median_s"] = round(median(vals), 4) \
                if vals else None
        out["teardown_max_s"] = round(max(
            r["phases"].get("teardown", 0.0) for r in all_runs), 4)
        out["member_wall_median_s"] = round(
            median([r["wall_s"] for r in all_runs]), 4)
        out["member_runs"] = len(all_runs)
        out["launches"] = launches
        out["rows_identical_to_main_path"] = True
        notified = client.shutdown_cluster()
        check(notified == len(workers),
              f"[gang] shutdown_cluster notified {notified} of "
              f"{len(workers)} workers")
    finally:
        gang.spawn_member = spawn
        gang.set_sharded(sharded0)
        client.stop()
        for w in workers:
            w.stop()
        master.stop()

    def left():
        return sorted(t.name for t in threading.enumerate()
                      if t not in before
                      and t.name.startswith(CLUSTER_THREADS))
    deadline = time.time() + 15
    while left() and time.time() < deadline:
        time.sleep(0.05)
    check(not left(), f"[gang] threads still running: {left()}")
    check(not member_children(), "[gang] member runners still alive")
    out["threads_stopped"] = True
    return out


def yuv420_wire(frames):
    """(n, h*w*3/2) uint8 planar I420 of RGB frames (BT.601 studio
    range, chroma averaged over 2 x 2): the wire format the loader
    decodes video to and stages on the card."""
    import numpy as np
    n, h, w, _ = frames.shape
    out = np.empty((n, h * w * 3 // 2), np.uint8)
    for i in range(n):
        f = frames[i].astype(np.float32)
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
        u = 128 - 0.148 * r - 0.291 * g + 0.439 * b
        v = 128 + 0.439 * r - 0.368 * g - 0.071 * b
        sub = lambda p: p.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))  # noqa
        out[i] = np.concatenate([
            np.clip(np.rint(y), 0, 255).ravel(),
            np.clip(np.rint(sub(u)), 0, 255).ravel(),
            np.clip(np.rint(sub(v)), 0, 255).ravel()]).astype(np.uint8)
    return out


def framecache_phase(st, frames, dev, seed: int, work: str) -> dict:
    """The process frame cache on the card at its default capacity,
    driven as the loader drives it (plan, then assemble, which stages
    the misses and offers them toward pages), over one item of the main
    path's frames in the YUV420 wire: a stencil pass (tasks reaching 8
    rows back), two dense passes of io-packet tasks, a Gather of a hot
    clip.  Every assembled tensor must equal direct staging of the same
    rows byte for byte.  Then the closed loop: device memory past
    hbm_pressure's threshold must make the controller shrink the pool
    to half its occupancy."""
    import numpy as np
    import torch
    from scanner_tpu_torch.engine import controller, framecache as fc
    from scanner_tpu_torch.engine.batch import staged_device_put
    from scanner_tpu_torch.util import health, memstats
    wire = yuv420_wire(frames)
    n = len(wire)
    label = memstats.device_label(dev)
    cache = fc.cache()
    cache.clear()
    table = ("chip_smoke", 0)

    def task(rows):
        rows = np.asarray(rows, np.int64)
        p = cache.plan(dev, table, "frame", 0, "yuv420", rows, n)
        got = cache.assemble(p, p.miss_rows, wire[p.miss_rows],
                             hw=(H, W))
        want = staged_device_put(wire[rows], dev, "staging", "smoke")
        check(got.device == dev and torch.equal(got, want),
              f"frame cache rows {rows[0]}..{rows[-1]} differ from "
              f"direct staging")
        p.lease.release()
        return int(p.hit_mask.sum()), len(rows)

    def status():
        return cache.status_dict()["devices"].get(label, {})

    passes = {}
    stencil = [task(range(max(0, s - CACHE_OVERLAP), min(n, s + IO)))
               for s in range(0, n, IO)]
    passes["stencil"] = stencil
    for k in (1, 2):
        passes[f"dense{k}"] = [task(range(s, min(n, s + IO)))
                               for s in range(0, n, IO)]
    hot = np.arange(n // 3, n // 3 + IO, 3)
    passes["gather"] = [task(hot)]
    st_ = status()
    hits = {k: sum(h for h, _ in v) for k, v in passes.items()}
    rows = {k: sum(r for _, r in v) for k, v in passes.items()}
    check(hits["stencil"] >= CACHE_OVERLAP * (len(stencil) - 1),
          f"stencil back-reach rows missed the pages: {stencil}")
    check(hits["dense2"] > 0, "no hits on the second dense pass")
    check(st_["evictions"] > 0, "the pool never evicted at capacity")
    check(st_["live_bytes"] + st_["fill_bytes"] <= st_["capacity_bytes"],
          f"the pool overshoots its capacity: {st_}")
    check(st_["pinned_bytes"] == 0, f"pins leaked: {st_}")
    # page gather against staging from the host, 96 resident frames
    resident = [r for r in range(n - IO, n)]
    p = cache.plan(dev, table, "frame", 0, "yuv420", resident, n)
    check(bool(p.hit_mask.all()), "the timed task's rows are not resident")
    p.lease.release()

    def from_pages():
        q = cache.plan(dev, table, "frame", 0, "yuv420", resident, n)
        out = cache.assemble(q, q.miss_rows, wire[q.miss_rows])
        q.lease.release()
        return out

    def from_host():
        return staged_device_put(wire[resident], dev, "staging", "smoke")

    times = {}
    for name, fn in (("assemble_from_pages", from_pages),
                     ("staged_device_put_from_host", from_host)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        times[name] = (time.time() - t0) / 20 * 1e3
    assemble_dev_ms = device_ms(from_pages, 20, [""])
    out = dict(frames=n, frame_bytes=wire.shape[1], page_frames=
               cache._page_frames.get((table, "frame", 0, "yuv420")),
               capacity_mb=st_["capacity_bytes"] >> 20,
               pages=st_["pages"], evictions=st_["evictions"],
               hits=json.dumps(hits), rows=json.dumps(rows),
               task_bytes=IO * wire.shape[1],
               assemble_ms=round(times["assemble_from_pages"], 4),
               assemble_device_ms=assemble_dev_ms["all kernels"] and round(
                   assemble_dev_ms["all kernels"], 4),
               staged_put_ms=round(times["staged_device_put_from_host"], 4))

    # -- the closed loop: hbm_pressure -> frame_cache_shrink -------------
    eng = health.ensure_started()
    ctrl = controller.ensure_started()
    check(eng is not None and ctrl is not None,
          "the health engine or the controller is switched off")
    eng.set_interval(LOOP_INTERVAL_S)
    occupied = st_["live_bytes"] + st_["fill_bytes"]
    target = max(fc.MIN_CAPACITY_BYTES,
                 min(st_["capacity_bytes"], occupied) // 2)
    n_audit = len(ctrl.audit())
    ballast = []
    torch.cuda.empty_cache()
    try:
        stats = memstats.device_memory_stats()[label]
        limit = stats["limit_bytes"]
        chunk = 1 << 30
        while stats["bytes_in_use"] / limit <= PRESSURE:
            need = int(PRESSURE * limit) - stats["bytes_in_use"] + (64 << 20)
            ballast.append(torch.empty(min(chunk, need), dtype=torch.uint8,
                                       device=dev))
            stats = memstats.device_memory_stats()[label]
        pressure = stats["bytes_in_use"] / limit
        t0 = time.time()
        applied = None
        while time.time() - t0 < LOOP_WAIT_S:
            applied = next((a for a in ctrl.audit()[n_audit:]
                            if a["playbook"] == "frame_cache_shrink"
                            and a["action"] == "shrink_frame_cache"
                            and a["outcome"] == "applied"
                            and a["labels"].get("device") == label), None)
            if applied is not None \
                    and status()["capacity_bytes"] == target:
                break
            time.sleep(0.05)
        waited = time.time() - t0
    finally:
        ballast.clear()
        torch.cuda.empty_cache()
        eng.set_interval(1.0)
    after = status()
    check(applied is not None,
          f"no frame_cache_shrink/shrink_frame_cache/applied on {label} "
          f"within {LOOP_WAIT_S} s (audit: {ctrl.audit()[n_audit:]})")
    check(after["capacity_bytes"] == target
          and after["live_bytes"] + after["fill_bytes"] <= target,
          f"the pool did not shrink to {target} bytes: {after}")
    out.update(loop_pressure=round(pressure, 4),
               loop_seconds=round(waited, 3),
               loop_audit=repr(f"{applied['playbook']}/{applied['action']}"
                               f"/{applied['outcome']} {applied['labels']}"
                               f" {applied['detail']}"),
               capacity_before_mb=round(st_["capacity_bytes"] / 2 ** 20, 3),
               capacity_after_mb=round(after["capacity_bytes"] / 2 ** 20, 3),
               pages_after=after["pages"],
               pressure_shrinks=after["pressure_shrinks"])
    fc.set_capacity_mb(fc.DEFAULT_CAPACITY_MB)
    cache.clear()
    out["video_path"] = video_cache_ab(st, work, seed) if have_libav() \
        else "skipped (no libav)"
    return out


def video_cache_ab(st, work: str, seed: int) -> str:
    """HistDiff over a synthesized clip through Client(device="cuda"),
    the frame cache on and off: the same rows."""
    from scanner_tpu_torch.engine import framecache as fc
    from scanner_tpu_torch.video.ingest import synthesize_video
    clip = os.path.join(work, "cache_clip.mp4")
    synthesize_video(clip, num_frames=IO * 2, width=W, height=H, fps=24)
    client = st.Client(db_path=os.path.join(work, "cache_db"),
                       device="cuda")
    _, failed = client.ingest_videos([("clip", clip)])
    check(not failed, f"ingest failed: {failed}")
    rows = {}
    for on in (True, False):
        fc.set_enabled(on)
        src = client.io.Input([st.NamedVideoStream(client, "clip")])
        client.run(client.io.Output(client.ops.HistDiff(frame=src),
                                    [st.NamedStream(client, f"v{on}")]),
                   st.PerfParams.manual(WORK, IO), show_progress=False)
        rows[on] = stored_items(client._db, f"v{on}")
    fc.set_enabled(True)
    check(same_bytes(rows[True], rows[False]),
          "video HistDiff rows differ with the frame cache on and off")
    return f"rows_identical({len(rows[True])})"


# [sharded]: the sharded train step at the JAX package's defaults
# (scanner_tpu/models/pose.py make_sharded_train_step), Ulysses at a
# long clip's shape, and the pipeline at one stage
SHARDED_CLIP = (8, 8, 64, 64, 3)
SHARDED_WIDTH = 32
SHARDED_STEPS = 6           # per run; the first is not timed
ULYSSES_SHAPE = (2, 2048, 4, 32)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_run(pose, mesh, remat: bool) -> dict:
    """SHARDED_STEPS steps of make_sharded_train_step on `mesh`: losses,
    each step's seconds (host clock; the loss's read waits for the
    card), peak bytes over the steps (max_memory_allocated after a reset)
    and the bytes allocated at the reset (earlier phases' tensors, the
    model, Adam's state and the batch), the bytes a forward pass holds
    for its backward (one more forward, its graph kept, above what was
    allocated before it), and what the step was built of."""
    import torch
    step, model, opt, (clip, target) = pose.make_sharded_train_step(
        mesh, clip_shape=SHARDED_CLIP, width=SHARDED_WIDTH, remat=remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    losses, secs = [], []
    for _ in range(SHARDED_STEPS):
        t0 = time.time()
        losses.append(float(step(clip, target)))
        secs.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated()
    before = torch.cuda.memory_allocated()
    heat = model(clip.to_local())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    del heat
    return dict(losses=losses, secs=secs, peak=peak, start=start,
                forward_held=held, built=(step, model, opt, clip, target))


def sharded_phase(dev, seed: int, hist, work: str) -> dict:
    """[sharded]: in-program sharding on a one-rank NCCL group on the
    card, formed here and destroyed before the phase returns."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from scanner_tpu_torch.models import pose
    from scanner_tpu_torch.models.checkpoint import TrainCheckpointer
    from scanner_tpu_torch.models.convert import flax_params, load_params
    from scanner_tpu_torch.parallel import (
        device_mesh, make_mesh, make_pipeline, make_ulysses_attention,
        reference_attention, replicate_to_global, shard_batch,
        stack_stage_params, temporal_diff)

    t_phase = time.time()
    card = dev if dev.index is not None or dev.type != "cuda" \
        else torch.device("cuda", torch.cuda.current_device())
    check(not dist.is_initialized(),
          "[sharded] a process group was already formed")
    t0 = time.time()
    # NCCL on the card (gloo only when a CPU rehearsal passes the CPU)
    dist.init_process_group(
        "nccl" if card.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
        **({"device_id": card} if card.type == "cuda" else {}))
    out = dict(backend=dist.get_backend(), ranks=dist.get_world_size(),
               init_s=round(time.time() - t0, 3))
    try:
        # (a) placements and the halo over the main path's rows
        mesh = device_mesh(make_mesh({"dp": 1, "sp": 1, "tp": 1},
                                     devices=[card]))
        rows = torch.from_numpy(hist)
        b = shard_batch(mesh, hist)
        r = replicate_to_global(mesh, (None, "tp"), hist)
        check(b.to_local().device == card
              and torch.equal(b.to_local().cpu(), rows)
              and tuple(b.placements) == (Shard(0), Replicate(),
                                          Replicate()),
              "[sharded] shard_batch did not place the rows on dp")
        check(torch.equal(r.to_local().cpu(), rows)
              and tuple(r.placements) == (Replicate(), Replicate(),
                                          Shard(1)),
              "[sharded] replicate_to_global did not place (None, 'tp')")
        diff = temporal_diff(mesh)(shard_batch(mesh, hist, "sp")) \
            .to_local()
        want = hist - np.concatenate([hist[:1], hist[:-1]])
        check(diff.device == card
              and np.array_equal(diff.cpu().numpy(), want),
              "[sharded] temporal_diff differs from the plain row "
              "difference")
        out.update(mesh=json.dumps({"dp": 1, "sp": 1, "tp": 1}),
                   diff_rows=f"{'x'.join(map(str, hist.shape))}"
                             f":{hist.dtype}", diff_bit_exact=True)

        # (b) Ulysses on the one-rank sp group
        g = torch.Generator(device=card).manual_seed(seed)
        q, k, v = (torch.randn(ULYSSES_SHAPE, generator=g, device=card)
                   for _ in range(3))
        uly = make_ulysses_attention(mesh, "sp")
        got, ref = uly(q, k, v), reference_attention(q, k, v)
        err = float((got - ref).abs().max())
        check(bool(torch.allclose(got, ref, rtol=2e-4, atol=2e-5)),
              f"[sharded] Ulysses differs from reference_attention by "
              f"{err}")
        out.update(ulysses_shape="x".join(map(str, ULYSSES_SHAPE)),
                   ulysses_max_abs_err=err,
                   ulysses_ms=cuda_ms(lambda: uly(q, k, v), 10),
                   reference_attention_ms=cuda_ms(
                       lambda: reference_attention(q, k, v), 10))

        # (c) the pipeline at one stage, and a one-stage pipelined model
        pp_mesh = device_mesh(make_mesh(
            {"dp": 1, "sp": 1, "tp": 1, "pp": 1}, devices=[card]))
        C = 32
        sp_ = [{"w": torch.randn(C, C, generator=g, device=card) * 0.1,
                "b": torch.randn(C, generator=g, device=card) * 0.1}]

        def stage(p, x):
            return torch.tanh(x @ p["w"] + p["b"])
        x = torch.randn(8, 16, C, generator=g, device=card)
        y = make_pipeline(pp_mesh, stage, num_microbatches=2)(
            stack_stage_params(sp_), x)
        pipe_err = float((y - stage(sp_[0], x)).abs().max())
        check(pipe_err <= 1e-5, f"[sharded] make_pipeline at pp 1, M 2 "
                                f"differs from its stage by {pipe_err}")
        piped = pose.init_params(seed, device=card, width=SHARDED_WIDTH,
                                 temporal_layers=1, pipeline_mesh=pp_mesh)
        plain = pose.VideoPoseNet(width=SHARDED_WIDTH, temporal_layers=1)
        load_params(plain, pose.pp_params_to_plain(flax_params(piped)))
        plain.to(card)
        clip = torch.randint(0, 256, (2,) + SHARDED_CLIP[1:], generator=g,
                             device=card, dtype=torch.uint8)
        with torch.no_grad():
            a, bb = piped(clip), plain(clip)
        model_err = float((a - bb).abs().max())
        scale = float(bb.abs().max())
        check(model_err <= 1e-2 * max(scale, 1.0),
              f"[sharded] the one-stage pipelined VideoPoseNet differs "
              f"from the plain layout by {model_err} (scale {scale})")
        out.update(pipeline_max_abs_err=pipe_err,
                   pipelined_model_max_abs_err=model_err,
                   pipelined_model_bit_equal=bool(torch.equal(a, bb)))

        # (d) the sharded step at the JAX package's defaults, (e) DCP
        torch.backends.cudnn.deterministic = True
        try:
            runs = {remat: sharded_run(pose, mesh, remat)
                    for remat in (False, True)}
            ref = pose.init_params(0, device=card, width=SHARDED_WIDTH)
            _, ref_step = pose.make_train_step(ref)
            step, model, opt, clip, target = runs[False]["built"]
            first = float(ref_step(clip.to_local(), target.to_local()))
            del ref, ref_step
            ckpt = TrainCheckpointer(os.path.join(work, "sharded_ckpt"))
            t0 = time.time()
            ckpt.save(SHARDED_STEPS, model, opt)
            save_s = time.time() - t0
            uninterrupted = float(step(clip, target))
            step, model, opt, (clip, target) = pose.make_sharded_train_step(
                mesh, clip_shape=SHARDED_CLIP, width=SHARDED_WIDTH)
            t0 = time.time()
            at = ckpt.restore(model, opt)
            restore_s = time.time() - t0
            resumed = float(step(clip, target))
        finally:
            torch.backends.cudnn.deterministic = False
        for remat, run in runs.items():
            name = "remat" if remat else "no_remat"
            losses = run["losses"]
            check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"[sharded] {name} losses do not fall: {losses}")
            step_s = float(np.mean(run["secs"][1:]))
            out.update({f"{name}_losses": json.dumps(losses),
                        f"{name}_step_ms": step_s * 1e3,
                        f"{name}_steps_per_s": 1.0 / step_s,
                        f"{name}_step_s": json.dumps(
                            [round(t, 4) for t in run["secs"]]),
                        f"{name}_peak_bytes": run["peak"],
                        f"{name}_bytes_at_reset": run["start"],
                        f"{name}_step_peak_bytes": run["peak"]
                        - run["start"],
                        f"{name}_forward_held_bytes": run["forward_held"]})
        check(runs[True]["losses"] == runs[False]["losses"],
              f"[sharded] remat losses {runs[True]['losses']} differ from "
              f"no-remat {runs[False]['losses']}")
        rel = abs(runs[False]["losses"][0] - first) / abs(first)
        check(rel <= 1e-3, f"[sharded] first sharded loss "
                           f"{runs[False]['losses'][0]} differs from the "
                           f"unsharded make_train_step's {first} by rel {rel}")
        check(at == SHARDED_STEPS and resumed == uninterrupted,
              f"[sharded] restored step {at}: next loss {resumed}, "
              f"uninterrupted {uninterrupted}")
        out.update(clip="x".join(map(str, SHARDED_CLIP)),
                   width=SHARDED_WIDTH, steps=SHARDED_STEPS,
                   remat_losses_equal=True, unsharded_first_loss=first,
                   first_loss_rel_diff=rel,
                   step_peak_ratio_remat=(runs[True]["peak"]
                                          - runs[True]["start"])
                   / (runs[False]["peak"] - runs[False]["start"]),
                   resume_loss=resumed, uninterrupted_loss=uninterrupted,
                   resume_bit_equal=True, save_s=round(save_s, 4),
                   restore_s=round(restore_s, 4))
    finally:
        dist.destroy_process_group()
    out["phase_s"] = round(time.time() - t_phase, 3)
    return out


HIST_MAIN_FUNCTION = "hist_u8_privateILi3EE"


# [dp_apply]: uneven batches over two replicas, so the padding path runs:
# 13 frames of 640 x 480, and 39 of the shipped task's rect scenes (the
# first 39 of [model_serve]'s 40)
DP_FRAMES, DP_SCENES = 13, 39
DP_ITERS = 10
# where the replicas sit on cards of their own, their packed rows
# (boxes in pixels, scores, keypoints in heatmap cells) may differ from
# one device's run on the same shards by this share of the rows' largest
# magnitude: the same kernels on the same shapes, on other cards
DP_SHARD_RTOL = 1e-3


def unmatched_scores(rows_a, rows_b, unpack) -> list:
    """The scores of the detections of `rows_a` that no detection of
    `rows_b` meets (same_box at IoU 0.9), over all frames."""
    from scanner_tpu_torch.models import detect_train as dt
    out = []
    for ra, rb in zip(rows_a, rows_b):
        a, b = unpack(ra), unpack(rb)
        out += [float(sa) for x, sa in zip(a["boxes"], a["scores"])
                if not any(dt.same_box(x, y) for y in b["boxes"])]
    return out


def dp_apply_phase(seed: int) -> dict:
    """[dp_apply]: ObjectDetect and PoseDetect, width 8 with the shipped
    weights, through DataParallelApply over every card of the machine
    (two entries of cuda:0 when it has one) on uneven batches, against
    the same op on one device.  The bounds are [model_serve]'s, where it
    applies them: ObjectDetect's boxes within IoU 0.9 on >= 95 % of the
    rect scenes at score_thresh 0.3; the blob keypoint of PoseDetect
    within one heatmap cell.  On the 640 x 480 frames at the default
    score_thresh 0.05 the agreement is printed, as [model_serve] prints
    the card's against the CPU's there (near-tied low scores), with the
    highest score of a box the replicas did not meet.  On one card the
    replicas' rows must equal one device's run on the same shards byte
    for byte: the split changes the batch sizes the library's kernels
    see, and nothing else; on several cards they must agree with it
    within DP_SHARD_RTOL, so that every set keeps a check there."""
    import numpy as np
    import torch
    from scanner_tpu_torch import models
    from scanner_tpu_torch.common import DeviceType
    from scanner_tpu_torch.graph.ops import KernelConfig
    from scanner_tpu_torch.models import detect_train as dt
    from scanner_tpu_torch.models import pose_train
    from scanner_tpu_torch.models.detection import unpack_detections
    n_cards = torch.cuda.device_count()
    first = torch.device("cuda", 0)
    replicas = [torch.device("cuda", i) for i in range(n_cards)] \
        if n_cards > 1 else [first, first]
    clips, _, _ = pose_train.synth_batch(np.random.RandomState(seed), 2,
                                         8, POSE_SIZE)
    rng = np.random.RandomState(21)
    rect = np.stack([dt.render_rect_scene(rng)[0]
                     for _ in range(DP_SCENES)])
    # (what, op, frames, keyword arguments); the first two are timed
    runs = [("objectdetect", "ObjectDetect", make_frames(DP_FRAMES, seed + 2),
             {}),
            ("posedetect", "PoseDetect",
             clips.reshape(-1, POSE_SIZE, POSE_SIZE, 3)[:DP_FRAMES], {}),
            ("objectdetect_rect", "ObjectDetect", rect,
             {"score_thresh": 0.3})]
    out = dict(device_count=n_cards, replicas=len(replicas),
               replica_devices=",".join(str(d) for d in replicas),
               batch=DP_FRAMES, rect_batch=DP_SCENES)
    for key, op, frames, kw in runs:
        def build(devices):
            return getattr(models, op)(
                KernelConfig(device=DeviceType.TPU, devices=devices),
                width=8, **kw)
        one, dp = build([first]), build(replicas)
        x = torch.from_numpy(frames).to(first)
        a, b = one.execute(x), dp.execute(x)
        torch.cuda.synchronize()
        check(b.device == first and b.shape == a.shape
              and bool(torch.isfinite(b).all()),
              f"[dp_apply] {op}: replicas gave {tuple(b.shape)} on "
              f"{b.device}, one device {tuple(a.shape)} on {a.device}")
        # the one device on the replicas' shards: what the split alone
        # changes (the library's kernels per batch size), not the wrapper
        n, rows = len(replicas), len(frames)
        padded = torch.cat([x, x.new_zeros((-rows % n,) + x.shape[1:])])
        shards = torch.cat([one.execute(c) for c in padded.chunk(n)])[:rows]
        a, b = a.cpu().numpy(), b.cpu().numpy()
        shards = shards.cpu().numpy()
        out[f"{key}_identical"] = bool(np.array_equal(a, b))
        same = bool(np.array_equal(shards, b))
        out[f"{key}_identical_to_one_device_on_shards"] = same
        # replicas on one card run its kernels on the same shapes: the
        # same bytes; on cards of their own, the same packed rows within
        # DP_SHARD_RTOL of the rows' scale
        diff = float(np.abs(shards.astype(np.float64) - b).max())
        bound = DP_SHARD_RTOL * max(1.0, float(np.abs(shards).max()))
        out[f"{key}_max_abs_diff_to_one_device_on_shards"] = diff
        check(same if n_cards == 1 else diff <= bound,
              f"[dp_apply] {op}: the replicas' rows differ from one "
              f"device's on the same shards by {diff} (bound "
              f"{0 if n_cards == 1 else bound})")
        if op == "ObjectDetect":
            share = dt.boxes_agree(a, b, unpack_detections)
            missed = unmatched_scores(a, b, unpack_detections)
            out[f"{key}_boxes_agree"] = share
            out[f"{key}_unmatched_boxes"] = len(missed)
            out[f"{key}_unmatched_max_score"] = max(missed, default=None)
            if kw:
                check(share >= 0.95, f"[dp_apply] ObjectDetect on the "
                                     f"rect scenes: one device's boxes met "
                                     f"within IoU 0.9 on {share:.3f} of "
                                     f"frames < 0.95")
        else:
            step = float(np.abs(a[:, 0, :2] - b[:, 0, :2]).max())
            check(step <= 1.0, f"[dp_apply] PoseDetect: the blob keypoint "
                               f"moved {step} heatmap cells")
            out[f"{key}_kp0_max_cell_diff"] = step
            out[f"{key}_max_score_diff"] = float(
                np.abs(a[:, :, 2] - b[:, :, 2]).max())
        if kw:
            continue
        out[f"{key}_one_device_ms"] = cuda_ms(lambda: one.execute(x),
                                              DP_ITERS)
        out[f"{key}_replicas_ms"] = cuda_ms(lambda: dp.execute(x),
                                            DP_ITERS)
        f_one, f_dp = one.infer_cost_flops(frames), \
            dp.infer_cost_flops(frames)
        check(f_one == f_dp, f"[dp_apply] {op}: cost_flops {f_dp} over "
                             f"the replicas, {f_one} on one device")
        out[f"{key}_cost_flops"] = f_dp
    return out


def coordinator_worker(master: str, db_path: str, coordinator: str,
                       out: str, device: str) -> int:
    """The [coordinator] phase's child process: a Worker on `device`
    that joins a one-rank process group at `coordinator` for its
    lifetime, serves `master` until shutdown_cluster, and writes to
    `out` what group it joined, whether it left it, and its histogram
    launches."""
    sys.path.insert(0, HERE)
    import torch.distributed as dist
    import scanner_tpu_torch.kernels  # noqa: F401  (registers the ops)
    from scanner_tpu_torch.engine.service import Worker
    from scanner_tpu_torch.kernels import cuda_ops
    from scanner_tpu_torch.parallel.distributed import CoordinatorConfig
    t0 = time.time()
    w = Worker(master, db_path=db_path, device=device,
               advertise_host="127.0.0.1",
               coordinator=CoordinatorConfig(coordinator, 1, 0))
    info = dict(backend=dist.get_backend(),
                world_size=dist.get_world_size(), rank=dist.get_rank(),
                join_s=w.group_join_s, worker_up_s=time.time() - t0)
    w.wait_for_shutdown()
    info.update(left_group=not dist.is_initialized(),
                launches=cuda_ops.histogram_launches)
    with open(out, "w") as fh:
        json.dump(info, fh)
    return 0


def proc_start(pid: int):
    """The start time (clock ticks since boot) of live process `pid`, or
    None when it is gone or a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
    except (OSError, IndexError):
        return None
    return None if fields[0] in "ZX" else int(fields[19])


def proc_children(pid: int) -> set:
    """The (pid, start time) of the live children of process `pid`."""
    kids = set()
    for task in glob.glob(f"/proc/{pid}/task/*/children"):
        try:
            with open(task) as fh:
                kids.update(int(k) for k in fh.read().split())
        except OSError:
            continue
    return {(k, t) for k in kids if (t := proc_start(k)) is not None}


def proc_descendants(pid: int) -> set:
    """The (pid, start time) of the live descendants of process `pid`."""
    out, todo = set(), [pid]
    while todo:
        for kid in proc_children(todo.pop()) - out:
            out.add(kid)
            todo.append(kid[0])
    return out


def set_subreaper(on: bool) -> None:
    """Make this process the one that inherits the orphans of its
    descendants (prctl PR_SET_CHILD_SUBREAPER), so that a process a
    child started and left behind stays visible as a child of this one."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, int(on), 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def processes_left(since: int, seen: set) -> list:
    """What is still alive of a child's process tree once the child was
    reaped: the descendants `seen` while it ran, and this process's
    children that started at `since` (clock ticks since boot) or later
    (the orphans that a subreaper inherits)."""
    left = {(p, t) for p, t in seen if proc_start(p) == t}
    left |= {(p, t) for p, t in proc_children(os.getpid()) if t >= since}
    return sorted(p for p, _ in left)


def coordinator_phase(st, frames, work: str, main_rows: dict,
                      main_launches: int) -> dict:
    """[coordinator]: a Master in this process and one
    Worker(device="cuda:N", coordinator=CoordinatorConfig(<free port>,
    1, 0)) in a child process (this process may hold [sharded]'s group
    later, and a process holds one default group): config 1 over the
    main path's frames.  The child's group must be NCCL, of one rank,
    and gone when it stops; rows the same bytes as the main path's;
    its histogram launches those of config 1; nothing of the child's
    process tree left."""
    import torch
    from scanner_tpu_torch.engine.service import Master
    from scanner_tpu_torch.storage import Database, PosixStorage
    db_path = os.path.join(work, "coordinator_db")
    Database(PosixStorage(db_path)).new_table(
        "frames", ["frame"], [[f] for f in frames],
        codecs={"frame": "pickle"})
    dev = f"cuda:{torch.cuda.current_device()}"
    master = Master(db_path=db_path, advertise_host="127.0.0.1")
    addr = f"127.0.0.1:{master.port}"
    result = os.path.join(work, "coordinator_child.json")
    t0 = time.time()
    # orphans of the worker's tree come to this process, where the
    # check after shutdown sees them
    set_subreaper(True)
    since = int(time.clock_gettime(time.CLOCK_BOOTTIME)
                * os.sysconf("SC_CLK_TCK"))
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--coordinator-worker",
         addr, db_path, f"127.0.0.1:{free_port()}", result, dev],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seen = set()
    client = st.Client(db_path=db_path, master=addr)
    out = {"device": dev}
    try:
        deadline = time.time() + 180
        while client.job_status()["num_workers"] < 1:
            check(child.poll() is None and time.time() < deadline,
                  f"[coordinator] the worker never registered "
                  f"(exit {child.poll()})")
            seen |= proc_descendants(child.pid)
            time.sleep(0.1)
        out["worker_registered_s"] = round(time.time() - t0, 3)
        wall, stages = run_config(client, st, 1, "coordinator1")
        s = client.job_status()
        check(s["finished"] and s["failed_jobs"] == []
              and s["task_failures"] == 0,
              f"[coordinator] config 1 status: {s}")
        rows = stored_items(client._db, "coordinator1")
        check(len(rows) == len(frames) and same_bytes(rows, main_rows[1]),
              "[coordinator] config 1 rows differ from the main path's")
        out.update(config1_fps=round(len(frames) / wall, 3),
                   config1_tasks=s["total_tasks"],
                   config1_stage_s=json.dumps(stages, sort_keys=True),
                   rows_identical_to_main_path=True)
        seen |= proc_descendants(child.pid)
        check(client.shutdown_cluster() == 1,
              "[coordinator] shutdown_cluster did not reach the worker")
        log, _ = child.communicate(timeout=120)
    finally:
        client.stop()
        if child.poll() is None:
            child.kill()
            child.communicate()
        master.stop()
        # a descendant may take a moment to see its parent gone
        end = time.time() + 10
        while (left := processes_left(since, seen)) and time.time() < end:
            time.sleep(0.1)
        for pid in left:     # stop what the check below reports
            with contextlib.suppress(OSError):
                os.kill(pid, 9)
                os.waitpid(pid, 0)
        set_subreaper(False)
    check(child.returncode == 0 and os.path.exists(result),
          f"[coordinator] the worker exited {child.returncode}: "
          f"{log[-2000:]}")
    with open(result) as fh:
        info = json.load(fh)
    check(info["backend"] == "nccl" and info["world_size"] == 1
          and info["rank"] == 0,
          f"[coordinator] the worker's group: {info}")
    check(info["left_group"], "[coordinator] the worker kept its group")
    check(info["launches"] == main_launches,
          f"[coordinator] the worker launched the histogram kernel "
          f"{info['launches']} times, config 1 {main_launches}")
    check(not left,
          f"[coordinator] processes of the worker's tree left: {left}")
    out.update(group_backend=info["backend"],
               group_world_size=info["world_size"],
               group_join_s=round(info["join_s"], 4),
               worker_up_s=round(info["worker_up_s"], 3),
               left_group=True, launches=info["launches"],
               descendants_seen=len(seen), processes_left=len(left))
    return out


CHAOS_PLANS = ("memory-pressure", "worker-crash")
CHAOS_ROWS = 24
CHAOS_TIMEOUT_S = 300


def chaos_phase(work: str) -> dict:
    """[chaos]: tools/torch_chaos_run.py --device cuda:N (a master and
    two worker processes sharing the card) for each of CHAOS_PLANS, one
    after the other.  Each plan must fire and give rows bit-exact to its
    clean run, with nothing of the tool's process tree left; the
    memory-pressure workers must have launched the histogram kernel.
    Returns the seconds of each run and the workers' launches."""
    import torch
    dev = f"cuda:{torch.cuda.current_device()}"
    tool = os.path.join(HERE, "tools", "torch_chaos_run.py")
    out = {"device": dev, "workers": 2, "rows": CHAOS_ROWS, "launches": 0}
    set_subreaper(True)
    try:
        for plan in CHAOS_PLANS:
            key = plan.replace("-", "_")
            log_path = os.path.join(work, f"chaos_{key}.log")
            since = int(time.clock_gettime(time.CLOCK_BOOTTIME)
                        * os.sysconf("SC_CLK_TCK"))
            t0 = time.time()
            with open(log_path, "w") as log:
                child = subprocess.Popen(
                    [sys.executable, tool, plan, "--device", dev,
                     "--workers", "2", "--rows", str(CHAOS_ROWS),
                     "--db", os.path.join(work, f"chaos_{key}_db")],
                    stdout=log, stderr=subprocess.STDOUT, cwd=HERE)
                seen = set()
                while child.poll() is None \
                        and time.time() - t0 < CHAOS_TIMEOUT_S:
                    seen |= proc_descendants(child.pid)
                    time.sleep(0.2)
                if child.poll() is None:
                    child.kill()
                child.wait()
            secs = time.time() - t0
            end = time.time() + 10
            while (left := processes_left(since, seen)) \
                    and time.time() < end:
                time.sleep(0.1)
            for pid in left:
                with contextlib.suppress(OSError):
                    os.kill(pid, 9)
                    os.waitpid(pid, 0)
            with open(log_path) as fh:
                text = fh.read()
            check(child.returncode == 0,
                  f"[chaos] {plan} exited {child.returncode}: "
                  f"{text[-3000:]}")
            res = json.loads(text.strip().splitlines()[-1])
            check(res["fired"] and res["bit_exact"]
                  and res["rows"] == CHAOS_ROWS,
                  f"[chaos] {plan}: {res}")
            check(not left and res["killed"] == 0,
                  f"[chaos] {plan}: processes left {left}, killed by the "
                  f"tool {res['killed']}")
            out[f"{key}_s"] = round(secs, 3)
            out[f"{key}_faulted_run_s"] = round(res["faulted_s"], 3)
            out[f"{key}_clean_run_s"] = round(res["clean_s"], 3)
            out[f"{key}_launches"] = res["worker_histogram_launches"]
            out[f"{key}_processes"] = res["processes"]
            out[f"{key}_descendants_seen"] = len(seen)
            out["launches"] += res["worker_histogram_launches"]
    finally:
        set_subreaper(False)
    check(out["memory_pressure_launches"] > 0,
          "[chaos] memory-pressure: the workers never launched the "
          "histogram kernel")
    return out


def tools_phase(st, frames, work: str, main_rows: dict, cuda_ops) -> dict:
    """[tools]: a Master in this process and a Worker(device="cuda:N")
    run config 1 over the main path's frames.  torch_top --once --json
    and torch_cost --json run against the master before the run, and
    torch_top, torch_trace --verify --json and torch_cost after it: each
    tool a process of its own, the tools of a round at once.  The worker
    shares this process's metrics registry with every earlier phase, so
    the checks read what the tools report the run added: the worker's
    eval rows, its tasks on the card and the Histogram rows on it."""
    import torch
    from scanner_tpu_torch.engine.service import Master, Worker
    from scanner_tpu_torch.storage import Database, PosixStorage
    db_path = os.path.join(work, "tools_db")
    Database(PosixStorage(db_path)).new_table(
        "frames", ["frame"], [[f] for f in frames],
        codecs={"frame": "pickle"})
    dev = f"cuda:{torch.cuda.current_device()}"
    master = Master(db_path=db_path, advertise_host="127.0.0.1")
    addr = f"127.0.0.1:{master.port}"
    worker = Worker(addr, db_path=db_path, device=dev,
                    advertise_host="127.0.0.1")
    client = st.Client(db_path=db_path, master=addr)
    out = {"device": dev}

    def tools(*runs):
        """Run each (name, args) of `runs` at once, each a process of
        its own; {name: (its --json document, its seconds)}."""
        procs = {}
        for name, args in runs:
            procs[name] = (time.time(), subprocess.Popen(
                [sys.executable,
                 os.path.join(HERE, "tools", f"torch_{name}.py"),
                 "--master", addr, *args],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=HERE))
        docs = {}
        try:
            for name, (t0, p) in procs.items():
                so, se = p.communicate(timeout=120)
                check(p.returncode == 0,
                      f"[tools] torch_{name}.py exited {p.returncode}: "
                      f"{se[-2000:]}")
                docs[name] = (json.loads(so), round(time.time() - t0, 3))
        finally:
            for _, p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        return docs

    def totals(top, cost):
        """The workers' (names, eval rows, tasks on `dev`, Histogram
        rows on `dev`) as top and cost report them."""
        workers = {n: d for n, d in top["nodes"].items()
                   if n.startswith("worker")}
        hist = sum(o["rows"] for n, rep in cost["nodes"].items()
                   if n.startswith("worker")
                   for o in (rep or {}).get("op_efficiency") or []
                   if o["op"] == "Histogram" and o["device"] == dev)
        return (sorted(workers),
                sum(d["eval_rows"] for d in workers.values()),
                sum(d["devices"].get(dev, {}).get("tasks", 0.0)
                    for d in workers.values()), hist)
    try:
        deadline = time.time() + 60
        while client.job_status()["num_workers"] < 1:
            check(time.time() < deadline,
                  "[tools] the worker never registered")
            time.sleep(0.1)
        docs = tools(("top", ["--once", "--json"]), ("cost", ["--json"]))
        out.update(top_before_s=docs["top"][1],
                   cost_before_s=docs["cost"][1])
        names0, rows0, tasks0, hist0 = totals(docs["top"][0],
                                              docs["cost"][0])
        check(len(names0) == 1,
              f"[tools] torch_top before the run names workers {names0}")
        cuda_ops.reset_counts()
        wall, _ = run_config(client, st, 1, "tools1")
        out["launches"] = cuda_ops.histogram_launches
        rows = stored_items(client._db, "tools1")
        check(len(rows) == len(frames) and same_bytes(rows, main_rows[1]),
              "[tools] config 1 rows differ from the main path's")
        out.update(config1_fps=round(len(frames) / wall, 3),
                   rows_identical_to_main_path=True)
        docs = tools(("top", ["--once", "--json"]),
                     ("trace", ["--verify", "--json"]), ("cost", ["--json"]))
        out.update({f"{n}_s": d[1] for n, d in docs.items()})
        (top, _), (trace, _), (cost, _) = (docs[n] for n in
                                           ("top", "trace", "cost"))
        names, rows1, tasks1, hist1 = totals(top, cost)
        out.update(top_eval_rows_added=rows1 - rows0,
                   top_tasks_added=tasks1 - tasks0,
                   cost_histogram_rows_added=hist1 - hist0)
        check(names == names0 and rows1 - rows0 >= len(frames)
              and tasks1 - tasks0 > 0,
              f"[tools] torch_top: worker {names0} -> {names}, eval rows "
              f"+{rows1 - rows0} (want >= {len(frames)}), tasks on {dev} "
              f"+{tasks1 - tasks0}")
        # the roofline ledger times a sample of the calls
        check(hist1 - hist0 > 0,
              f"[tools] torch_cost: no Histogram rows added on {dev}")
        check(trace["complete"] and trace["tasks"] > 0,
              f"[tools] torch_trace --verify: {trace}")
        out["trace_tasks"] = trace["tasks"]
        ledger = [e for rep in cost["nodes"].values()
                  for e in (rep or {}).get("ledger") or []]
        out["cost_ledger_kinds"] = json.dumps(sorted(
            {k for e in ledger for k in e.get("kinds") or []}))
        check(client.shutdown_cluster() == 1,
              "[tools] shutdown_cluster did not reach the worker")
    finally:
        client.stop()
        worker.stop()
        master.stop()
    return out


def hist_cases(g):
    """(what, uint8 frames, bins) that [kernel] holds the histogram
    kernel to its plain version on: the main path's shape, the batch
    sizes the engine and the shot path call with and a ragged one, every
    channel count with bins that take each kernel, flat channels, and a
    flat 1920 x 1080 frame (counts past 2^16 in one bin)."""
    import torch

    def rand(shape):
        return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    cases = [(f"random B={b}", rand((b, H, W, C)), BINS)
             for b in (1, 8, 16, 32, 33)]
    for c in (1, 2, 3, 4):
        for bins in (1, 16, 17, 128):
            cases.append((f"C={c} bins={bins}", rand((3, 37, 53, c)), bins))
    cases.append(("unaligned view of 97x131x3", rand((3, 97, 131, 3))[1:],
                  BINS))
    flat = torch.empty((4, H, W, C), dtype=torch.uint8)
    for c, v in enumerate((0, 255, 128)):
        flat[..., c] = v
    cases.append(("channels flat at 0, 255, 128", flat, BINS))
    cases.append(("channels flat, bins=17", flat, 17))
    cases.append(("flat 1920x1080x3",
                  torch.full((1, 1080, 1920, 3), 77, dtype=torch.uint8),
                  BINS))
    return cases


def hist_timings(dev, seed: int) -> dict:
    """The histogram kernel's device time alone (torch.profiler) where
    the main path finds its frames, cold: calls cycle over COLD_BATCHES
    distinct batches, so each reads its frames from device memory and not
    from the L2.  At 16 x 480 x 640 x 3: random bytes, flat frames, and
    every kernel one wrapper call runs; at B = 8 and B = 32 random."""
    from scanner_tpu_torch.kernels import cuda_ops
    out = {}
    for key, b, flat in (("kernel_device_ms_cold", 16, False),
                         ("kernel_device_ms_flat", 16, True),
                         ("kernel_device_ms_cold_b8", 8, False),
                         ("kernel_device_ms_cold_b32", 32, False)):
        batches = frame_batches(COLD_BATCHES, (b, H, W, C), seed, dev, flat)
        prof = device_ms(cycling(cuda_ops.histogram_frames, batches),
                         6 * COLD_BATCHES, ["hist"])
        out[key] = prof["hist"]
        out[f"{key}_events_per_call"] = prof["events per call"]["hist"]
        out[f"{key}_empty_takes"] = prof["empty takes"]
        # the wrapper runs the kernel and nothing else on the card: no
        # fill, no second pass.  The count may read under 1 (the profiler
        # can drop a record), never over.
        check(not prof["others"] and prof["kernels per call"] <= 1,
              f"a histogram wrapper call ran {prof['kernels per call']} "
              f"kernels on the card, not 1: {prof['others']}")
        if key == "kernel_device_ms_cold":
            out["device_ms_per_call_all_kernels"] = prof["all kernels"]
            out["kernels_per_call"] = prof["kernels per call"]
        del batches
    out["flat_over_random"] = ratio(out["kernel_device_ms_flat"],
                                    out["kernel_device_ms_cold"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    # [coordinator]'s child: MASTER DB COORDINATOR OUT DEVICE
    ap.add_argument("--coordinator-worker", nargs=5,
                    help=argparse.SUPPRESS)
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
    if args.coordinator_worker:
        return coordinator_worker(*args.coordinator_worker)
    sys.path.insert(0, HERE)
    import numpy as np

    import scanner_tpu_torch as st
    import scanner_tpu_torch.kernels  # noqa: F401
    from scanner_tpu_torch import native
    from scanner_tpu_torch.kernels import attention, color, cuda_ops
    import scanner_tpu_torch.models  # noqa: F401  (registers the models)
    register_smoke_ops(st)

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    libav = have_libav()
    phase("environment", python=sys.version.split()[0],
          torch=torch.__version__, cuda=torch.version.cuda,
          card=repr(card), libav=libav,
          msgpack=have_module("msgpack"),
          cloudpickle=have_module("cloudpickle"),
          google_crc32c=have_module("google_crc32c"),
          grpc=have_module("grpc"),
          main_path_source="stored-frame-table")

    # explicit: full f32 in the plain versions' matmuls and in the
    # models' f32 convolutions (the last heatmap layer), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- build: one nvcc per kernel source, started together -------------
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(cuda_ops.load_library),
                    pool.submit(attention.load_library)]:
            fut.result()
    scvid = "skipped (no libav; the main path reads a stored frame table)"
    if libav:
        from scanner_tpu_torch.video import lib as vlib
        vlib.get_lib()
        scvid = f"{native.build_seconds.get('libscvid.so', 0.0):.2f}s"
    sass = sass_counts(os.path.join(native.BUILD_DIR, "libscanner_flash.so"),
                       ("HGMMA", "UTMALDG"))
    loop = hot_loop(os.path.join(native.BUILD_DIR, "libscanner_hist.so"),
                    HIST_MAIN_FUNCTION)
    caps = cuda_ops.cluster_caps(torch.cuda.current_device())
    phase("build", histogram_kernel_s=round(
        native.build_seconds.get("libscanner_hist.so", 0.0), 3),
        flash_kernel_s=round(
            native.build_seconds.get("libscanner_flash.so", 0.0), 3),
        libscvid=repr(scvid), flash_sass=json.dumps(sass),
        hist_hot_loop=json.dumps(loop and dict(
            instructions=loop[0], loads_16B=loop[1],
            instructions_per_byte=round(loop[2], 3))),
        sms=torch.cuda.get_device_properties(0).multi_processor_count,
        hist_cluster_caps=json.dumps(caps),
        hist_blocks_per_frame=json.dumps({b: cuda_ops.blocks_per_row(
            b, H * W * C, caps) for b in (1, 8, 16, 32, 33)}))
    if sass is not None:
        check(all(sass.values()), f"the flash library's SASS lacks the "
                                  f"tensor-core or TMA path: {sass}")

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

    n_checks = 0
    for what, f, bins in hist_cases(g):
        compare(cuda_ops.histogram_frames(f.to(dev), bins),
                cuda_ops.histogram_frames_plain(f, bins), what)
        n_checks += 1
    # views into one flat buffer at byte offsets 0..15
    shape = (3, 61, 47, 3)
    n = shape[0] * shape[1] * shape[2] * shape[3]
    buf = torch.randint(0, 256, (n + 16,), generator=g, dtype=torch.uint8)
    buf_dev = buf.to(dev)
    for off in range(16):
        compare(cuda_ops.histogram_frames(
                    buf_dev[off:off + n].view(shape)),
                cuda_ops.histogram_frames_plain(buf[off:off + n].view(shape)),
                f"view at byte offset {off} of {shape}")
        n_checks += 1
    for rows, pix, bins in [(48, 30001, BINS), (5, 1000, 128), (3, 7, 1)]:
        ids = torch.randint(-2, bins + 3, (rows, pix), generator=g,
                            dtype=torch.int32)
        compare(cuda_ops.histogram_ids(ids.to(dev), bins),
                cuda_ops.histogram_ids_plain(ids, bins),
                f"int32 ids + padding {rows}x{pix}, bins={bins}")
        n_checks += 1
    phase("kernel", checks=n_checks, max_abs_err=max_err, tolerance=0)

    # -- flash-attention kernel check -----------------------------------
    flash_errs = {"m": 0.0, "l": 0.0, "out": 0.0, "f32_out": 0.0}
    n_checks = check_attention_kernel(dev, args.seed, flash_errs)
    phase("attention_kernel", checks=n_checks, reference="plain(TF32 q,k,v)",
          max_abs_err_m=flash_errs["m"], max_abs_err_l=flash_errs["l"],
          max_abs_err_acc_over_l=flash_errs["out"],
          tolerance=f"m,l:rtol={FLASH_RTOL},atol={FLASH_ATOL};"
                    f"acc/l:rtol={FLASH_RTOL},atol=2*2^-11*max|v|",
          max_abs_err_acc_over_l_vs_f32_inputs=flash_errs["f32_out"],
          fully_masked_unchanged=True)

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
        # the main path's client serves telemetry on an ephemeral
        # loopback port ([telemetry]) and starts the process health
        # engine and remediation controller ([health])
        gpu = st.Client(db_path=db_path, device="cuda", metrics_port=0)
        from scanner_tpu_torch.util import health
        ticks = time_ticks(health.engine())
        gpu.new_table("frames", ["frame"], [[f] for f in frames],
                      codecs={"frame": "pickle"})
        secs, stages, launches = {}, {}, {}
        torch.cuda.reset_peak_memory_stats()
        for cfg in (1, 2, "shot"):
            cuda_ops.reset_counts()
            secs[cfg], stages[cfg] = run_config(gpu, st, cfg,
                                                f"config{cfg}_cuda")
            launches[cfg] = cuda_ops.histogram_launches
            check(launches[cfg] > 0,
                  f"config {cfg}: the histogram kernel never launched")
        phase("ledgers", **ledgers(gpu, ("Histogram", "HistDiff"),
                                   "configs 1, 2, shot"), card=repr(card))
        # around the main path, on its client, before the CPU client
        # opens the database (two clients keep their own metadata)
        dev_label = str(torch.device("cuda", torch.cuda.current_device()))
        phase("health", **health_phase(gpu, st, dev_label, args.frames,
                                       ticks), card=repr(card))
        phase("telemetry", **telemetry_phase(gpu, st, dev_label,
                                             args.frames), card=repr(card))
        phase("device_trace", **device_trace_phase(
            gpu, st, work, args.frames, round(args.frames / secs[1], 3)),
            card=repr(card))
        phase("serial", **serial_phase(gpu, st, gpu._db, args.frames),
              card=repr(card))
        wt = worker_task_phase(gpu, st, args.frames, cuda_ops)
        check(wt["launches"] == launches[1],
              f"[worker_task] launched the histogram kernel "
              f"{wt['launches']} times, config 1 {launches[1]}")
        phase("worker_task", **wt, card=repr(card))
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
        config1_rows = hist     # [sharded] differences them on the card
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

        # -- the cluster: a master and a worker over gRPC -------------
        cluster_launches = 0
        if have_module("grpc"):
            from scanner_tpu_torch.util import faults
            main_rows = {cfg: stored_items(cpu._db, f"config{cfg}_cuda")
                         for cfg in (1, 2)}
            cl = cluster_phase(st, frames, work, main_rows, launches,
                               cuda_ops, faults)
            cluster_launches = (cl["config1_launches"]
                                + cl["config2_launches"]
                                + cl["drill_launches"])
            phase("cluster", ran=True, **cl,
                  main_path_config1_fps=round(args.frames / secs[1], 3),
                  card=repr(card))
            # -- gangs: two member processes sharing the card ---------
            gg = gang_phase(st, frames, work, main_rows, cuda_ops, faults,
                            f"cuda:{torch.cuda.current_device()}")
            cluster_launches += gg["launches"]
            phase("gang", ran=True, **gg,
                  main_path_config1_fps=round(args.frames / secs[1], 3),
                  card=repr(card))
            # -- a worker joined to a process group for its lifetime --
            co = coordinator_phase(st, frames, work, main_rows,
                                   launches[1])
            cluster_launches += co["launches"]
            phase("coordinator", ran=True, **co,
                  main_path_config1_fps=round(args.frames / secs[1], 3),
                  card=repr(card))
            # -- the chaos tool's drills, then the operator tools -------
            ch = chaos_phase(work)
            cluster_launches += ch["launches"]
            phase("chaos", ran=True, **ch, card=repr(card))
            tl = tools_phase(st, frames, work, main_rows, cuda_ops)
            cluster_launches += tl["launches"]
            phase("tools", ran=True, **tl, card=repr(card))
        else:
            for name in ("cluster", "gang", "coordinator", "chaos",
                         "tools"):
                phase(name, ran=False, reason="no-grpcio")

        # -- the pose model: serve, then train ------------------------
        phase("pose_serve", **pose_serve(st, work, args.seed))
        train = pose_train(dev, args.seed, flash_errs)
        phase("pose_train", **train)
        tr = train_phase(st, dev, work, args.seed, flash_errs)
        phase("train", **tr, card=repr(card))
        flash_launches = train["flash_launches"] + tr["pose_flash_launches"]
        flash_err = max(flash_errs[k] for k in ("m", "l", "out"))

        # -- the model zoo, then the golden chain ----------------------
        phase("model_serve", **model_serve(st, work, args.seed),
              card=repr(card))
        phase("dp_apply", **dp_apply_phase(args.seed), card=repr(card))
        gold = golden(st, work, args.seed)
        phase("golden", **gold, card=repr(card))
        phase("ledgers", **ledgers(gpu, ("Resize", "Blur", "Histogram",
                                         "Resize+Blur",
                                         "Resize+Blur+Histogram"),
                                   "golden"), card=repr(card))
        phase("warmup", **warmup(st, work, args.seed), card=repr(card))

        # -- timings at the main path's shape -------------------------
        x = torch.from_numpy(frames[:16]).to(dev)
        b, hh, ww, c = x.shape
        hist = hist_timings(dev, args.seed)
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
        warm = device_ms(lambda: cuda_ops.histogram_frames(x), 50, ["hist"])
        phase("timings", shape=f"{b}x{hh}x{ww}x{c}", kernel_ms=ms,
              kernel_device_ms=warm["hist"],
              kernel_device_ms_events_per_call=warm["events per call"][
                  "hist"], kernel_device_ms_empty_takes=warm["empty takes"],
              **hist, plain_ms=plain_ms,
              library_ms=library_ms, bound_ms=bound_ms,
              device_share_of_bound=ratio(bound_ms,
                                          hist["kernel_device_ms_cold"]),
              launches_per_600_frame_run=launches[1], card=repr(card))

        # -- the flash kernel at tools/tpu_window.py's shape and at the
        # train step's, from an empty carry, where one update divided by
        # l is exactly scaled_dot_product_attention (q arrives
        # pre-scaled) ---------------------------------------------------
        for fshape in (FLASH_SHAPE, TRAIN_FLASH_SHAPE):
            fb, ft, fd = fshape
            fargs = flash_inputs(torch.Generator().manual_seed(args.seed),
                                 fb, ft, ft, fd, False, dev)
            fq, fk, fv = fargs[:3]

            def kernel_call():
                attention.flash_block_update(*fargs, 0, 0)
            f_ms = cuda_ms(kernel_call, 20)
            f_dev = device_ms(kernel_call, 20, ["flash_tf32_kernel",
                                                "transpose_v_kernel"])
            f_plain_ms = cuda_ms(
                lambda: attention.flash_block_update_plain(*fargs, 0, 0), 5)
            f_library_ms = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    fq, fk, fv, scale=1.0), 20)
            f_bound_ms, f_by, f_flops = flash_bound(fb, ft, ft, fd)
            if fshape == FLASH_SHAPE:   # the kernels line's entry
                big = dict(ms=f_ms, plain_ms=f_plain_ms,
                           library_ms=f_library_ms, bound_ms=f_bound_ms,
                           bound_by=f_by)
            phase("timings", kernel="flash_block_update",
                  shape=f"{fb}x{ft}x{ft}x{fd}", causal=False,
                  kernel_ms=f_ms,
                  kernel_device_ms=f_dev["flash_tf32_kernel"],
                  transpose_device_ms=f_dev["transpose_v_kernel"],
                  events_per_call=json.dumps(f_dev["events per call"]),
                  empty_takes=f_dev["empty takes"],
                  plain_ms=f_plain_ms, library_ms=f_library_ms,
                  library="F.scaled_dot_product_attention(f32)",
                  bound_ms=f_bound_ms, bound_by=f_by,
                  device_share_of_bound=ratio(f_bound_ms,
                                              f_dev["flash_tf32_kernel"]),
                  wrapper_share_of_bound=f_bound_ms / f_ms,
                  achieved_tflops=f_flops / (f_ms * 1e-3) / 1e12,
                  faster_than_library=f_ms < f_library_ms,
                  launches_per_train_step=2, card=repr(card))
            check(f_ms < f_library_ms,
                  f"flash kernel ({f_ms:.4f} ms) is not faster than f32 "
                  f"scaled_dot_product_attention ({f_library_ms:.4f} ms) "
                  f"at {fb}x{ft}x{fd}")

        # -- in-program sharding on a one-rank NCCL group ---------------
        phase("sharded", **sharded_phase(dev, args.seed, config1_rows,
                                         work),
              card=repr(card))

        # -- the frame cache last: its closed loop fills the card ------
        phase("framecache", **framecache_phase(
            st, frames, torch.device(dev_label), args.seed, work),
            card=repr(card))
        gpu.stop()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "histogram_frames",
        "route": "cuda",
        "source": "scanner_tpu_torch/csrc/histogram.cu",
        "replaces": "scanner_tpu/kernels/pallas_ops.py:33",
        "launches": launches[1] + wt["launches"] + cluster_launches
        + gold["histogram_launches"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }, {
        "name": "flash_block_update",
        "route": "cuda",
        "source": "scanner_tpu_torch/csrc/flash_attention.cu",
        "replaces": "scanner_tpu/kernels/pallas_attention.py:50",
        "launches": flash_launches,
        "max_abs_err": flash_err,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes" if big["bound_by"] == "bytes"
        else "operations",
        "library_ms": big["library_ms"],
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
