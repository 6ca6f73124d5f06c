#!/usr/bin/env python3
"""Time the histogram kernel against other versions of its source, in
turns on one card, and break down the wrapper's host cost.

    python3 tools/torch_hist_ab.py [--variant NAME=path.cu ...]
        [--parent-wrapper path/cuda_ops.py] [--iters 48] [--out FILE]

The checkout's kernel (scanner_tpu_torch/csrc/histogram.cu) is "this";
each --variant is another source, built into scanner_tpu_torch/_build/.
Each version runs in a process of its own: two libraries built from one source do
not load side by side (the second one's kernels fail to launch).  A source whose library has
no `hist_abi_version` entry is taken to be the first design's (the
caller zeroes the output and the kernel adds into it).  For each
version it prints what ptxas -v says of its main-path kernel (registers,
spills) and the SASS instructions per input byte of that kernel's hot
loop (cuobjdump), then holds it against the plain version bit for bit.
Then every case is timed in the order this, variants..., variants
reversed, this: the kernel's device time alone and every kernel a call
runs (torch.profiler), cold (the calls cycle over 8 distinct batches,
past the 50 MB L2) or warm (one batch again and again).

With --parent-wrapper (the first design's kernels/cuda_ops.py) and a
variant named "parent", the first design's wrapper is timed beside this
one's, and each host cost it had is timed apart (microseconds per call,
host clock).  Prints the card's name and power limit first.  Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import (HIST_MAIN_FUNCTION, cuda_ms, cycling,  # noqa: E402
                        device_ms, frame_batches, hot_loop)
from scanner_tpu_torch.kernels import cuda_ops  # noqa: E402

# the first design's main-path kernel (hist_kernel<unsigned char>)
FIRST_FUNCTION = "hist_kernelIhE"
CASES = [  # (name, batch, cold, flat)
    ("16x480x640x3 cold", 16, True, False),
    ("16x480x640x3 warm", 16, False, False),
    ("16x480x640x3 flat cold", 16, True, True),
    ("8x480x640x3 cold", 8, True, False),
    ("32x480x640x3 cold", 32, True, False),
]


class Version:
    """One build of a histogram source and how to call it."""

    def __init__(self, name: str, path: str):
        self.name, self.path = name, path
        self.lib = ctypes.CDLL(path)
        self.first = not hasattr(self.lib, "hist_abi_version")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if self.first:
            self.lib.hist_u8_frames.argtypes = [vp, vp, ll, ll, ci, ci, vp]
            self.lib.hist_i32_ids.argtypes = [vp, vp, ll, ll, ci, vp]
            self.lib.hist_u8_frames.restype = ci
            self.lib.hist_i32_ids.restype = ci
        else:
            self.lib = cuda_ops.bind_library(path)

    def frames(self, x: torch.Tensor, bins: int = 16) -> torch.Tensor:
        if not self.first:
            return self._call(self.lib.hist_u8_frames, x, x.shape[0],
                              x[0].numel(), (x.shape[0], x.shape[-1], bins),
                              x.shape[-1], bins)
        b, h, w, c = x.shape
        out = torch.zeros((b, c, bins), dtype=torch.int32, device=x.device)
        self._check(self.lib.hist_u8_frames(
            x.data_ptr(), out.data_ptr(), b, h * w * c, c, bins,
            torch.cuda.current_stream().cuda_stream))
        return out

    def ids(self, v: torch.Tensor, bins: int) -> torch.Tensor:
        R, P = v.shape
        if not self.first:
            return self._call(self.lib.hist_i32_ids, v, R, P, (R, bins),
                              bins)
        out = torch.zeros((R, bins), dtype=torch.int32, device=v.device)
        self._check(self.lib.hist_i32_ids(
            v.data_ptr(), out.data_ptr(), R, P, bins,
            torch.cuda.current_stream().cuda_stream))
        return out

    def _call(self, fn, t, rows, n, shape, *args):
        """This design's calling convention (kernels/cuda_ops.py
        _launch), on this version's library."""
        k = cuda_ops.blocks_per_row(rows, n * t.element_size(),
                                    cuda_ops.cluster_caps(t.device.index,
                                                          self.lib))
        out = torch.empty(shape, dtype=torch.int32, device=t.device)
        self._check(fn(t.data_ptr(), out.data_ptr(), rows, n, *args, k,
                       torch.cuda.current_stream().cuda_stream))
        return out

    def _check(self, err: int) -> None:
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err}")


def ptxas_report(src: str, functions) -> list:
    """ptxas -v's lines on registers and spills of the kernels whose
    mangled name holds one of `functions`."""
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            [cuda_ops.nvcc_path(), "-gencode",
             "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas",
             "-v", "-shared", "-Xcompiler", "-fPIC", "-o",
             os.path.join(tmp, "lib.so"), src],
            capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
    keep, lines = False, []
    for x in r.stderr.splitlines():
        if "Compiling entry" in x:
            keep = any(f in x for f in functions)
        if keep and any(k in x for k in ("Compiling entry", "registers",
                                         "spill")):
            lines.append(x.strip())
    return lines


def check(v: Version, dev) -> str:
    g = torch.Generator().manual_seed(0)
    cases = [torch.randint(0, 256, (16, 480, 640, 3), generator=g,
                           dtype=torch.uint8),
             torch.full((16, 480, 640, 3), 200, dtype=torch.uint8),
             torch.randint(0, 256, (3, 97, 131, 3), generator=g,
                           dtype=torch.uint8)]
    for f in cases:
        got = v.frames(f.to(dev))
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), cuda_ops.histogram_frames_plain(f)):
            raise RuntimeError(f"{v.name} disagrees on frames {f.shape}")
    f = cases[2]
    got = v.frames(f.to(dev)[1:])
    if not torch.equal(got.cpu(), cuda_ops.histogram_frames_plain(f[1:])):
        raise RuntimeError(f"{v.name} disagrees on an unaligned view")
    ids = torch.randint(-2, 19, (48, 30001), generator=g, dtype=torch.int32)
    if not torch.equal(v.ids(ids.to(dev), 16).cpu(),
                       cuda_ops.histogram_ids_plain(ids, 16)):
        raise RuntimeError(f"{v.name} disagrees on int32 ids")
    return f"check {v.name}: ok, bit for bit (5 cases)"


def host_us(fn, n: int = 5000) -> float:
    """Host microseconds per call of fn, by the host clock."""
    for _ in range(100):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def host_costs(x: torch.Tensor) -> None:
    """Prints the microseconds of each host cost the first design's
    wrapper paid per call, beside what this wrapper pays instead."""
    dev = x.device
    idx = dev.index
    lock = threading.Lock()
    box = {"lib": cuda_ops.load_library(), "n": 0}
    empty_lib = cuda_ops.load_library().hist_u8_frames

    def locked_lookup():
        with lock:
            if box["lib"] is None:
                box["lib"] = cuda_ops.load_library()
        return box["lib"]

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    def count_locked():
        with lock:
            box["n"] += 1
    rows = [
        ("torch.zeros((16, 3, 16)) [first]",
         lambda: torch.zeros((16, 3, 16), dtype=torch.int32, device=dev)),
        ("torch.empty((16, 3, 16)) [this]",
         lambda: torch.empty((16, 3, 16), dtype=torch.int32, device=dev)),
        ("load_library() under its lock [first]", locked_lookup),
        ("cached library lookup [this]",
         lambda: cuda_ops._lib or cuda_ops.load_library()),
        ("with torch.cuda.device(dev) [first]", device_ctx),
        ("torch.cuda.current_device() == index [this]",
         lambda: torch.cuda.current_device() == idx),
        ("torch.cuda.current_stream().cuda_stream [first]",
         lambda: torch.cuda.current_stream().cuda_stream),
        ("torch.cuda.current_stream(index).cuda_stream [this]",
         lambda: torch.cuda.current_stream(idx).cuda_stream),
        ("cluster caps lookup and blocks_per_row [this]",
         lambda: cuda_ops.blocks_per_row(16, 921600,
                                         cuda_ops.cluster_caps(idx))),
        ("count under a lock [both]", count_locked),
        ("ctypes call, B = 0 (no launch) [this]",
         lambda: empty_lib(0, 0, 0, 0, 3, 16, 1, 0)),
        ("the checks: dim, dtype, device, shape, contiguity [both]",
         lambda: (x.dim() == 4 and x.dtype == torch.uint8
                  and x.device.type == "cuda" and x.shape[-1] <= 4
                  and x.is_contiguous())),
        ("histogram_frames(x), host only [this]",
         lambda: cuda_ops.histogram_frames(x)),
    ]
    for what, fn in rows:
        us = host_us(fn)
        torch.cuda.synchronize()
        print(f"host {us:9.3f} us  {what}", flush=True)


def load_parent_wrapper(path: str, lib):
    """The first design's wrapper module, bound to the first design's
    library `lib`."""
    spec = importlib.util.spec_from_file_location(
        "scanner_tpu_torch.kernels._first_cuda_ops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._lib = lib
    return mod


def worker(args) -> int:
    """One version's turn, in a process of its own: its check (first
    turn), every case's timings, and for "this" and "parent" the
    wrapper's time per call and host costs."""
    dev = torch.device("cuda")
    name, path = args.worker.split("=", 1)
    if name == "this":   # the wrapper's own library: no second copy
        cuda_ops.load_library()
        path = cuda_ops.build_kernel_library("libscanner_hist.so",
                                             cuda_ops._SRC)
    v = Version(name, path)
    if not v.first:
        caps = cuda_ops.cluster_caps(0, v.lib)
        print(f"cluster caps {caps}; blocks per frame at B = 8, 16, 32: "
              f"{[cuda_ops.blocks_per_row(b, 921600, caps) for b in (8, 16, 32)]}",
              flush=True)
    if args.check:
        print(check(v, dev), flush=True)
    for case, b, cold, flat in CASES:
        batches = frame_batches(8 if cold else 1, (b, 480, 640, 3),
                                args.seed, dev, flat)
        prof = device_ms(cycling(v.frames, batches), args.iters, ["hist"])
        print(f"{case:>24} {name:>10}  kernel {prof['hist']:.5f} ms  "
              f"all kernels {prof['all kernels']:.5f} ms  kernels/call "
              f"{prof['kernels per call']:.2f}", flush=True)
        del batches
    if args.check and name in ("this", "parent"):
        x = frame_batches(1, (16, 480, 640, 3), args.seed, dev)[0]
        parent = None
        fn = cuda_ops.histogram_frames
        if name == "parent" and args.parent_wrapper:
            parent = load_parent_wrapper(args.parent_wrapper, v.lib)
            fn = parent.histogram_frames
        if name == "this" or parent is not None:
            for _ in range(2):
                print(f"wrapper {name}: {cuda_ms(lambda: fn(x), 200):.5f} "
                      f"ms per call (CUDA events, back to back)",
                      flush=True)
            if parent is None:
                host_costs(x)
            else:
                print(f"host {host_us(lambda: fn(x)):9.3f} us  first "
                      f"design's histogram_frames(x), host only",
                      flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=path.cu")
    ap.add_argument("--parent-wrapper", default=None)
    ap.add_argument("--iters", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    if args.worker:
        return worker(args)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    lines = [f"card: {card}"]
    print(lines[0], flush=True)
    specs = [("this", cuda_ops._SRC)]
    for v in args.variant:
        name, src = v.split("=", 1)
        specs.append((name, os.path.abspath(src)))
    with ThreadPoolExecutor(2 * len(specs)) as pool:  # one nvcc each
        built = [pool.submit(cuda_ops.build_kernel_library,
                             f"libscanner_hist_ab_{name}.so", src)
                 for name, src in specs]
        reports = [pool.submit(ptxas_report, src,
                               [HIST_MAIN_FUNCTION, FIRST_FUNCTION])
                   for _, src in specs]
        paths = {spec[0]: f.result() for spec, f in zip(specs, built)}
        reports = [f.result() for f in reports]
    for (name, src), report in zip(specs, reports):
        loop = None
        for function in (HIST_MAIN_FUNCTION, FIRST_FUNCTION):
            loop = loop or hot_loop(paths[name], function)
        lines += [f"{name}: {src}"] + report
        lines.append(f"{name}: hot loop " + (
            "not found" if loop is None else
            f"{loop[0]} instructions, {loop[1]} 16-byte loads, "
            f"{loop[2]:.3f} instructions per byte"))
        print("\n".join(lines[-len(report) - 2:]), flush=True)

    names = [spec[0] for spec in specs]
    for turn, name in enumerate(names + names[::-1]):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               f"{name}={paths[name]}", "--iters", str(args.iters),
               "--seed", str(args.seed)]
        if turn < len(names):
            cmd.append("--check")
        if args.parent_wrapper:
            cmd += ["--parent-wrapper", args.parent_wrapper]
        r = subprocess.run(cmd, capture_output=True, text=True)
        out = r.stdout.strip().splitlines()
        lines += out
        print("\n".join(out), flush=True)
        if r.returncode:
            print(r.stderr, file=sys.stderr)
            raise RuntimeError(f"the turn of {name} failed")
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
