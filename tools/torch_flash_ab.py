#!/usr/bin/env python3
"""Time the flash-attention kernel against other versions of its source,
in turns on one card.

    python3 tools/torch_flash_ab.py [--variant NAME=path.cu ...]
        [--shape BHxTxD[c] ...] [--iters 20] [--out FILE]

The checkout's kernel (scanner_tpu_torch/csrc/flash_attention.cu) is
"this"; each --variant is another source with the same C entry
(flash_block_update_f32), built with nvcc into scanner_tpu_torch/_build/
and called through the same wrapper.  Each version is first held against
the plain version on TF32 operands at small shapes (as chip_smoke.py
does), then every shape (a trailing "c": causal) is timed in the order
this, variants..., variants reversed, this: the kernel's device time
alone from torch.profiler and the wrapper call's time from CUDA events.
Prints the card's name and power limit first, and what ptxas -v says of
the checkout's kernels (registers, shared memory, spills).  Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from chip_smoke import (compare_flash, cuda_ms, device_ms,  # noqa: E402
                        flash_inputs)
from scanner_tpu_torch.kernels import attention, cuda_ops  # noqa: E402

CHECKS = [  # (BH, Tq, Tk, D, q_off, k_off, causal, carry)
    (3, 193, 77, 40, 0, 0, False, True),
    (5, 130, 150, 64, 100, 37, True, True),
    (3, 300, 250, 128, 37, 11, True, True),
    (2, 100, 90, 6, 0, 0, True, True),
]


def load_variant(name: str, src: str):
    lib = ctypes.CDLL(cuda_ops.build_kernel_library(
        f"libscanner_flash_{name}.so", os.path.abspath(src)))
    ref = attention.load_library().flash_block_update_f32
    lib.flash_block_update_f32.argtypes = ref.argtypes
    lib.flash_block_update_f32.restype = ref.restype
    return lib


def ptxas_report(src: str) -> list:
    """ptxas -v's lines on registers, spills and warnings for `src`."""
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            [cuda_ops.nvcc_path(), "-gencode",
             "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas",
             "-v", "-shared", "-Xcompiler", "-fPIC", "-o",
             os.path.join(tmp, "lib.so"), src],
            capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
    keep = ("Compiling entry", "registers", "spill", "C75")
    return [x.strip() for x in r.stderr.splitlines()
            if any(k in x for k in keep)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=path.cu")
    ap.add_argument("--shape", action="append", default=None,
                    help="BHxTxD, 'c' appended for causal")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    lines = [f"card: {card}"] + ptxas_report(attention._SRC)
    print("\n".join(lines), flush=True)
    libs = {"this": attention.load_library()}
    for v in args.variant:
        name, src = v.split("=", 1)
        libs[name] = load_variant(name, src)
    dev = torch.device("cuda")
    for name, lib in libs.items():
        attention._lib = lib
        errs = {"m": 0.0, "l": 0.0, "out": 0.0, "f32_out": 0.0}
        g = torch.Generator().manual_seed(0)
        for bh, tq, tk, d, qo, ko, causal, carry in CHECKS:
            a = flash_inputs(g, bh, tq, tk, d, carry, dev)
            compare_flash(attention.flash_block_update(*a, qo, ko,
                                                       causal=causal),
                          a, qo, ko, causal, f"{name} {bh}x{tq}x{tk}x{d}",
                          errs)
        lines.append(f"check {name}: ok, max abs err m {errs['m']:.3g} "
                     f"l {errs['l']:.3g} acc/l {errs['out']:.3g}")
        print(lines[-1], flush=True)
    order = list(libs) + list(libs)[::-1]
    for shape in args.shape or ["16x2048x128", "8x2048x32"]:
        causal = shape.endswith("c")
        bh, t, d = (int(x) for x in shape.rstrip("c").split("x"))
        a = flash_inputs(torch.Generator().manual_seed(0), bh, t, t, d,
                         False, dev)

        def call():
            attention.flash_block_update(*a, 0, 0, causal=causal)
        for name in order:
            attention._lib = libs[name]
            kernel = device_ms(call, args.iters,
                               ["flash_tf32_kernel"])["flash_tf32_kernel"]
            wrapper = cuda_ms(call, args.iters)
            lines.append(f"{shape:>14} {name:>12}  kernel {kernel:.5f} ms  "
                         f"wrapper {wrapper:.5f} ms")
            print(lines[-1], flush=True)
    attention._lib = libs["this"]
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
