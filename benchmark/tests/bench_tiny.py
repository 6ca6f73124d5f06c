"""A copy of the benchmark at a tiny size, for driving whole runs on the
CPU: the same files, the frames cut to 24 of 48x64 and the jobs to a few
frames.  Not a test module."""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_FRAMES = 24
TINY_JOB = {"bulk": 24, "clips": 6}


def tiny_root(dest: str) -> str:
    """`dest` made a checkout of the benchmark alone, at the tiny size;
    returns it."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        doc = json.load(f)
    for c in doc["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        cfg["frames"].update(count=TINY_FRAMES, height=48, width=64)
        with open(os.path.join(dest, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in doc["workloads"]:
        path = os.path.join(dest, "benchmark", "traffic",
                            w["traffic"] + ".json")
        with open(path) as f:
            mix = json.load(f)
        mix.update(frames_per_job=TINY_JOB.get(w["traffic"], 6),
                   work_packet_size=2, io_packet_size=4)
        with open(path, "w") as f:
            json.dump(mix, f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)
    return dest


def run_tiny(root: str, workload: str, capsys, seed: int = 2 ** 33 + 5,
             seconds: float = 2.0, trace: int = 0):
    """One run of `workload` in `root` on the CPU: (exit code, the
    result's line parsed or None)."""
    from benchmark import run
    capsys.readouterr()
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  root=root, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    try:
        return rc, json.loads(lines[-1])
    except (IndexError, ValueError):
        return rc, None
