"""The readings that the limits of `correct` are set from, many seeds in
one process (set-up is long, a window short):

    python3 benchmark/harness/readings.py --workload hist.bulk \
        --seeds 11,12,13 --seconds 4 [--control 1]

For each seed, the run's own path: the inputs made from the seed, the
program started, every distinct job warmed up, a closed-loop window of
--seconds, the stored rows judged against the reference.  With
--control 1 the reference in the nearest precision below the
configuration's (reference/<name>.py control_results) is also put in
the program's place over every distinct job's clip, and judged the same
way.  One JSON line per seed.  The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def readings(cell, seed: int, seconds: float, control: bool,
             device) -> dict:
    from benchmark.run import Session
    work = tempfile.mkdtemp(prefix="bench_readings_")
    try:
        s = Session(cell, seed, device, work)
        err = s.warm_up()
        if err:
            return {"seed": seed, "error": err}
        win = s.window(seed, seconds)
        results = s.stored(win)
        s.close()
        out = {"seed": seed, "jobs": len(win.jobs),
               "failed": sum(1 for j in win.jobs if j.error),
               "program": {k: v for k, (v, _) in s.judge(results).items()}}
        if control:
            low = cell.reference.control_results(
                cell.config, s.prepared, s.frames, s.clips(), device)
            out["control"] = {k: v for k, (v, _) in s.judge(low).items()}
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness import spec
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.resolve(ROOT, args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds,
                                  bool(args.control), torch.device("cuda"))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
