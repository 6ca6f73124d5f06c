"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 benchmark/run.py --workload hist.bulk --seed 7 --seconds 51 \
        --trace 0

From the root of a checkout.  One run, one process:
  1. makes the cell's inputs from --seed (frames on the card; weights
     where the configuration's reference takes some);
  2. starts the program (scanner_tpu_torch), writes the stored frame
     table and warms up by sending one job of each length the traffic
     mix sends;
  3. sends jobs in a closed loop for --seconds, and with --trace 1 runs
     torch.profiler over a slice of it;
  4. reads back every row the window's jobs stored and compares them
     with the plain reference (reference/<name>.py), once the program's
     state is freed;
  5. prints each compared number beside its limit on standard error and
     the result as the last line of standard output.
With --trace 0 the result's metrics are the cell's end-to-end metrics,
with --trace 1 its per-layer metrics (metrics/<name>.py).  Exits 2,
printing no result, without enough CUDA cards, and 3 if JAX or the JAX
package was loaded by the time the result would be printed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

T_START = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "scanner_tpu")


def process_start() -> float:
    """When this process started, by the host clock (/proc), or when
    this file began to run where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        t = btime + ticks / os.sysconf("SC_CLK_TCK")
        return t if t <= T_START else T_START
    except (OSError, ValueError, StopIteration, IndexError):
        return T_START


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: str = ROOT, device=None) -> int:
    """One run; `device` other than None skips the look for a card and
    runs there (the tests drive the rest of a run on the CPU)."""
    t_start = process_start()
    args = parse(argv)
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch
    from benchmark.harness import spec
    cell = spec.resolve(root, args.workload)
    os.environ.update({k: str(v)
                       for k, v in cell.config.get("env", {}).items()})
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count()}"
                  if torch.cuda.is_available() else
                  "no CUDA card: the benchmark measures the card and has "
                  "no CPU mode", file=sys.stderr)
            return 2
        device = "cuda"
    work = tempfile.mkdtemp(prefix="bench_run_")
    try:
        return run(cell, args, torch.device(device), work, t_start)
    finally:
        shutil.rmtree(work, ignore_errors=True)


class Session:
    """The cell's inputs made from a seed and the program started on
    them: the frame table written, nothing yet sent.  The program is
    one local `Client` with the configuration's `client` arguments, or
    whatever its deployment module starts."""

    def __init__(self, cell, seed: int, device, work: str):
        import scanner_tpu_torch as st
        import scanner_tpu_torch.kernels  # noqa: F401  (registers the ops)
        import scanner_tpu_torch.models  # noqa: F401
        from benchmark.harness import frames as frames_mod
        from benchmark.harness import window
        self.cell, self.device, self.st = cell, device, st
        cfg, fr = cell.config, cell.config["frames"]
        self.n_frames = int(fr["count"])
        dev_frames = frames_mod.make_frames(
            self.n_frames, int(fr["height"]), int(fr["width"]), seed, device)
        self.frames = dev_frames.cpu().numpy()
        del dev_frames
        self.prepared = cell.reference.prepare(cfg, seed, device, work)
        db_path = os.path.join(work, "db")
        if cell.deployment is not None:
            self.client = cell.deployment.start(st, db_path, device, cfg)
        else:
            self.client = st.Client(db_path=db_path, device=device,
                                    **cfg.get("client", {}))
        self.client.new_table(window.FRAMES_TABLE, ["frame"],
                              [[f] for f in self.frames],
                              codecs={"frame": fr.get("codec", "pickle")})

    def send(self, job):
        from benchmark.harness import window
        return window.run_config(self.client, self.st, self.cell.config,
                                 self.cell.traffic, self.prepared, job,
                                 self.n_frames)

    def clips(self) -> list:
        """The distinct clips the traffic mix's jobs read."""
        return self.cell.generator.clips(self.cell.traffic, self.n_frames)

    def warm_up(self) -> str:
        """One job of each length the traffic sends (every clip of a
        length runs the same shapes); the first error."""
        from benchmark.harness import window
        firsts = {}
        for clip in self.clips():
            firsts.setdefault(clip[1] - clip[0], clip)
        for k, clip in enumerate(firsts.values()):
            job = self.send(window.Job(k, clip, f"warm_{k}"))
            if job.error:
                return f"warm-up job {clip} failed: {job.error}"
        return ""

    def window(self, seed: int, seconds: float, capture=None):
        from benchmark.harness import window
        gen = self.cell.generator
        loop = getattr(gen, "loop", window.closed_loop)
        return loop(self.send,
                    gen.job_order(self.cell.traffic, self.n_frames, seed),
                    seconds, tracer=capture)

    def stored(self, win) -> list:
        """(clip, rows) of every job of `win` that returned."""
        return [(j.clip, list(self.st.NamedStream(self.client,
                                                  j.table).load()))
                for j in win.jobs if not j.error]

    def close(self) -> None:
        """Stop the program and free what it holds on the device."""
        import torch
        if self.cell.deployment is not None:
            self.cell.deployment.stop(self.client)
        else:
            self.client.stop()
        self.client = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, results) -> dict:
        """{number: (value, limit)} of `results` against the reference."""
        return self.cell.reference.compare(self.cell.config, self.prepared,
                                           self.frames, results, self.device)


def run(cell, args, device, work, t_start) -> int:
    import torch
    from benchmark.harness import trace

    session = Session(cell, args.seed, device, work)
    err = session.warm_up()
    if err:
        print(err, file=sys.stderr)
        return 1
    capture = trace.Capture(work) if args.trace else None
    if capture is not None:
        capture.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_start
    # -- the window -----------------------------------------------------------
    win = session.window(args.seed, args.seconds, capture)
    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    device_trace = capture.read() if capture is not None else None
    # -- what the window's jobs stored, judged --------------------------------
    failed = [j for j in win.jobs if j.error]
    results = session.stored(win)
    session.close()
    checks = session.judge(results)
    correct = not failed and all(
        limit is not None and value <= limit
        for value, limit in checks.values())
    # -- the result -----------------------------------------------------------
    done = [j for j in win.jobs if not j.error]
    record = Record(cell, win, done, device_trace, device, setup_s)
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], record),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": record.device_kind, "count": cell.chips,
                "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": len(win.jobs),
           "failed": len(failed), "metrics": metrics, "device": dev_info}
    if args.trace:
        dev_info["busy_s"] = device_trace.busy_s if device_trace else 0.0
        dev_info["window_s"] = device_trace.window_s if device_trace else 0.0
        if device_trace is not None:
            out["breakdown"] = breakdown(device_trace, win)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    walls = sorted(j.wall for j in win.jobs)
    print(f"window: {len(walls)} jobs in {win.seconds:.3f} s, job wall "
          f"min {walls[0]:.4f} median {walls[len(walls) // 2]:.4f} max "
          f"{walls[-1]:.4f} s", file=sys.stderr)
    for j in failed[:5]:
        print(f"job {j.index} {j.clip} failed: {j.error}", file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    # last, so that whatever the judge or a reader loaded is seen too
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


class Record:
    """What a metric reader reads: the cell, the window's completed
    jobs, the traced slice (None without --trace 1), the device."""

    def __init__(self, cell, win, jobs, device_trace, device, setup_s):
        self.cell, self.config = cell, cell.config
        self.window, self.jobs = win, jobs
        self.trace = device_trace
        self.traced_jobs = [j for j in jobs if j.traced]
        self.device = device
        self.setup_s = setup_s
        import torch
        self.device_kind = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"

    @property
    def frames(self) -> int:
        return sum(j.frames for j in self.jobs)


def end_to_end(name: str, rec: Record) -> float:
    """The cell's end-to-end metrics, over all the window's jobs and all
    its time."""
    from benchmark.harness import stats
    if name == "setup_s":
        return rec.setup_s
    if name == "frames_per_s":
        return stats.rate(rec.frames, rec.window.seconds)
    if name == "job_p90_s":
        walls = [j.wall for j in rec.window.jobs]
        return stats.percentile(walls, stats.tail_percentile(len(walls), 90))
    raise KeyError(f"no end-to-end metric {name!r}")


def breakdown(tr, win) -> dict:
    """The traced slice's device operations by time, and its idle
    seconds by what the host was doing (the program's stage spans, the
    benchmark's `client` span around Client.run, `harness` outside)."""
    from benchmark.harness import trace
    spans = []
    for j in win.jobs:
        if j.traced:
            spans.append((j.t0, j.t1, "client"))
            spans.extend(j.spans)
    gaps = trace.label_gaps(tr.idle_gaps(), spans, "harness", "client")
    return {"device_ops": trace.top(tr.seconds_by_name()),
            "idle_gaps": trace.top(gaps)}


if __name__ == "__main__":
    sys.exit(main())
