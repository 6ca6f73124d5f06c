"""Jobs through the program's `Client.run`, and the closed loop that
sends them for a fixed time.

`run_config` is a frozen copy of `chip_smoke.py` `run_config` (commit
093baf35): the graph Input -> ops -> Output over the stored table,
`Client.run` timed by the host clock around it, and the job's stage
statistics from `client.get_profile(job)`.  Here the ops come from the
configuration's file, a clip's rows from a `Range` over the table, and
each job writes a table of its own, so that every job's rows can be
judged once the window has closed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

FRAMES_TABLE = "frames"


@dataclass
class Job:
    """One job as the benchmark saw it."""
    index: int
    clip: Tuple[int, int]
    table: str
    t0: float = 0.0                 # host clock before Client.run
    t1: float = 0.0                 # and after it returned
    stats: Dict[str, Any] = field(default_factory=dict)
    spans: List[Tuple[float, float, str]] = field(default_factory=list)
    error: Optional[str] = None
    traced: bool = False

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    @property
    def frames(self) -> int:
        return self.clip[1] - self.clip[0]

    def envelope(self) -> Optional[Tuple[float, float]]:
        """Earliest start to latest end of the job's stage spans."""
        if not self.spans:
            return None
        return (min(s for s, _, _ in self.spans),
                max(e for _, e, _ in self.spans))


def output_graph(client, st, config: Dict, op_args: Dict,
                 clip: Tuple[int, int], table_frames: int, out: str):
    """Input -> [Range] -> the configuration's ops -> Output(`out`)."""
    col = client.io.Input([st.NamedStream(client, FRAMES_TABLE)])
    if clip != (0, table_frames):
        col = client.streams.Range(col, [clip])
    for op in config["ops"]:
        args = {k: (op_args.get(v[1:-1], v) if isinstance(v, str)
                    and v.startswith("{") and v.endswith("}") else v)
                for k, v in op.get("args", {}).items()}
        col = getattr(client.ops, op["op"])(frame=col, **args)
    return client.io.Output(col, [st.NamedStream(client, out)])


def run_config(client, st, config: Dict, traffic: Dict, op_args: Dict,
               job: Job, table_frames: int) -> Job:
    """Run `job` to completion; fills its times, stage statistics and
    spans, or its error.  The mix's `run` entries go to `Client.run`."""
    perf = st.PerfParams.manual(int(traffic["work_packet_size"]),
                                int(traffic["io_packet_size"]))
    graph = output_graph(client, st, config, op_args, job.clip,
                         table_frames, job.table)
    job.t0 = time.time()
    try:
        jid = client.run(graph, perf, show_progress=False,
                         cache_mode=st.CacheMode.Overwrite,
                         **traffic.get("run", {}))
    except Exception as e:  # noqa: BLE001  (a failed job counts as failed)
        job.t1 = time.time()
        job.error = f"{type(e).__name__}: {e}"
        return job
    job.t1 = time.time()
    prof = client.get_profile(jid)
    job.stats = {k: v for k, v in prof.statistics().items()
                 if k != "_counters"}
    job.spans = [(iv.start, iv.end, iv.name)
                 for p in prof.profilers for iv in p.intervals()]
    return job


@dataclass
class Window:
    jobs: List[Job]
    t0: float
    t1: float                      # end of the last job the window sent

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def closed_loop(run: Callable[[Job], Job], order: Iterator[Tuple[int, int]],
                seconds: float, first_index: int = 0,
                tracer=None) -> Window:
    """Send jobs one after another while the window is open; the
    window closes when the last job sent before `seconds` had passed
    has returned.  With `tracer`, the jobs that start from 40 % of the
    window on, for max(2 s, 10 %) of it, run inside its capture (at
    least one job, where one starts after the 40 %)."""
    jobs: List[Job] = []
    t0 = time.time()
    lo, hi = 0.4 * seconds, 0.4 * seconds + max(2.0, 0.1 * seconds)
    tracing = False
    while time.time() - t0 < seconds:
        at = time.time() - t0
        if tracer is not None:
            if not tracing and tracer.t0 is None and at >= lo:
                tracer.start()
                tracing = True
            elif tracing and at >= hi and any(j.traced for j in jobs):
                tracer.stop()
                tracing = False
        clip = next(order)
        job = Job(first_index + len(jobs), clip,
                  f"out_{first_index + len(jobs)}", traced=tracing)
        jobs.append(run(job))
    if tracing:
        tracer.stop()
    return Window(jobs, t0, jobs[-1].t1 if jobs else time.time())
