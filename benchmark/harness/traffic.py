"""The general traffic generator: a closed loop of jobs over the stored
table, read from a traffic mix's data file (`traffic/<name>.json`).

Keys of a mix:
  loop               "closed": one client sends its next job when the
                     last has returned
  clients            1
  frames_per_job     rows of the stored table a job reads: the table is
                     cut into floor(frames / frames_per_job) clips, each
                     a contiguous `Range`; a job over the whole table
                     reads it without a sampler
  work_packet_size,  the job's PerfParams.manual(work, io)
  io_packet_size
  run                optional: further keyword arguments of every
                     job's `Client.run`
  generator          optional: the name of a module `traffic/<name>.py`
                     that takes this one's place; it has `clips` and
                     `job_order` as below, and may have `loop`, which
                     sends the jobs as `window.closed_loop` does here
Every seed sends the same clips; the seed draws only their order, a new
permutation each time the loop has sent every clip once.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

Clip = Tuple[int, int]


def clips(traffic: Dict, table_frames: int) -> List[Clip]:
    """The distinct [start, end) row ranges a mix's jobs read."""
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError(f"unsupported traffic {traffic}: only a closed "
                         f"loop of one client is generated")
    n = int(traffic["frames_per_job"])
    if not 1 <= n <= table_frames:
        raise ValueError(f"frames_per_job {n} outside 1..{table_frames}")
    return [(k * n, (k + 1) * n) for k in range(table_frames // n)]


def job_order(traffic: Dict, table_frames: int,
              seed: int) -> Iterator[Clip]:
    """The clips in the order the loop sends them, without end."""
    cs = clips(traffic, table_frames)
    rng = np.random.default_rng(int(seed))
    while True:
        for k in rng.permutation(len(cs)):
            yield cs[int(k)]
