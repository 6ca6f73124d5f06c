"""executor, the pipeline's teardown: per job, the seconds of the
program's `pipeline.drain` phase (from the last task's save until every
stage thread has ended), the median over the window's jobs."""

import statistics

PHASE = "pipeline.drain"


def read(rec):
    secs = [j.stats[PHASE]["total_s"] for j in rec.jobs if PHASE in j.stats]
    return statistics.median(secs) if secs else None
