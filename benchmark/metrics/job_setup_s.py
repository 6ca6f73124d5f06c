"""client / executor set-up: per job, the seconds of the program's
`job.setup` phase (from the entry of Client.run until the pipeline's
stage threads start), the median over the window's jobs."""

import statistics

PHASE = "job.setup"


def read(rec):
    secs = [j.stats[PHASE]["total_s"] for j in rec.jobs if PHASE in j.stats]
    return statistics.median(secs) if secs else None
