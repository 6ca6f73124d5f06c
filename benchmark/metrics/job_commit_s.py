"""storage, the table commit: per job, the seconds of the program's
`job.commit` phase (from the pipeline's return until the executor's:
the output tables committed, the megafile written), the median over the
window's jobs."""

import statistics

PHASE = "job.commit"


def read(rec):
    secs = [j.stats[PHASE]["total_s"] for j in rec.jobs if PHASE in j.stats]
    return statistics.median(secs) if secs else None
