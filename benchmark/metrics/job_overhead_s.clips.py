"""client layer: per job, the benchmark's clock around Client.run less
the envelope of the job's stage spans (earliest start to latest end of
its profile's intervals; both clocks are time.time()), the median over
the window's jobs.  Set-up before the first stage and teardown after
the last: the part of a small job that is not its work."""

import statistics


def read(rec):
    over = [j.wall - (e - s) for j in rec.jobs
            for s, e in [j.envelope() or (None, None)] if s is not None]
    return statistics.median(over) if over else None
