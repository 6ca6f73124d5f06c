"""evaluator layer: the profile's `evaluate:Histogram` span seconds, summed
over the window's jobs, per frame those jobs completed, in ms."""

SPAN = "evaluate:Histogram"


def read(rec):
    secs = sum(j.stats[SPAN]["total_s"] for j in rec.jobs if SPAN in j.stats)
    return 1e3 * secs / rec.frames if secs and rec.frames else None
