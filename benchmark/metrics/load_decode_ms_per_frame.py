"""executor / loader: the profile's `load:decode` span seconds (the rows
unpickled and stacked into one host batch, inside each `load` span, or
inside `evaluate` where a state-carry miss reloads a task), summed over
the window's jobs, per frame those jobs completed, in ms."""

SPAN = "load:decode"


def read(rec):
    secs = sum(j.stats[SPAN]["total_s"] for j in rec.jobs if SPAN in j.stats)
    return 1e3 * secs / rec.frames if secs and rec.frames else None
