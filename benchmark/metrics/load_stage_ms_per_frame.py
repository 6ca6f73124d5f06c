"""staging: the profile's `load:stage` span seconds (the pinned copy
and the asynchronous host-to-device dispatch, inside each `load` span,
or inside `evaluate` where a state-carry miss reloads a task), summed
over the window's jobs, per frame those jobs completed, in ms."""

SPAN = "load:stage"


def read(rec):
    secs = sum(j.stats[SPAN]["total_s"] for j in rec.jobs if SPAN in j.stats)
    return 1e3 * secs / rec.frames if secs and rec.frames else None
