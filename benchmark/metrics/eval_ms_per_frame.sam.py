"""evaluator layer: the profile's `evaluate:SamEmbed` span seconds (the
op's calls: their dispatch and the waits the launch queue forces),
summed over the window's jobs, per frame those jobs completed, in ms;
nothing where no job recorded the span."""

SPAN = "evaluate:SamEmbed"


def read(rec):
    secs = sum(j.stats[SPAN]["total_s"] for j in rec.jobs if SPAN in j.stats)
    return 1e3 * secs / rec.frames if secs and rec.frames else None
