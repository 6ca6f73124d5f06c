"""model network: the profile's `sam:net` span seconds (the ViT-H
encoder's dispatch inside `evaluate:SamEmbed`, and the waits the launch
queue forces), summed over the window's jobs, per frame those jobs
completed, in ms; nothing where no job recorded the span."""

SPAN = "sam:net"


def read(rec):
    secs = sum(j.stats[SPAN]["total_s"] for j in rec.jobs if SPAN in j.stats)
    return 1e3 * secs / rec.frames if secs and rec.frames else None
