"""model network: the profile's `openpose:net` span seconds (the
network's dispatch inside `evaluate:OpenPose`, and the waits the launch
queue forces), summed over the window's jobs, per frame those jobs
completed, in ms; nothing where no job recorded the span."""

SPAN = "openpose:net"


def read(rec):
    secs = sum(j.stats[SPAN]["total_s"] for j in rec.jobs if SPAN in j.stats)
    return 1e3 * secs / rec.frames if secs and rec.frames else None
