"""executor: save / storage layer: the profile's `save:fetch` (a task's
output columns brought to the host) and `save:write` (their rows
serialised and written to storage) span seconds, summed over the
window's jobs, per frame those jobs completed, in ms; nothing where no
job recorded either span."""

SPANS = ("save:fetch", "save:write")


def read(rec):
    secs = sum(j.stats[s]["total_s"] for j in rec.jobs for s in SPANS
               if s in j.stats)
    return 1e3 * secs / rec.frames if secs and rec.frames else None
