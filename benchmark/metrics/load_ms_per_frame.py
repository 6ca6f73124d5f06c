"""executor / loader layer: the profile's `load` stage seconds, summed
over the window's jobs, per frame those jobs completed, in ms."""


def read(rec):
    secs = sum(j.stats["load"]["total_s"] for j in rec.jobs
               if "load" in j.stats)
    return 1e3 * secs / rec.frames if secs and rec.frames else None
