"""kernel layer: the histogram kernel's share of its bound over the
traced slice.  The bound is the bytes the traced jobs' frames need
(each frame read once, its counts written once: harness/counts.py) at
the card's HBM peak; the time is the device time of the histogram
kernel's events in the trace, found by the kernel's names in the
program's CUDA source (csrc/histogram.cu).  In %; nothing where the
trace holds no such kernel."""

from benchmark.harness import counts, peaks

KERNELS = ("hist_u8_private", "hist_general")


def read(rec):
    bw = peaks.peak(rec.device_kind, "hbm_bytes_per_s")
    if rec.trace is None or bw is None:
        return None
    secs = sum(e - s for s, e, name in rec.trace.events
               if any(k in name for k in KERNELS))
    frames = sum(j.frames for j in rec.traced_jobs)
    if secs <= 0 or not frames:
        return None
    fr = rec.config["frames"]
    need = frames * counts.histogram_bytes_per_frame(
        fr["height"], fr["width"], fr["channels"], rec.config["bins"])
    return 100.0 * need / bw / secs
