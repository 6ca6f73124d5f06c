"""model network: the share of the card's dense bf16 peak that the SAM
ViT-H encoder reaches over the device time of the traced slice: the
traced jobs' frames x the encoder's FLOPs a frame
(harness/sam_flops.py, from the configuration's shapes), over the peak
times the device time of every kernel in the trace (copies and memsets
left out), so the reading follows whatever implements the network.
That time holds the prep's kernels and the evaluator's ladder warm-up,
which runs the encoder on 12 synthesized frames a job (batches 4 and 8)
that are not among the jobs' frames, so the share reads low by about
that much.  In %; nothing for a card with no listed peak or a trace
with no kernel."""

from benchmark.harness import sam_flops

NOT_KERNELS = ("Memcpy", "Memset")


def read(rec):
    peak = sam_flops.peak(rec.device_kind)
    if peak is None or rec.trace is None:
        return None
    secs = sum(e - s for s, e, name in rec.trace.events
               if not name.startswith(NOT_KERNELS))
    frames = sum(j.frames for j in rec.traced_jobs)
    if secs <= 0 or not frames:
        return None
    flops = frames * sam_flops.config_flops(rec.config)[0]
    return 100.0 * flops / (peak * secs)
