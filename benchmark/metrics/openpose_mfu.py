"""model network: the share of the card's dense bf16 peak that the
OpenPose network reaches while its kernels run: the traced jobs'
frames x the network's FLOPs a frame (harness/openpose_flops.py, from
the configuration's shapes; post-processing not counted), over the peak
times the device time of the network's events in the trace.  Those are
found by name: cuDNN's convolutions (its CUTLASS and sm90 implicit-GEMM
kernels name the forward convolution `fprop`) and the bias adds, ReLUs
and pools around them, whose names carry `BFloat16` (prep and post
run in float32).  On an H100 with torch 2.11 they
are 95 % of the network's device time: the GEMMs cuDNN runs some 1x1
convolutions as, the input's padding and the concatenations are left
out, so the share reads up to a twentieth of itself high.  In %;
nothing for a card with no listed peak or a trace with no such
kernel."""

from benchmark.harness import openpose_flops

KERNELS = ("fprop", "BFloat16")


def read(rec):
    peak = openpose_flops.peak(rec.device_kind)
    if peak is None or rec.trace is None:
        return None
    secs = sum(e - s for s, e, name in rec.trace.events
               if any(k in name for k in KERNELS))
    frames = sum(j.frames for j in rec.traced_jobs)
    if secs <= 0 or not frames:
        return None
    flops = frames * openpose_flops.config_flops_per_frame(rec.config)
    return 100.0 * flops / (peak * secs)
