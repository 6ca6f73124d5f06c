"""kernel: attention: the share of its roofline that SAM's attention
kernels reach: the traced jobs' frames x the attention's FLOPs a frame
(q k^T and p v, harness/sam_flops.py), over the dense bf16 peak times
the device time of the kernels whose names hold one of KERNELS, case
aside: PyTorch's memory-efficient attention (`fmha_cutlassF_*`),
cuDNN's and FlashAttention's (`*flash*`), and a hand-written kernel
named with `attn`.  The operations bound it: the bytes the algorithm
needs (q, k, v, the decomposed terms and the output) take a fraction of
the time its products do, so the bias a kernel reads in full counts
against it.  The evaluator's ladder warm-up (12 synthesized frames a
job) runs these kernels too, so the share reads low by about that
much.  In %; nothing for a card with no listed peak or a trace with no
such kernel."""

from benchmark.harness import sam_flops

KERNELS = ("fmha", "flash", "attn")


def read(rec):
    peak = sam_flops.peak(rec.device_kind)
    if peak is None or rec.trace is None:
        return None
    secs = sum(e - s for s, e, name in rec.trace.events
               if any(k in name.lower() for k in KERNELS))
    frames = sum(j.frames for j in rec.traced_jobs)
    if secs <= 0 or not frames:
        return None
    flops = frames * sam_flops.config_flops(rec.config)[1]
    return 100.0 * flops / (peak * secs)
