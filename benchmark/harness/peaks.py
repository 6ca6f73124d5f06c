"""Published peaks of the devices a run may report, by the name that
`torch.cuda.get_device_name()` gives.  NVIDIA H100 SXM data sheet, dense
rates without sparsity, at the full 700 W power limit; a card set below
it reads a lower share against the same peak."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(kind: str, what: str):
    """A device's published peak, or None for a device not listed."""
    return PEAKS.get(kind, {}).get(what)
