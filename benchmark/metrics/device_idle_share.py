"""device layer: the share of the traced slice's wall time in which no
kernel, copy or memset ran on the card (torch.profiler), in %."""


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
