"""The share of the traced window in which no kernel, copy or memset ran
on the card (``torch.profiler``'s device timeline), in percent."""

from spans import busy_intervals


def read(trace):
    lo, hi = trace.window
    if hi <= lo or not trace.device_ops:
        return None
    busy = sum(b - a for a, b in busy_intervals(trace.device_ops, lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo))
