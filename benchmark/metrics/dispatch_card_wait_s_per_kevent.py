"""The dispatch's waits on the card, seconds per 1,000 events: the
program's own ``wait_card`` spans under its ``dispatch`` spans
(``miso_tpu_torch.trace``: the copies to the card, which return only when
the kernels queued before them have run), each less the device time of
the host-to-device copies that ran inside it.  Nothing where the program
keeps no trace of its own or made no record in the window."""


def under(span, name, by_id):
    """Is a span called ``name`` among ``span``'s ancestors?"""
    while span.parent is not None:
        span = by_id.get(span.parent)
        if span is None:
            return False
        if span.name == name:
            return True
    return False


def read(trace):
    try:
        from miso_tpu_torch import trace as program
    except ImportError:
        return None
    if not trace.events:
        return None
    spans = [r for r in program.records(*trace.window)
             if isinstance(r, program.Span)]
    by_id = {s.id: s for s in spans}
    waits = [s for s in spans
             if s.name == "wait_card" and under(s, "dispatch", by_id)]
    if not waits:
        return None
    h2d = [(a, b) for name, a, b in trace.device_ops if "HtoD" in name]
    ns = 0
    for s in waits:
        copies = sum(max(0, min(b, s.t1) - max(a, s.t0)) for a, b in h2d)
        ns += s.t1 - s.t0 - copies
    return ns / 1e9 / (trace.events / 1e3)
