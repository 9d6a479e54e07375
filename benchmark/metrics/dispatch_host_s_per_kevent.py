"""The dispatch's host work, seconds per 1,000 events: the program's own
``dispatch`` spans (``miso_tpu_torch.trace``) less the ``wait_card`` and
``queue_wait`` spans under them (the waits on the card and for a free
slot in the materializer's queue).  Nothing where the program keeps no
trace of its own or made no record in the window."""


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
    dispatch = [s for s in spans if s.name == "dispatch"]
    if not dispatch:
        return None
    ns = sum(s.t1 - s.t0 for s in dispatch)
    for s in spans:
        if s.name not in ("wait_card", "queue_wait"):
            continue
        p = s
        while p is not None and p.name != "dispatch":
            p = by_id.get(p.parent) if p.parent is not None else None
        if p is not None:
            ns -= s.t1 - s.t0
    return ns / 1e9 / (trace.events / 1e3)
