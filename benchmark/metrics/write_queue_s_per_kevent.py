"""Seconds the writers' batches waited for a free thread of the pool,
per 1,000 events: over the program's own ``write`` spans
(``miso_tpu_torch.trace``), each one's start less the time its batch was
handed to the pool.  Read only in cells that write ``.miso`` files.
Nothing where the program keeps no trace of its own or made no record in
the window."""


def read(trace):
    try:
        from miso_tpu_torch import trace as program
    except ImportError:
        return None
    if not trace.events or not trace.writes_miso:
        return None
    writes = [r for r in program.records(*trace.window)
              if isinstance(r, program.Span) and r.name == "write"]
    if not writes:
        return None
    ns = sum(w.t0 - w.attrs["submitted"] for w in writes)
    return ns / 1e9 / (trace.events / 1e3)
