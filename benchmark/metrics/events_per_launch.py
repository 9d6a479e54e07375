"""Real events per sampler launch: the events of the program's own
``dispatch`` spans (``miso_tpu_torch.trace``; their padding left out)
over its ``launch`` counters, one a launch of B1, B1w, B2, B2w or B3.  A
launch runs its whole chain whatever its lanes, so few events a launch
means the card runs chains for padding or half-empty buckets.  Nothing
where the program keeps no trace of its own or made no record in the
window."""


def read(trace):
    try:
        from miso_tpu_torch import trace as program
    except ImportError:
        return None
    recs = program.records(*trace.window)
    launches = sum(1 for r in recs
                   if isinstance(r, program.Count) and r.name == "launch")
    events = sum(r.attrs["events"] for r in recs
                 if isinstance(r, program.Span) and r.name == "dispatch")
    if not launches:
        return None
    return events / launches
