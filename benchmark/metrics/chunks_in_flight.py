"""Chunks in flight on the card as a sampler launch is issued: the mean
``in_flight`` of the program's own ``launch`` counters
(``miso_tpu_torch.trace``), the launch's own chunk included, so 1 means
launches that run one after another.  Nothing where the program keeps no
trace of its own, made no record in the window, or its launches carry
no ``in_flight``."""


def read(trace):
    try:
        from miso_tpu_torch import trace as program
    except ImportError:
        return None
    counts = [r.attrs["in_flight"] for r in program.records(*trace.window)
              if isinstance(r, program.Count) and r.name == "launch"
              and "in_flight" in r.attrs]
    if not counts:
        return None
    return sum(counts) / len(counts)
