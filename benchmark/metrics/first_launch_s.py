"""Seconds from a job's start to its first sampler launch: per job of the
window, the first ``launch`` counter of the program's own trace
(``miso_tpu_torch.trace``) less the start of its ``job`` span; the median
over the window's jobs.  The card idles through it unless an earlier job
still runs.  Nothing where the program keeps no trace of its own or made
no record in the window."""
import statistics


def read(trace):
    try:
        from miso_tpu_torch import trace as program
    except ImportError:
        return None
    recs = program.records(*trace.window)
    first = {}
    for r in recs:
        if isinstance(r, program.Count) and r.name == "launch":
            first[r.job] = min(first.get(r.job, r.t), r.t)
    gaps = [first[r.job] - r.t0 for r in recs
            if isinstance(r, program.Span) and r.name == "job"
            and r.job in first]
    if not gaps:
        return None
    return statistics.median(gaps) / 1e9
