"""Host compile seconds per 1,000 events: the harness's spans around
``_host._CompileStream.run`` (catalog walk, BAM scan, native match and
collapse, per-gene fallback), summed over the traced window's jobs."""


def read(trace):
    if not trace.events:
        return None
    return trace.recorder.self_seconds("compile") / (trace.events / 1e3)
