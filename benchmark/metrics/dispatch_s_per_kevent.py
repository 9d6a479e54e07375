"""Dispatch seconds per 1,000 events: the harness's spans around
``pipeline.StreamRunner._dispatch`` (``pad_events``, the linear start,
the copies to the card and the launch), less their waits for a free slot
in the materializer's queue (``StreamRunner._put``)."""


def read(trace):
    if not trace.events:
        return None
    return trace.recorder.self_seconds(
        "dispatch", minus=("queue_wait",)) / (trace.events / 1e3)
