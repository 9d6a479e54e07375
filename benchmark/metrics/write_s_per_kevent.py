"""Copy-back and writer seconds per 1,000 events: the harness's spans
around ``StreamRunner._materialize_chunk`` less its waits for the card
(``torch.cuda.Event.synchronize``), the writers' batches
(``_write_events_batch`` / ``_pack_events_batch``, busy time summed over
the pool's threads) and ``write_summary_file``.  Read only in cells that
write ``.miso`` files."""


def read(trace):
    if not trace.events or not trace.writes_miso:
        return None
    r = trace.recorder
    busy = (r.self_seconds("materialize", minus=("device_wait",))
            + r.self_seconds("write") + r.self_seconds("summary"))
    return busy / (trace.events / 1e3)
