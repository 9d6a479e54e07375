"""The roofline count is a function of the events alone: however the
program buckets and routes them, a launch's least time is the same."""
import pytest

import roofline

STOCK = {"num_iters": 5000, "burn_in": 500, "lag": 10, "num_chains": 6}


def test_one_event_by_hand():
    got = roofline.launch([(2, 3, 3)], STOCK)
    ops = 6 * 5000 * (4 * 3 * 2 + 20 * 2)
    S = 450 * 6
    nbytes = 4 * ((2 * 3 * 2 + 3 + 4) + S * 3 + 6 * 2 + 12)
    assert (got["ops"], got["bytes"]) == (ops, nbytes)
    assert got["seconds"] == max(ops / 67e12, nbytes / 3.35e12)


@pytest.mark.parametrize("split", [1, 2, 7])
def test_the_same_events_count_alike_whatever_the_route(split):
    # one bucket's events: shallow (B1), wide (B1w) and deep (B3) alike
    events = [(2, 3, 3), (300, 120, 180), (2, 3, 4), (64, 40, 41),
              (6, 9, 12), (128, 64, 64), (3, 5, 7)]
    whole = roofline.launch(events, STOCK)
    parts = [roofline.launch(events[i::split], STOCK)
             for i in range(split)]
    for k in ("ops", "bytes"):
        assert sum(p[k] for p in parts) == whole[k]


def test_a_deep_event_counts_as_its_classes():
    """320 reads or 32,768 in the same three classes (B1 or B3): one
    count; a class without reads adds bytes, not operations."""
    import types

    import numpy as np

    def ev(counts):
        return types.SimpleNamespace(num_iso=2, num_classes=len(counts),
                                     counts=np.asarray(counts, float))

    shallow = roofline.launch([roofline.event_stats(ev([100, 120, 100]))],
                              STOCK)
    deep = roofline.launch([roofline.event_stats(ev([10240, 12288,
                                                     10240]))], STOCK)
    assert shallow == deep
    empty = roofline.launch([roofline.event_stats(ev([100, 0, 100]))],
                            STOCK)
    assert empty["ops"] < shallow["ops"]
    assert empty["bytes"] == shallow["bytes"]
