"""The reader of the chunks in flight at each launch
(``metrics/chunks_in_flight.py``) on hand-made program records: the mean
over the window's launches, and nothing where the launches carry no
``in_flight`` (a parent commit's program), tracing was off or the program
keeps no trace."""
import sys

import pytest

import spans
from metrics import chunks_in_flight
from miso_tpu_torch import trace as program

S = 10 ** 9                            # ns a second


def window(lo=0.0, hi=300.0):
    return spans.Trace(spans.Recorder(), [], [], (int(lo * S), int(hi * S)),
                       2000, True)


def launch(i, t, **attrs):
    return program.Count("launch", int(t * S), 1, 0, None,
                         dict({"route": "B1", "lanes": 16}, **attrs), i)


@pytest.fixture
def launches(monkeypatch):
    recs = [launch(0, 10, in_flight=1), launch(1, 11, in_flight=4),
            launch(2, 12, in_flight=16), launch(3, 13, in_flight=3),
            launch(4, 400, in_flight=100)]      # past the window
    monkeypatch.setattr(program, "_records", recs)
    return recs


def test_the_mean_over_the_windows_launches(launches):
    assert chunks_in_flight.read(window()) == pytest.approx(24 / 4)


@pytest.mark.parametrize("case", ["no_attribute", "tracing_off",
                                  "no_trace"])
def test_nothing_to_read(case, launches, monkeypatch):
    if case == "no_attribute":
        monkeypatch.setattr(program, "_records",
                            [launch(0, 10), launch(1, 11)])
    elif case == "tracing_off":
        monkeypatch.setattr(program, "_records", [])
    else:
        monkeypatch.setitem(sys.modules, "miso_tpu_torch.trace", None)
        monkeypatch.delattr(sys.modules["miso_tpu_torch"], "trace")
    assert chunks_in_flight.read(window()) is None
