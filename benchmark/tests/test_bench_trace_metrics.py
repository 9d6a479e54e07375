"""The five readers of the program's own trace (``miso_tpu_torch.trace``)
on hand-made records and device operations on one clock: the copies to
the card taken out of the dispatch's waits, the median over jobs, and
nothing where tracing was off or the program keeps no trace."""
import importlib
import sys

import pytest

import spans
from miso_tpu_torch import trace as program

S = 10 ** 9                            # ns a second
READERS = ["dispatch_card_wait_s_per_kevent", "dispatch_host_s_per_kevent",
           "first_launch_s", "events_per_launch", "write_queue_s_per_kevent"]
H2D = "Memcpy HtoD (Pageable -> Device)"


def reader(name):
    return importlib.import_module("metrics." + name).read


class Records:
    """Hand-made program records, ids in order of making."""

    def __init__(self):
        self.recs = []

    def span(self, name, t0, t1, job, parent=None, chunk=None, **attrs):
        s = program.Span(name, int(t0 * S), int(t1 * S), 1,
                         None if parent is None else parent.id, job, chunk,
                         attrs, len(self.recs))
        self.recs.append(s)
        return s

    def launch(self, t, job, route="B1"):
        self.recs.append(program.Count("launch", int(t * S), 1, job, None,
                                       {"route": route, "lanes": 512},
                                       len(self.recs)))


def window(recs, device_ops=(), events=2000, writes_miso=True,
           lo=0.0, hi=300.0):
    return spans.Trace(spans.Recorder(), list(device_ops), [],
                       (int(lo * S), int(hi * S)), events, writes_miso)


@pytest.fixture
def three_jobs(monkeypatch):
    """Three jobs of a window [0, 300] s; job 0 dispatches one chunk and
    writes it."""
    r = Records()
    j0 = r.span("job", 0, 90, 0)
    d = r.span("dispatch", 10, 20, 0, j0, chunk=0, shape=(2, 4, 320),
               events=1500, lanes=2048)
    launch = r.span("dispatch.launch", 11, 19, 0, d)
    r.span("wait_card", 12, 15, 0, launch, shard=0)
    r.span("queue_wait", 19.5, 20, 0, d)
    m = r.span("materialize", 30, 32, 0, chunk=0)
    r.span("wait_card", 30, 31, 0, m)             # not the dispatch's
    r.span("write", 33, 34, 0, chunk=0, submitted=int(32.5 * S))
    r.span("write", 34, 36, 0, chunk=0, submitted=int(32.6 * S))
    r.launch(20, 0)
    r.span("job", 100, 190, 1)
    r.span("dispatch", 120, 121, 1, events=500, lanes=512)
    r.launch(130, 1)
    r.launch(125, 1, route="B3")
    r.span("job", 200, 290, 2)
    r.launch(203, 2)
    r.span("job", 400, 410, 3)                    # past the window
    r.launch(401, 3)
    monkeypatch.setattr(program, "_records", r.recs)
    return r.recs


def test_card_wait_leaves_out_the_copies_device_time(three_jobs):
    ops = [(H2D, int(14 * S), int(14.5 * S)),       # inside: 0.5 s
           (H2D, int(14.8 * S), int(15.2 * S)),     # 0.2 s inside
           ("void reassign_kernel<2>(...)", int(15 * S), int(18 * S)),
           (H2D, int(30.2 * S), int(30.4 * S))]     # the materializer's
    got = reader("dispatch_card_wait_s_per_kevent")(window(three_jobs, ops))
    assert got == pytest.approx((3 - 0.5 - 0.2) / 2)


def test_host_time_is_the_dispatch_less_its_waits(three_jobs):
    got = reader("dispatch_host_s_per_kevent")(window(three_jobs))
    assert got == pytest.approx((10 - 3 - 0.5 + 1) / 2)


def test_first_launch_is_the_median_over_the_windows_jobs(three_jobs):
    # jobs 0, 1, 2: 20, 25 and 3 s; job 3 lies past the window
    assert reader("first_launch_s")(window(three_jobs)) == pytest.approx(20)


def test_events_per_launch_counts_real_events(three_jobs):
    assert reader("events_per_launch")(window(three_jobs)) == pytest.approx(
        2000 / 4)


def test_write_queue_is_each_batch_start_less_its_submit(three_jobs):
    got = reader("write_queue_s_per_kevent")(window(three_jobs))
    assert got == pytest.approx((0.5 + 1.4) / 2)
    assert reader("write_queue_s_per_kevent")(
        window(three_jobs, writes_miso=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_where_tracing_was_off(name, monkeypatch):
    monkeypatch.setattr(program, "_records", [])
    ops = [(H2D, 0, S), ("void reassign_kernel<2>(...)", S, 2 * S)]
    assert reader(name)(window([], ops)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_where_the_program_keeps_no_trace(name, three_jobs,
                                                  monkeypatch):
    # a parent commit's program: no miso_tpu_torch.trace to import
    monkeypatch.setitem(sys.modules, "miso_tpu_torch.trace", None)
    monkeypatch.delattr(sys.modules["miso_tpu_torch"], "trace")
    assert reader(name)(window(three_jobs)) is None
