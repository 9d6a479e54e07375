"""The port's own trace (miso_tpu_torch/trace.py), on the CPU: a job is
traced exactly when it starts under ``torch.profiler``; its records nest
inside it, a chunk's dispatch, materialize and write share its id, the
dispatch records count the events run and every sampler launch leaves one
counter; ``--profile`` writes the records into its Chrome trace on the
clock of the torch ops."""
import json
import time

import pytest
from torch.profiler import ProfilerActivity, profile

import miso_tpu_torch._host as host
import miso_tpu_torch.pipeline as tp
from miso_tpu_torch import trace
from miso_tpu_torch.sampler import deep, marginal_kernel, reassign_kernel
from miso_tpu_torch.testing import cap_test_threads, indexed_catalog

cap_test_threads()

N_EVENTS = 24
# small chunks: the catalog's one bucket shape runs as several chunks
CFG = dict(read_len=36, iters=200, burn_in=50, lag=5, chains=2,
           max_batch_events=8)


def sampler_calls() -> int:
    return sum(sum(m.LAUNCHES.values())
               for m in (reassign_kernel, marginal_kernel, deep))


def run_job(fix, out_dir, verbose=False, **kw):
    """One ``compute_all_genes_psi`` call: (events written, sampler calls
    made, the records made meanwhile)."""
    t0, calls = time.perf_counter_ns(), sampler_calls()
    n = tp.compute_all_genes_psi(
        fix["index"], fix["bam"], 36, out_dir, cfg=host.RunConfig(**CFG),
        seed=5, verbose=verbose, device="cpu", **kw)
    return (n, sampler_calls() - calls,
            trace.records(t0, time.perf_counter_ns()))


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trace")
    return root, indexed_catalog(str(root / "cat"), num_events=N_EVENTS,
                                 reads_per_event=200, read_len=36, seed=4)


@pytest.fixture(scope="module")
def traced(catalog):
    root, fix = catalog
    with profile(activities=[ProfilerActivity.CPU]):
        return run_job(fix, str(root / "traced"))


def spans(recs, name=None):
    return [r for r in recs if isinstance(r, trace.Span)
            and (name is None or r.name == name)]


def test_a_run_outside_a_profiler_records_nothing(catalog):
    root, fix = catalog
    n, calls, recs = run_job(fix, str(root / "plain"))
    assert n == N_EVENTS and calls > 0
    assert recs == []


def test_a_profiled_run_records_every_layer_inside_its_job(traced):
    n, _, recs = traced
    assert n == N_EVENTS
    names = {r.name for r in recs}
    assert {"job", "compile", "compile.load", "dispatch", "dispatch.pad",
            "dispatch.launch", "wait_card", "queue_wait", "launch",
            "materialize", "materialize.copy", "write",
            "summary"} <= names
    assert names & {"compile.match", "compile.fallback"}
    (job,) = spans(recs, "job")
    for r in recs:
        assert r.job == job.job
        if isinstance(r, trace.Span):
            assert job.t0 <= r.t0 <= r.t1 <= job.t1, r
        else:
            assert job.t0 <= r.t <= job.t1, r
    by_id = {s.id: s for s in spans(recs)}
    for s in spans(recs):
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.thread == s.thread and p.t0 <= s.t0 <= s.t1 <= p.t1
    # the copies to the card lie under the dispatch, the ready events'
    # waits under the materializer
    under = set()
    for w in spans(recs, "wait_card"):
        p = w
        while p.name not in ("dispatch", "materialize"):
            p = by_id[p.parent]
        under.add(p.name)
    assert under == {"dispatch", "materialize"}


def test_a_chunks_dispatch_materialize_and_write_share_its_id(traced):
    _, _, recs = traced
    dispatched = [s.chunk for s in spans(recs, "dispatch")]
    assert len(dispatched) == len(set(dispatched)) > 1
    assert sorted(s.chunk for s in spans(recs, "materialize")) == sorted(
        dispatched)
    written = {s.chunk for s in spans(recs, "write")}
    assert written == set(dispatched)
    for w in spans(recs, "write"):
        assert w.attrs["submitted"] <= w.t0


def test_dispatch_records_count_the_events_and_launches_the_calls(traced):
    n, calls, recs = traced
    disp = spans(recs, "dispatch")
    assert sum(d.attrs["events"] for d in disp) == n
    launches = [r for r in recs if isinstance(r, trace.Count)
                and r.name == "launch"]
    assert len(launches) == calls == len(disp)
    assert all(r.attrs["route"] == "B1.plain" for r in launches)
    # one launch per chunk here: its lanes are the dispatch's
    lanes = {r.chunk: r.attrs["lanes"] for r in launches}
    assert lanes == {d.chunk: d.attrs["lanes"] for d in disp}
    for d in disp:
        assert d.attrs["events"] <= d.attrs["lanes"] < 2 * d.attrs["events"]


def test_profile_trace_holds_the_program_spans_on_the_ops_clock(
        catalog, capsys):
    root, fix = catalog
    prof_dir = root / "profile"
    n, _, recs = run_job(fix, str(root / "profiled"), verbose=True,
                         profile_dir=str(prof_dir))
    assert n == N_EVENTS and spans(recs, "job")
    with open(prof_dir / "miso_torch_trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("pid") == "miso_tpu_torch"
            and e.get("ph") == "X"]
    assert {"job", "compile", "dispatch", "materialize",
            "write"} <= {e["name"] for e in mine}
    copies = [e for e in events if e.get("cat") == "cpu_op"
              and e["name"] in ("aten::to", "aten::copy_")]
    dispatch = [e for e in mine if e["name"] == "dispatch"]
    assert copies and dispatch
    for d in dispatch:
        assert [c for c in copies if d["ts"] <= c["ts"]
                and c["ts"] + c["dur"] <= d["ts"] + d["dur"]], d
    out = capsys.readouterr().out
    assert "bucket (iso=2" in out


def test_records_from_many_threads_are_all_kept():
    """Spans and counters made at once on more threads than cores, with
    the interpreter switching threads as often as it can: none lost, each
    span's parent on its own thread."""
    import sys
    import threading

    n_threads, n_each = 16, 200

    def work(tracer):
        for _ in range(n_each):
            with tracer.span("w"):
                tracer.count("c")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter_ns()
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.job() as tracer:
                threads = [threading.Thread(target=work, args=(tracer,))
                           for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
        recs = trace.records(t0, time.perf_counter_ns())
    finally:
        sys.setswitchinterval(switch)
    (job,) = spans(recs, "job")
    work_spans = spans(recs, "w")
    assert len(work_spans) == n_threads * n_each
    assert sum(isinstance(r, trace.Count) for r in recs) == (
        n_threads * n_each)
    assert len({r.id for r in recs}) == len(recs)
    assert all(s.parent is None and s.job == job.job for s in work_spans)


def test_only_the_last_jobs_records_are_kept(monkeypatch):
    monkeypatch.setattr(trace, "KEEP_JOBS", 2)
    t0 = time.perf_counter_ns()
    jobs = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with trace.job() as tracer:
                jobs.append(tracer.job)
    kept = {r.job for r in trace.records(t0, time.perf_counter_ns())}
    assert kept == set(jobs[1:])
