"""The program's own trace: spans and counters at its layer boundaries, on
``time.perf_counter_ns``.

A job -- one ``pipeline.compute_all_genes_psi`` or ``run_events`` call --
is traced exactly when it starts under a ``torch.profiler`` session
(``job``): the benchmark's traced window, or ``--profile DIR``, whose
``pipeline.profile_run`` profiles the whole call.  The decision is made
once, from the process-wide flag ``_is_profiler_enabled`` of
``torch.autograd.profiler`` (``torch.autograd._profiler_enabled()`` is
per thread, and the job's compile, materializer and writer threads are
not the profiler's), and the job's ``Tracer`` carries it to
``StreamRunner``, ``_CompileStream`` and the writer batches.  Off, a site
makes no record and costs one test of a flag; no site runs per event or
per read.

Records are kept in memory, those of the last ``KEEP_JOBS`` traced jobs,
and read back by time (``records``): by the benchmark's per-layer
readers, on the clock its profiler anchors the device trace to, and by
``profile_run``, which writes them into its Chrome trace
(``chrome_events``).

Spans (the thread's enclosing span is the parent; the records of one job
share its id, those of one chunk -- dispatch, materialize, write -- its
chunk id):

- ``job``: the whole call;
- ``compile`` (``_CompileStream.run``), with ``compile.load`` (a group's
  gene entries), ``compile.scan`` (a chromosome's BAM scan, on the
  prefetch threads), ``compile.scan_wait`` (waiting for that scan),
  ``compile.match`` (one native match-and-collapse call) and
  ``compile.fallback`` (a group's per-gene fallback);
- ``dispatch`` (attrs ``shape``, ``events`` real, ``lanes`` launched),
  with ``dispatch.pad``, ``dispatch.start`` (the linear start),
  ``dispatch.launch`` (the sampler calls and the device payload),
  ``wait_card`` (the copies to the card, which wait for the kernels
  queued before them) and ``queue_wait`` (a free slot in the
  materializer's queue);
- ``materialize``, with ``wait_card`` (the chunk's ready event) and
  ``materialize.copy`` (the copies to the host);
- ``write`` (attr ``submitted``: when the batch was handed to the pool);
- ``summary``: the summary file.

Counter ``launch`` (attrs ``route``: B1, B1w, B2, B2w, B3, or the plain
version's ``*.plain``; ``lanes``: the launch's event slots) after every
sampler launch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler

# traced jobs whose records are kept
KEEP_JOBS = 64


@dataclasses.dataclass
class Span:
    name: str
    t0: int                  # perf_counter_ns
    t1: int                  # 0 while open
    thread: int
    parent: Optional[int]    # id of the enclosing span on the thread
    job: int
    chunk: Optional[int]
    attrs: dict
    id: int


@dataclasses.dataclass
class Count:
    name: str
    t: int                   # perf_counter_ns
    thread: int
    job: int
    chunk: Optional[int]
    attrs: dict
    id: int


_records: List[object] = []
_lock = threading.Lock()
_ids = itertools.count()
_jobs = itertools.count()
_local = threading.local()       # .stack: the thread's open spans
_active = 0                      # traced jobs running in the process
_NULL = contextlib.nullcontext()


def profiling() -> bool:
    """Is a ``torch.profiler`` session running in the process?"""
    return bool(_autograd_profiler._is_profiler_enabled)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """One span, opened on entry and closed on exit, on the thread that
    enters it."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "Tracer", name: str, chunk, attrs: dict):
        self.tracer = tracer
        self.span = Span(name, 0, 0, 0, None, tracer.job, chunk, attrs,
                         next(_ids))

    def __enter__(self):
        self.span.thread = threading.get_ident()
        stack = _stack()
        top = stack[-1] if stack else None
        if top is not None:
            self.span.parent = top.span.id
            if self.span.chunk is None and top.span.job == self.span.job:
                self.span.chunk = top.span.chunk
        stack.append(self)
        self.span.t0 = time.perf_counter_ns()
        with _lock:
            _records.append(self.span)
        return self.span

    def __exit__(self, *exc):
        self.span.t1 = time.perf_counter_ns()
        _stack().pop()


class Tracer:
    """One job's tracer, on or off for the whole job.  Off, ``span``
    returns a shared empty context and ``count`` returns at once."""

    def __init__(self, on: bool):
        self.on = on
        self.job = next(_jobs) if on else None
        self._chunks = itertools.count()

    def span(self, name: str, chunk: Optional[int] = None, **attrs):
        """A span of this job; ``chunk`` defaults to the enclosing
        span's."""
        if not self.on:
            return _NULL
        return _Open(self, name, chunk, attrs)

    def count(self, name: str, chunk: Optional[int] = None, **attrs):
        """A counter record of this job at this instant."""
        if not self.on:
            return
        if chunk is None:
            top = _top()
            if top is not None and top.span.job == self.job:
                chunk = top.span.chunk
        rec = Count(name, time.perf_counter_ns(), threading.get_ident(),
                    self.job, chunk, attrs, next(_ids))
        with _lock:
            _records.append(rec)

    def next_chunk(self) -> Optional[int]:
        """A new chunk id of this job (None when off)."""
        return next(self._chunks) if self.on else None

    def chunk(self) -> Optional[int]:
        """The chunk of this thread's innermost open span of this job."""
        if not self.on:
            return None
        top = _top()
        return (top.span.chunk if top is not None
                and top.span.job == self.job else None)


OFF = Tracer(False)


def _top() -> Optional[_Open]:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def job():
    """The tracer of one job, on if a ``torch.profiler`` session is
    running as the job starts, with the job's ``job`` span open around
    the body."""
    global _active
    tracer = Tracer(profiling())
    if not tracer.on:
        yield tracer
        return
    with _lock:
        _active += 1
        first = tracer.job - KEEP_JOBS + 1
        if _records and _records[0].job < first:
            _records[:] = [r for r in _records if r.job >= first]
    try:
        with tracer.span("job"):
            yield tracer
    finally:
        with _lock:
            _active -= 1


def span(name: str, **attrs):
    """A span inside this thread's innermost open span, of its job and
    chunk: for sites below the layer that holds the job's tracer (the
    copies to the card, the sampler's launches).  Nothing where no traced
    job runs or this thread has no open span."""
    if not _active:
        return _NULL
    top = _top()
    if top is None:
        return _NULL
    return top.tracer.span(name, **attrs)


def count(name: str, **attrs) -> None:
    """A counter record inside this thread's innermost open span, as
    ``span``."""
    if not _active:
        return
    top = _top()
    if top is not None:
        top.tracer.count(name, **attrs)


# ------------------------------------------------------------ reading
def records(lo: int, hi: int) -> List[object]:
    """Every kept record inside [lo, hi] (perf_counter ns): the closed
    spans that start and end there, and the counters made there."""
    with _lock:
        recs = list(_records)
    return [r for r in recs
            if (lo <= r.t0 and 0 < r.t1 <= hi if isinstance(r, Span)
                else lo <= r.t <= hi)]


def chrome_events(recs: List[object], to_us) -> List[dict]:
    """The records as Chrome trace events of a process of their own
    (``miso_tpu_torch``), at ``to_us(t_ns)`` microseconds."""
    pid = "miso_tpu_torch"
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "miso_tpu_torch spans"}}]
    for r in recs:
        args = dict(r.attrs, job=r.job, chunk=r.chunk)
        if isinstance(r, Span):
            out.append({"ph": "X", "cat": "miso_tpu_torch", "name": r.name,
                        "pid": pid, "tid": r.thread, "ts": to_us(r.t0),
                        "dur": (r.t1 - r.t0) / 1e3, "args": args})
        else:
            out.append({"ph": "i", "s": "t", "cat": "miso_tpu_torch",
                        "name": r.name, "pid": pid, "tid": r.thread,
                        "ts": to_us(r.t), "args": args})
    return out


def bucket_table(recs: List[object]) -> Dict[tuple, dict]:
    """Per bucket shape (pad_iso, pad_classes, pad_reads): its chunks,
    real events, launched lanes, the seconds its chunks waited in the
    materializer's queue (from the dispatch's put to the materializer's
    start) and the seconds they ran (dispatch less its queue wait, plus
    materialize)."""
    spans = [r for r in recs if isinstance(r, Span)]
    mat = {(s.job, s.chunk): s for s in spans if s.name == "materialize"}
    put = {s.parent: s for s in spans if s.name == "queue_wait"}
    table: Dict[tuple, dict] = {}
    for d in spans:
        if d.name != "dispatch":
            continue
        row = table.setdefault(tuple(d.attrs["shape"]), {
            "chunks": 0, "events": 0, "lanes": 0, "queued_s": 0.0,
            "run_s": 0.0})
        row["chunks"] += 1
        row["events"] += d.attrs["events"]
        row["lanes"] += d.attrs["lanes"]
        q, m = put.get(d.id), mat.get((d.job, d.chunk))
        run = d.t1 - d.t0 - (q.t1 - q.t0 if q is not None else 0)
        if m is not None:
            run += m.t1 - m.t0
            if q is not None:
                row["queued_s"] += max(m.t0 - q.t0, 0) / 1e9
        row["run_s"] += run / 1e9
    return table
