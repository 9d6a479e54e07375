"""The traced run: host spans recorded from the benchmark's own wrappers
around named calls of the program, and the device's timeline from
``torch.profiler``, on one clock.

Spans (name: the call wrapped):

- ``compile``: ``_host._CompileStream.run`` (the host compile thread);
- ``dispatch``: ``pipeline.StreamRunner._dispatch``, with its child
  ``queue_wait``: ``StreamRunner._put`` (waiting for a free slot in the
  materializer's queue);
- ``materialize``: ``StreamRunner._materialize_chunk``, with its child
  ``device_wait``: ``torch.cuda.Event.synchronize`` (waiting for the
  chunk's kernels);
- ``write``: ``pipeline._write_events_batch`` and ``_pack_events_batch``
  (the writers' pool);
- ``summary``: ``io.miso_file.write_summary_file``;
- ``job``: one ``compute_all_genes_psi`` call (recorded by the harness).

The dispatch wrapper also records, from the chunk's host events, what the
roofline count needs (``roofline.launch``).  Nothing is wrapped in an
untraced run.
"""
from __future__ import annotations

import dataclasses
import functools
import glob
import os
import re
import threading
import time
from typing import Dict, List, Optional

import roofline


@dataclasses.dataclass
class Span:
    name: str
    t0: int                  # perf_counter_ns
    t1: int
    thread: int
    parent: Optional[int]    # index of the enclosing span on the thread


class Recorder:
    """Spans from every thread, kept in memory."""

    def __init__(self):
        self.spans: List[Span] = []
        self.launches: List[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._undo = []

    def span(self, name: str):
        rec = self

        class _Ctx:
            def __enter__(self):
                stack = getattr(rec._local, "stack", None)
                if stack is None:
                    stack = rec._local.stack = []
                self.parent = stack[-1] if stack else None
                with rec._lock:
                    self.index = len(rec.spans)
                    rec.spans.append(Span(name, time.perf_counter_ns(), 0,
                                          threading.get_ident(),
                                          self.parent))
                stack.append(self.index)

            def __exit__(self, *exc):
                rec.spans[self.index].t1 = time.perf_counter_ns()
                rec._local.stack.pop()

        return _Ctx()

    def wrap(self, owner, attr: str, name: str, before=None):
        """Record a span around every call of ``owner.attr``."""
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            if before is not None:
                before(*args, **kwargs)
            with self.span(name):
                return orig(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    def install(self, sampler_cfg: dict):
        """Wrap the program's calls named in the module docstring."""
        import torch
        import miso_tpu_torch._host as host
        import miso_tpu_torch.io.miso_file as miso_file
        import miso_tpu_torch.pipeline as pipeline

        def on_dispatch(runner, key, evs, tags):
            self.launches.append(roofline.launch(
                [roofline.event_stats(ev) for ev in evs], sampler_cfg))

        self.wrap(host._CompileStream, "run", "compile")
        self.wrap(pipeline.StreamRunner, "_dispatch", "dispatch",
                  before=on_dispatch)
        self.wrap(pipeline.StreamRunner, "_put", "queue_wait")
        self.wrap(pipeline.StreamRunner, "_materialize_chunk", "materialize")
        self.wrap(torch.cuda.Event, "synchronize", "device_wait")
        self.wrap(pipeline, "_write_events_batch", "write")
        self.wrap(pipeline, "_pack_events_batch", "write")
        self.wrap(miso_file, "write_summary_file", "summary")

    def uninstall(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    # ------------------------------------------------------------ reading
    def self_seconds(self, name: str, minus=()) -> float:
        """Summed durations of spans ``name`` less their direct children
        named in ``minus``."""
        total = 0
        for i, s in enumerate(self.spans):
            if s.name == name and s.t1:
                total += s.t1 - s.t0
        if minus:
            for s in self.spans:
                if (s.name in minus and s.parent is not None and s.t1
                        and self.spans[s.parent].name == name):
                    total -= s.t1 - s.t0
        return total / 1e9


def sampler_kernels() -> List[str]:
    """Names of the program's sampler kernels: every ``__global__``
    function of its CUDA sources but the latency and barrier probes."""
    import miso_tpu_torch
    csrc = os.path.join(os.path.dirname(miso_tpu_torch.__file__), "csrc")
    names = []
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu"))):
        with open(path) as f:
            text = f.read()
        for m in re.finditer(r"__global__\s+void\s+(?:\w+(?:\([^)]*\))?\s+)*"
                             r"(\w+)\s*\(", text):
            if not re.search(r"probe|latency", m.group(1)):
                names.append(m.group(1))
    return names


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read: the recorder's spans and launch
    counts, the device's operations (name, start, end, in the recorder's
    clock, ns), the sampler kernels' names, the window and the events
    written in it."""

    recorder: Recorder
    device_ops: List[tuple]
    kernel_names: List[str]
    window: tuple
    events: int
    writes_miso: bool

    def is_sampler_kernel(self, name: str) -> bool:
        """Is ``name``, as the profiler prints a kernel (``void
        (anonymous namespace)::reassign_kernel<2>(...)``), one of them?"""
        head = name.replace("(anonymous namespace)::", "")
        head = head[5:] if head.startswith("void ") else head
        return re.split(r"[<(]", head, maxsplit=1)[0].split("::")[-1] in (
            self.kernel_names)


class Profiler:
    """``torch.profiler`` over the traced window, with an anchor that puts
    its clock on ``time.perf_counter_ns``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        from torch.profiler import record_function
        self.prof.__enter__()
        self.anchor = time.perf_counter_ns()
        with record_function("bench_anchor"):
            pass
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)

    def device_ops(self) -> List[tuple]:
        """(name, start, end) of every operation on the card, in
        perf_counter ns."""
        from torch.autograd import DeviceType
        evs = self.prof.profiler.kineto_results.events()
        offset = None
        for e in evs:
            if e.name() == "bench_anchor":
                offset = e.start_ns() - self.anchor
                break
        if offset is None:
            raise RuntimeError("the profiler kept no anchor")
        return [(e.name(), e.start_ns() - offset,
                 e.start_ns() - offset + e.duration_ns())
                for e in evs if e.device_type() == DeviceType.CUDA
                and e.duration_ns() > 0]


def busy_intervals(ops: List[tuple], lo: int, hi: int) -> List[tuple]:
    """The union of the operations' intervals, clipped to [lo, hi]."""
    iv = sorted((max(a, lo), min(b, hi)) for _, a, b in ops
                if b > lo and a < hi)
    out: List[list] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps named by the host spans open across their middle."""
    by_name: Dict[str, int] = {}
    for name, a, b in trace.device_ops:
        by_name[name] = by_name.get(name, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace.window
    busy = busy_intervals(trace.device_ops, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        open_ = sorted({s.name for s in trace.recorder.spans
                        if s.t0 <= mid < (s.t1 or hi) and s.name != "job"})
        named.append(["+".join(open_) or "none", (b - a) / 1e9])
    return {"device_ops": [[n, t / 1e9] for n, t in ops],
            "idle_gaps": named}
