#!/usr/bin/env python3
"""miso_tpu_torch's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<name>.json``) and the traffic a lab's sample brings.  Set-up
imports the program, loads its kernels, generates the sample from the
seed (GFF, coordinate-sorted BAM; ``generate.py``), indexes the GFF and
runs one warm-up job on a slice of it.  The window then runs
``miso_tpu_torch.pipeline.compute_all_genes_psi`` -- the ``miso --run``
engine -- over the whole sample, one job after another with a fresh
output directory each, as a lab runs one ``miso --run`` per sample.
Once the window has closed, ``check.py`` holds what the jobs wrote
against the plain reference.

The last line of standard output is one JSON object; with ``--trace 0``
its metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``metrics/<name>.py``.  The numbers
compared, each beside its limit, close standard error and the JSON line.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules whose presence fails a run: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "miso_tpu")
# a warm-up job's share of the sample's events
WARMUP_EVENTS = 96


def run_env():
    """One thread for each of the host's numeric libraries (the program's
    own threads -- compile, dispatch, materializer, writers -- stay as
    they are; a pool of spinning OpenMP threads beside them made jobs
    ~40 % slower and twice as spread), and every build and kernel cache
    of the program at a fixed path inside the checkout (the kernels'
    library builds in the package's own ``build/`` and the host library
    beside its sources)."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell's traffic (``workloads/<name>.json``), its configuration
    (the file ``BENCHMARK.json`` names, else ``configs/<config>.json``)
    and the metrics ``BENCHMARK.json`` gives it, found by name."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = load_json(HERE, "workloads", name + ".json")
    files = {c["name"]: c["file"] for c in bench["configs"]}
    cell["config_data"] = load_json(ROOT, files.get(
        cell["config"], os.path.join("benchmark", "configs",
                                     cell["config"] + ".json")))
    cell["name"] = name

    def mine(m):
        return name in m.get("workloads", [name])
    cell["end_to_end"] = [m for m in bench["end_to_end"] if mine(m)]
    cell["per_layer"] = [m for m in bench["per_layer"] if mine(m)]
    return cell


def run_config(cfg: dict, cell: dict):
    from miso_tpu_torch._host import RunConfig
    s, rd, run = cfg["sampler"], cfg["reads"], cell.get("run", {})
    fr = rd.get("fragment")
    return RunConfig(
        read_len=rd["read_len"], overhang_len=rd["overhang_len"],
        paired_end=rd["paired_end"],
        mean_frag_len=fr["mean"] if fr else None,
        frag_variance=fr["sd"] ** 2 if fr else None,
        num_sds=fr["num_sds"] if fr else 4.0,
        iters=s["num_iters"], burn_in=s["burn_in"], lag=s["lag"],
        chains=s["num_chains"],
        algorithm=run.get("algorithm", s["algorithm"]),
        min_event_reads=s["min_event_reads"], strand_rule=rd["strand"],
        summary_only=run.get("summary_only", False),
        start="linear" if run.get("linear_start") else "auto")


class Compiled:
    """The read classes of the genes the check reads back, as the timed
    path's host compile hands each event to the sampler: every
    ``_CompileStream`` made while installed passes its events through
    :meth:`keep` first.  Costs a set lookup an event."""

    def __init__(self, names):
        self.names = set(names)
        self.job = None
        self.events = {}                 # (job, name) -> (keys, counts)
        self._undo = None

    def keep(self, ev):
        if ev is not None and ev.name in self.names:
            c = ev.classes
            keys = c.templates if c.frag_len is None else c.frag_len
            self.events[(self.job, ev.name)] = (
                np.array(keys, np.int64).T, np.array(c.counts, np.int64))

    def install(self):
        import miso_tpu_torch._host as host
        init = host._CompileStream.__init__
        keep = self.keep

        def wrapped(stream, *args, **kwargs):
            init(stream, *args, **kwargs)
            emit = stream.emit

            def emit_kept(ev):
                keep(ev)
                emit(ev)
            stream.emit = emit_kept
        host._CompileStream.__init__ = wrapped
        self._undo = (host._CompileStream, init)

    def uninstall(self):
        if self._undo is not None:
            self._undo[0].__init__ = self._undo[1]
            self._undo = None


def job_seed(seed: int, job: int) -> int:
    """The sampler seed of job ``job`` of a run on ``seed``."""
    words = [int(seed) % (1 << 64), job % (1 << 32), 0x10B]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint32)[0])


def forbidden_modules():
    """Top-level names of loaded modules that a run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def dir_bytes(path: str) -> int:
    total = 0
    for d, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(d, f))
            except OSError:
                pass
    return total


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda:0", work_dir=None, t_start=T_START,
             log=sys.stderr) -> dict:
    """One run of cell ``name``; returns the result's fields.  ``device``
    "cpu" drives the program's plain versions (the tests' use)."""
    import torch

    import check
    import generate
    import spans

    cell = load_cell(name)
    cfg = cell["config_data"]
    import miso_tpu_torch
    from miso_tpu_torch.io.index import index_gff
    from miso_tpu_torch.pipeline import compute_all_genes_psi
    if not os.path.abspath(miso_tpu_torch.__file__).startswith(ROOT + os.sep):
        raise RuntimeError("miso_tpu_torch imported from outside the "
                           "checkout: %s" % miso_tpu_torch.__file__)
    cuda = device.startswith("cuda")
    phases = []                          # set-up's parts, for the log
    mark = [time.perf_counter()]
    phases.append(("start and imports", mark[0] - t_start))

    def phase(what: str):
        now = time.perf_counter()
        phases.append((what, now - mark[0]))
        mark[0] = now
    with contextlib.redirect_stdout(log):
        if cuda:
            from miso_tpu_torch import kernels
            kernels.load()
            torch.cuda.synchronize()
        phase("kernels and context")
        tmp = tempfile.mkdtemp(prefix="miso-bench-", dir=work_dir)
        try:
            sample = generate.make_sample(cfg, cell, seed)
            phase("sample")
            generate.write_sample(sample, os.path.join(tmp, "sample"))
            phase("GFF and BAM")
            index_dir = os.path.join(tmp, "index")
            index_gff(sample.gff_path, index_dir)
            phase("index_gff")
            rc = run_config(cfg, cell)
            names = np.array(sample.models.name)
            due = np.flatnonzero(check.due(sample))
            warm = names[due[np.linspace(0, len(due) - 1, min(
                WARMUP_EVENTS, len(due))).astype(int)]].tolist()

            def job(k: int, gene_ids=None):
                out = os.path.join(tmp, "job%d" % k)
                return out, compute_all_genes_psi(
                    index_dir, sample.bam_path, rc.read_len, out, cfg=rc,
                    gene_ids=gene_ids, seed=job_seed(seed, k),
                    verbose=False, device=device)

            job(-1, warm)
            if cuda:
                torch.cuda.synchronize()
            setup_s = time.perf_counter() - t_start
            phase("warm-up job")
            print("setup %.3f s: %s" % (setup_s, ", ".join(
                "%s %.3f" % p for p in phases)), file=log)

            rec = spans.Recorder() if trace else None
            prof = spans.Profiler() if trace and cuda else None
            if rec is not None:
                rec.install(cfg["sampler"])
            compiled = Compiled(names[[g for _, g in check.pick_events(
                sample, seed, cell["check"]["events"], 1)]].tolist())
            compiled.install()
            jobs, written = [], 0
            try:
                with (prof or contextlib.nullcontext()):
                    t0 = time.perf_counter_ns()
                    while (time.perf_counter_ns() - t0) / 1e9 < seconds:
                        ctx = (rec.span("job") if rec
                               else contextlib.nullcontext())
                        tj = time.perf_counter()
                        compiled.job = len(jobs)
                        with ctx:
                            out, n = job(len(jobs))
                        jobs.append({"out_dir": out, "events": n,
                                     "seconds": time.perf_counter() - tj})
                        written += n
                    if cuda:
                        torch.cuda.synchronize()
                    t1 = time.perf_counter_ns()
            finally:
                compiled.uninstall()
                if rec is not None:
                    rec.uninstall()
            window_s = (t1 - t0) / 1e9
            peak = (torch.cuda.max_memory_allocated(torch.device(device))
                    if cuda else 0)
            metrics, device_info, extra = {}, {}, {}
            if trace:
                tr = spans.Trace(rec, prof.device_ops() if prof else [],
                                 spans.sampler_kernels(), (t0, t1), written,
                                 not rc.summary_only)
                for m in cell["per_layer"]:
                    mod = importlib.import_module("metrics." + m["name"])
                    v = mod.read(tr)
                    if v is not None:
                        metrics[m["name"]] = {"value": float(v),
                                              "unit": m["unit"]}
                lo, hi = tr.window
                device_info["busy_s"] = sum(
                    b - a for a, b in spans.busy_intervals(
                        tr.device_ops, lo, hi)) / 1e9
                device_info["window_s"] = window_s
                extra["breakdown"] = spans.breakdown(tr)
            else:
                e2e = {"events_per_s": written / window_s,
                       "setup_s": setup_s}
                for m in cell["end_to_end"]:
                    metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                          "unit": m["unit"]}
            print("jobs %d, events %d, window %.3f s, bytes written %d"
                  % (len(jobs), written, window_s, dir_bytes(tmp)),
                  file=log)
            print("job seconds %s" % " ".join(
                "%.3f" % j["seconds"] for j in jobs), file=log)
            t_check = time.perf_counter()
            numbers = check.check(sample, jobs, cell, seed, device=device,
                                  log=log, compiled=compiled.events)
            print("check took %.1f s" % (time.perf_counter() - t_check),
                  file=log)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    limits = cell["limits"]
    due_n = int(check.due(sample).sum()) * len(jobs)
    return {
        "correct": check.within(numbers, limits),
        "attempted": due_n,
        "failed": int(min(numbers["missing"], due_n)),
        "metrics": metrics,
        "device": dict(device_info, memory_peak_bytes=int(peak)),
        **extra,
        "checks": {k: {"value": float(min(numbers[k], 1e300)),
                       "limit": float(limits[k])} for k in limits},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    run_env()
    sys.path.insert(1, ROOT)
    import torch
    chips = load_cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("needs %d CUDA device(s); this machine has %s" % (
            chips, torch.cuda.device_count() if torch.cuda.is_available()
            else "none"), file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda:0" if chips == 1 else "cuda")
    found = forbidden_modules()
    if found:
        print("the run loaded %s" % ", ".join(found), file=sys.stderr)
        return 3
    res["device"] = dict({"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": chips}, **res["device"])
    for k, v in res["checks"].items():
        print("check %s %r limit %r" % (k, v["value"], v["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
