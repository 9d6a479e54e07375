"""The port's pipeline (miso_tpu_torch/pipeline.py, _host.py, cli/main.py)
against the JAX package's, on the CPU.

The deterministic device pieces (per-read expansion, the tick and
centipoint quantisation and the device summary of quantize.py) must match
the JAX functions exactly on the same inputs.  The whole slice --
catalog -> ``miso --run`` -> ``.miso`` + ``.miso_summary`` -- runs
through both CLIs on one simulated catalog, in every mode the port runs;
chains differ, so posterior means are held to the Monte-Carlo noise of
the fast settings.
"""
import inspect
import os
import re
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import miso_tpu.pipeline as jp
import miso_tpu_torch._host as host
import miso_tpu_torch.pipeline as tp
import miso_tpu_torch.quantize as tz
import miso_tpu_torch.sampler.reassign_kernel as rk
from miso_tpu_torch import trace
from miso_tpu.core.events import compile_single_end
from miso_tpu.core.gene import make_gene
from miso_tpu.core.simulate import simulate_reads
from miso_tpu_torch.testing import cap_test_threads

cap_test_threads()

FAST_SETTINGS = """\
[data]
filter_results = True
min_event_reads = 20

[sampler]
burn_in = 100
lag = 5
num_iters = 600
num_chains = 2
"""
# posterior means of two independent runs at FAST_SETTINGS (200 samples
# per event) agree to this Monte-Carlo tolerance
MEAN_TOL = 0.05


def test_expand_read_tensors_matches_jax():
    rng = np.random.default_rng(3)
    E, C, I, R = 5, 4, 3, 64
    weights = (rng.random((E, C, I)) < 0.6).astype(np.float32)
    log_read = np.where(weights > 0, rng.normal(-4, 1, (E, C, I)),
                        0.0).astype(np.float32)
    counts = rng.integers(0, 16, (E, C)).astype(np.float32)
    counts[1] = 0.0                               # an event with no reads
    counts[2, :] = [16, 16, 16, 16]               # exactly R reads
    jw, jls = jp._expand_read_tensors(jnp.asarray(weights),
                                      jnp.asarray(log_read),
                                      jnp.asarray(counts), R)
    tw, tls = rk.expand_read_tensors(torch.from_numpy(weights),
                                     torch.from_numpy(log_read),
                                     torch.from_numpy(counts), R)
    assert tw.dtype == torch.float32 and tw.shape == (E, R, I)
    np.testing.assert_array_equal(tw.numpy(),
                                  np.asarray(jw).astype(np.float32))
    # JAX stores bf16; the port keeps f32, which rounds to the same bf16
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(tls.numpy()).astype(jnp.bfloat16)),
        np.asarray(jls))


def test_wide_reassign_bucket_reaches_its_wrapper_as_classes(monkeypatch):
    """``run_sampler`` hands a wide REASSIGN bucket (a gene of 300
    isoforms, a bucket of 512) to ``run_batch_reassign`` as its class
    tensors and read slots: no (E, R, I) tile is built on the way (B1w
    reads the classes; tests/test_torch_kernel_source.py holds it to the
    plain version with the expansion taken away, and the card's run,
    ``chip_smoke.py``, alike).  On the CPU the wrapper's plain version
    expands them itself: the result is the expanded batch's, bit for
    bit."""
    from miso_tpu_torch.sampler import wide
    from miso_tpu_torch.sampler.mcmc import SamplerConfig
    from miso_tpu_torch.testing import class_batch, wide_event

    ev = wide_event("reassign")
    pad_iso, _, R = tp._bucket_key(ev)
    assert pad_iso == 512 >= wide.WIDE_FROM and R <= tp.DEEP_READS
    batch = class_batch([ev], "cpu")
    assert batch.read_w.shape == (1, 1, 512)
    cfg = SamplerConfig(iters=12, burn_in=4, lag=2, chains=2)
    tiles = batch._replace(**dict(zip(("read_w", "read_logscore"),
                                      rk.expand_read_tensors(
                                          batch.weights, batch.log_read,
                                          batch.counts, R))))
    ref = rk.run_batch_reassign(7, tiles, cfg)
    calls, expanded = [], []

    def wrapper(seed, b, c, **kw):
        # what run_sampler expanded before it handed the bucket over
        calls.append((tuple(b.read_w.shape), kw.get("pad_reads"),
                      len(expanded)))
        return rk.run_batch_reassign(seed, b, c, **kw)

    def expand(*args):
        expanded.append(args[-1])
        return rk_expand(*args)

    rk_expand = rk.expand_read_tensors
    monkeypatch.setattr(tp, "run_batch_reassign", wrapper)
    monkeypatch.setattr(rk, "expand_read_tensors", expand)
    got = tp.run_sampler(7, batch, cfg, None, R)
    # only the CPU's plain version, inside the wrapper, expands
    assert calls == [((1, 1, 512), R, 0)] and expanded == [R]
    for name, a, b in zip(got._fields, got, ref):
        assert torch.equal(a, b), name


def _jax_quantize(flat_psi, flat_ll, two_iso):
    """The quantisation of pipeline.py:615-635 (inline in _dispatch)."""
    if two_iso:
        quant = jnp.clip(jnp.round(flat_psi[:, :, 0] * 1e4),
                         0, 10000).astype(jnp.uint16)
    else:
        quant = jnp.clip(jnp.round(flat_psi * 1e4),
                         0, 10000).astype(jnp.uint16)
    cents = jnp.round(flat_ll * 100.0)
    cmin = jnp.min(cents, axis=1)
    cmax = jnp.max(cents, axis=1)
    resid = jnp.clip(cents - cmin[:, None], 0, 65535).astype(jnp.uint16)
    return quant, resid, cmin, cmax


@pytest.mark.parametrize("I", [2, 3])
def test_quantisation_and_summary_match_jax(I):
    rng = np.random.default_rng(7 + I)
    E, S = 6, 200
    psi = rng.dirichlet(np.ones(I), size=(E, S)).astype(np.float32)
    psi[0, 3, 0] = np.nextafter(np.float32(1.0), np.float32(2.0))
    psi[1, 5, 0] = 0.99995                       # rounds to 10000 exactly
    psi[-1] = np.nan                             # a masked padding row
    ll = rng.normal(-300, 40, (E, S)).astype(np.float32)
    ll[2, :] = np.linspace(-1000, 0, S)          # a row wider than uint16
    ll[-1] = np.nan
    two = I == 2
    jq, jres, jmin, jmax = _jax_quantize(jnp.asarray(psi), jnp.asarray(ll),
                                         two)
    tq = tz.quantize_psi(torch.from_numpy(psi), two)
    tres, tmin, tmax = tz.quantize_scores(torch.from_numpy(ll))
    np.testing.assert_array_equal(tq.numpy().astype(np.uint16),
                                  np.asarray(jq))
    np.testing.assert_array_equal(tres.numpy().astype(np.uint16),
                                  np.asarray(jres))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    lo, hi = jp._ci_bound_indices(S)
    jsum, jlo, jhi = jp._summary_stats(jq, lo, hi)
    tsum, tlo, thi = tz.summary_stats(tq, lo, hi)
    # the host reduction of pipeline.py:694 over either payload
    np.testing.assert_array_equal(
        tsum.numpy().astype(np.int64).sum(axis=1),
        np.asarray(jsum).astype(np.int64).sum(axis=1))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("name", [
    "RunConfig", "chrom_output_dir", "event_output_path",
    "compile_gene_event", "_LazyResult", "_ci_bound_indices",
    "_write_event", "_iter_bodies", "_write_events_batch",
    "_pack_events_batch", "write_event_results", "_CompileStream"])
def test_host_copy_has_not_drifted(name):
    """_host.py holds verbatim copies of miso_tpu/pipeline.py objects,
    importing the port's own host modules, with the trace sites of
    ``_CompileStream`` taken out."""
    assert untraced(inspect.getsource(getattr(host, name))) == re.sub(
        r"miso_tpu(?!_torch)", "miso_tpu_torch",
        inspect.getsource(getattr(jp, name)))


def untraced(src: str) -> str:
    """``src`` without the port's trace sites: the ``tracer`` parameter
    and attribute of ``_CompileStream``, and every ``with
    self.tracer.span(...):`` line, its block moved back out."""
    src = src.replace(",\n                 tracer: trace.Tracer = trace.OFF)",
                      ")")
    src = src.replace("        # the job's tracer: the compile's spans "
                      "(trace.py)\n        self.tracer = tracer\n", "")
    out, opened = [], []           # indents of the open with-lines
    for line in src.split("\n"):
        indent = len(line) - len(line.lstrip())
        while opened and line.strip() and indent <= opened[-1]:
            opened.pop()
        if re.fullmatch(r"\s*with self\.tracer\.span\(.*\):", line):
            opened.append(indent)
            continue
        out.append(line[4 * len(opened):] if line.strip() else line)
    return "\n".join(out)


def test_untraced_takes_out_every_trace_site_of_the_compile():
    src = untraced(inspect.getsource(host._CompileStream))
    assert "tracer" not in src and "trace." not in src


def test_chunk_seeds_differ_across_chunks_and_bucket_axes():
    base = (0, 0, 2, 4, 320)
    seeds = {tp.chunk_seed(*base)}
    for axis in range(5):
        alt = list(base)
        alt[axis] += 4096 if axis == 1 else 1
        seeds.add(tp.chunk_seed(*alt))
    assert len(seeds) == 6
    assert tp.chunk_seed(*base) == tp.chunk_seed(*base)


def test_two_chunks_of_one_bucket_draw_different_streams():
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    _, pos, cig = simulate_reads(g, [0.6, 0.4], 60, 25,
                                 np.random.default_rng(1))
    ev = compile_single_end(g, pos, cig, read_len=25)
    cfg = host.RunConfig(read_len=25, iters=60, burn_in=10, lag=5,
                         chains=2, max_batch_events=4)
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = tp.run_events([ev] * 8, cfg, seed=0, device="cpu")
    chunks = [r.attrs["events"]
              for r in trace.records(t0, time.perf_counter_ns())
              if isinstance(r, trace.Span) and r.name == "dispatch"]
    assert chunks == [4, 4]
    first, second = out[0]["psi_ticks"], out[4]["psi_ticks"]
    assert first.shape == second.shape == (20, 2)
    assert not np.array_equal(first, second)
    # within a chunk, lanes draw distinct streams too
    assert not np.array_equal(out[0]["psi_ticks"], out[1]["psi_ticks"])


# --------------------------------------------------------- the dispatch
# (gene, reads, first total) of four buckets: their keys differ in every
# axis, and every event's total reads is its own
DISPATCH_BUCKETS = (
    (([100, 50, 100], [[1, 2, 3], [1, 3]]), 40, 40),
    (([100, 50, 80, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]]), 110, 100),
    (([100, 50, 80, 60, 100],
      [[1, 2, 3, 4, 5], [1, 3, 4, 5], [1, 4, 5], [1, 2, 5]]), 210, 200),
    (([100, 50, 100], [[1, 2, 3], [1, 3]]), 300, 290))
PER_BUCKET = 13


class FakeReady:
    """A chunk's ready event that passes when ``passed()`` says so."""

    def __init__(self, passed):
        self.passed = passed

    def query(self):
        return self.passed()

    def synchronize(self):
        if not self.passed():
            raise AssertionError("materialized before its kernels ran")


def dispatch_events():
    """PER_BUCKET events of each of DISPATCH_BUCKETS, the buckets' events
    in turn, each event's total reads set to a number no other has."""
    import dataclasses
    from miso_tpu_torch.testing import simulated_event

    out = []
    for b, ((exons, isoforms), reads, total) in enumerate(DISPATCH_BUCKETS):
        psi = np.full(len(isoforms), 1.0 / len(isoforms))
        base = simulated_event(exons, isoforms, psi, reads, 36, seed=b)
        for j in range(PER_BUCKET):
            counts = base.counts.copy()
            counts[np.argmax(counts)] += total + j - counts.sum()
            out.append(dataclasses.replace(base, counts=counts))
    order = [b * PER_BUCKET + j for j in range(PER_BUCKET)
             for b in range(len(DISPATCH_BUCKETS))]
    return [out[i] for i in order]


def fake_sampler(calls, runner):
    """A sampler that runs nothing: each event's final counts are its
    total reads, and ``calls`` records every launch's seed, key, real
    totals and the chunks in flight as it was issued."""
    from miso_tpu_torch.sampler.mcmc import SamplerResult

    def run(seed, batch, cfg, start_psi, pad_reads):
        E, C, I = batch.weights.shape
        total = batch.counts.sum(1)
        calls.append({"seed": seed, "key": (I, C, pad_reads),
                      "totals": [int(t) for t in total if t > 0],
                      "in_flight": len(runner._in_flight)})
        psi = torch.full((E, cfg.num_records, cfg.chains, I), 1.0 / I)
        return SamplerResult(
            psi_samples=psi, loglik=torch.zeros(psi.shape[:3]),
            accepted=torch.zeros(E, dtype=torch.int32),
            rejected=torch.zeros(E, dtype=torch.int32),
            final_n=total[:, None, None].expand(E, cfg.chains, I).clone(),
            final_psi=psi[:, 0])
    return run


@pytest.mark.parametrize("bound", ["streams", "memory"])
def test_the_dispatch_keeps_seeds_and_results_in_any_completion_order(
        monkeypatch, bound):
    """Chunks complete out of order (random numbers of looks at their
    ready events; with four streams the first chunk only once three
    later ones have landed): every chunk reaches ``on_chunk`` once with
    its own events' results, each keeps the seed and offset that the
    order of its bucket gives (as a FIFO dispatch gave them), ``finish``
    flushes the costliest buckets first, and the chunks in flight never
    pass the pool's four streams, nor one where one chunk fills the
    memory budget."""
    monkeypatch.setattr(tp, "POOL_STREAMS", 4)
    monkeypatch.setattr(tp, "READY_POLL_S", 1e-4)
    rng = np.random.default_rng(5)
    evs = dispatch_events()
    cfg = host.RunConfig(read_len=36, iters=30, burn_in=10, lag=5,
                         chains=2, max_batch_events=4)
    landed, calls = [], []
    runner = tp.StreamRunner(cfg, seed=9, device="cpu",
                             on_chunk=lambda tags, res: landed.append(
                                 (list(tags), res)))
    if bound == "memory":
        runner.memory_budget = 1
    monkeypatch.setattr(tp, "run_sampler", fake_sampler(calls, runner))
    payload = runner._device_payload

    def pending(res, two_iso):
        p = payload(res, two_iso)
        n = len(calls)
        looks = [int(rng.integers(0, 20))]

        def passed():
            if n == 1:
                return len(landed) >= 3 or bound == "memory"
            looks[0] -= 1
            return looks[0] < 0
        p["ready"] = FakeReady(passed)
        return p

    monkeypatch.setattr(runner, "_device_payload", pending)
    try:
        for i, ev in enumerate(evs):
            runner.add(ev, tag=i)
        n_added = len(calls)
        runner.finish()
    except BaseException:
        runner.abort()
        raise
    total = {i: int(ev.counts.sum()) for i, ev in enumerate(evs)}
    tag_of = {t: i for i, t in total.items()}
    # every event once, with its own results
    tags = [t for chunk, _ in landed for t in chunk]
    assert sorted(tags) == list(range(len(evs)))
    for chunk, results in landed:
        for t, res in zip(chunk, results):
            assert np.all(res["final_n"] == total[t])
    # seeds and offsets: a bucket's chunks in its order, every 4 events
    by_key = {}
    for i, ev in enumerate(evs):
        by_key.setdefault(tp._bucket_key(ev), []).append(i)
    assert len(calls) == len(landed) == len(DISPATCH_BUCKETS) * 4
    seen = {key: 0 for key in by_key}
    for c in calls:
        key = c["key"]
        k = seen[key]
        seen[key] += 1
        assert [tag_of[t] for t in c["totals"]] == by_key[key][4 * k:
                                                             4 * k + 4]
        assert c["seed"] == tp.chunk_seed(9, 4 * k, *key)
    if bound == "streams":
        # the first chunk landed after later ones: completion order
        assert [tag_of[t] for t in calls[0]["totals"]] != landed[0][0]
    # finish: the remainder of each bucket, costliest first
    finished = [c["key"] for c in calls[n_added:]]
    assert finished == sorted(by_key, key=lambda k: -k[0] * k[2])
    assert [runner.chain_cost(k) for k in finished] == sorted(
        (runner.chain_cost(k) for k in finished), reverse=True)
    most = max(c["in_flight"] for c in calls)
    assert most == (1 if bound == "memory" else 4)


def test_chain_cost_reads_the_route_from_the_key():
    """B1/B1w: isoforms x read slots; B3 and MARGINAL/CLASSES: isoforms x
    classes."""
    costs = {}
    for algorithm in ("reassign", "marginal"):
        runner = tp.StreamRunner(host.RunConfig(read_len=36,
                                                algorithm=algorithm),
                                 device="cpu")
        runner.finish()
        costs[algorithm] = [runner.chain_cost(k) for k in (
            (32, 64, 512), (4, 64, tp.DEEP_READS * 2))]
    assert costs == {"reassign": [32 * 512, 4 * 64],
                     "marginal": [32 * 64, 4 * 64]}


# ------------------------------------------------------------ the slice
N_EVENTS = 40


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    from miso_tpu.cli.index_gff import main as index_main
    from miso_tpu.testing import build_catalog_fixture

    root = tmp_path_factory.mktemp("torch_slice")
    fix = build_catalog_fixture(str(root / "fix"), num_events=N_EVENTS,
                                reads_per_event=400, seed=7)
    settings = root / "settings.txt"
    settings.write_text(FAST_SETTINGS)
    index_dir = str(root / "index")
    assert index_main(["--index", fix["gff"], index_dir]) == 0
    return root, fix, index_dir, str(settings)


def _run_both(catalog, extra):
    from miso_tpu.cli.main import main as jax_main
    from miso_tpu_torch.cli.main import main as torch_main

    root, fix, index_dir, settings = catalog
    tag = "_".join(a.strip("-") for a in extra) or "full"
    outs = {}
    for name, fn, dev in (("jax", jax_main, []),
                          ("torch", torch_main, ["--device", "cpu"])):
        out = str(root / ("%s_%s" % (name, tag)))
        rc = fn(["--run", index_dir, fix["bam"], "--output-dir", out,
                 "--read-len", str(fix["read_len"]),
                 "--settings-filename", settings] + extra + dev)
        assert rc == 0
        outs[name] = out
    return outs


def _summary(out):
    path = os.path.join(out, "summary",
                        "%s.miso_summary" % os.path.basename(out))
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [dict(zip(header, line.rstrip("\n").split("\t")))
                for line in f if line.strip()]
    return {r["event_name"]: r for r in rows}


def _miso_files(out):
    found = {}
    for d, _, files in os.walk(out):
        for fn in files:
            if fn.endswith(".miso"):
                found[os.path.relpath(os.path.join(d, fn), out)] = \
                    os.path.join(d, fn)
    return found


def _header(path):
    with open(path) as f:
        fields = f.readline().lstrip("#").rstrip("\n").split("\t")
    chain_dependent = ("percent_accept", "assigned_counts")
    return [x for x in fields if x.split("=", 1)[0] not in chain_dependent]


def _check_truth(means, fix):
    truth = fix["true_psi"]
    assert np.corrcoef(means, truth)[0, 1] > 0.9
    assert abs(np.mean(means - truth)) < 0.06


def _means(out):
    from miso_tpu.io.miso_file import MISOSamples

    obj = MISOSamples(out)
    return np.array([obj.get_event_samples("ev%d" % e).samples[:, 0].mean()
                     for e in range(N_EVENTS)])


def test_slice_matches_jax_cli(catalog):
    outs = _run_both(catalog, [])
    jf, tf = _miso_files(outs["jax"]), _miso_files(outs["torch"])
    assert len(tf) == N_EVENTS and sorted(tf) == sorted(jf)
    for rel in tf:
        assert _header(tf[rel]) == _header(jf[rel]), rel
    assert sorted(_summary(outs["torch"])) == sorted(_summary(outs["jax"]))
    means = {name: _means(out) for name, out in outs.items()}
    assert np.all(np.abs(means["torch"] - means["jax"]) < MEAN_TOL)
    _check_truth(means["torch"], catalog[1])


def test_slice_summary_only_matches_jax_cli(catalog):
    outs = _run_both(catalog, ["--summary-only"])
    for out in outs.values():
        assert not _miso_files(out)
    js, ts = _summary(outs["jax"]), _summary(outs["torch"])
    assert sorted(ts) == sorted(js) and len(ts) == N_EVENTS
    names = ["ev%d" % e for e in range(N_EVENTS)]
    tm = np.array([float(ts[n]["miso_posterior_mean"]) for n in names])
    jm = np.array([float(js[n]["miso_posterior_mean"]) for n in names])
    # the table rounds each mean to 2 decimals: up to 0.01 more apart
    assert np.all(np.abs(tm - jm) < MEAN_TOL + 0.01 + 1e-9)
    _check_truth(tm, catalog[1])


@pytest.mark.parametrize("flags", [
    ["--algorithm", "marginal"], ["--algorithm", "classes"],
    ["--linear-start"], ["--convergent"]])
def test_new_modes_match_jax_cli(catalog, flags):
    """The modes this slice adds, through both CLIs: the same .miso
    files, headers equal apart from chain-dependent fields (convergent
    stop also records each event's own schedule), and posterior means
    within the Monte-Carlo tolerance of each other and of the truth."""
    outs = _run_both(catalog, flags)
    jf, tf = _miso_files(outs["jax"]), _miso_files(outs["torch"])
    assert len(tf) == N_EVENTS and sorted(tf) == sorted(jf)
    dependent = ("iters", "burn_in") if "--convergent" in flags else ()
    for rel in tf:
        th = [x for x in _header(tf[rel]) if x.split("=")[0] not in dependent]
        jh = [x for x in _header(jf[rel]) if x.split("=")[0] not in dependent]
        assert th == jh, rel
    assert sorted(_summary(outs["torch"])) == sorted(_summary(outs["jax"]))
    means = {name: _means(out) for name, out in outs.items()}
    assert np.all(np.abs(means["torch"] - means["jax"]) < MEAN_TOL)
    _check_truth(means["torch"], catalog[1])


def _header_fields(header):
    fields = header.split("\n", 1)[0].lstrip("#").split("\t")
    return [x for x in fields
            if x.split("=", 1)[0] not in ("percent_accept",
                                          "assigned_counts")]


def test_pack_output_matches_jax_cli(catalog):
    """--pack-output through both CLIs: no .miso tree, and .miso_db
    files holding the same events with the same headers apart from
    chain-dependent fields."""
    from miso_tpu_torch.testing import packed_events

    outs = _run_both(catalog, ["--pack-output"])
    packed = {}
    for name, out in outs.items():
        assert not _miso_files(out)
        packed[name] = packed_events(out)
    assert len(packed["torch"]) == N_EVENTS
    assert sorted(packed["torch"]) == sorted(packed["jax"])
    for ev, (header, body) in packed["torch"].items():
        jax_header, jax_body = packed["jax"][ev]
        # (600 - 100) / 5 samples per chain, 2 chains
        assert body.count("\n") == jax_body.count("\n") == 200, ev
        assert _header_fields(header) == _header_fields(jax_header)
    assert sorted(_summary(outs["torch"])) == sorted(_summary(outs["jax"]))


def test_profile_writes_a_trace(catalog, capsys):
    from miso_tpu_torch.cli.main import main as torch_main

    root, fix, index_dir, settings = catalog
    trace_dir = root / "trace"
    assert torch_main(["--run", index_dir, fix["bam"], "--output-dir",
                       str(root / "profiled"), "--read-len", "36",
                       "--settings-filename", settings, "--summary-only",
                       "--profile", str(trace_dir), "--device", "cpu"]) == 0
    traces = list(trace_dir.glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert str(traces[0]) in capsys.readouterr().out
    assert len(_summary(str(root / "profiled"))) == N_EVENTS


def test_cli_refuses_unported_flags_and_missing_cuda(catalog):
    from miso_tpu_torch.cli.main import main as torch_main

    root, fix, index_dir, settings = catalog
    base = ["--run", index_dir, fix["bam"], "--output-dir",
            str(root / "refused"), "--read-len", "36"]
    # the multi-host flags run since the port has parallel/distributed.py;
    # what is refused now, before any rendezvous, is a host that was
    # started without its coordinator, count or id, or with an id outside
    # the count
    for flags in (["--num-hosts", "2"],
                  ["--coordinator", "localhost:1234"],
                  ["--coordinator", "localhost:1234", "--host-id", "0"],
                  ["--num-hosts", "2", "--host-id", "1"],
                  ["--coordinator", "localhost:1234", "--num-hosts", "2",
                   "--host-id", "2"],
                  ["--coordinator", "localhost:1234", "--num-hosts", "2",
                   "--host-id", "-1"]):
        with pytest.raises(ValueError, match="--host-id"):
            torch_main(base + flags + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_main(base)


def test_summary_only_resume_backfills_every_row(catalog, capsys):
    """--summary-only resumed over a tree that holds full outputs for
    half the catalog: the events that have their .miso file are skipped
    and their rows come from the stored samples, so every event has a
    row (the JAX package leaves those rows out without a word)."""
    from miso_tpu_torch.cli.main import main as torch_main

    root, fix, index_dir, settings = catalog
    out = str(root / "resumed")
    half = ["ev%d" % e for e in range(0, N_EVENTS, 2)]
    from miso_tpu_torch.io.settings import Settings
    assert tp.compute_all_genes_psi(
        index_dir, fix["bam"], 36, out, settings=Settings.load(settings),
        gene_ids=half, device="cpu", verbose=False) == len(half)
    first = _summary(out)
    assert sorted(first) == sorted(half)
    os.remove(os.path.join(out, "summary", "resumed.miso_summary"))
    capsys.readouterr()
    assert torch_main(["--run", index_dir, fix["bam"], "--output-dir", out,
                       "--read-len", "36", "--settings-filename", settings,
                       "--summary-only", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    # only the other half was sampled, and no new .miso file appeared
    assert "Quantified %d events (%d skipped)" % (
        N_EVENTS - len(half), len(half)) in text
    assert "Posterior summary (%d events" % N_EVENTS in text
    assert len(_miso_files(out)) == len(half)
    rows = _summary(out)
    assert sorted(rows) == sorted("ev%d" % e for e in range(N_EVENTS))
    # a backfilled row is the row the full run wrote for that event
    for name in half:
        assert rows[name] == first[name]
    means = np.array([float(rows["ev%d" % e]["miso_posterior_mean"])
                      for e in range(N_EVENTS)])
    _check_truth(means, fix)
