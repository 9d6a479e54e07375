"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything below
    python3 chip_smoke.py marginal [DIR]   # a development aid: the
                                           # MARGINAL kernel's checks and
                                           # times alone, and its I=2 SASS
                                           # into DIR (default: the build
                                           # directory).  It drives no main
                                           # path and prints no verdict:
                                           # its exit code 0 is not the
                                           # smoke's
    python3 chip_smoke.py hosts      # likewise a development aid: the
                                     # 2,000-gene REASSIGN run, then the
                                     # multi-host run (three times, for
                                     # the spread of its walls), the host
                                     # tools, the wide buckets and the
                                     # probes alone
    python3 chip_smoke.py mesh       # likewise: the 2,000-gene REASSIGN,
                                     # MARGINAL and convergent runs, then
                                     # the mesh phase alone
    python3 chip_smoke.py wide       # likewise: the wide kernels B1w and
                                     # B2w alone (their checks, the wide
                                     # buckets' runs and times)
    python3 chip_smoke.py streams    # likewise: the stream pool's check
                                     # alone (a mixed catalog through
                                     # StreamRunner, bit-equal to a run
                                     # on one stream)
    python3 chip_smoke.py multinomial [DIR]  # likewise: the deep route's
                                             # kernel B3 alone (its checks,
                                             # the deep catalog's runs, its
                                             # times and step breakdown),
                                             # and its SASS into DIR
                                             # (default: the build
                                             # directory)

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, in parallel), holds each against its plain PyTorch
version -- at the main paths' shapes, at up to 64 isoforms (the narrow
B1 and B2) and at 128, 512, 2,048 and 8,192 isoforms (the wide B1w and
B2w, ``csrc/wide_kernel.cu``, which take every bucket from
``wide.WIDE_FROM`` and ``wide.WIDE_FROM_MARGINAL`` isoforms on, B1w
reading the bucket's classes; at 8,192 their lane arrays lie in
scratch) and on paired-end events; each kernel in every layout its
launch plan can take (REASSIGN: lane width T and home of the weights;
MARGINAL: lane width T; B1w and B2w: block width, shared memory or
scratch), whose Philox chains must also be bit-equal -- and against
the grid-exact posterior, then runs ``miso --run`` through the port
(``miso_tpu_torch.cli.main``) at stock sampler settings: on a 2,000-gene
single-end catalog REASSIGN, MARGINAL with the linear start, CLASSES,
REASSIGN with convergent stop and REASSIGN with ``--pack-output``; on a
2,000-gene paired-end catalog with ``--paired-end 250 15``, REASSIGN and
MARGINAL (the latter's largest launch is held against the plain version
on the run's own tensors, and the run is made once more on a 500-gene
catalog, beside a run of it with the plain version in the kernel's
place: the two runs' biases against the truth must agree); and on a
16-gene catalog of 20,000 reads per gene, whose deep
events take the multinomial route (kernel B3), once more under
``--profile``.  It checks each run's output against the simulation
truth.  Then the rest of the user's path on the single-end catalog: two
``miso_torch --run --coordinator ... --num-hosts 2`` processes at once on
the one card into one output tree (beside one such process alone, for
the walls); a second sample with psi moved by 0.5 in every other gene,
then the port's ``summarize``, ``compare`` and ``filter_events`` CLIs
over the two trees; ``run_miso.py --compute-gene-psi`` for a handful of
genes; buckets of 512 and 2,048 isoforms (four genes of 300 and of
1,100 isoforms) through ``StreamRunner`` at stock settings for REASSIGN
and MARGINAL (each one launch of B1w or B2w, which is then held against
the plain version at that bucket's shape, timed beside it and its bound,
and held against the exact posterior of a two-isoform event padded to
the bucket's width); a mixed catalog (buckets of 2, 16, 32 and 64
isoforms and a deep one) through ``StreamRunner`` with its pool of
streams and again with the pool forced to one stream, bit for bit the
same; and the port's ``module_availability`` and ``test_miso``.  The mesh phase (``parallel/mesh.py``): both kernels
sharded at their main shapes over ``[cuda:0]`` and ``[cuda:0, cuda:0]``
(one stream per entry) against the unsharded launch -- bit-equal under
fixed uniforms in the shards' launch plan, every Philox shard of the
pipeline's sampler bit-equal to its slice run alone with the seed the
pipeline draws for it (``chunk_seed(..., shard=k)``) -- then ``miso --run``'s
engine over ``[cuda:0, cuda:0]`` on the single-end catalog for REASSIGN,
MARGINAL with the linear start and the convergent stop, each wall beside
the unsharded run's.  The script never imports matplotlib (the card's
machine has none).
Every phase that fails raises, so the script exits non-zero and
never prints its last line.  It needs one CUDA device and fails without
one.

B3, the deep route's kernel (``csrc/multinomial_kernel.cu``), is held
against its plain version under fixed uniforms in every plan at the
deep catalog's bucket shape, on a paired-end deep bucket of 256 classes,
and at 8, 16 and 128 isoforms, from AUTO and GIVEN starts; its Philox
chain must be one in every plan, its binomial draws must have the
multinomial's moments at n p below and above 10, and its posterior must
match the plain version's and the exact one; it runs the million-read
event and is timed on 64 such events and at the 16,384-read threshold
beside B1.

The last lines are ``{"kernels": [...]}`` -- per kernel, its launches in
the main-path runs (for B1w and B2w: the wide buckets' runs), its
largest difference from the plain version, both times at the main
path's bucket shape (B1w, B2w: the bucket of 512), and the least time
the card could
take for that launch (``bound_ms``: the larger of bytes over 3.35 TB/s
and operations over the FP32, integer and issue rates,
``reassign_bound``, ``marginal_bound`` and ``multinomial_bound``) -- and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import glob
import importlib.util
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

T_START = time.time()

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(ROOT, "miso_tpu_torch", "csrc")):
    sys.exit("chip_smoke: run it from a checkout of the repo (no "
             "miso_tpu_torch/csrc beside %s)" % os.path.basename(__file__))
sys.path.insert(0, ROOT)

from miso_tpu_torch import kernels  # noqa: E402
from miso_tpu_torch import pipeline as tp  # noqa: E402
from miso_tpu_torch.cli import compare as compare_cli  # noqa: E402
from miso_tpu_torch.cli import filter_events as filter_cli  # noqa: E402
from miso_tpu_torch.cli import module_availability  # noqa: E402
from miso_tpu_torch.cli import run_miso as run_miso_cli  # noqa: E402
from miso_tpu_torch.cli import summarize as summarize_cli  # noqa: E402
from miso_tpu_torch.cli import test_miso as test_miso_cli  # noqa: E402
from miso_tpu_torch.cli.main import main as miso_torch_main  # noqa: E402
from miso_tpu_torch.io.index import get_gene_ids_to_filenames  # noqa: E402
from miso_tpu_torch.io.settings import Settings  # noqa: E402
from miso_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from miso_tpu_torch.sampler import deep  # noqa: E402
from miso_tpu_torch.sampler import marginal_kernel as mk  # noqa: E402
from miso_tpu_torch.sampler import reassign_kernel as rk  # noqa: E402
from miso_tpu_torch.sampler import wide as wd  # noqa: E402
from miso_tpu_torch.sampler.mcmc import (  # noqa: E402
    EventBatch, SamplerConfig, batch_from_numpy)
from miso_tpu_torch.testing import (  # noqa: E402
    BINOMIAL_REGIMES, PAIRED_GENE, binomial_batch, binomial_chi2,
    binomial_moments, class_batch, deepened, exact_marginal_mean_2iso,
    WIDE_CLASS_SLOTS, indexed_catalog, lane_test_batch, marginal_lane_batch,
    multinomial_lane_batch, packed_events, pad_events, padded_batch,
    paired_event, simulate_catalog_bam, simulated_event, wide_class_batch,
    wide_event)

# tests/exact_posterior.py is numpy/scipy only
sys.path.insert(0, os.path.join(ROOT, "tests"))
from exact_posterior import exact_posterior_mean_2iso  # noqa: E402

DEV = "cuda"
# the mesh phase's mesh: the one card named twice, a stream for each
MESH = ("cuda:0", "cuda:0")
# fixed-uniform agreement of kernel and plain version: both are f32 and
# follow the same chain, differing only by rounding (the tolerances of
# tests/test_pallas_interpret.py)
PSI_ATOL, LL_ATOL, N_ATOL = 2e-4, 2e-3, 1e-5
STOCK = SamplerConfig()             # 5000 iters, burn-in 500, lag 10, 6 chains
STOCK_M = SamplerConfig(algorithm="marginal")
SE_GENE = ([100, 50, 100], [[1, 2, 3], [1, 3]])  # make_se_catalog's gene
G3_GENE = ([100, 50, 80, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]])
MAIN_E, MAIN_R = 2048, 320          # the 2,000-gene run's bucket: I=2, R=320
N_GENES = 2000
# the paired-end MARGINAL run that puts the plain version in the
# kernel's place takes a catalog of this many genes
PLAIN_GENES = 500
# the second sample of the compare phase: psi moved by this much (up
# where it was below 0.5, else down) in every other gene
MOVED_BY = 0.5
SMALL = dict(iters=24, burn_in=6, lag=3, chains=2)
PHILOX = dict(iters=1500, burn_in=300, lag=5, chains=4)
# the deep catalog: 16 genes whose 20,000 reads each pad to a bucket of
# 32,768 > pipeline.DEEP_READS, so REASSIGN takes the multinomial route
DEEP_GENES, DEEP_READS_PER_GENE = 16, 20000
# the threshold measurement: 64 events of ~16,000 reads, B1 at R=16,384
# against B3 on the same events
THRESH_E, THRESH_R = 64, 16384
# the 2,000-gene REASSIGN run's four launches (512, 1024, 3 and 461
# events, each padded to a power of two)
CHUNK_E = (512, 1024, 4, 512)
# each kernel's time at its main shape before its redesign (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md)
EARLIER_MS = {"reassign": 90.36, "marginal": 7.50}
EARLIER_CHUNKS_MS = 111.3    # the four launches together
EARLIER_THRESH_MS = 404.59   # R=16,384, E=64
# B2 at the shapes below with one thread per lane, the kernel before its
# lanes were spread over a warp's threads (NVIDIA H100 80GB HBM3,
# 700.00 W; this script's ``marginal`` mode on that tree), by the labels
# of marginal_shapes
EARLIER_B2_MS = {
    "main I=2 C=4 E=2048": 7.042, "chunk E=1024": 7.047,
    "chunk E=512": 7.043, "chunk E=4": 6.994,
    "classes I=4 C=32 E=2048": 6.101, "paired I=2 C=256 E=2048": 21.121,
    "I=8 C=24 E=2048": 7.643, "I=32 C=8 E=2048": 17.962,
    "main tile E=16384": 3.255}
# the widest instance of both narrow kernels, (I, real isoforms): held
# against the plain version in every layout
NARROW_ISO = ((64, 33),)
# the wide kernels B1w and B2w (csrc/wide_kernel.cu), (I, real
# isoforms): held against their plain versions in every plan; at the
# widest a lane's arrays are past a block's shared memory, in scratch
WIDE_CHECK_ISO = ((128, 70), (512, 300), (2048, 1100), (8192, 4500))
# B2w's narrowest bucket, 64 isoforms, 60 and 64 real (MARGINAL/CLASSES
# from wide.WIDE_FROM_MARGINAL)
MARGINAL_64 = ((64, 60), (64, 64))
# the wide buckets of the main path: four genes of each many isoforms,
# padded to a bucket of each width, through StreamRunner at stock
# settings; the kernel and its plain version are also timed side by side
# on the short schedule
WIDE_GENES = ((300, 512), (1100, 2048))
WIDE_SHORT = dict(iters=60, burn_in=20, lag=2, chains=2)
# the wide buckets (4 genes of 300 and of 1,100 isoforms, I = 512 and
# 2,048) at 5000 x 6 before each kernel's redesign: B1w reading (R, I)
# read tiles, and B2w with its rows in device memory (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md): not timed here
EARLIER_WIDE_MS = {"reassign": {512: 232.5, 2048: 772.6},
                   "marginal": {512: 33.57, 2048: 77.51}}
# wider tiles (E, R, I) at which every layout is timed beside the plan's
WIDE_SHAPES = ((2048, 320, 8), (512, 320, 8), (4, 320, 8), (2048, 1024, 8),
               (2048, 320, 16), (2048, 640, 4), (1024, 4096, 8),
               (2048, 320, 32), (1024, 16384, 2))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(name, got, ref, padding=None):
    """Kernel result against the plain version's; returns max |d psi|.
    ``padding`` (E,) marks padding events (no isoform): their
    log-likelihood may be non-finite, the same on both routes; every
    other value must be finite and agree."""
    got, ref = got.to_numpy(), ref.to_numpy()

    def err(a, b):
        # NaN or infinity in either fails the check below
        return np.abs(a - b).max(initial=0.0)

    ll_got, ll_ref = got.loglik.copy(), ref.loglik.copy()
    if padding is not None:
        rows = np.zeros(ll_got.shape, bool)
        rows[padding] = True
        same = rows & ~np.isfinite(ll_got) & (
            (ll_got == ll_ref) | (np.isnan(ll_got) & np.isnan(ll_ref)))
        ll_got[same] = ll_ref[same] = 0.0
    errs = {
        "psi": err(got.psi_samples, ref.psi_samples),
        "loglik": err(ll_got, ll_ref),
        "final_n": err(got.final_n, ref.final_n),
        "final_psi": err(got.final_psi, ref.final_psi),
    }
    ok = (errs["psi"] <= PSI_ATOL and errs["final_psi"] <= PSI_ATOL
          and errs["loglik"] <= LL_ATOL and errs["final_n"] <= N_ATOL
          and np.array_equal(got.accepted, ref.accepted))
    print("  %-40s max|dpsi| %.3g  max|dll| %.3g  max|dn| %.3g  "
          "accepted equal %s" % (name, errs["psi"], errs["loglik"],
                                 errs["final_n"],
                                 np.array_equal(got.accepted, ref.accepted)))
    if not ok:
        raise AssertionError("kernel disagrees with the plain version: %s"
                             % name)
    return float(errs["psi"])


def main_shape_batch(algorithm="reassign"):
    """MAIN_E events shaped like the 2,000-gene run's bucket for
    ``algorithm``: 64 simulated SE events (300 reads of 36 nt) tiled."""
    rng = np.random.default_rng(1)
    evs = [simulated_event(*SE_GENE, [p, 1.0 - p], 300, 36, seed=100 + i,
                           algorithm=algorithm)
           for i, p in enumerate(rng.uniform(0.05, 0.95, 64))]
    return padded_batch([evs[i % 64] for i in range(MAIN_E)], DEV,
                        pad_reads=MAIN_R)


def classes_sized_batch(E=64, C=32, I=4, num_iso=3):
    """E events of ``num_iso`` isoforms over C classes, the class count
    of a CLASSES event: row-normalised random weights, a quarter of the
    classes empty, random counts, and the last event a padding event."""
    rng = np.random.default_rng(5)
    w = np.zeros((E, C, I), np.float32)
    w[:, :, :num_iso] = rng.random((E, C, num_iso)) * (
        rng.random((E, C, num_iso)) < 0.6)
    w /= np.maximum(w.sum(-1, keepdims=True), 1e-30)
    counts = rng.integers(0, 40, (E, C)).astype(np.float32)
    counts[:, rng.random(C) < 0.25] = 0.0
    num_iso_v = np.full(E, num_iso, np.int32)
    w[-1], counts[-1], num_iso_v[-1] = 0.0, 0.0, 0
    batch, _ = batch_from_numpy(EventBatch(
        weights=w, log_read=np.zeros_like(w), counts=counts,
        log_iso_w=np.zeros((E, I)), hyper=np.ones((E, I)),
        num_iso=num_iso_v, read_w=np.zeros((E, 1, I)),
        read_logscore=np.zeros((E, 1, I))), DEV)
    return batch


def paired_batch():
    """Four paired-end events: fragment-probability weights, one class
    per fragment length."""
    return padded_batch(
        [paired_event(*PAIRED_GENE, [p, 1.0 - p], 400, 40, 250.0, 15.0,
                      seed=11 + i)
         for i, p in enumerate((0.6, 0.3, 0.8, 0.45))], DEV)


def both(seed, batch, cfg, start=None, fixed=None):
    """(kernel result, plain result) of REASSIGN or MARGINAL/CLASSES."""
    if cfg.algorithm == "reassign":
        ref = rk._reassign_plain(seed, batch, cfg, rk._event_consts(batch),
                                 start, fixed)
        got = rk.run_batch_reassign(seed, batch, cfg, start_psi=start,
                                    fixed_uniform=fixed)
    else:
        ref = mk._marginal_plain(seed, batch, cfg,
                                 mk._marginal_consts(batch), start, fixed)
        got = mk.run_batch_marginal(seed, batch, cfg, start_psi=start,
                                    fixed_uniform=fixed)
    torch.cuda.synchronize()
    return got, ref


def timed(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events (the
    earlier phases have run both routes at this shape: no warm-up)."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def dirichlet_start(num_iso, E, K, pad_iso=None):
    """(E, K, pad_iso) GIVEN start psi over ``num_iso`` real isoforms,
    seeded."""
    sp = np.zeros((E, K, pad_iso or num_iso), np.float32)
    sp[..., :num_iso] = np.random.default_rng(9).dirichlet(
        np.ones(num_iso), size=(E, K))
    return torch.from_numpy(sp).to(DEV)


def in_plan(seed, batch, cfg, plan, start=None, fixed=False):
    """The REASSIGN kernel in one layout of its launch plan."""
    return rk._reassign_cuda(seed, batch, cfg, rk._event_consts(batch),
                             start, fixed, plan=plan)


def tag(plan):
    return "T=%d %s" % (plan.T, plan.home)


def sliced(batch, E):
    """The first E events of a batch."""
    return EventBatch(*[t[:E].contiguous() for t in batch])


def tiled(batch, n):
    """A batch n times over: its events repeated along the event axis."""
    return EventBatch(*[t.repeat(n, *[1] * (t.dim() - 1)).contiguous()
                        for t in batch])


def reassign_layouts(big, big_ref, pb, gpu):
    """The REASSIGN kernel in every layout its plan can take: equal to
    the plain version under fixed uniforms, one Philox chain whatever
    the layout, and each layout's time.  Returns the numbers kept."""
    small = SamplerConfig(**SMALL)
    K = small.chains
    max_err = 0.0
    print("REASSIGN layouts, fixed uniforms (R=16 with padded reads, AUTO "
          "and GIVEN):")
    for I, num_iso in ((2, 2), (3, 3), (8, 5)) + NARROW_ISO:
        b = lane_test_batch(I, num_iso, I, DEV)
        consts = rk._event_consts(b)
        seen = set()
        for given in (False, True):
            start = dirichlet_start(num_iso, 2, K, I) if given else None
            ref = rk._reassign_plain(0, b, small, consts, start, rk.FIXED_U)
            for plan in rk.all_plans(*b.read_w.shape, K):
                got = in_plan(0, b, small, plan, start, True)
                torch.cuda.synchronize()
                max_err = max(max_err, compare(
                    "I=%d %s %s" % (I, "GIVEN" if given else "AUTO",
                                    tag(plan)), got, ref))
                seen.add((plan.T, plan.home))
        # every lane width in both homes
        every = {(T, h) for T in rk.LANE_THREADS for h in rk.HOMES}
        if seen != every:
            raise AssertionError("I=%d: layouts run %s" % (I, sorted(seen)))
    # deeper tiles: several groups of reads per thread
    print("REASSIGN layouts, fixed uniforms, paired-end R=%d and the main "
          "shape:" % pb.read_w.shape[1])
    ref = rk._reassign_plain(0, pb, small, rk._event_consts(pb), None,
                             rk.FIXED_U)
    for plan in rk.all_plans(*pb.read_w.shape, K):
        got = in_plan(0, pb, small, plan, None, True)
        torch.cuda.synchronize()
        max_err = max(max_err, compare("paired-end " + tag(plan), got, ref))
    E, R, I = big.read_w.shape
    plans = rk.all_plans(E, R, I, STOCK.chains)
    chosen = rk.launch_plan(E, R, I, STOCK.chains)
    if chosen.T >= 32 or chosen.home != "shared" or chosen not in plans:
        raise AssertionError("main shape plan: %s" % (chosen,))
    for plan in plans:
        got = in_plan(0, big, STOCK, plan, None, True)
        torch.cuda.synchronize()
        max_err = max(max_err, compare("main shape " + tag(plan), got,
                                       big_ref))
    # Philox: the chain does not depend on the layout
    print("REASSIGN layouts, Philox at the main shape (I=%d R=%d E=%d, "
          "%d x %d): psi, final_n and acceptance bit-equal to the chosen "
          "plan's (%s); times  [%s]" % (I, R, E, STOCK.iters, STOCK.chains,
                                        tag(chosen), gpu))
    first = in_plan(11, big, STOCK, chosen).to_numpy()
    layout_ms = {}
    for plan in plans:
        got = in_plan(11, big, STOCK, plan).to_numpy()
        same = (np.array_equal(got.psi_samples, first.psi_samples)
                and np.array_equal(got.final_n, first.final_n)
                and np.array_equal(got.accepted, first.accepted))
        dll = float(np.abs(got.loglik - first.loglik).max())
        ms = timed(lambda: in_plan(11, big, STOCK, plan), reps=2)
        layout_ms[tag(plan)] = ms
        print("  %-16s bit-equal %s  max|dll| %.3g  %8.2f ms  %d threads a "
              "block%s"
              % (tag(plan), same, dll, ms, plan.threads,
                 "  <- chosen" if plan == chosen else ""))
        if not same or dll > LL_ATOL:
            raise AssertionError("Philox chain depends on the layout: %s"
                                 % (plan,))
    # the main path's four launches, one after the other
    chunk_ms = [timed(lambda: rk.run_batch_reassign(3, sliced(big, e),
                                                    STOCK), reps=2)
                for e in CHUNK_E]
    print("REASSIGN at the main path's chunk sizes E=%s: %s ms, %.2f ms in "
          "all (earlier kernel: %.1f ms)  [%s]"
          % (list(CHUNK_E), ["%.2f" % m for m in chunk_ms], sum(chunk_ms),
             EARLIER_CHUNKS_MS, gpu))
    # every layout at every chunk size: what the plan's rule rests on
    print("REASSIGN ms by layout and E (stock schedule)  [%s]" % gpu)
    sizes = sorted(set(CHUNK_E))
    for plan in plans:
        row = [timed(lambda: in_plan(3, sliced(big, e), STOCK, plan), reps=2)
               for e in sizes]
        print("  %-16s %s" % (tag(plan), "  ".join(
            "E=%d %7.2f" % (e, m) for e, m in zip(sizes, row))))
    return {"max_err": max_err, "layout_ms": layout_ms,
            "chunk_ms": chunk_ms, "wide_ms": wide_layouts(gpu)}


def wide_layouts(gpu):
    """Every layout at tiles wider or deeper than the main shape's: I=8
    at three launch sizes (the plan takes T=4, 16 and 32 there), shapes
    where the narrowest lane's tiles would crowd an SM's shared memory
    and the plan widens the lane (I=8 at R=1024, I=32), and deep tiles
    of which an SM holds one (I=8 at R=4096, I=2 at R=16,384).  Returns
    {shape: {layout: ms}} and prints how far the chosen layout is from
    the fastest."""
    cfg = SamplerConfig(iters=1000, burn_in=100, lag=10, chains=6)
    out = {}
    print("REASSIGN ms by layout at wide tiles, %d x %d  [%s]"
          % (cfg.iters, cfg.chains, gpu))
    for E, R, I in WIDE_SHAPES:
        b = lane_test_batch(I, I - 3, 21, DEV, E=E, R=R)
        chosen = rk.launch_plan(E, R, I, cfg.chains)
        row = {}
        for plan in rk.all_plans(E, R, I, cfg.chains):
            in_plan(5, b, cfg, plan)
            row[tag(plan)] = timed(lambda: in_plan(5, b, cfg, plan), reps=2)
        best = min(row, key=row.get)
        out["I=%d R=%d E=%d" % (I, R, E)] = row
        print("  I=%d R=%d E=%d: %s; chosen %s %.2f ms, fastest %s %.2f ms "
              "(chosen / fastest %.3f)"
              % (I, R, E, ", ".join("%s %.2f" % kv for kv in row.items()),
                 tag(chosen), row[tag(chosen)], best, row[best],
                 row[tag(chosen)] / row[best]))
    return out


def dump_sass(entry, path):
    """Write the SASS of the kernel instance whose mangled name holds
    ``entry`` to ``path`` (``cuobjdump -sass`` of the built library), for
    counting a step's dependent chain by hand.  Returns the number of
    instructions."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        raise FileNotFoundError("no cuobjdump beside nvcc: %s" % tool)
    out = subprocess.run([tool, "-sass", kernels.LIB_PATH],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    body = [part for part in out.split("\t\tFunction : ")
            if part.split("\n", 1)[0].find(entry) >= 0]
    if len(body) != 1:
        raise AssertionError("cuobjdump: %d functions named %s"
                             % (len(body), entry))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(body[0])
    return len(re.findall(r"/\*[0-9a-f]{4}\*/", body[0]))


def m_plans(batch, K):
    """Every launch plan of the MARGINAL kernel at a batch's shape, and
    the chosen one."""
    E, C, I = batch.weights.shape
    return mk.all_marginal_plans(E, C, I, K), mk.marginal_plan(E, C, I, K)


def m_tag(plan):
    return "T=%d" % plan.T


def m_in_plan(seed, batch, cfg, plan, start=None, fixed=False, consts=None):
    """The MARGINAL kernel in one layout of its launch plan."""
    return mk._marginal_cuda(seed, batch, cfg,
                             consts or mk._marginal_consts(batch), start,
                             fixed, plan=plan)


def m_wrapper(name, batch, cfg, ref, start=None):
    """``run_batch_marginal`` itself (its checks, its constants, its own
    choice of plan) against a plain result under fixed uniforms."""
    got = mk.run_batch_marginal(0, batch, cfg, start_psi=start,
                                fixed_uniform=mk.FIXED_U)
    torch.cuda.synchronize()
    E, C, I = batch.weights.shape
    return compare("%s wrapper (%s)" % (name, m_tag(mk.marginal_plan(
        E, C, I, cfg.chains))), got, ref)


def marginal_shapes(big_m, pb):
    """[(label, batch, schedule)] at which the MARGINAL kernel is timed
    in every plan: the main shape and the main path's chunk sizes at the
    stock schedule, and at 1000 x 6 a CLASSES-sized event, a paired-end
    one (one class per fragment length), wider isoform counts and a
    launch eight times the main one; then 16 and 64 isoforms, where the
    plan caps the lane."""
    quick = dict(iters=1000, burn_in=100, lag=10, chains=6)
    E = big_m.weights.shape[0]
    shapes = [("main I=2 C=4 E=%d" % E, big_m, STOCK_M)]
    shapes += [("chunk E=%d" % e, sliced(big_m, e), STOCK_M)
               for e in sorted(set(CHUNK_E), reverse=True)]
    cfg_c = SamplerConfig(algorithm="classes", **quick)
    cfg_m = SamplerConfig(algorithm="marginal", **quick)
    paired = tiled(pb, E // pb.weights.shape[0])
    shapes += [
        ("classes I=4 C=32 E=%d" % E, classes_sized_batch(E=E), cfg_c),
        ("paired I=%d C=%d E=%d" % (paired.weights.shape[2],
                                    paired.weights.shape[1], E), paired,
         cfg_m),
        ("I=8 C=24 E=%d" % E, classes_sized_batch(E, 24, 8, 5), cfg_c),
        ("I=32 C=8 E=%d" % E, classes_sized_batch(E, 8, 32, 17), cfg_c),
        ("main tile E=%d" % (8 * E), tiled(big_m, 8), cfg_m),
        ("I=16 C=8 E=%d" % E, classes_sized_batch(E, 8, 16, 9), cfg_c),
        ("I=64 C=8 E=%d" % E, classes_sized_batch(E, 8, 64, 33), cfg_c)]
    return shapes


def marginal_layouts(big_m, pb, gpu):
    """The MARGINAL kernel in every plan it can be launched with: equal
    to the plain version under fixed uniforms, one Philox chain whatever
    the plan, and each plan's time at each shape.  Returns the numbers
    kept."""
    small_m = SamplerConfig(algorithm="marginal", **SMALL)
    K = small_m.chains
    m_err = 0.0
    print("MARGINAL plans, fixed uniforms (an empty class and a padding "
          "event; AUTO and GIVEN):")
    for I, num_iso in ((2, 2), (3, 3), (8, 5)) + NARROW_ISO:
        b = marginal_lane_batch(I, num_iso, I, DEV)
        consts = mk._marginal_consts(b)
        plans, _ = m_plans(b, K)
        for given in (False, True):
            start = None
            if given:
                start = dirichlet_start(num_iso, 2, K, I)
                start = torch.cat([start, torch.zeros_like(start[:1])])
            ref = mk._marginal_plain(0, b, small_m, consts, start,
                                     mk.FIXED_U)
            for plan in plans:
                got = m_in_plan(0, b, small_m, plan, start, True)
                torch.cuda.synchronize()
                m_err = max(m_err, compare(
                    "marginal I=%d %s %s" % (I, "GIVEN" if given else "AUTO",
                                             m_tag(plan)), got, ref))
            m_err = max(m_err, m_wrapper(
                "marginal I=%d %s" % (I, "GIVEN" if given else "AUTO"), b,
                small_m, ref, start))
    # class counts that T does not divide, and above the widest lane
    cfg_c = SamplerConfig(algorithm="classes", iters=400, burn_in=100,
                          lag=5, chains=4)
    for name, b, cfg in (
            ("classes I=4 C=5", classes_sized_batch(8, 5), cfg_c),
            ("classes I=4 C=40", classes_sized_batch(8, 40), cfg_c),
            ("classes I=4 C=32 E=64", classes_sized_batch(), cfg_c),
            ("marginal paired-end C=%d" % pb.weights.shape[1], pb, small_m),
            ("marginal main shape stock %dx%d" % (STOCK_M.iters,
                                                  STOCK_M.chains), big_m,
             STOCK_M)):
        consts = mk._marginal_consts(b)
        ref = mk._marginal_plain(0, b, cfg, consts, None, mk.FIXED_U)
        for plan in m_plans(b, cfg.chains)[0]:
            got = m_in_plan(0, b, cfg, plan, None, True)
            torch.cuda.synchronize()
            m_err = max(m_err, compare("%s %s" % (name, m_tag(plan)), got,
                                       ref))
        m_err = max(m_err, m_wrapper(name, b, cfg, ref))
    # the wrapper at the main path's chunk sizes, where the plan widens
    # the lane: under fixed uniforms an event's chain is its own, so the
    # main shape's plain result (the loop's last), cut to the chunk, is
    # the chunk's
    for e in sorted(set(CHUNK_E), reverse=True):
        m_err = max(m_err, m_wrapper(
            "marginal chunk E=%d stock" % e, sliced(big_m, e), STOCK_M,
            type(ref)(*[t[:e] for t in ref])))
    # Philox: the chain does not depend on the plan, and does on the seed
    Em, Cm, Im = big_m.weights.shape
    plans, chosen = m_plans(big_m, STOCK_M.chains)
    if chosen not in plans or not 1 < chosen.T < 32:
        raise AssertionError("main shape plan: %s" % (chosen,))
    print("MARGINAL plans, Philox at the main shape (I=%d C=%d E=%d, %d x "
          "%d): psi, loglik and acceptance bit-equal to the chosen plan's "
          "(%s)" % (Im, Cm, Em, STOCK_M.iters, STOCK_M.chains,
                    m_tag(chosen)))
    first = m_in_plan(11, big_m, STOCK_M, chosen).to_numpy()
    for plan in plans:
        got = m_in_plan(11, big_m, STOCK_M, plan).to_numpy()
        same = (np.array_equal(got.psi_samples, first.psi_samples)
                and np.array_equal(got.loglik, first.loglik)
                and np.array_equal(got.final_psi, first.final_psi)
                and np.array_equal(got.accepted, first.accepted))
        print("  %-12s bit-equal %s" % (m_tag(plan), same))
        if not same:
            raise AssertionError("Philox chain depends on the plan: %s"
                                 % (plan,))
    other = m_in_plan(12, big_m, STOCK_M, chosen).to_numpy()
    rate = first.accepted.sum() / (Em * STOCK_M.iters * STOCK_M.chains)
    if np.array_equal(other.psi_samples, first.psi_samples) \
            or not 0.05 < rate < 0.95:
        raise AssertionError("Philox chain: seed ignored or chain frozen "
                             "(acceptance %.3f)" % rate)
    # every plan's time at every shape, launcher alone (constants made
    # once); the chosen plan's time over the fastest
    print("MARGINAL ms by plan and shape (launcher alone)  [%s]" % gpu)
    shape_ms = {}
    for label, b, cfg in marginal_shapes(big_m, pb):
        consts = mk._marginal_consts(b)
        plans, chosen = m_plans(b, cfg.chains)
        row = {}
        for plan in plans:
            if b.weights.shape[2] > 32 and plan.T > 4:
                continue    # seconds a launch, and never the plan's choice
            m_in_plan(5, b, cfg, plan, consts=consts)
            row[m_tag(plan)] = timed(
                lambda: m_in_plan(5, b, cfg, plan, consts=consts), reps=3)
        best = min(row, key=row.get)
        shape_ms[label] = row
        earlier = EARLIER_B2_MS.get(label)
        print("  %s, %d x %d: %s; chosen %s %.3f ms, fastest %s %.3f ms "
              "(chosen / fastest %.3f)%s"
              % (label, cfg.iters, cfg.chains,
                 ", ".join("%s %.3f" % kv for kv in row.items()),
                 m_tag(chosen), row[m_tag(chosen)], best, row[best],
                 row[m_tag(chosen)] / row[best],
                 "" if earlier is None else "; one thread per lane %.3f ms"
                 % earlier))
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print("SM clock right after these launches, and its maximum: %s"
          % clocks)
    chunk_ms = [shape_ms["chunk E=%d" % e][m_tag(
        m_plans(sliced(big_m, e), STOCK_M.chains)[1])] for e in CHUNK_E]
    print("MARGINAL at the main path's chunk sizes E=%s: %s ms, %.2f ms in "
          "all  [%s]" % (list(CHUNK_E), ["%.2f" % m for m in chunk_ms],
                         sum(chunk_ms), gpu))
    return {"max_err": m_err, "shape_ms": shape_ms, "chunk_ms": chunk_ms,
            "plan": m_tag(m_plans(big_m, STOCK_M.chains)[1])}


class Launches:
    """Wraps the five kernels' CUDA launchers (B1, B2, B3 of the deep
    route, and the wide B1w and B2w) for one main-path run: CUDA-event
    times and GIVEN-start launches per kernel, and the launch counts read
    from each wrapper's own counter (B1w's and B2w's under "wide")."""

    NAMES = ("reassign", "marginal", "multinomial", "reassign_wide",
             "marginal_wide")

    def __init__(self):
        self.spans = {name: [] for name in self.NAMES}
        self.given = {name: 0 for name in self.NAMES}
        self.counts = None
        # each route's launch of the most events: its arguments
        self.largest = {}

    def _wrap(self, name, launch):
        def timed_launch(*args, **kw):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = launch(*args, **kw)
            t1.record()
            self.spans[name].append((t0, t1))
            start_psi = args[4] if len(args) > 4 else kw.get("start_psi")
            self.given[name] += start_psi is not None
            kept = self.largest.get(name)
            if kept is None or (args[1].weights.shape[0]
                                > kept[1].weights.shape[0]):
                self.largest[name] = args
            return out
        return timed_launch

    def __enter__(self):
        self._saved = (rk._reassign_cuda, mk._marginal_cuda,
                       deep._multinomial_cuda, rk._reassign_wide_cuda,
                       mk._marginal_wide_cuda)
        rk._reassign_cuda = self._wrap("reassign", rk._reassign_cuda)
        mk._marginal_cuda = self._wrap("marginal", mk._marginal_cuda)
        deep._multinomial_cuda = self._wrap("multinomial",
                                            deep._multinomial_cuda)
        rk._reassign_wide_cuda = self._wrap("reassign_wide",
                                            rk._reassign_wide_cuda)
        mk._marginal_wide_cuda = self._wrap("marginal_wide",
                                            mk._marginal_wide_cuda)
        for counts in (rk.LAUNCHES, mk.LAUNCHES, deep.LAUNCHES):
            for key in counts:
                counts[key] = 0
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        (rk._reassign_cuda, mk._marginal_cuda, deep._multinomial_cuda,
         rk._reassign_wide_cuda, mk._marginal_wide_cuda) = self._saved
        self.counts = {"reassign": dict(rk.LAUNCHES),
                       "marginal": dict(mk.LAUNCHES),
                       "multinomial": dict(deep.LAUNCHES)}
        return False

    def ms(self, name):
        return sum(a.elapsed_time(b) for a, b in self.spans[name])


def check_run(fix, out, name, gpu, wall, lc, packed=False, max_bias=0.06):
    """A main-path run's output: every event's .miso file (or, packed,
    its .miso_db entry) and the summary, and posterior means against the
    simulation truth.  Returns {event: header line}."""
    n = len(fix["true_psi"])
    headers = {}
    if packed:
        headers = {ev: h.split("\n", 1)[0]
                   for ev, (h, _) in packed_events(out).items()}
    for d, _, files in os.walk(out):
        for f in files:
            if f.endswith(".miso"):
                with open(os.path.join(d, f)) as fh:
                    headers[f[:-5]] = fh.readline().rstrip("\n")
    missing = {"ev%d" % e for e in range(n)} - set(headers)
    if missing or len(headers) != n:
        raise AssertionError("%s: %d events have no %s, %d files"
                             % (name, len(missing),
                                ".miso_db entry" if packed else ".miso",
                                len(headers)))
    summ = os.path.join(out, "summary", "%s.miso_summary"
                        % os.path.basename(out))
    with open(summ) as f:
        head = f.readline().rstrip("\n").split("\t")
        rows = [dict(zip(head, ln.rstrip("\n").split("\t")))
                for ln in f if ln.strip()]
    mean = {r["event_name"]: float(r["miso_posterior_mean"]) for r in rows}
    est = np.array([mean["ev%d" % e] for e in range(n)])
    truth = fix["true_psi"]
    corr = float(np.corrcoef(est, truth)[0, 1])
    bias = float(np.mean(est - truth))
    print("%s: %d events in %.2fs = %.1f events/s end to end; kernels "
          "%.1f ms (reassign) + %.1f ms (marginal) + %.1f ms (multinomial); "
          "launches %s; %d %s + summary (%d rows); truth corr %.4f, bias "
          "%+.4f  [%s]"
          % (name, n, wall, n / wall, lc.ms("reassign"), lc.ms("marginal"),
             lc.ms("multinomial"), lc.counts, len(headers),
             ".miso_db entries" if packed else ".miso files", len(rows),
             corr, bias, gpu))
    if not (corr > 0.9 and abs(bias) < max_bias):
        raise AssertionError("%s: posterior means miss the truth" % name)
    lc.bias = bias
    return headers


def plain_for_kernel(seed, batch, cfg, consts, start_psi, fixed, plan=None):
    """``_marginal_plain`` under ``_marginal_cuda``'s signature."""
    return mk._marginal_plain(seed, batch, cfg, consts, start_psi,
                              mk.FIXED_U if fixed else None)


def run_main_path(fix, tmp, name, flags, gpu, read_len=36, max_bias=0.06,
                  plain_marginal=False):
    """``miso --run`` through the port, its launches counted and timed and
    its output checked.  ``plain_marginal`` puts the plain version in the
    MARGINAL kernel's place, on the card: what the algorithm itself gives
    on this catalog.  Such a run must launch no kernel, every other one
    no plain version."""
    out = os.path.join(tmp, name)
    kernel = mk._marginal_cuda
    if plain_marginal:
        mk._marginal_cuda = plain_for_kernel
    try:
        with Launches() as lc:
            t = time.time()
            rc = miso_torch_main(["--run", fix["index"], fix["bam"],
                                  "--output-dir", out, "--read-len",
                                  str(read_len)] + flags)
            torch.cuda.synchronize()
            wall = time.time() - t
    finally:
        mk._marginal_cuda = kernel
    if rc != 0:
        raise AssertionError("miso_torch --run %s returned %d"
                             % (" ".join(flags), rc))
    unused = ("cuda", "wide") if plain_marginal else ("plain",)
    for kern in ("reassign", "marginal", "multinomial"):
        if any(lc.counts[kern].get(u, 0) != 0 for u in unused) or (
                plain_marginal and lc.counts["marginal"]["plain"] < 1):
            raise AssertionError("%s: %s launches %s"
                                 % (name, "/".join(unused), lc.counts))
    lc.wall = wall
    return lc, check_run(fix, out, name, gpu, wall, lc,
                         packed="--pack-output" in flags, max_bias=max_bias)


def header_field(header, key):
    return re.search(r"(?:^#|\t)%s=([^\t]*)" % key, header).group(1)


def compatible_reads(header):
    """The reads of a .miso header's ``counts=`` classes that are
    compatible with some isoform: those a final assignment places."""
    return sum(int(n) for t, n in re.findall(
        r"\(([\d,]+)\):(\d+)", header_field(header, "counts"))
        if "1" in t.split(","))


def settled(header):
    """A .miso header line without its chain-dependent fields."""
    return [x for x in header.lstrip("#").split("\t")
            if x.split("=", 1)[0] not in ("percent_accept",
                                          "assigned_counts")]


def three_iso(name, results, cfg):
    """A 3-isoform event: kernel and plain version agree on means and
    acceptance, and the chain is not frozen."""
    got, ref = (r.to_numpy() for r in results)
    m1 = got.flat_samples()[0].mean(axis=0)
    m2 = ref.flat_samples()[0].mean(axis=0)
    a1 = float(got.accepted[0]) / (cfg.iters * cfg.chains)
    a2 = float(ref.accepted[0]) / (cfg.iters * cfg.chains)
    print("%s 3-isoform: kernel means %s acc %.3f; plain means %s acc %.3f"
          % (name, np.array2string(m1, precision=4), a1,
             np.array2string(m2, precision=4), a2))
    if not (np.all(np.abs(m1 - m2) < 0.03) and abs(a1 - a2) < 0.06
            and a1 > 0.05):
        raise AssertionError("%s: 3-isoform kernel disagrees with plain"
                             % name)


def threshold_events(scale=8):
    """THRESH_E events of 2,000 reads, each class count times ``scale``:
    16,000 reads each at the default, just under pipeline.DEEP_READS."""
    rng = np.random.default_rng(3)
    return [deepened(simulated_event(*SE_GENE, [p, 1.0 - p], 2000, 36,
                                     seed=300 + i), scale)
            for i, p in enumerate(rng.uniform(0.05, 0.95, THRESH_E))]


def threshold_times(thr_rb, gpu):
    """{home: ms} of the REASSIGN kernel at R=16,384 on THRESH_E events,
    stock schedule, in each home its lane width can take."""
    E, R, I = thr_rb.read_w.shape
    chosen = rk.launch_plan(E, R, I, STOCK.chains)
    out = {}
    for plan in rk.all_plans(E, R, I, STOCK.chains):
        if plan.T != chosen.T:
            continue
        in_plan(5, thr_rb, SamplerConfig(iters=10, burn_in=0, lag=5), plan)
        out[plan.home] = timed(lambda: in_plan(5, thr_rb, STOCK, plan),
                               reps=1)
    print("REASSIGN at R=%d E=%d, %d x %d: %s; chosen %s (earlier kernel: "
          "%.2f ms)  [%s]"
          % (R, E, STOCK.iters, STOCK.chains,
             ", ".join("%s %.2f ms" % kv for kv in out.items()), tag(chosen),
             EARLIER_THRESH_MS, gpu))
    return out


# what a host process of the multi-host phase runs: the CLI's main(), then
# its own launch counters on a line the parent reads
HOST_PROGRAM = """
import json, sys
from miso_tpu_torch.cli.main import main
from miso_tpu_torch.sampler import reassign_kernel as rk
rc = main(sys.argv[1:])
print("LAUNCHES " + json.dumps(rk.LAUNCHES))
sys.exit(rc)
"""


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def host_processes(fix, out, num_hosts):
    """``miso_torch --run`` in ``num_hosts`` processes started together on
    the one card, all writing into ``out``: with more than one, each gets
    ``--coordinator 127.0.0.1:PORT --num-hosts N --host-id k``.  Returns
    (seconds from the first start to the last exit, [each one's output]);
    raises if one fails, and leaves none running."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    port = free_port()
    procs = []
    t = time.time()
    try:
        for hid in range(num_hosts):
            flags = [] if num_hosts == 1 else [
                "--coordinator", "127.0.0.1:%d" % port,
                "--num-hosts", str(num_hosts), "--host-id", str(hid)]
            procs.append(subprocess.Popen(
                [sys.executable, "-c", HOST_PROGRAM, "--run", fix["index"],
                 fix["bam"], "--output-dir", out, "--read-len", "36"]
                + flags, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outputs = [p.communicate(timeout=600)[0] for p in procs]
        wall = time.time() - t
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for hid, (p, o) in enumerate(zip(procs, outputs)):
        if p.returncode != 0:
            raise AssertionError("host %d of %d exited %d:\n%s"
                                 % (hid, num_hosts, p.returncode, o[-4000:]))
    return wall, outputs


def host_report(output):
    """(events quantified, the run's own seconds, device, B1 launches,
    plain launches, genes of the shard or None) from one host's output."""
    m = re.search(r"Quantified (\d+) events \(\d+ skipped\) in ([\d.]+)s "
                  r"on (\S+)", output)
    counts = json.loads(re.search(r"^LAUNCHES (.*)$", output, re.M).group(1))
    shard = re.search(r"Host shard: (\d+) genes", output)
    return (int(m.group(1)), float(m.group(2)), m.group(3), counts["cuda"],
            counts["plain"], None if shard is None else int(shard.group(1)))


def summary_rows(path):
    with open(path) as f:
        return f.readline(), [ln for ln in f if ln.strip()]


def two_hosts(fix, tmp, lc_r, gpu, reps=1):
    """Two host processes on one card into one tree, beside one process
    alone; ``reps`` times over, in turns, for the spread of the walls.
    Returns the first merged tree."""
    ratios = []
    for rep in range(reps):
        alone_wall, (alone_out,) = host_processes(
            fix, os.path.join(tmp, "one_host_%d" % rep), 1)
        alone = host_report(alone_out)
        out = os.path.join(tmp, "two_hosts" + ("_%d" % rep if rep else ""))
        pair_wall, outputs = host_processes(fix, out, 2)
        reports = [host_report(o) for o in outputs]
        shards = [r[5] for r in reports]
        if (alone[0] != N_GENES or alone[5] is not None or None in shards
                or min(shards) < 1 or sum(shards) != N_GENES
                or [r[0] for r in reports] != shards):
            raise AssertionError("host shards: alone %s, pair %s"
                                 % (alone, reports))
        for n, _, dev, b1, plain, _ in reports + [alone]:
            if not dev.startswith("cuda") or b1 < 1 or plain != 0:
                raise AssertionError("a host did not run B1 on the card: %s"
                                     % ((n, dev, b1, plain),))
        files = glob.glob(os.path.join(out, "chr*", "*.miso"))
        per_host = sorted(glob.glob(os.path.join(out, "summary",
                                                 "*.host*.miso_summary")))
        names = [ln.split("\t", 1)[0] for f in per_host
                 for ln in summary_rows(f)[1]]
        if (len(files) != N_GENES or len(per_host) != 2 or sorted(names)
                != sorted("ev%d" % e for e in range(N_GENES))):
            raise AssertionError("two hosts: %d .miso files, summaries %s "
                                 "with %d rows" % (len(files), per_host,
                                                   len(names)))
        ratios.append((max(r[1] for r in reports) / alone[1],
                       pair_wall / alone_wall))
        print("two hosts, one card: shards %s, B1 launches %s; each host's "
              "own run %s s, the pair from first start to last exit %.2fs; "
              "one such process alone: run %.2fs, start to exit %.2fs; the "
              "one-host REASSIGN run inside this process %.2fs  [%s]"
              % (shards, [r[3] for r in reports],
                 ["%.2f" % r[1] for r in reports], pair_wall, alone[1],
                 alone_wall, lc_r.wall, gpu))
        for o in outputs + [alone_out]:
            print("    " + re.search(r"^Quantified .*$", o, re.M).group(0))
    print("two hosts over one, %d time(s) in turns: the slower host's run %s "
          "of the lone process's, the pair's wall %s of the lone process's"
          % (reps, ["%.3f" % a for a, _ in ratios],
             ["%.3f" % b for _, b in ratios]))
    return os.path.join(tmp, "two_hosts")


def staged(name, fn, argv):
    """A host CLI of the port, timed; raises unless it returns 0."""
    t = time.time()
    rc = fn(argv)
    if rc != 0:
        raise AssertionError("%s %s returned %d" % (name, " ".join(argv), rc))
    return time.time() - t


def users_path(fix, tmp, merged, gpu):
    """run -> summarize -> compare -> filter: a second sample over the
    same genes with psi moved by MOVED_BY in every other gene runs on the
    card; the port's summarize CLI reads the merged two-host tree, its
    compare CLI both trees, its filter the Bayes factors."""
    truth = fix["true_psi"]
    moved = np.arange(N_GENES) % 2 == 0
    psi2 = np.where(moved, np.where(truth < 0.5, truth + MOVED_BY,
                                    truth - MOVED_BY), truth)
    t = time.time()
    bam2 = os.path.join(tmp, "sample2.bam")
    simulate_catalog_bam(fix["genes"], psi2, 300, 36, bam2,
                         np.random.default_rng(17))
    build_s = time.time() - t
    fix2 = dict(fix, bam=bam2, true_psi=psi2)
    lc2, _ = run_main_path(fix2, tmp, "sample2", [], gpu)
    # summarize the merged two-host tree: the union of the hosts' rows
    summ_dir = os.path.join(tmp, "summarized")
    summ_s = staged("summarize", summarize_cli.main,
                    ["--summarize-samples", merged, summ_dir])
    head, rows = summary_rows(os.path.join(
        summ_dir, "summary", "two_hosts.miso_summary"))
    union = []
    for f in sorted(glob.glob(os.path.join(merged, "summary",
                                           "*.host*.miso_summary"))):
        h, r = summary_rows(f)
        if h != head:
            raise AssertionError("summary headers differ: %s" % f)
        union += r
    if len(rows) != N_GENES or sorted(rows) != sorted(union):
        raise AssertionError("summarize: %d rows, the hosts' %d; equal %s"
                             % (len(rows), len(union),
                                sorted(rows) == sorted(union)))
    cmp_dir = os.path.join(tmp, "compared")
    sample2 = os.path.join(tmp, "sample2")
    cmp_s = staged("compare", compare_cli.main,
                   ["--compare-samples", merged, sample2, cmp_dir])
    bf_file = os.path.join(cmp_dir, "two_hosts_vs_sample2", "bayes-factors",
                           "two_hosts_vs_sample2.miso_bf")
    _, bf_rows = filter_cli.read_bf_file(bf_file)
    by_event = {r["event_name"]: r for r in bf_rows}
    if len(bf_rows) != N_GENES or len(by_event) != N_GENES:
        raise AssertionError(".miso_bf: %d rows" % len(bf_rows))
    diff = np.array([float(by_event["ev%d" % e]["diff"])
                     for e in range(N_GENES)])
    bf = np.array([float(by_event["ev%d" % e]["bayes_factor"])
                   for e in range(N_GENES)])
    # sample 1 - sample 2: the moved genes' diff is -+MOVED_BY
    want = np.where(truth < 0.5, -MOVED_BY, MOVED_BY)
    found = moved & (np.abs(diff) > 0.35) & (np.sign(diff) == np.sign(want)) \
        & (bf > 20)
    quiet = ~moved & (np.abs(diff) < 0.3)
    filt_dir = os.path.join(tmp, "filtered")
    filt_s = staged("filter_events", filter_cli.main,
                    ["--filter", bf_file, "--output-dir", filt_dir,
                     "--bayes-factor", "20", "--delta-psi", "0.3"])
    _, kept_rows = filter_cli.read_bf_file(os.path.join(
        filt_dir, "two_hosts_vs_sample2.miso_bf.filtered"))
    kept = np.zeros(N_GENES, bool)
    kept[[int(r["event_name"][2:]) for r in kept_rows]] = True
    print("run -> summarize -> compare -> filter: second sample built in "
          "%.2fs, run %.2fs, summarize %.2fs (%d rows = the two hosts' "
          "rows), compare %.2fs (%d rows), filter %.2fs; moved genes with "
          "|diff| > 0.35, its sign and Bayes factor > 20: %d of %d; unmoved "
          "with |diff| < 0.3: %d of %d; the filter keeps %d moved and %d "
          "unmoved  [%s]"
          % (build_s, lc2.wall, summ_s, len(rows), cmp_s, len(bf_rows),
             filt_s, found.sum(), moved.sum(), quiet.sum(), (~moved).sum(),
             (kept & moved).sum(), (kept & ~moved).sum(), gpu))
    # a diff is the difference of two posterior means from 300 reads each
    # (sd ~0.07): 0.35 lies ~2 sd under MOVED_BY and 0.3 ~4 sd above 0,
    # so not every one of 1,000 genes can be asked for
    if not (found.sum() >= 0.95 * moved.sum()
            and quiet.sum() >= 0.99 * (~moved).sum()
            and (kept & moved).sum() >= 0.95 * moved.sum()
            and (kept & ~moved).sum() <= 0.01 * (~moved).sum()):
        raise AssertionError("compare / filter miss the moved genes")
    return lc2


def worker_cli(fix, tmp, heads_r, gpu):
    """``run_miso.py --compute-gene-psi`` on the card for a handful of
    genes: B1 launches, no plain version, and each header equal to the
    ``--run`` one's but for its chain-dependent fields."""
    out = os.path.join(tmp, "run_miso")
    pickles = get_gene_ids_to_filenames(fix["index"])
    genes = ["ev%d" % e for e in sorted({0, 7, N_GENES // 48,
                                         N_GENES // 2 - 1, N_GENES - 2})]
    with Launches() as lc:
        t = time.time()
        for gene in genes:
            staged("run_miso.py", run_miso_cli.main,
                   ["--compute-gene-psi", gene, pickles[gene], fix["bam"],
                    out, "--read-len", "36"])
        wall = time.time() - t
    if lc.counts["reassign"]["cuda"] < len(genes) \
            or lc.counts["reassign"]["plain"] != 0:
        raise AssertionError("run_miso.py launches: %s" % lc.counts)
    for gene in genes:
        (path,) = glob.glob(os.path.join(out, "chr*", gene + ".miso"))
        with open(path) as f:
            if settled(f.readline().rstrip("\n")) != settled(heads_r[gene]):
                raise AssertionError("run_miso.py header of %s differs from "
                                     "the --run one's" % gene)
    print("run_miso.py --compute-gene-psi: %d genes in %.2fs, B1 launches "
          "%d, plain 0, headers equal to the --run ones (chain-dependent "
          "fields aside)  [%s]" % (len(genes), wall,
                                   lc.counts["reassign"]["cuda"], gpu))
    return lc


def wide_two_iso(algorithm, width):
    """Eight copies of a two-isoform event of 2,000 reads in a bucket of
    ``width`` isoforms, and its grid-exact posterior mean."""
    ev = simulated_event(*SE_GENE, [0.7, 0.3], 2000, 25, seed=42,
                         algorithm=algorithm)
    exact = (exact_posterior_mean_2iso(ev) if algorithm == "reassign"
             else exact_marginal_mean_2iso(ev))
    batch, _ = batch_from_numpy(pad_events(
        [ev] * 8, pad_iso=width, read_dtype=np.float32), DEV)
    return batch, exact


def wide_case(kind, I, num_iso):
    """(batch, consts, plans, launcher, plain version) of a wide kernel's
    check: B1w on ``lane_test_batch`` (E=2, R=16 with padding reads), B2w
    on ``marginal_lane_batch`` (E=3 with a padding event, C=5 with an
    empty class)."""
    if kind == "reassign":
        b = lane_test_batch(I, num_iso, I, DEV)
        return (b, rk._event_consts(b), rk.all_wide_plans(2, 16, I, 2),
                rk._reassign_wide_cuda, rk._reassign_plain)
    b = marginal_lane_batch(I, num_iso, I, DEV, C=5)
    return (b, mk._marginal_consts(b), mk.all_wide_plans(3, 5, I, 2),
            mk._marginal_wide_cuda, mk._marginal_plain)


def bit_equal(name, got, ref):
    """Raise unless two results are equal to the bit; returns 0.0 (the
    largest difference)."""
    diff = bitwise(got.to_numpy(), ref.to_numpy())
    print("  %-40s bit-equal %s" % (name, not any(diff.values())))
    if any(diff.values()):
        raise AssertionError("%s: not bit-equal to the plain version %s"
                             % (name, diff))
    return 0.0


def expanded(batch, R):
    """A class batch with its read tiles of R slots, as the plain
    version reads it."""
    rw, rls = rk.expand_read_tensors(batch.weights, batch.log_read,
                                     batch.counts, R)
    return batch._replace(read_w=rw, read_logscore=rls)


# 12 classes in 20 read slots, some of 2 and 3 reads: more classes than
# half the slots, so B1w walks every read (wide.walks)
WALK_COUNTS = ((2, 1, 1, 0, 3, 1, 1, 1, 2, 1, 1, 1),
               (1, 3, 1, 1, 1, 2, 0, 1, 1, 1, 1, 2))


def b1w_class_check(cfg):
    """B1w on class tensors (``wide_class_batch``: 7 classes in 20 read
    slots, a class of no reads, one of zero weights whose reads straddle
    two groups of four, padding reads), as run_sampler hands a wide
    bucket over, against the plain version on the expanded tiles, to the
    bit, at WIDE_CHECK_ISO: every block width, the lane arrays in
    scratch, and tables of many tiles (2 rows a tile, and 1 in
    scratch), from AUTO and GIVEN starts, also at 384 isoforms (rows of
    three chunks, a warp's fourth slot idle); and at 512 isoforms a
    launch of more classes than half its slots, whose reads walk."""
    K, R = cfg.chains, WIDE_CLASS_SLOTS
    print("reassign wide kernel on classes, fixed uniforms, every plan:")
    for (I, num_iso), counts in [(w, None) for w in WIDE_CHECK_ISO] + [
            ((384, 250), None), (WIDE_CHECK_ISO[1], WALK_COUNTS)]:
        b = wide_class_batch(I, num_iso, I, DEV,
                             *([] if counts is None else [counts]))
        E, C, _ = b.weights.shape
        tiles = expanded(b, R)
        consts = rk._event_consts(b)
        plans = rk.all_wide_plans(E, R, I, K, classes=C)
        plans += [p._replace(shared_bytes=0) for p in plans if p.shared_bytes]
        plans += [wd.tiled(plans[0], R, I, 2),
                  wd.tiled(plans[2], R, I, 1)._replace(shared_bytes=0)]
        for given in (False, True):
            start = dirichlet_start(num_iso, E, K, I) if given else None
            ref = rk._reassign_plain(0, tiles, cfg, consts, start,
                                     rk.FIXED_U)
            for plan in plans:
                got = rk._reassign_wide_cuda(0, b, cfg, consts, start, True,
                                             plan=plan, pad_reads=R)
                torch.cuda.synchronize()
                bit_equal("classes I=%d (%d real) C=%d %s threads=%d "
                          "rows=%d %s" % (
                              I, num_iso, C, "GIVEN" if given else "AUTO",
                              plan.threads, plan.rows,
                              "shared" if plan.shared_bytes else "scratch"),
                          got, ref)
        if I != 512 or counts is not None:
            continue
        # one Philox chain: every plan, and the expanded tiles alike
        short = SamplerConfig(**WIDE_SHORT)
        first = rk._reassign_wide_cuda(7, tiles, short, consts, None, False)
        for plan in plans:
            bit_equal("classes I=512 Philox threads=%d rows=%d %s" % (
                plan.threads, plan.rows,
                "shared" if plan.shared_bytes else "scratch"),
                rk._reassign_wide_cuda(7, b, short, consts, None, False,
                                       plan=plan, pad_reads=R), first)


def b2w_at_64(cfg):
    """C.4 on the card: MARGINAL and CLASSES buckets of 64 isoforms (60
    and 64 real) go to B2w through the wrapper, equal the plain version
    in B2w's order, and accept every fixed-uniform step, as the JAX
    kernel and the f64 replica do (B2's order accepted 18 and 26 of
    48)."""
    for algorithm in ("marginal", "classes"):
        c = SamplerConfig(algorithm=algorithm, **SMALL)
        for real in (60, 64):
            b = marginal_lane_batch(64, real, 64, DEV)
            before = dict(mk.LAUNCHES)
            got = mk.run_batch_marginal(0, b, c, fixed_uniform=mk.FIXED_U)
            torch.cuda.synchronize()
            went = {k: mk.LAUNCHES[k] - before[k] for k in before}
            ref = mk._marginal_plain(0, b, c, mk._marginal_consts(b), None,
                                     mk.FIXED_U, wide_order=True)
            compare("%s I=64 (%d real) through the wrapper" % (
                algorithm, real), got, ref)
            accepted = got.accepted[:2].cpu().tolist()
            print("    launches %s, accepted %s of %d each" % (
                went, accepted, c.iters * c.chains))
            if went != {"cuda": 0, "wide": 1, "plain": 0} or accepted != [
                    c.iters * c.chains] * 2:
                raise AssertionError("%s at I=64 (%d real): not B2w or not "
                                     "the reference's chain" % (algorithm,
                                                                real))


def wide_plans_check():
    """B1w and B2w against their plain versions (the wide summing order)
    under fixed uniforms in every plan (every block width; B2w also every
    cluster size and home of its class rows) and with the lane arrays
    forced into scratch, from AUTO and GIVEN starts, at WIDE_CHECK_ISO
    (the widest past shared memory: every plan in scratch; B2w also at
    64 isoforms, 60 and 64 real) -- B1w to the bit, on read tiles (a
    class a read: C = R) and on class tensors, in tables of one and of
    many tiles; B2w's too -- then one Philox
    chain in every plan at 512 isoforms; then the MARGINAL and CLASSES
    buckets of 64 isoforms on B2w.  B2w's plans are its plain version to
    the bit too (its every plan to the first, the first to the plain
    version).  Returns {kind: largest |d psi|}."""
    small = SamplerConfig(**SMALL)
    K = small.chains
    errs = {}
    for kind in ("reassign", "marginal"):
        cfg = SamplerConfig(algorithm=kind, **SMALL)
        errs[kind] = 0.0
        print("%s wide kernel, fixed uniforms, every plan:" % kind)
        widths = WIDE_CHECK_ISO if kind == "reassign" else (
            MARGINAL_64 + WIDE_CHECK_ISO)
        equal_to_plain = 0
        for I, num_iso in widths:
            b, consts, plans, launch, plain = wide_case(kind, I, num_iso)
            if I == WIDE_CHECK_ISO[-1][0] and any(p.shared_bytes
                                                  for p in plans):
                raise AssertionError("I=%d fits shared memory" % I)
            plans = plans + [p._replace(shared_bytes=0) for p in plans
                             if p.shared_bytes]
            E = b.weights.shape[0]
            for given in (False, True):
                start = None
                if given:
                    start = dirichlet_start(num_iso, 2, K, I)
                    start = torch.cat([start, torch.zeros_like(
                        start[:E - 2])])
                # (at 64 isoforms the plain version's default order is
                # B2's: B2w's is asked for)
                ref = plain(0, b, cfg, consts, start, rk.FIXED_U,
                            wide_order=True)
                first = None
                for plan in plans:
                    got = launch(0, b, cfg, consts, start, True, plan=plan)
                    torch.cuda.synchronize()
                    name = "I=%d (%d real) %s %s %s" % (
                        I, num_iso, "GIVEN" if given else "AUTO",
                        wide_tag(plan),
                        "shared" if plan.shared_bytes else "scratch")
                    errs[kind] = max(errs[kind], compare(name, got, ref))
                    if kind == "reassign":
                        bit_equal(name, got, ref)
                    elif first is None:
                        first = got
                        equal_to_plain += not any(bitwise(
                            got.to_numpy(), ref.to_numpy()).values())
                    else:
                        bit_equal(name + " (to the first plan)", got, first)
        if kind == "marginal":
            print("  B2w bit-equal to its plain version in %d of %d "
                  "(width, start) cases; every plan bit-equal to the "
                  "first" % (equal_to_plain, 2 * len(widths)))
            if equal_to_plain != 2 * len(widths):
                raise AssertionError("B2w is not its plain version to the "
                                     "bit")
        if kind == "reassign":
            b1w_class_check(cfg)
        b, consts, plans, launch, _ = wide_case(kind, 512, 300)
        short = SamplerConfig(algorithm=kind, **WIDE_SHORT)
        first = None
        for plan in plans + [plans[0]._replace(shared_bytes=0)]:
            got = launch(7, b, short, consts, None, False,
                         plan=plan).to_numpy()
            if first is None:
                first = got
            elif bitwise(got, first) != {f: 0.0 for f in got._fields}:
                raise AssertionError("%s wide kernel: the Philox chain "
                                     "depends on the plan %s" % (kind, plan))
        print("  Philox at I=512, %d x %d: bit-equal in every plan (%d)"
              % (short.iters, short.chains, len(plans) + 1))
    b2w_at_64(small)
    return errs


def wide_tag(plan):
    """A wide plan's block width and, for B2w, its cluster and the home
    of its class rows."""
    if plan.rows:
        return "threads=%d rows=%d" % (plan.threads, plan.rows)
    return "threads=%d cluster=%d rows in %s" % (plan.threads, plan.cluster,
                                                 plan.weights)


def no_tiles(*args):
    raise AssertionError("a wide REASSIGN bucket expanded its read tiles")


# B2w's step breakdown and its barrier probe (the enums of
# csrc/wide_kernel.cu's -DMISO_B2W_CLOCKS build)
B2W_CLOCK_SLOTS = kernels.source_enum("B2wClock", "wide_kernel.cu")
B2W_LATENCY_SLOTS = kernels.source_enum("B2wLatency", "wide_kernel.cu")


def wide_bucket_batch(algorithm, gene_iso):
    """The wide bucket of four genes of ``gene_iso`` isoforms
    (``wide_event``, seeds 3 ... 6), padded as ``wide_buckets`` pads it
    for the plain version."""
    return padded_batch([wide_event(algorithm, num_iso=gene_iso, seed=3 + j)
                         for j in range(4)], DEV)


def b2w_breakdown(label, batch, gpu, plan=None, seed=3):
    """One stock launch of B2w's step-breakdown build (kernels.
    load_b2w_clocks, in the production build's place for that launch
    only), in ``plan`` (default: the wrapper's): clocks per step in each
    phase on each lane's first thread (``Wait``: its waits at the
    barriers of the phases other than the class terms'), and ``Rows``,
    the class rows on the first thread of the lane's last warp, beside
    it.  The stamps slow the launch; its time is printed beside the
    phases."""
    lib = kernels.load_b2w_clocks()
    sums = np.zeros(len(B2W_CLOCK_SLOTS), np.uint64)
    kernels.check(lib, lib.miso_marginal_wide_clocks(sums.ctypes.data),
                  "clearing B2w's step breakdown")
    consts = mk._marginal_consts(batch)
    E, C, I = batch.weights.shape
    if plan is None:
        plan = mk.wide_plan(E, C, I, STOCK_M.chains)
    saved = kernels.load
    kernels.load = lambda: lib
    try:
        ms = timed(lambda: mk._marginal_wide_cuda(
            seed, batch, STOCK_M, consts, None, False, plan=plan), reps=1)
    finally:
        kernels.load = saved
    kernels.check(lib, lib.miso_marginal_wide_clocks(sums.ctypes.data),
                  "reading B2w's step breakdown")
    v = dict(zip(B2W_CLOCK_SLOTS, sums.astype(np.float64)))
    steps = v["kB2Steps"]
    phases = {k[3:]: float(v[k] / steps) for k in B2W_CLOCK_SLOTS
              if k != "kB2Steps"}
    # the first thread's chain (the class rows' warp runs beside it)
    step = sum(x for k, x in phases.items() if k != "Rows")
    out = {"instrumented_ms": ms, "clocks_per_step": phases,
           "step_clocks": step, "plan": list(plan),
           "implied_mhz": step * STOCK_M.iters / (ms * 1e-3) / 1e6}
    print("B2w step breakdown, %s (E=%d C=%d I=%d, plan %s; the "
          "instrumented build, %.2f ms, implies %.0f MHz): clocks a step "
          "%s = %.0f  [%s]" % (label, E, C, I, tuple(plan), ms,
                               out["implied_mhz"],
                               {k: round(x, 1) for k, x in phases.items()},
                               step, gpu))
    return out


def b2w_latencies(gpu, reps=4096):
    """The probe of B2w's step-breakdown build: clocks a barrier (a block
    of 32 and of 512 threads, clusters of 2, 4 and 8 blocks, and a
    cluster of 4 whose blocks each store into the next one's shared
    memory before it)."""
    lib = kernels.load_b2w_clocks()
    out = torch.zeros(len(B2W_LATENCY_SLOTS), dtype=torch.float64,
                      device=DEV)
    kernels.check(lib, lib.miso_wide_latencies(out.data_ptr(), reps),
                  "B2w's barrier probe")
    torch.cuda.synchronize()
    lat = {k[4:]: round(x, 2) for k, x in zip(B2W_LATENCY_SLOTS,
                                              out.cpu().tolist())}
    print("barrier latencies, clocks a barrier (%d in a row): %s  [%s]"
          % (reps, lat, gpu))
    return lat


def b2w_phase(gpu):
    """B2w's step breakdown at both wide buckets (MARGINAL, 4 genes of
    300 and of 1,100 isoforms) and the barrier probe."""
    t0 = time.time()
    out = {}
    for gene_iso, width in WIDE_GENES:
        b = wide_bucket_batch("marginal", gene_iso)
        out["I=%d" % width] = b2w_breakdown("bucket of %d" % width, b, gpu)
    out["latencies"] = b2w_latencies(gpu)
    print("B2w's breakdown and probe: %.1fs (the step-breakdown build: "
          "nvcc %s s)" % (time.time() - t0,
                          kernels.B2W_CLOCKS_BUILD_INFO["seconds"]))
    return out


def wide_buckets(gpu):
    """Buckets of 512 and 2,048 isoforms (four genes of 300 and of 1,100
    isoforms) through StreamRunner on the card at stock settings,
    REASSIGN then MARGINAL: each one launch of the wide kernel and of
    nothing else, psi summing to one; REASSIGN's with the read-tile
    expansion taken away (B1w reads the bucket's classes).  The wide
    kernel is then held against its plain version on the bucket's own
    events under fixed uniforms (B1w to the bit, on the bucket's class
    tensors and on its read tiles: a class a read, C = R), timed beside
    it (short schedule; at 512 isoforms at stock too, with its bounds:
    B1w's for the class form it runs and for the reads' walks), and with
    Philox draws held against the exact posterior of a two-isoform event
    padded to the bucket's width.  Returns {algorithm: the numbers
    kept}."""
    out = {}
    for algorithm in ("reassign", "marginal"):
        mod = rk if algorithm == "reassign" else mk
        run = rk.run_batch_reassign if mod is rk else mk.run_batch_marginal
        stock = SamplerConfig(algorithm=algorithm)
        row = {"launches": 0, "max_err": 0.0}
        for gene_iso, width in WIDE_GENES:
            evs = [wide_event(algorithm, num_iso=gene_iso, seed=3 + j)
                   for j in range(4)]
            key = tp._bucket_key(evs[0])
            cfg = tp.RunConfig(read_len=25, algorithm=algorithm)
            saved = rk.expand_read_tensors
            rk.expand_read_tensors = no_tiles
            try:
                with Launches() as lc:
                    t = time.time()
                    results = tp.run_events(evs, cfg, seed=0, device=DEV)
                    wall = time.time() - t
            finally:
                rk.expand_read_tensors = saved
            sums = np.array([r["samples"][:, :gene_iso].sum(axis=1)
                             for r in results])
            mine = {"cuda": 0, "wide": 1, "plain": 0}
            idle = {"cuda": 0, "wide": 0, "plain": 0}
            kernel = algorithm + "_wide"
            launched = lc.largest[kernel][1]
            ok = (lc.counts["reassign"] == (mine if mod is rk else idle)
                  and lc.counts["marginal"] == (mine if mod is mk else idle)
                  and lc.counts["multinomial"] == {"cuda": 0, "plain": 0}
                  and launched.weights.shape[2] == width
                  and launched.read_w.shape[1] == 1
                  and np.all(np.abs(sums - 1.0) < 0.03)
                  and all(np.isfinite(r["loglik"]).all() for r in results))
            stock_ms = lc.ms(kernel)    # the launch of the run above
            print("wide bucket, %s: %d events of %d isoforms in a bucket of "
                  "%d (C=%d, %d read slots), %d x %d: %.2fs, kernel %.1f ms; "
                  "launches %s; the kernel's batch %s; psi sums %.4f..%.4f  "
                  "[%s]" % (algorithm, len(evs), gene_iso, width, key[1],
                            key[2], cfg.iters, cfg.chains, wall, stock_ms,
                            lc.counts, tuple(launched.read_w.shape),
                            sums.min(), sums.max(), gpu))
            if not ok:
                raise AssertionError("wide %s bucket of %d: launches, tiles "
                                     "or psi" % (algorithm, width))
            row["launches"] += lc.counts[algorithm]["wide"]
            # the wide kernel against the plain version at the bucket's
            # shape, and both timed
            b = padded_batch(evs, DEV)
            cb, _ = batch_from_numpy(pad_events(
                evs, pad_iso=key[0], pad_classes=key[1], pad_reads=key[2],
                read_dtype=np.float32, per_read=False), DEV)
            R = key[2]
            if b.weights.shape[2] != width or cb.weights.shape[2] != width:
                raise AssertionError("wide bucket pads to %d isoforms"
                                     % b.weights.shape[2])
            short = SamplerConfig(algorithm=algorithm, **WIDE_SHORT)
            for given in (False, True):
                start = (dirichlet_start(gene_iso, len(evs), short.chains,
                                         width) if given else None)
                label = "%s wide bucket I=%d (%d real) %s" % (
                    algorithm, width, gene_iso, "GIVEN" if given else "AUTO")
                got, ref = both(0, b, short, start, mod.FIXED_U)
                row["max_err"] = max(row["max_err"], compare(label, got, ref))
                if mod is rk:
                    bit_equal(label + " C=R", got, ref)
                    cref = rk._reassign_plain(
                        0, expanded(cb, R), short, rk._event_consts(cb),
                        start, rk.FIXED_U)
                    cgot = rk.run_batch_reassign(
                        0, cb, short, start_psi=start,
                        fixed_uniform=rk.FIXED_U, pad_reads=R)
                    torch.cuda.synchronize()
                    row["max_err"] = max(row["max_err"], compare(
                        label + " classes", cgot, cref))
                    bit_equal(label + " classes C=%d" % key[1], cgot, cref)
            consts = (rk._event_consts(b) if mod is rk
                      else mk._marginal_consts(b))
            plain = rk._reassign_plain if mod is rk else mk._marginal_plain
            if mod is rk:
                # B1w as the pipeline launches it: the bucket's classes
                def launch(c):
                    return rk.run_batch_reassign(3, cb, c, pad_reads=R)
            else:
                def launch(c):
                    return run(3, b, c)
            short_ms = timed(lambda: launch(short), reps=3)
            plain_short_ms = timed(lambda: plain(3, b, short, consts),
                                   reps=1)
            direct_ms = timed(lambda: launch(stock), reps=2)
            entry = {"stock_ms": stock_ms, "direct_ms": direct_ms,
                     "short_ms": short_ms, "plain_short_ms": plain_short_ms,
                     "classes": key[1], "read_slots": key[2]}
            if mod is rk:
                valid = int((b.read_w.sum(-1) > 0).sum())
                live = int(rk.class_map(cb.counts, R)[3].sum())
                bound = rk.reassign_bound(
                    len(evs), R, width, stock.chains, stock.iters,
                    stock.num_records, valid_reads=valid, classes=live)
                reads_bound = rk.reassign_bound(
                    *b.read_w.shape, stock.chains, stock.iters,
                    stock.num_records, valid_reads=valid)
                # the read tiles, a class a read: the worst case
                entry["tiles_ms"] = timed(lambda: run(3, b, stock), reps=2)
                entry["live_classes"] = live
                entry["bound_reads_ms"] = reads_bound["bound_ms"]
            else:
                bound = mk.marginal_bound(
                    *b.weights.shape, stock.chains, stock.iters,
                    stock.num_records,
                    live_classes=int((b.counts > 0).sum()))
            entry.update(bound_ms=bound["bound_ms"],
                         bound_by=bound["bound_by"],
                         shape=list(b.read_w.shape if mod is rk
                                    else b.weights.shape))
            if width == 512:
                entry["plain_stock_ms"] = timed(
                    lambda: plain(3, b, stock, consts), reps=1)
            print("wide bucket, %s kernel at I=%d %s=%d E=%d: %d x %d %.2f ms "
                  "(plain version %.2f ms); %d x %d %.2f ms in the run, %.2f "
                  "ms alone%s%s; bound %.4f ms (%s)%s  [%s]"
                  % (algorithm, width, "R" if mod is rk else "C",
                     entry["shape"][1], len(evs), short.iters, short.chains,
                     short_ms, plain_short_ms, stock.iters, stock.chains,
                     stock_ms, direct_ms,
                     ", on read tiles (C = R) %.2f ms" % entry["tiles_ms"]
                     if "tiles_ms" in entry else "",
                     ", plain version %.1f ms" % entry["plain_stock_ms"]
                     if "plain_stock_ms" in entry else "",
                     bound["bound_ms"], bound["bound_by"],
                     "; %d live classes, the reads' walks' bound %.4f ms" % (
                         entry["live_classes"], entry["bound_reads_ms"])
                     if mod is rk else "", gpu))
            # Philox draws through the same kernel: the exact posterior
            tb, exact = wide_two_iso(algorithm, width)
            res = run(1, tb, SamplerConfig(algorithm=algorithm, **PHILOX))
            means = res.to_numpy().flat_samples()[:, :, 0].mean(axis=1)
            print("  a two-isoform event in a bucket of %d: exact %.4f, "
                  "kernel means %s" % (width, exact,
                                       np.array2string(means, precision=4)))
            if not np.all(np.abs(means - exact) < 0.02):
                raise AssertionError("the wide %s kernel misses the exact "
                                     "posterior at %d isoforms"
                                     % (algorithm, width))
            row["I=%d" % width] = entry
        (n1, w1), (n2, w2) = WIDE_GENES
        print("wide %s kernel, 5000 x 6: 4 genes of %d isoforms %.1f ms in "
              "the run, %.1f ms alone; of %d isoforms %.1f / %.1f ms; the "
              "earlier %.2f / %.2f ms (before the kernel's redesign; "
              "PERF.md, not timed here)  [%s]"
              % (algorithm, n1, row["I=%d" % w1]["stock_ms"],
                 row["I=%d" % w1]["direct_ms"], n2,
                 row["I=%d" % w2]["stock_ms"], row["I=%d" % w2]["direct_ms"],
                 EARLIER_WIDE_MS[algorithm][w1],
                 EARLIER_WIDE_MS[algorithm][w2], gpu))
        out[algorithm] = row
    return out


# the stream pool's check: genes of 2, 12, 24 and 48 isoforms (buckets
# of 2, 16, 32 and 64), read counts spread over many read pads, and three
# deep ones (B3), in chunks of a few events
POOL_GENES = ((2, 24), (12, 16), (24, 16), (48, 16))
POOL_DEEP = 3
POOL_CHUNK = 4


def pool_events():
    """The stream pool check's catalog: (events, the bucket keys)."""
    evs = []
    for num_iso, n in POOL_GENES:
        evs += [wide_event("reassign", num_iso=num_iso, n_reads=150 + 23 * j,
                           seed=50 + j) for j in range(n)]
    evs += [deepened(wide_event("reassign", num_iso=2, n_reads=300,
                                seed=90 + j), 100) for j in range(POOL_DEEP)]
    return evs, sorted({tp._bucket_key(ev) for ev in evs})


def stream_pool_check(gpu):
    """A mixed catalog (``pool_events``: buckets of 2, 16, 32 and 64
    isoforms and a deep one) through StreamRunner at stock settings,
    twice: with the pool of ``tp.POOL_STREAMS`` streams, chunks side by
    side and materialized as they complete, and with the pool forced to
    one stream, so one chunk in flight.  Every event's psi ticks, scores,
    final counts, summary and acceptance must be equal bit for bit."""
    evs, keys = pool_events()
    cfg = tp.RunConfig(read_len=25, max_batch_events=POOL_CHUNK)
    if not any(k[2] > tp.DEEP_READS for k in keys) or {
            k[0] for k in keys} != {2, 16, 32, 64}:
        raise AssertionError("stream pool catalog: buckets %s" % keys)
    runs = {}
    for streams in (tp.POOL_STREAMS, 1):
        saved = tp.POOL_STREAMS
        tp.POOL_STREAMS = streams
        try:
            with Launches() as lc:
                t = time.time()
                results = tp.run_events(evs, cfg, seed=7, device=DEV)
                torch.cuda.synchronize()
                wall = time.time() - t
        finally:
            tp.POOL_STREAMS = saved
        runs[streams] = results
        print("stream pool of %d: %d events in %d buckets, %d launches, "
              "%.2fs  [%s]" % (streams, len(evs), len(keys),
                               sum(sum(c.values())
                                   for c in lc.counts.values()), wall, gpu))
    got, want = runs[tp.POOL_STREAMS], runs[1]
    for j, (a, b) in enumerate(zip(got, want)):
        if sorted(a) != sorted(b):
            raise AssertionError("stream pool: event %d has %s, one stream "
                                 "%s" % (j, sorted(a), sorted(b)))
        for name in a:
            x, y = a[name], b[name]
            same = (all(np.array_equal(u, v) for u, v in zip(x, y))
                    if isinstance(x, tuple) else np.array_equal(x, y))
            if not same:
                raise AssertionError("stream pool: event %d's %s differs "
                                     "from the one-stream run's" % (j, name))
    print("stream pool: every event's results bit-equal to the one-stream "
          "run's  [%s]" % gpu)


def host_batch(batch):
    """A batch on the card as the numpy batch a sharded run takes."""
    return EventBatch(*(t.cpu().numpy() for t in batch))


def one_launch(seed, batch, cfg, start=None, fixed=False, plan=None):
    """The kernel of ``cfg.algorithm`` in one launch (in ``plan`` if
    given), on the host."""
    if cfg.algorithm == "reassign":
        return in_plan(seed, batch, cfg, plan, start, fixed).to_numpy()
    return mk._marginal_cuda(seed, batch, cfg, mk._marginal_consts(batch),
                             start, fixed, plan=plan).to_numpy()


def shard_plan(cfg, batch, E):
    """The plan each kernel picks for a shard of E events of ``batch``."""
    if cfg.algorithm == "reassign":
        return rk.launch_plan(E, batch.read_w.shape[1], batch.read_w.shape[2],
                              cfg.chains)
    return mk.marginal_plan(E, batch.weights.shape[1],
                            batch.weights.shape[2], cfg.chains)


def bitwise(got, want):
    """{field: max |difference|} over the fields of two host results: 0
    where a field is bit-equal (NaN in the same places, as padding events
    may give), inf where shapes or NaNs differ."""
    out = {}
    for f in got._fields:
        x, y = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if x.shape == y.shape and np.array_equal(x, y, equal_nan=True):
            out[f] = 0.0
        elif x.shape != y.shape:
            out[f] = float("inf")
        else:
            d = np.abs(x.astype(np.float64) - y.astype(np.float64))
            out[f] = float(np.nanmax(d)) or float("inf")
    return out


def kernel_of(seed, batch, cfg, start_psi=None, fixed_uniform=None):
    """The wrapper of ``cfg.algorithm``'s kernel on a batch with per-read
    tiles, in fixed-uniform mode where asked."""
    run = (rk.run_batch_reassign if cfg.algorithm == "reassign"
           else mk.run_batch_marginal)
    return run(seed, batch, cfg, start_psi=start_psi,
               fixed_uniform=fixed_uniform)


def main_sampler(seed, batch, cfg, start_psi=None):
    """The pipeline's sampler (``run_sampler``) on the main bucket: B1 on
    the per-read tiles it expands from the class tensors, or B2."""
    return tp.run_sampler(seed, batch, cfg, start_psi, MAIN_R)


def walled(fn, reps=3):
    """Mean wall milliseconds of fn() over reps runs after one more, every
    card's queue drained before and after (shards run on side streams,
    so CUDA events on one stream would not see them)."""
    fn()      # a shard's first launch on its stream allocates there
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / reps


def mesh_kernels(big, big_m, gpu):
    """(a) of the mesh phase: both kernels sharded at their main shapes
    (B1 at E=2048 and 2047, B2 at E=2048; stock schedule) over [cuda:0]
    and [cuda:0, cuda:0], each shard on its own stream.  Under fixed
    uniforms the sharded result is the unsharded launch's: bit-equal in
    the plan each shard takes (B1's read score sums its reads in an
    order that follows the lane width, which the plan picks from E; psi,
    counts and acceptance are bit-equal in any plan), and once from a
    GIVEN start.  Under Philox the pipeline's sampler (``run_sampler``)
    is run over the mesh with the seeds the pipeline draws
    (``chunk_seed(..., shard=k)``): every shard is bit-equal to it run
    alone on its slice with its seed, no two shards share a seed, and one
    entry is bit-equal to the unsharded launch.  Returns the largest
    difference from the unsharded launches and the times."""
    meshes = {"[cuda:0]": MESH[:1], "[cuda:0, cuda:0]": MESH}
    E = big.weights.shape[0]
    cases = [("B1 E=%d" % E, big, STOCK),
             ("B1 E=%d" % (E - 1), sliced(big, E - 1), STOCK),
             ("B2 E=%d" % E, big_m, STOCK_M)]
    print("mesh: both kernels sharded at their main shapes, %d x %d"
          % (STOCK.iters, STOCK.chains))
    worst = 0.0
    times = {}
    for label, b, cfg in cases:
        E = b.weights.shape[0]
        hb = host_batch(b)
        own = one_launch(0, b, cfg, fixed=True)
        for mname, devs in meshes.items():
            mesh = tmesh.make_event_mesh(devs)
            n = len(mesh)
            got = tmesh.run_batch_sharded([0] * n, hb, cfg, mesh, kernel_of,
                                          fixed_uniform=rk.FIXED_U)
            step = -(-E // n)
            plan = shard_plan(cfg, b, step)
            got_np = got.to_numpy()
            got_np = type(got_np)(*(x[:E] for x in got_np))
            same_plan = one_launch(0, b, cfg, fixed=True, plan=plan)
            d_plan = bitwise(got_np, same_plan)
            d_own = bitwise(got_np, own)
            print("  %-10s %-17s fixed uniforms: against the unsharded "
                  "launch in the shards' plan (%s) %s; in its own plan "
                  "max|dpsi| %.3g max|dll| %.3g, accepted equal %s"
                  % (label, mname, plan, "bit-equal" if not any(
                      d_plan.values()) else d_plan, d_own["psi_samples"],
                     d_own["loglik"], d_own["accepted"] == 0))
            if (any(d_plan.values()) or d_own["psi_samples"]
                    or d_own["accepted"] or d_own["final_n"]
                    or d_own["final_psi"] or d_own["loglik"] > LL_ATOL):
                raise AssertionError("mesh %s %s: sharded != unsharded"
                                     % (label, mname))
            worst = max(worst, d_own["psi_samples"])
            # Philox: each shard is its slice alone with its chunk seed
            I, C = b.weights.shape[2], b.weights.shape[1]
            seeds = [tp.chunk_seed(11, 0, I, C, MAIN_R,
                                   shard=k if n > 1 else None)
                     for k in range(n)]
            if len(set(seeds)) != n:
                raise AssertionError("two shards share a seed: %s" % seeds)
            ph = tmesh.run_batch_sharded(seeds, hb, cfg, mesh, main_sampler)
            padded = tmesh.shard_batch(hb, mesh)
            for k, (shard, seed_k) in enumerate(zip(ph.shards, seeds)):
                alone = main_sampler(seed_k, padded[k], cfg)
                d = bitwise(shard.to_numpy(), alone.to_numpy())
                if any(d.values()):
                    raise AssertionError("mesh %s %s: Philox shard %d is "
                                         "not its slice alone: %s"
                                         % (label, mname, k, d))
            if n == 1:
                d = bitwise(ph.to_numpy(),
                            main_sampler(seeds[0], b, cfg).to_numpy())
                if any(d.values()):
                    raise AssertionError("mesh %s [cuda:0]: not the "
                                         "unsharded launch: %s" % (label, d))
            print("  %-10s %-17s Philox: %d shard(s) bit-equal to the "
                  "slice alone with seeds %s%s"
                  % (label, mname, n, ["%016x" % s for s in seeds],
                     "; bit-equal to the unsharded launch" if n == 1
                     else ""))
            streams = tmesh.shard_streams(mesh)
            parts = tmesh.shard_batch(hb, mesh, streams)

            def sharded_launch():
                for part, s, sk in zip(parts, streams, seeds):
                    with tmesh.on_stream(s):
                        kernel_of(sk, part, cfg)
            times[(label, mname)] = walled(sharded_launch)
        times[(label, "unsharded")] = walled(
            lambda: kernel_of(seeds[0], b, cfg))
        print("  %-10s wall per launch: unsharded %.2f ms, [cuda:0] %.2f "
              "ms, [cuda:0, cuda:0] %.2f ms (two streams on one card)  [%s]"
              % (label, times[(label, "unsharded")],
                 times[(label, "[cuda:0]")],
                 times[(label, "[cuda:0, cuda:0]")], gpu))
    # a GIVEN start, split as the batch is
    start = dirichlet_start(2, big.weights.shape[0], STOCK.chains)
    hb = host_batch(big)
    got = tmesh.run_batch_sharded(
        [0, 0], hb, STOCK, tmesh.make_event_mesh(meshes["[cuda:0, cuda:0]"]),
        kernel_of, start_psi=start.cpu().numpy(),
        fixed_uniform=rk.FIXED_U).to_numpy()
    plan = shard_plan(STOCK, big, big.weights.shape[0] // 2)
    d = bitwise(got, one_launch(0, big, STOCK, start, True, plan))
    print("  B1 E=%d GIVEN start over [cuda:0, cuda:0], fixed uniforms: "
          "%s" % (big.weights.shape[0], "bit-equal to the unsharded launch in the shards' plan"
                  if not any(d.values()) else d))
    if any(d.values()):
        raise AssertionError("mesh: GIVEN start sharded != unsharded")
    return {"max_err": worst, "ms": times}


def mesh_run(fix, tmp, name, gpu, device, **kw):
    """``compute_all_genes_psi`` on ``device`` (a mesh: a list of devices)
    at stock settings (``kw``: the flags' RunConfig fields), its launches
    counted and its output checked as ``run_main_path``'s."""
    out = os.path.join(tmp, name)
    settings = Settings.load(None)
    cfg = tp.RunConfig.from_settings(settings, 36, **kw)
    with Launches() as lc:
        t = time.time()
        n = tp.compute_all_genes_psi(fix["index"], fix["bam"], 36, out,
                                     cfg=cfg, settings=settings,
                                     device=device)
        torch.cuda.synchronize()
        lc.wall = time.time() - t
    if n != N_GENES:
        raise AssertionError("%s: %d events written" % (name, n))
    for kern in ("reassign", "marginal"):
        if lc.counts[kern]["plain"] != 0:
            raise AssertionError("%s: plain launches %s" % (name, lc.counts))
    check_run(fix, out, name, gpu, lc.wall, lc)
    return lc


def mesh_phase(fix, tmp, big, big_m, single, gpu):
    """The mesh phase: (a) ``mesh_kernels``; (b) the main path over
    ``MESH`` for REASSIGN, MARGINAL with the linear start and the
    convergent stop on the single-end catalog, each followed by the same
    run unsharded through the same call, and both walls printed beside
    the earlier unsharded CLI run's (``single``: name -> its Launches).
    Returns (a)'s numbers and (b)'s Launches."""
    t = time.time()
    kernels_out = mesh_kernels(big, big_m, gpu)
    t_kernels = time.time() - t
    runs = {}
    for name, kw, kern in (
            ("out", {}, "reassign"),
            ("marginal_linear", {"algorithm": "marginal",
                                 "start": "linear"}, "marginal"),
            ("convergent", {"stop": "convergent"}, "reassign")):
        lc = mesh_run(fix, tmp, "mesh_" + name, gpu, list(MESH), **kw)
        again = mesh_run(fix, tmp, "unsharded_" + name, gpu, DEV, **kw)
        other = "marginal" if kern == "reassign" else "reassign"
        if (lc.counts[kern]["cuda"] < 2 or lc.counts[other]["cuda"] != 0
                or again.counts[kern]["cuda"] < 1):
            raise AssertionError("mesh %s launches: %s, unsharded %s"
                                 % (name, lc.counts, again.counts))
        runs[name] = lc
        print("mesh main path %-15s over [cuda:0, cuda:0]: wall %.2fs; "
              "unsharded right after %.2fs, the earlier unsharded CLI run "
              "%.2fs; %s launches %d (%d unsharded)  [%s]"
              % (name, lc.wall, again.wall, single[name].wall, kern,
                 lc.counts[kern]["cuda"], again.counts[kern]["cuda"], gpu))
    print("mesh phase: %.1fs (the kernels %.1fs, six runs of %d genes the "
          "rest)" % (time.time() - t, t_kernels, N_GENES))
    return kernels_out, runs


def probes():
    """The port's module_availability and test_miso on the card.
    matplotlib is the one module no phase here needs (and this script
    never imports it): where it is missing the probe must count exactly
    it."""
    missing = int(importlib.util.find_spec("matplotlib") is None)
    rc = module_availability.main([])
    if rc != missing:
        raise AssertionError("module_availability returned %d, %d expected"
                             % (rc, missing))
    staged("test_miso", test_miso_cli.main, [])


def rest_of_path(fix, tmp, lc_r, heads_r, gpu, reps=1):
    """What a user does around and after the one-host run ``lc_r`` of
    ``fix``: two hosts on the one card, summarize, compare and filter
    over their merged tree and a second sample, and the worker CLI.
    Returns the Launches of the two runs made inside this process."""
    merged = two_hosts(fix, tmp, lc_r, gpu, reps)
    return (users_path(fix, tmp, merged, gpu),
            worker_cli(fix, tmp, heads_r, gpu))


# B3, the multinomial kernel of the deep route: the deep catalog's bucket
# shape (16 events of 20,000 reads), a paired-end deep bucket (256
# classes), and wider events
B3_SHAPES = ("deep catalog", "paired-end deep", "I=8", "I=16", "I=128")
# posterior means of B3 and the plain version on the deep catalog's
# bucket: each within this of the other (independent Philox and
# torch.Generator draws; posterior sd ~0.006 at 20,000 reads) and of the
# grid-exact mean
B3_POSTERIOR_TOL, EXACT_TOL = 0.01, 0.02
# the deep route before B3 (batched torch, ~83 launches an iteration;
# NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): the deep catalog's bucket
# in its main-path run, and the 16,384-read threshold's 64 events
EARLIER_DEEP_MS = {"catalog": 5153.4, "threshold": 5268.92}
# B3 before its redesign for the H100 at the deep catalog's bucket (PR 8's
# final form; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)
EARLIER_B3_MS = 37.65


def deep_catalog_batch():
    """DEEP_GENES simulated events of 2,000 reads of 36 nt, every class
    count times 10: the deep catalog's bucket shape (I=2, C=4, 20,000
    reads), with the events kept for their exact posteriors."""
    rng = np.random.default_rng(2)
    evs = [deepened(simulated_event(*SE_GENE, [p, 1.0 - p], 2000, 36,
                                    seed=200 + i), 10)
           for i, p in enumerate(rng.uniform(0.05, 0.95, DEEP_GENES))]
    return class_batch(evs, DEV), evs


def b3_shape(label):
    if label == "deep catalog":
        return deep_catalog_batch()[0]
    if label == "paired-end deep":
        return class_batch(
            [deepened(paired_event(*PAIRED_GENE, [p, 1.0 - p], 400, 40,
                                   250.0, 15.0, seed=11 + i), 50)
             for i, p in enumerate((0.6, 0.3, 0.8, 0.45))], DEV)
    I, num_iso, C = {"I=8": (8, 5, 6), "I=16": (16, 9, 6),
                     "I=128": (128, 70, 4)}[label]
    return multinomial_lane_batch(I, num_iso, I, DEV, C=C, scale=300.0)


def given_start(batch, K):
    """(E, K, I) GIVEN start: Dirichlet over each event's real isoforms
    (zeros for a padding event), seeded."""
    E, _, I = batch.weights.shape
    rng = np.random.default_rng(9)
    sp = np.zeros((E, K, I), np.float32)
    for e, k in enumerate(batch.num_iso.cpu().numpy()):
        if k > 0:
            sp[e, :, :k] = rng.dirichlet(np.ones(k), size=K)
    return torch.from_numpy(sp).to(DEV)


def b3(seed, batch, cfg, plan=None, start=None, fixed=False):
    """B3 in one plan (default: ``multinomial_plan``'s)."""
    out = deep._multinomial_cuda(seed, batch, cfg, deep._event_consts(batch),
                                 start, fixed, plan=plan)
    torch.cuda.synchronize()
    return out


def b3_plain(seed, batch, cfg, start=None, fixed=None):
    out = deep._multinomial_plain(seed, batch, cfg,
                                  deep._event_consts(batch), start, fixed)
    torch.cuda.synchronize()
    return out


# B3's binomial draws against the exact pmf: equal bins of the
# randomised probability integral transform (testing.binomial_chi2), and
# the least p-value a regime may show
B3_CHI2_BINS, B3_CHI2_P = 32, 1e-3
# the step breakdown's sums and the latency probe's slots (the enums of
# csrc/multinomial_kernel.cu's -DMISO_B3_CLOCKS build)
B3_CLOCK_SLOTS = kernels.source_enum("ClockSlot")
B3_LATENCY_SLOTS = kernels.source_enum("LatencySlot")


# the packing check: the deep catalog's bucket tiled to 384 ... 12,288
# lanes, in every plan (multinomial_plan packs lanes into warps past
# LANE_WARPS = 660 lanes)
B3_PACKING_TILES = (4, 6, 11, 16, 32, 128)


def b3_tag(plan):
    return "T=%d%s" % (plan.T, "" if plan.shared_bytes else " scratch")


def b3_plans(E, C, I, K):
    """Every plan, and the warp-per-lane plan with its lane arrays in
    scratch."""
    plans = deep.all_multinomial_plans(E, C, I, K)
    return plans + [plans[-1]._replace(shared_bytes=0)]


def b3_plan_times(batch, seed=3):
    """B3 at stock settings in every plan of ``b3_plans``, ms by
    plan."""
    E, C, I = batch.weights.shape
    consts = deep._event_consts(batch)
    out = {}
    for plan in b3_plans(E, C, I, STOCK.chains):
        def run():
            deep._multinomial_cuda(seed, batch, STOCK, consts, None, False,
                                   plan=plan)
        run()
        out[b3_tag(plan)] = timed(run, reps=3)
    return out


def b3_packing_times(big, gpu):
    """B3 at stock settings in every plan at B3_PACKING_TILES times the
    deep catalog's bucket: {lanes: {plan: ms}}."""
    out = {}
    for n in B3_PACKING_TILES:
        b = tiled(big, n)
        E, C, I = b.weights.shape
        out[E * STOCK.chains] = b3_plan_times(b)
        print("B3 at %d lanes (the deep catalog's bucket x %d), ms by plan: "
              "%s (multinomial_plan: %s)  [%s]"
              % (E * STOCK.chains, n,
                 {k: round(x, 2) for k, x in out[E * STOCK.chains].items()},
                 b3_tag(deep.multinomial_plan(E, C, I, STOCK.chains)), gpu))
    return out


def b3_breakdown(label, batch, gpu, seed=3):
    """One stock launch of the step-breakdown build (kernels.
    load_b3_clocks, in the production build's place for that launch
    only): clocks per step in each phase (each lane's first thread), the
    random binomial draws per lane and step, and BTRS's tries, squeeze
    hits and slow-path tries.  The stamps slow the launch; its time is
    printed beside the phases."""
    lib = kernels.load_b3_clocks()
    sums = np.zeros(len(B3_CLOCK_SLOTS), np.uint64)
    kernels.check(lib, lib.miso_multinomial_clocks(sums.ctypes.data),
                  "clearing B3's step breakdown")
    saved = kernels.load
    kernels.load = lambda: lib
    held = []
    try:
        ms = timed(lambda: held.append(b3(seed, batch, STOCK)), reps=1)
    finally:
        kernels.load = saved
    kernels.check(lib, lib.miso_multinomial_clocks(sums.ctypes.data),
                  "reading B3's step breakdown")
    v = dict(zip(B3_CLOCK_SLOTS, sums.astype(np.float64)))
    steps = v["kCntSteps"]
    phases = {k[4:]: float(v[k] / steps) for k in B3_CLOCK_SLOTS
              if k.startswith("kClk")}
    btrs = max(v["kCntDraws"] - v["kCntInversion"], 1.0)
    tries = max(v["kCntTries"], 1.0)
    out = {"instrumented_ms": ms, "clocks_per_step": phases,
           "step_clocks": sum(phases.values()),
           "draws_per_step": v["kCntDraws"] / steps,
           "inversion_share": v["kCntInversion"] / max(v["kCntDraws"], 1.0),
           "tries_per_btrs_draw": v["kCntTries"] / btrs,
           "squeeze_share": v["kCntSqueeze"] / btrs,
           "slow_share": v["kCntSlow"] / tries,
           "slow_per_draw": v["kCntSlow"] / btrs,
           "rounds_per_btrs_draw": v["kCntRounds"] / btrs,
           "accept_share": float(held[0].to_numpy().accepted.sum())
           / steps}
    # the SM clock the stamps imply: a lane's clocks over the launch's time
    out["implied_mhz"] = (out["step_clocks"] * STOCK.iters
                          / (ms * 1e-3) / 1e6)
    E, C, I = batch.weights.shape
    print("B3 step breakdown, %s (E=%d C=%d I=%d, plan %s; the "
          "instrumented build, %.2f ms, implies %.0f MHz): clocks a step "
          "%s = %.0f; per lane and step %.3f random draws (%.1f %% by "
          "inversion), %.3f BTRS tries and %.3f rounds a draw, %.1f %% of "
          "draws by the squeeze, %.3f slow tests a try; MH accepts %.1f %% "
          "of steps  [%s]"
          % (label, E, C, I, b3_tag(deep.multinomial_plan(E, C, I,
                                                          STOCK.chains)),
             ms, out["implied_mhz"],
             {k: round(x, 1) for k, x in phases.items()},
             out["step_clocks"], out["draws_per_step"],
             100 * out["inversion_share"], out["tries_per_btrs_draw"],
             out["rounds_per_btrs_draw"], 100 * out["squeeze_share"],
             out["slow_share"], 100 * out["accept_share"], gpu))
    return out


def b3_latencies(gpu, reps=4096):
    """The dependent latencies of a step's pieces (the probe of the
    step-breakdown build), clocks per operation."""
    lib = kernels.load_b3_clocks()
    out = torch.zeros(len(B3_LATENCY_SLOTS) + 1, dtype=torch.float64,
                      device=DEV)
    chase = torch.tensor([float((i * 7 + 1) & 31) for i in range(32)],
                         device=DEV)
    kernels.check(lib, lib.miso_multinomial_latencies(
        out.data_ptr(), reps, chase.data_ptr()), "B3's latency probe")
    torch.cuda.synchronize()
    lat = {k[4:]: round(x, 2) for k, x in zip(B3_LATENCY_SLOTS,
                                              out.cpu().tolist())}
    print("dependent latencies, clocks an operation (one warp, %d in a "
          "chain): %s  [%s]" % (reps, lat, gpu))
    return lat


def multinomial_phase(gpu):
    """B3 against its plain version under fixed uniforms in every plan
    at every shape of B3_SHAPES, from AUTO and GIVEN starts (and at
    stock settings at the deep catalog's shape); one Philox chain in
    every plan; the moments of its binomial draws; its posterior beside
    the plain version's and the exact one; its time, its plain version's,
    its bound and its estimated floor at the deep catalog's shape.
    Returns the numbers kept."""
    small = SamplerConfig(**SMALL)
    err = 0.0
    print("B3 (multinomial), fixed uniforms, every plan, AUTO and GIVEN:")
    for label in B3_SHAPES:
        b = b3_shape(label)
        E, C, I = b.weights.shape
        padding = (b.num_iso == 0).cpu().numpy()
        for start in (None, given_start(b, small.chains)):
            ref = b3_plain(0, b, small, start, rk.FIXED_U)
            for plan in b3_plans(E, C, I, small.chains):
                err = max(err, compare(
                    "%s E=%d C=%d I=%d %s %s" % (
                        label, E, C, I, b3_tag(plan),
                        "AUTO" if start is None else "GIVEN"),
                    b3(0, b, small, plan, start, True), ref, padding))
    big, evs = deep_catalog_batch()
    E, C, I = big.weights.shape
    err = max(err, compare("deep catalog stock %dx%d" % (STOCK.iters,
                                                         STOCK.chains),
                           b3(0, big, STOCK, None, None, True),
                           b3_plain(0, big, STOCK, None, rk.FIXED_U)))

    cfg = SamplerConfig(**PHILOX)
    plans = b3_plans(E, C, I, cfg.chains)
    first = b3(17, big, cfg, plans[0]).to_numpy()
    for plan in plans[1:]:
        got = b3(17, big, cfg, plan).to_numpy()
        if not (np.array_equal(got.psi_samples, first.psi_samples)
                and np.array_equal(got.final_n, first.final_n)
                and np.array_equal(got.accepted, first.accepted)
                and np.abs(got.loglik - first.loglik).max() <= LL_ATOL):
            raise AssertionError("B3's Philox chain differs at %s"
                                 % b3_tag(plan))
    print("B3 Philox chain, %d x %d: bit-equal in plans %s"
          % (cfg.iters, cfg.chains, [b3_tag(p) for p in plans]))

    bb = binomial_batch(4096, DEV)
    res = b3(5, bb, SamplerConfig(iters=0, burn_in=0, lag=1, chains=6))
    moments, sums = binomial_moments(bb, res)
    print("B3 binomial draws, standardised (mean, variance, lanes) by "
          "(reads, weight) %s: %s; sums exact %s"
          % (list(BINOMIAL_REGIMES), moments, sums))
    if not sums or not all(abs(m) < 5 / np.sqrt(n)
                           and abs(v - 1.0) < 6 * np.sqrt(2.0 / n)
                           for m, v, n in moments):
        raise AssertionError("B3's binomial draws miss their moments")
    chi2 = binomial_chi2(bb, res, B3_CHI2_BINS)
    print("B3 binomial draws against the exact pmf, (chi2, p, draws) by "
          "regime over %d bins: %s" % (B3_CHI2_BINS, chi2))
    if not all(p > B3_CHI2_P for _, p, _ in chi2):
        raise AssertionError("B3's binomial draws miss the exact pmf")

    t0 = time.time()
    ms = timed(lambda: deep.run_batch_multinomial(3, big, STOCK), reps=3)
    got = deep.run_batch_multinomial(3, big, STOCK).to_numpy()
    torch.cuda.synchronize()
    plain_ms = timed(lambda: b3_plain(3, big, STOCK), reps=1)
    ref = b3_plain(3, big, STOCK).to_numpy()
    exact = np.array([exact_posterior_mean_2iso(ev) for ev in evs])
    m_got = got.flat_samples()[:, :, 0].mean(axis=1)
    m_ref = ref.flat_samples()[:, :, 0].mean(axis=1)
    d_plain = float(np.abs(m_got - m_ref).max())
    d_exact = float(np.abs(m_got - exact).max())
    d_exact_plain = float(np.abs(m_ref - exact).max())
    print("B3 posterior at the deep catalog's shape, %d x %d: max |B3 - "
          "plain| %.4f, max |B3 - exact| %.4f, max |plain - exact| %.4f "
          "(%.1fs)" % (STOCK.iters, STOCK.chains, d_plain, d_exact,
                       d_exact_plain, time.time() - t0))
    if not (d_plain < B3_POSTERIOR_TOL and d_exact < EXACT_TOL
            and d_exact_plain < EXACT_TOL):
        raise AssertionError("B3's posterior misses the plain version's "
                             "or the exact one")
    plan = deep.multinomial_plan(E, C, I, STOCK.chains)
    b = deep.multinomial_bound(E, C, I, STOCK.chains, STOCK.iters,
                               STOCK.num_records,
                               live_classes=int((big.counts > 0).sum()))
    floor = deep.multinomial_floor(C, I, plan.T, STOCK.iters)
    print("B3 at the deep catalog's shape E=%d C=%d I=%d, %d x %d, T=%d: "
          "kernel %.2f ms, plain %.2f ms (PERF.md, not timed here: B3 "
          "before its redesign %.2f ms, the deep route before B3 %.1f ms); "
          "bound %.4f ms (%s), dependent-chain floor %.2f ms (an estimate, "
          "not measured)  [%s]"
          % (E, C, I, STOCK.iters, STOCK.chains, plan.T, ms, plain_ms,
             EARLIER_B3_MS, EARLIER_DEEP_MS["catalog"], b["bound_ms"],
             b["bound_by"], floor, gpu))
    t0 = time.time()
    plans_ms = b3_plan_times(big)
    print("B3 at the deep catalog's shape in every plan, ms: %s (the plan's "
          "own: %s)  [%s]" % ({k: round(x, 2) for k, x in plans_ms.items()},
                              b3_tag(plan), gpu))
    breakdown = b3_breakdown("deep catalog", big, gpu)
    floor = deep.multinomial_floor(
        C, I, plan.T, STOCK.iters, accept_share=breakdown["accept_share"],
        slow_per_draw=breakdown["slow_per_draw"])
    print("B3's dependent-chain floor at the deep catalog's shape, at this "
          "run's accepts and slow tests: %.2f ms (multinomial_floor: an "
          "estimate from the probe's latencies, not timed); B3 %.2f ms = "
          "%.1fx it  [%s]" % (floor, ms, ms / floor, gpu))
    latencies = b3_latencies(gpu)
    packing = b3_packing_times(big, gpu)
    print("B3's plans, breakdown and latencies: %.1fs (the step-breakdown "
          "build: nvcc %s s)" % (time.time() - t0,
                                 kernels.CLOCKS_BUILD_INFO["seconds"]))
    return {"max_err": err, "ms": ms, "plain_ms": plain_ms, "bound": b,
            "floor_ms": floor, "plan_T": plan.T, "moments": moments,
            "chi2": chi2, "plans_ms": plans_ms, "breakdown": breakdown,
            "latencies": latencies, "packing_ms": packing,
            "posterior": {"b3_vs_plain": d_plain, "b3_vs_exact": d_exact}}


def million_read_event():
    """tests/test_deep_events.py's event through B3 on the card."""
    ev_d = deepened(simulated_event(*SE_GENE, [0.3, 0.7], 2000, 25,
                                    seed=4), 500)
    exact_d = exact_posterior_mean_2iso(ev_d)
    launches = deep.LAUNCHES["cuda"]
    res = deep.run_batch_multinomial(
        0, class_batch([ev_d], DEV),
        SamplerConfig(iters=800, burn_in=200, lag=4, chains=4))
    res = res.to_numpy()
    mean_d = float(res.flat_samples()[0, :, 0].mean())
    print("B3, 1,000,000 reads: exact %.4f, mean %.4f; final_n sums %s"
          % (exact_d, mean_d, res.final_n.sum(-1)[0].tolist()))
    if not (deep.LAUNCHES["cuda"] == launches + 1
            and abs(mean_d - exact_d) < 0.02
            and np.all(res.final_n.sum(-1) == 1_000_000.0)):
        raise AssertionError("B3 misses the million-read event")


def deep_catalog_runs(tmp, gpu):
    """The deep catalog through miso --run, then once more under
    --profile (shorter chains): B3 launches, nothing else does, and every
    header's assigned counts sum to its event's reads.  Returns the two
    runs' Launches."""
    t = time.time()
    fix_d = indexed_catalog(os.path.join(tmp, "cat_deep"),
                            num_events=DEEP_GENES,
                            reads_per_event=DEEP_READS_PER_GENE,
                            read_len=36, seed=2)
    print("deep catalog: %d genes x %d reads built and indexed in %.1fs"
          % (DEEP_GENES, DEEP_READS_PER_GENE, time.time() - t))
    lc_d, heads_d = run_main_path(fix_d, tmp, "deep", [], gpu)
    reads = []
    for ev, h in heads_d.items():
        reads.append(compatible_reads(h))
        n_assigned = sum(int(c.split(":")[1]) for c in
                         header_field(h, "assigned_counts").split(","))
        if n_assigned != reads[-1] or reads[-1] <= tp.DEEP_READS:
            raise AssertionError("deep %s: %d reads, %d assigned"
                                 % (ev, reads[-1], n_assigned))
    print("deep: every header's assigned counts sum to its event's reads "
          "(%d..%d); wall %.2fs, B3 %.1f ms over %d launches (the deep "
          "route before B3, PERF.md, not timed here: %.1f ms)  [%s]"
          % (min(reads), max(reads), lc_d.wall, lc_d.ms("multinomial"),
             lc_d.counts["multinomial"]["cuda"], EARLIER_DEEP_MS["catalog"],
             gpu))
    prof_dir = os.path.join(tmp, "trace")
    settings = os.path.join(tmp, "short.txt")
    with open(settings, "w") as f:
        f.write("[sampler]\nburn_in = 50\nlag = 5\n"
                "num_iters = 200\nnum_chains = 6\n")
    lc_f, _ = run_main_path(fix_d, tmp, "deep_profiled",
                            ["--settings-filename", settings,
                             "--profile", prof_dir], gpu)
    traces = glob.glob(os.path.join(prof_dir, "*.json"))
    if len(traces) != 1 or os.path.getsize(traces[0]) == 0:
        raise AssertionError("--profile wrote no trace: %s" % traces)
    print("profile: %s, %.1f MiB" % (os.path.basename(traces[0]),
                                     os.path.getsize(traces[0]) / 2 ** 20))
    for lc in (lc_d, lc_f):
        if not (lc.counts["multinomial"]["cuda"] >= 1
                and lc.counts["reassign"]["cuda"] == 0
                and lc.counts["marginal"]["cuda"] == 0):
            raise AssertionError("deep catalog launches: %s" % lc.counts)
    return lc_d, lc_f


def deep_times(thr, thr_ms, gpu):
    """B3 at stock settings on 64 events of a million reads, and on the
    64 events of ~16,000 reads at the threshold beside B1 at R=16,384 on
    the same events.  Returns the numbers kept."""
    deep_b = class_batch([deepened(ev, 500) for ev in threshold_events(1)],
                         DEV)
    e64_ms = timed(lambda: deep.run_batch_multinomial(5, deep_b, STOCK),
                   reps=1)
    thr_b = class_batch(thr, DEV)
    b1_ms = thr_ms[rk.launch_plan(THRESH_E, THRESH_R, 2,
                                  STOCK.chains).home]
    b3_ms = timed(lambda: deep.run_batch_multinomial(5, thr_b, STOCK),
                  reps=3)
    print("B3 at E=%d (1,000,000 reads each), %d iters x %d chains: "
          "%.2f ms  [%s]" % (THRESH_E, STOCK.iters, STOCK.chains, e64_ms,
                             gpu))
    print("threshold, E=%d events of %d reads, %d x %d: B1 at R=%d %.2f "
          "ms, B3 %.2f ms (the deep route before B3, PERF.md, not timed "
          "here: %.2f ms)  [%s]"
          % (THRESH_E, int(thr[0].counts.sum()), STOCK.iters, STOCK.chains,
             THRESH_R, b1_ms, b3_ms, EARLIER_DEEP_MS["threshold"], gpu))
    return {"stock_ms_e64": e64_ms,
            "breakdown_e64": b3_breakdown("64 events of 10^6 reads", deep_b,
                                          gpu, seed=5),
            "breakdown_threshold": b3_breakdown("threshold", thr_b, gpu,
                                                seed=5),
            "threshold": {"events": THRESH_E,
                          "reads": int(thr[0].counts.sum()),
                          "b1_ms_r16384": b1_ms, "b3_ms": b3_ms}}


def main(only=None, sass_dir=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    gpu = card()
    print("card: %s (%d visible)" % (gpu, torch.cuda.device_count()))
    print("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))

    # -- 1. build
    t = time.time()
    kernels.load()
    nvcc_s = kernels.BUILD_INFO["seconds"]
    print("kernel build: %s, loaded after %.2fs" % (
        "library already built" if nvcc_s is None
        else "nvcc %.2fs" % nvcc_s, time.time() - t))
    # ptxas -v: per kernel and isoform width I, registers and spills
    entry, registers = None, {}
    for line in kernels.BUILD_INFO["log"].splitlines():
        m = re.search(r"entry function '\S*?(reassign|marginal|multinomial)"
                      r"(_wide)?_kernel", line)
        if m:
            # the width of a template instance (B3, B1w and B2w have one
            # instance each, of runtime width); the name's namespace holds
            # the file's name
            width = re.search(r"_kernelILi(\d+)E", line)
            entry = m.group(1) + (m.group(2) or "") + (
                " I=%s" % width.group(1) if width else "")
        elif entry and ("spill" in line or "registers" in line):
            print("  %s: %s" % (entry, line.split(":", 1)[-1].strip()))
            used = re.search(r"Used (\d+) registers", line)
            if used and entry.startswith("reassign I="):
                registers[int(entry.split("=")[1])] = int(used.group(1))
    # the launch plan reckons an SM's resident blocks from these
    if registers and registers != rk.KERNEL_REGISTERS:
        raise AssertionError("ptxas gave the REASSIGN kernel %s registers, "
                             "reassign_kernel.KERNEL_REGISTERS says %s"
                             % (registers, rk.KERNEL_REGISTERS))

    if only == "marginal":
        # the MARGINAL kernel's checks and times alone
        marginal_layouts(main_shape_batch("marginal"), paired_batch(), gpu)
        sass = os.path.join(sass_dir or kernels.BUILD_DIR,
                            "marginal_kernel_I2.sass")
        print("SASS of the I=2 instance: %s instructions, written to %s"
              % (dump_sass("marginal_kernelILi2E", sass), sass))
        print("chip_smoke marginal: %.1fs in all  [%s]"
              % (time.time() - T_START, gpu))
        return 0

    if only == "mesh":
        # the mesh phase alone, beside the unsharded runs it is read with
        with tempfile.TemporaryDirectory(prefix="miso_smoke_") as tmp:
            fix = indexed_catalog(os.path.join(tmp, "cat"),
                                  num_events=N_GENES, reads_per_event=300,
                                  read_len=36, seed=1)
            single = {
                "out": run_main_path(fix, tmp, "out", [], gpu)[0],
                "marginal_linear": run_main_path(
                    fix, tmp, "marginal_linear",
                    ["--algorithm", "marginal", "--linear-start"], gpu)[0],
                "convergent": run_main_path(fix, tmp, "convergent",
                                            ["--convergent"], gpu)[0]}
            mesh_phase(fix, tmp, main_shape_batch(),
                       main_shape_batch("marginal"), single, gpu)
        print("chip_smoke mesh: %.1fs in all  [%s]"
              % (time.time() - T_START, gpu))
        return 0

    if only == "streams":
        # the stream pool's check alone
        stream_pool_check(gpu)
        print("chip_smoke streams: %.1fs in all  [%s]"
              % (time.time() - T_START, gpu))
        return 0

    if only == "wide":
        # the wide kernels' checks and buckets alone
        wide_plans_check()
        wide_buckets(gpu)
        b2w_phase(gpu)
        print("chip_smoke wide: %.1fs in all  [%s]"
              % (time.time() - T_START, gpu))
        return 0

    if only == "hosts":
        # the multi-host run and the host tools alone
        with tempfile.TemporaryDirectory(prefix="miso_smoke_") as tmp:
            fix = indexed_catalog(os.path.join(tmp, "cat"),
                                  num_events=N_GENES, reads_per_event=300,
                                  read_len=36, seed=1)
            lc_r, heads_r = run_main_path(fix, tmp, "out", [], gpu)
            rest_of_path(fix, tmp, lc_r, heads_r, gpu, reps=3)
        wide_buckets(gpu)
        probes()
        print("chip_smoke hosts: %.1fs in all  [%s]"
              % (time.time() - T_START, gpu))
        return 0

    if only == "multinomial":
        # B3 alone: its checks, the deep catalog's runs and its times
        sass = os.path.join(sass_dir or kernels.BUILD_DIR,
                            "multinomial_kernel.sass")
        print("SASS of B3: %s instructions, written to %s"
              % (dump_sass("multinomial_kernel", sass), sass))
        million_read_event()
        multinomial_phase(gpu)
        thr = threshold_events()
        thr_ms = threshold_times(padded_batch(thr, DEV, pad_reads=THRESH_R),
                                 gpu)
        with tempfile.TemporaryDirectory(prefix="miso_smoke_") as tmp:
            deep_catalog_runs(tmp, gpu)
        deep_times(thr, thr_ms, gpu)
        print("chip_smoke multinomial: %.1fs in all  [%s]"
              % (time.time() - T_START, gpu))
        return 0

    # -- 2. fixed uniforms: each kernel follows its plain version's chain
    print("fixed-uniform match, kernel vs plain version on the card:")
    small = SamplerConfig(**SMALL)
    for num_iso in (2, 3):
        for given in (False, True):
            b = lane_test_batch(num_iso, num_iso, num_iso, DEV)
            start = dirichlet_start(num_iso, 2, 2) if given else None
            compare("reassign I=%d %s padded reads" % (
                num_iso, "GIVEN" if given else "AUTO"),
                *both(0, b, small, start, rk.FIXED_U))
    big = main_shape_batch()
    E, R, I = big.read_w.shape
    big_got, big_ref = both(0, big, STOCK, None, rk.FIXED_U)
    max_err = compare("reassign I=%d R=%d E=%d stock %dx%d" % (
        I, R, E, STOCK.iters, STOCK.chains), big_got, big_ref)
    pb = paired_batch()

    # -- (k) the REASSIGN kernel's layouts
    layouts = reassign_layouts(big, big_ref, pb, gpu)
    max_err = max(max_err, layouts["max_err"])
    thr = threshold_events()
    thr_rb = padded_batch(thr, DEV, pad_reads=THRESH_R)
    thr_ms = threshold_times(thr_rb, gpu)

    # -- (a) the same for the MARGINAL kernel, in every plan: an empty
    # class and a padding event, CLASSES-sized class counts, paired-end
    # classes, the main path's bucket; its times by plan and shape
    small_m = SamplerConfig(algorithm="marginal", **SMALL)
    big_m = main_shape_batch("marginal")
    Em, Cm, Im = big_m.weights.shape
    m_layouts = marginal_layouts(big_m, pb, gpu)
    m_err = m_layouts["max_err"]
    # -- 3. Philox draws: the exact posterior and the plain version
    ev = simulated_event(*SE_GENE, [0.7, 0.3], 2000, 25, seed=42)
    exact = exact_posterior_mean_2iso(ev)
    cfg = SamplerConfig(**PHILOX)
    res = rk.run_batch_reassign(0, padded_batch([ev] * 8, DEV), cfg)
    means = res.to_numpy().flat_samples()[:, :, 0].mean(axis=1)
    print("exact posterior: exact %.4f, kernel means %s" % (
        exact, np.array2string(means, precision=4)))
    if not np.all(np.abs(means - exact) < 0.02):
        raise AssertionError("kernel misses the exact posterior")

    ev3 = simulated_event(*G3_GENE, [0.5, 0.3, 0.2], 3000, 25, seed=7)
    three_iso("reassign", both(2, padded_batch([ev3] * 8, DEV), cfg), cfg)

    # -- (b) MARGINAL and CLASSES with Philox draws: the collapsed model's
    # exact posterior from AUTO and from a wrong GIVEN start, and the
    # 3-isoform agreement with the plain version
    for algo in ("marginal", "classes"):
        cfg_a = SamplerConfig(algorithm=algo, **PHILOX)
        ev_a = simulated_event(*SE_GENE, [0.7, 0.3], 2000, 25, seed=42,
                               algorithm=algo)
        exact_a = exact_marginal_mean_2iso(ev_a)
        b = padded_batch([ev_a] * 8, DEV)
        wrong = torch.tensor([0.05, 0.95], device=DEV).expand(
            8, cfg_a.chains, 2).contiguous()
        for start, tol in ((None, 0.02), (wrong, 0.03)):
            res = mk.run_batch_marginal(1, b, cfg_a, start_psi=start)
            means = res.to_numpy().flat_samples()[:, :, 0].mean(axis=1)
            print("%s exact posterior (%s start): exact %.4f, kernel means "
                  "%s" % (algo, "AUTO" if start is None else "GIVEN (0.05, "
                          "0.95)", exact_a,
                          np.array2string(means, precision=4)))
            if not np.all(np.abs(means - exact_a) < tol):
                raise AssertionError("%s kernel misses the exact posterior"
                                     % algo)
        ev3a = simulated_event(*G3_GENE, [0.5, 0.3, 0.2], 3000, 25, seed=7,
                               algorithm=algo)
        three_iso(algo, both(2, padded_batch([ev3a] * 8, DEV), cfg_a), cfg_a)

    # -- (e) fixed uniforms at 128 isoforms (about 70 real) through the
    # wrappers, which take the wide kernels there (and B1w and B2w in
    # every plan at 128 ... 8,192 isoforms), and on paired-end events:
    # fragment-probability weights, log_iso_w = assscores near 11,
    # non-zero read scores; B2 on the same events
    wide_err = wide_plans_check()
    for given in (False, True):
        start = dirichlet_start(70, 2, 2, 128) if given else None
        wide_err["reassign"] = max(wide_err["reassign"], compare(
            "reassign I=128 (70 real) %s" % ("GIVEN" if given else "AUTO"),
            *both(0, lane_test_batch(128, 70, 128, DEV), small, start,
                  rk.FIXED_U)))
        wide_err["marginal"] = max(wide_err["marginal"], compare(
            "marginal I=128 (70 real) %s" % ("GIVEN" if given else "AUTO"),
            *both(0, marginal_lane_batch(128, 70, 128, DEV), small_m,
                  None if start is None else torch.cat(
                      [start, torch.zeros_like(start[:1])]), mk.FIXED_U)))
    print("  paired batch: E=%d C=%d R=%d, log_iso_w %.3f..%.3f, read "
          "scores down to %.2f" % (pb.weights.shape[0], pb.weights.shape[1],
                                   pb.read_w.shape[1],
                                   float(pb.log_iso_w.min()),
                                   float(pb.log_iso_w.max()),
                                   float(pb.read_logscore.min())))
    for cfg_p in (small, STOCK):
        tag = "stock %dx%d" % (cfg_p.iters, cfg_p.chains) \
            if cfg_p is STOCK else "small"
        max_err = max(max_err, compare("reassign paired-end %s" % tag,
                                       *both(0, pb, cfg_p, None,
                                             rk.FIXED_U)))
        cfg_pm = SamplerConfig(algorithm="marginal", iters=cfg_p.iters,
                               burn_in=cfg_p.burn_in, lag=cfg_p.lag,
                               chains=cfg_p.chains)
        m_err = max(m_err, compare("marginal paired-end %s" % tag,
                                   *both(0, pb, cfg_pm, None, mk.FIXED_U)))

    # -- (f) paired-end, Philox draws: the exact posterior
    # (tests/test_sampler.py::test_paired_end_recovery's event)
    ev_p = paired_event(*PAIRED_GENE, [0.65, 0.35], 1500, 30, 200.0, 10.0,
                        seed=11)
    exact_p = exact_posterior_mean_2iso(ev_p)
    res = rk.run_batch_reassign(0, padded_batch([ev_p] * 8, DEV), cfg)
    means = res.to_numpy().flat_samples()[:, :, 0].mean(axis=1)
    print("paired-end exact posterior: exact %.4f, kernel means %s" % (
        exact_p, np.array2string(means, precision=4)))
    if not np.all(np.abs(means - exact_p) < 0.02):
        raise AssertionError("kernel misses the paired exact posterior")

    # -- (h), first half: the million-read event of
    # tests/test_deep_events.py through B3 on the card, then B3 against
    # its plain version, its Philox chain, its draws and its posterior
    million_read_event()
    b3_k = multinomial_phase(gpu)

    # -- 4 and (c). the main paths: miso --run through the port
    with tempfile.TemporaryDirectory(prefix="miso_smoke_") as tmp:
        t = time.time()
        fix = indexed_catalog(os.path.join(tmp, "cat"), num_events=N_GENES,
                              reads_per_event=300, read_len=36, seed=1)
        print("catalog: %d genes x 300 reads built and indexed in %.1fs"
              % (N_GENES, time.time() - t))
        lc_r, heads_r = run_main_path(fix, tmp, "out", [], gpu)
        lc_m, _ = run_main_path(fix, tmp, "marginal_linear",
                                ["--algorithm", "marginal",
                                 "--linear-start"], gpu)
        lc_c, _ = run_main_path(fix, tmp, "classes",
                                ["--algorithm", "classes"], gpu)
        lc_v, heads = run_main_path(fix, tmp, "convergent",
                                    ["--convergent"], gpu)
        # -- (i) --pack-output: the same events in .miso_db, their
        # headers equal to the .miso run's but for chain-dependent fields
        lc_k, packed = run_main_path(fix, tmp, "packed", ["--pack-output"],
                                     gpu)
        if sorted(packed) != sorted(heads_r) or any(
                settled(packed[ev]) != settled(heads_r[ev])
                for ev in packed):
            raise AssertionError("--pack-output headers differ from the "
                                 ".miso run's")
        print("pack-output: %d .miso_db events, headers equal to the .miso "
              "run's (chain-dependent fields aside)" % len(packed))

        # -- (n) the mesh: both kernels sharded over [cuda:0] and [cuda:0,
        # cuda:0], then the main path over [cuda:0, cuda:0] on this catalog
        mesh_k, mesh_runs = mesh_phase(
            fix, tmp, big, big_m, {"out": lc_r, "marginal_linear": lc_m,
                                   "convergent": lc_v}, gpu)

        # -- (l) the rest of the user's path: two hosts on the one card,
        # then summarize, compare and filter over their merged tree and a
        # second sample, and the worker CLI
        lc_s, lc_w = rest_of_path(fix, tmp, lc_r, heads_r, gpu)

        # -- (g) the paired-end main path
        t = time.time()
        fix_p = indexed_catalog(os.path.join(tmp, "cat_pe"),
                                num_events=N_GENES, reads_per_event=150,
                                read_len=40, seed=1, paired=True)
        print("paired catalog: %d genes x 150 pairs of 40 nt built and "
              "indexed in %.1fs" % (N_GENES, time.time() - t))
        torch.cuda.reset_peak_memory_stats()
        lc_p, _ = run_main_path(fix_p, tmp, "paired",
                                ["--paired-end", "250", "15"], gpu,
                                read_len=40)
        print("paired-end main path: wall %.2fs, B1 %.1f ms over %d "
              "launches, peak device memory %.1f MiB  [%s]"
              % (lc_p.wall, lc_p.ms("reassign"),
                 lc_p.counts["reassign"]["cuda"],
                 torch.cuda.max_memory_allocated() / 2 ** 20, gpu))
        # the same catalog through MARGINAL: B2 at its widest class counts
        # (one class per fragment length).  Its means sit further above
        # the truth than the other runs' limit of 0.06 allows (the
        # collapsed chains sample the fragment fraction, as in the JAX
        # package: tests/test_torch_bias.py), so a quarter-size catalog
        # is run twice, once with the plain version in the kernel's
        # place: the two biases must agree, which makes the offset the
        # collapsed sampler's and not the kernel's
        flags_q = ["--paired-end", "250", "15", "--algorithm", "marginal"]
        lc_q, _ = run_main_path(fix_p, tmp, "paired_marginal", flags_q, gpu,
                                read_len=40, max_bias=0.08)
        # that run's largest launch once more on its own tensors and
        # schedule, under fixed uniforms, beside the plain version
        _, qb, qcfg, qconsts, qstart, _ = lc_q.largest["marginal"]
        t = time.time()
        m_err = max(m_err, compare(
            "marginal paired-end main path E=%d C=%d I=%d, %d x %d"
            % (tuple(qb.weights.shape) + (qcfg.iters, qcfg.chains)),
            mk.run_batch_marginal(0, qb, qcfg, start_psi=qstart,
                                  fixed_uniform=mk.FIXED_U),
            mk._marginal_plain(0, qb, qcfg, qconsts, qstart, mk.FIXED_U)))
        print("  (held in %.1fs)" % (time.time() - t))
        del qb, qconsts
        fix_q = indexed_catalog(os.path.join(tmp, "cat_pe_quarter"),
                                num_events=PLAIN_GENES, reads_per_event=150,
                                read_len=40, seed=1, paired=True)
        lc_qk, _ = run_main_path(fix_q, tmp, "paired_marginal_quarter",
                                 flags_q, gpu, read_len=40, max_bias=0.08)
        lc_qp, _ = run_main_path(fix_q, tmp, "paired_marginal_plain",
                                 flags_q, gpu, read_len=40, max_bias=0.08,
                                 plain_marginal=True)
        print("paired-end MARGINAL main path: wall %.2fs, B2 %.1f ms over "
              "%d launches, bias %+.4f; on %d genes bias %+.4f, with the "
              "plain version in the kernel's place %+.4f (wall %.2fs)  [%s]"
              % (lc_q.wall, lc_q.ms("marginal"),
                 lc_q.counts["marginal"]["cuda"], lc_q.bias, PLAIN_GENES,
                 lc_qk.bias, lc_qp.bias, lc_qp.wall, gpu))
        if abs(lc_qk.bias - lc_qp.bias) > 0.005:
            raise AssertionError("paired-end MARGINAL: the kernel's bias "
                                 "is not the plain version's")

        # -- (h), second half: a deep catalog through miso --run, then
        # once more under --profile: B3 and nothing else launches
        lc_d, lc_f = deep_catalog_runs(tmp, gpu)
    checks = [
        (lc_r, "reassign", lc_r.counts["marginal"]["cuda"] == 0),
        (lc_m, "marginal", lc_m.given["marginal"] >= 1
         and lc_m.counts["reassign"]["cuda"] == 0),
        (lc_c, "marginal", lc_c.counts["reassign"]["cuda"] == 0),
        (lc_v, "reassign", lc_v.counts["marginal"]["cuda"] == 0),
        (lc_k, "reassign", lc_k.counts["marginal"]["cuda"] == 0),
        (lc_s, "reassign", lc_s.counts["marginal"]["cuda"] == 0),
        (lc_w, "reassign", lc_w.counts["marginal"]["cuda"] == 0),
        (lc_p, "reassign", lc_p.counts["marginal"]["cuda"] == 0),
        (lc_q, "marginal", lc_q.counts["reassign"]["cuda"] == 0),
        (lc_qk, "marginal", lc_qk.counts["reassign"]["cuda"] == 0),
        (lc_d, "multinomial", lc_d.counts["reassign"]["cuda"] == 0),
        (lc_f, "multinomial", lc_f.counts["reassign"]["cuda"] == 0),
    ]
    for lc, kern, ok in checks:
        if lc.counts[kern]["cuda"] < 1 or not ok:
            raise AssertionError("main path launches: %s, GIVEN %s"
                                 % (lc.counts, lc.given))
    iters = np.array([int(re.search(r"iters=(\d+)", h).group(1))
                      for h in heads.values()])
    print("convergent: %d of %d events needed a continuation round "
          "(final iters %s)" % ((iters > STOCK.iters).sum(), len(iters),
                                sorted(set(iters.tolist()))))

    # -- (m) buckets of 512 and 2,048 isoforms, and the port's probes
    wide = wide_buckets(gpu)
    stream_pool_check(gpu)
    for kind in ("reassign", "marginal"):
        wide_err[kind] = max(wide_err[kind], wide[kind]["max_err"])
    probes()

    # B2w's step breakdown at both buckets and the barrier probe; its
    # dependent-chain floor from this run's probes (B3's latencies, the
    # barriers): an estimate, printed apart from the kernels line
    b2w = b2w_phase(gpu)
    b2w_floor_ms = {}
    for gene_iso, width in WIDE_GENES:
        shape = wide["marginal"]["I=%d" % width]["shape"]
        plan = mk.wide_plan(*shape, STOCK_M.chains)
        floor = deep.marginal_wide_floor(
            shape[1], width, plan.threads, plan.cluster, STOCK_M.iters,
            clocks={**b3_k["latencies"], **b2w["latencies"]})
        b2w_floor_ms["I=%d" % width] = floor
        wide["marginal"]["I=%d" % width]["step_clocks"] = (
            b2w["I=%d" % width]["step_clocks"])
        print("B2w's dependent-chain floor at the bucket of %d (plan %s; "
              "marginal_wide_floor from this run's probes, an estimate, "
              "not timed): %.2f ms; B2w %.2f ms = %.1fx it  [%s]"
              % (width, wide_tag(plan), floor,
                 wide["marginal"]["I=%d" % width]["direct_ms"],
                 wide["marginal"]["I=%d" % width]["direct_ms"] / floor, gpu))

    # -- 5 and (d). kernel and plain version at the main paths' buckets
    ms = timed(lambda: rk.run_batch_reassign(3, big, STOCK), reps=3)
    plain_ms = timed(lambda: rk._reassign_plain(
        3, big, STOCK, rk._event_consts(big)), reps=1)
    print("reassign time at I=%d R=%d E=%d, %d iters x %d chains: kernel "
          "%.2f ms, plain %.2f ms  [%s]" % (I, R, E, STOCK.iters,
                                            STOCK.chains, ms, plain_ms, gpu))
    m_ms = timed(lambda: mk.run_batch_marginal(3, big_m, STOCK_M), reps=3)
    m_plain_ms = timed(lambda: mk._marginal_plain(
        3, big_m, STOCK_M, mk._marginal_consts(big_m)), reps=1)
    print("marginal time at I=%d C=%d E=%d, %d iters x %d chains: kernel "
          "%.2f ms, plain %.2f ms  [%s]" % (Im, Cm, Em, STOCK.iters,
                                            STOCK.chains, m_ms, m_plain_ms,
                                            gpu))

    # -- (j) B3 at stock settings on 64 deep events, then at the
    # 16,384-read threshold beside B1 on the same 64 events
    b3_t = deep_times(thr, thr_ms, gpu)
    # the least time the card could take for each kernel's launch at its
    # main shape, from this run's inputs: reads with a compatible isoform,
    # classes with reads
    bound = rk.reassign_bound(
        E, R, I, STOCK.chains, STOCK.iters, STOCK.num_records,
        valid_reads=int((big.read_w.sum(-1) > 0).sum()))
    # the same work in the class form B1w runs (a row a class, a search a
    # read): B1's bound were it to read the classes
    bound_classes = rk.reassign_bound(
        E, R, I, STOCK.chains, STOCK.iters, STOCK.num_records,
        valid_reads=int((big.read_w.sum(-1) > 0).sum()),
        classes=int(rk.class_map(big.counts, R).nact.sum()))
    print("reassign bound at its main shape in the class form: %.4f ms "
          "(%s)" % (bound_classes["bound_ms"], bound_classes["bound_by"]))
    m_bound = mk.marginal_bound(
        Em, Cm, Im, STOCK_M.chains, STOCK_M.iters, STOCK_M.num_records,
        live_classes=int((big_m.counts > 0).sum()))
    for name, b in (("reassign", bound), ("marginal", m_bound)):
        print("%s bound at its main shape: %.3g bytes = %.4f ms, %.4g FP32 "
              "and %.4g integer operations, the pipes side by side = %.3f "
              "ms: bound by %s"
              % (name, b["bytes"], b["bytes_ms"], b["fp32_ops"],
                 b["int_ops"], b["ops_ms"], b["bound_by"]))
    print("each kernel before its redesign at the same shape (PERF.md, not "
          "timed here): reassign %.2f ms, marginal %.2f ms; the deep route "
          "before B3: %.1f ms at the deep catalog's bucket, %.2f ms at the "
          "threshold" % (EARLIER_MS["reassign"], EARLIER_MS["marginal"],
                         EARLIER_DEEP_MS["catalog"],
                         EARLIER_DEEP_MS["threshold"]))
    print("B3's dependent-chain floor at the deep catalog's bucket "
          "(multinomial_floor: an estimate from measured latencies, not "
          "timed): %.2f ms" % b3_k["floor_ms"])
    print("B2w's dependent-chain floor at the wide buckets "
          "(marginal_wide_floor: an estimate from this run's probes, not "
          "timed): %s ms" % ", ".join("%s %.2f" % kv
                                      for kv in b2w_floor_ms.items()))
    print("chip_smoke: %.1fs in all" % (time.time() - T_START))
    print(json.dumps({"kernels": [{
        "name": "reassign", "route": "cuda",
        "source": "miso_tpu_torch/csrc/reassign_kernel.cu",
        "replaces": "miso_tpu/sampler/pallas_kernel.py:120",
        "launches": lc_r.counts["reassign"]["cuda"]
        + lc_v.counts["reassign"]["cuda"] + lc_k.counts["reassign"]["cuda"]
        + lc_p.counts["reassign"]["cuda"] + lc_s.counts["reassign"]["cuda"]
        + lc_w.counts["reassign"]["cuda"]
        + mesh_runs["out"].counts["reassign"]["cuda"]
        + mesh_runs["convergent"].counts["reassign"]["cuda"],
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "bound_classes_ms": bound_classes["bound_ms"],
        "library_ms": None,
        "main_path_launches": lc_r.counts["reassign"]["cuda"],
        "main_path_ms": lc_r.ms("reassign"),
        "chunk_ms": layouts["chunk_ms"],
        "mesh": {"launches": mesh_runs["out"].counts["reassign"]["cuda"]
                 + mesh_runs["convergent"].counts["reassign"]["cuda"],
                 "walls_s": [mesh_runs["out"].wall,
                             mesh_runs["convergent"].wall],
                 "max_abs_err": mesh_k["max_err"]}}, {
        "name": "marginal", "route": "cuda",
        "source": "miso_tpu_torch/csrc/marginal_kernel.cu",
        "replaces": "miso_tpu/sampler/pallas_marginal.py:48",
        "launches": lc_m.counts["marginal"]["cuda"]
        + lc_c.counts["marginal"]["cuda"] + lc_q.counts["marginal"]["cuda"]
        + lc_qk.counts["marginal"]["cuda"]
        + mesh_runs["marginal_linear"].counts["marginal"]["cuda"],
        "max_abs_err": m_err, "ms": m_ms, "plain_ms": m_plain_ms,
        "bound_ms": m_bound["bound_ms"], "bound_by": m_bound["bound_by"],
        "library_ms": None,
        "main_path_launches": lc_m.counts["marginal"]["cuda"],
        "main_path_ms": lc_m.ms("marginal"),
        "chunk_ms": m_layouts["chunk_ms"], "plan": m_layouts["plan"],
        "mesh": {"launches":
                 mesh_runs["marginal_linear"].counts["marginal"]["cuda"],
                 "walls_s": [mesh_runs["marginal_linear"].wall]}}, {
        "name": "multinomial", "route": "cuda",
        "source": "miso_tpu_torch/csrc/multinomial_kernel.cu",
        "replaces": "miso_tpu/sampler/mcmc.py:383",
        "launches": lc_d.counts["multinomial"]["cuda"]
        + lc_f.counts["multinomial"]["cuda"],
        "max_abs_err": b3_k["max_err"], "ms": b3_k["ms"],
        "plain_ms": b3_k["plain_ms"],
        "bound_ms": b3_k["bound"]["bound_ms"],
        "bound_by": b3_k["bound"]["bound_by"], "library_ms": None,
        "plan_T": b3_k["plan_T"],
        "main_path_launches": lc_d.counts["multinomial"]["cuda"],
        "main_path_ms": lc_d.ms("multinomial"),
        "deep_catalog_wall_s": lc_d.wall,
        "stock_ms_e64": b3_t["stock_ms_e64"],
        "threshold": b3_t["threshold"],
        "binomial_moments": b3_k["moments"], "binomial_chi2": b3_k["chi2"],
        "plans_ms": b3_k["plans_ms"],
        "step_clocks": {"deep_catalog": b3_k["breakdown"]["step_clocks"],
                        "e64": b3_t["breakdown_e64"]["step_clocks"],
                        "threshold":
                        b3_t["breakdown_threshold"]["step_clocks"]},
        "posterior": b3_k["posterior"]}] + [{
        "name": kind + "_wide", "route": "cuda",
        "source": "miso_tpu_torch/csrc/wide_kernel.cu",
        "replaces": replaces,
        "launches": wide[kind]["launches"],
        "max_abs_err": wide_err[kind],
        "ms": wide[kind]["I=512"]["direct_ms"],
        "plain_ms": wide[kind]["I=512"]["plain_stock_ms"],
        "bound_ms": wide[kind]["I=512"]["bound_ms"],
        "bound_by": wide[kind]["I=512"]["bound_by"], "library_ms": None,
        "main_path_ms": wide[kind]["I=512"]["stock_ms"],
        "bucket_512": wide[kind]["I=512"],
        "bucket_2048": wide[kind]["I=2048"]}
        for kind, replaces in (
            ("reassign", "miso_tpu/sampler/pallas_kernel.py:120"),
            ("marginal", "miso_tpu/sampler/pallas_marginal.py:48"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] not in ([], ["marginal"], ["hosts"], ["mesh"],
                             ["multinomial"], ["wide"], ["streams"]) \
            or len(sys.argv) > (3 if sys.argv[1:2] in (["marginal"],
                                                       ["multinomial"])
                                else 2):
        sys.exit("usage: python3 chip_smoke.py [marginal [SASS_DIR] | hosts "
                 "| mesh | multinomial [SASS_DIR] | wide | streams]")
    sys.exit(main(*sys.argv[1:]))
