"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version and against the grid-exact posterior,
then runs ``miso --run`` through the port (``miso_tpu_torch.cli.main``)
on a 2,000-gene simulated catalog at stock sampler settings and checks
its output against the simulation truth.  Every phase that fails raises,
so the script exits non-zero and never prints its last line.  It needs
one CUDA device and fails without one.

The line before the last is ``{"kernels": [...]}``: per kernel, its
launches in the main-path run, its largest difference from the plain
version, and both times at the main path's bucket shape.  The last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(ROOT, "miso_tpu_torch", "csrc")):
    sys.exit("chip_smoke: run it from a checkout of the repo (no "
             "miso_tpu_torch/csrc beside %s)" % os.path.basename(__file__))
sys.path.insert(0, ROOT)

from miso_tpu_torch import kernels  # noqa: E402
from miso_tpu_torch.cli.main import main as miso_torch_main  # noqa: E402
from miso_tpu_torch.sampler import reassign_kernel as rk  # noqa: E402
from miso_tpu_torch.sampler.mcmc import SamplerConfig  # noqa: E402
from miso_tpu_torch.testing import (  # noqa: E402
    indexed_catalog, lane_test_batch, padded_batch, simulated_event)

# tests/exact_posterior.py is numpy/scipy only
sys.path.insert(0, os.path.join(ROOT, "tests"))
from exact_posterior import exact_posterior_mean_2iso  # noqa: E402

DEV = "cuda"
# fixed-uniform agreement of kernel and plain version: both are f32 and
# follow the same chain, differing only by rounding (the tolerances of
# tests/test_pallas_interpret.py)
PSI_ATOL, LL_ATOL, N_ATOL = 2e-4, 2e-3, 1e-5
STOCK = SamplerConfig()             # 5000 iters, burn-in 500, lag 10, 6 chains
SE_GENE = ([100, 50, 100], [[1, 2, 3], [1, 3]])  # make_se_catalog's gene
G3_GENE = ([100, 50, 80, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]])
MAIN_E, MAIN_R = 2048, 320          # the 2,000-gene run's bucket: I=2, R=320


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(name, got, ref):
    """Kernel result against the plain version's; returns max |d psi|."""
    got, ref = got.to_numpy(), ref.to_numpy()
    errs = {
        "psi": np.abs(got.psi_samples - ref.psi_samples).max(initial=0.0),
        "loglik": np.abs(got.loglik - ref.loglik).max(initial=0.0),
        "final_n": np.abs(got.final_n - ref.final_n).max(initial=0.0),
        "final_psi": np.abs(got.final_psi - ref.final_psi).max(initial=0.0),
    }
    ok = (errs["psi"] <= PSI_ATOL and errs["final_psi"] <= PSI_ATOL
          and errs["loglik"] <= LL_ATOL and errs["final_n"] <= N_ATOL
          and np.array_equal(got.accepted, ref.accepted))
    print("  %-34s max|dpsi| %.3g  max|dll| %.3g  max|dn| %.3g  "
          "accepted equal %s" % (name, errs["psi"], errs["loglik"],
                                 errs["final_n"],
                                 np.array_equal(got.accepted, ref.accepted)))
    if not ok:
        raise AssertionError("kernel disagrees with the plain version: %s"
                             % name)
    return float(errs["psi"])


def main_shape_batch():
    """MAIN_E events shaped like the 2,000-gene run's bucket: 64
    simulated SE events (300 reads of 36 nt) tiled."""
    rng = np.random.default_rng(1)
    evs = [simulated_event(*SE_GENE, [p, 1.0 - p], 300, 36, seed=100 + i)
           for i, p in enumerate(rng.uniform(0.05, 0.95, 64))]
    return padded_batch([evs[i % 64] for i in range(MAIN_E)], DEV,
                        pad_reads=MAIN_R)


def both(seed, batch, cfg, start=None, fixed=None):
    consts = rk._event_consts(batch)
    ref = rk._reassign_plain(seed, batch, cfg, consts, start, fixed)
    got = rk.run_batch_reassign(seed, batch, cfg, start_psi=start,
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


def main() -> int:
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
    # ptxas -v: per instantiation (isoform width I) registers and spills
    width = None
    for line in kernels.BUILD_INFO["log"].splitlines():
        m = re.search(r"entry function '\S*reassign_kernelILi(\d+)E", line)
        if m:
            width = m.group(1)
        elif width and ("spill" in line or "registers" in line):
            print("  I=%s: %s" % (width, line.split(":", 1)[-1].strip()))

    # -- 2. fixed uniforms: the kernel follows the plain version's chain
    print("fixed-uniform match, kernel vs plain version on the card:")
    small = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2)
    for num_iso in (2, 3):
        for given in (False, True):
            b = lane_test_batch(num_iso, num_iso, num_iso, DEV)
            start = None
            if given:
                sp = np.random.default_rng(9).dirichlet(
                    np.ones(num_iso), size=(2, 2)).astype(np.float32)
                start = torch.as_tensor(sp).to(DEV)
            compare("I=%d %s padded reads" % (num_iso,
                                             "GIVEN" if given else "AUTO"),
                    *both(0, b, small, start, rk.FIXED_U))
    big = main_shape_batch()
    E, R, I = big.read_w.shape
    max_err = compare("I=%d R=%d E=%d stock %dx%d" % (
        I, R, E, STOCK.iters, STOCK.chains),
        *both(0, big, STOCK, None, rk.FIXED_U))

    # -- 3. Philox draws: the exact posterior and the plain version
    ev = simulated_event(*SE_GENE, [0.7, 0.3], 2000, 25, seed=42)
    exact = exact_posterior_mean_2iso(ev)
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4)
    res = rk.run_batch_reassign(0, padded_batch([ev] * 8, DEV), cfg)
    means = res.to_numpy().flat_samples()[:, :, 0].mean(axis=1)
    print("exact posterior: exact %.4f, kernel means %s" % (
        exact, np.array2string(means, precision=4)))
    if not np.all(np.abs(means - exact) < 0.02):
        raise AssertionError("kernel misses the exact posterior")

    ev3 = simulated_event(*G3_GENE, [0.5, 0.3, 0.2], 3000, 25, seed=7)
    got, ref = both(2, padded_batch([ev3] * 8, DEV), cfg)
    got, ref = got.to_numpy(), ref.to_numpy()
    m1 = got.flat_samples()[0].mean(axis=0)
    m2 = ref.flat_samples()[0].mean(axis=0)
    a1 = float(got.accepted[0]) / (cfg.iters * cfg.chains)
    a2 = float(ref.accepted[0]) / (cfg.iters * cfg.chains)
    print("3-isoform: kernel means %s acc %.3f; plain means %s acc %.3f" % (
        np.array2string(m1, precision=4), a1,
        np.array2string(m2, precision=4), a2))
    if not (np.all(np.abs(m1 - m2) < 0.03) and abs(a1 - a2) < 0.06
            and a1 > 0.05):
        raise AssertionError("3-isoform kernel disagrees with plain")

    # -- 4. the main path: miso --run through the port
    kernel_ms = []
    launch = rk._reassign_cuda

    def timed_launch(*a, **kw):   # CUDA-event timing of each launch
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = launch(*a, **kw)
        t1.record()
        kernel_ms.append((t0, t1))
        return out

    with tempfile.TemporaryDirectory(prefix="miso_smoke_") as tmp:
        t = time.time()
        fix = indexed_catalog(os.path.join(tmp, "cat"), num_events=2000,
                              reads_per_event=300, read_len=36, seed=1)
        print("catalog: 2000 genes x 300 reads built and indexed in %.1fs"
              % (time.time() - t))
        out = os.path.join(tmp, "out")
        rk._reassign_cuda = timed_launch
        for key in rk.LAUNCHES:
            rk.LAUNCHES[key] = 0
        try:
            t = time.time()
            rc = miso_torch_main(["--run", fix["index"], fix["bam"],
                                  "--output-dir", out, "--read-len", "36"])
            torch.cuda.synchronize()
            wall = time.time() - t
        finally:
            rk._reassign_cuda = launch
        launches = dict(rk.LAUNCHES)
        if rc != 0:
            raise AssertionError("miso_torch --run returned %d" % rc)
        if launches["cuda"] < 1 or launches["plain"] != 0:
            raise AssertionError("main path launches: %s" % launches)
        names = set()
        for _, _, files in os.walk(out):
            names.update(f[:-5] for f in files if f.endswith(".miso"))
        missing = {"ev%d" % e for e in range(2000)} - names
        if missing:
            raise AssertionError("%d events have no .miso" % len(missing))
        summ = os.path.join(out, "summary", "out.miso_summary")
        with open(summ) as f:
            head = f.readline().rstrip("\n").split("\t")
            rows = [dict(zip(head, ln.rstrip("\n").split("\t")))
                    for ln in f if ln.strip()]
        mean = {r["event_name"]: float(r["miso_posterior_mean"])
                for r in rows}
        est = np.array([mean["ev%d" % e] for e in range(2000)])
        truth = fix["true_psi"]
        corr = float(np.corrcoef(est, truth)[0, 1])
        bias = float(np.mean(est - truth))
        k_ms = sum(a.elapsed_time(b) for a, b in kernel_ms)
        print("main path: 2000 events in %.2fs = %.1f events/s end to end; "
              "kernel %.1f ms over %d launches; %d .miso files + summary "
              "(%d rows); truth corr %.4f, bias %+.4f  [%s]" % (
                  wall, 2000 / wall, k_ms, launches["cuda"], len(names),
                  len(rows), corr, bias, gpu))
        if not (corr > 0.9 and abs(bias) < 0.06):
            raise AssertionError("posterior means miss the truth")

    # -- 5. kernel and plain version at the main path's bucket shape
    consts = rk._event_consts(big)
    ms = timed(lambda: rk.run_batch_reassign(3, big, STOCK), reps=3)
    plain_ms = timed(lambda: rk._reassign_plain(3, big, STOCK, consts),
                     reps=1)
    print("time at I=%d R=%d E=%d, %d iters x %d chains: kernel %.2f ms, "
          "plain %.2f ms  [%s]" % (I, R, E, STOCK.iters, STOCK.chains, ms,
                                   plain_ms, gpu))
    print(json.dumps({"kernels": [{
        "name": "reassign", "route": "cuda",
        "source": "miso_tpu_torch/csrc/reassign_kernel.cu",
        "replaces": "miso_tpu/sampler/pallas_kernel.py:120",
        "launches": launches["cuda"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
