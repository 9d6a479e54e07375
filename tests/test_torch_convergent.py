"""Convergent stopping and the linear start in the port
(miso_tpu_torch/sampler/convergent.py, stats/rhat.py, pipeline.py)
against the JAX package, after tests/test_adaptive.py."""
import functools
import glob
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import miso_tpu_torch.pipeline as tp
from miso_tpu.core.assignment import linear_start_psi
from miso_tpu.core.events import _round_up_reads, pad_events
from miso_tpu.stats import rhat as jrhat
from miso_tpu_torch._host import RunConfig, _write_events_batch
from miso_tpu_torch.sampler import convergent as cv
from miso_tpu_torch.sampler.mcmc import EventBatch, SamplerConfig
from miso_tpu_torch.stats.rhat import batch_rhat, extended_iterations
from miso_tpu_torch.testing import cap_test_threads, simulated_event

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from exact_posterior import exact_posterior_mean_2iso  # noqa: E402

cap_test_threads()

SE_GENE = ([100, 50, 100], [[1, 2, 3], [1, 3]])
CPU = (torch.device("cpu"),)   # a mesh of one entry


def _events(n, seed):
    rng = np.random.default_rng(seed)
    return [simulated_event(*SE_GENE, [p, 1 - p], 1000, 25,
                            seed=seed * 100 + e)
            for e, p in enumerate(rng.uniform(0.2, 0.8, n))]


def _batch(evs):
    pad = pad_events(evs, read_dtype=np.float32, per_read=False)
    R = _round_up_reads(max(int(ev.counts.sum()) for ev in evs))
    return EventBatch(**pad), R


def _run(evs, cfg, seed=0, **kw):
    batch, R = _batch(evs)
    sampler = functools.partial(tp.run_sampler, pad_reads=R)
    return cv.run_batch_convergent([seed], batch, cfg, sampler, CPU, **kw)


@pytest.mark.parametrize("case", ["converged", "divergent", "one_record"])
def test_batch_rhat_matches_jax(case):
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 0.05, size=(4, 200, 4, 3)).astype(np.float32)
    if case == "divergent":
        x[1, :, 0, :] += 0.5         # one chain stuck elsewhere
        x[2, :, :, 2] = 0.25         # a constant isoform: W = 0
    elif case == "one_record":
        x = x[:, :1]
    want = np.asarray(jrhat.batch_rhat(jnp.asarray(x)))
    with np.errstate(invalid="ignore", divide="ignore"):
        got = batch_rhat(torch.from_numpy(x)).numpy()
    # f32 sums in another order: a few ulps of R-hat
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if case == "divergent":
        assert np.all(got[1] > 1.1) and np.all(got[0] < 1.05)


def test_extension_rule():
    assert extended_iterations(5000, 500) == jrhat.extended_iterations(
        5000, 500) == 14000


def test_convergent_extension_is_bucketed(monkeypatch):
    """An impossible threshold forces an extension for every event: 200
    iterations, then 3*200 - 2*50 = 500; the next round would need 1100 >
    max_iters, so all stop there.  Continuation batches pad 5 events to
    8."""
    evs = _events(5, seed=7)
    sizes = []
    batch, R = _batch(evs)

    def sampler(seed, b, cfg, start):
        sizes.append((b.weights.shape[0], cfg.iters, start is None))
        return tp.run_sampler(seed, b, cfg, start, pad_reads=R)

    cfg = SamplerConfig(iters=200, burn_in=50, lag=2, chains=2)
    results, iters_used = cv.run_batch_convergent(
        [2], batch, cfg, sampler, CPU, max_iters=700, rhat_threshold=0.0)
    assert sizes == [(8, 200, True), (8, 500, False)]
    assert np.all(iters_used == 500), iters_used
    for r in results:
        assert r["iters"] == 500 and r["burn_in"] == 200
        assert r["samples"].shape == (2 * (500 - 200) // 2, 2)
        assert np.all(np.abs(r["samples"].sum(axis=1) - 1.0) < 1e-3)


def test_convergent_pipeline_records_schedule(tmp_path):
    """``--convergent``: each event's final schedule lands in its .miso
    header (iters=/burn_in=)."""
    evs = _events(3, seed=9)
    for e, ev in enumerate(evs):
        ev.name = "ev%d" % e
    cfg = RunConfig(read_len=25, iters=300, burn_in=60, lag=3, chains=2,
                    stop="convergent", max_iters=4000)
    results = tp.run_events(evs, cfg, seed=1, device="cpu")
    for r in results:
        assert r["iters"] >= 300 and np.isfinite(r["samples"]).all()
        assert "summary" in r
    assert _write_events_batch(str(tmp_path), cfg, evs, results) == 3
    paths = sorted(glob.glob(str(tmp_path / "*" / "*.miso")))
    assert len(paths) == 3
    for p, r in zip(paths, results):
        with open(p) as f:
            head = f.readline()
        assert "iters=%d" % r["iters"] in head
        assert "burn_in=%d" % r["burn_in"] in head


@pytest.mark.parametrize("growth", [2.0, 1.0])
def test_convergent_growth_matches_exact_posterior(growth):
    evs = _events(2, seed=11)
    cfg = SamplerConfig(iters=300, burn_in=100, lag=2, chains=4)
    results, _ = _run(evs, cfg, seed=2, max_iters=20000,
                      extend_factor=growth)
    for ev, r in zip(evs, results):
        exact = exact_posterior_mean_2iso(ev)
        got = float(r["samples"][:, 0].mean())
        assert abs(got - exact) < 0.03, (growth, got, exact)


def test_convergent_growth_below_one_raises():
    with pytest.raises(ValueError, match="extend_factor"):
        _run(_events(1, seed=0), SamplerConfig(iters=200, burn_in=50,
                                               lag=2, chains=2),
             extend_factor=0.5)


def test_rounds_draw_different_streams():
    evs = _events(2, seed=4)
    batch, R = _batch(evs)
    seeds = []

    def sampler(seed, b, cfg, start):
        seeds.append(seed)
        return tp.run_sampler(seed, b, cfg, start, pad_reads=R)

    cv.run_batch_convergent([5], batch, SamplerConfig(iters=40, burn_in=10,
                                                      lag=2, chains=2),
                            sampler, CPU, max_iters=400,
                            rhat_threshold=0.0, extend_factor=1.0)
    assert len(seeds) >= 3 and len(set(seeds)) == len(seeds)
    assert 5 not in seeds
    assert cv.round_seed(5, 1) == seeds[1]


@pytest.mark.parametrize("stop", ["fixed", "convergent"])
@pytest.mark.parametrize("algorithm", ["reassign", "marginal"])
def test_linear_start_reaches_the_sampler(monkeypatch, algorithm, stop):
    """``--linear-start``: every chain of round 0 starts at the event's
    NNLS solution (padded isoforms 0), for either kernel and stop rule."""
    evs = [simulated_event(*SE_GENE, [p, 1 - p], 400, 25, seed=s,
                           algorithm=algorithm)
           for s, p in enumerate((0.25, 0.7))]
    starts = []
    run = tp.run_sampler

    def sampler(seed, batch, cfg, start_psi, pad_reads):
        starts.append(None if start_psi is None else start_psi.numpy())
        return run(seed, batch, cfg, start_psi, pad_reads)

    monkeypatch.setattr(tp, "run_sampler", sampler)
    cfg = RunConfig(read_len=25, iters=100, burn_in=20, lag=5, chains=3,
                    algorithm=algorithm, start="linear", stop=stop)
    out = tp.run_events(evs, cfg, seed=0, device="cpu")
    assert all(np.isfinite(r["samples"]).all() for r in out)
    sp = starts[0]
    assert sp.shape == (2, 3, 2)
    for j, ev in enumerate(evs):
        want = linear_start_psi(ev, 25, 1)
        np.testing.assert_allclose(sp[j], np.tile(want, (3, 1)), atol=1e-7)
