"""The port's MARGINAL / CLASSES sampler
(miso_tpu_torch/sampler/marginal_kernel.py) and its pipeline routing
against the JAX package.

On the CPU the wrapper runs its plain PyTorch version.  In fixed-uniform
mode that version must reproduce the Pallas kernel's chain (run in the
Pallas interpreter with ``_DEBUG_NO_PRNG``, as
tests/test_pallas_interpret.py runs it).  With random draws it must
match the grid-exact posterior of the collapsed model and the JAX XLA
sampler.  The CUDA kernel itself is held to the plain version on the
card (tests/test_torch_cuda.py and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax

import miso_tpu.sampler.pallas_kernel as pk
import miso_tpu.sampler.pallas_marginal as pm
import miso_tpu_torch.pipeline as tp
from miso_tpu.core.events import _round_up_reads, pad_events
from miso_tpu.sampler import mcmc as jmcmc
from miso_tpu_torch._host import RunConfig
from miso_tpu_torch.sampler import deep
from miso_tpu_torch.sampler import marginal_kernel as mk
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler.mcmc import SamplerConfig, batch_from_numpy
from miso_tpu_torch.testing import (cap_test_threads, exact_marginal_mean_2iso,
                                    marginal_lane_batch, simulated_event)

cap_test_threads()

# Tolerances of tests/test_pallas_interpret.py: f32 chains that follow
# the same path differ only by rounding.
PSI_ATOL, LL_ATOL = 2e-4, 2e-3
SE_GENE = ([100, 50, 100], [[1, 2, 3], [1, 3]])
G3_GENE = ([100, 50, 80, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]])
SMALL = dict(iters=24, burn_in=6, lag=3, chains=2)
LONG = dict(iters=1500, burn_in=300, lag=5, chains=4)


def _start(num_iso, K, E=2):
    return np.random.default_rng(9).dirichlet(
        np.ones(num_iso), size=(E, K)).astype(np.float32)


@pytest.mark.parametrize("num_iso,real,given,algorithm", [
    (2, 2, False, "marginal"), (3, 3, False, "marginal"),
    (2, 2, True, "marginal"), (3, 3, True, "marginal"),
    (64, 33, False, "marginal"),
    (64, 60, False, "marginal"), (64, 64, False, "marginal"),
    (64, 60, False, "classes"), (64, 64, False, "classes")])
def test_plain_fixed_uniform_matches_pallas_interpret(monkeypatch, num_iso,
                                                      real, given,
                                                      algorithm):
    """The JAX kernel runs the two real events; the port runs them beside
    a padding event, whose lanes must not touch theirs.  The last cases
    are a bucket of 64 isoforms with 33, 60 and 64 real ones, which the
    wrapper runs in B2w's summing order (``wide.WIDE_FROM_MARGINAL``):
    in B2's order, isoform sums in sequence, the f32 MH ratio at 60 and
    64 real isoforms rounded away from the JAX kernel's (18 and 26 of 48
    steps accepted against 48), in B2w's it does not.  (Past ~200 real
    isoforms the f32 rounding of the psi-space proposal densities is of
    the size of the MH ratio itself in both packages, and two
    implementations that round differently take different accept
    decisions.)"""
    monkeypatch.setattr(pk, "_DEBUG_NO_PRNG", True)
    tb = marginal_lane_batch(num_iso, real, seed=num_iso, device="cpu")
    nb = jmcmc.EventBatch(*(t.numpy()[:2] for t in tb))
    K = SMALL["chains"]
    start = _start(num_iso, K) if given else None
    ref = pm.run_batch_pallas_marginal(
        jax.random.PRNGKey(0), nb,
        jmcmc.SamplerConfig(algorithm=algorithm, **SMALL),
        interpret=True, start_psi=start)
    tstart = None
    if given:
        tstart = torch.zeros((3, K, num_iso))
        tstart[:2] = torch.from_numpy(start)
    got = mk.run_batch_marginal(
        0, tb, SamplerConfig(algorithm=algorithm, **SMALL),
        start_psi=tstart, fixed_uniform=mk.FIXED_U).to_numpy()
    assert got.psi_samples.shape == (3, 6, K, num_iso)
    np.testing.assert_allclose(got.psi_samples[:2], ref.psi_samples,
                               rtol=0, atol=PSI_ATOL)
    np.testing.assert_allclose(got.loglik[:2], ref.loglik, rtol=0,
                               atol=LL_ATOL)
    np.testing.assert_allclose(got.final_psi[:2], ref.final_psi, rtol=0,
                               atol=PSI_ATOL)
    np.testing.assert_array_equal(got.accepted[:2],
                                  np.asarray(ref.accepted))
    np.testing.assert_array_equal(got.final_n, 0.0)


@pytest.mark.parametrize("algorithm,given", [
    ("marginal", False), ("classes", False), ("marginal", True),
    ("classes", True)])
def test_plain_matches_exact_posterior(algorithm, given):
    """Posterior means within 0.02 of the collapsed model's grid-exact
    mean (tests/test_sampler.py:132-140), and within 0.03 from a wrong
    GIVEN start at psi = (0.05, 0.95)."""
    ev = simulated_event(*SE_GENE, [0.7, 0.3], 2000, 25, seed=42,
                         algorithm=algorithm)
    exact = exact_marginal_mean_2iso(ev)
    cfg = SamplerConfig(algorithm=algorithm, **LONG)
    tb, start = batch_from_numpy(
        pad_events([ev] * 2, read_dtype=np.float32, per_read=False), "cpu",
        np.tile(np.float32([0.05, 0.95]), (2, cfg.chains, 1))
        if given else None)
    res = mk.run_batch_marginal(11, tb, cfg, start_psi=start).to_numpy()
    means = res.flat_samples()[:, :, 0].mean(axis=1)
    tol = 0.03 if given else 0.02
    assert np.all(np.abs(means - exact) < tol), (means, exact)


@pytest.mark.parametrize("algorithm", ["marginal", "classes"])
def test_plain_three_isoform_agrees_with_xla(algorithm):
    """A 3-isoform event (multi-dim proposal, masked edge): means within
    0.03 and acceptance within 0.05 of the JAX XLA sampler, and no frozen
    chain (the carried-score and TF32 faults of docs/VALIDATION.md)."""
    ev = simulated_event(*G3_GENE, [0.5, 0.3, 0.2], 1000, 25, seed=7,
                         algorithm=algorithm)
    pad = pad_events([ev] * 2, read_dtype=np.float32)
    ref = jmcmc.run_batch(jax.random.PRNGKey(3), jmcmc.EventBatch(**pad),
                          jmcmc.SamplerConfig(algorithm=algorithm, **LONG))
    tb, _ = batch_from_numpy(pad, "cpu")
    cfg = SamplerConfig(algorithm=algorithm, **LONG)
    got = mk.run_batch_marginal(2, tb, cfg).to_numpy()
    m1 = got.flat_samples()[0].mean(axis=0)
    m2 = np.asarray(ref.flat_samples())[0].mean(axis=0)
    assert np.all(np.abs(m1 - m2) < 0.03), (m1, m2)
    a1 = float(got.accepted[0]) / (cfg.iters * cfg.chains)
    a2 = float(ref.accepted[0]) / (cfg.iters * cfg.chains)
    assert abs(a1 - a2) < 0.05, (a1, a2)
    assert a1 > 0.05, ("chain frozen", a1)


def test_padding_events_do_not_change_real_lanes():
    cfg = SamplerConfig(algorithm="marginal", **SMALL)
    padded = marginal_lane_batch(3, 3, seed=1, device="cpu")
    alone = type(padded)(*(t[:2] for t in padded))
    a = mk.run_batch_marginal(0, alone, cfg, fixed_uniform=mk.FIXED_U)
    b = mk.run_batch_marginal(0, padded, cfg, fixed_uniform=mk.FIXED_U)
    a, b = a.to_numpy(), b.to_numpy()
    np.testing.assert_array_equal(a.psi_samples, b.psi_samples[:2])
    np.testing.assert_array_equal(a.loglik, b.loglik[:2])
    np.testing.assert_array_equal(a.accepted, b.accepted[:2])
    np.testing.assert_array_equal(a.final_psi, b.final_psi[:2])
    # the padding event's lanes stay finite (psi 0, score 0): its clamped
    # k gives finite constants where the TPU kernel's are inf and NaN
    assert np.all(b.psi_samples[2] == 0.0) and np.all(b.loglik[2] == 0.0)


def test_cpu_tensors_take_the_plain_route():
    tb = marginal_lane_batch(2, 2, seed=0, device="cpu")
    before = dict(mk.LAUNCHES)
    res = mk.run_batch_marginal(1, tb, SamplerConfig(
        iters=12, burn_in=2, lag=2, chains=3, algorithm="classes"))
    assert mk.LAUNCHES["plain"] == before["plain"] + 1
    assert mk.LAUNCHES["cuda"] == before["cuda"]
    assert res.psi_samples.shape == (3, 5, 3, 2)
    assert res.psi_samples.device.type == "cpu"
    s = res.psi_samples.numpy()[:2]
    assert np.all(np.isfinite(s)) and np.allclose(s.sum(-1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="MARGINAL or CLASSES"):
        mk.run_batch_marginal(1, tb, SamplerConfig(iters=4, burn_in=0,
                                                   lag=1))


def _record_marginal(monkeypatch):
    """Wrap the pipeline's MARGINAL entry point; returns the list of
    results it produced."""
    seen = []

    def recording(*a, **kw):
        res = mk.run_batch_marginal(*a, **kw)
        seen.append(res)
        return res

    monkeypatch.setattr(tp, "run_batch_marginal", recording)
    return seen


@pytest.mark.parametrize("algorithm", ["marginal", "classes"])
def test_final_n_is_the_host_assignment_of_chain_0(monkeypatch, algorithm):
    evs = [simulated_event(*SE_GENE, [p, 1 - p], 300, 25, seed=s,
                           algorithm=algorithm)
           for s, p in enumerate((0.3, 0.6, 0.8))]
    seen = _record_marginal(monkeypatch)
    cfg = RunConfig(read_len=25, iters=60, burn_in=10, lag=5, chains=2,
                    algorithm=algorithm)
    out = tp.run_events(evs, cfg, seed=0, device="cpu")
    assert len(seen) == 1
    final_psi = seen[0].final_psi.numpy()
    for j, (ev, res) in enumerate(zip(evs, out)):
        want = ev.final_assignment_counts(final_psi[j, 0, :ev.num_iso])
        np.testing.assert_array_equal(res["final_n"], want)
        assert res["final_n"].sum() == ev.classes.counts.sum()


def test_deep_marginal_event_runs_without_read_tiles(monkeypatch):
    """MARGINAL over 16,384 reads: no multinomial step is needed and no
    per-read tile is built (REASSIGN takes the deep route there, without
    tiles too)."""
    ev = simulated_event(*SE_GENE, [0.4, 0.6], 17000, 25, seed=3,
                         algorithm="marginal")
    assert _round_up_reads(int(ev.counts.sum())) > tp.DEEP_READS

    def no_tiles(*a, **kw):
        raise AssertionError("per-read tiles built for MARGINAL")

    monkeypatch.setattr(rk, "expand_read_tensors", no_tiles)
    cfg = RunConfig(read_len=25, iters=200, burn_in=50, lag=5, chains=2,
                    algorithm="marginal")
    res = tp.run_events([ev], cfg, seed=0, device="cpu")[0]
    assert res["psi_ticks"].shape == (60, 2)
    assert abs(res["samples"][:, 0].mean()
               - exact_marginal_mean_2iso(ev)) < 0.03
    ev_r = simulated_event(*SE_GENE, [0.4, 0.6], 17000, 25, seed=3)
    launches = deep.LAUNCHES["plain"]
    res = tp.run_events([ev_r], RunConfig(read_len=25, iters=20, burn_in=0,
                                          lag=1, chains=2), device="cpu")[0]
    assert deep.LAUNCHES["plain"] == launches + 1
    assert float(np.sum(res["final_n"])) == float(ev_r.counts.sum())
