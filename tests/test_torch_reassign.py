"""The port's REASSIGN sampler (miso_tpu_torch/sampler/reassign_kernel.py)
against the JAX package.

On the CPU the wrapper runs its plain PyTorch version.  In fixed-uniform
mode that version must reproduce the Pallas kernel's chain exactly (the
kernel runs in the Pallas interpreter with ``_DEBUG_NO_PRNG``, as
tests/test_pallas_interpret.py runs it).  With random draws it must
match the grid-exact posterior and the JAX XLA sampler.  The CUDA kernel
itself is compared with the plain version on the card
(tests/test_torch_cuda.py and ``chip_smoke.py``).
"""
import numpy as np
import pytest

import jax

import miso_tpu.sampler.pallas_kernel as pk
from miso_tpu.core.events import compile_single_end, pad_events
from miso_tpu.core.gene import make_gene
from miso_tpu.core.simulate import simulate_reads
from miso_tpu.sampler import mcmc as jmcmc
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler.mcmc import SamplerConfig, batch_from_numpy

from exact_posterior import exact_posterior_mean_2iso
from miso_tpu_torch.testing import cap_test_threads

cap_test_threads()

# Tolerances of tests/test_pallas_interpret.py: f32 chains that follow
# the same path differ only by rounding.
PSI_ATOL, LL_ATOL, N_ATOL = 2e-4, 2e-3, 1e-5


def _interp_batch(num_iso, seed, padded=True):
    """The inputs of test_pallas_interpret.py: E=2 events, R=16 reads,
    random compatibility with read 0 compatible with every isoform and,
    when padded, three all-zero (padding) reads."""
    R, E, I = 16, 2, num_iso
    rng = np.random.default_rng(seed)
    read_w = (rng.random((E, R, I)) < 0.7).astype(np.float32)
    if padded:
        read_w[:, -3:, :] = 0.0
    read_w[:, 0, :] = 1.0
    rls = np.where(read_w > 0, np.log(0.01 + rng.random((E, R, I))), 0.0
                   ).astype(np.float32)
    log_iso_w = np.log(np.array([[200.0, 120.0, 80.0][:I]] * E, np.float32))
    return jmcmc.EventBatch(
        weights=np.zeros((E, 4, I), np.float32),
        log_read=np.zeros((E, 4, I), np.float32),
        counts=np.zeros((E, 4), np.float32),
        log_iso_w=log_iso_w,
        hyper=np.ones((E, I), np.float32),
        num_iso=np.full((E,), num_iso, np.int32),
        read_w=read_w, read_logscore=rls)


def _assert_same_chain(a, b):
    np.testing.assert_allclose(a.psi_samples, b.psi_samples, rtol=0,
                               atol=PSI_ATOL)
    np.testing.assert_allclose(a.loglik, b.loglik, rtol=0, atol=LL_ATOL)
    np.testing.assert_allclose(a.final_n, b.final_n, rtol=0, atol=N_ATOL)
    np.testing.assert_allclose(a.final_psi, b.final_psi, rtol=0,
                               atol=PSI_ATOL)
    np.testing.assert_array_equal(a.accepted, b.accepted)


@pytest.mark.parametrize("num_iso,given", [(2, False), (3, False),
                                           (2, True), (3, True)])
def test_plain_fixed_uniform_matches_pallas_interpret(monkeypatch, num_iso,
                                                      given):
    monkeypatch.setattr(pk, "_DEBUG_NO_PRNG", True)
    batch = _interp_batch(num_iso, seed=5 if given else 0,
                          padded=not given)
    K = 2
    start = None
    if given and num_iso == 2:
        # distinct start per (event, chain), as test_kernel_given_start
        p0 = np.array([[0.9, 0.3], [0.6, 0.15]], np.float32)
        start = np.stack([p0, 1.0 - p0], axis=-1).astype(np.float32)
    elif given:
        start = np.random.default_rng(9).dirichlet(
            np.ones(num_iso), size=(2, K)).astype(np.float32)
    jcfg = jmcmc.SamplerConfig(iters=24, burn_in=6, lag=3, chains=K)
    ref = pk.run_batch_pallas(jax.random.PRNGKey(0), batch, jcfg,
                              interpret=True, start_psi=start)
    ref = jmcmc.SamplerResult(*(np.asarray(x) for x in ref))
    tb, tstart = batch_from_numpy(batch, "cpu", start)
    got = rk.run_batch_reassign(
        0, tb, SamplerConfig(iters=24, burn_in=6, lag=3, chains=K),
        start_psi=tstart, fixed_uniform=rk.FIXED_U).to_numpy()
    assert got.psi_samples.shape == ref.psi_samples.shape
    _assert_same_chain(got, ref)


def test_plain_fixed_uniform_matches_pallas_interpret_at_64_isoforms(
        monkeypatch):
    """A wide bucket, 33 real isoforms padded to 64: the loops over the
    isoforms that the wide kernel instances roll.  (Tracing the JAX
    kernel's Python lists takes minutes from 128 isoforms on.)"""
    from miso_tpu_torch.testing import lane_test_batch

    monkeypatch.setattr(pk, "_DEBUG_NO_PRNG", True)
    tb = lane_test_batch(64, 33, 64, "cpu")
    batch = jmcmc.EventBatch(*(t.numpy() for t in tb))
    sched = dict(iters=24, burn_in=6, lag=3, chains=2)
    ref = pk.run_batch_pallas(jax.random.PRNGKey(0), batch,
                              jmcmc.SamplerConfig(**sched), interpret=True)
    ref = jmcmc.SamplerResult(*(np.asarray(x) for x in ref))
    got = rk.run_batch_reassign(0, tb, SamplerConfig(**sched),
                                fixed_uniform=rk.FIXED_U).to_numpy()
    assert got.psi_samples.shape == ref.psi_samples.shape == (2, 6, 2, 64)
    _assert_same_chain(got, ref)
    assert (got.psi_samples[..., 33:] == 0).all()


def _demo_event(psi, n_reads, seed):
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    _, pos, cig = simulate_reads(g, psi, n_reads, 25,
                                 np.random.default_rng(seed))
    return compile_single_end(g, pos, cig, read_len=25)


def test_plain_matches_exact_posterior():
    """tests/test_pallas.py::test_pallas_matches_exact_posterior with the
    plain version: every event's posterior mean within 0.02 of the
    grid-exact one."""
    ev = _demo_event([0.7, 0.3], 2000, seed=42)
    exact = exact_posterior_mean_2iso(ev)
    tb, _ = batch_from_numpy(pad_events([ev] * 4, read_dtype=np.float32),
                             "cpu")
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4)
    res = rk.run_batch_reassign(11, tb, cfg).to_numpy()
    means = res.flat_samples()[:, :, 0].mean(axis=1)
    assert np.all(np.abs(means - exact) < 0.02), (means, exact)


def test_plain_three_isoform_agrees_with_xla():
    """A 3-isoform event (multi-dim proposal, masked edge): posterior
    means within 0.03 and acceptance within 0.06 of the JAX XLA sampler
    (the agreement test_pallas.py asks of the TPU kernel)."""
    g3 = make_gene([100, 50, 80, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]])
    _, pos, cig = simulate_reads(g3, [0.5, 0.3, 0.2], 1000, 25,
                                 np.random.default_rng(7))
    ev = compile_single_end(g3, pos, cig, read_len=25)
    pad = pad_events([ev] * 2, read_dtype=np.float32)
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4)
    ref = jmcmc.run_batch(
        jax.random.PRNGKey(3), jmcmc.EventBatch(**pad),
        jmcmc.SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4))
    tb, _ = batch_from_numpy(pad, "cpu")
    got = rk.run_batch_reassign(2, tb, cfg).to_numpy()
    m1 = got.flat_samples()[0].mean(axis=0)
    m2 = np.asarray(ref.flat_samples())[0].mean(axis=0)
    assert np.all(np.abs(m1 - m2) < 0.03), (m1, m2)
    a1 = float(got.accepted[0]) / (cfg.iters * cfg.chains)
    a2 = float(ref.accepted[0]) / (cfg.iters * cfg.chains)
    assert abs(a1 - a2) < 0.06, (a1, a2)
    assert a1 > 0.05, ("chain frozen", a1)


def test_cpu_tensors_take_the_plain_route():
    batch = _interp_batch(2, seed=0)
    tb, _ = batch_from_numpy(batch, "cpu")
    before = dict(rk.LAUNCHES)
    res = rk.run_batch_reassign(
        1, tb, SamplerConfig(iters=12, burn_in=2, lag=2, chains=3))
    assert rk.LAUNCHES["plain"] == before["plain"] + 1
    assert rk.LAUNCHES["cuda"] == before["cuda"]
    assert res.psi_samples.shape == (2, 5, 3, 2)
    assert res.psi_samples.device.type == "cpu"
    s = res.psi_samples.numpy()
    assert np.all(np.isfinite(s)) and np.allclose(s.sum(-1), 1.0, atol=1e-5)
    # every valid read is assigned exactly once
    n_valid = (batch.read_w.sum(-1) > 0).sum(-1)
    np.testing.assert_array_equal(res.final_n.numpy().sum(-1),
                                  np.repeat(n_valid[:, None], 3, axis=1))


def test_padding_events_do_not_poison_real_lanes():
    """A pow2-padding event (num_iso = 0) beside real ones: the real
    lanes' chain is unchanged by its presence."""
    from miso_tpu_torch.sampler.mcmc import _pow2_pad_events
    batch = _interp_batch(3, seed=1)
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2)
    alone, _ = batch_from_numpy(batch, "cpu")
    three = jmcmc.EventBatch(*(np.asarray(a)[[0, 1, 0]] for a in batch))
    padded, _ = _pow2_pad_events(three, None, 3)
    assert padded.num_iso[3] == 0
    tp, _ = batch_from_numpy(padded, "cpu")
    a = rk.run_batch_reassign(0, alone, cfg, fixed_uniform=rk.FIXED_U)
    b = rk.run_batch_reassign(0, tp, cfg, fixed_uniform=rk.FIXED_U)
    a, b = a.to_numpy(), b.to_numpy()
    np.testing.assert_array_equal(a.psi_samples, b.psi_samples[:2])
    np.testing.assert_array_equal(a.loglik, b.loglik[:2])
    np.testing.assert_array_equal(a.accepted, b.accepted[:2])
    np.testing.assert_array_equal(b.final_n[3], 0.0)
