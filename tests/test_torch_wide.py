"""The port at a bucket of 2,048 isoforms against the JAX package, on the
CPU: a gene of 1,100 isoforms (``testing.wide_event``, 13 exons), which
the card runs through the wide kernels B1w and B2w
(miso_tpu_torch/csrc/wide_kernel.cu) and the CPU through their plain
versions in the wide summing order.  The kernels themselves are held to
those plain versions on the CPU (tests/test_torch_kernel_source.py
``-k wide``) and on the card (``chip_smoke.py``, ``pytest -m cuda``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from exact_posterior import exact_posterior_mean_2iso
from miso_tpu import pipeline as jpipeline
from miso_tpu.core.events import pad_events as jpad_events
from miso_tpu.sampler import mcmc as jmcmc
from miso_tpu.sampler import model as jm
import miso_tpu_torch.pipeline as tp
from miso_tpu_torch.sampler import marginal_kernel as mk
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler import wide
from miso_tpu_torch.sampler.mcmc import SamplerConfig, batch_from_numpy
from miso_tpu_torch.testing import (cap_test_threads, padded_batch,
                                    simulated_event, wide_event)

cap_test_threads()

NUM_ISO, WIDTH = 1100, 2048


def _gene(algorithm="reassign", n_reads=64, seed=3):
    ev = wide_event(algorithm, num_iso=NUM_ISO, n_reads=n_reads, seed=seed)
    assert tp._bucket_key(ev)[0] == WIDTH >= wide.WIDE_FROM
    return ev


def test_read_tensors_of_a_wide_bucket_match_jax():
    """The port's per-read tiles, expanded on the device from the class
    tensors, are the JAX package's: ``pad_events``' per-read layout to
    1e-5 relative (both f32), and the JAX device expansion's to the bit
    once rounded to its bf16."""
    ev = _gene()
    host = jpad_events([ev], read_dtype=np.float32)
    R = host["read_w"].shape[1]
    cls = jpad_events([ev], per_read=False)
    rw, rls = rk.expand_read_tensors(*(torch.from_numpy(cls[k]) for k in (
        "weights", "log_read", "counts")), R)
    assert rw.shape == (1, R, WIDTH) and rw.dtype == torch.float32
    np.testing.assert_allclose(rw.numpy(), host["read_w"], rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(rls.numpy(), host["read_logscore"],
                               rtol=1e-5, atol=0)
    jw, jls = jpipeline._expand_read_tensors(*(jnp.asarray(cls[k]) for k in (
        "weights", "log_read", "counts")), R)
    for mine, theirs in ((rw, jw), (rls, jls)):
        np.testing.assert_array_equal(
            mine.to(torch.bfloat16).float().numpy(),
            np.asarray(theirs.astype(jnp.float32)))


def _psi(k, seed):
    psi = np.zeros(WIDTH, np.float32)
    psi[:k] = np.random.default_rng(seed).dirichlet(np.ones(k))
    return psi


def test_reassign_score_of_a_wide_bucket_matches_jax():
    """The joint score at a given psi (miso.c:243-307), as the port's
    plain version records it (alpha space, the wide summing order), to
    1e-5 relative of the JAX package's ``score_assignments`` +
    ``ldirichlet`` + read score, with counts from a Gibbs draw."""
    ev = _gene()
    batch = padded_batch([ev], "cpu")
    consts = rk._event_consts(batch)
    log_iso_w, h, amask, iso_mask, last, scal = consts
    psi = _psi(NUM_ISO, 5)
    masks = jm.make_masks(jnp.int32(NUM_ISO), WIDTH)
    n, rp = jm.gibbs_reassign_perread(
        jax.random.PRNGKey(0), jnp.asarray(psi),
        jnp.asarray(batch.read_w[0].numpy()),
        jnp.asarray(batch.read_logscore[0].numpy()), masks)
    want = (float(rp) + float(jm.score_assignments(
        jnp.asarray(psi), n, jnp.asarray(ev_pad(ev, "log_iso_w")), masks))
        + float(jm.ldirichlet(jnp.asarray(psi),
                              jnp.asarray(ev_pad(ev, "hyper")), masks)))
    t = torch.from_numpy(psi)[None]
    alpha = torch.where(amask > 0, torch.log(t) - torch.log(
        t[:, NUM_ISO - 1:NUM_ISO]), torch.zeros_like(t))
    eiw = torch.exp(log_iso_w) * iso_mask
    real = iso_mask > 0
    h1 = torch.where(real, h - 1.0, torch.zeros_like(h))
    a_liw = torch.where(real, log_iso_w, torch.zeros_like(h))
    n_t = torch.from_numpy(np.asarray(n, np.float32))[None]
    psi_a, ld, logS = rk._stats(alpha, amask, last, eiw, wide.wide_sum)
    np.testing.assert_allclose(psi_a.numpy()[0], psi, rtol=1e-4, atol=1e-9)
    got = rk._joint_abs(alpha, amask, n_t, h1, wide.wide_sum(h1), a_liw,
                        torch.tensor([float(rp)]), n_t.sum(-1), ld, logS,
                        scal[:, 1], wide.wide_sum)
    assert abs(float(got[0]) - want) <= 1e-5 * abs(want), (float(got), want)


def ev_pad(ev, field):
    """One event's per-isoform field, padded to WIDTH as pad_events pads
    it."""
    return jpad_events([ev], pad_iso=WIDTH)[field][0]


def test_marginal_score_of_a_wide_bucket_matches_jax():
    """The collapsed joint score the port's plain MARGINAL version
    records for each sample, to 1e-5 relative of the JAX package's
    ``score_marginal`` + ``ldirichlet`` at that sample's psi."""
    ev = _gene("marginal")
    batch = padded_batch([ev], "cpu")
    cfg = SamplerConfig(algorithm="marginal", iters=4, burn_in=0, lag=1,
                        chains=2)
    res = mk._marginal_plain(0, batch, cfg, mk._marginal_consts(batch),
                             None, mk.FIXED_U, wide_order=True)
    masks = jm.make_masks(jnp.int32(NUM_ISO), WIDTH)
    W = jnp.asarray(batch.weights[0].numpy())
    counts = jnp.asarray(batch.counts[0].numpy())
    hyper = jnp.asarray(batch.hyper[0].numpy())
    for r in range(cfg.num_records):
        for k in range(cfg.chains):
            psi = jnp.asarray(res.psi_samples[0, r, k].numpy())
            want = float(jm.score_marginal(psi, W, counts)
                         + jm.ldirichlet(psi, hyper, masks))
            got = float(res.loglik[0, r, k])
            assert abs(got - want) <= 1e-5 * abs(want), (r, k, got, want)


def _exon_mass(psi_samples, num_iso):
    """(middle exons,) posterior mass of each middle exon's inclusion:
    sum of psi over the isoforms that hold it, averaged over samples and
    chains.  Isoform m holds middle exon b when bit b of m is set."""
    m = np.arange(num_iso)
    holds = np.stack([(m >> b) & 1 for b in range(
        (num_iso - 1).bit_length())]).astype(np.float64)  # (B, num_iso)
    flat = psi_samples[..., :num_iso].reshape(-1, num_iso).astype(np.float64)
    return (flat @ holds.T).mean(0)


def test_wide_bucket_posterior_matches_jax_run_batch():
    """Each middle exon's posterior inclusion mass from the port's plain
    sampler within 0.05 of ``miso_tpu.sampler.mcmc.run_batch`` (CPU JAX,
    the XLA scan) at the same schedule.  (The two differ by under 1e-4:
    at 1,100 isoforms the proposal's sd is 4e-4 in alpha, and neither
    chain moves far from the uniform start in 200 iterations.)"""
    ev = _gene(n_reads=64)
    cfg = SamplerConfig(iters=200, burn_in=50, lag=5, chains=2)
    pad = jpad_events([ev], read_dtype=np.float32)
    ref = jmcmc.run_batch(
        jax.random.PRNGKey(0),
        jmcmc.EventBatch(**{k: np.asarray(v) for k, v in pad.items()}),
        jmcmc.SamplerConfig(iters=cfg.iters, burn_in=cfg.burn_in,
                            lag=cfg.lag, chains=cfg.chains))
    batch, _ = batch_from_numpy(pad, "cpu")
    assert batch.read_w.shape[2] == WIDTH
    res = rk.run_batch_reassign(0, batch, cfg)
    jax_mass = _exon_mass(np.asarray(ref.psi_samples)[0], NUM_ISO)
    port_mass = _exon_mass(res.psi_samples[0].numpy(), NUM_ISO)
    assert np.abs(port_mass - jax_mass).max() < 0.05, (port_mass, jax_mass)
    # both chains count every read, and padded isoforms stay at 0
    assert np.all(res.final_n.sum(-1).numpy() == ev.counts.sum())
    assert float(res.psi_samples[..., NUM_ISO:].abs().max()) == 0.0


@pytest.mark.parametrize("algorithm", ["reassign", "marginal"])
def test_two_isoform_event_padded_to_a_wide_bucket_is_exact(algorithm):
    """A two-isoform event in a bucket of 2,048 isoforms: the plain
    version in the wide summing order within 0.02 of the grid-exact
    posterior mean (tests/exact_posterior.py; the collapsed model's for
    MARGINAL)."""
    from miso_tpu_torch.testing import exact_marginal_mean_2iso

    ev = simulated_event([100, 50, 100], [[1, 2, 3], [1, 3]], [0.7, 0.3],
                         300, 25, seed=42, algorithm=algorithm)
    exact = (exact_posterior_mean_2iso(ev) if algorithm == "reassign"
             else exact_marginal_mean_2iso(ev))
    batch, _ = batch_from_numpy(jpad_events(
        [ev], pad_iso=WIDTH, read_dtype=np.float32), "cpu")
    cfg = SamplerConfig(algorithm=algorithm, iters=1200, burn_in=200, lag=2,
                        chains=4)
    run = (rk.run_batch_reassign if algorithm == "reassign"
           else mk.run_batch_marginal)
    res = run(1, batch, cfg)
    mean = float(res.psi_samples[0, :, :, 0].mean())
    assert abs(mean - exact) < 0.02, (mean, exact)
    assert float(res.psi_samples[..., 2:].abs().max()) == 0.0
