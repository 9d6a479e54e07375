"""The port's wide route against the reference's control flow, on the CPU.

From ``wide.WIDE_FROM`` (REASSIGN) and ``wide.WIDE_FROM_MARGINAL``
(MARGINAL) isoforms the wrappers run the wide kernels B1w and B2w on the
card and, on the CPU, their plain versions in the wide kernels' summing
order; the kernels are held to those plain versions to the bit
(tests/test_torch_kernel_source.py ``-k wide``, ``chip_smoke.py``).
REASSIGN at 64 isoforms, the widest narrow bucket (B1's order), is held
here too.
Here the plain versions are held, under fixed uniforms (every uniform
0.4999, as the Pallas kernels' ``_DEBUG_NO_PRNG``), to the numpy
replicas of one (event, chain) lane of the JAX package's kernels in
tests/test_pallas_interpret.py (``_sim_event``, ``_sim_marginal``, in
f64), which run in a fraction of a second where the Pallas interpreter
takes minutes at these widths: the MH/Gibbs recurrence, the record
schedule, padded reads and isoforms, from the AUTO and a GIVEN start.
MARGINAL stops at 120 real isoforms and runs from the AUTO start only:
its f32 MH ratio is rounding-dominated past ~200 isoforms in both
packages, and from a GIVEN Dirichlet start already at 70-120 (the
proposal correction, scaled by 1/sigma = 5 k^2, meets psi far from the
start's uniform values): there no f32 chain follows the f64 replica's
accept decisions (ROADMAP C.6).
"""
import numpy as np
import pytest
import torch

from test_pallas_interpret import _sim_event, _sim_marginal

from miso_tpu_torch.sampler import marginal_kernel as mk
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler import wide
from miso_tpu_torch.sampler.mcmc import SamplerConfig
from miso_tpu_torch.testing import (cap_test_threads, lane_test_batch,
                                    marginal_lane_batch)

cap_test_threads()

# the tolerances of PERF.md section 2 (tests/test_torch_cuda.py)
PSI_ATOL, LL_ATOL = 2e-4, 2e-3
SMALL = dict(iters=24, burn_in=6, lag=3, chains=2)


def _given(num_iso, E, K, I):
    sp = np.zeros((E, K, I), np.float32)
    sp[..., :num_iso] = np.random.default_rng(9).dirichlet(
        np.ones(num_iso), size=(E, K))
    return sp


def _check_lane(got, e, k, rec_psi, rec_ll, final_psi, final_n=None):
    np.testing.assert_allclose(got.psi_samples[e, :, k], rec_psi, rtol=0,
                               atol=PSI_ATOL)
    np.testing.assert_allclose(got.loglik[e, :, k], rec_ll, rtol=0,
                               atol=LL_ATOL)
    np.testing.assert_allclose(got.final_psi[e, k], final_psi, rtol=0,
                               atol=PSI_ATOL)
    if final_n is not None:
        np.testing.assert_array_equal(got.final_n[e, k], final_n)


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("I,num_iso", [(64, 40), (64, 60), (128, 70),
                                       (128, 100), (128, 120), (256, 200),
                                       (512, 300)])
def test_reassign_wide_order_follows_the_replica(I, num_iso, given):
    """REASSIGN through its wrapper (``lane_test_batch``: 16 reads,
    three of them padding; B1w's order from ``wide.WIDE_FROM`` isoforms,
    B1's at 64) against ``_sim_event``: psi and the records within the
    tolerances, the final counts and the accepted steps exactly."""
    assert (I >= wide.WIDE_FROM) == (I not in rk.KERNEL_ISO)
    cfg = SamplerConfig(**SMALL)
    K = cfg.chains
    batch = lane_test_batch(I, num_iso, I, "cpu")
    E, R, _ = batch.read_w.shape
    sp = _given(num_iso, E, K, I) if given else None
    got = rk.run_batch_reassign(
        0, batch, cfg, start_psi=None if sp is None else torch.from_numpy(sp),
        fixed_uniform=rk.FIXED_U).to_numpy()
    f64 = [t.numpy().astype(np.float64) for t in (
        batch.read_w, batch.read_logscore, batch.log_iso_w, batch.hyper)]
    for e in range(E):
        accepted = 0.0
        for k in range(K):
            rec_psi, rec_ll, acc, n, psi = _sim_event(
                *(a[e] for a in f64), num_iso, cfg, R,
                start_psi=None if sp is None else sp[e, k].astype(
                    np.float64))
            _check_lane(got, e, k, rec_psi, rec_ll, psi, n)
            accepted += acc
        assert got.accepted[e] == accepted


@pytest.mark.parametrize("num_iso", [70, 100, 120])
def test_marginal_wide_order_follows_the_replica(num_iso):
    """MARGINAL in B2w's order (``marginal_lane_batch`` at 128 isoforms:
    two events of four classes, one empty, beside a padding event)
    against ``_sim_marginal`` from the AUTO start: psi and the records
    within the tolerances, the accepted steps exactly."""
    I = 128
    assert I >= wide.WIDE_FROM_MARGINAL
    cfg = SamplerConfig(algorithm="marginal", **SMALL)
    K = cfg.chains
    batch = marginal_lane_batch(I, num_iso, I, "cpu")
    got = mk.run_batch_marginal(0, batch, cfg,
                                fixed_uniform=mk.FIXED_U).to_numpy()
    f64 = [t.numpy().astype(np.float64) for t in (
        batch.weights, batch.counts, batch.hyper)]
    for e in range(2):
        accepted = 0.0
        for k in range(K):
            rec_psi, rec_ll, acc, psi = _sim_marginal(
                *(a[e] for a in f64), num_iso, cfg)
            _check_lane(got, e, k, rec_psi, rec_ll, psi)
            accepted += acc
        assert got.accepted[e] == accepted
