"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs an NVIDIA GPU and skips without one.  The card's
machine has no JAX, so this file imports none, and runs there without
tests/conftest.py (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from miso_tpu_torch.sampler import marginal_kernel as mk
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler.mcmc import SamplerConfig
from miso_tpu_torch.testing import (PAIRED_GENE, lane_test_batch,
                                    marginal_lane_batch, padded_batch,
                                    paired_event)

pytestmark = pytest.mark.cuda

# f32 chains that follow the same path differ only by rounding (the
# tolerances of tests/test_pallas_interpret.py)
PSI_ATOL, LL_ATOL, N_ATOL = 2e-4, 2e-3, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_same_chain(got, ref):
    got, ref = got.to_numpy(), ref.to_numpy()
    np.testing.assert_allclose(got.psi_samples, ref.psi_samples, rtol=0,
                               atol=PSI_ATOL)
    np.testing.assert_allclose(got.loglik, ref.loglik, rtol=0, atol=LL_ATOL)
    np.testing.assert_allclose(got.final_n, ref.final_n, rtol=0,
                               atol=N_ATOL)
    np.testing.assert_allclose(got.final_psi, ref.final_psi, rtol=0,
                               atol=PSI_ATOL)
    np.testing.assert_array_equal(got.accepted, ref.accepted)


# (I, num_iso): every width the kernel is built for, some with padded
# isoforms
WIDTHS = [(2, 2), (3, 3), (4, 3), (6, 5), (8, 8), (16, 9), (32, 17),
          (64, 33), (128, 70), (256, 130)]


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("I,num_iso", WIDTHS)
def test_kernel_matches_plain_fixed_uniform(cuda, I, num_iso, given):
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2)
    batch = lane_test_batch(I, num_iso, I, cuda)
    start = None
    if given:
        sp = np.zeros((2, 2, I), np.float32)
        sp[..., :num_iso] = np.random.default_rng(9).dirichlet(
            np.ones(num_iso), size=(2, 2))
        start = torch.from_numpy(sp).to(cuda)
    ref = rk._reassign_plain(0, batch, cfg, rk._event_consts(batch), start,
                             rk.FIXED_U)
    launches = rk.LAUNCHES["cuda"]
    got = rk.run_batch_reassign(0, batch, cfg, start_psi=start,
                                fixed_uniform=rk.FIXED_U)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["cuda"] == launches + 1
    _assert_same_chain(got, ref)


def test_kernel_rejects_bad_input(cuda):
    cfg = SamplerConfig(iters=4, burn_in=0, lag=1, chains=2)
    batch = lane_test_batch(2, 2, 0, cuda)
    with pytest.raises(ValueError, match="read_w"):
        rk.run_batch_reassign(0, batch._replace(
            read_w=batch.read_w.double()), cfg)
    with pytest.raises(ValueError, match="start_psi"):
        rk.run_batch_reassign(0, batch, cfg, start_psi=torch.zeros(
            (2, 3, 2), device=cuda))


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("I,num_iso", WIDTHS)
def test_marginal_kernel_matches_plain_fixed_uniform(cuda, I, num_iso,
                                                     given):
    """B2 at every width, with padded isoforms, an empty class and a
    padding event."""
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2,
                        algorithm="marginal")
    batch = marginal_lane_batch(I, num_iso, I, cuda)
    start = None
    if given:
        sp = np.zeros((3, 2, I), np.float32)
        sp[:2, :, :num_iso] = np.random.default_rng(9).dirichlet(
            np.ones(num_iso), size=(2, 2))
        start = torch.from_numpy(sp).to(cuda)
    ref = mk._marginal_plain(0, batch, cfg, mk._marginal_consts(batch),
                             start, mk.FIXED_U)
    launches = mk.LAUNCHES["cuda"]
    got = mk.run_batch_marginal(0, batch, cfg, start_psi=start,
                                fixed_uniform=mk.FIXED_U)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["cuda"] == launches + 1
    _assert_same_chain(got, ref)


def test_marginal_kernel_rejects_bad_input(cuda):
    cfg = SamplerConfig(iters=4, burn_in=0, lag=1, chains=2,
                        algorithm="classes")
    batch = marginal_lane_batch(2, 2, 0, cuda)
    with pytest.raises(ValueError, match="weights"):
        mk.run_batch_marginal(0, batch._replace(
            weights=batch.weights.double()), cfg)
    with pytest.raises(ValueError, match="num_iso"):
        mk.run_batch_marginal(0, batch._replace(
            num_iso=batch.num_iso.long()), cfg)
    with pytest.raises(ValueError, match="start_psi"):
        mk.run_batch_marginal(0, batch, cfg, start_psi=torch.zeros(
            (3, 3, 2), device=cuda))
    with pytest.raises(ValueError, match="takes I in"):
        mk.run_batch_marginal(0, marginal_lane_batch(5, 5, 0, cuda), cfg)


@pytest.mark.parametrize("algorithm", ["reassign", "marginal"])
@pytest.mark.parametrize("iters", [24, 5000])
def test_kernels_match_plain_on_paired_events(cuda, algorithm, iters):
    """Paired-end tiles (tests/test_pallas.py:230-235): fragment-
    probability weights, log_iso_w = assscores near 11 and non-zero read
    scores, on a small schedule and on the stock 5000 x 6 one."""
    ev = paired_event(*PAIRED_GENE, [0.6, 0.4], 400, 40, 250.0, 15.0,
                      seed=11)
    batch = padded_batch([ev] * 2, cuda)
    cfg = (SamplerConfig(iters=24, burn_in=6, lag=3, chains=2,
                         algorithm=algorithm) if iters == 24
           else SamplerConfig(algorithm=algorithm))
    if algorithm == "reassign":
        ref = rk._reassign_plain(0, batch, cfg, rk._event_consts(batch),
                                 None, rk.FIXED_U)
        got = rk.run_batch_reassign(0, batch, cfg, fixed_uniform=rk.FIXED_U)
    else:
        ref = mk._marginal_plain(0, batch, cfg, mk._marginal_consts(batch),
                                 None, mk.FIXED_U)
        got = mk.run_batch_marginal(0, batch, cfg, fixed_uniform=mk.FIXED_U)
    torch.cuda.synchronize()
    _assert_same_chain(got, ref)
