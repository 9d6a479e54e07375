"""miso_tpu_torch/sampler/model.py against miso_tpu/sampler/model.py, and
the plain REASSIGN version's alpha-space MH arithmetic against the
psi-space form built from the ported model functions.

Inputs are made with numpy from a seed and fed to both packages.
Tolerance rtol 1e-5 / atol 1e-5: both sides compute in float32, in a
different reduction order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from miso_tpu.sampler import model as jm
from miso_tpu_torch.sampler import model as tm
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler.mcmc import EventBatch
from miso_tpu_torch.testing import cap_test_threads

cap_test_threads()

E, R, C = 6, 24, 5
RTOL = ATOL = 1e-5


def _inputs(I, seed=0):
    """E events padded to I isoforms, num_iso cycling over 2..I."""
    rng = np.random.default_rng(seed + I)
    k = np.array([2 + e % (I - 1) for e in range(E)], np.int32)
    real = np.arange(I)[None, :] < k[:, None]
    psi = np.zeros((E, I), np.float32)
    for e in range(E):
        psi[e, :k[e]] = rng.dirichlet(np.ones(k[e]))
    psi = psi.astype(np.float32)
    read_w = ((rng.random((E, R, I)) < 0.6) & real[:, None, :]
              ).astype(np.float32)
    read_w[:, -4:, :] = 0.0                 # padding reads
    read_w[:, 0, :] = real.astype(np.float32)
    with np.errstate(divide="ignore"):
        log_iso_w = np.where(real, np.log(rng.uniform(50, 300, (E, I))),
                             -np.inf).astype(np.float32)
    return dict(
        k=k, psi=psi,
        alpha=rng.normal(0, 1.5, (E, I - 1)).astype(np.float32),
        eps=rng.normal(0, 1, (E, I - 1)).astype(np.float32),
        hyper=rng.uniform(0.5, 3.0, (E, I)).astype(np.float32),
        log_iso_w=log_iso_w,
        n=np.where(real, rng.integers(0, 20, (E, I)), 0).astype(np.float32),
        weights=np.where(rng.random((E, C, I)) < 0.7,
                         rng.random((E, C, I)), 0.0).astype(np.float32),
        counts=rng.integers(0, 30, (E, C)).astype(np.float32),
        read_w=read_w,
        read_logscore=np.where(read_w > 0,
                               np.log(0.01 + rng.random((E, R, I))),
                               0.0).astype(np.float32),
        u=np.stack([np.asarray(jax.random.uniform(
            jax.random.PRNGKey(e), (R, 1), jnp.float32)) for e in range(E)]),
    )


def _jax_per_event(fn, x, I):
    """Apply a one-event JAX function to every event of the batch."""
    out = []
    for e in range(E):
        masks = jm.make_masks(jnp.int32(x["k"][e]), I)
        out.append(fn({key: v[e] for key, v in x.items()}, masks))
    return [np.stack([np.asarray(o[j]) for o in out])
            for j in range(len(out[0]))]


def _torch(x):
    return {key: torch.from_numpy(np.asarray(v)) for key, v in x.items()}


# name -> (JAX call on one event, torch call on the batch)
FUNCS = {
    "make_masks": (
        lambda x, m: (m.iso_mask, m.amask, m.last_onehot, m.k, m.sigma,
                      m.noise_scale),
        lambda t, m: (m.iso_mask, m.amask, m.last_onehot, m.k, m.sigma,
                      m.noise_scale)),
    "logistic_inv": (
        lambda x, m: (jm.logistic_inv(x["alpha"], m),),
        lambda t, m: (tm.logistic_inv(t["alpha"], m),)),
    "propose": (
        lambda x, m: jm.propose(x["alpha"], x["eps"], m),
        lambda t, m: tm.propose(t["alpha"], t["eps"], m)),
    "proposal_logpdf": (
        lambda x, m: (jm.proposal_logpdf(x["psi"], x["alpha"], m),),
        lambda t, m: (tm.proposal_logpdf(t["psi"], t["alpha"], m),)),
    "ldirichlet": (
        lambda x, m: (jm.ldirichlet(x["psi"], x["hyper"], m),),
        lambda t, m: (tm.ldirichlet(t["psi"], t["hyper"], m),)),
    "score_assignments": (
        lambda x, m: (jm.score_assignments(x["psi"], x["n"],
                                           x["log_iso_w"], m),),
        lambda t, m: (tm.score_assignments(t["psi"], t["n"],
                                           t["log_iso_w"], m),)),
    "score_marginal": (
        lambda x, m: (jm.score_marginal(x["psi"], x["weights"],
                                        x["counts"]),),
        lambda t, m: (tm.score_marginal(t["psi"], t["weights"],
                                        t["counts"]),)),
    "gibbs_reassign_perread": (
        # the key that draws x["u"] in _inputs
        lambda x, m: jm.gibbs_reassign_perread(
            jax.random.PRNGKey(int(x["ev"])), x["psi"], x["read_w"],
            x["read_logscore"], m),
        lambda t, m: tm.gibbs_reassign_perread(
            t["u"], t["psi"], t["read_w"], t["read_logscore"], m)),
}


@pytest.mark.parametrize("I", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_model_function_matches_jax(name, I):
    x = _inputs(I)
    x["ev"] = np.arange(E)
    jfn, tfn = FUNCS[name]
    want = _jax_per_event(jfn, x, I)
    t = _torch(x)
    got = tfn(t, tm.make_masks(t["k"], I))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("I", [2, 3, 4])
def test_alpha_space_log_ratio_matches_psi_space(I):
    """The plain version's MH log-ratio and recorded joint score (alpha
    space, float32) equal the psi-space (pjs - cjs) + full*(pto_c -
    cto_p) of mcmc.py:392-398 and its joint score, built from the ported
    model functions in float64."""
    rng = np.random.default_rng(40 + I)
    x = _inputs(I, seed=40)
    k = torch.from_numpy(x["k"])
    masks64 = tm.make_masks(k, I)
    masks64 = masks64._replace(sigma=masks64.sigma.double(),
                               noise_scale=masks64.noise_scale.double())
    am = masks64.amask.double()
    alpha = torch.from_numpy(x["alpha"]).double() * am
    d = masks64.noise_scale[:, None] * torch.from_numpy(
        rng.normal(0, 1, (E, I - 1))).double() * am
    alpha_new = alpha + d
    n = torch.from_numpy(x["n"]).double()
    hyper = torch.from_numpy(x["hyper"]).double()
    liw = torch.from_numpy(x["log_iso_w"]).double()
    rp = torch.from_numpy(rng.normal(-50, 5, E))

    psi = tm.logistic_inv(alpha, masks64)
    psi_new = tm.logistic_inv(alpha_new, masks64)

    def joint(p):
        return (rp + tm.score_assignments(p, n, liw, masks64)
                + tm.ldirichlet(p, hyper, masks64))

    # alpha space, float32, through the plain version's own functions
    f32 = torch.float32
    pad = torch.zeros((E, 1), dtype=torch.float64)
    a_i = torch.cat([alpha, pad], 1).to(f32)
    d_i = torch.cat([d, pad], 1).to(f32)
    zeros = torch.zeros((E, 1, I))
    batch = EventBatch(weights=zeros, log_read=zeros, counts=zeros[:, :, 0],
                       log_iso_w=liw.to(f32), hyper=hyper.to(f32),
                       num_iso=k, read_w=zeros, read_logscore=zeros)
    log_iso_w, h, amask, iso_mask, last, scal = rk._event_consts(batch)
    eiw = torch.exp(log_iso_w) * iso_mask
    real = iso_mask > 0
    h1 = torch.where(real, h - 1.0, torch.zeros_like(h))
    a_liw = torch.where(real, log_iso_w, torch.zeros_like(h))
    n32 = n.to(f32)
    n_valid = n32.sum(-1)
    psi_a, ld, logS = rk._stats(a_i, amask, last, eiw)
    psi_an, ld_n, logS_n = rk._stats(a_i + d_i, amask, last, eiw)
    np.testing.assert_allclose(psi_a.numpy(), psi.numpy(), atol=1e-6)
    for full in (0.0, 1.0):
        want = (joint(psi_new) - joint(psi)
                + full * (tm.proposal_logpdf(psi, alpha_new, masks64)
                          - tm.proposal_logpdf(psi_new, alpha, masks64)))
        got = rk._log_ratio(n32, d_i, h1, h1.sum(-1), n_valid,
                            amask.sum(-1) + 1.0, ld, ld_n, logS, logS_n,
                            full)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4)
    got_joint = rk._joint_abs(a_i, amask, n32, h1, h1.sum(-1), a_liw,
                              rp.to(f32), n_valid, ld, logS, scal[:, 1])
    np.testing.assert_allclose(got_joint.numpy(), joint(psi).numpy(),
                               rtol=1e-6, atol=1e-3)
