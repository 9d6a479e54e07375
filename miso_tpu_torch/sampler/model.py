"""Probabilistic model math of the MISO sampler, in masked torch.

Torch ports of ``miso_tpu/sampler/model.py:57-195`` (same reference
citations: pysplicing/src/miso.c:97-307).  The functions keep the JAX
shapes for one (event, chain) -- alpha (I-1,), psi (I,) -- and also take
leading batch dimensions.  This module is the psi-space oracle for the
alpha-space arithmetic of the REASSIGN kernel and its plain version
(``reassign_kernel.py``).  Of it, only ``gibbs_reassign`` runs on a main
path: the Gibbs step of the plain version of the deep route's kernel
(``deep.py``), which the kernel's fixed-uniform mode follows draw for
draw.

Contractions stay elementwise sums (never ``@``): see ``score_marginal``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class EventMasks(NamedTuple):
    """Per-event mask set derived from the real isoform count k."""

    iso_mask: torch.Tensor     # (..., I) bool
    amask: torch.Tensor        # (..., I-1) bool
    last_onehot: torch.Tensor  # (..., I) float32
    k: torch.Tensor            # (...) int32
    sigma: torch.Tensor        # (...) float32: 0.2 / k**2
    noise_scale: torch.Tensor  # (...) sigma if k == 2 else sqrt(sigma)


def make_masks(num_iso: torch.Tensor, I: int) -> EventMasks:
    """Masks for events with ``num_iso`` real isoforms padded to I."""
    k = torch.as_tensor(num_iso).to(torch.int32)
    dev = k.device
    ar = torch.arange(I, device=dev)
    iso_mask = ar < k[..., None]
    amask = torch.arange(I - 1, device=dev) < (k - 1)[..., None]
    last_onehot = (ar == (k - 1)[..., None]).to(torch.float32)
    kf = k.to(torch.float32)
    sigma = 0.2 / (kf * kf)
    noise_scale = torch.where(k == 2, sigma, torch.sqrt(sigma))
    return EventMasks(iso_mask, amask, last_onehot, k, sigma, noise_scale)


def logistic_inv(alpha: torch.Tensor, masks: EventMasks) -> torch.Tensor:
    """alpha (..., I-1) -> psi (..., I), masked inverse-logit.
    Ref: pysplicing/src/miso.c:219-241 + :462-468."""
    exp_a = torch.where(masks.amask, torch.exp(alpha),
                        torch.zeros_like(alpha))
    denom = 1.0 + exp_a.sum(-1, keepdim=True)
    head = exp_a / denom
    psi = torch.cat([head, torch.zeros_like(head[..., :1])], dim=-1)
    return psi + masks.last_onehot * (1.0 - head.sum(-1, keepdim=True))


def propose(alpha, eps, masks: EventMasks):
    """Drift proposal alphaNew = alpha + noise_scale * eps on the masked
    dims.  Returns (alphaNew, psiNew).  Ref: pysplicing/src/miso.c:449-471."""
    step = torch.where(masks.amask, eps, torch.zeros_like(eps))
    alpha_new = alpha + masks.noise_scale[..., None] * step
    return alpha_new, logistic_inv(alpha_new, masks)


def proposal_logpdf(psi, mu_alpha, masks: EventMasks):
    """log q(psi | mu_alpha): multivariate logistic-normal with diagonal
    sigma.  Ref: pysplicing/src/miso.c:97-122."""
    sigma = masks.sigma
    lenf = (masks.k - 1).to(psi.dtype)
    ltheta = (psi * masks.last_onehot).sum(-1)
    theta = psi[..., :-1]
    zero = torch.zeros_like(theta)
    safe_log_theta = torch.where(masks.amask, torch.log(theta), zero)
    log_prod = safe_log_theta.sum(-1)
    tmp = torch.where(masks.amask, safe_log_theta
                      - torch.log(ltheta)[..., None] - mu_alpha, zero)
    exp_part = -0.5 * (tmp * tmp).sum(-1) / sigma
    covar_const = -0.5 * lenf * torch.log(2.0 * math.pi * sigma)
    return covar_const - log_prod - torch.log(ltheta) + exp_part


def ldirichlet(psi, hyper, masks: EventMasks):
    """Dirichlet log-pdf with masked components.
    Ref: pysplicing/src/miso.c:165-182."""
    m = masks.iso_mask
    one = torch.ones_like(psi)
    zero = torch.zeros_like(psi)
    h = torch.where(m, hyper, one)
    logx = torch.where(m, torch.log(psi), zero)
    score = torch.where(m, (h - 1.0) * logx, zero).sum(-1)
    asum = torch.where(m, h, zero).sum(-1)
    lg = torch.where(m, torch.lgamma(h), zero).sum(-1)
    return score + torch.lgamma(asum) - lg


def score_assignments(psi, n_per_iso, log_iso_w, masks: EventMasks):
    """Assignment score sum_j n_j * lognorm_j with
    lognorm = log psi + log_iso_w - logsumexp(...).
    Ref: pysplicing/src/miso.c:124-163."""
    lp = torch.where(masks.iso_mask, torch.log(psi) + log_iso_w,
                     torch.full_like(psi, -math.inf))
    mx = lp.max(-1, keepdim=True).values
    lse = torch.log(torch.exp(lp - mx).sum(-1, keepdim=True)) + mx
    lognorm = lp - lse
    return torch.where(n_per_iso > 0, n_per_iso * lognorm,
                       torch.zeros_like(lognorm)).sum(-1)


def score_marginal(psi, weights, counts):
    """MARGINAL / CLASSES read score sum_c counts_c * log(sum_j W_cj psi_j),
    zero-probability classes contributing 0.  Ref: miso.c:272-293.

    Written elementwise, not as ``weights @ psi``: a matrix product may
    round through TF32 (or bf16 on the TPU), and that noise, amplified by
    ``counts`` in log space, moves the MH ratio by whole units."""
    s = (weights * psi[..., None, :]).sum(-1)
    return torch.where(s > 0, counts * torch.log(s),
                       torch.zeros_like(s)).sum(-1)


def gibbs_reassign_perread(u, psi, read_w, read_logscore,
                           masks: EventMasks):
    """Per-read categorical Gibbs reassignment by inverse CDF
    (pysplicing/src/miso.c:30-91).  ``u`` (..., R, 1) are the uniforms
    that the JAX version draws from its key: read r takes the first
    isoform j whose cumulative weight reaches u_r * total.
    Returns (n_per_iso (..., I), read_prob (...))."""
    rw = psi[..., None, :] * read_w.to(psi.dtype)       # (..., R, I)
    cum = torch.cumsum(rw, dim=-1)
    total = cum[..., -1:]
    valid = total[..., 0] > 0
    ge = cum >= u * total
    prev = torch.cat([torch.zeros_like(ge[..., :1]), ge[..., :-1]], dim=-1)
    onehot = ge & ~prev & (rw > 0) & valid[..., None]
    onehot = onehot.to(psi.dtype)
    n = onehot.sum(-2)
    read_prob = (onehot * read_logscore.to(psi.dtype)).sum((-1, -2))
    return n, read_prob


def gibbs_reassign(psi, weights, counts, generator=None, uniform=None):
    """Per-class multinomial reassignment (pysplicing/src/miso.c:30-91):
    the counts_c reads of class c each take isoform j with probability
    p_cj = psi_j W_cj / sum_j psi_j W_cj, so the class's assignment counts
    are multinomial.  psi (..., I), weights (..., C, I), counts (..., C)
    -> draws (..., C, I).

    The semantics of ``jax.random.multinomial`` as the JAX version calls
    it: chained binomials over the isoforms with ratio_j = p_j / (sum of
    p over isoforms j and after), 1 as divisor where that mass is 0,
    clipped to [0, 1].  The last isoform of nonzero p has ratio exactly 1
    and takes the remainder, so every class sums exactly to its count.
    Classes with no compatible isoform draw zero.  The reverse sum is an
    ordered loop over the short isoform axis, not ``torch.cumsum``.

    ``uniform`` (a float, the fixed-uniform test mode of the kernels)
    replaces every binomial draw by a bounded deterministic rule, the
    one the multinomial kernel's fixed mode computes:
    floor(remainder * ratio + uniform) clipped to [0, remainder], one
    f32 multiply, one add and a floor, so the two agree draw for draw.
    It never enters a rejection loop.  Otherwise each draw is
    ``torch.binomial`` from ``generator``."""
    p = psi[..., None, :] * weights                        # (..., C, I)
    I = p.shape[-1]
    tot = p[..., 0]
    for j in range(1, I):
        tot = tot + p[..., j]
    valid = tot > 0
    zero = torch.zeros_like(tot)
    probs = torch.where(valid[..., None],
                        p / torch.where(valid, tot, 1.0)[..., None], 0.0)
    rest = [probs[..., I - 1]]                             # reversed
    for j in range(I - 2, -1, -1):
        rest.append(probs[..., j] + rest[-1])
    rest.reverse()
    remainder = torch.where(valid, counts.to(p.dtype), zero).expand(
        tot.shape).contiguous()
    draws = []
    for j in range(I):
        ratio = (probs[..., j] / torch.where(rest[j] == 0, 1.0, rest[j])
                 ).clamp(0.0, 1.0)
        if uniform is None:
            c = torch.binomial(remainder, ratio, generator=generator)
        else:
            c = torch.minimum(torch.floor(remainder * ratio + uniform)
                              .clamp_min(0.0), remainder)
        draws.append(c)
        remainder = remainder - c
    return torch.stack(draws, -1)
