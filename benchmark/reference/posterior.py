"""The posterior of Ψ that the program's sampler draws from, for one
event, worked out from its read classes.

MISO (Katz et al. 2010; pysplicing miso.c, miso_paired.c) with a uniform
Dirichlet prior.  A class c of n_c reads has a match value w_cj on
isoform j: 1 or 0 for a single-end read, and for a pair f(l_cj), the
insert-length pmf at the pair's fragment length on j (0 where it does
not match).  REASSIGN draws each read's isoform with probability
∝ Ψ_j w_cj and moves Ψ by Metropolis-Hastings on the assignment score
sum_j m_j log(Ψ_j a_j / sum_k Ψ_k a_k), a_j the isoform's positions
(L_j - r + 1 for reads of length r; for pairs, the sum over the insert
support of max(L_j - l + 1, 0)).  Its stationary Ψ-marginal is

    p(Ψ | reads) ∝ prod_c (sum_j Ψ_j w_cj)^n_c / (sum_j Ψ_j a_j)^N

with N the reads that match some isoform.  MARGINAL scores
prod_c (sum_j Ψ_j w'_cj)^n_c, with w'_cj = w_cj / a_j for single-end
reads and w'_cj = w_cj for pairs, and no denominator.

Two isoforms integrate on a grid: there MISO's chains reach the
posterior at the stock length.  With more isoforms they need not (a
drift step of sqrt(0.2) / k in logit space leaves a chain of 5,000 steps
near its start), so ``miso_chains`` runs MISO's chain itself, in plain
PyTorch, and the program's chains are held to its chains.  Every
function takes the dtype it computes in, so that the control can run the
same arithmetic one precision down.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def class_terms(sample, g: int, keys: np.ndarray, counts: np.ndarray,
                algorithm: str):
    """(w (C, I), n (C,), a (I,) or None) float64 for gene g's classes
    under ``algorithm``, leaving out the classes that match no isoform."""
    m = sample.models
    rd = sample.config["reads"]
    I = m.num_iso(g)
    L = np.array([int((en - st + 1).sum())
                  for st, en in (m.exons(g, j) for j in range(I))])
    if rd["paired_end"]:
        from generate import fragment_pmf
        lens, p = fragment_pmf(sample.config)
        w = np.where(keys >= 0, p[np.clip(keys - lens[0], 0, len(p) - 1)],
                     0.0)
        a = np.maximum(L[:, None] - lens[None, :] + 1, 0).sum(1).astype(
            np.float64)
    else:
        w = (keys > 0).astype(np.float64)
        a = np.maximum(L - rd["read_len"] + 1, 0).astype(np.float64)
        if algorithm == "marginal":
            w = w / np.where(a > 0, a, 1.0)[None, :]
    live = w.any(1)
    return (w[live], counts[live].astype(np.float64),
            a if algorithm == "reassign" else None)


def grid_posterior(b, n, a, dtype=torch.float64, points: int = 20001
                   ) -> Dict[str, object]:
    """Two isoforms: the posterior of Ψ_0 on a grid, computed in
    ``dtype``.  Returns mean and sd of Ψ_0 and the grid's CDF."""
    psi = torch.linspace(1e-7, 1 - 1e-7, points, dtype=torch.float64)
    x = psi.to(dtype)
    bt = torch.as_tensor(b).to(dtype)
    nt = torch.as_tensor(n).to(dtype)
    mix = bt[None, :, 0] * x[:, None] + bt[None, :, 1] * (1 - x[:, None])
    ll = (nt[None, :] * torch.log(mix)).sum(1)
    if a is not None:
        at = torch.as_tensor(a).to(dtype)
        ll = ll - nt.sum() * torch.log(at[0] * x + at[1] * (1 - x))
    w = torch.exp(ll - ll.max())
    w = w / w.sum()
    mean = (w * x).sum()
    var = (w * (x - mean) ** 2).sum()
    cdf = torch.cumsum(w.to(torch.float64), 0)
    return {"mean": np.array([float(mean), 1 - float(mean)]),
            "sd": np.array([float(var.sqrt())] * 2),
            "grid": psi.numpy(), "cdf": cdf.numpy() / float(cdf[-1])}


def grid_quantile(post, q: float, iso: int = 0) -> float:
    """The q-quantile of Ψ_iso from a grid posterior."""
    x = post["grid"][int(np.searchsorted(post["cdf"], q))]
    return float(x if iso == 0 else 1 - x)


def class_rows(g, w, base):
    """Every class's cumulative row of g_j w_cj, normalised and laid end
    to end as c + cum / total (float64, sorted along each chain), so
    that one search finds a read's isoform from c + a uniform."""
    cum = torch.cumsum(g[:, None, :] * w[None, :, :], 2)
    frac = cum / cum[:, :, -1:].clamp_min(torch.finfo(cum.dtype).tiny)
    return (base[None, :, None] + frac.to(torch.float64)).reshape(
        g.shape[0], -1)


def miso_chains(w, n, a, seed: int, sampler: dict, device="cpu",
                dtype=torch.float64, chains: int = 48) -> Dict[str, object]:
    """MISO's REASSIGN chain itself, ``chains`` times, for events whose
    chains do not reach the posterior at the configuration's length (many
    isoforms: a drift step of sqrt(0.2) / k in logit space).  The same
    start, proposal, acceptance and schedule as MISO (miso.c): logits
    alpha of the first k - 1 isoforms against the last, started at
    1 / (k - 1) (0 for two isoforms) plus one drift step; each iteration
    a drift step accepted by Metropolis-Hastings on the assignment score
    and the logistic Jacobian (not on the first iteration), a record of
    Ψ every lag-th iteration after burn-in, then every read reassigned
    with probability ∝ Ψ_j w_cj.  Returns the records (chains, records,
    I) and per isoform the chains' means and their spread."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    C, I = w.shape
    K = chains
    sig = 0.2 / (I * I)
    ns = sig if I == 2 else sig ** 0.5
    wt = torch.as_tensor(w, device=device).to(dtype)
    eiw = torch.as_tensor(a, device=device).to(dtype)
    cls = torch.repeat_interleave(
        torch.arange(C, device=device),
        torch.as_tensor(n.astype(np.int64), device=device))
    N = int(cls.numel())
    base = torch.arange(C, device=device, dtype=torch.float64)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float64).to(dtype)

    def stats(alpha):
        e = torch.cat([torch.exp(alpha), torch.ones(K, 1, device=device,
                                                    dtype=dtype)], 1)
        denom = e.sum(1)
        return e / denom[:, None], torch.log(denom), torch.log(
            (e * eiw[None, :]).sum(1))

    def gibbs(psi):
        rows = class_rows(psi, wt, base)
        q = cls[None, :].to(torch.float64) + torch.rand(
            K, N, device=device, dtype=torch.float64, generator=gen)
        pick = torch.searchsorted(rows, q.clamp_max(C - 1e-12))
        iso = (pick - cls[None, :] * I).clamp(0, I - 1)
        m = torch.zeros(K, I, device=device, dtype=dtype)
        return m.scatter_add_(1, iso, torch.ones(K, N, device=device,
                                                 dtype=dtype))

    a0 = 0.0 if I == 2 else 1.0 / (I - 1)
    alpha = a0 + ns * normal(K, I - 1)
    psi, ld, logS = stats(alpha)
    m = gibbs(psi)
    T, burn, lag = sampler["num_iters"], sampler["burn_in"], sampler["lag"]
    recs = []
    for it in range(T):
        d = ns * normal(K, I - 1)
        alpha_new = alpha + d
        psi_new, ld_new, logS_new = stats(alpha_new)
        logr = (m[:, :-1] * d).sum(1) - N * (logS_new - logS)
        if it > 0:
            logr = logr + d.sum(1) + I * (ld - ld_new)
        u = torch.rand(K, device=device, dtype=torch.float64,
                       generator=gen).clamp_min(2.0 ** -24)
        acc = (logr >= 0) | (torch.log(u).to(dtype) < logr)
        alpha = torch.where(acc[:, None], alpha_new, alpha)
        psi = torch.where(acc[:, None], psi_new, psi)
        ld = torch.where(acc, ld_new, ld)
        logS = torch.where(acc, logS_new, logS)
        if it + 1 > burn and (it + 1 - burn) % lag == 0:
            recs.append(psi)
        m = gibbs(psi)
    draws = torch.stack(recs, 1).to(torch.float64).cpu().numpy()
    means = draws.mean(1)
    return {"records": draws, "mean": means.mean(0),
            "chain_sd": means.std(0, ddof=1)}
