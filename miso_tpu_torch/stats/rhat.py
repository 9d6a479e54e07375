"""Gelman-Rubin R-hat for convergent stopping, in torch.

The counterpart of ``miso_tpu/stats/rhat.py:46-64``: the textbook
statistic (Gelman et al., BDA 2nd ed. p.296) with ddof=1 variances and
the ``W > 0`` guard, not the reference's squared running sum
(miso.c:612-617; see the JAX module's note).
"""
from __future__ import annotations

import torch


def batch_rhat(psi_samples: torch.Tensor) -> torch.Tensor:
    """(E, R, K, I) -> (E, I) R-hat per event, on the samples' device.
    B = R * between-chain variance of the chain means, W = mean
    within-chain variance, R-hat = sqrt(((R-1)/R W + B/R) / W)."""
    x = psi_samples
    R = x.shape[1]
    chain_means = x.mean(dim=1)                      # (E, K, I)
    chain_vars = x.var(dim=1, correction=1)
    B = R * chain_means.var(dim=1, correction=1)     # (E, I)
    W = chain_vars.mean(dim=1)
    var_plus = (R - 1) / R * W + B / R
    return torch.sqrt(var_plus / torch.where(W > 0, W, torch.ones_like(W)))


def extended_iterations(no_iter: int, burn_in: int) -> int:
    """Adaptive extension rule (miso.c:922): noIter' = 3*noIter - 2*burnIn."""
    return 3 * no_iter - 2 * burn_in
