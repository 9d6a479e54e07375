"""Chen-Shao order-statistic credible intervals.

Parity: misopy/credible_intervals.py:4-71 (including the exact index
arithmetic: bound index = int(round(q * n)) - 1 on the sorted samples).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def ci_bound_indices(num_samples: int,
                     confidence_level: float = 0.95):
    """(lo, hi) sorted-sample bound indices per the Chen-Shao rule
    (misopy/credible_intervals.py:31-55 index arithmetic), or None when
    the sample count is too small -- the ONE definition shared by the
    text summarize path, the device-side run summary (pipeline), and
    the batched comparison."""
    alpha = 1 - confidence_level
    lo = int(round((alpha / 2) * num_samples)) - 1
    hi = int(round((1 - alpha / 2) * num_samples)) - 1
    if lo <= 0 or hi <= 0:
        return None
    return lo, hi


def compute_credible_intervals(samples: np.ndarray,
                               confidence_level: float = 0.95
                               ) -> Tuple[float, float]:
    """samples: (N,) or (N, I) -- column 0 used, as in the reference."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, 0]
    n = len(samples)
    bounds = ci_bound_indices(n, confidence_level)
    if bounds is None:
        # DELIBERATE DIVERGENCE from misopy/credible_intervals.py:31-55:
        # there int(round(q*n))-1 silently yields index -1 for tiny n,
        # which numpy wrap-around turns into the LARGEST sample as the
        # LOWER bound -- a wrong row emitted without complaint.  A
        # truncated/filtered .miso file should error loudly instead.
        # Documented in docs/VALIDATION.md ("small-n credible intervals").
        raise ValueError("Too few samples for credible interval (n=%d)" % n)
    lo, hi = bounds
    s = np.sort(samples)
    return float(s[lo]), float(s[hi])


def compute_multi_iso_credible_intervals(samples: np.ndarray,
                                         confidence_level: float = 0.95
                                         ) -> List[Tuple[float, float]]:
    return [
        compute_credible_intervals(samples[:, i], confidence_level)
        for i in range(samples.shape[1])
    ]


def format_credible_intervals(event_name: str, samples: np.ndarray,
                              confidence_level: float = 0.95) -> List[str]:
    """[event, mean, ci_low, ci_high] as 2-decimal strings; the multi-isoform
    case joins per-isoform values with commas.
    Ref: misopy/credible_intervals.py:4-28."""
    samples = np.asarray(samples)
    num_samples, num_iso = samples.shape
    if num_iso > 2:
        cis = compute_multi_iso_credible_intervals(samples, confidence_level)
        lo = ",".join("%.2f" % ci[0] for ci in cis)
        hi = ",".join("%.2f" % ci[1] for ci in cis)
        mean = ",".join("%.2f" % v for v in samples.mean(axis=0))
        return [event_name, mean, lo, hi]
    ci = compute_credible_intervals(samples, confidence_level)
    return [event_name, "%.2f" % samples[:, 0].mean(),
            "%.2f" % ci[0], "%.2f" % ci[1]]
