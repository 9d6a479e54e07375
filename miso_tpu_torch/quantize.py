"""Device-side output precision: psi ticks, score centipoints and the
posterior summary, computed on the samples' device so that only these
small integer payloads are copied to the host (pipeline.py:258-283,
:611-635 of the JAX package)."""
from __future__ import annotations

import torch


def quantize_psi(flat_psi, two_iso: bool):
    """(E, S, I) psi -> int32 ticks of 1e-4 (the .miso "%.4f" precision),
    clipped to 0..10000; two-isoform buckets keep column 0 only.  NaN
    (masked lanes) maps to 0, as JAX's float -> uint16 cast does."""
    x = flat_psi[:, :, 0] if two_iso else flat_psi
    x = torch.nan_to_num(torch.round(x * 1e4), nan=0.0)
    return torch.clamp(x, 0, 10000).to(torch.int32)


def quantize_scores(flat_ll):
    """(E, S) scores -> (resid int32 centipoints above the per-event min,
    cmin, cmax) (pipeline.py:630-635)."""
    cents = torch.round(flat_ll * 100.0)
    cmin = cents.min(dim=1).values
    cmax = cents.max(dim=1).values
    resid = torch.nan_to_num(cents - cmin[:, None], nan=0.0)
    return torch.clamp(resid, 0, 65535).to(torch.int32), cmin, cmax


def summary_stats(quant, lo: int, hi: int):
    """Device-side posterior summary of the ticks (pipeline.py:258-283):
    per-(event[, isoform]) tick sums as (E, 1[, I]) int64 -- one segment,
    since the card has int64 -- plus the Chen-Shao order statistics at
    the lo/hi bound indices."""
    s = torch.sort(quant, dim=1).values
    ssum = quant.to(torch.int64).sum(dim=1, keepdim=True)
    return ssum, s[:, lo], s[:, hi]
