"""The least time a sampler launch could take on one NVIDIA H100, from the
batch's sufficient statistics alone.

The count takes no input from the kernel that ran the bucket: B1, B1w
and B3 (REASSIGN) and B2 and B2w (MARGINAL) are counted alike on the
same events, so a change that reroutes a bucket leaves it unmoved.

Per event e with I_e isoforms, C_e classes, of which R_e hold reads, over
K chains, T iterations and S retained samples:

- operations: K * T * (4 * R_e * I_e + 20 * I_e).  Per class with reads
  and isoform: the product Ψ_j * w_cj, its running sum, the ratio of a
  binomial split of the class's reads and its draw's arithmetic (4).  Per
  isoform: the proposal's normal draw, its exponential and logistic sum
  and division, the log, the prior and score terms and the acceptance's
  share (20).  A class's reads are drawn as one multinomial, whichever
  way a kernel draws them.
- bytes: each input read once, each output written once, 4 bytes a
  value (float32, as the configuration states): in, the class weights
  and read scores (2 * C_e * I_e), counts (C_e), isoform weights and
  Dirichlet hyperparameters (2 * I_e); out, the retained samples and
  their scores (S * (I_e + 1)), final counts per chain (K * I_e) and
  accepted and rejected moves per chain (2 * K).

Least time = max(operations / PEAK_FLOPS, bytes / PEAK_BYTES).
"""
from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, and HBM3
# bandwidth, at the 700 W power limit
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def event_stats(ev) -> Tuple[int, int, int]:
    """(isoforms, classes with reads, classes) of a compiled event."""
    return ev.num_iso, int((ev.counts > 0).sum()), ev.num_classes


def launch(events: Iterable[Tuple[int, int, int]], sampler: dict) -> dict:
    """Operations, bytes and least seconds of one launch over ``events``
    (isoforms, classes with reads, classes), at the sampler settings
    (num_iters, burn_in, lag, num_chains)."""
    K, T = sampler["num_chains"], sampler["num_iters"]
    S = ((T - sampler["burn_in"]) // sampler["lag"]) * K
    ops = 0
    nbytes = 0
    for I, R, C in events:
        ops += K * T * (4 * R * I + 20 * I)
        nbytes += 4 * ((2 * C * I + C + 2 * I)
                       + S * (I + 1) + K * I + 2 * K)
    return {"ops": ops, "bytes": nbytes,
            "seconds": max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)}
