"""Deep REASSIGN events: the chain with the per-class multinomial Gibbs
step.

The counterpart of the JAX package's route for REASSIGN buckets of more
than 16,384 reads (``miso_tpu/pipeline.py:456-472``): ``gibbs =
"multinomial"`` through the XLA scan (``mcmc.run_batch``, Gibbs step
``model.gibbs_reassign``), never the Pallas kernel, and no per-read tiles
at all (``pad_events(per_read=False)``).  It is no TPU kernel, so the
port is batched torch over the (event, chain) lanes on the batch's
device: the alpha-space MH step of ``reassign_kernel._mh_chain`` around
``model.gibbs_reassign``.  Its device memory and per-iteration work are
O(classes), whatever the depth.

``run_batch_multinomial`` takes the same batch, ``start_psi`` (E, K, I)
and result layout as ``run_batch_reassign``; the per-read fields may be
the (E, 1, I) placeholders.  ``final_n`` sums exactly to each event's
compatible reads (f32 counts are exact below 2^24 reads).
"""
from __future__ import annotations

import torch

from miso_tpu_torch.sampler.mcmc import (EventBatch, SamplerConfig,
                                         SamplerResult)
from miso_tpu_torch.sampler.model import gibbs_reassign
from miso_tpu_torch.sampler.reassign_kernel import (_event_consts,
                                                    _mh_chain, _uniforms)

# launches of the deep route; not a kernel, so apart from the kernels'
# counters
LAUNCHES = {"deep": 0}


def run_batch_multinomial(seed: int, batch: EventBatch, cfg: SamplerConfig,
                          start_psi=None) -> SamplerResult:
    """REASSIGN with the multinomial Gibbs step over a padded batch, on
    the batch's device, drawing from a ``torch.Generator`` seeded with
    ``seed``.  ``start_psi`` (E, K, I) selects the GIVEN start."""
    if cfg.algorithm != "reassign":
        raise ValueError("run_batch_multinomial runs REASSIGN only (got %s)"
                         % cfg.algorithm)
    if cfg.lag < 1 or cfg.iters < 0 or cfg.burn_in < 0 or cfg.chains < 1:
        raise ValueError("bad sampler schedule: %r" % (cfg,))
    LAUNCHES["deep"] += 1
    f32 = torch.float32
    gen, uniform = _uniforms(seed, batch.weights.device, None)
    W = batch.weights.to(f32)[:, None]                      # (E, 1, C, I)
    lr = batch.log_read.to(f32)[:, None]
    # reads of classes with a compatible isoform (padded isoforms weigh
    # 0): the reads that count into some isoform, whatever psi is
    compat = W.sum(-1) > 0                                  # (E, 1, C)
    counts = torch.where(compat, batch.counts.to(f32)[:, None], 0.0)

    def gibbs(psi, want_rp):
        draws = gibbs_reassign(psi, W, counts, generator=gen)  # (E,K,C,I)
        n = draws.sum(-2)
        rp = ((draws * lr).sum((-1, -2)) if want_rp
              else torch.zeros(n.shape[:2], dtype=f32, device=n.device))
        return n, rp

    return _mh_chain(cfg, _event_consts(batch), start_psi, uniform, gibbs,
                     counts.sum(-1))
