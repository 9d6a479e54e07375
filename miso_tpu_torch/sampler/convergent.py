"""Convergent-mean stopping with adaptive extension, in torch.

The counterpart of ``miso_tpu/sampler/mcmc.py:180-351``
(``run_batch_convergent``) and ``:147-170`` (``_quantized_rows``).  The
whole batch runs one block; events whose per-isoform R-hat is above the
threshold run again as a continuation batch, each from its own final
psi (GIVEN start), with iters' = iters + g * (iters - burn_in) and
burn_in' = iters (g = 2 is the reference's 3*noIter - 2*burnIn,
miso.c:903-928).

Left out, as they served only the TPU's remote runtime and compile
cache: the batched round keys (``_round_keys``), the one host transfer
per round, the 64-event pad floor and the power-of-two row index.  Each
round instead draws from its own seed, mixed from the chunk seed and the
round index, so no round replays another's stream.  Each converged
event's samples still leave the device once, quantised to the ``.miso``
precision.  Over a mesh every round splits its events as the fixed stop
does (``miso_tpu/pipeline.py:513-517`` passes ``mesh=``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from miso_tpu_torch.parallel.mesh import on_stream, run_batch_sharded
from miso_tpu_torch.quantize import quantize_psi, quantize_scores
from miso_tpu_torch.sampler.mcmc import (EventBatch, SamplerConfig,
                                         _pow2_pad_events)
from miso_tpu_torch.stats.rhat import batch_rhat


def round_seed(seed: int, round_i: int) -> int:
    """64-bit sampler seed of adaptive round ``round_i`` of a chunk."""
    seed = int(seed) & ((1 << 64) - 1)
    words = np.random.SeedSequence(
        [seed & 0xFFFFFFFF, seed >> 32, round_i]).generate_state(
            2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)


def _quantized_rows(psi_samples, loglik, idx, two_iso: bool):
    """Posterior payload of the selected batch rows ``idx`` at ``.miso``
    precision, on the samples' device: int32 psi ticks (column 0 only
    for two-isoform events) and per-event-offset score centipoints
    (resid, cmin, cmax)."""
    E, R, K, I = psi_samples.shape
    quant = quantize_psi(psi_samples.reshape(E, R * K, I)[idx], two_iso)
    return (quant,) + quantize_scores(loglik.reshape(E, R * K)[idx])


def _host_rows(res, rows, two_iso: bool):
    """(flat samples, scores) of the batch rows ``rows`` of one sampler
    result at ``.miso`` precision, on the host: psi from its int ticks,
    scores from their centipoints, a full-precision row where the
    centipoints span more than uint16."""
    idx = torch.as_tensor(rows, device=res.psi_samples.device)
    quant, resid, cmin, cmax = (t.cpu().numpy() for t in
                                _quantized_rows(res.psi_samples,
                                                res.loglik, idx, two_iso))
    if two_iso:
        c0 = quant.astype(np.float64) / 1e4
        flat = np.stack([c0, 1.0 - c0], axis=-1)
    else:
        flat = quant.astype(np.float32) / 1e4
    cmin = cmin.astype(np.float64)
    ll = (resid.astype(np.float64) + cmin[:, None]) / 100.0
    with np.errstate(invalid="ignore"):
        wide = np.flatnonzero((cmax.astype(np.float64) - cmin) > 65535)
    for w in wide:  # rare: full-precision row
        ll[w] = res.loglik[int(rows[w])].reshape(-1).cpu().numpy()
    return flat, ll


def run_batch_convergent(seeds, events: EventBatch, cfg: SamplerConfig,
                         sampler, mesh, max_iters: int = 500000,
                         rhat_threshold: float = 1.1, start_psi=None,
                         extend_factor: float = 2.0, streams=None):
    """Convergent-mean stopping over a numpy batch.

    ``sampler(seed, batch, cfg, start_psi)`` runs one block on a padded
    torch batch on its device and returns a ``SamplerResult``
    (``pipeline.run_sampler``).  ``mesh`` is a tuple of devices
    (``parallel/mesh.py``; one entry for an unsplit run) over which every
    round splits its events, with ``seeds`` one seed per entry and
    ``streams`` the entries' streams.  ``start_psi`` (E, K, I), if given, seeds round
    0 (the NNLS linear start); later rounds start from each event's final
    psi.  Returns (results, iters_used): per-event dicts with float
    ``samples`` (S, I) and ``loglik`` (S,), ``accepted``, ``rejected``,
    ``final_n``, ``final_psi`` (K, I) and the final ``iters``/``burn_in``
    schedule."""
    if extend_factor < 1.0:
        # burnIn' = noIter discards the whole previous run (reference
        # semantics), so the retained window scales by g each round --
        # g < 1 would shrink it toward zero records
        raise ValueError("extend_factor must be >= 1 (got %r)"
                         % extend_factor)
    E = len(events.num_iso)
    I = np.asarray(events.weights).shape[2]
    two_iso = I == 2
    results: list = [None] * E
    iters_used = np.zeros(E, dtype=np.int64)
    remaining = np.arange(E)
    cur = cfg
    start = None if start_psi is None else np.array(start_psi, np.float32)
    round_i = 0
    while len(remaining):
        nr = len(remaining)
        sub = EventBatch(*(np.asarray(a)[remaining] for a in events))
        sp = None if start is None else start[remaining]
        sub, sp = _pow2_pad_events(sub, sp, nr)
        res = run_batch_sharded([round_seed(s, round_i) for s in seeds],
                                sub, cur, mesh, sampler, start_psi=sp,
                                streams=streams)
        # every shard's R-hat and counts, joined in event order
        host = res.map(lambda r: [t.cpu().numpy() for t in (
            batch_rhat(r.psi_samples), r.accepted, r.rejected, r.final_n,
            r.final_psi)])
        rh, acc, rej, fn, fpsi = (np.concatenate(f)[:nr]
                                  for f in zip(*host))
        iso_mask = np.arange(I)[None, :] < np.asarray(sub.num_iso)[:nr, None]
        conv = np.all(np.where(iso_mask, rh <= rhat_threshold, True), axis=1)
        next_iters = int(round(cur.iters
                               + extend_factor * (cur.iters - cur.burn_in)))
        if next_iters > max_iters:
            conv[:] = True  # maxIterations cap (miso.c:908)
        rows = np.flatnonzero(conv)
        if rows.size:
            # each shard's converged rows, quantised on its device and
            # stream, joined in row order
            got, lo = [], 0
            for r, stream in zip(res.shards, res.streams):
                n_k = r.accepted.shape[0]
                mine = rows[(rows >= lo) & (rows < lo + n_k)] - lo
                lo += n_k
                if len(mine):
                    with on_stream(stream):
                        got.append(_host_rows(r, mine, two_iso))
            flat = np.concatenate([g[0] for g in got])
            ll = np.concatenate([g[1] for g in got])
            for n, j in enumerate(rows):
                results[remaining[j]] = {
                    "samples": flat[n], "loglik": ll[n],
                    "accepted": acc[j], "rejected": rej[j],
                    "final_n": fn[j], "final_psi": fpsi[j],
                    "iters": cur.iters, "burn_in": cur.burn_in,
                }
        iters_used[remaining] = cur.iters
        if conv.all():
            break
        if start is None:
            start = np.zeros((E, cur.chains, I), np.float32)
        start[remaining] = fpsi
        remaining = remaining[~conv]
        cur = dataclasses.replace(cur, iters=next_iters, burn_in=cur.iters)
        round_i += 1
    return results, iters_used
