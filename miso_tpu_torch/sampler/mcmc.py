"""Batch, config and result types of the sampler, in torch.

Counterparts of ``miso_tpu/sampler/mcmc.py:36-117`` with the same field
names, shapes and sample layout, so host code passes batches unchanged.
That module imports jax at module level and cannot be imported here.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class EventBatch(NamedTuple):
    """A device-ready batch of E events padded to (C classes, I isoforms).

    weights:   (E, C, I) class weights ({0,1} compatibility, single-end).
    log_read:  (E, C, I) per-read log score of a class-c read on isoform i.
    counts:    (E, C) reads per class.
    log_iso_w: (E, I) log effective length; -inf on padded isoforms.
    hyper:     (E, I) Dirichlet prior parameters.
    num_iso:   (E,) real isoform count per event (0 on padding events).
    read_w:    (E, R, I) per-read class weights.
    read_logscore: (E, R, I) per-read log score by isoform.
    """

    weights: torch.Tensor
    log_read: torch.Tensor
    counts: torch.Tensor
    log_iso_w: torch.Tensor
    hyper: torch.Tensor
    num_iso: torch.Tensor
    read_w: torch.Tensor
    read_logscore: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampler schedule (reference defaults:
    misopy/settings/miso_settings.txt burn_in=500 lag=10 num_iters=5000
    num_chains=6)."""

    iters: int = 5000
    burn_in: int = 500
    lag: int = 10
    chains: int = 6
    algorithm: str = "reassign"  # 'reassign' | 'marginal' | 'classes'
    gibbs: str = "perread"       # the port runs 'perread' only
    dtype: str = "float32"       # the port computes in float32 only

    @property
    def num_records(self) -> int:
        return (self.iters - self.burn_in) // self.lag


class SamplerResult(NamedTuple):
    psi_samples: torch.Tensor  # (E, RREC, K, I) record-major, chains inner
    loglik: torch.Tensor       # (E, RREC, K)
    accepted: torch.Tensor     # (E,) accepted over chains, incl. burn-in
    rejected: torch.Tensor     # (E,)
    final_n: torch.Tensor      # (E, K, I) final per-isoform assignment counts
    final_psi: torch.Tensor    # (E, K, I)

    def flat_samples(self):
        """(E, RREC*K, I) in the reference's interleaved sample order."""
        E, R, K, I = self.psi_samples.shape
        return self.psi_samples.reshape(E, R * K, I)

    def flat_loglik(self):
        E, R, K = self.loglik.shape
        return self.loglik.reshape(E, R * K)

    def to_numpy(self) -> "SamplerResult":
        return SamplerResult(*(t.detach().cpu().numpy() for t in self))


def batch_from_numpy(batch, device, start_psi=None):
    """The JAX package's numpy batch (an ``EventBatch`` of arrays or the
    ``pad_events`` dict) -> (torch ``EventBatch``, start_psi tensor or
    None) on ``device``.  Float fields become float32 (bf16 per-read
    tiles are upcast), ``num_iso`` int32; ``start_psi`` is (E, K, I).

    To a card each array goes through page-locked staging, so its copy is
    asynchronous on the current stream and waits for no work queued
    before it.  The staging comes from PyTorch's caching host allocator,
    which hands a block out again only once the copies recorded on it
    have run: it may be dropped at once."""
    fields = batch._asdict() if hasattr(batch, "_asdict") else dict(batch)
    out = {}
    for name in EventBatch._fields:
        out[name] = _to_device(fields[name], np.int32 if name == "num_iso"
                               else np.float32, device)
    sp = None
    if start_psi is not None:
        sp = _to_device(start_psi, np.float32, device)
    return EventBatch(**out), sp


def _to_device(a, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a, dtype))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True).contiguous()
    return t.to(device).contiguous()


def _pow2_pad_events(batch: EventBatch, start_psi, n: int):
    """Pad a numpy batch's event axis up to the next power of two with
    zero events (num_iso = 0, masked everywhere).  JAX-free copy of
    ``miso_tpu/sampler/mcmc.py:_pow2_pad_events`` with floor 1: the
    64-event floor only saved TPU recompiles."""
    target = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)
    if target == n:
        return batch, start_psi
    arrs = []
    for a in batch:
        a = np.asarray(a)
        pad = np.zeros((target - n,) + a.shape[1:], a.dtype)
        arrs.append(np.concatenate([a, pad], axis=0))
    if start_psi is not None:
        sp = np.asarray(start_psi)
        pad = np.zeros((target - n,) + sp.shape[1:], sp.dtype)
        start_psi = np.concatenate([sp, pad], axis=0)
    return type(batch)(*arrs), start_psi
