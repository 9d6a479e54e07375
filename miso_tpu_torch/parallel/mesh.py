"""Event-data parallelism over the local devices, in torch.

The port of ``miso_tpu/parallel/mesh.py``, written anew because that
module imports JAX.  The padded event catalog is split along the event
axis over a "mesh": a tuple of ``torch.device``, one entry per shard.
Every shard runs the single-device sampler (kernel B1, B2, or B3 of the
deep route) on its own device and on a CUDA stream of its own, so a list
that names one card twice still runs its shards side by side.  There is
no traffic between shards; results stay on their devices, in event order
(``ShardedResult``).

Shard k's seed carries a shard axis, the counterpart of
``jax.random.fold_in(key, axis_index)`` (``mesh.py:138-141``): the
pipeline passes one ``chunk_seed(..., shard=k)`` per shard.  A mesh of
one entry has no shard axis.  The pipeline runs each chunk on a stream of
every entry's pool (``stream_pool``), so chunks run side by side on a
card; ``shard_streams`` gives the one stream an entry (the default
stream for a mesh of one) of the convergent stop's rounds.

Every launch of a sharded run is made from the calling thread, so the
kernels' ``LAUNCHES`` counters need no lock.  A tensor of shard k is
made, read and written only under shard k's stream; the host copies of
the results wait for that stream (``ShardedResult.map``, or an event
recorded on it).  ``_SHARDED_FN_CACHE`` is not ported: it saved JAX
retracing only.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from miso_tpu_torch import trace
from miso_tpu_torch.sampler.mcmc import (EventBatch, SamplerConfig,
                                         SamplerResult, batch_from_numpy)

Mesh = Tuple[torch.device, ...]


def resolve_device(device) -> torch.device:
    """The device a run asks for; never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %r asked for, but torch sees no CUDA "
                           "device (pass --device cpu to run the plain "
                           "version on the CPU)" % str(device))
    return dev


def make_event_mesh(devices=None) -> Mesh:
    """The mesh over every visible CUDA device, or over ``devices`` as
    given (repeats kept: each entry is a shard).  A CUDA entry where torch
    sees no card raises."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("a mesh over the CUDA devices asked for, but "
                               "torch sees none")
        devices = ["cuda:%d" % i for i in range(n)]
    mesh = tuple(resolve_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def pad_to_devices(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to a multiple of n (zero events are masked out by
    counts=0 and contribute nothing)."""
    e = arr.shape[0]
    rem = (-e) % n
    if rem == 0:
        return arr
    pad = np.zeros((rem,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def shard_streams(mesh: Mesh) -> Tuple[Optional[torch.cuda.Stream], ...]:
    """A new CUDA stream for every CUDA entry of a mesh of two or more
    (None for a CPU entry): two entries on one card get two streams.  A
    mesh of one entry runs on its device's default stream (None)."""
    if len(mesh) == 1:
        return (None,)
    return tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                 for d in mesh)


def stream_pool(device: torch.device,
                size: int) -> Tuple[Optional[torch.cuda.Stream], ...]:
    """``size`` streams on ``device`` (None each for the CPU): PyTorch's
    pool streams, which neither wait for the legacy default stream nor
    it for them."""
    if device.type != "cuda":
        return (None,) * size
    return tuple(torch.cuda.Stream(device=device) for _ in range(size))


def on_stream(stream):
    """Context that makes ``stream`` (and its device) current; nothing for
    a CPU shard."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


def _split(arr, n: int) -> List[np.ndarray]:
    """Pad axis 0 of ``arr`` to a multiple of n and cut it into n
    contiguous slices."""
    a = pad_to_devices(np.asarray(arr), n)
    step = a.shape[0] // n
    return [a[k * step:(k + 1) * step] for k in range(n)]


def _shard_inputs(batch, mesh: Mesh, streams, start_psi=None):
    """[(torch ``EventBatch``, start psi or None)] per mesh entry: the
    entry's slice of the host batch (and of ``start_psi``), copied to its
    device by ``batch_from_numpy`` under its stream, from page-locked
    staging: it returns at once (each a ``wait_card`` span, ``trace``)."""
    n = len(mesh)
    parts = [_split(a, n) for a in batch]
    starts = ([None] * n if start_psi is None
              else _split(np.asarray(start_psi, np.float32), n))
    out = []
    for k, (dev, s) in enumerate(zip(mesh, streams)):
        with on_stream(s), trace.span("wait_card", shard=k):
            out.append(batch_from_numpy(type(batch)(*(p[k] for p in parts)),
                                        dev, starts[k]))
    return out


def shard_batch(batch, mesh: Mesh, streams=None) -> List[EventBatch]:
    """A host (numpy) ``EventBatch`` as one torch ``EventBatch`` per mesh
    entry: its contiguous slice of the event axis, padded to a multiple
    of ``len(mesh)``, on that entry's device -- one host-to-device copy
    per field and shard, made on the shard's stream (``streams``, as
    ``shard_streams`` gives them; default stream where None)."""
    streams = streams or (None,) * len(mesh)
    return [b for b, _ in _shard_inputs(batch, mesh, streams)]


class ShardedResult(NamedTuple):
    """One ``SamplerResult`` per mesh entry, each on its device, in event
    order, with the stream each was made on."""
    shards: Tuple[SamplerResult, ...]
    streams: Tuple[Optional[torch.cuda.Stream], ...]

    def map(self, fn) -> list:
        """[fn(shard k) under shard k's stream, for every k]."""
        out = []
        for res, s in zip(self.shards, self.streams):
            with on_stream(s):
                out.append(fn(res))
        return out

    def to_numpy(self) -> SamplerResult:
        """The whole result on the host, shards concatenated in event
        order."""
        parts = self.map(lambda r: r.to_numpy())
        return SamplerResult(*(np.concatenate(f) for f in zip(*parts)))


def run_batch_sharded(seeds, batch, cfg: SamplerConfig, mesh: Mesh,
                      sampler, start_psi=None, fixed_uniform=None,
                      streams=None) -> ShardedResult:
    """Run ``sampler(seeds[k], batch_k, cfg, start_psi_k)`` on every
    shard k of a host batch, each on its device and stream (``streams``,
    one per mesh entry; new ones where None).  ``seeds`` holds one seed
    per shard (the pipeline's ``chunk_seed(..., shard=k)``).
    ``start_psi`` (E, K, I), the GIVEN start, is split as the batch is.
    ``fixed_uniform`` is passed to the sampler (the kernels'
    fixed-uniform mode).  A shard that fails raises; nothing falls
    back."""
    n = len(mesh)
    if len(seeds) != n:
        raise ValueError("%d seeds for a mesh of %d" % (len(seeds), n))
    streams = streams or shard_streams(mesh)
    kw = {} if fixed_uniform is None else {"fixed_uniform": fixed_uniform}
    out = []
    for (b, sp), sk, s in zip(_shard_inputs(batch, mesh, streams,
                                            start_psi), seeds, streams):
        with on_stream(s):
            out.append(sampler(sk, b, cfg, sp, **kw))
    return ShardedResult(tuple(out), tuple(streams))


def posterior_summary(result: SamplerResult):
    """Posterior mean and variance per event over the flat samples, on
    the samples' device (``mesh.py:160-170``)."""
    flat = result.psi_samples.reshape(
        result.psi_samples.shape[0], -1, result.psi_samples.shape[-1])
    return flat.mean(dim=1), flat.var(dim=1, correction=0)
