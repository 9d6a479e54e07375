"""End-to-end quantification pipeline on the local GPUs: indexed GFF + BAM
-> .miso.

The port of ``miso_tpu/pipeline.py``.  The host half (catalog walk, event
compile, ``.miso`` formatting) is the JAX package's code, copied into
``_host.py`` and the port's ``core/``, ``io/`` and ``native/``.  The
device half is torch:

1. ``StreamRunner._dispatch`` pads a bucket's class tensors and runs the
   sampler (``run_sampler``): REASSIGN hands them to its wrapper
   (``sampler/reassign_kernel.py``) with the bucket's read slots, where
   the wide kernel B1w reads the classes themselves and the narrow one
   first expands the per-read tiles on the device
   (``reassign_kernel.expand_read_tensors``); MARGINAL and CLASSES run
   their kernel (``sampler/marginal_kernel.py``) on the class tensors
   alone.
   It quantises psi to ticks and scores to centipoints, with the
   posterior summary computed on the device (``quantize.py``);
2. a materializer thread copies each chunk to the host as its kernels
   finish, in no fixed order, draws the final assignment counts of
   MARGINAL/CLASSES events there, and hands the chunk to the ``.miso``
   writers.

On a card the dispatch runs ahead of it: each chunk's copies (from
page-locked staging), launch and payload go on a stream of a pool that no
other chunk in flight holds, so the small launches of many buckets run
side by side.

``--convergent`` runs each bucket through ``sampler/convergent.py``
instead, synchronously on the dispatch thread.  ``--linear-start`` seeds
every chain of either stop rule with the host NNLS start.  A REASSIGN
bucket of more than ``DEEP_READS`` reads builds no per-read tiles and
runs the multinomial Gibbs step (``sampler/deep.py``: kernel B3 on the
card), as the JAX package does.

The port runs single-end and paired-end events with every algorithm,
either start and either stop rule, with full ``.miso`` output,
``--summary-only`` or ``--pack-output``, under ``--profile`` too, on one
host or on several (``parallel/distributed.py``: each host runs its
shard of the genes and writes its own summary into the shared tree).
On a host with more than one visible card, ``device="cuda"`` splits every
chunk's events over all of them (``parallel/mesh.py``, ``resolve_mesh``):
each shard runs its kernel on its own card and on a stream of that
card's pool, and the materializer joins the shards in event order.

Every kernel takes a bucket of any width: the REASSIGN and MARGINAL
wrappers run their narrow instances (B1, B2) below ``wide.WIDE_FROM``
(REASSIGN, 128) and ``wide.WIDE_FROM_MARGINAL`` isoforms (MARGINAL and
CLASSES, 64) and the wide kernels (B1w, B2w: a lane a block, any width)
from there on, and the deep route's B3 takes any width; nothing takes a
kernel's place on the card.
"""
from __future__ import annotations

import functools
import json
import os
import queue as queue_mod
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from miso_tpu_torch import trace
from miso_tpu_torch.core.events import (CompiledEvent, bucket_events,
                                        _round_up, _round_up_iso,
                                        _round_up_reads, pad_events)
from miso_tpu_torch.io import sam as sam_io
from miso_tpu_torch.io.index import get_gene_ids_to_filenames
from miso_tpu_torch.io.settings import Settings
# compile_gene_event, event_output_path and write_event_results are not
# used here: cli/run_miso.py imports them from this module, as the JAX
# package's does from its pipeline.py
from miso_tpu_torch._host import (RunConfig, _CompileStream, _LazyResult,
                                  _ci_bound_indices, _pack_events_batch,
                                  _write_events_batch, compile_gene_event,
                                  event_output_path, write_event_results)
from miso_tpu_torch.parallel import distributed
# resolve_device is imported from here by cli/main.py and cli/test_miso.py
from miso_tpu_torch.parallel.mesh import (make_event_mesh, resolve_device,
                                          run_batch_sharded, shard_streams,
                                          stream_pool)
from miso_tpu_torch.quantize import (quantize_psi, quantize_scores,
                                     summary_stats)
from miso_tpu_torch.sampler.convergent import run_batch_convergent
from miso_tpu_torch.sampler.deep import run_batch_multinomial
from miso_tpu_torch.sampler.marginal_kernel import run_batch_marginal
from miso_tpu_torch.sampler.mcmc import (EventBatch, SamplerConfig,
                                         _pow2_pad_events)
from miso_tpu_torch.sampler.reassign_kernel import run_batch_reassign

# Above this many reads a REASSIGN bucket takes the multinomial Gibbs
# step and builds no per-read tiles, as in the JAX package
# (pipeline.py:460).  MARGINAL and CLASSES read no per-read tiles at any
# depth.
DEEP_READS = 16384
# the last word of a chunk seed's shard part (chunk_seed)
SHARD_TAG = 0x5348
# streams in each mesh entry's pool, and the ceiling on the chunks in
# flight: a chunk runs on one that no other chunk in flight holds, so the
# launches of different buckets share the card (PERF.md, section 6)
POOL_STREAMS = 16
# the share of the smallest card's memory that the device tensors of the
# chunks in flight may hold
IN_FLIGHT_MEMORY_SHARE = 0.25
# seconds between the materializer's looks at the chunks' ready events
READY_POLL_S = 0.002


def resolve_mesh(device):
    """The mesh a run's ``device`` asks for (pipeline.py:166-187), or None
    for an unsharded run on one device.  ``"cuda"`` is every visible card
    when there are more than one (``CUDA_VISIBLE_DEVICES`` or
    ``"cuda:N"`` restricts it), else None; ``"cuda:N"`` and ``"cpu"`` are
    None; a list or tuple of devices is that mesh, even of one entry.  A
    CUDA entry where there is no card raises (``resolve_device``)."""
    if isinstance(device, (list, tuple)):
        return make_event_mesh(device)
    dev = resolve_device(device)
    if (dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() > 1):
        return make_event_mesh()
    return None


def _bucket_key(ev: CompiledEvent) -> Tuple[int, int, int]:
    return (_round_up_iso(ev.num_iso),
            _round_up(max(ev.num_classes, 1)),
            _round_up_reads(max(int(ev.counts.sum()), 1)))


def chunk_seed(seed: int, offset: int, pad_iso: int, pad_classes: int,
               pad_reads: int, host: Optional[int] = None,
               shard: Optional[int] = None) -> int:
    """64-bit sampler seed of one chunk.  It mixes every bucket axis and
    the chunk offset within the bucket: buckets that differ in one axis,
    or successive chunks of one bucket, would otherwise replay the same
    per-(event, chain) random streams (pipeline.py:473-484).  ``host`` is
    the host id of a multi-host run, None on a single host: every host
    counts its chunk offsets from 0, so without it two hosts with one
    ``--seed`` would draw the same streams for different events.
    ``shard`` is the mesh entry of a sharded chunk (mesh.py:138-141),
    None where the chunk is not split; its part ends in ``SHARD_TAG``, so
    shard k of one host never takes host k's seed."""
    words = np.random.SeedSequence(
        [seed, offset, pad_iso, pad_classes, pad_reads]
        + ([] if host is None else [host])
        + ([] if shard is None else [shard, SHARD_TAG])).generate_state(
            2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)


def run_sampler(seed: int, batch: EventBatch, cfg: SamplerConfig,
                start_psi, pad_reads: int):
    """One sampler run over a padded torch batch on its device: MARGINAL
    and CLASSES read the class tensors only, and so does REASSIGN above
    ``DEEP_READS`` reads (the multinomial Gibbs step); shallower REASSIGN
    buckets go to their wrapper as classes and ``pad_reads`` read slots,
    which B1w reads as they are and the other routes expand."""
    if cfg.algorithm in ("marginal", "classes"):
        return run_batch_marginal(seed, batch, cfg, start_psi=start_psi)
    if pad_reads > DEEP_READS:
        return run_batch_multinomial(seed, batch, cfg, start_psi=start_psi)
    return run_batch_reassign(seed, batch, cfg, start_psi=start_psi,
                              pad_reads=pad_reads)


def linear_start(evs: List[CompiledEvent], cfg: RunConfig,
                 pad_iso: int) -> np.ndarray:
    """(n, K, pad_iso) f32 start psi: every chain of an event starts at
    its NNLS deconvolution (MISO_START_LINEAR, pipeline.py:485-497); an
    event whose NNLS fails starts uniform, as in the JAX package."""
    from miso_tpu_torch.core.assignment import linear_start_psi

    sp = np.zeros((len(evs), cfg.chains, pad_iso), np.float32)
    for j, ev in enumerate(evs):
        try:
            expr = linear_start_psi(ev, cfg.read_len, cfg.overhang_len)
        except Exception:
            expr = np.full(ev.num_iso, 1.0 / ev.num_iso)
        sp[j, :, :ev.num_iso] = expr[None, :]
    return sp


def _to_numpy(t):
    return None if t is None else t.cpu().numpy()


def _full_row(parts, j: int):
    """Event j's full-precision scores from the part that holds it."""
    for part in parts:
        n = part["accepted"].shape[0]
        if j < n:
            return _to_numpy(part["ll_full"][j])
        j -= n
    raise IndexError("event past the chunk")


def _memory_budget(mesh) -> Optional[int]:
    """Bytes the chunks in flight may hold: ``IN_FLIGHT_MEMORY_SHARE`` of
    the smallest card's memory; None for a mesh of the CPU alone."""
    cards = [d for d in mesh if d.type == "cuda"]
    if not cards:
        return None
    return int(IN_FLIGHT_MEMORY_SHARE
               * min(torch.cuda.mem_get_info(d)[1] for d in cards))


class StreamRunner:
    """Streaming device dispatcher (pipeline.py:306-766): events
    accumulate into (pad_iso, pad_classes, pad_reads) buckets and every
    full bucket is dispatched at once; a materializer thread copies
    finished chunks to the host while later chunks run.  Every chunk is
    split over the mesh (``resolve_mesh(device)``; an unsharded run is a
    mesh of one entry) and runs on stream i of every entry's pool
    (``stream_pool``), an i that no other chunk in flight holds: its
    copies from page-locked staging, its launch and its device payload,
    so chunks of different buckets run side by side as the card has room.

    A chunk is in flight from its dispatch until it is materialized.
    Fewer than ``POOL_STREAMS`` are, and on a card their device tensors
    hold under ``IN_FLIGHT_MEMORY_SHARE`` of its memory (``_put`` waits
    for room); the materializer takes whichever has completed first.  The
    order changes no result: every chunk's seed keys on its bucket and
    its offset in that bucket, and each event's results are its own.

    ``on_chunk(tags, results)`` fires on the materializer thread as each
    chunk lands, inside the chunk's ``materialize`` span.  ``tracer`` is
    the job's (``trace.job``): the dispatch and materialize spans of a
    chunk share its chunk id."""

    def __init__(self, cfg: RunConfig, seed: int = 0, device="cuda",
                 on_chunk=None, tracer: trace.Tracer = trace.OFF):
        self.cfg = cfg
        self.seed = seed
        self.mesh = resolve_mesh(device) or (resolve_device(device),)
        # the convergent stop's rounds: a stream per entry, the default
        # stream for a mesh of one
        self.streams = shard_streams(self.mesh)
        self.pools = [stream_pool(d, POOL_STREAMS) for d in self.mesh]
        self.memory_budget = _memory_budget(self.mesh)
        self.on_chunk = on_chunk
        self.tracer = tracer
        # the host axis of the chunk seeds: this host's id in a
        # multi-host run, None (no axis) on a single host
        self.host = (distributed.process_index()
                     if distributed.process_count() > 1 else None)
        self.sampler_cfg = SamplerConfig(
            iters=cfg.iters, burn_in=cfg.burn_in, lag=cfg.lag,
            chains=cfg.chains, algorithm=cfg.algorithm)
        self.buckets: Dict[Tuple[int, int, int], Tuple[list, list]] = {}
        self.bucket_off: Dict[Tuple[int, int, int], int] = {}
        self.bucket_chunks: Dict[Tuple[int, int, int], int] = {}
        # the chunks in flight, in dispatch order, under _cond
        self._in_flight: List[dict] = []
        self._cond = threading.Condition()
        self._closing = False
        self._aborted = False
        self._mat_err: list = []
        self._mat_thread = threading.Thread(target=self._materialize_loop,
                                            daemon=True)
        self._mat_thread.start()

    # ------------------------------------------------------------ intake
    def add(self, ev: CompiledEvent, tag=None) -> None:
        key = _bucket_key(ev)
        evs, tags = self.buckets.setdefault(key, ([], []))
        evs.append(ev)
        tags.append(ev if tag is None else tag)
        # progressive chunk sizes (512 -> 1024 -> 2048 -> max): the first
        # chunks dispatch early, so device work, copies and writes start
        # while the host still compiles (pipeline.py:363-381).  Convergent
        # stop keeps whole buckets: each chunk runs its own rounds.
        n_disp = self.bucket_chunks.get(key, 0)
        thresh = (self.cfg.max_batch_events if self.cfg.stop == "convergent"
                  else min(self.cfg.max_batch_events,
                           max(512 << n_disp, 1)))
        if len(evs) >= thresh:
            del self.buckets[key]
            self.bucket_chunks[key] = n_disp + 1
            self._dispatch(key, evs, tags)
        self._check_err()

    def chain_cost(self, key) -> int:
        """What a step of a chain of bucket ``key`` costs, read from the
        key: B1 and B1w (REASSIGN up to ``DEEP_READS`` reads) pass every
        read slot over the isoforms, B3 and the MARGINAL/CLASSES kernels
        every class."""
        pad_iso, pad_classes, pad_reads = key
        if self.cfg.algorithm == "reassign" and pad_reads <= DEEP_READS:
            return pad_iso * pad_reads
        return pad_iso * pad_classes

    def finish(self) -> None:
        """Flush partial buckets in sub-chunks, the costliest chains first
        (``chain_cost``) so that the many short ones fill in around them;
        drain, join the thread.  A bucket's chunks keep their order, and
        with it their offsets and seeds."""
        step = (self.cfg.max_batch_events if self.cfg.stop == "convergent"
                else max(256, self.cfg.max_batch_events // 8))
        for key in sorted(self.buckets,
                          key=lambda k: (-self.chain_cost(k), k)):
            evs, tags = self.buckets[key]
            for lo in range(0, len(evs), step):
                self._dispatch(key, evs[lo:lo + step], tags[lo:lo + step])
        self.buckets.clear()
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        self._mat_thread.join()
        self._check_err()

    def abort(self) -> None:
        """Error-path shutdown: drop the chunks in flight, stop the
        thread."""
        self.buckets.clear()
        with self._cond:
            self._aborted = True
            self._in_flight.clear()
            self._cond.notify_all()
        self._mat_thread.join(timeout=30)

    def _put(self, item: dict) -> None:
        """Wait for room among the chunks in flight (fewer than the pool's
        streams, their device bytes under the budget), then take ``item``
        in on the first stream of the pool that none of them holds
        (``item["stream"]``).  Raises if the materializer died."""
        size = len(self.pools[0])
        with self._cond:
            while not self._room(size):
                self._check_err()
                if not self._mat_thread.is_alive():
                    raise RuntimeError("materializer thread died")
                self._cond.wait(timeout=5)
            item["stream"] = min(set(range(size)) - {
                p["stream"] for p in self._in_flight})
            self._in_flight.append(item)

    def _room(self, size: int) -> bool:
        if len(self._in_flight) >= size:
            return False
        return (self.memory_budget is None or not self._in_flight
                or sum(p.get("bytes", 0) for p in self._in_flight)
                < self.memory_budget)

    def _check_err(self):
        if self._mat_err:
            raise self._mat_err[0]

    @staticmethod
    def _passed(p: dict, device=None) -> bool:
        """Have chunk ``p``'s kernels run (its part on ``device``, or all
        its parts)?  Not while it is being dispatched."""
        if "parts" not in p:
            return False
        return all(part["ready"] is None or part["ready"].query()
                   for part in p["parts"]
                   if device is None or part["device"] == device)

    # ---------------------------------------------------------- dispatch
    def _dispatch(self, key, evs, tags) -> None:
        tr = self.tracer
        chunk = tr.next_chunk()
        # lanes: the event slots _pow2_pad_events pads the chunk to
        with tr.span("dispatch", chunk=chunk, shape=key, events=len(evs),
                     lanes=1 << (len(evs) - 1).bit_length()):
            self._dispatch_chunk(key, evs, tags, chunk)
        self._check_err()

    def _dispatch_chunk(self, key, evs, tags, chunk) -> None:
        cfg = self.cfg
        tr = self.tracer
        pad_iso, pad_classes, pad_reads = key
        with tr.span("dispatch.pad"):
            batch = EventBatch(**pad_events(
                evs, pad_iso=pad_iso, pad_classes=pad_classes,
                pad_reads=pad_reads, read_dtype=np.float32, per_read=False))
        lo = self.bucket_off.get(key, 0)
        self.bucket_off[key] = lo + cfg.max_batch_events
        # one seed per shard; a mesh of one entry has no shard axis
        n = len(self.mesh)
        seeds = [chunk_seed(self.seed, lo, pad_iso, pad_classes, pad_reads,
                            host=self.host, shard=k if n > 1 else None)
                 for k in range(n)]
        start = None
        if cfg.start == "linear":
            with tr.span("dispatch.start"):
                start = linear_start(evs, cfg, pad_iso)
        sampler = functools.partial(run_sampler, pad_reads=pad_reads)
        if cfg.stop == "convergent":
            with tr.span("dispatch.launch"):
                self._dispatch_convergent(evs, tags, batch, start, seeds,
                                          sampler)
            return
        with tr.span("dispatch.pad"):
            batch, start = _pow2_pad_events(batch, start, len(evs))
        two_iso = pad_iso == 2
        item = {"evs": evs, "tags": tags, "two_iso": two_iso,
                "chunk": chunk}
        with tr.span("queue_wait"):
            self._put(item)
        if tr.on:
            sampler = self._counted(sampler)
        # each shard quantised on its device and on the chunk's stream of
        # its pool; the copies to the card are the wait_card spans of
        # parallel/mesh.py
        with tr.span("dispatch.launch"):
            res = run_batch_sharded(
                seeds, batch, self.sampler_cfg, self.mesh, sampler,
                start_psi=start,
                streams=[pool[item["stream"]] for pool in self.pools])
            parts = res.map(lambda r: self._device_payload(r, two_iso))
        # on the card: the inputs and the sampler's results (the payload
        # is smaller than the results)
        nbytes = sum(np.asarray(a).nbytes for a in batch) + sum(
            t.nbytes for r in res.shards for t in r)
        with self._cond:
            item.update(parts=parts, bytes=nbytes)
            self._cond.notify_all()

    def _counted(self, sampler):
        """``sampler`` whose ``launch`` counters carry ``in_flight``: the
        chunks in flight on the launch's device as it is issued, this one
        included (``trace``)."""
        def run(seed, batch, cfg, start_psi, **kw):
            dev = batch.counts.device
            with self._cond:
                n = sum(1 for p in self._in_flight
                        if not self._passed(p, dev))
            with trace.counter_attrs(in_flight=n):
                return sampler(seed, batch, cfg, start_psi, **kw)
        return run

    def _device_payload(self, res, two_iso: bool) -> dict:
        """What the materializer copies of one sampler result: psi ticks,
        the device summary and score centipoints, on the result's device,
        and on a card an event recorded after them on the current stream,
        the chunk's (the materializer takes the chunk once it has
        passed).  REASSIGN's final counts come from the chain; the
        collapsed algorithms draw them on the host from chain 0's final
        psi."""
        quant = quantize_psi(res.flat_samples(), two_iso)
        bounds = _ci_bound_indices(quant.shape[1])
        summ = (None if bounds is None
                else summary_stats(quant, bounds[0], bounds[1]))
        ll = resid = cmin = cmax = None
        n_samples = int(quant.shape[1])
        if self.cfg.summary_only:
            quant = None
        else:
            ll = res.flat_loglik()
            resid, cmin, cmax = quantize_scores(ll)
        reassign = self.cfg.algorithm == "reassign"
        return {
            "quant": quant, "summ": summ, "n_samples": n_samples,
            "ll_min": cmin, "ll_max": cmax, "ll_resid": resid,
            "ll_full": ll, "accepted": res.accepted,
            "rejected": res.rejected,
            "final_n": res.final_n if reassign else None,
            "final_psi": None if reassign else res.final_psi,
            "device": res.accepted.device,
            "ready": (torch.cuda.current_stream(
                res.accepted.device).record_event()
                if res.accepted.is_cuda else None)}

    def _dispatch_convergent(self, evs, tags, batch, start, seeds,
                             sampler) -> None:
        """Convergent stop for one bucket (pipeline.py:506-572), on the
        dispatch thread: each round needs the last round's R-hat.  The
        class tensors are sliced per round on the host, and REASSIGN
        expands its per-read tiles on the device each round; with a mesh
        every round splits its events over it.  Summaries are taken on
        the host, batched per final schedule."""
        cfg = self.cfg
        conv_res, _ = run_batch_convergent(
            seeds, batch, self.sampler_cfg, sampler, self.mesh,
            max_iters=cfg.max_iters, start_psi=start,
            extend_factor=cfg.convergent_growth, streams=self.streams)
        groups: Dict[int, list] = {}
        for j in range(len(evs)):
            groups.setdefault(conv_res[j]["samples"].shape[0], []).append(j)
        summaries: Dict[int, tuple] = {}
        for S, idxs in groups.items():
            bounds = _ci_bound_indices(S)
            if bounds is None:
                continue
            T = np.clip(np.round(np.stack(
                [conv_res[j]["samples"] for j in idxs]) * 1e4),
                0, 10000).astype(np.int64)          # (n, S, I_pad)
            st = np.sort(T, axis=1)
            mean = (T.astype(np.float64) / 1e4).mean(axis=1)
            lo, hi = st[:, bounds[0]] / 1e4, st[:, bounds[1]] / 1e4
            for t_i, j in enumerate(idxs):
                summaries[j] = (mean[t_i], lo[t_i], hi[t_i])
        results = []
        for j, ev in enumerate(evs):
            r = conv_res[j]
            k = ev.num_iso
            fn = r["final_n"][0, :k]
            if cfg.algorithm != "reassign":
                # the final assignment pass from chain 0's end-of-chain
                # psi (miso.c:935-947)
                fn = ev.final_assignment_counts(r["final_psi"][0, :k])
            res_d = {
                "samples": r["samples"][:, :k], "loglik": r["loglik"],
                "percent_accept": 100.0 * r["accepted"]
                    / max(r["accepted"] + r["rejected"], 1),
                "final_n": fn, "iters": int(r["iters"]),
                "burn_in": int(r["burn_in"]),
            }
            if j in summaries:
                res_d["summary"] = summaries[j]
            results.append(res_d)
        if self.on_chunk is not None:
            self.on_chunk(tags, results)

    # ------------------------------------------------------- materialize
    def _materialize_loop(self):
        while True:
            with self._cond:
                while True:
                    if self._aborted:
                        return
                    p = next((q for q in self._in_flight
                              if self._passed(q)), None)
                    if p is not None:
                        break
                    if self._closing and not self._in_flight:
                        return
                    # look again at the ready events while chunks run;
                    # else sleep until a dispatch, finish or abort
                    self._cond.wait(READY_POLL_S if any(
                        "parts" in q for q in self._in_flight) else None)
            try:
                self._materialize_chunk(p)
            except BaseException as e:  # surfaced on the caller thread
                self._mat_err.append(e)
                return
            finally:
                with self._cond:
                    self._in_flight = [q for q in self._in_flight
                                       if q is not p]
                    self._cond.notify_all()

    def _materialize_chunk(self, p: dict) -> None:
        """pipeline.py:663-766 with device_get replaced by .cpu() copies;
        int32 ticks and centipoints become uint16 on the host.  A sharded
        chunk's parts are copied once their events have completed and
        joined in event order."""
        with self.tracer.span("materialize", chunk=p["chunk"]):
            self._materialize_parts(p)

    def _materialize_parts(self, p: dict) -> None:
        tr = self.tracer
        evs = p["evs"]
        parts = p["parts"]
        with tr.span("wait_card"):
            for part in parts:
                if part["ready"] is not None:
                    part["ready"].synchronize()

        def joined(name, index=None):
            got = [part[name] if index is None else part[name][index]
                   for part in parts]
            if got[0] is None:
                return None
            got = [_to_numpy(t) for t in got]
            return got[0] if len(got) == 1 else np.concatenate(got)

        with tr.span("materialize.copy"):
            accepted = joined("accepted")
            rejected = joined("rejected")
            final_n = joined("final_n")
            final_psi = joined("final_psi")
            q = joined("quant")
            summ = (None if parts[0]["summ"] is None
                    else [joined("summ", i) for i in range(3)])
            cmin, cmax, resid = ((None,) * 3 if q is None else (
                joined("ll_min"), joined("ll_max"), joined("ll_resid")))
        n_real = len(evs)
        S = parts[0]["n_samples"]
        q = None if q is None else q.astype(np.uint16)
        summary = None
        if summ is not None:
            ssum, lo_t, hi_t = summ
            ssum = ssum.astype(np.int64).sum(axis=1)
            lo_v = lo_t.astype(np.float64) / 1e4
            hi_v = hi_t.astype(np.float64) / 1e4
            # the mean from the host ticks when they are here (bitwise
            # what summarize_miso computes from the .miso text), else
            # from the exact device tick sums
            if q is not None:
                mean_v = (q.astype(np.float64) / 1e4).mean(axis=1)
            else:
                mean_v = ssum.astype(np.float64) / S / 1e4
            if p["two_iso"]:  # column-0 scalars -> (E, 1) vectors
                mean_v, lo_v, hi_v = (a.reshape(len(a), 1)
                                      for a in (mean_v, lo_v, hi_v))
            summary = (mean_v, lo_v, hi_v)
        ticks = cmin_i = None
        wide = set()
        if q is not None:
            resid = resid.astype(np.uint16)
            if p["two_iso"]:
                ticks = np.empty(q.shape + (2,), np.uint16)
                ticks[:, :, 0] = q
                ticks[:, :, 1] = 10000 - q
            else:
                ticks = q
            with np.errstate(invalid="ignore"):
                # padding events carry non-finite score rows; no real
                # event reads their cmin
                cmin_i = np.round(np.nan_to_num(cmin.astype(np.float64))
                                  ).astype(np.int64)
                wide = set(np.flatnonzero(
                    (cmax[:n_real].astype(np.float64) - cmin[:n_real])
                    > 65535).tolist())
        results = []
        for j, ev in enumerate(evs):
            k = ev.num_iso
            if final_n is not None:
                fn = final_n[j, 0, :k]  # chain 0
            else:
                # the final assignment pass of the collapsed algorithms
                # (miso.c:935-947, pipeline.py:738-741)
                fn = ev.final_assignment_counts(final_psi[j, 0, :k])
            res = _LazyResult({
                "percent_accept": 100.0 * accepted[j]
                    / max(accepted[j] + rejected[j], 1),
                "final_n": fn,
            })
            if summary is not None:
                res["summary"] = (summary[0][j], summary[1][j],
                                  summary[2][j])
            if ticks is not None:
                res["psi_ticks"] = ticks[j, :, :k]
                if j in wide:  # rare: full-precision row
                    res["loglik"] = _full_row(parts, int(j))
                else:
                    res["score_cents"] = (resid[j].astype(np.int64)
                                          + cmin_i[j])
            results.append(res)
        if self.on_chunk is not None:
            self.on_chunk(p["tags"], results)


def _in_span(span, fn, *args):
    """``fn(*args)`` inside ``span``, on the thread that runs it (a writer
    batch on the pool)."""
    with span:
        return fn(*args)


def run_events(events: List[CompiledEvent], cfg: RunConfig, seed: int = 0,
               device="cuda", on_chunk=None):
    """Run compiled events through the sampler, bucketed by shape, on
    ``device`` or the mesh it names (``resolve_mesh``).  Returns a list
    parallel to ``events`` of per-event result dicts.  Traced as one job
    when it starts under ``torch.profiler`` (``trace.job``)."""
    out: List[Optional[dict]] = [None] * len(events)

    def _on_chunk(tags, results):
        for i, res in zip(tags, results):
            out[i] = res
        if on_chunk is not None:
            on_chunk(tags, out)

    with trace.job() as tracer:
        runner = StreamRunner(cfg, seed=seed, device=device,
                              on_chunk=_on_chunk, tracer=tracer)
        for key, idxs in bucket_events(events):
            for i in idxs:
                runner.add(events[i], tag=i)
        runner.finish()
    return out


# the profiler annotation that puts the program's clock on the trace's
PROFILE_ANCHOR = "miso_trace_anchor"


def profile_run(fn, profile_dir: str, devices, verbose: bool = True):
    """Run ``fn()`` under ``torch.profiler`` -- host calls, and the cards'
    kernels and copies when one of ``devices`` is CUDA -- and write the
    Chrome trace into ``profile_dir``, with the program's own spans and
    counters of the jobs ``fn`` runs (``trace``: traced, as they start
    under the profiler) as a process of their own on the trace's clock.
    Under ``verbose`` prints one line per bucket shape.  Returns what
    ``fn`` returns."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    os.makedirs(profile_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        anchor = time.perf_counter_ns()
        with record_function(PROFILE_ANCHOR):
            pass
        out = fn()
        for d in cuda:
            torch.cuda.synchronize(d)
        recs = trace.records(anchor, time.perf_counter_ns())
    path = os.path.join(profile_dir, "miso_torch_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    ts = [e["ts"] for e in doc["traceEvents"]
          if e.get("name") == PROFILE_ANCHOR and e.get("ph") == "X"]
    if not ts:
        raise RuntimeError("the profiler kept no %s" % PROFILE_ANCHOR)
    doc["traceEvents"] += trace.chrome_events(
        recs, lambda t: ts[0] + (t - anchor) / 1e3)
    with open(path, "w") as f:
        json.dump(doc, f)
    if verbose:
        print("torch.profiler trace written to %s" % path)
        for shape, row in sorted(trace.bucket_table(recs).items()):
            print("  bucket (iso=%d, classes=%d, reads=%d): %d chunks, "
                  "%d events in %d lanes, %.2fs in flight, %.2fs run"
                  % (shape + (row["chunks"], row["events"], row["lanes"],
                              row["flight_s"], row["run_s"])))
    return out


def compute_all_genes_psi(
    index_dir: str,
    alignments_path: str,
    read_len: int,
    output_dir: str,
    cfg: Optional[RunConfig] = None,
    settings: Optional[Settings] = None,
    gene_ids: Optional[List[str]] = None,
    seed: int = 0,
    verbose: bool = True,
    device="cuda",
    profile_dir: Optional[str] = None,
) -> int:
    """The ``miso --run`` engine on ``device``, or on every visible card
    for ``"cuda"`` where there are more than one, or on the mesh a list of
    devices names (``resolve_mesh``).  Returns the number of events
    written.  A copy of pipeline.py:1304-1567.  ``profile_dir`` runs the
    call under ``torch.profiler`` and writes a Chrome trace there, with
    the program's layers beside the torch ops and kernels
    (``profile_run``; pipeline.py:1492-1497 profiles with
    ``jax.profiler``).  The call is one traced job when it starts under a
    profiler (``trace.job``)."""
    if profile_dir:
        return profile_run(
            functools.partial(compute_all_genes_psi, index_dir,
                              alignments_path, read_len, output_dir, cfg=cfg,
                              settings=settings, gene_ids=gene_ids,
                              seed=seed, verbose=verbose, device=device),
            profile_dir, resolve_mesh(device) or (resolve_device(device),),
            verbose)
    with trace.job() as tracer:
        return _compute_all_genes_psi(
            tracer, index_dir, alignments_path, read_len, output_dir, cfg,
            settings, gene_ids, seed, verbose, device)


def _compute_all_genes_psi(tracer: trace.Tracer, index_dir, alignments_path,
                           read_len, output_dir, cfg, settings, gene_ids,
                           seed, verbose, device) -> int:
    from miso_tpu_torch.io.sanity import check_gff_and_bam, setup_logger

    settings = settings or Settings.get()
    cfg = cfg or RunConfig.from_settings(settings, read_len)
    if cfg.summary_only and cfg.pack_output:
        raise ValueError(
            "--pack-output and --summary-only conflict: summary-only "
            "runs store no posterior samples to pack")
    if cfg.summary_only:
        n_s = ((cfg.iters - cfg.burn_in) // cfg.lag) * cfg.chains
        if _ci_bound_indices(n_s) is None:
            raise ValueError(
                "--summary-only needs enough retained samples for the "
                "95%% credible interval (got %d; need ~40+)" % n_s)
    setup_logger(output_dir)
    check_gff_and_bam(index_dir, alignments_path,
                      given_read_len=cfg.filter_read_len)

    t0 = time.time()
    id_to_fname = get_gene_ids_to_filenames(index_dir)
    if gene_ids is not None:
        id_to_fname = {g: id_to_fname[g] for g in gene_ids if g in id_to_fname}
    alignments = sam_io.open_alignments(alignments_path)

    # group by per-chromosome pickle directory so the whole-chromosome
    # scan cache stays small, then by gene id for determinism
    items = sorted(id_to_fname.items(), key=lambda kv: (kv[1], kv[0]))
    if items and getattr(alignments, "references", None):
        # build the region index once before fanning out threads
        list(alignments.fetch(alignments.references[0], 0, 0))

    from concurrent.futures import ThreadPoolExecutor

    write_pool = ThreadPoolExecutor(
        max_workers=max(2, min(4, os.cpu_count() or 4)))
    write_futures = []
    write_lock = threading.Lock()

    progress = {"done": 0, "t_last": t0}
    from miso_tpu_torch.io.miso_file import summary_row_fields
    summary_rows: Dict[str, str] = {}
    packer = None
    if cfg.pack_output and not cfg.summary_only:
        from miso_tpu_torch.io.miso_db import DirectPacker
        packer = DirectPacker(output_dir)

    def on_chunk(evs, results):
        chunk = tracer.chunk()
        rows_local = {}
        for ev, res in zip(evs, results):
            if res is None:
                continue
            fields = summary_row_fields(ev, res)
            if fields is not None:
                rows_local[ev.name] = "\t".join(fields)
        with write_lock:
            if packer is not None:
                for lo in range(0, len(evs), 512):
                    write_futures.append(write_pool.submit(
                        _in_span, tracer.span(
                            "write", chunk=chunk,
                            submitted=time.perf_counter_ns()),
                        _pack_events_batch, packer, cfg,
                        evs[lo:lo + 512], results[lo:lo + 512]))
            elif not cfg.summary_only:
                for lo in range(0, len(evs), 512):
                    write_futures.append(write_pool.submit(
                        _in_span, tracer.span(
                            "write", chunk=chunk,
                            submitted=time.perf_counter_ns()),
                        _write_events_batch, output_dir, cfg,
                        evs[lo:lo + 512], results[lo:lo + 512]))
            summary_rows.update(rows_local)
            progress["done"] += len(evs)
            now = time.time()
            if verbose and now - progress["t_last"] > 15:
                progress["t_last"] = now
                print("  ... %d/%d events through the device (%.0f "
                      "events/s)" % (progress["done"], len(items),
                                     progress["done"] / (now - t0)))

    runner = StreamRunner(cfg, seed=seed, device=device, on_chunk=on_chunk,
                          tracer=tracer)
    if verbose and len(runner.mesh) > 1:
        print("Event catalog sharded over %d local devices"
              % len(runner.mesh))

    ev_queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=8192)
    compile_done = {}

    from miso_tpu_torch import native as _native
    workers = 1
    if (not hasattr(alignments, "scan_chrom_columnar")
            or _native.load() is None):
        workers = settings.get_num_processors() or 1
    stream = _CompileStream(items, alignments, cfg, output_dir, verbose,
                            emit=ev_queue.put, workers=workers,
                            done=packer.done_names if packer else None,
                            tracer=tracer)

    def produce():
        t = time.time()
        try:
            with tracer.span("compile"):
                stream.run()
            compile_done["seconds"] = time.time() - t
        except BaseException as e:
            compile_done["error"] = e
        finally:
            ev_queue.put(None)

    producer = threading.Thread(target=produce, daemon=True)

    def consume():
        producer.start()
        try:
            while True:
                ev = ev_queue.get()
                if ev is None:
                    break
                runner.add(ev)
        except BaseException:
            # stop the producer at its next gene, drain the queue until
            # it exits, then stop the materializer
            stream.stop = True
            while producer.is_alive():
                try:
                    while True:
                        ev_queue.get_nowait()
                except queue_mod.Empty:
                    pass
                producer.join(timeout=0.2)
            runner.abort()
            raise
        producer.join()
        if "error" in compile_done:
            runner.abort()
            raise compile_done["error"]
        runner.finish()

    try:
        consume()
        written = 0
        for f in write_futures:
            written += f.result()
    finally:
        write_pool.shutdown()
    if packer is not None:
        packer.finish()
    if summary_rows or stream.resume_skipped:
        from miso_tpu_torch.io.miso_file import write_summary_file
        label = os.path.basename(os.path.normpath(output_dir))
        ran = len(summary_rows)   # rows of events this run sampled
        if distributed.process_count() > 1:
            # multi-host runs share output_dir: per-host summary files
            # (concurrent read-merge-writes of one file would race and
            # drop rows; concatenate or summarize_miso to merge)
            label = "%s.host%d" % (label, distributed.process_index())
        summary_filename = os.path.join(output_dir, "summary",
                                        "%s.miso_summary" % label)
        if stream.resume_skipped:
            # resumed runs: backfill the skipped events' rows from their
            # stored samples so the summary is never silently partial --
            # under --summary-only too, where the skipped events' .miso
            # files of an earlier full run are the only source of their
            # rows (the JAX package leaves those rows out)
            from miso_tpu_torch.io.miso_file import (MISOSamples,
                                               summary_row_from_data)
            have = set(summary_rows)
            if os.path.isfile(summary_filename):
                with open(summary_filename) as f:
                    f.readline()
                    have.update(line.split("\t", 1)[0]
                                for line in f if line.strip())
            obj = MISOSamples(output_dir)
            for nm in stream.resume_skipped_names:
                if nm in have or nm not in obj.event_names_to_fnames:
                    continue
                data = obj.get_event_samples(nm)
                if data is None:
                    continue
                try:
                    summary_rows[nm] = "\t".join(
                        summary_row_from_data(nm, data))
                except ValueError:
                    print("WARNING: cannot summarize resumed event %s "
                          "(too few samples)" % nm)
        with tracer.span("summary"):
            n_summ = write_summary_file(summary_filename, summary_rows)
        if verbose:
            print("Posterior summary (%d events, device-side): %s"
                  % (n_summ, summary_filename))
        if cfg.summary_only:
            written = ran
    if verbose:
        dt = time.time() - t0
        print("Quantified %d events (%d skipped) in %.2fs on %s "
              "(host compile %.2fs, overlapped); %.1f events/s "
              "(%.1f events/s/chip)"
              % (written, stream.skipped, dt,
                 ",".join(str(d) for d in runner.mesh),
                 compile_done.get("seconds", float("nan")),
                 written / max(dt, 1e-9),
                 written / max(dt, 1e-9) / len(runner.mesh)))
    return written
