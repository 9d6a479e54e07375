"""Seeded inputs for the port's checks (``chip_smoke.py``): simulated
single-end and paired-end events, padded batches on a device, indexed
simulated catalogs, built with the JAX package's JAX-free host code, the
read-back of packed output, and the grid-exact posterior of the
collapsed model."""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from miso_tpu.cli.index_gff import main as index_gff_main
from miso_tpu.core.events import (compile_paired_end, compile_single_end,
                                  pad_events)
from miso_tpu.core.gene import make_gene
from miso_tpu.core.simulate import simulate_paired_reads, simulate_reads
from miso_tpu.testing import (build_catalog_fixture,
                              build_paired_catalog_fixture)
from miso_tpu_torch.sampler.mcmc import EventBatch, batch_from_numpy


def simulated_event(exon_lens, isoforms, psi, n_reads, read_len, seed,
                    algorithm="reassign"):
    """One single-end event: reads simulated at ``psi`` on a gene of
    ``exon_lens`` with ``isoforms`` (1-based exon lists), compiled for
    ``algorithm``."""
    gene = make_gene(list(exon_lens), [list(i) for i in isoforms])
    _, pos, cig = simulate_reads(gene, list(psi), n_reads, read_len,
                                 np.random.default_rng(seed))
    return compile_single_end(gene, pos, cig, read_len=read_len,
                              algorithm=algorithm)


# the paired-end gene of tests/test_pallas.py and tests/test_sampler.py
PAIRED_GENE = ([600, 100, 600], [[1, 2, 3], [1, 3]])


def paired_event(exon_lens, isoforms, psi, n_pairs, read_len,
                 mean_frag_len, frag_sd, seed):
    """One paired-end event: ``n_pairs`` mate pairs simulated at ``psi``
    with fragment lengths of mean ``mean_frag_len`` and standard
    deviation ``frag_sd``, compiled for any algorithm (the class
    weights are fragment-length probabilities)."""
    gene = make_gene(list(exon_lens), [list(i) for i in isoforms])
    _, pos, cig = simulate_paired_reads(
        gene, list(psi), n_pairs, read_len, mean_frag_len, frag_sd ** 2,
        rng=np.random.default_rng(seed))
    return compile_paired_end(gene, pos, cig, read_len=read_len,
                              mean_frag_len=mean_frag_len,
                              frag_variance=frag_sd ** 2)


def padded_batch(events, device, pad_reads=None):
    """``pad_events`` (f32 per-read tiles) -> the port's EventBatch."""
    batch, _ = batch_from_numpy(
        pad_events(events, pad_reads=pad_reads, read_dtype=np.float32),
        device)
    return batch


def deepened(ev, scale):
    """``ev`` with every class count times ``scale``: a deeper library of
    the same read-class profile (reads of a class are exchangeable), as
    tests/test_deep_events.py builds its million-read event."""
    return dataclasses.replace(ev, counts=ev.counts * scale,
                               num_reads=ev.num_reads * scale)


def class_batch(events, device):
    """``pad_events`` without per-read tiles (the (E, 1, I) placeholders
    of a deep REASSIGN bucket) -> the port's EventBatch."""
    batch, _ = batch_from_numpy(
        pad_events(events, per_read=False, read_dtype=np.float32), device)
    return batch


def indexed_catalog(out_dir, num_events, reads_per_event, read_len, seed,
                    paired=False):
    """``build_catalog_fixture`` (GFF + BAM + truth) plus its
    ``index_gff`` index under ``out_dir/index``.  ``paired`` builds
    ``build_paired_catalog_fixture``'s catalog instead: mate pairs
    (``reads_per_event`` of them) with fragments of 250 +- 15 nt."""
    if paired:
        fix = build_paired_catalog_fixture(
            out_dir, num_events=num_events, pairs_per_event=reads_per_event,
            read_len=read_len, seed=seed)
    else:
        fix = build_catalog_fixture(out_dir, num_events=num_events,
                                    reads_per_event=reads_per_event,
                                    read_len=read_len, seed=seed)
    fix["index"] = os.path.join(out_dir, "index")
    if index_gff_main(["--index", fix["gff"], fix["index"]]) != 0:
        raise RuntimeError("index_gff failed on %s" % fix["gff"])
    return fix


def lane_test_batch(I, num_iso, seed, device):
    """The inputs of tests/test_pallas_interpret.py, widened to any I: E=2
    events of ``num_iso`` real isoforms padded to I, R=16 reads with read
    0 compatible with every real isoform and 3 all-zero padding reads."""
    R, E = 16, 2
    rng = np.random.default_rng(seed)
    real = np.arange(I) < num_iso
    read_w = ((rng.random((E, R, I)) < 0.7) & real).astype(np.float32)
    read_w[:, -3:, :] = 0.0
    read_w[:, 0, :] = real
    rls = np.where(read_w > 0, np.log(0.01 + rng.random((E, R, I))),
                   0.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        log_iso_w = np.where(real, np.log(np.linspace(200.0, 80.0, I)),
                             -np.inf)
    batch, _ = batch_from_numpy(EventBatch(
        weights=np.zeros((E, 4, I)), log_read=np.zeros((E, 4, I)),
        counts=np.zeros((E, 4)), log_iso_w=np.tile(log_iso_w, (E, 1)),
        hyper=np.ones((E, I)), num_iso=np.full((E,), num_iso),
        read_w=read_w, read_logscore=rls), device)
    return batch


def marginal_lane_batch(I, num_iso, seed, device):
    """The MARGINAL inputs of tests/test_pallas_interpret.py, widened to
    any I: E=2 events of ``num_iso`` real isoforms padded to I, C=4
    classes of random weights with the last class empty and counts
    (30, 20, 10, 0), then one padding event (num_iso = 0) as
    ``_pow2_pad_events`` adds them."""
    E, C = 3, 4
    rng = np.random.default_rng(seed)
    weights = np.zeros((E, C, I), np.float32)
    weights[:2, :, :num_iso] = rng.random((2, C, num_iso))
    weights[:, -1, :] = 0.0
    counts = np.zeros((E, C), np.float32)
    counts[:2] = [30.0, 20.0, 10.0, 0.0]
    num_iso_v = np.array([num_iso, num_iso, 0], np.int32)
    batch, _ = batch_from_numpy(EventBatch(
        weights=weights, log_read=np.zeros((E, C, I)), counts=counts,
        log_iso_w=np.zeros((E, I)), hyper=np.ones((E, I)),
        num_iso=num_iso_v, read_w=np.zeros((E, 1, I)),
        read_logscore=np.zeros((E, 1, I))), device)
    return batch


def packed_events(out_dir):
    """{event name: (header block, sample lines)} of every ``.miso_db``
    under ``out_dir`` (``--pack-output``), read back through
    ``MISODatabase``."""
    import glob

    from miso_tpu.io.miso_db import MISODatabase

    found = {}
    for path in glob.glob(os.path.join(out_dir, "*.miso_db")):
        db = MISODatabase(path)
        for name in db.get_all_event_names():
            body, header = db.get_event_raw(name)
            found[name] = (header, body)
    return found


def exact_marginal_mean_2iso(ev, grid=20001):
    """Grid-exact posterior mean of psi_1 for a two-isoform event
    compiled for MARGINAL or CLASSES: under the uniform Dirichlet prior
    p(psi) is proportional to prod_c (sum_i W_ci psi_i)^counts_c
    (tests/test_sampler.py:132-140)."""
    p = np.linspace(1e-6, 1 - 1e-6, grid)
    s = np.stack([p, 1 - p], axis=1) @ np.asarray(ev.weights, np.float64).T
    ll = np.where(ev.counts[None, :] > 0,
                  np.log(np.maximum(s, 1e-300)) * ev.counts[None, :],
                  0.0).sum(axis=1)
    w = np.exp(ll - ll.max())
    return float((w * p).sum() / w.sum())
