"""Seeded inputs for the port's checks (``chip_smoke.py``): simulated
events, padded batches on a device, and an indexed simulated catalog,
built with the JAX package's JAX-free host code."""
from __future__ import annotations

import os

import numpy as np

from miso_tpu.cli.index_gff import main as index_gff_main
from miso_tpu.core.events import compile_single_end, pad_events
from miso_tpu.core.gene import make_gene
from miso_tpu.core.simulate import simulate_reads
from miso_tpu.testing import build_catalog_fixture
from miso_tpu_torch.sampler.mcmc import EventBatch, batch_from_numpy


def simulated_event(exon_lens, isoforms, psi, n_reads, read_len, seed):
    """One single-end event: reads simulated at ``psi`` on a gene of
    ``exon_lens`` with ``isoforms`` (1-based exon lists), compiled."""
    gene = make_gene(list(exon_lens), [list(i) for i in isoforms])
    _, pos, cig = simulate_reads(gene, list(psi), n_reads, read_len,
                                 np.random.default_rng(seed))
    return compile_single_end(gene, pos, cig, read_len=read_len)


def padded_batch(events, device, pad_reads=None):
    """``pad_events`` (f32 per-read tiles) -> the port's EventBatch."""
    batch, _ = batch_from_numpy(
        pad_events(events, pad_reads=pad_reads, read_dtype=np.float32),
        device)
    return batch


def indexed_catalog(out_dir, num_events, reads_per_event, read_len, seed):
    """``build_catalog_fixture`` (GFF + BAM + truth) plus its
    ``index_gff`` index under ``out_dir/index``."""
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
