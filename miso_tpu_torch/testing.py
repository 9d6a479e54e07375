"""Seeded inputs for the port's checks (``chip_smoke.py``): simulated
single-end and paired-end events, padded batches on a device, indexed
simulated catalogs (the catalog helpers of ``miso_tpu/testing.py``,
copied; tests/test_torch_host_copy.py holds the two together), the
read-back of packed output, and the grid-exact posterior of the
collapsed model."""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from miso_tpu_torch.cli.index_gff import main as index_gff_main
from miso_tpu_torch.core.events import (compile_paired_end,
                                        compile_single_end, pad_events)
from miso_tpu_torch.core.gene import Exon, Gene, Isoform, make_gene
from miso_tpu_torch.core.simulate import (simulate_paired_reads,
                                          simulate_reads)
from miso_tpu_torch.io.gff import GFFRecord, write_gff
from miso_tpu_torch.io.sam import AlignedRead, write_bam
from miso_tpu_torch.sampler.mcmc import EventBatch, batch_from_numpy

# torch's intra-op threads in a test process.  The tests run in several
# worker processes at once, and in each the OpenMP pool would spread every
# small op of the plain versions over every core: six workers on eight
# cores took one whole-CLI test from 6 s alone to 600 s.
TEST_THREADS = 1


def cap_test_threads() -> Dict[str, str]:
    """Cap torch's intra-op threads in this process at ``TEST_THREADS``.
    Returns the environment entries that cap a child interpreter alike:
    ``dict(os.environ, **cap_test_threads())``."""
    import torch

    torch.set_num_threads(TEST_THREADS)
    return {"OMP_NUM_THREADS": str(TEST_THREADS)}


def make_se_catalog(
    num_events: int,
    rng: np.random.Generator,
    chroms: int = 4,
    exon_lens=(100, 50, 100),
) -> Tuple[List[Gene], List[GFFRecord], np.ndarray]:
    """num_events SE genes spaced along `chroms` chromosomes.
    Returns (genes, gff_records, true_psi (num_events,))."""
    genes: List[Gene] = []
    records: List[GFFRecord] = []
    true_psi = rng.uniform(0.05, 0.95, size=num_events)
    spacing = sum(exon_lens) + 1000
    for e in range(num_events):
        chrom = "chr%d" % (1 + e % chroms)
        offset = 1 + (e // chroms) * spacing
        starts = np.cumsum([offset] + list(exon_lens[:-1])).tolist()
        parts = [Exon(int(s), int(s + l - 1), label="%s.p%d" % ("ev%d" % e, i))
                 for i, (s, l) in enumerate(zip(starts, exon_lens))]
        gene = Gene(
            parts=parts,
            isoforms=[Isoform((0, 1, 2), label="ev%d.A" % e,
                              desc=["up", "se", "dn"]),
                      Isoform((0, 2), label="ev%d.B" % e,
                              desc=["up", "dn"])],
            label="ev%d" % e, chrom=chrom, strand="+")
        genes.append(gene)
        gid = gene.label
        lo, hi = gene.genomic_span()
        records.append(GFFRecord(chrom, "sim", "gene", lo, hi, None, "+",
                                 None, {"ID": [gid]}))
        for iso in gene.isoforms:
            records.append(GFFRecord(chrom, "sim", "mRNA", lo, hi, None,
                                     "+", None,
                                     {"ID": [iso.label], "Parent": [gid]}))
            for pi in iso.parts:
                p = gene.parts[pi]
                records.append(GFFRecord(
                    chrom, "sim", "exon", p.start, p.end, None, "+", None,
                    {"ID": ["%s.%s" % (iso.label, p.label)],
                     "Parent": [iso.label]}))
    return genes, records, true_psi


def simulate_catalog_bam(
    genes: List[Gene],
    true_psi: np.ndarray,
    reads_per_event: int,
    read_len: int,
    bam_path: str,
    rng: np.random.Generator,
) -> None:
    """Simulate reads for every gene and write one coordinate-sorted BAM."""
    reads: List[AlignedRead] = []
    for e, gene in enumerate(genes):
        psi = [float(true_psi[e]), 1.0 - float(true_psi[e])]
        _, pos, cig = simulate_reads(gene, psi, reads_per_event, read_len,
                                     rng)
        for r in range(len(pos)):
            reads.append(AlignedRead(
                qname="sim_%d_%d" % (e, r), flag=0, rname=gene.chrom,
                pos=int(pos[r]) - 1, mapq=255, cigar_str=cig[r],
                rlen=read_len))
    chroms = sorted({g.chrom for g in genes})
    order = {c: i for i, c in enumerate(chroms)}
    reads.sort(key=lambda r: (order[r.rname], r.pos))
    lengths = [max(g.genomic_span()[1] for g in genes if g.chrom == c)
               + 1000 for c in chroms]
    write_bam(bam_path, chroms, lengths, reads)


def simulate_catalog_bam_paired(
    genes: List[Gene],
    true_psi: np.ndarray,
    pairs_per_event: int,
    read_len: int,
    mean_frag_len: float,
    sd_frag_len: float,
    bam_path: str,
    rng: np.random.Generator,
) -> None:
    """Simulate proper mate pairs for every gene (FR orientation flags,
    as the pairing QC requires, misopy/sam_utils.py:210-289) and write
    one coordinate-sorted BAM."""
    reads: List[AlignedRead] = []
    for e, gene in enumerate(genes):
        psi = [float(true_psi[e]), 1.0 - float(true_psi[e])]
        _, pos, cig = simulate_paired_reads(
            gene, psi, pairs_per_event, read_len, mean_frag_len,
            sd_frag_len ** 2, rng=rng)
        for r in range(len(pos)):
            flag = 0x1 | 0x2 | (0x40 | 0x20 if r % 2 == 0
                                else 0x80 | 0x10)
            reads.append(AlignedRead(
                qname="sim_%d_%d" % (e, r // 2), flag=flag,
                rname=gene.chrom, pos=int(pos[r]) - 1, mapq=255,
                cigar_str=cig[r], rlen=read_len))
    chroms = sorted({g.chrom for g in genes})
    order = {c: i for i, c in enumerate(chroms)}
    reads.sort(key=lambda r: (order[r.rname], r.pos))
    lengths = [max(g.genomic_span()[1] for g in genes if g.chrom == c)
               + 1000 for c in chroms]
    write_bam(bam_path, chroms, lengths, reads)


def build_paired_catalog_fixture(
    out_dir: str,
    num_events: int = 2000,
    pairs_per_event: int = 150,
    read_len: int = 40,
    mean_frag_len: float = 250.0,
    sd_frag_len: float = 15.0,
    seed: int = 0,
) -> Dict[str, object]:
    """Paired-end GFF + BAM + truth table (exons sized so the fragment
    distribution fits both isoforms)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    genes, records, true_psi = make_se_catalog(
        num_events, rng, exon_lens=(300, 100, 300))
    gff_path = os.path.join(out_dir, "catalog.gff")
    write_gff(records, gff_path)
    bam_path = os.path.join(out_dir, "catalog.bam")
    simulate_catalog_bam_paired(genes, true_psi, pairs_per_event,
                                read_len, mean_frag_len, sd_frag_len,
                                bam_path, rng)
    return {"gff": gff_path, "bam": bam_path, "true_psi": true_psi,
            "genes": genes, "read_len": read_len,
            "mean_frag_len": mean_frag_len, "sd_frag_len": sd_frag_len}


def build_catalog_fixture(
    out_dir: str,
    num_events: int = 50,
    reads_per_event: int = 300,
    read_len: int = 36,
    seed: int = 0,
) -> Dict[str, object]:
    """GFF + BAM + truth table under out_dir; returns paths + truth."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    genes, records, true_psi = make_se_catalog(num_events, rng)
    gff_path = os.path.join(out_dir, "catalog.gff")
    write_gff(records, gff_path)
    bam_path = os.path.join(out_dir, "catalog.bam")
    simulate_catalog_bam(genes, true_psi, reads_per_event, read_len,
                         bam_path, rng)
    return {"gff": gff_path, "bam": bam_path, "true_psi": true_psi,
            "genes": genes, "read_len": read_len}


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


def wide_event(algorithm="reassign", num_iso=300, n_reads=400, seed=3):
    """One wide event: a gene of ``num_iso`` isoforms, the first of the
    2^m subsets of m middle exons that keep the first and last exon (m =
    9, 11 exons, up to 512 isoforms; more middle exons for more: 1,100
    isoforms take 11, 13 exons), ``n_reads`` simulated reads at a seeded
    Dirichlet psi.  300 isoforms pad to a bucket of 512, 1,100 to one of
    2,048."""
    middle = max(9, (num_iso - 1).bit_length())
    subsets = [[1] + [2 + b for b in range(middle) if m >> b & 1]
               + [middle + 2] for m in range(num_iso)]
    psi = np.random.default_rng(seed).dirichlet(np.ones(num_iso))
    return simulated_event([60] * (middle + 2), subsets, psi, n_reads, 25,
                           seed=seed, algorithm=algorithm)


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


def lane_test_batch(I, num_iso, seed, device, E=2, R=16):
    """The inputs of tests/test_pallas_interpret.py, widened to any I (and
    to any E and R): E=2 events of ``num_iso`` real isoforms padded to I,
    R=16 reads with read 0 compatible with every real isoform and 3
    all-zero padding reads."""
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


# read counts of ``wide_class_batch``'s classes: in event 0 a class of
# no reads and one (class 2) of zero weights whose five reads straddle
# two groups of four; 15 and 14 reads in 20 read slots, the rest padding
WIDE_CLASS_COUNTS = ((3, 0, 5, 2, 1, 4, 0), (1, 1, 1, 6, 0, 2, 3))
WIDE_CLASS_SLOTS = 20


def wide_class_batch(I, num_iso, seed, device, counts=WIDE_CLASS_COUNTS):
    """A REASSIGN batch of class tensors alone (``read_w`` and
    ``read_logscore`` (E, 1, I) placeholders), for B1w's class form: E
    = len(counts) events of ``num_iso`` real isoforms padded to I, C =
    len(counts[0]) classes of random weights (class 0 compatible with
    every real isoform, class 2 with none) and non-zero read scores,
    ``counts`` reads a class; run it as ``WIDE_CLASS_SLOTS`` read slots
    (or more)."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.float32)
    E, C = counts.shape
    real = np.arange(I) < num_iso
    weights = ((rng.random((E, C, I)) < 0.7) & real).astype(np.float32)
    weights[:, 0, :] = real
    weights[:, 2, :] = 0.0
    log_read = np.where(weights > 0, np.log(0.01 + rng.random((E, C, I))),
                        0.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        log_iso_w = np.where(real, np.log(np.linspace(200.0, 80.0, I)),
                             -np.inf)
    batch, _ = batch_from_numpy(EventBatch(
        weights=weights, log_read=log_read, counts=counts,
        log_iso_w=np.tile(log_iso_w, (E, 1)), hyper=np.ones((E, I)),
        num_iso=np.full((E,), num_iso), read_w=np.zeros((E, 1, I)),
        read_logscore=np.zeros((E, 1, I))), device)
    return batch


def marginal_lane_batch(I, num_iso, seed, device, C=4):
    """The MARGINAL inputs of tests/test_pallas_interpret.py, widened to
    any I (and any class count C): E=2 events of ``num_iso`` real
    isoforms padded to I, C=4 classes of random weights with the last
    class empty and counts (30, 20, 10, 0) (repeated for a wider C),
    then one padding event (num_iso = 0) as ``_pow2_pad_events`` adds
    them."""
    E = 3
    rng = np.random.default_rng(seed)
    weights = np.zeros((E, C, I), np.float32)
    weights[:2, :, :num_iso] = rng.random((2, C, num_iso))
    weights[:, -1, :] = 0.0
    counts = np.zeros((E, C), np.float32)
    counts[:2] = np.resize([30.0, 20.0, 10.0, 0.0], C)
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

    from miso_tpu_torch.io.miso_db import MISODatabase

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


def multinomial_lane_batch(I, num_iso, seed, device, C=4, scale=1.0):
    """``marginal_lane_batch`` for the deep route: the same E=3 events
    (the last a padding event), class counts times ``scale``, and
    non-zero read scores log(0.01 + U) where a class weighs on an
    isoform."""
    batch = marginal_lane_batch(I, num_iso, seed, "cpu", C=C)
    rng = np.random.default_rng(seed)
    w = batch.weights.numpy()
    log_read = np.where(w > 0, np.log(0.01 + rng.random(w.shape)), 0.0)
    return batch_from_numpy(EventBatch(
        *[t.numpy() for t in batch._replace(
            log_read=batch.log_read.new_tensor(log_read),
            counts=batch.counts * scale)]), device)[0]


# (reads of the class, weight of isoform 1 beside isoform 0's 1) of the
# binomial check's events: p0 = psi0 / (psi0 + w psi1), so n * p0 below
# and above 10, and p0 below and above 1/2 (the symmetric draw)
BINOMIAL_REGIMES = ((200.0, 50.0), (1e6, 1.0), (200.0, 0.02),
                    (50000.0, 0.3))


def binomial_batch(copies, device):
    """The events of the binomial draws' check: each regime of
    ``BINOMIAL_REGIMES`` ``copies`` times, two isoforms and one class of
    the regime's reads, whose draw n0 ~ Bin(reads, p0) is final_n's
    first isoform after a run of no iterations."""
    E = len(BINOMIAL_REGIMES) * copies
    reads = np.repeat([r for r, _ in BINOMIAL_REGIMES], copies)
    w1 = np.repeat([w for _, w in BINOMIAL_REGIMES], copies)
    weights = np.stack([np.ones(E), w1], -1)[:, None, :]
    batch, _ = batch_from_numpy(EventBatch(
        weights=weights, log_read=np.zeros_like(weights),
        counts=reads[:, None], log_iso_w=np.zeros((E, 2)),
        hyper=np.ones((E, 2)), num_iso=np.full(E, 2),
        read_w=np.zeros((E, 1, 2)), read_logscore=np.zeros((E, 1, 2))),
        device)
    return batch


def binomial_moments(batch, result):
    """Per regime of ``binomial_batch``: (mean, variance, lanes) of the
    standardised draws z = (n0 - n p0) / sqrt(n p0 (1 - p0)), p0 from
    each lane's final psi, in float64; and whether every lane's counts
    sum to its reads."""
    res = result.to_numpy()
    reads = batch.counts.cpu().numpy()[:, 0].astype(np.float64)
    w1 = batch.weights.cpu().numpy()[:, 0, 1].astype(np.float64)
    psi = res.final_psi.astype(np.float64)
    p0 = psi[..., 0] / (psi[..., 0] + w1[:, None] * psi[..., 1])
    n = reads[:, None]
    z = (res.final_n[..., 0] - n * p0) / np.sqrt(n * p0 * (1.0 - p0))
    copies = len(reads) // len(BINOMIAL_REGIMES)
    out = []
    for r in range(len(BINOMIAL_REGIMES)):
        zr = z[r * copies:(r + 1) * copies].ravel()
        out.append((float(zr.mean()), float(zr.var()), zr.size))
    sums = np.all(res.final_n.sum(-1) == n)
    return out, bool(sums)


def binomial_chi2(batch, result, bins, seed=0):
    """Per regime of ``binomial_batch``: (chi2, p-value, draws) of the
    draws n0 against the exact Bin(n, p0) pmf, p0 from each lane's final
    psi.  Each draw k becomes its randomised probability integral
    transform u = F(k - 1) + V (F(k) - F(k - 1)), V uniform from
    ``seed``, which the exact pmf makes uniform on [0, 1) whatever n
    and p0; the draws' counts in ``bins`` equal bins of u then follow a
    chi2 of bins - 1 degrees of freedom."""
    from scipy.stats import binom, chi2

    res = result.to_numpy()
    reads = batch.counts.cpu().numpy()[:, 0].astype(np.float64)
    w1 = batch.weights.cpu().numpy()[:, 0, 1].astype(np.float64)
    psi = res.final_psi.astype(np.float64)
    p0 = psi[..., 0] / (psi[..., 0] + w1[:, None] * psi[..., 1])
    n = np.broadcast_to(reads[:, None], p0.shape)
    k = res.final_n[..., 0].astype(np.float64)
    lo = binom.cdf(k - 1.0, n, p0)
    u = lo + np.random.default_rng(seed).random(k.shape) * (
        binom.cdf(k, n, p0) - lo)
    copies = len(reads) // len(BINOMIAL_REGIMES)
    out = []
    for r in range(len(BINOMIAL_REGIMES)):
        ur = u[r * copies:(r + 1) * copies].ravel()
        counts = np.bincount(np.minimum((ur * bins).astype(int), bins - 1),
                             minlength=bins)
        expected = ur.size / bins
        stat = float(((counts - expected) ** 2 / expected).sum())
        out.append((stat, float(chi2.sf(stat, bins - 1)), ur.size))
    return out
