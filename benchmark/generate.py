"""Seeded samples: gene models, their GFF, and a coordinate-sorted BAM of
simulated reads, made in bulk with numpy.

One general generator reads a configuration (the gene models, the read
layout, the sampler) and a traffic mix (the reads per event).  The
genes' shapes and read counts are drawn at fixed quantiles of their
distributions from a stream that is the same for every seed; the seed
orders the genes along the genome and draws their strands, isoform
fractions and reads.  So two seeds give the program the same work in
another order.

Nothing here imports the program: the reference reads the same arrays.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import math
import os
import struct
import zlib
from typing import List, Optional

import numpy as np

CHROMS = ["chr%d" % i for i in range(1, 23)] + ["chrX"]
GAP_NT = 5000              # intergenic distance between genes
BGZF_BLOCK = 65280         # uncompressed bytes per BGZF block
MAX_BLOCKS = 4             # aligned blocks a read may have (cigar ops <= 7)
CIGAR_M, CIGAR_N = 0, 3    # BAM cigar op codes
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def rng_for(seed: int, *words: int) -> np.random.Generator:
    """A generator keyed by a seed of any size or sign and a stream tag."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64)] + list(words)))


def quantiles(n: int) -> np.ndarray:
    """n mid-point probabilities (i + 0.5) / n."""
    return (np.arange(n) + 0.5) / n


def _ndtri(p: np.ndarray) -> np.ndarray:
    from scipy.special import ndtri
    return ndtri(p)


def lognormal_sizes(n: int, spec: dict, rng: np.random.Generator
                    ) -> np.ndarray:
    """n integers at the quantiles of a log-normal (median, sigma),
    clipped to [min, max], in an order drawn from ``rng``."""
    v = spec["median"] * np.exp(spec["sigma"] * _ndtri(quantiles(n)))
    v = np.clip(np.rint(v), spec.get("min", 1), spec.get("max", 1 << 40))
    return rng.permutation(v.astype(np.int64))


@dataclasses.dataclass
class GeneModels:
    """Genes as flat arrays.  Exons ("parts") are 1-based inclusive
    genomic intervals, sorted within each gene; an isoform is a sorted
    list of its gene's part indices."""

    name: List[str]
    chrom: np.ndarray            # (G,) index into CHROMS
    strand: np.ndarray           # (G,) '+' or '-'
    part_off: np.ndarray         # (G+1,) into part_start / part_end
    part_start: np.ndarray
    part_end: np.ndarray
    iso_off: np.ndarray          # (G+1,) into the isoform list
    iso_part_off: np.ndarray     # (N_iso+1,) into iso_part
    iso_part: np.ndarray         # local part indices

    @property
    def num_genes(self) -> int:
        return len(self.name)

    def num_iso(self, g: int) -> int:
        return int(self.iso_off[g + 1] - self.iso_off[g])

    def exons(self, g: int, j: int):
        """(starts, ends) of isoform j of gene g, genomic order."""
        k = self.iso_off[g] + j
        parts = self.iso_part[self.iso_part_off[k]:self.iso_part_off[k + 1]]
        base = self.part_off[g]
        return self.part_start[base + parts], self.part_end[base + parts]


@dataclasses.dataclass
class Reads:
    """Aligned reads in BAM order.  ``block_start`` is 1-based genomic,
    ``block_len`` 0 past a read's last block.  Paired reads share a
    ``pair`` id; single-end reads have pair = their own index."""

    gene: np.ndarray             # (R,)
    pair: np.ndarray             # (R,)
    mate: np.ndarray             # (R,) 0 single/first, 1 second
    block_start: np.ndarray      # (R, MAX_BLOCKS)
    block_len: np.ndarray        # (R, MAX_BLOCKS)


@dataclasses.dataclass
class Sample:
    config: dict
    models: GeneModels
    units: np.ndarray            # (G,) reads (single) or pairs per gene
    reads: Reads
    gff_path: Optional[str] = None
    bam_path: Optional[str] = None

    @property
    def total_reads(self) -> int:
        return int(len(self.reads.gene))


# ------------------------------------------------------------ gene models

def _layout(exon_lens: List[np.ndarray], intron_lens: List[np.ndarray],
            rng: np.random.Generator):
    """Place genes one after another on the chromosomes: (chrom, strand,
    part_off, part_start, part_end)."""
    G = len(exon_lens)
    chrom = (np.arange(G) * len(CHROMS)) // G
    strand = np.where(rng.random(G) < 0.5, "+", "-")
    n_parts = np.array([len(e) for e in exon_lens])
    part_off = np.concatenate([[0], np.cumsum(n_parts)])
    starts = np.empty(part_off[-1], np.int64)
    ends = np.empty(part_off[-1], np.int64)
    cursor = np.ones(len(CHROMS), np.int64)
    for g in range(G):
        c = chrom[g]
        pos = cursor[c]
        el, il = exon_lens[g], intron_lens[g]
        gaps = np.concatenate([[0], il])
        s = pos + np.cumsum(gaps) + np.concatenate([[0], np.cumsum(el[:-1])])
        a, b = part_off[g], part_off[g + 1]
        starts[a:b] = s
        ends[a:b] = s + el - 1
        cursor[c] = ends[b - 1] + 1 + GAP_NT
    return chrom, strand, part_off, starts, ends


def skipped_exon_shapes(cfg: dict, rng: np.random.Generator) -> list:
    """Per event (exon lengths, intron lengths, isoforms as part tuples):
    two isoforms over three exons, inclusion (0,1,2) and exclusion
    (0,2)."""
    G = cfg["events"]
    gm = cfg["gene_model"]
    up = lognormal_sizes(G, gm["flank_exon_nt"], rng)
    se = lognormal_sizes(G, gm["skipped_exon_nt"], rng)
    dn = lognormal_sizes(G, gm["flank_exon_nt"], rng)
    i1 = lognormal_sizes(G, gm["intron_nt"], rng)
    i2 = lognormal_sizes(G, gm["intron_nt"], rng)
    return [(np.array([up[g], se[g], dn[g]]), np.array([i1[g], i2[g]]),
             [(0, 1, 2), (0, 2)]) for g in range(G)]


def isoform_counts(G: int, spec: dict, rng: np.random.Generator
                   ) -> np.ndarray:
    """G isoform counts at the quantiles of P(I) ∝ I^-power over
    [min, max], in a seeded order."""
    sizes = np.arange(spec["min"], spec["max"] + 1)
    p = sizes.astype(np.float64) ** -spec["power"]
    cdf = np.cumsum(p) / p.sum()
    idx = np.minimum(np.searchsorted(cdf, quantiles(G)), len(sizes) - 1)
    return rng.permutation(sizes[idx])


def cassette_exons(n_iso: int, most: int) -> int:
    """The fewest cassette exons that give ``n_iso`` distinct isoforms:
    the one with every exon, and others that each skip a distinct set of
    at most ``most`` cassette exons."""
    a = 1
    while sum(math.comb(a, k) for k in range(min(a, most) + 1)) < n_iso:
        a += 1
    return a


def _skip_isoforms(lens: np.ndarray, n_alt: int, n_iso: int, min_len: int,
                   rng: np.random.Generator) -> list:
    """Up to ``n_iso`` isoforms of a gene with exons ``lens`` and
    ``n_alt`` internal cassette exons drawn from ``rng``: every exon,
    then each set of one cassette exon skipped, of two, ... (in a drawn
    order within each size), where what is left holds a fragment."""
    n = len(lens)
    alt = np.sort(1 + rng.choice(n - 2, size=n_alt, replace=False))
    isos = [tuple(range(n))]
    for k in range(1, n_alt + 1):
        sets = list(itertools.combinations(alt.tolist(), k))
        for j in rng.permutation(len(sets)):
            if len(isos) == n_iso:
                return isos
            parts = tuple(sorted(set(range(n)) - set(sets[j])))
            if lens[list(parts)].sum() > min_len:
                isos.append(parts)
    return isos


def multi_isoform_shapes(cfg: dict, rng: np.random.Generator) -> list:
    """Per gene (exon lengths, intron lengths, isoforms): the isoforms
    share the gene's exons and differ at a few cassette exons.  The first
    isoform has every exon; each other one skips a distinct set of at
    most ``skipped_per_isoform_max`` of the gene's internal cassette
    exons, the sets of one exon first, then of two, ...; a set that
    leaves an isoform too short for the longest fragment is passed over,
    and larger sets, more cassette exons or longer exons taken where that
    leaves too few.  ``most`` sizes the cassette exons; the sets, drawn
    from them in order of size, go past it only where that is needed."""
    G = cfg["events"]
    gm = cfg["gene_model"]
    most = gm["skipped_per_isoform_max"]
    n_iso = isoform_counts(G, gm["isoforms"], rng)
    n_alt = np.array([cassette_exons(int(i), most) for i in n_iso])
    n_exons = np.maximum(lognormal_sizes(G, gm["exons_per_gene"], rng),
                         n_alt + 2)
    total = int(n_exons.sum())
    exon_all = lognormal_sizes(total, gm["exon_nt"], rng)
    intron_all = lognormal_sizes(total, gm["intron_nt"], rng)
    off = np.concatenate([[0], np.cumsum(n_exons)])
    min_len = int(fragment_pmf(cfg)[0][-1])
    shapes = []
    for g in range(G):
        n = int(n_exons[g])
        lens = exon_all[off[g]:off[g + 1]]
        if lens.sum() <= min_len:          # the full isoform holds a fragment
            lens = lens * (min_len // int(lens.sum()) + 1)
        a = int(n_alt[g])
        while True:
            isos = _skip_isoforms(lens, a, int(n_iso[g]), min_len, rng)
            if len(isos) == n_iso[g]:
                break
            # too few sets leave a fragment's length: one cassette exon
            # more, or longer exons where every internal one is cassette
            if a < n - 2:
                a += 1
            else:
                lens = lens * 2
        shapes.append((lens, intron_all[off[g]:off[g + 1] - 1], isos))
    return shapes


def build_models(shapes: list, prefix: str, rng: np.random.Generator
                 ) -> GeneModels:
    """Lay the genes out one after another on the chromosomes, each on a
    strand drawn from ``rng``."""
    G = len(shapes)
    chrom, strand, part_off, ps, pe = _layout(
        [sh[0] for sh in shapes], [sh[1] for sh in shapes], rng)
    isos = [iso for sh in shapes for iso in sh[2]]
    iso_off = np.concatenate([[0], np.cumsum([len(sh[2]) for sh in shapes])])
    iso_part_off = np.concatenate([[0], np.cumsum([len(i) for i in isos])])
    iso_part = np.array([p for iso in isos for p in iso], np.int64)
    return GeneModels(["%s%05d" % (prefix, g) for g in range(G)], chrom,
                      strand, part_off, ps, pe, iso_off, iso_part_off,
                      iso_part)


def write_gff(models: GeneModels, path: str) -> None:
    """GFF3: gene, mRNA (Parent gene), exon (Parent mRNA) records."""
    lines = ["##gff-version 3\n"]
    for g in range(models.num_genes):
        c, s, gid = CHROMS[models.chrom[g]], models.strand[g], models.name[g]
        a, b = models.part_off[g], models.part_off[g + 1]
        lo, hi = models.part_start[a], models.part_end[b - 1]
        lines.append("%s\tbench\tgene\t%d\t%d\t.\t%s\t.\tID=%s;Name=%s\n"
                     % (c, lo, hi, s, gid, gid))
        for j in range(models.num_iso(g)):
            st, en = models.exons(g, j)
            tid = "%s.%d" % (gid, j)
            lines.append("%s\tbench\tmRNA\t%d\t%d\t.\t%s\t.\tID=%s;Parent=%s\n"
                         % (c, st[0], en[-1], s, tid, gid))
            lines.extend(
                "%s\tbench\texon\t%d\t%d\t.\t%s\t.\tID=%s.e%d;Parent=%s\n"
                % (c, x0, x1, s, tid, x, tid)
                for x, (x0, x1) in enumerate(zip(st, en)))
    with open(path, "w") as f:
        f.writelines(lines)


# ------------------------------------------------------------------ reads

def reads_per_unit(G: int, spec: dict, rng: np.random.Generator
                   ) -> np.ndarray:
    """Reads (or pairs) per gene: a share of unexpressed genes with
    counts spread evenly over [0, min_event_reads), the rest at the
    quantiles of a log-normal, capped; in a seeded order."""
    n_off = int(round(G * spec.get("unexpressed", 0.0)))
    off = np.floor(quantiles(n_off) * spec.get("unexpressed_below", 20))
    on = spec["median"] * np.exp(spec["sigma"] * _ndtri(quantiles(G - n_off)))
    on = np.clip(np.rint(on), 1, spec["cap"])
    return rng.permutation(np.concatenate([off, on]).astype(np.int64))


def _iso_tables(models: GeneModels):
    """Per isoform: exon count and transcript length; per exon of each
    isoform, flattened: genomic start, length and transcript offset."""
    gene_of = np.repeat(np.arange(models.num_genes), np.diff(models.iso_off))
    sizes = np.diff(models.iso_part_off)
    flat_gene = np.repeat(gene_of, sizes)
    flat_part = models.part_off[flat_gene] + models.iso_part
    gs = models.part_start[flat_part]
    ln = models.part_end[flat_part] - gs + 1
    csum = np.cumsum(ln)
    iso_len = np.add.reduceat(ln, models.iso_part_off[:-1])
    t_off = csum - ln - np.repeat(csum[models.iso_part_off[:-1]]
                                  - ln[models.iso_part_off[:-1]], sizes)
    return sizes, iso_len, gs, ln, t_off


def _blocks(iso: np.ndarray, tpos: np.ndarray, read_len: int, tabs):
    """Genomic blocks of reads at transcript offset ``tpos`` (0-based) of
    isoform ``iso``: (block_start (R, 4) 1-based, block_len (R, 4))."""
    sizes, _, gs, ln, t_off = tabs
    first = np.asarray(np.cumsum(sizes) - sizes)[iso]
    last = first + sizes[iso]
    # the exon holding the read's first base: search the isoform's own
    # transcript offsets, shifted so all isoforms sort as one array
    big = np.int64(1) << 40
    key = t_off + np.repeat(np.arange(len(sizes), dtype=np.int64) * big,
                            sizes)
    x = np.searchsorted(key, iso.astype(np.int64) * big + tpos,
                        side="right") - 1
    R = len(tpos)
    bs = np.zeros((R, MAX_BLOCKS), np.int64)
    bl = np.zeros((R, MAX_BLOCKS), np.int64)
    lo = tpos.copy()
    hi = tpos + read_len
    for b in range(MAX_BLOCKS):
        xb = x + b
        ok = (xb < last) & (lo < hi)
        xs = np.where(ok, xb, 0)
        seg_end = np.minimum(hi, t_off[xs] + ln[xs])
        bs[ok, b] = (gs[xs] + lo - t_off[xs])[ok]
        bl[ok, b] = (seg_end - lo)[ok]
        lo = np.where(ok, seg_end, lo)
    if (lo < hi).any():
        raise ValueError("a read spans more than %d exons" % MAX_BLOCKS)
    return bs, bl


def simulate(models: GeneModels, units: np.ndarray, cfg: dict,
             traffic: dict, rng: np.random.Generator):
    """Reads for ``units`` reads (pairs) per gene, each gene's isoform
    fractions drawn from a Dirichlet, under the program's model:
    a unit takes isoform j with probability ∝ psi_j * (positions of j);
    single-end reads start uniformly on the isoform; a pair takes a
    fragment length from the configuration's discretised normal, capped
    by the isoform, and a start uniformly among the fragment's
    positions."""
    rd = cfg["reads"]
    rl = rd["read_len"]
    G = models.num_genes
    alpha = traffic.get("psi_dirichlet", 0.5)
    tabs = _iso_tables(models)
    iso_len = tabs[1]
    psi = [rng.dirichlet(np.full(models.num_iso(g), alpha))
           for g in range(G)]
    psi_flat = np.concatenate(psi)
    paired = rd["paired_end"]
    if paired:
        lens, pmf = fragment_pmf(cfg)
        # positions of isoform j: sum over fragment lengths of (L - f + 1)
        pos_w = np.maximum(iso_len[:, None] - lens[None, :] + 1, 0).sum(1)
    else:
        pos_w = np.maximum(iso_len - rl + 1, 0)
    w = psi_flat * pos_w
    # one unit's isoform: inverse CDF within its gene's isoforms
    first, n_iso = models.iso_off[:-1], np.diff(models.iso_off)
    csum = np.cumsum(w)
    cdf = (csum - np.repeat(csum[first] - w[first], n_iso)) / np.repeat(
        np.add.reduceat(w, first), n_iso)
    unit_gene = np.repeat(np.arange(G), units)
    U = len(unit_gene)
    u = rng.random(U)
    big = 2.0
    key = cdf + np.repeat(np.arange(G) * big, n_iso)
    iso = np.searchsorted(key, unit_gene * big + u, side="left")
    iso = np.minimum(iso, models.iso_off[unit_gene + 1] - 1)
    L = iso_len[iso]
    if paired:
        # fragment length by inverse CDF of the pmf cut at L
        fcdf = np.cumsum(pmf)
        top = fcdf[np.clip(L - lens[0], 0, len(lens) - 1)]
        f = lens[np.searchsorted(fcdf, rng.random(U) * top, side="left")]
        f = np.minimum(f, L)
        start = np.floor(rng.random(U) * (L - f + 1)).astype(np.int64)
        bs1, bl1 = _blocks(iso, start, rl, tabs)
        bs2, bl2 = _blocks(iso, start + f - rl, rl, tabs)
        reads = Reads(np.repeat(unit_gene, 2), np.repeat(np.arange(U), 2),
                      np.tile([0, 1], U),
                      np.stack([bs1, bs2], 1).reshape(2 * U, MAX_BLOCKS),
                      np.stack([bl1, bl2], 1).reshape(2 * U, MAX_BLOCKS))
    else:
        start = np.floor(rng.random(U) * (L - rl + 1)).astype(np.int64)
        bs, bl = _blocks(iso, start, rl, tabs)
        reads = Reads(unit_gene, np.arange(U), np.zeros(U, np.int64), bs, bl)
    # BAM order: chromosome, then position
    order = np.lexsort((reads.block_start[:, 0], models.chrom[reads.gene]))
    reads = Reads(*(getattr(reads, f.name)[order]
                    for f in dataclasses.fields(Reads)))
    return reads


def make_sample(cfg: dict, traffic: dict, seed: int) -> Sample:
    """The sample a cell runs on ``seed``, in memory.  The genes' shapes
    and their read counts come from a stream that is the same for every
    seed; the seed orders them along the genome and draws the strands,
    the isoform fractions and the reads."""
    fixed = rng_for(0, 0x5A4D)
    rng = rng_for(seed, 0x5A4D)
    kind = cfg["gene_model"]["kind"]
    if kind == "skipped_exon":
        shapes, prefix = skipped_exon_shapes(cfg, fixed), "ev"
    elif kind == "multi_isoform":
        shapes, prefix = multi_isoform_shapes(cfg, fixed), "g"
    else:
        raise ValueError("unknown gene model %r" % kind)
    units = reads_per_unit(len(shapes), traffic["reads_per_event"], fixed)
    order = rng.permutation(len(shapes))
    models = build_models([shapes[i] for i in order], prefix, rng)
    units = units[order]
    reads = simulate(models, units, cfg, traffic, rng)
    return Sample(cfg, models, units, reads)


# -------------------------------------------------------------------- BAM

def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """SAM spec 5.3 bin of [beg, end) (0-based), vectorised."""
    end = end - 1
    out = np.zeros(beg.shape, np.int64)
    done = np.zeros(beg.shape, bool)
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = off + (beg[hit] >> shift)
        done |= hit
    return out


_FIXED = np.dtype([("block_size", "<i4"), ("ref", "<i4"), ("pos", "<i4"),
                   ("l_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                   ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                   ("next_ref", "<i4"), ("next_pos", "<i4"),
                   ("tlen", "<i4")])
NAME_LEN = 9                 # 8 hex digits and a NUL


def bam_records(sample: Sample, lo: int, hi: int) -> bytes:
    """BAM records of reads [lo, hi) as one byte string."""
    r = sample.reads
    bs = r.block_start[lo:hi]
    bl = r.block_len[lo:hi]
    n = hi - lo
    nb = (bl > 0).sum(1)
    ncig = 2 * nb - 1
    width = _FIXED.itemsize + NAME_LEN + 4 * (2 * MAX_BLOCKS - 1)
    rec_len = _FIXED.itemsize + NAME_LEN + 4 * ncig
    fixed = np.zeros(n, _FIXED)
    pos0 = bs[:, 0] - 1
    last = np.take_along_axis(bs + bl, (nb - 1)[:, None], 1)[:, 0] - 1
    fixed["block_size"] = rec_len - 4
    fixed["ref"] = sample.models.chrom[r.gene[lo:hi]]
    fixed["pos"] = pos0
    fixed["l_name"] = NAME_LEN
    fixed["mapq"] = 255
    fixed["bin"] = reg2bin(pos0, last)
    fixed["n_cigar"] = ncig
    fixed["next_ref"] = -1
    fixed["next_pos"] = -1
    if sample.config["reads"]["paired_end"]:
        first = r.mate[lo:hi] == 0
        fixed["flag"] = np.where(first, 0x1 | 0x2 | 0x40 | 0x20,
                                 0x1 | 0x2 | 0x80 | 0x10)
        fixed["next_ref"] = fixed["ref"]
    M = np.zeros((n, width), np.uint8)
    M[:, :_FIXED.itemsize] = fixed.view(np.uint8).reshape(n, -1)
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    shifts = 4 * np.arange(7, -1, -1)
    M[:, _FIXED.itemsize:_FIXED.itemsize + 8] = hexd[
        (r.pair[lo:hi, None] >> shifts[None, :]) & 0xF]
    # cigar: M block, then N gap and M block per further block
    ops = np.zeros((n, 2 * MAX_BLOCKS - 1), np.uint32)
    ops[:, 0::2] = (bl << 4) | CIGAR_M
    gaps = bs[:, 1:] - (bs[:, :-1] + bl[:, :-1])
    ops[:, 1::2] = np.where(bl[:, 1:] > 0, (gaps << 4) | CIGAR_N, 0)
    c0 = _FIXED.itemsize + NAME_LEN
    M[:, c0:] = ops.astype("<u4").view(np.uint8).reshape(n, -1)
    keep = np.arange(width)[None, :] < rec_len[:, None]
    return M[keep].tobytes()


def _bgzf_block(chunk: bytes) -> bytes:
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
              + struct.pack("<H", 6) + b"BC"
              + struct.pack("<HH", 2, len(cdata) + 25))
    return header + cdata + struct.pack(
        "<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))


def write_bam(sample: Sample, path: str, threads: int = 4,
              reads_per_batch: int = 1 << 19) -> int:
    """Write the sample's reads as a coordinate-sorted BAM; returns its
    size in bytes."""
    m = sample.models
    lengths = np.zeros(len(CHROMS), np.int64)
    np.maximum.at(lengths, m.chrom, m.part_end[m.part_off[1:] - 1] + GAP_NT)
    text = b"@HD\tVN:1.6\tSO:coordinate\n"
    head = [b"BAM\x01", struct.pack("<i", len(text)), text,
            struct.pack("<i", len(CHROMS))]
    for name, ln in zip(CHROMS, lengths):
        nb = name.encode() + b"\x00"
        head.append(struct.pack("<i", len(nb)) + nb
                    + struct.pack("<i", max(int(ln), 1)))
    pending = b"".join(head)
    size = 0
    R = sample.total_reads
    with open(path, "wb") as f, \
            concurrent.futures.ThreadPoolExecutor(threads) as pool:
        for lo in range(0, max(R, 1), reads_per_batch):
            pending += bam_records(sample, lo, min(R, lo + reads_per_batch))
            cut = len(pending) - len(pending) % BGZF_BLOCK
            if lo + reads_per_batch >= R:
                cut = len(pending)
            chunks = [pending[i:i + BGZF_BLOCK]
                      for i in range(0, cut, BGZF_BLOCK)]
            pending = pending[cut:]
            for blk in pool.map(_bgzf_block, chunks):
                f.write(blk)
                size += len(blk)
        f.write(BGZF_EOF)
    return size + len(BGZF_EOF)


def write_sample(sample: Sample, out_dir: str) -> Sample:
    """Write the sample's GFF and BAM under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    sample.gff_path = os.path.join(out_dir, "sample.gff")
    sample.bam_path = os.path.join(out_dir, "sample.bam")
    write_gff(sample.models, sample.gff_path)
    write_bam(sample, sample.bam_path)
    return sample


def fragment_pmf(cfg: dict):
    """(lengths, probabilities) of the configuration's insert lengths, as
    the configuration states them (mean, sd, num_sds, floor at the read
    length), for a reader that needs the support."""
    fr = cfg["reads"]["fragment"]
    sd = fr["sd"]
    lo = max(int(fr["mean"] - sd * fr["num_sds"]), cfg["reads"]["read_len"])
    hi = max(int(fr["mean"] + sd * fr["num_sds"]), lo)
    lens = np.arange(lo, hi + 1)
    p = np.exp(-0.5 * ((lens - fr["mean"]) / sd) ** 2) / (sd * math.sqrt(
        2 * math.pi))
    return lens, p / p.sum()
