"""Input sanity checks and the coverage prefilter.

Parity targets:
- check_gff_and_bam: misopy/run_events_analysis.py:74-194 (mixed read
  lengths, chr-prefix mismatch between annotation and alignments).
- prefilter: misopy/run_events_analysis.py:27-71 +
  exon_utils.py:217-250 (coverage counting; natively, no bedtools).
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Set

logger = logging.getLogger("miso")


def check_gff_and_bam(gff_dir: str, bam_filename: str,
                      num_genes: int = 10000, num_reads: int = 10000,
                      given_read_len: Optional[int] = None) -> List[str]:
    """Warn on mixed read lengths and chromosome-naming mismatches.
    Returns the list of warning strings (also logged)."""
    from miso_tpu_torch.io.sam import open_alignments

    warnings: List[str] = []

    def warn(msg):
        warnings.append(msg)
        logger.warning(msg)

    if not os.path.isfile(bam_filename):
        warn("Error: BAM %s cannot be found." % bam_filename)
        return warnings

    alignments = open_alignments(bam_filename)
    seq_lens: Set[int] = set()
    bam_chroms: Set[str] = set()
    for n, read in enumerate(alignments):
        if n >= num_reads:
            break
        if read.rlen:
            seq_lens.add(read.rlen)
        if read.rname != "*":
            bam_chroms.add(read.rname)
    if len(seq_lens) > 1:
        warn("Found mixed length reads in your BAM file: %s. "
             "MISO does not support mixed read lengths. Read lengths "
             "were: %s" % (bam_filename,
                           ",".join(map(str, sorted(seq_lens)))))
    elif seq_lens and given_read_len is not None:
        (ln,) = seq_lens
        if ln != given_read_len:
            warn("Error: The given read length (%d) does not match the "
                 "read length found in BAM (%d)."
                 % (given_read_len, ln))

    genes_fname = os.path.join(gff_dir, "genes.gff")
    if not os.path.isfile(genes_fname):
        warn("No genes.gff file found in %s. Did you index your GFF "
             "with an older version of MISO?" % gff_dir)
        return warnings
    gff_chroms: Set[str] = set()
    with open(genes_fname) as f:
        for n, line in enumerate(f):
            if n >= num_genes:
                break
            gff_chroms.add(line.strip().split("\t")[0])
    gff_chr = any(c.startswith("chr") for c in gff_chroms)
    bam_chr = any(str(c).startswith("chr") for c in bam_chroms)
    if bam_chroms and gff_chroms and gff_chr != bam_chr:
        warn("It looks like your GFF annotation file and your BAM file "
             "might not have matching headers (chromosome names). "
             "BAM chroms: %s; GFF chroms: %s. Run is likely to produce "
             "empty output."
             % (",".join(sorted(map(str, bam_chroms))[:5]),
                ",".join(sorted(gff_chroms)[:5])))
    return warnings


def get_ids_passing_filter(gff_index_dir: str, bam_filename: str,
                           min_reads: int = 20) -> List[str]:
    """Gene IDs with at least `min_reads` reads overlapping their span.

    The reference shells out to bedtools coverage
    (run_events_analysis.py:27-71); this counts with the native reader.
    """
    from miso_tpu_torch.io.gff import read_gff
    from miso_tpu_torch.io.sam import iter_bam_reads_in_gene, open_alignments

    # Gene spans come straight from the index's genes.gff (one text
    # pass) -- unpickling every per-gene shelve entry just for its span
    # made this O(genes) pickle loads.
    genes_fname = os.path.join(gff_index_dir, "genes.gff")
    spans = []
    for rec in read_gff(genes_fname):
        gid = rec.get_id()
        if gid is not None:
            spans.append((gid, rec.seqid, rec.start, rec.end))

    alignments = open_alignments(bam_filename)
    if hasattr(alignments, "scan_chrom_columnar"):
        # ONE columnar scan per chromosome + two binary searches and a
        # mask sum per gene: the per-gene region fetches re-inflated
        # the same BGZF blocks over and over (82s at 50k genes; this
        # path runs in ~2s)
        import numpy as np
        from collections import defaultdict
        by_chrom: dict = defaultdict(list)
        for gid, chrom, lo, hi in spans:
            by_chrom[chrom].append((gid, lo, hi))
        passing = []
        for chrom, items in by_chrom.items():
            c = chrom
            if c not in alignments.references:
                parts = c.split("chr")
                c = parts[0] if len(parts) <= 1 else parts[1]
            try:
                scan = alignments.scan_chrom_columnar(c)
            except KeyError:
                continue  # chromosome absent from the BAM: 0 reads
            pos, ends, span = scan.pos, scan.ref_end, scan.max_span
            for gid, lo, hi in items:
                start, end = lo - 1, hi
                i0 = int(np.searchsorted(pos, start - span + 1, "left"))
                i1 = int(np.searchsorted(pos, end, "left"))
                if i1 - i0 < min_reads:
                    continue
                if int((ends[i0:i1] > start).sum()) >= min_reads:
                    passing.append(gid)
        return sorted(passing)
    passing = []
    for gene_id, chrom, lo, hi in sorted(spans):
        count = 0
        # stop at the threshold: the filter only needs >= min_reads,
        # not the exact coverage of deep genes
        for _ in iter_bam_reads_in_gene(alignments, chrom, lo - 1, hi):
            count += 1
            if count >= min_reads:
                break
        if count >= min_reads:
            passing.append(gene_id)
    return passing


def setup_logger(output_dir: str, name: str = "miso",
                 level=logging.INFO) -> logging.Logger:
    """Timestamped file + stdout logging under output/logs
    (misopy/miso.py:30-58)."""
    import time as _time

    log = logging.getLogger(name)
    log.setLevel(level)
    if log.handlers:
        return log
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        datefmt="%m/%d/%Y %I:%M:%S %p")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    log.addHandler(sh)
    if output_dir:
        logs_dir = os.path.join(output_dir, "logs")
        os.makedirs(logs_dir, exist_ok=True)
        ts = _time.strftime("%Y-%m-%d_%H-%M-%S")
        fh = logging.FileHandler(
            os.path.join(logs_dir, "main.%s.log" % ts))
        fh.setFormatter(fmt)
        log.addHandler(fh)
    return log
