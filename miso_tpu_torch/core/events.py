"""Event compiler: (gene, aligned reads) -> device-ready dense tensors.

The TPU-native analogue of the per-gene setup code in
pysplicing/src/miso.c:748-815 (match matrix, effective lengths, isoscores)
and miso_paired.c:367-419 (fragment pmf, per-fragment-length isoscores,
assscores), plus read-class collapse so the device tensors are
(classes x isoforms) regardless of read depth.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from miso_tpu_torch.core.fragments import normal_fragment
from miso_tpu_torch.core.gene import Gene
from miso_tpu_torch.core.matching import (ReadClasses, collapse_to_classes,
                                    match_classes, match_iso,
                                    match_iso_paired)

NEG_INF = -np.inf


@dataclasses.dataclass
class CompiledEvent:
    """One event's device tensors plus output-layer metadata."""

    name: str
    gene: Gene
    num_iso: int
    num_reads: int            # reads (single-end) or pairs (paired-end)
    weights: np.ndarray       # (C, I)
    log_read: np.ndarray      # (C, I)
    counts: np.ndarray        # (C,)
    log_iso_w: np.ndarray     # (I,)
    hyper: np.ndarray         # (I,)
    classes: ReadClasses
    paired: bool = False
    any_compatible: bool = True

    @property
    def num_classes(self) -> int:
        return len(self.counts)

    def counts_str(self) -> str:
        """The ``counts=`` header field: READ-class templates (as int
        tuples) with read counts -- always the match-matrix classes, even
        when the sampler scores with position classes (ALGO_CLASSES), as
        in the reference (miso.c:762-767 computes them from the match
        matrix regardless of algorithm).
        Ref: misopy/miso_sampler.py:404-422.

        One int cast + one tolist per event instead of a Python generator
        per template cell (paired events carry ~100 classes; the per-cell
        form was a measurable slice of the catalog write phase)."""
        tm = self.classes.templates.astype(np.int64).T.tolist()  # (C, I)
        cn = self.classes.counts.astype(np.int64).tolist()
        return ",".join(
            "(%s):%d" % (",".join(map(str, t)), n)
            for t, n in zip(tm, cn))

    def final_assignment_counts(self, psi: np.ndarray,
                                rng: Optional[np.random.Generator] = None
                                ) -> np.ndarray:
        """One reassignment pass from `psi` over the read classes -- the
        reference's final-assignment computation for non-REASSIGN
        algorithms (miso.c:935-947)."""
        rng = rng or np.random.default_rng(0)
        templates = self.classes.templates  # (I, C)
        counts = self.classes.counts
        n = np.zeros(self.num_iso)
        for c in range(templates.shape[1]):
            p = psi[:self.num_iso] * templates[:, c]
            tot = p.sum()
            if tot <= 0 or counts[c] <= 0:
                continue
            n += rng.multinomial(int(counts[c]), p / tot)
        return n


def effective_lengths(
    gene: Gene, read_len: int, overhang: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(clamped_efflen, raw_efflen): effective isoform lengths.

    l_i = isolen_i - readLen + 1 - 2*(numExons_i - 1)*(overhang - 1),
    clamped at 0 (raw value kept for the isoscores term).
    Ref: pysplicing/src/miso.c:777-784.
    """
    isolen = gene.iso_lengths
    nox = gene.iso_num_exons_all
    raw = isolen - read_len + 1 - 2 * (nox - 1) * (overhang - 1)
    return np.maximum(raw, 0), raw


def compile_single_end(
    gene: Gene,
    positions: np.ndarray,
    cigars: Sequence[str],
    read_len: int,
    overhang: int = 1,
    hyper: Optional[np.ndarray] = None,
    name: str = "event",
    algorithm: str = "reassign",
) -> CompiledEvent:
    """Compile a single-end event.  Ref: pysplicing/src/miso.c:748-815."""
    if overhang == 0:
        overhang = 1
    # fused match + collapse (the (I, R) match matrix never materializes
    # on the native path; identical classes either way)
    classes, any_comp = match_classes(gene, positions, cigars, read_len,
                                      overhang)
    return _event_from_classes(gene, classes, any_comp, len(positions),
                               read_len, overhang, hyper, name, algorithm)


def _se_scores(raw: np.ndarray, efflen: np.ndarray):
    """(isoscores, log_iso_w) from raw/clamped effective lengths.

    isoscores_i = -log(raw_i); reference computes -log of the raw
    (possibly <= 0) value (miso.c:783); we map non-positive to -inf.
    """
    with np.errstate(divide="ignore", invalid="ignore"):
        isoscores = np.where(raw > 0, -np.log(np.maximum(raw, 1e-300)),
                             NEG_INF)
        log_iso_w = np.where(efflen > 0, np.log(np.maximum(efflen, 1)),
                             NEG_INF)
    return isoscores, log_iso_w


def _event_from_classes(
    gene: Gene,
    classes: ReadClasses,
    any_comp: bool,
    num_reads: int,
    read_len: int,
    overhang: int,
    hyper: Optional[np.ndarray],
    name: str,
    algorithm: str,
    scores=None,
) -> CompiledEvent:
    """Everything in compile_single_end after read-class collapse.
    `scores` = precomputed (efflen, isoscores, log_iso_w) (the batch
    compiler vectorizes them across a whole chromosome's genes)."""
    noiso = gene.num_isoforms
    if scores is not None:
        efflen, isoscores, log_iso_w = scores
    else:
        efflen, raw = effective_lengths(gene, read_len, overhang)
        isoscores, log_iso_w = _se_scores(raw, efflen)

    templates = classes.templates  # (I, C)
    weights = templates.T.astype(np.float64).copy()  # (C, I)
    counts = classes.counts.astype(np.float64)
    # Drop the all-incompatible class from the DEVICE tensors: the
    # reference assigns those reads -1 and they contribute nothing to
    # any score (miso.c:65-66 noValid==0); keeping them as zero-weight
    # rows is statistically inert (masked in every kernel) but inflates
    # the per-read tile R and breaks the grid-exact oracle.  The header
    # `counts=` field keeps ALL classes (counts_str uses self.classes),
    # matching the reference output (miso_sampler.py:404-422).
    compat = weights.any(axis=1)
    if not compat.all():
        weights = weights[compat]
        counts = counts[compat]
        templates = templates[:, compat]
    if algorithm == "marginal":
        # match probabilities divided by effective length (miso.c:807-815)
        div = np.where(efflen != 0, efflen, 1).astype(np.float64)
        weights = weights / div[None, :]
    elif algorithm == "classes":
        # position-class scoring (miso.c:790-803): row-normalized
        # assignment matrix + per-class read counts via support matching
        from miso_tpu_torch.core.assignment import (assignment_matrix,
                                              norm_assignment_matrix)
        from miso_tpu_torch.core.matching import match_vector_from_classes
        A = assignment_matrix(gene, read_len, overhang)
        weights = norm_assignment_matrix(A).T        # (C_a, I)
        counts = match_vector_from_classes(classes, A)
    log_read = np.where(templates.T > 0, isoscores[None, :], 0.0)
    log_read = np.where(np.isfinite(log_read), log_read, 0.0)
    if algorithm == "classes" and log_read.shape[0] != weights.shape[0]:
        log_read = np.zeros_like(weights)  # unused by the CLASSES scorer

    if hyper is None:
        hyper = _ones_ro(noiso)
    return CompiledEvent(
        name=name, gene=gene, num_iso=noiso, num_reads=num_reads,
        weights=weights, log_read=log_read,
        counts=counts,
        log_iso_w=log_iso_w, hyper=np.asarray(hyper, dtype=np.float64),
        classes=classes, paired=False,
        any_compatible=any_comp,
    )


def _flat_exon_tables(genes: List[Gene]):
    """(spans (n,2), exon_starts, exon_ends, exon_idx_flat, eidx_ofs,
    noiso) built from Gene objects, for catalogs whose index predates
    the precomputed compile tables."""
    spans = np.array([g.genomic_span() for g in genes], np.int64
                     ).reshape(-1, 2)
    starts_l, ends_l, idx_l, ofs_l = [], [], [], []
    exon_base = row_base = 0
    for g in genes:
        s, e, idx = g.flat_exons()
        starts_l.append(s)
        ends_l.append(e)
        idx_l.append(idx + exon_base)
        ofs_l.append(row_base)
        exon_base += len(s)
        row_base += len(idx)
    z = np.zeros(0, np.int64)
    return (spans,
            np.concatenate(starts_l) if starts_l else z,
            np.concatenate(ends_l) if ends_l else z,
            np.concatenate(idx_l) if idx_l else z,
            np.asarray(ofs_l, np.int64),
            np.array([g.num_isoforms for g in genes], np.int64))


def compile_paired_end_many(
    genes: List[Gene],
    names: List[str],
    scan,
    read_len: int,
    mean_frag_len: float,
    frag_variance: float,
    num_sds: float = 4.0,
    overhang: int = 1,
    min_event_reads: int = 0,
    tables: Optional[dict] = None,
    rows: Optional[np.ndarray] = None,
) -> Optional[List[Optional[CompiledEvent]]]:
    """Batch-compile every paired-end gene of a chromosome against ONE
    columnar pair scan (io/sam.ChromPairs) with a single native
    match+collapse call -- the paired analogue of
    compile_single_end_many (per-gene slicing decoded per-pair cigar
    strings and re-encoded them for the matcher).

    Returns a list parallel to `genes` (None = skip rules), or None if
    the native batch path is unavailable.
    """
    from miso_tpu_torch import native

    if overhang == 0:
        overhang = 1
    n = len(genes)
    if n == 0:
        return []
    if len(scan.p1) == 0:
        return None
    frag_prob, frag_start = normal_fragment(
        mean_frag_len, frag_variance, num_sds, read_len)
    frag_prob = np.asarray(frag_prob, dtype=np.float64)
    frag_prob = frag_prob / frag_prob.sum()
    if tables is not None and rows is not None:
        rows = np.asarray(rows, np.int64)
        spans = tables["span"][rows]
        eidx_ofs = tables["gidx"][rows]
        noiso_arr = tables["noiso"][rows]
        exon_starts = tables["exon_starts"]
        exon_ends = tables["exon_ends"]
        exon_idx_flat = tables["exon_idx"]
    else:
        (spans, exon_starts, exon_ends, exon_idx_flat, eidx_ofs,
         noiso_arr) = _flat_exon_tables(genes)
    los = spans[:, 0] - 1   # 0-based region start
    his = spans[:, 1]
    i0 = np.searchsorted(scan.pmin, los - scan.max_span + 1, "left")
    i1 = np.searchsorted(scan.pmin, his, "left")
    hit = native.match_classes_paired_multi(
        i0, i1, los, his, scan.p1, scan.e1, scan.p2, scan.e2,
        scan.cigar_buf, scan.co1, scan.co2,
        exon_starts, exon_ends, exon_idx_flat, eidx_ofs, noiso_arr,
        read_len, overhang, frag_prob, frag_start, pos_offset=1)
    if hit is None:
        return None
    iso_ofs, isolen_all, nox_all = _gather_iso_tables(
        tables, rows, noiso_arr, genes, n)
    # fragment-length score tables for the WHOLE chromosome in one
    # vectorized pass (the per-gene (il, noiso) log/where chain cost a
    # measurable slice of paired compile; semantics:
    # miso_paired.c:403-419 isoscores / assscores)
    il = len(frag_prob)
    jj = np.arange(il)[:, None]
    lp_all = (isolen_all[None, :] - frag_start - jj + 1
              - 2 * (nox_all[None, :] - 1) * (overhang - 1))
    with np.errstate(divide="ignore", invalid="ignore"):
        isoscores_all = np.where(
            lp_all > 0, -np.log(np.maximum(lp_all, 1e-300)), NEG_INF
        ) + np.log(frag_prob[:, None])
        assscores_all = np.log(np.sum(np.where(lp_all > 0, lp_all, 0),
                                      axis=0))
    fl_flat, match_flat, counts, class_ofs, npairs = hit
    n_cls = class_ofs[1:] - class_ofs[:-1]
    entry_ofs = np.zeros(n + 1, np.int64)
    np.cumsum(n_cls * noiso_arr, out=entry_ofs[1:])
    out: List[Optional[CompiledEvent]] = []
    for g in range(n):
        gene = genes[g]
        npr = int(npairs[g])
        noiso = gene.num_isoforms
        if noiso < 2 or npr == 0 or npr < min_event_reads:
            out.append(None)
            continue
        c0, c1 = int(class_ofs[g]), int(class_ofs[g + 1])
        e0, e1_ = int(entry_ofs[g]), int(entry_ofs[g + 1])
        cg = c1 - c0
        fl = fl_flat[e0:e1_].reshape(cg, noiso).T        # (I, C)
        match = match_flat[e0:e1_].reshape(cg, noiso).T  # (I, C)
        if not match.any():
            out.append(None)  # no pair compatible with any isoform
            continue
        classes = ReadClasses(templates=match, counts=counts[c0:c1],
                              frag_len=fl)
        o0, o1 = int(iso_ofs[g]), int(iso_ofs[g + 1])
        out.append(_paired_event_from_classes(
            gene, classes, True, npr, read_len, overhang, frag_prob,
            frag_start, None, names[g],
            scores=(isoscores_all[:, o0:o1], assscores_all[o0:o1])))
    return out


def _gather_iso_tables(tables, rows, noiso_arr, genes, n: int):
    """(iso_ofs, isolen_all, nox_all) for a batch of genes: the fully
    vectorized per-isoform gather from the index's compile tables, with
    the per-gene concatenate fallback -- shared by the single-end and
    paired batch compilers."""
    iso_ofs = np.zeros(n + 1, np.int64)
    np.cumsum(noiso_arr, out=iso_ofs[1:])
    if tables is not None and rows is not None:
        rows = np.asarray(rows, np.int64)
        take = (np.arange(iso_ofs[-1])
                - np.repeat(iso_ofs[:-1], noiso_arr)
                + np.repeat(tables["iso_ofs"][rows], noiso_arr))
        return (iso_ofs, tables["iso_lengths"][take],
                tables["iso_num_exons"][take])
    return (iso_ofs,
            np.concatenate([g.iso_lengths for g in genes]),
            np.concatenate([g.iso_num_exons_all for g in genes]))


_ONES_RO: dict = {}


def _ones_ro(n: int) -> np.ndarray:
    """Shared read-only all-ones hyperparameter vector: the default
    Dirichlet prior is built once per event, and a fresh np.ones per
    event measurably taxed the 50k-catalog compile wall."""
    a = _ONES_RO.get(n)
    if a is None:
        a = np.ones(n)
        a.setflags(write=False)
        _ONES_RO[n] = a
    return a


def compile_single_end_many(
    genes: List[Gene],
    names: List[str],
    scan,
    read_len: int,
    overhang: int = 1,
    algorithm: str = "reassign",
    min_event_reads: int = 0,
    tables: Optional[dict] = None,
    rows: Optional[np.ndarray] = None,
) -> Optional[List[Optional[CompiledEvent]]]:
    """Batch-compile every gene of a chromosome against ONE columnar scan
    (io/sam.ChromReads) with a single native match+collapse call --
    per-gene dispatch dominated host compile at catalog scale.

    `tables`/`rows`: the index's precomputed whole-chromosome compile
    tables (io/index.py::build_compile_tables) + each gene's row in
    them; with tables the per-gene exon/length assembly is a vectorized
    gather and the Gene objects are touched only for CompiledEvent
    metadata.

    Returns a list parallel to `genes` (None entries = skip rules:
    <2 isoforms, <min_event_reads reads, no compatible read -- the
    reference's per-gene skips, run_miso.py:141-146 /
    miso_sampler.py:352-354), or None if the native batch path is
    unavailable (caller falls back to per-gene compilation).
    """
    from miso_tpu_torch import native

    if overhang == 0:
        overhang = 1
    n = len(genes)
    if n == 0:
        return []
    if len(scan.pos) == 0:
        return None
    if tables is not None and rows is not None:
        rows = np.asarray(rows, np.int64)
        spans = tables["span"][rows]
        eidx_ofs = tables["gidx"][rows]
        noiso_arr = tables["noiso"][rows]
        exon_starts = tables["exon_starts"]
        exon_ends = tables["exon_ends"]
        exon_idx_flat = tables["exon_idx"]
    else:
        (spans, exon_starts, exon_ends, exon_idx_flat, eidx_ofs,
         noiso_arr) = _flat_exon_tables(genes)
    iso_ofs, isolen_all, nox_all = _gather_iso_tables(
        tables, rows, noiso_arr, genes, n)
    los = spans[:, 0] - 1   # 0-based region start (pipeline fetches lo-1)
    his = spans[:, 1]       # half-open end
    i0 = np.searchsorted(scan.pos, los - scan.max_span + 1, "left")
    i1 = np.searchsorted(scan.pos, his, "left")
    hit = native.match_classes_multi(
        i0, i1, los, scan.pos, scan.ref_end,
        scan.cigar_buf, scan.cigar_off,
        exon_starts, exon_ends, exon_idx_flat, eidx_ofs, noiso_arr,
        read_len, overhang, pos_offset=1)
    if hit is None:
        return None
    masks, counts, class_ofs, nreads = hit
    raw_all = isolen_all - read_len + 1 - 2 * (nox_all - 1) * (overhang - 1)
    efflen_all = np.maximum(raw_all, 0)
    isoscores_all, log_iso_w_all = _se_scores(raw_all, efflen_all)
    # per-read score with incompatible/-inf mapped to 0, so
    # log_read = weights * iso_clean (weights are {0,1})
    iso_clean = np.where(np.isfinite(isoscores_all), isoscores_all, 0.0)
    div_all = np.where(efflen_all != 0, efflen_all, 1).astype(np.float64)
    # ONE bitmask unpack for the whole chromosome: per-gene `(masks >>
    # shifts) & 1` numpy calls cost ~1s of the 50k-catalog compile wall;
    # gene g's (noiso, C_g) template block is a VIEW of this array
    # (row j of the full unpack is bit max_I-1-j, so a gene with fewer
    # isoforms starts at row max_I - noiso)
    max_I = int(noiso_arr.max()) if n else 0
    shifts_all = np.arange(max(max_I, 1) - 1, -1, -1,
                           dtype=np.uint64)[:, None]
    unp = ((masks[None, :] >> shifts_all) & 1).astype(np.float64)
    zero_mask = masks == 0
    out: List[Optional[CompiledEvent]] = []
    for g in range(n):
        gene = genes[g]
        nr = int(nreads[g])
        noiso = gene.num_isoforms
        if noiso < 2 or nr == 0 or nr < min_event_reads:
            out.append(None)
            continue
        c0, c1 = int(class_ofs[g]), int(class_ofs[g + 1])
        templates = unp[max_I - noiso:, c0:c1]
        classes = ReadClasses(templates=templates, counts=counts[c0:c1])
        # classes are in ascending bitmask order, so the one possible
        # all-incompatible class (mask 0; dropped from device tensors,
        # miso.c:65-66 -- see _event_from_classes) is always FIRST
        d0 = 1 if zero_mask[c0] else 0
        if c1 - c0 <= d0:
            out.append(None)  # no read compatible with any isoform
            continue
        # o0/o1: this gene's isoform rows (NOT the i0/i1 read-window
        # bounds defined above -- distinct names to avoid shadowing)
        o0, o1 = iso_ofs[g], iso_ofs[g + 1]
        if algorithm == "classes":
            out.append(_event_from_classes(
                gene, classes, True, nr, read_len, overhang, None,
                names[g], algorithm,
                scores=(efflen_all[o0:o1], isoscores_all[o0:o1],
                        log_iso_w_all[o0:o1])))
            continue
        weights = templates.T[d0:]          # (C_dev, I)
        if algorithm == "marginal":
            # match probabilities / effective length (miso.c:807-815)
            weights = weights / div_all[o0:o1][None, :]
            log_read = templates.T[d0:] * iso_clean[o0:o1][None, :]
        else:
            log_read = weights * iso_clean[o0:o1][None, :]
        out.append(CompiledEvent(
            name=names[g], gene=gene, num_iso=noiso, num_reads=nr,
            weights=weights, log_read=log_read,
            counts=counts[c0 + d0:c1],
            log_iso_w=log_iso_w_all[o0:o1],
            hyper=_ones_ro(noiso),
            classes=classes, paired=False, any_compatible=True))
    return out


def compile_paired_end(
    gene: Gene,
    positions: np.ndarray,
    cigars: Sequence[str],
    read_len: int,
    mean_frag_len: float,
    frag_variance: float,
    num_sds: float = 4.0,
    overhang: int = 1,
    frag_prob: Optional[np.ndarray] = None,
    frag_start: Optional[int] = None,
    hyper: Optional[np.ndarray] = None,
    name: str = "event",
) -> CompiledEvent:
    """Compile a paired-end event.  Ref: pysplicing/src/miso_paired.c:241-419.

    Mates must be consecutive (2r, 2r+1) in positions/cigars.
    """
    if overhang == 0:
        overhang = 1
    noiso = gene.num_isoforms
    if frag_prob is None:
        frag_prob, frag_start = normal_fragment(
            mean_frag_len, frag_variance, num_sds, read_len)
    frag_prob = np.asarray(frag_prob, dtype=np.float64)
    frag_prob = frag_prob / frag_prob.sum()
    il = len(frag_prob)

    match, frag_len = match_iso_paired(
        gene, positions, cigars, read_len, overhang, frag_prob, frag_start)
    classes = collapse_to_classes(match, frag_len)
    return _paired_event_from_classes(
        gene, classes, bool((match > 0).any()), len(positions) // 2,
        read_len, overhang, frag_prob, frag_start, hyper, name)


def _paired_event_from_classes(
    gene: Gene,
    classes: ReadClasses,
    any_comp: bool,
    num_pairs: int,
    read_len: int,
    overhang: int,
    frag_prob: np.ndarray,
    frag_start: int,
    hyper: Optional[np.ndarray],
    name: str,
    scores=None,
) -> CompiledEvent:
    """Everything in compile_paired_end after read-class collapse.
    `scores` = precomputed (isoscores, assscores) (the batch compiler
    vectorizes them across a whole chromosome's genes)."""
    noiso = gene.num_isoforms
    il = len(frag_prob)
    if scores is not None:
        isoscores, assscores = scores
    else:
        isolen = gene.iso_lengths
        nox = gene.iso_num_exons_all
        # lp[j, i] = isolen_i - fragStart - j + 1
        #            - 2*(nox_i-1)*(overhang-1)
        j = np.arange(il)[:, None]
        lp = (isolen[None, :] - frag_start - j + 1
              - 2 * (nox[None, :] - 1) * (overhang - 1))
        with np.errstate(divide="ignore", invalid="ignore"):
            # per-(fragLen, iso) read score. The reference adds the
            # linear fragment probability (miso_paired.c:403-411); we
            # use the correct log probability -- see sampler/model.py
            # module docstring.
            isoscores = np.where(
                lp > 0, -np.log(np.maximum(lp, 1e-300)), NEG_INF
            ) + np.log(frag_prob[:, None])
            assscores = np.log(np.sum(np.where(lp > 0, lp, 0), axis=0))

    templates = classes.templates.T  # (C, I) fragment-length probabilities
    fl = classes.frag_len.T          # (C, I)
    counts = classes.counts.astype(np.float64)
    # drop the all-incompatible class from device tensors (see the
    # single-end counterpart above; miso.c:65-66)
    compat = templates.any(axis=1)
    if not compat.all():
        templates = templates[compat]
        fl = fl[compat]
        counts = counts[compat]
    valid = fl >= 0
    fl_idx = np.clip(fl - frag_start, 0, il - 1)
    log_read = np.where(valid, isoscores[fl_idx, np.arange(noiso)[None, :]], 0.0)
    log_read = np.where(np.isfinite(log_read), log_read, 0.0)

    if hyper is None:
        hyper = _ones_ro(noiso)
    return CompiledEvent(
        name=name, gene=gene, num_iso=noiso, num_reads=num_pairs,
        weights=templates.astype(np.float64), log_read=log_read,
        counts=counts,
        log_iso_w=assscores, hyper=np.asarray(hyper, dtype=np.float64),
        classes=classes, paired=True,
        any_compatible=any_comp,
    )


def two_iso_event_from_counts(
    gene: Gene,
    ni: int, ne: int, nb: int,
    read_len: int,
    overhang: int = 1,
    name: str = "event",
) -> CompiledEvent:
    """Build a two-isoform event directly from NI/NE/NB read-category
    counts (inclusion-only, exclusion-only, both), the representation of
    the reference's legacy two-isoform path
    (misopy/read_simulator.py:390 read_counts_to_read_list +
    miso_sampler.py:469 run_sampler_on_event)."""
    assert gene.num_isoforms == 2
    templates = np.array([[1.0, 0.0, 1.0],
                          [0.0, 1.0, 1.0]])
    counts = np.array([ni, ne, nb], dtype=np.float64)
    classes = ReadClasses(templates=templates, counts=counts)
    efflen, raw = effective_lengths(gene, read_len, overhang)
    with np.errstate(divide="ignore"):
        isoscores = np.where(raw > 0, -np.log(np.maximum(raw, 1e-300)),
                             NEG_INF)
        log_iso_w = np.where(efflen > 0, np.log(np.maximum(efflen, 1)),
                             NEG_INF)
    weights = templates.T.copy()
    log_read = np.where(templates.T > 0, isoscores[None, :], 0.0)
    log_read = np.where(np.isfinite(log_read), log_read, 0.0)
    return CompiledEvent(
        name=name, gene=gene, num_iso=2, num_reads=int(ni + ne + nb),
        weights=weights, log_read=log_read, counts=counts,
        log_iso_w=log_iso_w, hyper=np.ones(2), classes=classes,
        paired=False, any_compatible=(ni + ne + nb) > 0)


# --------------------------------------------------------------------------
# Padding / batching
# --------------------------------------------------------------------------

def _round_up(x: int, candidates=(2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)) -> int:
    for c in candidates:
        if x <= c:
            return c
    return int(2 ** np.ceil(np.log2(max(x, 1))))


def _round_up_iso(x: int) -> int:
    """Pad granularity for the isoform axis: every Gibbs iteration pays
    O(I) passes over the (R, B) read tile, so a dead padded isoform is
    a full extra pass -- bucket 3-isoform events at exactly 3 (and 5-6
    at 6) instead of the next power of two.  The sampler kernels unroll
    I as Python lists, so no alignment constraint applies."""
    return _round_up(x, candidates=(2, 3, 4, 6, 8, 16, 32, 64))


def _round_up_reads(x: int) -> int:
    """Pad granularity for the per-read axis: every MCMC iteration pays
    O(R) device work, so padding waste is throughput loss (power-of-2
    rounding wastes up to 2x).  Multiples of 32 keep (R, B) tiles
    sublane-aligned for f32 AND bf16 while bounding the number of
    distinct compile shapes (<= 16 buckets below 512, <= 12 more below
    2048, then powers of two)."""
    if x <= 32:
        return 32
    if x <= 512:
        return int(-(-x // 32) * 32)
    if x <= 2048:
        return int(-(-x // 128) * 128)
    return int(2 ** np.ceil(np.log2(x)))


def pad_events(
    events: List[CompiledEvent],
    pad_iso: Optional[int] = None,
    pad_classes: Optional[int] = None,
    pad_reads: Optional[int] = None,
    dtype=np.float32,
    read_dtype=None,
    per_read: bool = True,
):
    """Pad a list of compiled events to common (C, I, R) and stack.

    Returns dict of numpy arrays matching sampler.mcmc.EventBatch fields.
    Padded classes have counts 0; padded isoforms have log_iso_w = -inf and
    are excluded by the sampler's masks; padded read slots carry class -1.

    The large per-read tensors (read_w / read_logscore) are stored in
    ``read_dtype`` (default float32, the width the CUDA kernel reads;
    the JAX package defaults to bfloat16 here).  The per-read log-score
    term cancels in the MH ratio and only shifts recorded
    log-likelihoods.

    ``per_read=False`` skips materializing the per-read tensors entirely
    (placeholder (E, 1, I) zeros): the per-class multinomial Gibbs
    (gibbs='multinomial') samples assignment counts from (C, I) class
    tensors, so a million-read event costs the same device memory and
    iteration work as a hundred-read one (see docs/DEEP_EVENTS.md).
    """
    E = len(events)
    if read_dtype is None:
        read_dtype = np.float32
    I = pad_iso or _round_up(max(ev.num_iso for ev in events))
    C = pad_classes or _round_up(max(max(ev.num_classes, 1) for ev in events))
    R = pad_reads or _round_up_reads(
        max(max(int(ev.counts.sum()), 1) for ev in events))
    if not per_read:
        R = 1
    weights = np.zeros((E, C, I), dtype)
    log_read = np.zeros((E, C, I), dtype)
    counts = np.zeros((E, C), dtype)
    log_iso_w = np.full((E, I), NEG_INF, dtype)
    hyper = np.ones((E, I), dtype)
    num_iso = np.zeros((E,), np.int32)
    read_w = np.zeros((E, R, I), read_dtype)
    read_logscore = np.zeros((E, R, I), read_dtype)
    for e, ev in enumerate(events):
        k, c = ev.num_iso, ev.num_classes
        weights[e, :c, :k] = ev.weights
        log_read[e, :c, :k] = ev.log_read
        counts[e, :c] = ev.counts
        log_iso_w[e, :k] = ev.log_iso_w
        hyper[e, :k] = ev.hyper
        num_iso[e] = k
        if per_read:
            # expand classes to per-read rows (static per event): the
            # device Gibbs step then needs no gathers
            # (see gibbs_reassign_perread)
            rc = np.repeat(np.arange(c, dtype=np.int64),
                           ev.counts.astype(np.int64))
            read_w[e, :len(rc), :k] = ev.weights[rc]
            read_logscore[e, :len(rc), :k] = ev.log_read[rc]
    return dict(weights=weights, log_read=log_read, counts=counts,
                log_iso_w=log_iso_w, hyper=hyper, num_iso=num_iso,
                read_w=read_w, read_logscore=read_logscore)


def bucket_events(
    events: List[CompiledEvent],
) -> List[Tuple[Tuple[int, int, int], List[int]]]:
    """Group event indices into (pad_iso, pad_classes, pad_reads) shape
    buckets, so jit recompiles only once per bucket shape."""
    buckets: dict = {}
    for idx, ev in enumerate(events):
        key = (_round_up_iso(ev.num_iso),
               _round_up(max(ev.num_classes, 1)),
               _round_up_reads(max(int(ev.counts.sum()), 1)))
        buckets.setdefault(key, []).append(idx)
    return sorted(buckets.items())
