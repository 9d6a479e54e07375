"""In-memory gene / isoform / exon model.

Capability parity with the reference gene model (misopy/Gene.py:114-843 and
the struct-of-arrays C container pysplicing/src/gff.c), redesigned around
flat numpy arrays so the host-side event compiler can vectorize over reads.

Coordinates are 1-based inclusive genomic positions throughout, matching the
reference C engine (the Python layer of the reference shifts 0-based pysam
positions by +1 before calling C; see misopy/miso_sampler.py:284).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Exon:
    """A genomic interval (1-based, inclusive). Ref: misopy/Gene.py:52-88."""

    start: int
    end: int
    label: Optional[str] = None

    @property
    def len(self) -> int:
        return self.end - self.start + 1


@dataclass
class Isoform:
    """An isoform: ordered exon parts of a gene. Ref: misopy/Gene.py:694-843."""

    parts: Tuple[int, ...]  # indices into Gene.parts, 5'->3' in genomic order
    label: Optional[str] = None
    desc: Optional[object] = None  # printable description (str or list)

    def __len__(self) -> int:
        return len(self.parts)


@dataclass
class Gene:
    """A gene: unique exon parts plus isoforms referencing them.

    Ref: misopy/Gene.py:114-691.  ``parts`` are sorted by (start, end); each
    isoform is a tuple of part indices.
    """

    parts: List[Exon]
    isoforms: List[Isoform]
    label: Optional[str] = None
    chrom: Optional[str] = None
    strand: Optional[str] = None
    # cached per-isoform exon arrays
    _exon_cache: dict = field(default_factory=dict, repr=False)

    # ---------------------------------------------------------------- basics
    @property
    def num_isoforms(self) -> int:
        return len(self.isoforms)

    def iso_exons(self, iso: int) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, ends) arrays of exon coordinates of isoform `iso`,
        sorted by genomic start (the order the matcher walks them;
        ref: pysplicing/src/gff.c:728-779 keeps exons in file order, which
        the reference GFFs list in ascending genomic order)."""
        hit = self._exon_cache.get(iso)
        if hit is not None:
            return hit
        ex = sorted(
            (self.parts[p] for p in self.isoforms[iso].parts),
            key=lambda e: (e.start, e.end),
        )
        starts = np.array([e.start for e in ex], dtype=np.int64)
        ends = np.array([e.end for e in ex], dtype=np.int64)
        self._exon_cache[iso] = (starts, ends)
        return starts, ends

    def iso_length(self, iso: int) -> int:
        """Sum of exon lengths. Ref: pysplicing/src/gff.c:689-709."""
        starts, ends = self.iso_exons(iso)
        return int(np.sum(ends - starts + 1))

    def iso_num_exons(self, iso: int) -> int:
        return len(self.iso_exons(iso)[0])

    @property
    def iso_lengths(self) -> np.ndarray:
        hit = self._exon_cache.get("__iso_lengths__")
        if hit is None:
            hit = np.array(
                [self.iso_length(i) for i in range(self.num_isoforms)],
                dtype=np.int64)
            self._exon_cache["__iso_lengths__"] = hit
        return hit

    @property
    def iso_num_exons_all(self) -> np.ndarray:
        hit = self._exon_cache.get("__iso_num_exons__")
        if hit is None:
            hit = np.array(
                [self.iso_num_exons(i) for i in range(self.num_isoforms)],
                dtype=np.int64)
            self._exon_cache["__iso_num_exons__"] = hit
        return hit

    def flat_exons(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flat (exon_starts, exon_ends, exon_idx) tables across all
        isoforms -- the layout the native matchers consume (isoform i's
        exons are rows exon_idx[i]..exon_idx[i+1]).  Cached on the gene;
        index_gff warms it before pickling so catalog compiles skip the
        per-isoform Python assembly entirely."""
        hit = self._exon_cache.get("__flat__")
        if hit is not None:
            return hit
        starts_l, ends_l, idx = [], [], [0]
        for i in range(self.num_isoforms):
            s, e = self.iso_exons(i)
            starts_l.append(s)
            ends_l.append(e)
            idx.append(idx[-1] + len(s))
        out = (np.ascontiguousarray(
                   np.concatenate(starts_l) if starts_l
                   else np.zeros(0, np.int64), np.int64),
               np.ascontiguousarray(
                   np.concatenate(ends_l) if ends_l
                   else np.zeros(0, np.int64), np.int64),
               np.asarray(idx, dtype=np.int64))
        self._exon_cache["__flat__"] = out
        return out

    def genomic_span(self) -> Tuple[int, int]:
        lo = min(p.start for p in self.parts)
        hi = max(p.end for p in self.parts)
        return lo, hi

    def iso_genomic_span(self, iso: int) -> Tuple[int, int]:
        starts, ends = self.iso_exons(iso)
        return int(starts[0]), int(ends[-1])

    # ------------------------------------------------- coordinate conversion
    def genomic_to_iso(self, iso: int, pos: np.ndarray) -> np.ndarray:
        """Convert genomic positions to 1-based isoform coordinates.

        Positions falling in introns (or outside) map to -1.
        Ref: pysplicing/src/gff.c genomic_to_iso (:1041-1160).
        """
        starts, ends = self.iso_exons(iso)
        pos = np.asarray(pos, dtype=np.int64)
        lens = ends - starts + 1
        cum = np.concatenate([[0], np.cumsum(lens)])  # offset of each exon
        # exon index of each position: last exon with start <= pos
        ei = np.searchsorted(starts, pos, side="right") - 1
        ei_c = np.clip(ei, 0, len(starts) - 1)
        inside = (ei >= 0) & (pos <= ends[ei_c]) & (pos >= starts[ei_c])
        out = cum[ei_c] + (pos - starts[ei_c]) + 1
        return np.where(inside, out, -1)

    def iso_to_genomic(self, iso: int, ipos: np.ndarray) -> np.ndarray:
        """Convert 1-based isoform coordinates to genomic positions (-1 if
        out of range). Ref: pysplicing/src/gff.c iso_to_genomic (:855-1040)."""
        starts, ends = self.iso_exons(iso)
        ipos = np.asarray(ipos, dtype=np.int64)
        lens = ends - starts + 1
        cum = np.concatenate([[0], np.cumsum(lens)])
        ei = np.searchsorted(cum, ipos, side="left") - 1
        ei = np.where((ipos >= 1) & (ei < len(starts)), ei, -1)
        ei_c = np.clip(ei, 0, len(starts) - 1)
        out = starts[ei_c] + (ipos - cum[ei_c]) - 1
        return np.where(ei >= 0, out, -1)

    # ------------------------------------------------------------ describers
    def iso_desc_str(self, iso: int) -> str:
        d = self.isoforms[iso].desc
        if d is None:
            d = self.isoforms[iso].label or "iso%d" % iso
        if isinstance(d, (list, tuple)):
            return "_".join(str(x) for x in d)
        return str(d)


def make_gene(
    part_lens: Sequence[int],
    isoform_parts: Sequence[Sequence[int]],
    chrom: Optional[str] = None,
    strand: Optional[str] = None,
    label: str = "gene",
    offset: int = 1,
) -> Gene:
    """Build a synthetic gene from consecutive exon lengths and 1-based part
    lists per isoform.  Mirrors misopy/Gene.py:1019-1039 (make_gene), the
    constructor used by the reference's own smoke tests.
    """
    parts = []
    pos = offset
    for i, ln in enumerate(part_lens):
        parts.append(Exon(pos, pos + ln - 1, label="p%d" % (i + 1)))
        pos += ln
    isoforms = [
        Isoform(tuple(p - 1 for p in ip), label="iso%d" % k, desc="iso%d" % k)
        for k, ip in enumerate(isoform_parts)
    ]
    return Gene(parts=parts, isoforms=isoforms, label=label, chrom=chrom,
                strand=strand)
