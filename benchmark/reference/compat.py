"""Read classes of one gene, worked out again from the generated reads and
gene models: which isoforms each read (or pair) is compatible with, and
for a pair the fragment length it implies on each.

A plain NumPy reading of MISO's model (Katz et al., Nat. Methods 2010;
pysplicing solve.c): a read matches an isoform when every aligned block
lies in one of its exons and consecutive blocks meet consecutive exons
at their ends; a pair matches when both mates match, and its fragment
length on the isoform, from the first mate's start to the second mate's
end in transcript coordinates, lies in the insert-length support.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def read_compat(bs: np.ndarray, bl: np.ndarray, st: np.ndarray,
                en: np.ndarray) -> np.ndarray:
    """(R,) bool: do reads with blocks (bs 1-based starts, bl lengths, 0
    past the last block) match the isoform with exons [st, en]?"""
    X = len(st)
    x0 = np.searchsorted(st, bs[:, 0], side="right") - 1
    ok = x0 >= 0
    for b in range(bs.shape[1]):
        has = bl[:, b] > 0
        xb = x0 + b
        xs = np.clip(xb, 0, X - 1)
        end = bs[:, b] + bl[:, b] - 1
        good = (xb < X) & (bs[:, b] >= st[xs]) & (end <= en[xs])
        if b > 0:
            prev = np.clip(xb - 1, 0, X - 1)
            good &= ((bs[:, b - 1] + bl[:, b - 1] - 1) == en[prev]) & (
                bs[:, b] == st[xs])
        ok &= ~has | good
    return ok


def transcript_pos(gpos: np.ndarray, st: np.ndarray, en: np.ndarray
                   ) -> np.ndarray:
    """0-based transcript offset of genomic positions inside the
    isoform's exons."""
    ln = en - st + 1
    t_off = np.concatenate([[0], np.cumsum(ln)[:-1]])
    x = np.clip(np.searchsorted(st, gpos, side="right") - 1, 0, len(st) - 1)
    return t_off[x] + gpos - st[x]


def gene_reads(sample, g: int) -> np.ndarray:
    """Indices of gene g's reads."""
    return np.flatnonzero(sample.reads.gene == g)


def class_keys(sample, g: int) -> np.ndarray:
    """(units, I) int class keys of gene g: single-end 1/0 compatibility;
    paired-end the fragment length on each isoform, -1 where the pair
    does not match it."""
    m = sample.models
    r = sample.reads
    idx = gene_reads(sample, g)
    I = m.num_iso(g)
    cfg = sample.config["reads"]
    if not cfg["paired_end"]:
        keys = np.zeros((len(idx), I), np.int64)
        for j in range(I):
            st, en = m.exons(g, j)
            keys[:, j] = read_compat(r.block_start[idx], r.block_len[idx],
                                     st, en)
        return keys
    from generate import fragment_pmf
    lens, _ = fragment_pmf(sample.config)
    rl = cfg["read_len"]
    order = np.lexsort((r.mate[idx], r.pair[idx]))
    idx = idx[order]
    first, second = idx[0::2], idx[1::2]
    if not (r.pair[first] == r.pair[second]).all():
        raise ValueError("gene %d has an unpaired mate" % g)
    keys = np.full((len(first), I), -1, np.int64)
    for j in range(I):
        st, en = m.exons(g, j)
        ok = (read_compat(r.block_start[first], r.block_len[first], st, en)
              & read_compat(r.block_start[second], r.block_len[second],
                            st, en))
        frag = (transcript_pos(r.block_start[second, 0], st, en)
                - transcript_pos(r.block_start[first, 0], st, en) + rl)
        ok &= (frag >= lens[0]) & (frag <= lens[-1])
        keys[ok, j] = frag[ok]
    return keys


def classes(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(distinct keys (C, I), counts (C,))."""
    if len(keys) == 0:
        return keys.reshape(0, keys.shape[1]), np.zeros(0, np.int64)
    uniq, counts = np.unique(keys, axis=0, return_counts=True)
    return uniq, counts


def class_table(keys: np.ndarray, counts: np.ndarray
                ) -> Dict[Tuple[int, ...], int]:
    """{class key: reads}, classes of one key summed, the all-incompatible
    class (no isoform matched) left out: the program keeps or drops it as
    the path it takes decides, and it carries no term of the posterior."""
    out: Dict[Tuple[int, ...], int] = {}
    for k, n in zip(map(tuple, np.asarray(keys).tolist()),
                    np.asarray(counts).tolist()):
        if any(v > 0 for v in k) and n:
            out[k] = out.get(k, 0) + int(n)
    return out


def header_classes(sample, keys: np.ndarray, counts: np.ndarray
                   ) -> Dict[Tuple[int, ...], int]:
    """The classes as a ``counts=`` field lists them: the match value of
    each isoform cast to an integer (1/0 single-end; a pair's normalised
    fragment probability, so 0 for every pair), with the reads of classes
    that print alike summed."""
    if sample.config["reads"]["paired_end"]:
        from generate import fragment_pmf
        lens, p = fragment_pmf(sample.config)
        vals = np.where(keys >= 0, p[np.clip(keys - lens[0], 0, len(p) - 1)],
                        0.0).astype(np.int64)
    else:
        vals = keys
    out: Dict[Tuple[int, ...], int] = {}
    for v, n in zip(map(tuple, vals.tolist()), counts.tolist()):
        out[v] = out.get(v, 0) + int(n)
    return out
