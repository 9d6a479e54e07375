"""Native (C++) host kernels for the event compiler, loaded via ctypes.

The reference implements its host hot paths in C (pysplicing's
libsplicing); here the equivalents live in matchlib.cpp, compiled on
first use (cached next to the source) and dispatched from
miso_tpu_torch.core.matching.  A pure-numpy fallback is always available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "matchlib.cpp"),
         os.path.join(_DIR, "bamlib.cpp"),
         os.path.join(_DIR, "formatlib.cpp"),
         os.path.join(_DIR, "parselib.cpp")]
_SRC = _SRCS[0]  # kept for older callers
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _so_path() -> str:
    tag = sysconfig.get_platform().replace("-", "_")
    return os.path.join(_DIR, "libmisonative_%s.so" % tag)


def _build(so_path: str) -> bool:
    cxx = os.environ.get("CXX", "c++")
    cmd = [cxx, "-O2", "-shared", "-fPIC", "-std=c++17"] + _SRCS + [
        "-o", so_path + ".tmp"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(so_path + ".tmp", so_path)
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED
    # lock-free fast path checks ONLY _LIB: checking _TRIED here raced
    # a concurrent first load (T1 holds the lock mid-build with
    # _TRIED=True, T2 would return None and poison its scan)
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("MISO_NO_NATIVE") == "1":
            return None
        so = _so_path()
        src_mtime = max(os.path.getmtime(s) for s in _SRCS
                        if os.path.isfile(s))
        if not os.path.isfile(so) or src_mtime > os.path.getmtime(so):
            if not _build(so):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.miso_match_iso.restype = ctypes.c_int64
        lib.miso_match_iso.argtypes = [
            i64p, ctypes.c_int64,                 # positions
            ctypes.c_char_p, i64p,                # cigar buf + offsets
            i64p, i64p, i64p, ctypes.c_int64,     # exons
            ctypes.c_int64, ctypes.c_int64,       # read_len, overhang
            f64p,                                 # out
        ]
        # fused match+collapse: plain pointer args (the ndpointer
        # from_param/cast machinery measurably taxed the 10k-gene
        # compile profile at ~6 conversions per call)
        vp = ctypes.c_void_p
        lib.miso_match_classes.restype = ctypes.c_int64
        lib.miso_match_classes.argtypes = [
            vp, ctypes.c_int64,                   # positions
            ctypes.c_char_p, vp,                  # cigar buf + offsets
            vp, vp, vp, ctypes.c_int64,           # exons
            ctypes.c_int64, ctypes.c_int64,       # read_len, overhang
            vp, vp, ctypes.c_int64,               # out mask/count + cap
        ]
        lib.miso_match_classes_multi.restype = ctypes.c_int64
        lib.miso_match_classes_multi.argtypes = [
            vp, vp,                               # positions, ref_end
            ctypes.c_char_p, vp,                  # cigar buf + offsets
            ctypes.c_int64,                       # n_genes
            vp, vp, vp,                           # read_lo/hi, span_start
            vp, vp, vp, vp, vp,                   # exon tables + ofs/noiso
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            vp, vp, ctypes.c_int64,               # out mask/count + cap
            vp, vp,                               # class_ofs, nreads
        ]
        lib.miso_match_classes_paired_multi.restype = ctypes.c_int64
        lib.miso_match_classes_paired_multi.argtypes = [
            vp, vp, vp, vp,                       # p1, e1, p2, e2
            ctypes.c_char_p, vp, vp,              # cigar buf + co1/co2
            ctypes.c_int64,                       # n_genes
            vp, vp, vp, vp,                       # pair_lo/hi, span lo/hi
            vp, vp, vp, vp, vp,                   # exon tables + ofs/noiso
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            vp, ctypes.c_int64, ctypes.c_int64,   # frag_prob/start/il
            vp, vp, vp,                           # out fl/match/count
            ctypes.c_int64, ctypes.c_int64,       # caps
            vp, vp,                               # class_ofs, npairs
        ]
        lib.miso_genomic_to_iso.restype = None
        lib.miso_genomic_to_iso.argtypes = [
            i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int64, i64p]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.miso_bam_scan.restype = ctypes.c_int64
        lib.miso_bam_scan.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # buf
            i64p,                                 # rec_off
            i32p, i32p, i32p, i32p, i32p, i32p,   # fixed fields + ref_end
            i64p, i32p,                           # qname off/len
            ctypes.c_void_p, ctypes.c_int64, i64p,  # cigar buf/cap/off
            ctypes.POINTER(ctypes.c_int64),       # consumed
        ]
        lib.miso_pair_qnames.restype = ctypes.c_int64
        lib.miso_pair_qnames.argtypes = [
            u8p, ctypes.c_int64,                  # qname byte buffer
            i64p, i32p,                           # qname off/len
            i64p,                                 # partner (out)
        ]
        lib.miso_format_quantized.restype = ctypes.c_int64
        lib.miso_format_quantized.argtypes = [
            i64p, ctypes.c_int64, ctypes.c_int64,  # q, S, I
            i64p, u8p,                             # cents, neg
            u8p, i64p,                             # out, off
        ]
        lib.miso_parse_samples.restype = ctypes.c_int64
        lib.miso_parse_samples.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,       # buf
            f64p, ctypes.c_int64,                  # out, max_vals
            ctypes.POINTER(ctypes.c_int64),        # ncols
        ]
        _LIB = lib
        return _LIB


class BamScan:
    """Columnar result of one native scan over a decompressed window."""

    __slots__ = ("n", "rec_off", "ref_id", "pos", "flag", "mapq", "l_seq",
                 "ref_end", "qname_off", "qname_len", "cigar_buf",
                 "cigar_off", "consumed")

    def __init__(self, n, rec_off, ref_id, pos, flag, mapq, l_seq,
                 ref_end, qname_off, qname_len, cigar_buf, cigar_off,
                 consumed):
        self.n = n
        self.rec_off = rec_off
        self.ref_id = ref_id
        self.pos = pos
        self.flag = flag
        self.mapq = mapq
        self.l_seq = l_seq
        self.ref_end = ref_end
        self.qname_off = qname_off
        self.qname_len = qname_len
        self.cigar_buf = cigar_buf
        self.cigar_off = cigar_off
        self.consumed = consumed

    def cigar_str(self, i: int) -> str:
        # cigar strings are NUL-terminated in the packed buffer
        return self.cigar_buf[self.cigar_off[i]:
                              self.cigar_off[i + 1] - 1].decode()


def bam_scan(buf, start: int = 0,
             max_records: Optional[int] = None) -> Optional[BamScan]:
    """Decode size-prefixed BAM records from a decompressed byte window
    into columnar arrays; None if the native library is unavailable.
    Raises ValueError on structurally corrupt records."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(buf, dtype=np.uint8)
    n = buf.shape[0]
    cap = max(max_records if max_records is not None
              else (n - start) // 36 + 1, 1)
    rec_off = np.empty(cap, np.int64)
    i32 = lambda: np.empty(cap, np.int32)  # noqa: E731
    ref_id, pos, flag, mapq, l_seq, ref_end = (
        i32(), i32(), i32(), i32(), i32(), i32())
    qname_off = np.empty(cap, np.int64)
    qname_len = i32()
    # 11 bytes/op worst case; records have >= 1 op slot each.
    # np.empty, not ctypes.create_string_buffer: the latter ZEROES the
    # buffer (a full extra pass over ~3 bytes/op at catalog scale)
    cigar_cap = max(int(n - start) * 3 + 16, 1024)
    cigar_arr = np.empty(cigar_cap, np.uint8)
    cigar_off = np.empty(cap + 1, np.int64)
    consumed = ctypes.c_int64(0)
    cnt = lib.miso_bam_scan(
        buf, n, start, cap, rec_off, ref_id, pos, flag, mapq, l_seq,
        ref_end, qname_off, qname_len, cigar_arr.ctypes.data, cigar_cap,
        cigar_off, ctypes.byref(consumed))
    if cnt < 0:
        raise ValueError("corrupt BAM record in scan window")
    used = int(cigar_off[cnt]) if cnt > 0 else 0
    return BamScan(int(cnt), rec_off[:cnt], ref_id[:cnt], pos[:cnt],
                   flag[:cnt], mapq[:cnt], l_seq[:cnt], ref_end[:cnt],
                   qname_off[:cnt], qname_len[:cnt],
                   cigar_arr[:used].tobytes(),
                   cigar_off[:cnt + 1],
                   int(consumed.value))


def _packed_cigars(cigars, n: int):
    """(cigar_buf bytes, offsets int64 array) from either a PackedCigars
    (zero-copy) or a sequence of strings (one joined encode)."""
    if hasattr(cigars, "buf") and hasattr(cigars, "offsets"):
        return cigars.buf, np.ascontiguousarray(cigars.offsets, np.int64)
    if n:
        # ONE encode of the whole join (per-read str.encode calls
        # dominated the event-compile profile), then vectorized offset
        # recovery from the NUL separators
        cigar_buf = ("\x00".join(cigars) + "\x00").encode()
        nuls = np.flatnonzero(np.frombuffer(cigar_buf, np.uint8) == 0)
        offsets = np.concatenate([np.zeros(1, np.int64), nuls[:-1] + 1])
        return cigar_buf, offsets
    return b"", np.zeros(0, np.int64)


def _flat_exons(gene):
    """Flat (exon_starts, exon_ends, exon_idx) tables for the native
    matchers (cached on the gene; warmed at index time)."""
    return gene.flat_exons()


def match_iso_native(gene, positions: np.ndarray, cigars,
                     read_len: int, overhang: int) -> Optional[np.ndarray]:
    """Native match matrix; None if the library is unavailable.

    `cigars` is either a sequence of strings or a PackedCigars-style
    object (``.buf`` NUL-terminated bytes + ``.offsets``), which the
    matcher consumes zero-copy -- the whole-chromosome columnar ingest
    path never materializes per-read strings."""
    lib = load()
    if lib is None:
        return None
    noiso = gene.num_isoforms
    n = len(positions)
    positions = np.ascontiguousarray(positions, dtype=np.int64)
    cigar_buf, offsets = _packed_cigars(cigars, n)
    exon_starts, exon_ends, exon_idx = _flat_exons(gene)
    out = np.zeros((noiso, n), dtype=np.float64)
    rc = lib.miso_match_iso(
        positions, n, cigar_buf, offsets,
        exon_starts, exon_ends, exon_idx, noiso,
        read_len, overhang, out)
    if rc != 0:
        from miso_tpu_torch.core.cigar import CigarError
        raise CigarError("Bad CIGAR string in native matcher")
    return out


def match_classes_native(gene, positions: np.ndarray, cigars,
                         read_len: int, overhang: int):
    """Fused match + class collapse for a single-end event.

    Returns (templates (I, C) float64 {0,1}, counts (C,) float64) with
    classes in ascending bitmask order -- byte-identical to
    core/matching.py::collapse_to_classes(match_iso(...)) -- without
    ever materializing the (I, R) match matrix.  None if the native
    library is unavailable or noiso > 62 (bitmask key width).
    Ref: pysplicing/src/solve.c:8-108 + miso_paired.c:576-619.
    """
    lib = load()
    noiso = gene.num_isoforms
    if lib is None or noiso > 62:
        return None
    n = len(positions)
    positions = np.ascontiguousarray(positions, dtype=np.int64)
    cigar_buf, offsets = _packed_cigars(cigars, n)
    exon_starts, exon_ends, exon_idx = _flat_exons(gene)
    cap = n + 1
    out_mask = np.empty(cap, np.uint64)
    out_count = np.empty(cap, np.int64)
    nc = lib.miso_match_classes(
        positions.ctypes.data, n, cigar_buf, offsets.ctypes.data,
        exon_starts.ctypes.data, exon_ends.ctypes.data,
        exon_idx.ctypes.data, noiso, read_len, overhang,
        out_mask.ctypes.data, out_count.ctypes.data, cap)
    if nc == -1:
        from miso_tpu_torch.core.cigar import CigarError
        raise CigarError("Bad CIGAR string in native matcher")
    if nc < 0:
        return None
    shifts = np.arange(noiso - 1, -1, -1, dtype=np.uint64)
    templates = ((out_mask[None, :nc] >> shifts[:, None]) & 1
                 ).astype(np.float64)
    return templates, out_count[:nc].astype(np.float64)


def match_classes_multi(read_lo, read_hi, span_start,
                        positions, ref_end, cigar_buf, cigar_offsets,
                        exon_starts, exon_ends, exon_idx_flat,
                        eidx_ofs, noiso_arr,
                        read_len: int, overhang: int, pos_offset: int = 1):
    """Whole-chromosome batch match+collapse: ONE native call compiles
    read classes for every gene against the chromosome's columnar read
    pool (ChromReads arrays).  Gene g considers reads
    [read_lo[g], read_hi[g]) with ref_end > span_start[g] -- exactly
    ChromReads.slice's region mask.  Gene g's exon_idx block starts at
    exon_idx_flat[eidx_ofs[g]] (noiso_arr[g]+1 global entries) -- the
    layout of the index's precomputed compile tables.

    Returns (masks (uint64 flat), counts (float64 flat), class_ofs
    (n_genes+1,), nreads (n_genes,)) or None if unavailable.
    """
    lib = load()
    if lib is None:
        return None
    n_genes = len(read_lo)
    if noiso_arr.size and noiso_arr.max() > 62:
        return None
    exon_starts = np.ascontiguousarray(exon_starts, np.int64)
    exon_ends = np.ascontiguousarray(exon_ends, np.int64)
    exon_idx_flat = np.ascontiguousarray(exon_idx_flat, np.int64)
    eidx_ofs = np.ascontiguousarray(eidx_ofs, np.int64)
    noiso_arr = np.ascontiguousarray(noiso_arr, np.int64)
    read_lo = np.ascontiguousarray(read_lo, np.int64)
    read_hi = np.ascontiguousarray(read_hi, np.int64)
    span_start = np.ascontiguousarray(span_start, np.int64)
    positions = np.ascontiguousarray(positions, np.int64)
    ref_end = np.ascontiguousarray(ref_end, np.int64)
    cigar_offsets = np.ascontiguousarray(cigar_offsets, np.int64)
    cap = int((read_hi - read_lo).sum()) + n_genes
    out_mask = np.empty(cap, np.uint64)
    out_count = np.empty(cap, np.int64)
    class_ofs = np.empty(n_genes + 1, np.int64)
    nreads = np.empty(n_genes, np.int64)
    rc = lib.miso_match_classes_multi(
        positions.ctypes.data, ref_end.ctypes.data,
        cigar_buf, cigar_offsets.ctypes.data, n_genes,
        read_lo.ctypes.data, read_hi.ctypes.data, span_start.ctypes.data,
        exon_starts.ctypes.data, exon_ends.ctypes.data,
        exon_idx_flat.ctypes.data, eidx_ofs.ctypes.data,
        noiso_arr.ctypes.data,
        read_len, overhang, pos_offset,
        out_mask.ctypes.data, out_count.ctypes.data, cap,
        class_ofs.ctypes.data, nreads.ctypes.data)
    if rc == -1:
        from miso_tpu_torch.core.cigar import CigarError
        raise CigarError("Bad CIGAR string in native matcher")
    if rc != 0:
        return None
    n_cls = int(class_ofs[n_genes])
    return (out_mask[:n_cls], out_count[:n_cls].astype(np.float64),
            class_ofs, nreads)


def match_classes_paired_multi(pair_lo, pair_hi, span_start, span_end,
                               p1, e1, p2, e2, cigar_buf, co1, co2,
                               exon_starts, exon_ends, exon_idx_flat,
                               eidx_ofs, noiso_arr,
                               read_len: int, overhang: int,
                               frag_prob, frag_start: int,
                               pos_offset: int = 1):
    """Whole-chromosome batch paired match+collapse (ChromPairs arrays).

    Returns (fl_flat int64, match_flat float64, counts float64,
    class_ofs (n_genes+1,), npairs (n_genes,)) -- gene g's class c is
    noiso_arr[g] consecutive entries of the flat streams -- or None if
    the native library is unavailable.  A class is keyed by its
    fragment-length vector, not by an isoform bitmask, so a gene may
    have any number of isoforms.
    """
    lib = load()
    if lib is None:
        return None
    n_genes = len(pair_lo)
    noiso_arr = np.ascontiguousarray(noiso_arr, np.int64)
    c = lambda a: np.ascontiguousarray(a, np.int64)  # noqa: E731
    pair_lo, pair_hi = c(pair_lo), c(pair_hi)
    span_start, span_end = c(span_start), c(span_end)
    p1, e1, p2, e2 = c(p1), c(e1), c(p2), c(e2)
    co1, co2 = c(co1), c(co2)
    exon_starts, exon_ends = c(exon_starts), c(exon_ends)
    exon_idx_flat, eidx_ofs = c(exon_idx_flat), c(eidx_ofs)
    frag_prob = np.ascontiguousarray(frag_prob, np.float64)
    il = len(frag_prob)
    tot_pairs = int((pair_hi - pair_lo).sum())
    cap_classes = tot_pairs + n_genes
    # a gene has at most one class a pair (plus one), each of its own
    # width: one wide gene does not widen every other gene's room
    cap_entries = int(((pair_hi - pair_lo + 1) * noiso_arr).sum())
    out_fl = np.empty(cap_entries, np.int64)
    out_match = np.empty(cap_entries, np.float64)
    out_count = np.empty(cap_classes, np.int64)
    class_ofs = np.empty(n_genes + 1, np.int64)
    npairs = np.empty(n_genes, np.int64)
    rc = lib.miso_match_classes_paired_multi(
        p1.ctypes.data, e1.ctypes.data, p2.ctypes.data, e2.ctypes.data,
        cigar_buf, co1.ctypes.data, co2.ctypes.data, n_genes,
        pair_lo.ctypes.data, pair_hi.ctypes.data,
        span_start.ctypes.data, span_end.ctypes.data,
        exon_starts.ctypes.data, exon_ends.ctypes.data,
        exon_idx_flat.ctypes.data, eidx_ofs.ctypes.data,
        noiso_arr.ctypes.data, read_len, overhang, pos_offset,
        frag_prob.ctypes.data, frag_start, il,
        out_fl.ctypes.data, out_match.ctypes.data, out_count.ctypes.data,
        cap_classes, cap_entries, class_ofs.ctypes.data,
        npairs.ctypes.data)
    if rc == -1:
        from miso_tpu_torch.core.cigar import CigarError
        raise CigarError("Bad CIGAR string in native matcher")
    if rc != 0:
        return None
    return out_fl, out_match, out_count.astype(np.float64), class_ofs, \
        npairs


def pair_qnames(buf, qname_off, qname_len):
    """partner[i] = index of record i's mate, or -1.

    Native mate pairing over packed qname bytes: trailing /1 /2 #1 #2
    mate ids are stripped, and ONLY names occurring exactly twice pair
    (reference dict semantics, misopy/sam_utils.py:210-289).  Returns
    None if the native library is unavailable.
    """
    lib = load()
    if lib is None:
        return None
    buf = np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8))
    qname_off = np.ascontiguousarray(qname_off, np.int64)
    qname_len = np.ascontiguousarray(qname_len, np.int32)
    n = len(qname_off)
    partner = np.empty(n, np.int64)
    rc = lib.miso_pair_qnames(buf, n, qname_off, qname_len, partner)
    if rc < 0:
        return None
    return partner


def format_quantized(q: np.ndarray, cents: np.ndarray,
                     neg: np.ndarray):
    """Native .miso sample-block formatter (formatlib.cpp): quantized
    psi ticks (S, I) + score centipoints (S,) -> (bytes, offsets) with
    offsets[s] the start of line s.  None if the library is
    unavailable (callers fall back to the numpy formatter)."""
    lib = load()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, np.int64)
    S, I = q.shape
    cents = np.ascontiguousarray(cents, np.int64)
    neg = np.ascontiguousarray(neg, np.uint8)
    out = np.empty(S * (7 * int(I) + 30), np.uint8)
    off = np.empty(S + 1, np.int64)
    total = lib.miso_format_quantized(q.reshape(-1), S, I, cents, neg,
                                      out, off)
    return out[:total].tobytes(), off


def parse_samples(data: bytes):
    """Native .miso sample-block parser (parselib.cpp): the bytes AFTER
    the two header lines -> (samples (S, I), scores (S,)) float64.
    Releases the GIL, so catalog-scale summarize/compare loads scale
    across threads.  None if the library is unavailable or the block
    is ragged/malformed (callers use the Python parser then)."""
    lib = load()
    if lib is None or not data:
        return None
    max_vals = len(data) // 2 + 8
    out = np.empty(max_vals, np.float64)
    ncols = ctypes.c_int64(0)
    n = lib.miso_parse_samples(data, len(data), out, max_vals,
                               ctypes.byref(ncols))
    nc = int(ncols.value)
    if n <= 0 or nc < 2 or n % nc:
        return None
    arr = out[:n].reshape(-1, nc)
    return arr[:, :-1].copy(), arr[:, -1].copy()
