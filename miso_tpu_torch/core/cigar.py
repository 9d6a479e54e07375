"""CIGAR string parsing with the reference engine's exact semantics.

Behavior parity with pysplicing/src/solve.c:220-306 (splicing_parse_cigar):

- ``M`` and ``=`` are matches; runs are truncated so the cumulative matched
  length never exceeds ``max_read_len`` (when positive).
- ``N`` is an intron skip, encoded as a negative run.
- ``X`` (mismatch), ``D`` (deletion), ``S``/``H`` (clips) are *counted as
  matching* (same truncation rule).
- ``I`` (insertion) is ignored entirely.
- ``S``/``H`` may only appear at the beginning/end; anything else raises.
- Any other op raises.

The numeric encoding is a signed run-length list: positive = consume exon
sequence, negative = skip intron.
"""
from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

# ops that count as "matching" (consume reference as exon sequence)
_MATCHLIKE = frozenset("M=XSHD")


class CigarError(ValueError):
    pass


def parse_cigar(cigar: str, max_read_len: int = 0) -> Tuple[Tuple[int, ...], int]:
    """Parse one CIGAR string into (numeric_runs, matched_length).

    Ref: pysplicing/src/solve.c:220-306.
    """
    runs: List[int] = []
    length = 0
    mode = 0  # 0: begin, 1: middle, 2: end  (solve.c:234)
    pos = 0
    for m in _CIGAR_RE.finditer(cigar):
        if m.start() != pos:
            raise CigarError("Bad CIGAR string: %r" % cigar)
        pos = m.end()
        l = int(m.group(1))
        op = m.group(2)
        if op == "P":
            raise CigarError(
                "Unsupported CIGAR string (`MNSHDI=X' are supported)")
        if mode == 0 and op not in "SH":
            mode = 1
        elif mode == 1 and op in "SH":
            mode = 2
        elif mode == 2 and op not in "SH":
            raise CigarError(
                "Bad CIGAR string: `S' and 'H' may appear only at the "
                "beginning and the end")
        if op == "N":
            runs.append(-l)
        elif op == "I":
            pass  # ignored (solve.c:290-294)
        elif op in _MATCHLIKE:
            if max_read_len > 0 and length + l > max_read_len:
                l = max_read_len - length
            runs.append(l)
            length += l
        else:  # pragma: no cover - regex restricts ops
            raise CigarError("Unsupported CIGAR op %r" % op)
    if pos != len(cigar):
        raise CigarError("Bad CIGAR string: %r" % cigar)
    return tuple(runs), length


def parse_cigars(
    cigars: Sequence[str], max_read_len: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse many CIGARs into a flat runs array + offsets + lengths.

    Returns (runs, offsets, lengths) where runs[offsets[i]:offsets[i+1]] are
    read i's signed runs and lengths[i] its matched length.
    """
    all_runs: List[int] = []
    offsets = np.zeros(len(cigars) + 1, dtype=np.int64)
    lengths = np.zeros(len(cigars), dtype=np.int64)
    cache: dict = {}
    for i, c in enumerate(cigars):
        hit = cache.get(c)
        if hit is None:
            hit = parse_cigar(c, max_read_len)
            cache[c] = hit
        runs, ln = hit
        all_runs.extend(runs)
        offsets[i + 1] = len(all_runs)
        lengths[i] = ln
    return np.array(all_runs, dtype=np.int64), offsets, lengths


def cigar_from_runs(runs: Sequence[int]) -> str:
    """Inverse: numeric runs -> ``xMyNzM`` style CIGAR (simulator output).

    Ref: pysplicing/src/simulator.c:161-187 emits this format.
    """
    out = []
    for r in runs:
        if r >= 0:
            out.append("%dM" % r)
        else:
            out.append("%dN" % (-r))
    return "".join(out)
