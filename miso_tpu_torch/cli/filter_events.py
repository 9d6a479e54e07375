"""`filter_events` -- post-hoc filtering of `.miso_bf` comparison tables.

Capability parity: misopy/filter_events.py (single-table thresholds
:241-330; multi-replicate voting `multi_filter` :83-186 via `--votes`).
Two-isoform count filters only, as in the reference.

The counts= strings are Python dict-literal bodies
(`(0,0):278,(0,1):2513,(1,1):798`, written by miso_sampler.py:418-421),
so they are parsed with ast.literal_eval rather than the reference's
regex walk.
"""
from __future__ import annotations

import argparse
import ast
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

MAX_BF = 1e12

# class keys in a two-isoform counts dict
_INC, _EXC, _BOTH = (1, 0), (0, 1), (1, 1)


def get_counts(counts_str: str) -> Optional[Tuple[int, int, int]]:
    """(inclusion, exclusion, both) read counts from a counts= field;
    None when unparseable or not a two-isoform event
    (the contract of filter_events.py:27-59).  Multi-isoform count
    strings are rejected BY DESIGN, exactly as the reference's
    count-based filters are two-isoform-only -- events with >2 isoforms
    pass through count filters unfiltered."""
    try:
        class_counts = ast.literal_eval("{%s}" % counts_str)
    except (ValueError, SyntaxError):
        return None
    if not isinstance(class_counts, dict) or not class_counts:
        return None
    keys = list(class_counts)
    if not all(isinstance(k, tuple) for k in keys) or len(keys[0]) != 2:
        return None
    return (class_counts.get(_INC, 0), class_counts.get(_EXC, 0),
            class_counts.get(_BOTH, 0))


@dataclass(frozen=True)
class CountThresholds:
    """Minimum read support (filter_events.py:61-82 semantics)."""

    total: int = 0      # inc + exc + both
    inc: int = 0
    exc: int = 0
    inc_plus_exc: int = 0

    def passes(self, counts: Tuple[int, int, int]) -> bool:
        inc, exc, both = counts
        return (inc + exc + both >= self.total
                and inc + exc >= self.inc_plus_exc
                and inc >= self.inc and exc >= self.exc)


def _first_float(field: str, cap: Optional[float] = None) -> float:
    v = float(field.split(",")[0])
    return min(v, cap) if cap is not None else v


def read_bf_file(path: str) -> Tuple[List[str], List[Dict[str, str]]]:
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = []
        for line in f:
            fields = line.rstrip("\n").split("\t")
            rows.append(dict(zip(header, fields)))
    return header, rows


def filter_events(
    rows: List[Dict[str, str]],
    num_total: int, num_inc: int, num_exc: int, num_sum: int,
    delta_psi_filter: float, bf_filter: float,
    apply_both_samples: bool = False,
) -> List[Dict[str, str]]:
    """Single-table filter (filter_events.py:241-330)."""
    if abs(delta_psi_filter) > 1:
        raise ValueError("Error: delta psi value outside [0, 1].")
    thresholds = CountThresholds(total=num_total, inc=num_inc,
                                 exc=num_exc, inc_plus_exc=num_sum)
    out = []
    for event in rows:
        bf = _first_float(event["bayes_factor"], cap=MAX_BF)
        delta_psi = _first_float(event["diff"])
        if abs(bf) < abs(bf_filter):
            continue
        if abs(delta_psi) < abs(delta_psi_filter):
            continue
        counts1 = get_counts(event["sample1_counts"])
        if counts1 is not None:
            counts2 = get_counts(event["sample2_counts"])
            if counts2 is None:
                raise ValueError("Incompatible samples.")
            ok1 = thresholds.passes(counts1)
            ok2 = thresholds.passes(counts2)
            if apply_both_samples and not (ok1 and ok2):
                continue
            if not apply_both_samples and not (ok1 or ok2):
                continue
        out.append(event)
    return out


def bayes_factor_votes(event: Dict[str, str], bf_filter: float) -> List[int]:
    """Per-isoform 0/1 BF-pass indicators (filter_events.py:188-203)."""
    return [1 if abs(min(float(x), MAX_BF)) >= bf_filter else 0
            for x in event["bayes_factor"].split(",")]


def delta_psi_votes(event: Dict[str, str], dp_filter: float) -> List[int]:
    """Per-isoform signed delta-psi votes: 0 below threshold, else +-1
    preserving direction (filter_events.py:205-223)."""
    out = []
    for x in event["diff"].split(","):
        dp = float(x)
        out.append(0 if abs(dp) < dp_filter
                   else (1 if dp > 0 else -1))
    return out


def multi_filter(
    tables: Sequence[List[Dict[str, str]]],
    num_total: int, num_inc: int, num_exc: int, num_sum: int,
    delta_psi_filter: float, bf_filter: float,
    votes: int,
    apply_both_samples: bool = False,
) -> List[List[Dict[str, str]]]:
    """Replicate voting (`--votes N`, filter_events.py:83-186): each
    replicate table is threshold-filtered, then an event survives only if

    - it passes the filters in >= N replicates,
    - some isoform's Bayes factor passes in >= N replicates, and
    - some isoform's delta-psi votes agree in DIRECTION in >= N
      replicates (signed votes sum to >= N in magnitude).

    Deliberate divergence: the reference keeps events that fail BOTH
    vote tests (its final condition `not bf_pass and dp_pass` at
    filter_events.py:168 only deletes one of the four cases; the author
    marks the block "this is not going to work at all").  We require
    both tests to pass, which is the documented intent of the flag.
    """
    filtered = [
        filter_events(rows, num_total, num_inc, num_exc, num_sum,
                      delta_psi_filter, bf_filter,
                      apply_both_samples=apply_both_samples)
        for rows in tables]
    if len(tables) <= 1 or votes <= 0:
        return filtered
    by_event: Dict[str, List[Dict[str, str]]] = {}
    for rows in filtered:
        for ev in rows:
            by_event.setdefault(ev["event_name"], []).append(ev)
    keep = set()
    for name, evs in by_event.items():
        if len(evs) < votes:
            continue
        bf_sum: List[int] = []
        dp_sum: List[int] = []
        for ev in evs:
            bfv = bayes_factor_votes(ev, bf_filter)
            dpv = delta_psi_votes(ev, delta_psi_filter)
            if bf_sum and (len(bfv) != len(bf_sum)
                           or len(dpv) != len(dp_sum)):
                # zip() would silently vote over the common prefix
                raise ValueError(
                    "Event %s has inconsistent isoform counts across "
                    "replicate .miso_bf tables (%d vs %d Bayes factors)"
                    % (name, len(bf_sum), len(bfv)))
            bf_sum = ([a + b for a, b in zip(bf_sum, bfv)]
                      if bf_sum else bfv)
            dp_sum = ([a + b for a, b in zip(dp_sum, dpv)]
                      if dp_sum else dpv)
        if any(v >= votes for v in bf_sum) and \
                any(abs(v) >= votes for v in dp_sum):
            keep.add(name)
    return [[ev for ev in rows if ev["event_name"] in keep]
            for rows in filtered]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="filter_events")
    p.add_argument("--filter", dest="filter_filenames", nargs="+",
                   default=None,
                   help=".miso_bf file(s) to filter; several files are "
                        "treated as biological replicates (see --votes)")
    p.add_argument("--num-total", type=int, default=0)
    p.add_argument("--num-inc", type=int, default=0)
    p.add_argument("--num-exc", type=int, default=0)
    p.add_argument("--num-sum-inc-exc", dest="num_sum", type=int, default=0)
    p.add_argument("--delta-psi", dest="delta_psi", type=float, default=0.0)
    p.add_argument("--bayes-factor", dest="bayes_factor", type=float,
                   default=0.0)
    p.add_argument("--apply-both", dest="apply_both", action="store_true",
                   default=False)
    p.add_argument("--votes", dest="votes", type=int, default=0,
                   help="Replicates that must pass the filters (and agree "
                        "in delta-psi direction) to keep an event.")
    p.add_argument("--control", dest="control_filenames", nargs="+",
                   default=[],
                   help="Control comparison file(s).  Accepted for CLI "
                        "parity; the reference parses but never uses "
                        "this flag (misopy/filter_events.py:402-404).")
    p.add_argument("--output-dir", dest="output_dir", default=None)
    args = p.parse_args(argv)
    if not args.filter_filenames or args.output_dir is None:
        print("Need --filter FILE.miso_bf [...] --output-dir DIR",
              file=sys.stderr)
        return 1
    headers, tables, totals = [], [], []
    for path in args.filter_filenames:
        header, rows = read_bf_file(path)
        headers.append(header)
        tables.append(rows)
        totals.append(len(rows))
    passed_tables = multi_filter(
        tables, args.num_total, args.num_inc, args.num_exc, args.num_sum,
        args.delta_psi, args.bayes_factor, args.votes, args.apply_both)
    os.makedirs(args.output_dir, exist_ok=True)
    for path, header, passed, total in zip(
            args.filter_filenames, headers, passed_tables, totals):
        out_path = os.path.join(args.output_dir,
                                os.path.basename(path) + ".filtered")
        with open(out_path, "w") as f:
            f.write("\t".join(header) + "\n")
            for row in passed:
                f.write("\t".join(row.get(h, "") for h in header) + "\n")
        print("%d/%d events pass the filter (%.2f percent): %s"
              % (len(passed), total,
                 100.0 * len(passed) / max(total, 1), out_path))
    return 0


if __name__ == "__main__":
    sys.exit(main())
