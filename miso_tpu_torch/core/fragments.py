"""Insert/fragment length distributions for paired-end inference.

Ref: pysplicing/src/simulator.c:198-219 (splicing_normal_fragment).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def normal_fragment(
    mean: float, var: float, num_devs: float, min_length: int
) -> Tuple[np.ndarray, int]:
    """Discretized normal insert-length pmf over mean +/- num_devs * sd.

    Returns (probs, fragment_start); probs[j] is the (unnormalized) density
    at length fragment_start + j.  The caller normalizes to sum 1
    (pysplicing/src/miso_paired.c:303-308).
    """
    sd = math.sqrt(var)
    frag_start = int(mean - sd * num_devs)
    frag_end = int(mean + sd * num_devs)
    if frag_start < min_length:
        frag_start = min_length
    if frag_end < frag_start:
        frag_end = frag_start
    lengths = np.arange(frag_start, frag_end + 1, dtype=np.float64)
    probs = np.exp(-0.5 * ((lengths - mean) / sd) ** 2) / (sd * math.sqrt(2 * math.pi))
    return probs, frag_start
