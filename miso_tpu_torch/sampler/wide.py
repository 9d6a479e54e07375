"""The wide-lane kernels' shared plan: ``csrc/wide_kernel.cu`` (B1w,
REASSIGN, and B2w, MARGINAL/CLASSES) for every bucket of ``WIDE_FROM``
isoforms or more, of any width.

A lane ((event, chain) chain) is a block; its threads own the isoforms
and its I-wide arrays lie once in dynamic shared memory, or in a scratch
buffer past the block's limit.  The width is padded to chunks of 128
isoforms, warp lane (slot) l owning isoforms 128 c + 4 l + q of chunk c.
Every sum over isoforms (or B2w's classes) runs in one order whatever
the block: slot l adds its isoforms in (c, q) order, then a butterfly
over the 32 slots adds the slots.  ``wide_sum``, ``wide_cumsum`` and
``read_sum`` are the kernels' orders in torch, for the plain versions:
with them a plain version follows a wide kernel's chain to the bit but
for the exp/log calls' last bits.  Nothing on the card's path runs them.

Constants: csrc/wide_kernel.cu holds the same values (kMaxThreads,
kHeadFloats, kReassignArrays, kMarginalArrays, kMaxShared).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# From this many isoforms a bucket runs the wide kernel (B1w, B2w) in
# place of the narrow instances (B1, B2): the smallest width at which
# the wide form is no slower, timed on an H100 at 64, 128 and 256
# isoforms (PERF.md).
WIDE_FROM = 128
# Threads of a lane (a block), and what a lane keeps ahead of its arrays
# (sums, 32 partial sums).
WIDE_THREADS = (32, 64, 128, 256, 512)
HEAD_FLOATS = 64
# I-wide arrays of a lane: B1w alpha, psi, efflen, its log, hyper - 1,
# the counts and four terms summed each step; B2w alpha, psi, log psi,
# hyper - 1, the proposal's three, and four terms, beside its class
# terms.
REASSIGN_ARRAYS = 10
MARGINAL_ARRAYS = 11
# dynamic shared memory a block can ask an H100 for; past it the lane's
# arrays go to scratch
MAX_SHARED = 232448
# Threads a launch keeps at most where it has the lanes for them: an H100
# holds 2,048 on each of its 132 SMs.  A lane's step is a chain of
# latencies (a read's two passes and its scan, a class row's loads and
# sum, a barrier a phase), which more warps share out: a launch of few
# lanes gives each the widest block; one of more lanes keeps its blocks
# narrower, since every block pays for its barriers alike.
CARD_THREADS = 132 * 2048
KINDS = ("reassign", "marginal")


class WidePlan(NamedTuple):
    """How one launch of a wide kernel is laid out."""
    threads: int       # a lane's block, a multiple of 32
    shared_bytes: int  # the lane's arrays in shared memory; 0: in scratch


def chunks(n: int) -> int:
    """The chunks of 128 that n isoforms (or classes) are padded to."""
    return -(-n // 128)


def lane_floats(kind: str, n: int, I: int) -> int:
    """A lane's floats: the head, the kernel's I-wide arrays (128
    chunks(I) each), and for B2w its class terms (n = C, padded alike)."""
    P = 128 * chunks(I)
    if kind == "reassign":
        return HEAD_FLOATS + REASSIGN_ARRAYS * P
    return HEAD_FLOATS + MARGINAL_ARRAYS * P + 128 * chunks(n)


def check_shape(kind: str, E: int, n: int, I: int, K: int) -> None:
    if kind not in KINDS:
        raise ValueError("no wide kernel for %r" % (kind,))
    reads = kind == "reassign"
    if E < 1 or K < 1 or I < 2 or n < 1 or (reads and (n < 4 or n % 4)):
        raise ValueError(
            "the wide %s kernel takes E and K positive, I >= 2 and %s "
            "(got E=%d, %s=%d, I=%d, K=%d)" % (
                kind, "R a positive multiple of 4" if reads
                else "C positive", E, "R" if reads else "C", n, I, K))


def _layout(kind: str, n: int, I: int, threads: int) -> WidePlan:
    need = 4 * lane_floats(kind, n, I)
    return WidePlan(threads=threads,
                    shared_bytes=need if need <= MAX_SHARED else 0)


def wide_plan(kind: str, E: int, n: int, I: int, K: int) -> WidePlan:
    """The launch of a wide kernel for E events of width I (n: reads R
    for B1w, classes C for B2w) and K chains: the widest block whose
    E * K lanes stay within ``CARD_THREADS``, 32 threads where none
    does; the lane's arrays in shared memory where they fit a block,
    else in scratch."""
    check_shape(kind, E, n, I, K)
    threads = max([t for t in WIDE_THREADS if E * K * t <= CARD_THREADS]
                  or [WIDE_THREADS[0]])
    return _layout(kind, n, I, threads)


def all_wide_plans(kind: str, E: int, n: int, I: int, K: int):
    """Every plan a wide kernel can be launched with at this shape, one
    per block width: the checks run them all.  ``plan._replace(
    shared_bytes=0)`` puts a plan's lane arrays in scratch."""
    check_shape(kind, E, n, I, K)
    return [_layout(kind, n, I, t) for t in WIDE_THREADS]


def _chunked(x):
    """x (..., n) as (..., chunks, 32, 4), zeros past n: [c, l, q] is
    isoform 128 c + 4 l + q, which slot l owns."""
    n = x.shape[-1]
    P = 128 * chunks(n)
    if P > n:
        x = torch.nn.functional.pad(x, (0, P - n))
    return x.reshape(*x.shape[:-1], P // 128, 32, 4)


def _butterfly(v):
    """The 32 slots of v (..., 32) added as the warp's xor butterfly
    adds them: halves first."""
    h = 16
    while h:
        v = v[..., :h] + v[..., h:2 * h]
        h //= 2
    return v[..., 0]


def wide_sum(x):
    """Sum over the last axis in the wide kernels' order: each slot's
    isoforms in (chunk, q) order, then the butterfly over the slots."""
    v = _chunked(x)
    acc = v[..., 0, :, 0]
    for c in range(v.shape[-3]):
        for q in range(4):
            if c or q:
                acc = acc + v[..., c, :, q]
    return _butterfly(acc)


def wide_cumsum(x):
    """(cumulative sums, total) over the last axis in B1w's Gibbs order:
    in chunk c, a slot's running sum loc_q of its four, the slots' sums
    scanned over the warp (Hillis-Steele, shuffles up by 1, 2, ... 16:
    incl, and excl one slot behind), and the chunks' totals (a scan's
    last slot) carried in order; isoform 128 c + 4 l + q at carry_c +
    (excl_l + loc_q).  The total: each slot's sums of its four added
    over the chunks, then the butterfly over the slots."""
    n = x.shape[-1]
    v = _chunked(x)
    runs = [v[..., 0]]
    for q in range(1, 4):
        runs.append(runs[-1] + v[..., q])
    loc = torch.stack(runs, -1)                       # (..., C, 32, 4)
    incl = runs[-1]
    o = 1
    while o < 32:
        incl = torch.cat([incl[..., :o], incl[..., o:] + incl[..., :-o]], -1)
        o *= 2
    excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], -1)
    carry = [torch.zeros_like(incl[..., 0, 0])]
    for c in range(v.shape[-3] - 1):
        carry.append(carry[-1] + incl[..., c, 31])
    carries = torch.stack(carry, -1)                  # (..., C)
    cums = carries[..., None, None] + (excl[..., None] + loc)
    slot = runs[-1][..., 0, :]
    for c in range(1, v.shape[-3]):
        slot = slot + runs[-1][..., c, :]
    return cums.reshape(*x.shape[:-1], -1)[..., :n], _butterfly(slot)


def read_sum(x):
    """Sum over the reads (last axis) in B1w's order of the read score:
    read r of group g = r // 4 adds into slot g % 32, the groups in
    ascending order and a group's reads in turn, then the butterfly over
    the slots; reads past the last are zeros."""
    n = x.shape[-1]
    rows = -(-n // 128)
    if 128 * rows > n:
        x = torch.nn.functional.pad(x, (0, 128 * rows - n))
    v = x.reshape(*x.shape[:-1], rows, 32, 4)
    acc = torch.zeros_like(v[..., 0, :, 0])
    for q in range(rows):
        for j in range(4):
            acc = acc + v[..., q, :, j]
    return _butterfly(acc)


def quarters(x):
    """x (..., n) as (4, chunks, 32, ...), contiguous: [q, c, l, ...] is
    isoform 128 c + 4 l + q.  ``wide_first`` reads rows so laid out: a
    slot's running sums, the warp's scan and the chunks' carries then
    add whole contiguous blocks."""
    v = _chunked(x)                                   # (..., C, 32, 4)
    d = v.dim()
    return v.permute(d - 1, d - 3, d - 2, *range(d - 3)).contiguous()


def wide_first(v, n, u):
    """(index, total) of each row of ``v`` (``quarters`` of rows of n
    isoforms): the first i < n - 1 whose cumulative weight in B1w's
    order (``wide_cumsum``) reaches u times the total, n - 1 where none
    does.  Found as the kernel walks the chunks: a chunk's largest
    cumulative weight is carry_c plus its largest excl_l + loc_3 (a
    slot's running sum only grows), so only the first chunk that reaches
    the target is summed in full; the values are ``wide_cumsum``'s, bit
    for bit."""
    C = v.shape[1]
    runs = [v[0]]
    for q in range(1, 4):
        runs.append(runs[-1] + v[q])                  # (C, 32, ...)
    incl = runs[-1].clone()
    o = 1
    while o < 32:
        incl[:, o:] = incl[:, o:] + incl[:, :-o]
        o *= 2
    excl = torch.zeros_like(incl)
    excl[:, 1:] = incl[:, :-1]
    carry = [torch.zeros_like(incl[0, 0])]
    slot = runs[-1][0]
    for c in range(1, C):
        carry.append(carry[-1] + incl[c - 1, 31])
        slot = slot + runs[-1][c]
    carries = torch.stack(carry)                      # (C, ...)
    total = _butterfly(slot.movedim(0, -1))
    target = u * total
    reach = carries + (excl + runs[-1]).amax(1) >= target
    chunk = torch.where(reach.any(0), reach.to(torch.uint8).argmax(0), C - 1)

    # each row's chunk of the slots' running sums and exclusive scan
    pick = chunk[None, None].expand(1, 32, *chunk.shape)
    loc = torch.stack([torch.gather(r, 0, pick)[0] for r in runs], -1)
    cums = (torch.gather(carries, 0, chunk[None])[0][..., None]
            + (torch.gather(excl, 0, pick)[0][..., None] + loc))
    cums = cums.movedim(0, -2).reshape(*chunk.shape, 128)   # 4 l + q
    at = chunk[..., None] * 128 + torch.arange(128, device=v.device)
    ge = (cums >= target[..., None]) & (at < n - 1)
    first = at.gather(-1, ge.to(torch.uint8).argmax(-1, keepdim=True))[..., 0]
    return torch.where(ge.any(-1), first, n - 1), total
