"""The wide-lane kernels' shared plan: ``csrc/wide_kernel.cu`` (B1w,
REASSIGN, for every bucket of ``WIDE_FROM`` isoforms or more, and B2w,
MARGINAL/CLASSES, from ``WIDE_FROM_MARGINAL``), of any width.

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

B1w reads its event as classes (``weights``, ``log_read`` (E, C, I)),
never as (E, R, I) read tiles: each step it builds, for every class with
reads, the class's cumulative row (its running maximum) and total once
in a table in shared memory, and each read finds its isoform by a binary
search in its class's row.  Where the classes are more than half the
read slots (three quarters of them at one chunk a row: ``walks``; read
tiles, a class a read) every read walks its
class's row instead, as B1w did on read tiles.  The tile rule
(``table_rows``): a row holds 128 chunks(I) floats and two scalars; the
table holds a row for every class with reads where the lane's floats
then still let an SM hold the blocks the launch gives it, up to
``SM_BUSY_WARPS`` warps (``sm_blocks``), else
as many rows as do (but four, the rows a warp builds at once), taken a
tile at a time (the classes in order, each tile followed by the run of
reads that falls in it); where not even one row fits a block beside the
lane's arrays, the arrays and a table of ``SCRATCH_ROWS`` rows go to
scratch.

B2w keeps a lane's class weights in shared memory for the whole
launch, where they fit (``marginal_plan``): a block's rows, padded to
128 chunks(I) floats, beside its two class-term buffers and, where they
fit too, its lane arrays.  Where one block cannot hold the rows a lane
is a thread-block cluster of ``cluster`` blocks that split its classes
(ceil(C / cluster) rows each), one cluster barrier a step; where no
cluster the launch can take holds them (``lanes x cluster <= SMS``), or
where rows in shared memory would leave the launch more blocks than one
wave of the card holds, the rows stay in device memory.  Its block is
the one that keeps an SM busiest in the launch's first wave.

Constants: csrc/wide_kernel.cu holds the same values (kMaxThreads,
kHeadFloats, kReassignArrays, kMarginalArrays, kRowScalars, kMaxShared).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# From this many isoforms a REASSIGN bucket runs the wide kernel B1w in
# place of the narrow instances B1: the smallest width at which B1w, in
# the form its launch takes (``walks``), is no slower than B1 at every E
# and class share (PERF.md; wide_times.py --mix on an H100, 416 read
# slots).  At 64 isoforms B1w beat B1 at E = 4 and 64 at every share,
# but at E = 2,048 only to C = R/2 classes (113.95 against 111.87 ms):
# at C = 5R/8 its table took 142.38 ms and at C = R its walk 240.26,
# against B1's 112.55 and 113.12.
WIDE_FROM = 128
# From this many isoforms a MARGINAL/CLASSES bucket runs B2w in place of
# B2, for two reasons (PERF.md): B2's isoform sums in sequence make its
# f32 MH ratio round away from the reference's at 60 and 64 real
# isoforms (18 and 26 of 48 fixed-uniform steps accepted where the JAX
# kernel and an f64 replica accept 48), where B2w's order agrees; and
# B2w is 1.7-12x faster than B2 at 64 isoforms at every E timed.
WIDE_FROM_MARGINAL = 64
# Threads of a lane (a block), and what a lane keeps ahead of its arrays
# (sums, 32 partial sums).
WIDE_THREADS = (32, 64, 128, 256, 512)
HEAD_FLOATS = 64
# I-wide arrays of a lane: B1w alpha, psi, efflen, its log, hyper - 1,
# the counts and four terms summed each step; B2w alpha, psi, log psi,
# hyper - 1, the proposal's three and two steps' normals (its terms are
# summed as they are computed, never stored), beside its class terms.
REASSIGN_ARRAYS = 10
MARGINAL_ARRAYS = 9
# B2w's clusters: blocks of a lane (the cluster sizes every card takes)
# and the homes of its class rows, and the registers a thread of each
# instance may take (its __launch_bounds__: two blocks of 512 an SM with
# its rows in device memory, one in shared memory)
CLUSTERS = (1, 2, 4, 8)
WEIGHT_HOMES = ("device", "shared")
MARGINAL_REGISTERS = {"device": 64, "shared": 128}
# B2w's class rows a warp takes at most where a launch's blocks would be
# narrower: at 2,048 events of 64 isoforms, 100 x 6, blocks of a warp
# take 64 classes in 10.59 ms, blocks of two 256 in 34.75 (B2w with its
# rows in device memory for every launch: 13.52, 52.51; wide_times.py
# --marginal on an H100)
ROWS_A_WARP = 128
# B1w walks every read, building no class table, where a launch's
# classes are more than this share of its read slots (``walks``): for
# rows of one chunk (I <= 128), and of more.  Timed on an H100 at 64,
# 128 and 512 isoforms, 416 read slots, E = 4, 64 and 2,048 (PERF.md,
# wide_times.py --mix): a row of one chunk costs less than two reads'
# walks, so the table wins to C = 3R/4 (at 128 isoforms 18.2 / 54.0 /
# 171.0 ms against the walk's 18.9 / 55.7 / 206.9) and the walk from C =
# R at E = 4 and 64; at 512 isoforms a row builds every chunk where a
# walk stops at its isoform's, and the two meet at C = R/2 (38.0 against
# 38.1 ms at E = 4).
WALK_ABOVE = (0.75, 0.5)
# B1w's class table: a row's scalars beside its 128 chunks(I) cumulative
# weights (the class's total and its flag: some weight > 0), and the rows
# of a table in scratch
ROW_SCALARS = 2
SCRATCH_ROWS = 8
# dynamic shared memory a block can ask an H100 for; past it the lane's
# arrays go to scratch
MAX_SHARED = 232448
# An H100's SMs, and what one SM holds at once: threads, blocks, shared
# memory (of which the runtime keeps BLOCK_RESERVED a block).  A table
# that fits a block but leaves an SM a few warps where the launch has
# dozens an SM for it serialises the lanes: at 2,048 events x 6 chains
# (blocks of a warp) and 64 isoforms, 416 rows a block took 1,972 ms,
# tiles of 4 rows 339, the walk 240; with blocks of 16 warps (64
# events) the whole table beat tiles that keep three blocks an SM, 71
# against 99 ms (PERF.md, wide_times.py --mix).  So B1w's table keeps
# an SM SM_BUSY_WARPS warps, where the launch has them.
SMS = 132
SM_THREADS = 2048
SM_BLOCKS = 32
SM_SHARED = 233472
SM_REGISTERS = 65536
BLOCK_RESERVED = 1024
SM_BUSY_WARPS = 16
# Threads a launch keeps at most where it has the lanes for them.  A
# lane's step is a chain of latencies (a read's two passes and its scan,
# a class row's loads and sum, a barrier a phase), which more warps
# share out: a launch of few lanes gives each the widest block; one of
# more lanes keeps its blocks narrower, since every block pays for its
# barriers alike.
CARD_THREADS = SMS * SM_THREADS
KINDS = ("reassign", "marginal")


class WidePlan(NamedTuple):
    """How one launch of a wide kernel is laid out."""
    threads: int       # a lane's block, a multiple of 32
    shared_bytes: int  # the dynamic shared memory a block asks for; 0:
                       # the lane's arrays in scratch (B2w then asks for
                       # its term buffers and shared rows alone)
    rows: int = 0      # B1w: class rows a table tile holds; B2w: 0
    cluster: int = 1   # B2w: blocks of a lane, a thread-block cluster
    weights: str = "device"   # B2w: where its class rows lie (B1w reads
                              # device memory)


def chunks(n: int) -> int:
    """The chunks of 128 that n isoforms (or classes) are padded to."""
    return -(-n // 128)


def lane_floats(kind: str, n: int, I: int, rows: int = 0) -> int:
    """A lane's floats: the head, the kernel's I-wide arrays (128
    chunks(I) each), for B1w the read scores of its n = R read slots and
    a class table of ``rows`` rows (rounded up to whole 16 bytes); for
    B2w a block's (n = C; its class terms and rows apart:
    ``marginal_bytes``)."""
    P = 128 * chunks(I)
    if kind == "reassign":
        # whole 16 bytes: the next lane's arrays in scratch follow
        return 4 * -(-(HEAD_FLOATS + REASSIGN_ARRAYS * P + n
                       + rows * (P + ROW_SCALARS)) // 4)
    return HEAD_FLOATS + MARGINAL_ARRAYS * P


def weight_rows(C: int, cluster: int) -> int:
    """B2w's class rows a block holds: its share of the lane's C."""
    return -(-C // cluster)


def marginal_bytes(C: int, I: int, cluster: int = 1,
                   weights: str = "device", arrays: bool = True) -> int:
    """B2w's dynamic shared memory a block: two term buffers (128
    chunks(C) floats each), its ``weight_rows`` rows of 128 chunks(I)
    where ``weights`` is "shared", and its lane floats where ``arrays``
    lie in shared memory."""
    P = 128 * chunks(I)
    return 4 * (2 * 128 * chunks(C)
                + (weight_rows(C, cluster) * P if weights == "shared" else 0)
                + (lane_floats("marginal", C, I) if arrays else 0))


def launch_bytes(plan: WidePlan, C: int, I: int) -> int:
    """The dynamic shared memory B2w's ``plan`` launches with: its
    ``shared_bytes``, or with its lane arrays in scratch (0) the term
    buffers and shared rows alone."""
    return plan.shared_bytes or marginal_bytes(C, I, plan.cluster,
                                               plan.weights, arrays=False)


def walks(R: int, C: Optional[int], I: int) -> bool:
    """Whether B1w walks every read of a launch of R read slots, C
    classes (None: read tiles, a class a read) and width I instead of
    building its class table: where the classes are more than
    ``WALK_ABOVE`` of the slots (its first share for rows of one chunk),
    so many hold a single read that their rows (every chunk, and its
    running maximum) cost more than the reads' walks, which stop at
    their isoforms' chunks."""
    share = WALK_ABOVE[0] if chunks(I) == 1 else WALK_ABOVE[1]
    return C is None or C > share * R


def _rows_in(budget: int, R: int, I: int) -> int:
    """The class rows that fit ``budget`` bytes beside a B1w lane's
    arrays (< 1 where none does)."""
    room = (budget // 4 - lane_floats("reassign", R, I)) // (
        128 * chunks(I) + ROW_SCALARS)
    if room >= 1 and 4 * lane_floats("reassign", R, I, room) > budget:
        room -= 1                       # the rounding to 16 bytes
    return room


def resident(threads: int, shared_bytes: int, registers: int) -> int:
    """Blocks of ``threads`` threads of ``registers`` and ``shared_bytes``
    one SM holds at once."""
    return min(SM_BLOCKS, SM_THREADS // threads,
               SM_SHARED // (shared_bytes + BLOCK_RESERVED),
               SM_REGISTERS // (threads * registers))


def sm_blocks(threads: int, lanes: int) -> int:
    """The blocks of ``threads`` B1w's table leaves room for on an SM in
    a launch of ``lanes`` lanes: the lanes spread over the SMs, up to
    ``SM_BUSY_WARPS`` warps (a block at least), as far as an SM's blocks
    and threads allow."""
    return min(-(-lanes // SMS), SM_BLOCKS, SM_THREADS // threads,
               max(1, SM_BUSY_WARPS // (threads // 32)))


def table_rows(R: int, I: int, C: Optional[int], threads: int = 512,
               lanes: int = 1) -> int:
    """The class rows of B1w's table tile for R read slots, width I, C
    classes (None: read tiles) and a launch of ``lanes`` blocks of
    ``threads``: one where the launch walks its reads (``walks``: the
    table stays empty), else up to min(C, R): as many as fit beside the
    lane's arrays in an SM's shared memory shared by ``sm_blocks``
    blocks, but no fewer than four (the rows a warp builds at once), and
    no more than fit a block;
    where no row fits a block (the lane goes to scratch),
    ``SCRATCH_ROWS``."""
    rows = 1 if walks(R, C, I) else min(C, R)
    room = _rows_in(MAX_SHARED, R, I)
    if room < 1:
        return min(rows, SCRATCH_ROWS)
    share = _rows_in(SM_SHARED // sm_blocks(threads, lanes)
                     - BLOCK_RESERVED, R, I)
    return min(rows, room, max(share, 4))


def check_shape(kind: str, E: int, n: int, I: int, K: int,
                classes: Optional[int] = None) -> None:
    if kind not in KINDS:
        raise ValueError("no wide kernel for %r" % (kind,))
    reads = kind == "reassign"
    if (E < 1 or K < 1 or I < 2 or n < 1 or (reads and (n < 4 or n % 4))
            or (classes is not None and classes < 1)):
        raise ValueError(
            "the wide %s kernel takes E and K positive, I >= 2 and %s "
            "(got E=%d, %s=%d, I=%d, K=%d, classes %s)" % (
                kind, "R a positive multiple of 4 and C positive" if reads
                else "C positive", E, "R" if reads else "C", n, I, K,
                classes))


def _layout(kind: str, n: int, I: int, threads: int,
            classes: Optional[int] = None, lanes: int = 1,
            cluster: int = 1, weights: str = "device") -> WidePlan:
    rows = 0
    if kind == "reassign":
        rows = table_rows(n, I, classes, threads, lanes)
        need = 4 * lane_floats(kind, n, I, rows)
    else:
        need = marginal_bytes(n, I, cluster, weights)
    return WidePlan(threads=threads,
                    shared_bytes=need if need <= MAX_SHARED else 0,
                    rows=rows, cluster=cluster, weights=weights)


def _threads(blocks: int) -> int:
    """The widest block whose ``blocks`` stay within ``CARD_THREADS``, 32
    threads where none does."""
    return max([t for t in WIDE_THREADS if blocks * t <= CARD_THREADS]
               or [WIDE_THREADS[0]])


def _fits(plan: WidePlan, C: int, I: int) -> bool:
    """Whether B2w's plan asks no block for more shared memory than it
    has."""
    return launch_bytes(plan, C, I) <= MAX_SHARED


def marginal_plan(E: int, C: int, I: int, K: int) -> WidePlan:
    """B2w's launch for E events of (C, I) class weights and K chains.
    Its class rows lie in shared memory for the launch where a block of
    the smallest cluster (``CLUSTERS``) whose lanes x cluster blocks stay
    within the card's ``SMS`` holds them, beside its lane arrays, and one
    wave of the card holds every block (``resident``, at the instance's
    ``MARGINAL_REGISTERS``); else in device memory, a lane then a cluster
    of the largest such size (its blocks split the rows).  Its block by
    ``_marginal_threads``.  Timed on an H100 (``wide_times.py``):
    against B2w with its rows in device memory for every launch, over I =
    64 ... 2,048, C = 64 and 256, E = 4, 64 and 2,048 (``--marginal``),
    0.07-0.96 of its times; at 3 events,
    blocks of 512, 1000 x 6 (``--plans``), rows in shared memory beat
    device memory (I=512, C=64: 4.34 against 5.01 ms; I=2,048, C=64, a
    cluster of 4: 6.39 against 9.09), a larger cluster of shared rows
    gains under 1 % (I=512, C=64: 4.30, 4.29 ms in 2 and 4), and device
    rows gain by their cluster (I=2,048, C=256: 38.54, 22.20, 14.49 ms in
    1, 2 and 4 blocks)."""
    lanes = E * K
    allowed = [c for c in CLUSTERS if lanes * c <= SMS] or [1]
    for c in allowed:
        plan = _marginal_layout(lanes, C, I, c, "shared")
        if plan.shared_bytes and lanes * c <= SMS * resident(
                plan.threads, plan.shared_bytes,
                MARGINAL_REGISTERS["shared"]):
            return plan
    return _marginal_layout(lanes, C, I, allowed[-1], "device")


def _marginal_layout(lanes: int, C: int, I: int, cluster: int,
                     weights: str) -> WidePlan:
    """B2w's plan of ``cluster`` blocks a lane, its rows in ``weights``,
    in the block of ``_marginal_threads``."""
    plan = _layout("marginal", C, I, 32, lanes=lanes, cluster=cluster,
                   weights=weights)
    return plan._replace(threads=_marginal_threads(
        lanes * cluster, C, cluster, launch_bytes(plan, C, I),
        MARGINAL_REGISTERS[weights]))


def _marginal_threads(blocks: int, C: int, cluster: int, shared_bytes: int,
                      registers: int) -> int:
    """B2w's block, in a launch of ``blocks`` blocks of ``shared_bytes``
    and ``registers`` a thread: the one that keeps the most threads of an
    SM busy in the launch's first wave (the blocks an SM holds, or if
    fewer the launch's blocks an SM gets, times the block), the narrowest
    of equals, and a warp for every ``ROWS_A_WARP`` of its class rows.
    A launch of one wave takes the widest block.  At 2,048 events, 100 x
    6 (``wide_times.py --marginal`` on an H100), of 2,048 isoforms and 64
    classes, whose lane arrays leave an SM three blocks, blocks of 32,
    128 and 512 threads took 765.69, 200.35 and 90.81 ms; of 512 and 64,
    eleven blocks an SM, 58.85, 25.16 and 33.88 ms (128 the pick).  The
    pick is not always the fastest: of 512 and 256, 97.71 ms in 128
    threads, 86.75 in 512; of 128 and 256, 35.23 in 64, 32.50 in 128."""
    share = -(-blocks // SMS)

    def busy(t):
        return min(resident(t, shared_bytes, registers), share) * t

    best = max(WIDE_THREADS, key=lambda t: (busy(t), -t))
    rows = weight_rows(C, cluster)
    return min(max(best, 32 * -(-rows // ROWS_A_WARP)), WIDE_THREADS[-1])


def wide_plan(kind: str, E: int, n: int, I: int, K: int,
              classes: Optional[int] = None) -> WidePlan:
    """The launch of a wide kernel for E events of width I (n: read
    slots R for B1w, classes C for B2w; ``classes``: B1w's class count
    C, None for read tiles, a read a class) and K chains: the widest
    block whose E * K lanes stay within ``CARD_THREADS``, 32 threads
    where none does; the lane's arrays in shared memory where they fit a
    block, else in scratch; B1w's table rows by ``table_rows``; B2w's
    plan by ``marginal_plan``."""
    check_shape(kind, E, n, I, K, classes)
    if kind == "marginal":
        return marginal_plan(E, n, I, K)
    return _layout(kind, n, I, _threads(E * K), classes, E * K)


def all_wide_plans(kind: str, E: int, n: int, I: int, K: int,
                   classes: Optional[int] = None):
    """Every plan a wide kernel can be launched with at this shape: the
    checks run them all.  One per block width; for B2w one per block
    width, cluster size and home of its rows where a block holds what the
    plan puts in its shared memory.  ``plan._replace(shared_bytes=0)``
    puts a plan's lane arrays in scratch, and ``tiled(plan, R, I, rows)``
    B1w's table in tiles of ``rows``."""
    check_shape(kind, E, n, I, K, classes)
    if kind == "reassign":
        return [_layout(kind, n, I, t, classes, E * K)
                for t in WIDE_THREADS]
    plans = [_layout(kind, n, I, t, lanes=E * K, cluster=c, weights=home)
             for t in WIDE_THREADS for c in CLUSTERS
             for home in WEIGHT_HOMES]
    return [p for p in plans if _fits(p, n, I)]


def tiled(plan: WidePlan, R: int, I: int, rows: int) -> WidePlan:
    """B1w's ``plan`` with a table tile of ``rows`` class rows, in shared
    memory where the plan's arrays are (the checks force tables of many
    tiles at small widths so)."""
    need = 4 * lane_floats("reassign", R, I, rows)
    return plan._replace(rows=rows,
                         shared_bytes=need if plan.shared_bytes else 0)


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
