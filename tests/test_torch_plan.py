"""The kernels' launch plans and bounds: the plain Python around the CUDA
sources (miso_tpu_torch/sampler/reassign_kernel.py, marginal_kernel.py,
deep.py), checked without a card."""
import re
import os

import pytest

import miso_tpu_torch
from miso_tpu_torch.sampler import deep
from miso_tpu_torch.sampler import marginal_kernel as mk
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler import wide
from miso_tpu_torch.testing import cap_test_threads

cap_test_threads()

CSRC_DIR = os.path.join(
    os.path.dirname(os.path.abspath(miso_tpu_torch.__file__)), "csrc")
CSRC = os.path.join(CSRC_DIR, "reassign_kernel.cu")
DEPTHS = (32, 320, 1024, 4096, 16384)


def _well_formed(plan, R, I, K):
    assert plan.T in (4, 8, 16, 32)
    assert plan.threads == plan.lanes_per_block * plan.T
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.threads <= rk.MAX_THREADS
    assert plan.home in rk.HOMES
    assert 0 <= plan.shared_bytes <= 232448
    assert plan.groups_per_thread == -(-(R // 4) // plan.T)
    if plan.home == "shared":
        # whole events in the block, one tile each
        assert plan.lanes_per_block % K == 0
        assert plan.shared_bytes == (plan.lanes_per_block // K) * R * I * 4
    else:
        assert plan.shared_bytes == 0


@pytest.mark.parametrize("R", DEPTHS)
@pytest.mark.parametrize("I", rk.KERNEL_ISO)
def test_a_plan_exists_for_every_width_and_depth(I, R):
    for E in (1, 3, 512, 4096):
        for K in (1, 2, 4, 6):
            plan = rk.launch_plan(E, R, I, K)
            _well_formed(plan, R, I, K)
            assert plan in rk.all_plans(E, R, I, K)
            # at least the narrowest lane that fills the card, else a
            # whole warp; wider only to uncrowd the tiles in shared memory
            fill = next((t for t in rk.LANE_THREADS
                         if E * K * t >= 32 * rk.FILL_WARPS), 32)
            assert plan.T >= fill
            widths = [T for T in rk.LANE_THREADS if T >= fill]
            state = {T: rk._layouts(E, R, I, K, T) for T in widths}
            roomy = [T for T in widths
                     if "shared" in state[T][1] and not state[T][0]]
            fitting = [T for T in widths if "shared" in state[T][1]]
            if roomy:       # the narrowest lane whose tiles crowd no SM
                assert (plan.T, plan.home) == (roomy[0], "shared")
            elif fitting:   # the fewest events in a block
                assert (plan.T, plan.home) == (fitting[-1], "shared")
            else:
                assert (plan.T, plan.home) == (fill, "cache")


def test_main_path_chunks_get_the_lane_that_fills_the_card():
    """The 2,000-gene run's launches (512, 1024, 3 and 461 events, padded
    to powers of two) and the whole bucket, at I=2, R=320, K=6."""
    got = {E: rk.launch_plan(E, 320, 2, 6) for E in (4, 512, 1024, 2048)}
    assert {E: p.T for E, p in got.items()} == {4: 32, 512: 16, 1024: 8,
                                                2048: 4}
    assert all(p.home == "shared" and p.threads in (96, 192)
               for p in got.values())
    main = got[2048]
    assert main.T < 32 and main.lanes_per_block == 24   # four events
    assert main.shared_bytes == 4 * 320 * 2 * 4
    # the paired-end catalog's bucket
    assert rk.launch_plan(2048, 160, 2, 6).T == 4


@pytest.mark.parametrize("E,R,I,home", [
    (64, 1024, 2, "shared"), (64, 16384, 2, "shared"),
    (2048, 320, 8, "shared"), (64, 16384, 4, "cache"),
    (64, 4096, 16, "cache"), (64, 1024, 64, "cache"),
    (4096, 16384, 2, "shared")])
def test_tiles_beyond_shared_memory_go_to_the_cache(E, R, I, home):
    plan = rk.launch_plan(E, R, I, 6)
    assert plan.home == home
    if home == "cache":     # one event's tile is beyond shared memory
        assert R * I * 4 > rk.SHARED_LIMIT


def test_every_lane_width_and_home_can_be_forced_where_it_fits():
    for I in (2, 64):
        plans = rk.all_plans(2, 16, I, 2)
        assert {(p.T, p.home) for p in plans} == {
            (T, h) for T in rk.LANE_THREADS for h in rk.HOMES}
        for plan in plans:
            _well_formed(plan, 16, I, 2)
    # one event's 128 KB tile fits, four events' do not
    assert {p.T for p in rk.all_plans(64, 16384, 2, 6)
            if p.home == "shared"} == {16, 32}


def test_many_chains_leave_whole_events_and_shared_memory():
    plan = rk.launch_plan(4, 1024, 2, 9)    # 9 * 32 threads > a block
    assert plan.home == "cache"
    assert plan.threads == rk.MAX_THREADS
    assert all(p.home != "shared" for p in rk.all_plans(4, 1024, 2, 9)
               if p.T == 32)


def test_shared_memory_must_not_cost_resident_blocks():
    # 64 blocks on 132 SMs: one block's 128 KB tile crowds nothing out
    assert rk.launch_plan(64, 16384, 2, 6).shared_bytes == 131072
    # four events' 128 KB of tiles would leave an SM one block of three
    # warps; one event's 32 KB leave it six blocks of lanes of 16
    wide = rk.launch_plan(2048, 1024, 8, 6)
    assert (wide.T, wide.home, wide.shared_bytes) == (16, "shared", 32768)
    assert any(p.home == "shared" and p.shared_bytes == 131072
               for p in rk.all_plans(2048, 1024, 8, 6) if p.T == 4)
    # at 255 registers a thread an SM holds two blocks of 96 threads:
    # four events' 80 KB of tiles cost it none, 160 KB would
    wider = rk.launch_plan(2048, 320, 16, 6)
    assert (wider.T, wider.home, wider.shared_bytes) == (4, "shared", 81920)
    widest = rk.launch_plan(2048, 320, 32, 6)
    assert (widest.T, widest.home, widest.shared_bytes) == (8, "shared",
                                                            81920)
    # one event's 128 KB at any lane width: an SM holds one block, and
    # the widest lane gives that block the most warps
    deep = rk.launch_plan(2048, 4096, 8, 6)
    assert (deep.T, deep.home, deep.threads) == (32, "shared", 192)
    # the same tiles in a launch of 64 blocks stay in shared memory
    assert rk.launch_plan(256, 1024, 8, 6).home == "shared"
    # a block takes 1 KB of the SM's 228 beside its own
    assert rk.SM_SHARED // (32768 + rk.BLOCK_RESERVE) == 6   # not 7


@pytest.mark.parametrize("E,R,I,K", [(8, 318, 2, 6), (8, 0, 2, 6),
                                     (8, 320, 5, 6), (8, 320, 2, 0),
                                     (0, 320, 2, 6)])
def test_plan_rejects_what_the_kernel_does_not_take(E, R, I, K):
    with pytest.raises(ValueError):
        rk.launch_plan(E, R, I, K)
    with pytest.raises(ValueError):
        rk.all_plans(E, R, I, K)


def test_plan_constants_equal_the_kernel_source():
    with open(CSRC) as f:
        src = f.read()

    def const(name):
        return int(re.search(r"constexpr int [^;]*\b%s = (\d+)" % name,
                             src).group(1))

    assert [const("k" + h.capitalize()) for h in rk.HOMES] == [0, 1]
    assert const("kMaxThreads") == rk.MAX_THREADS
    widths = sorted({int(w) for w in re.findall(r"case (\d+): return", src)})
    assert tuple(widths) == rk.KERNEL_ISO
    assert tuple(rk.KERNEL_REGISTERS) == rk.KERNEL_ISO
    assert all(0 < r <= 255 for r in rk.KERNEL_REGISTERS.values())


# ------------------------------------------------ the MARGINAL kernel's plan
def _m_well_formed(plan):
    assert plan.T in mk.LANE_THREADS
    assert plan.lanes_per_block >= 1
    assert plan.threads == plan.lanes_per_block * plan.T
    assert plan.threads % 32 == 0 and plan.threads <= mk.MAX_THREADS


@pytest.mark.parametrize("C", [1, 4, 5, 32, 256])
@pytest.mark.parametrize("I", rk.KERNEL_ISO)
def test_a_marginal_plan_exists_for_every_width_and_class_count(I, C):
    for E in (1, 3, 512, 2048, 65536):
        for K in (1, 2, 4, 6):
            plan = mk.marginal_plan(E, C, I, K)
            _m_well_formed(plan)
            assert plan in mk.all_marginal_plans(E, C, I, K)
            # within the warps that fill the card, or one thread a lane
            assert plan.T == 1 or E * K * plan.T <= 32 * rk.FILL_WARPS
            # threads beyond the classes only draw ahead: half the fill
            if plan.T >= 2 * C:
                assert E * K * plan.T <= 32 * mk.AHEAD_WARPS
            if I >= 16:
                assert plan.T <= 2


def test_marginal_main_path_chunks_get_their_lane():
    """The 2,000-gene run's launches (512, 1024, 3 and 461 events, padded
    to powers of two) and the whole bucket, at I=2, C=4, K=6.  On an
    NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py, 5000 x 6) T=4 was
    the fastest lane at E=2048 (4.03 ms; T=2 5.01, T=8 6.13) and at
    E=1024 (3.57; T=8 3.67), T=8 at E=512 (3.29; T=4 3.36, T=16 3.48),
    and T=32 at E=4 (2.89; T=4 3.33)."""
    got = {E: mk.marginal_plan(E, 4, 2, 6).T for E in (4, 512, 1024, 2048)}
    assert got == {4: 32, 512: 8, 1024: 4, 2048: 4}
    # a CLASSES-sized event and a paired-end one fill the same warps
    assert mk.marginal_plan(2048, 32, 4, 6).T == 4
    assert mk.marginal_plan(2048, 256, 2, 6).T == 4
    # with classes for every thread the lane widens to the whole fill
    assert mk.marginal_plan(512, 32, 4, 6).T == 16
    assert mk.marginal_plan(512, 4, 2, 6).T == 8


def test_marginal_lane_narrows_as_the_launch_grows():
    widths = [mk.marginal_plan(E, 256, 2, 6).T
              for E in (1, 64, 256, 512, 1024, 2048, 4096, 8192, 65536)]
    assert widths == sorted(widths, reverse=True)
    assert widths[0] == 32 and widths[-1] == 1
    assert mk.marginal_plan(4096, 256, 2, 6).T == 2     # the largest chunk
    # wide isoform counts: two threads, then one
    assert [mk.marginal_plan(E, 8, 32, 6).T
            for E in (4, 2048, 4096, 8192)] == [2, 2, 2, 1]
    assert mk.marginal_plan(2048, 8, 16, 6).T == 2
    assert mk.marginal_plan(2048, 24, 8, 6).T == 4
    # T = 1 is reachable at any E
    assert mk.marginal_plan(65536, 8, 64, 6).T == 1
    assert mk.marginal_plan(4, 8, 64, 6).T == 2
    assert mk.WIDE_ISO == ((16, 2),)


def test_every_marginal_lane_width_can_be_forced():
    for I, C in ((2, 4), (64, 5), (32, 40)):
        plans = mk.all_marginal_plans(3, C, I, 2)
        assert [p.T for p in plans] == [1, 2, 4, 8, 16, 32]
        for plan in plans:
            _m_well_formed(plan)


@pytest.mark.parametrize("E,C,I,K", [(8, 4, 5, 6), (8, 0, 2, 6),
                                     (0, 4, 2, 6), (8, 4, 2, 0),
                                     (8, 4, 2048, 6)])
def test_marginal_plan_rejects_what_the_kernel_does_not_take(E, C, I, K):
    with pytest.raises(ValueError):
        mk.marginal_plan(E, C, I, K)
    with pytest.raises(ValueError):
        mk.all_marginal_plans(E, C, I, K)


def test_marginal_plan_constants_equal_the_kernel_source():
    with open(os.path.join(CSRC_DIR, "marginal_kernel.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kMaxThreads = (\d+)",
                         src).group(1)) == mk.MAX_THREADS
    assert mk.MAX_THREADS % 32 == 0
    widths = sorted({int(w) for w in re.findall(r"case (\d+): return", src)})
    assert tuple(widths) == rk.KERNEL_ISO
    assert mk.AHEAD_WARPS * 2 == rk.FILL_WARPS
    # the source is built without FMA contraction
    from miso_tpu_torch import kernels
    assert kernels.SOURCE_FLAGS["marginal_kernel.cu"] == ["-fmad=false"]


# ------------------------------------------ the wide kernels' plan (wide.py)
def test_wide_plan_constants_equal_the_kernel_source():
    with open(os.path.join(CSRC_DIR, "wide_kernel.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(r"constexpr int %s = (\d+)" % name,
                             src).group(1))

    assert const("kMaxThreads") == max(wide.WIDE_THREADS)
    assert const("kHeadFloats") == wide.HEAD_FLOATS
    assert const("kReassignArrays") == wide.REASSIGN_ARRAYS
    assert const("kMarginalArrays") == wide.MARGINAL_ARRAYS
    assert const("kRowScalars") == wide.ROW_SCALARS
    assert const("kMaxShared") == wide.MAX_SHARED
    assert "return (n + 127) / 128;" in src      # wide.chunks
    # every bucketed width below a wide kernel's first has a narrow
    # instance
    from miso_tpu_torch.core.events import _round_up_iso
    widths = {_round_up_iso(k) for k in range(1, 1025)}
    for first in (wide.WIDE_FROM, wide.WIDE_FROM_MARGINAL):
        assert {w for w in widths if w < first} <= set(rk.KERNEL_ISO)
    from miso_tpu_torch import kernels
    assert kernels.SOURCE_FLAGS["wide_kernel.cu"] == ["-fmad=false"]


@pytest.mark.parametrize("kind", wide.KINDS)
@pytest.mark.parametrize("I", [64, 100, 128, 256, 512, 1024, 1100, 2048,
                               4096, 8192, 16384])
def test_a_wide_plan_exists_for_every_width(kind, I):
    """A block of 32 ... 512 threads, as wide as ``CARD_THREADS`` allows
    over the launch's blocks (B2w: the block that keeps the most threads
    of an SM busy in the first wave, the narrowest of equals, and a warp
    for every ``ROWS_A_WARP`` class rows); the lane's arrays in shared memory where they fit, else
    in scratch; B1w's class table of a row per class with reads where it
    fits beside them and leaves an SM the blocks the launch gives it,
    else as many rows as do (four at least, as many as fit a block at
    most), else (scratch) ``SCRATCH_ROWS``; B2w's class rows in shared
    memory in the smallest cluster of ``lanes x cluster <= SMS`` blocks
    whose block holds them beside its arrays and whose blocks one wave
    of the card holds, else in device memory in the largest."""
    plan_of = rk.wide_plan if kind == "reassign" else mk.wide_plan
    for E in (1, 4, 64, 2048):
        for K in (1, 6):
            for n in (16, 512):
                plan = plan_of(E, n, I, K)
                assert plan in wide.all_wide_plans(kind, E, n, I, K)
                assert plan.threads in wide.WIDE_THREADS
                blocks = E * K * plan.cluster
                fits = [t for t in wide.WIDE_THREADS
                        if blocks * t <= wide.CARD_THREADS]
                if kind == "marginal":
                    _check_marginal_plan(plan, E * K, n, I)
                    continue
                assert plan.threads == max(fits or [32])
                need = 4 * wide.lane_floats(kind, n, I, plan.rows)
                assert plan.shared_bytes == (need if need <= wide.MAX_SHARED
                                             else 0)
                assert plan.rows == 1          # read tiles walk
                for C in (1, 7, 64, n):
                    plan = plan_of(E, n, I, K, classes=C)
                    most = 1 if wide.walks(n, C, I) else min(C, n)
                    # a lane in scratch starts on 16 bytes, as its float4
                    # loads need
                    assert wide.lane_floats(kind, n, I, plan.rows) % 4 == 0
                    bare = 4 * wide.lane_floats(kind, n, I)
                    row = 4 * (128 * wide.chunks(I) + wide.ROW_SCALARS)
                    if bare + row <= wide.MAX_SHARED:
                        assert 1 <= plan.rows <= most
                        assert plan.shared_bytes == 4 * wide.lane_floats(
                            kind, n, I, plan.rows) <= wide.MAX_SHARED
                        assert bare + row * plan.rows <= plan.shared_bytes
                        # one row more would not fit a block, or would
                        # cost an SM one of the blocks the launch gives it
                        blocks = wide.sm_blocks(plan.threads, E * K)
                        share = (wide.SM_SHARED // blocks
                                 - wide.BLOCK_RESERVED)
                        more = bare + row * (plan.rows + 1)
                        assert (plan.rows == most or more > wide.MAX_SHARED
                                or (plan.rows >= 4 and more > share))
                        assert plan.rows >= 4 or plan.rows == most or (
                            bare + 4 * row > wide.MAX_SHARED)
                    else:
                        assert plan.rows == min(most, wide.SCRATCH_ROWS)
                        assert plan.shared_bytes == 0


def _marginal_threads(lanes, C, I, cluster, weights):
    """B2w's block by its rule, written out: the threads of an SM busy in
    the first wave (blocks it holds, or the launch's blocks it gets if
    fewer, times the block) at their most, the narrowest of equals; a
    warp for every ROWS_A_WARP rows."""
    need = wide.marginal_bytes(C, I, cluster, weights)
    if need > wide.MAX_SHARED:
        need = wide.marginal_bytes(C, I, cluster, weights, arrays=False)
    regs = wide.MARGINAL_REGISTERS[weights]
    share = -(-lanes * cluster // wide.SMS)
    busy = {t: min(wide.resident(t, need, regs), share) * t
            for t in wide.WIDE_THREADS}
    most = max(busy.values())
    best = min(t for t in wide.WIDE_THREADS if busy[t] == most)
    return min(max(best, 32 * -(-wide.weight_rows(C, cluster)
                                // wide.ROWS_A_WARP)), 512)


def _check_marginal_plan(plan, lanes, C, I):
    """B2w's plan against its rule (see test_a_wide_plan_exists_for_
    every_width)."""
    assert plan.rows == 0
    assert plan.threads == _marginal_threads(lanes, C, I, plan.cluster,
                                             plan.weights)
    need = wide.marginal_bytes(C, I, plan.cluster, plan.weights)
    assert plan.shared_bytes == (need if need <= wide.MAX_SHARED else 0)
    allowed = [c for c in wide.CLUSTERS if lanes * c <= wide.SMS] or [1]
    assert plan.cluster in allowed

    def shared_fits(c):
        t = _marginal_threads(lanes, C, I, c, "shared")
        b = wide.marginal_bytes(C, I, c, "shared")
        return b <= wide.MAX_SHARED and lanes * c <= wide.SMS * wide.resident(
            t, b, wide.MARGINAL_REGISTERS["shared"])

    if plan.weights == "shared":
        assert shared_fits(plan.cluster)
        assert not any(shared_fits(c) for c in allowed if c < plan.cluster)
    else:
        assert plan.cluster == allowed[-1]
        assert not any(shared_fits(c) for c in allowed)


def test_wide_plan_examples():
    """The buckets chip_smoke.py runs: 4 genes of 300 and of 1,100
    isoforms (24 lanes) in the widest blocks, a launch of 2,048 events
    in warps; B1w's table whole at 512 isoforms and 64 classes, in tiles
    of 18 rows at 2,048 isoforms, of one row where the reads walk (read
    tiles, or more classes than ``wide.walks`` allows); the lane arrays
    in scratch from 5,249 isoforms (B1w)."""
    assert not wide.walks(416, 64, 512) and not wide.walks(416, 208, 512)
    assert wide.walks(416, 209, 512) and wide.walks(416, None, 512)
    # rows of one chunk: the table to three quarters of the slots
    assert not wide.walks(416, 312, 128) and wide.walks(416, 313, 128)
    assert wide.walks(416, 209, 256) and wide.walks(416, None, 64)
    # 2,048 events x 6 chains in blocks of a warp: tiles that leave an
    # SM 16 blocks, four rows at least; blocks of 16 warps (64 events)
    # keep their whole table
    assert wide.sm_blocks(32, 2048 * 6) == 16
    assert rk.wide_plan(2048, 416, 128, 6, classes=208).rows == 12
    assert rk.wide_plan(2048, 416, 512, 6, classes=208).rows == 4
    assert wide.sm_blocks(512, 64 * 6) == 1
    assert rk.wide_plan(64, 416, 64, 6, classes=312).rows == 312
    assert rk.wide_plan(4, 416, 512, 6, classes=64) == wide.WidePlan(
        512, 4 * (64 + 10 * 512 + 416 + 64 * (512 + 2)), 64)
    assert rk.wide_plan(4, 416, 2048, 6, classes=200).rows == 18
    assert rk.wide_plan(4, 512, 512, 6) == wide.WidePlan(512, 4 * (
        64 + 10 * 512 + 512 + (512 + 2) + 2), 1)   # whole 16 bytes
    assert rk.wide_plan(4, 512, 512, 6, classes=256).rows == 101
    assert rk.wide_plan(4, 512, 512, 6, classes=512).rows == 1
    assert [rk.wide_plan(E, 512, 128, 6).threads
            for E in (64, 128, 1024, 2048)] == [512, 256, 32, 32]
    assert rk.wide_plan(4, 512, 2048, 6).threads == 512
    # B2w: at 4 genes of 300 isoforms the rows fit one block, at 1,100 a
    # cluster of 4 blocks (16 rows each); at 64 events they stay in device
    # memory (one block an SM would take three waves)
    assert mk.wide_plan(4, 64, 512, 6) == wide.WidePlan(
        512, 4 * (2 * 128 + 64 * 512 + 64 + 9 * 512), 0, 1, "shared")
    assert mk.wide_plan(4, 64, 2048, 6) == wide.WidePlan(
        512, 4 * (2 * 128 + 16 * 2048 + 64 + 9 * 2048), 0, 4, "shared")
    assert mk.wide_plan(4, 256, 512, 6)[3:] == (4, "shared")
    assert mk.wide_plan(4, 256, 2048, 6)[3:] == (4, "device")
    assert mk.wide_plan(64, 64, 512, 6)[3:] == (1, "device")
    assert [mk.wide_plan(2048, C, 64, 6).threads for C in (64, 256)] == [
        32, 64]
    # 2,048 events of 512 and 2,048 isoforms: lane arrays that leave an SM
    # 11 and 3 blocks take blocks of 4 and 16 warps
    assert [mk.wide_plan(2048, 64, I, 6).threads for I in (512, 2048)] == [
        128, 512]
    assert rk.wide_plan(2048, 512, 128, 6).threads == 32
    assert rk.wide_plan(4, 64, 5248, 2).shared_bytes > 0
    assert rk.wide_plan(4, 64, 5249, 2) == wide.WidePlan(512, 0, 1)
    assert rk.wide_plan(4, 64, 5249, 2, classes=32).rows == 8
    assert mk.wide_plan(2, 8, 8192, 2).shared_bytes == 0


@pytest.mark.parametrize("kind,E,n,I,K", [
    ("reassign", 0, 16, 128, 2), ("reassign", 2, 14, 128, 2),
    ("reassign", 2, 16, 1, 2), ("marginal", 2, 0, 128, 2),
    ("marginal", 2, 4, 128, 0), ("neither", 2, 4, 128, 2)])
def test_wide_plan_rejects_what_the_kernel_does_not_take(kind, E, n, I, K):
    with pytest.raises(ValueError):
        wide.wide_plan(kind, E, n, I, K)
    with pytest.raises(ValueError):
        wide.all_wide_plans(kind, E, n, I, K)


def _f32(x):
    import numpy as np
    return np.float32(x)


def _kernel_slot_sum(x):
    """warp_sum of csrc/wide_kernel.cu (a row of slot_sums), transcribed:
    lane l adds the float4 of isoforms 128 c + 4 l ... + 3 for c = 0, 1,
    ... from 0, then v += shfl_xor(v, o) for o = 16 ... 1, in float32."""
    import numpy as np
    n = len(x)
    v = [np.float32(0)] * 32
    for c in range(wide.chunks(n)):
        for l in range(32):
            for q in range(4):
                i = 128 * c + 4 * l + q
                v[l] = _f32(v[l] + (x[i] if i < n else np.float32(0)))
    o = 16
    while o:
        v = [_f32(v[l] + v[l ^ o]) for l in range(32)]
        o //= 2
    assert len(set(v)) == 1          # every lane holds the same sum
    return v[0]


def _kernel_cums(x):
    """B1w's Gibbs sums, transcribed (class_rows): in
    chunk c a lane's running sums of its four products, the warp's
    shfl_up scan of the lanes' sums, the exclusive offset, the chunks'
    last-lane sums carried; the total a lane's sums of its four over the
    chunks from 0, then the xor butterfly."""
    import numpy as np
    n = len(x)
    cums, carry = {}, np.float32(0)
    lane_tot = [np.float32(0)] * 32
    for c in range(wide.chunks(n)):
        loc = {}
        incl = []
        for l in range(32):
            acc = None
            for q in range(4):
                i = 128 * c + 4 * l + q
                v = x[i] if i < n else np.float32(0)
                acc = v if acc is None else _f32(acc + v)
                loc[l, q] = acc
            incl.append(acc)
            lane_tot[l] = _f32(lane_tot[l] + acc)
        o = 1
        while o < 32:
            incl = [_f32(incl[l] + incl[l - o]) if l >= o else incl[l]
                    for l in range(32)]
            o *= 2
        excl = [np.float32(0)] + incl[:31]
        for l in range(32):
            for q in range(4):
                i = 128 * c + 4 * l + q
                if i < n:
                    cums[i] = _f32(carry + _f32(excl[l] + loc[l, q]))
        carry = _f32(carry + incl[31])
    o = 16
    while o:
        lane_tot = [_f32(lane_tot[l] + lane_tot[l ^ o]) for l in range(32)]
        o //= 2
    return [cums[i] for i in range(n)], lane_tot[0]


def _kernel_read_sum(x):
    """B1w's read score, transcribed (reassign_gibbs): each read's score
    in its slot of rs (0 past the reads), then lane l of every warp adds
    groups g = l, l + 32, ... a group's four in turn, from 0, and a
    butterfly over the lanes."""
    import numpy as np
    G = -(-len(x) // 4)
    rs = list(x) + [np.float32(0)] * (4 * G - len(x))
    v = [np.float32(0)] * 32
    for l in range(32):
        for g in range(l, G, 32):
            for j in range(4):
                v[l] = _f32(v[l] + rs[4 * g + j])
    o = 16
    while o:
        v = [_f32(v[l] + v[l ^ o]) for l in range(32)]
        o //= 2
    return v[0]


@pytest.mark.parametrize("n", [1, 2, 31, 33, 128, 130, 300, 1100])
def test_wide_orders_are_the_kernels(n):
    """``wide_sum``, ``wide_cumsum`` and ``read_sum`` (torch, for the
    plain versions) add in the order of the CUDA loops they mirror, to
    the bit, on float32 values whose sums round (the read score alike in
    every block width: every warp adds the 32 slots)."""
    import numpy as np
    import torch

    x = (np.random.default_rng(n).random(n) * 10 ** np.random.default_rng(
        n + 1).uniform(-3, 3, n)).astype(np.float32)
    t = torch.from_numpy(x)
    assert wide.wide_sum(t).item() == _kernel_slot_sum(x)
    cums, total = wide.wide_cumsum(t)
    want, want_total = _kernel_cums(x)
    assert cums.tolist() == [float(v) for v in want]
    assert total.item() == want_total
    assert wide.read_sum(t).item() == _kernel_read_sum(x)
    # batched alike: a leading axis changes nothing
    two = torch.stack([t, t.flip(0)])
    assert wide.wide_sum(two)[0].item() == _kernel_slot_sum(x)
    assert wide.wide_sum(two)[1].item() == _kernel_slot_sum(x[::-1].copy())


@pytest.mark.parametrize("n", [2, 3, 128, 130, 300, 1100])
def test_wide_first_is_the_first_cumulative_weight_that_reaches(n):
    """``wide.wide_first`` (chunk by chunk) gives what a full walk of
    ``wide_cumsum`` gives: the first i < n - 1 whose cumulative weight
    reaches u times the total, n - 1 where none; on rows of zeros (a
    padding read), of sparse weights, and at u = 0, 0.4999 and 1."""
    import numpy as np
    import torch

    rng = np.random.default_rng(n)
    x = rng.random((6, 50, n)).astype(np.float32)
    x *= rng.random((6, 50, n)) < 0.2
    x[0] = 0.0
    x[1, :, : n // 2] = 0.0
    t = torch.from_numpy(x)
    u = torch.from_numpy(rng.random((6, 50)).astype(np.float32))
    u[2] = 0.0
    u[3] = 0.4999
    u[4] = 1.0
    got, total = wide.wide_first(wide.quarters(t), n, u)
    cums, want_total = wide.wide_cumsum(t)
    assert torch.equal(total, want_total)
    ge = cums[..., :-1] >= (u * total)[..., None]
    want = torch.where(ge.any(-1), ge.to(torch.uint8).argmax(-1), n - 1)
    assert torch.equal(got, want)


def _kernel_search(x, u):
    """B1w's draw of a read of class row x at uniform u, transcribed:
    class_rows' running maximum of the row's cumulative weights
    (``_kernel_cums``' floats), then reassign_gibbs's lower bound over
    the first n - 1: while the probed value does not reach u * total
    the search moves right."""
    import numpy as np
    n = len(x)
    cums, total = _kernel_cums(x)
    run = np.maximum.accumulate(np.asarray(cums, np.float32))
    target = _f32(np.float32(u) * total)
    at, length = 0, n - 1
    while length > 0:
        h = length >> 1
        if not run[at + h] >= target:
            at, length = at + h + 1, length - h - 1
        else:
            length = h
    return at


@pytest.mark.parametrize("walk", [False, True])
def test_class_map_lays_the_reads_out_as_the_expansion_does(walk):
    """``class_map``: every read slot that ``expand_read_tensors`` fills
    from class c is c's (``cid``), and lies in c's run of slots in the
    class table (``cls``, ``first``, ``slot``), or with ``walk`` in the
    list of reads that walk (``walk``, the table empty); the other
    slots (past an event's reads, or past R) in neither; classes of no
    reads nowhere."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    for _ in range(100):
        E, C, I = 3, int(rng.integers(1, 9)), 5
        counts = torch.from_numpy(rng.integers(0, 4, (E, C)).astype(
            np.float32))
        R = int(rng.integers(4, 20))
        w = torch.from_numpy(rng.random((E, C, I)).astype(np.float32))
        rw, _ = rk.expand_read_tensors(w, w, counts, R)
        m = rk.class_map(counts, R, walk)
        assert m.cls.shape == (E, min(C, R))
        for e in range(E):
            na, nw = int(m.nact[e]), int(m.nwalk[e])
            walking = m.walk[e, :nw].tolist()
            assert walking == sorted(walking)
            assert (m.walk[e, nw:] == -1).all()
            assert (na == 0) == (walk or not (m.cid[e] >= 0).any())
            for r in range(R):
                c = int(m.cid[e, r])
                if c < 0:
                    assert (rw[e, r] == 0).all() and int(m.slot[e, r]) == -1
                    assert r not in walking
                    continue
                assert torch.equal(rw[e, r], w[e, c])
                a = int(m.slot[e, r])
                if walk:
                    assert a == -1 and r in walking
                else:
                    assert a < na and int(m.cls[e, a]) == c
                    assert int(m.first[e, a]) <= r < int(m.first[e, a + 1])
            assert int(m.first[e, na]) == int((m.cid[e] >= 0).sum())


@pytest.mark.parametrize("n", [2, 3, 128, 130, 300])
def test_class_table_search_is_wide_first(n):
    """The binary search in B1w's class table finds what ``wide_first``
    (the plain version's chunk walk) finds: the first i < n - 1 whose
    cumulative weight reaches u times the total, n - 1 where none; on
    rows of zeros, of ties (equal weights, and runs of zeros: flat
    stretches of the row) and of weights over six decades, whose
    cumulative weights fall by an ulp where the warp scan's tree adds
    (a search in the row itself would miss there), at u = 0, 0.4999, 1,
    random, and at the very values where the row falls."""
    import numpy as np
    import torch

    rng = np.random.default_rng(n)
    rows = [np.zeros(n, np.float32), np.ones(n, np.float32),
            np.where(np.arange(n) % 3 == 0, 0.25, 0.0).astype(np.float32)]
    rows += [(rng.random(n) * 10 ** rng.uniform(-3, 3, n)
              * (rng.random(n) < 0.5)).astype(np.float32) for _ in range(6)]
    dips = 0
    for x in rows:
        cums, total = wide.wide_cumsum(torch.from_numpy(x))
        us = [0.0, 0.4999, 1.0] + list(rng.random(3))
        for i in np.flatnonzero(cums[1:n - 1].numpy() < cums[:n - 2].numpy()):
            dips += 1
            u = np.float32(cums[i].item() / total.item())
            us += [u, np.nextafter(u, np.float32(0)),
                   np.nextafter(u, np.float32(1))]
        u = torch.tensor(np.float32(us))
        want, _ = wide.wide_first(wide.quarters(
            torch.from_numpy(x).expand(len(us), n)), n, u)
        assert [_kernel_search(x, v) for v in us] == want.tolist()
    assert dips > 0 or n < 128


# ------------------------------------------------------------- the bounds
def test_reassign_bound_arithmetic():
    E, R, I, K, iters, rec = 2048, 320, 2, 6, 5000, 450
    b = rk.reassign_bound(E, R, I, K, iters, rec)
    steps, lanes, reads = iters + 1, E * K, E * R
    assert b["bytes"] == 4 * (2 * reads * I + 5 * E * I + 2 * E
                              + E * rec * K * (I + 1) + lanes * (2 * I + 1))
    assert b["int_ops"] == steps * (
        K * (E * (R // 4) * 40 + 3 * reads) + lanes * 2 * 40)
    assert b["fp32_ops"] == steps * (K * reads * (3 * I - 1)
                                     + lanes * 20 * I)
    assert b["bytes_ms"] == pytest.approx(1e3 * b["bytes"] / 3.35e12)
    # the integer pipe, at half the FP32 rate, takes longest here
    assert b["ops_ms"] == pytest.approx(1e3 * b["int_ops"] / 16.75e12)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == b["ops_ms"] > 100 * b["bytes_ms"]
    assert 15.0 < b["bound_ms"] < 16.0


@pytest.mark.parametrize("fp_ops,int_ops,ms", [
    (33.5e9, 0, 1.0),           # the FP32 pipe alone
    (0, 16.75e9, 1.0),          # the integer pipe alone, at half the rate
    (33.5e9, 16.75e9, 1.5),     # both: the schedulers issue one or the other
    (3.35e9, 16.75e9, 1.0),     # FP32 work in the integer pipe's shadow
    (16.75e9, 16.75e9, 1.0)])   # both pipes busy, every issue slot taken
def test_the_pipes_run_side_by_side(fp_ops, int_ops, ms):
    b = rk.bound(0, int(fp_ops), int(int_ops))
    assert b["ops_ms"] == pytest.approx(ms)
    assert b["bound_ms"] == b["ops_ms"] and b["bound_by"] == "operations"
    assert b["ops_ms"] <= 1e3 * (fp_ops / 33.5e12 + int_ops / 16.75e12)


def test_reassign_bound_counts_what_the_data_needs():
    full = rk.reassign_bound(64, 320, 2, 6, 5000, 450)
    part = rk.reassign_bound(64, 320, 2, 6, 5000, 450,
                             valid_reads=64 * 300)
    assert part["bytes"] == full["bytes"]
    assert part["int_ops"] == full["int_ops"] - 5001 * 6 * 3 * 64 * 20
    # a padded read keeps its I adds, loses the rest of its walk
    assert part["fp32_ops"] == full["fp32_ops"] - 5001 * 6 * 64 * 20 * 3
    assert part["bound_ms"] < full["bound_ms"]
    # twice the chains or the steps, twice the work
    twice = rk.reassign_bound(64, 320, 2, 12, 5000, 450)
    assert twice["int_ops"] == 2 * full["int_ops"]
    assert twice["fp32_ops"] == 2 * full["fp32_ops"]


def test_reassign_bound_counts_the_class_form():
    """``classes``: B1w's work, a cumulative row per class with reads
    (2 I - 1 FP32 operations a step: its products and sums, not the
    kernel's running maximum) and per valid read its uniform, a
    search of ceil(log2 I) compares and its count; the reads' Philox
    calls as before; the class rows and a class index per read slot in
    place of the read tiles."""
    E, R, I, K, iters, rec = 4, 416, 512, 6, 5000, 450
    C, valid = 4 * 64, 4 * 400
    b = rk.reassign_bound(E, R, I, K, iters, rec, valid_reads=valid,
                          classes=C)
    reads = rk.reassign_bound(E, R, I, K, iters, rec, valid_reads=valid)
    steps, lanes = iters + 1, E * K
    assert b["int_ops"] == reads["int_ops"]
    assert b["fp32_ops"] == steps * (K * (C * (2 * I - 1) + valid * (2 + 9))
                                     + lanes * 20 * I)
    assert b["bytes"] == reads["bytes"] - 4 * 2 * E * R * I + 4 * (
        2 * C * I + E * R)
    assert b["bound_by"] == "operations"
    # a class a read: a row and a search a read, less than a walk's
    # 3 I - 1 (its compares and count updates) but more than half of it
    walk = rk.reassign_bound(E, R, I, K, iters, rec)["fp32_ops"]
    one = rk.reassign_bound(E, R, I, K, iters, rec, classes=E * R)
    assert walk / 2 < one["fp32_ops"] < walk
    assert b["bound_ms"] < reads["bound_ms"] / 5


def test_a_launch_with_no_steps_is_bound_by_bytes():
    b = rk.reassign_bound(2048, 16384, 2, 1, 0, 0)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == b["bytes_ms"] > b["ops_ms"]


def test_marginal_wide_floor_is_a_chain_of_steps():
    """B2w's dependent-chain floor: its steps' chain from the measured
    latencies, to the clock at the wide buckets' shapes; it grows with the
    steps, the isoforms' chunks (its four sums over them) and the classes'
    chunks, and a cluster's barrier in place of a block's."""
    dep, sh = deep.DEP_CLOCKS, deep.SHUFFLE_CLOCKS

    def chunk_sum(n):
        return 16 * -(-n // 128) + 5 * (sh + dep)

    step = (2 * dep + deep.EXPF_CLOCKS + chunk_sum(512) + dep
            + deep.DIVF_CLOCKS + chunk_sum(512) + 2 * dep
            + deep.LOGF_CLOCKS + 3 * dep + chunk_sum(512) + 44.7
            + chunk_sum(64) + 10 * dep + 5 * 44.7)
    assert deep.marginal_wide_floor(64, 512, 512, 1, 5000) == pytest.approx(
        1e3 * 5001 * step / deep.SM_CLOCK_HZ)
    base = deep.marginal_wide_floor(64, 512, 512, 1, 5000)
    assert 3.0 < base < 6.0
    assert deep.marginal_wide_floor(64, 512, 512, 1, 10001) == \
        pytest.approx(2 * base)
    assert deep.marginal_wide_floor(64, 2048, 512, 1, 5000) > base
    assert deep.marginal_wide_floor(256, 512, 512, 1, 5000) > base
    assert deep.marginal_wide_floor(64, 512, 32, 1, 5000) < base
    assert deep.marginal_wide_floor(64, 512, 512, 4, 5000) == pytest.approx(
        base + 1e3 * 5001 * (1324.0 - 44.7) / deep.SM_CLOCK_HZ)
    assert 8.0 < deep.marginal_wide_floor(64, 2048, 512, 4, 5000) < 12.0
    # a run's own probes in the constants' place
    assert deep.marginal_wide_floor(64, 512, 512, 1, 5000, clocks={
        "Logf": deep.LOGF_CLOCKS + 100}) == pytest.approx(
            base + 1e3 * 5001 * 100 / deep.SM_CLOCK_HZ)


def test_marginal_bound_arithmetic():
    E, C, I, K, iters, rec = 2048, 4, 2, 6, 5000, 450
    b = mk.marginal_bound(E, C, I, K, iters, rec)
    steps, lanes = iters + 1, E * K
    assert b["bytes"] == 4 * (E * C * I + E * C + E + E * I + 4 * E
                              + E * rec * K * (I + 1) + lanes * (I + 1))
    assert b["fp32_ops"] == steps * (
        K * E * C * (2 * I + 1 + mk.SFU_COST)
        + lanes * (2 * I * mk.SFU_COST + 12 * I))
    assert b["int_ops"] == steps * lanes * 2 * 40
    assert b["bound_by"] == "operations"
    # issue-bound: FP32 and integer instructions share the schedulers
    assert b["bound_ms"] == pytest.approx(
        1e3 * (b["fp32_ops"] + b["int_ops"]) / 33.5e12)
    assert 0.3 < b["bound_ms"] < 0.4
    fewer = mk.marginal_bound(E, C, I, K, iters, rec, live_classes=E * 3)
    assert fewer["fp32_ops"] == b["fp32_ops"] - steps * K * E * (
        2 * I + 1 + mk.SFU_COST)
    assert fewer["int_ops"] == b["int_ops"]


def test_marginal_bound_does_not_depend_on_the_plan():
    """The bound counts the function's operations: 0.32 ms at the main
    shape's inputs (three of an event's four classes hold reads),
    whatever the lane width."""
    b = mk.marginal_bound(2048, 4, 2, 6, 5000, 450, live_classes=2048 * 3)
    assert round(b["bound_ms"], 2) == 0.32
    assert b["fp32_ops"] == 5001 * (6 * 2048 * 3 * 13 + 12288 * (32 + 24))
    assert "plan" not in mk.marginal_bound.__code__.co_varnames


# ------------------------------------------ the multinomial kernel B3's plan
@pytest.mark.parametrize("C", [1, 3, 4, 5, 128, 256])
def test_a_multinomial_plan_exists_for_every_width_and_class_count(C):
    """The lane width reads E * K alone; the width sizes the lanes'
    arrays: the narrowest width and a wide one stand for every other."""
    for I in (2, 1024):
        for E in (1, 3, 16, 64, 2048, 16384):
            for K in (1, 2, 6):
                plan = deep.multinomial_plan(E, C, I, K)
                assert plan.T in deep.LANE_THREADS
                # a block is one warp
                assert plan.threads == plan.lanes_per_block * plan.T == 32
                assert plan.threads == deep.MAX_THREADS
                assert plan in deep.all_multinomial_plans(E, C, I, K)
                # a warp a lane while the launch keeps a warp a scheduler
                # at most, but one thread a lane
                assert plan.T == 1 or E * K * plan.T <= 32 * deep.LANE_WARPS
                wider = 2 * plan.T
                assert wider > 32 or E * K * wider > 32 * deep.LANE_WARPS
                # the lanes' arrays in shared memory where they fit
                need = 4 * plan.lanes_per_block * deep.lane_floats(
                    C, I, plan.T)
                assert plan.shared_bytes == (need if need <= deep.MAX_SHARED
                                             else 0)


@pytest.mark.parametrize("E,C,T,G,S", [
    (16, 4, 32, 4, 8),       # the deep catalog's bucket: 96 lanes
    (64, 4, 32, 4, 8),       # 64 events (threshold, 10^6 reads): 384
    (16, 256, 32, 32, 1),    # a paired-end deep bucket of 256 classes
    (4, 1, 32, 1, 32),       # one class: a slot of 32 tries
    (110, 4, 32, 4, 8),      # 660 lanes: the last warp-per-lane launch
    (111, 4, 16, 4, 4),      # 666 lanes: two a warp
    (256, 4, 8, 4, 2),       # 1,536 lanes: four a warp
    (2048, 256, 1, 1, 1)])   # 12,288 lanes: 32 a warp
def test_multinomial_plan_of_the_deep_paths(E, C, T, G, S):
    """A warp per lane up to LANE_WARPS lanes (6 chains), lanes packed
    into warps past it; a lane's T threads form G class slots of S
    threads that try a draw's calls at once."""
    plan = deep.multinomial_plan(E, C, 2, 6)
    assert (plan.T, plan.lanes_per_block) == (T, 32 // T)
    assert deep.class_slots(C, plan.T) == G and plan.T // G == S
    assert plan.shared_bytes == 4 * plan.lanes_per_block * (
        (deep.LANE_ARRAYS + G) * 2 + min(T, deep.AHEAD_FLOATS // 3) * 3)
    assert [p.T for p in deep.all_multinomial_plans(E, C, 2, 6)] == list(
        deep.LANE_THREADS)


@pytest.mark.parametrize("C,I,T,shared", [
    (4, 2, 32, True), (256, 1024, 32, True), (4, 3600, 32, True),
    (4, 3700, 32, False), (256, 1300, 32, False), (1, 60000, 1, False)])
def test_multinomial_lane_arrays_leave_shared_memory_only_past_it(C, I, T,
                                                                  shared):
    """The widths whose lane arrays pass the block's shared memory take
    them from scratch (shared_bytes 0): from about 3,630 isoforms at 4
    classes, 1,260 at 32 classes or more."""
    plan = next(p for p in deep.all_multinomial_plans(1, C, I, 1)
                if p.T == T)
    assert (plan.shared_bytes > 0) == shared
    assert deep.ahead_steps(I, T) == max(1, min(T, 4096 // (I + 1)))


@pytest.mark.parametrize("E,C,I,K", [(0, 4, 2, 6), (8, 0, 2, 6),
                                     (8, 4, 1, 6), (8, 4, 2, 0)])
def test_multinomial_plan_rejects_what_the_kernel_does_not_take(E, C, I, K):
    with pytest.raises(ValueError):
        deep.multinomial_plan(E, C, I, K)
    with pytest.raises(ValueError):
        deep.all_multinomial_plans(E, C, I, K)


def test_multinomial_plan_constants_equal_the_kernel_source():
    with open(os.path.join(CSRC_DIR, "multinomial_kernel.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(r"constexpr int %s = (\d+)" % name,
                             src).group(1))

    assert const("kMaxThreads") == deep.MAX_THREADS
    assert const("kLaneArrays") == deep.LANE_ARRAYS
    assert const("kAheadFloats") == deep.AHEAD_FLOATS
    assert const("kMaxShared") == deep.MAX_SHARED
    # one instance, of runtime width, its lane arrays in dynamic shared
    # memory, the kLaneArrays of them named once each
    assert "template <int" not in src
    assert src.count("multinomial_kernel<<<") == 1
    assert "extern __shared__" in src
    at = re.findall(r"L\.\w+ = base \+ (\d+) \* I;",
                    src.replace("= base;", "= base + 0 * I;"))
    assert sorted(map(int, at)) == list(range(deep.LANE_ARRAYS))
    from miso_tpu_torch import kernels
    assert kernels.SOURCE_FLAGS["multinomial_kernel.cu"] == ["-fmad=false"]


def test_multinomial_bound_arithmetic():
    E, C, I, K, iters, rec = 16, 4, 2, 6, 5000, 450
    b = deep.multinomial_bound(E, C, I, K, iters, rec)
    steps, lanes = iters + 1, E * K
    assert b["bytes"] == 4 * (2 * E * C * I + E * C + 5 * E * I + 2 * E
                              + E * rec * K * (I + 1) + lanes * (2 * I + 1))
    draws = K * E * C * (I - 1)
    assert b["int_ops"] == steps * (lanes * 2 + draws) * 40
    assert b["fp32_ops"] == steps * (lanes * 20 * I + K * E * C * 6 * I
                                     + draws * 20)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(
        1e3 * b["int_ops"] / 16.75e12)
    assert 0.005 < b["bound_ms"] < 0.01
    fewer = deep.multinomial_bound(E, C, I, K, iters, rec,
                                   live_classes=E * 3)
    assert fewer["int_ops"] == b["int_ops"] - steps * K * E * 40
    assert fewer["bytes"] == b["bytes"]
    # no steps: the bytes bound it
    assert deep.multinomial_bound(2048, 256, 2, 1, 0, 0)["bound_by"] \
        == "bytes"


def test_multinomial_floor_is_a_chain_of_steps():
    """The dependent-chain floor grows with the steps, the rounds of
    class slots and the isoforms, with the accepts and the slow tests,
    and shrinks as a lane widens over the classes: about 2.5 ms at the
    deep catalog's shape, whatever the tries' threads."""
    base = deep.multinomial_floor(4, 2, 32, 5000)
    assert 2.0 < base < 3.0
    assert deep.multinomial_floor(4, 2, 4, 5000) == base
    assert deep.multinomial_floor(4, 2, 32, 10001) == pytest.approx(
        2 * base)
    assert deep.multinomial_floor(4, 2, 1, 5000) > base
    assert deep.multinomial_floor(4, 3, 32, 5000) > base
    assert deep.multinomial_floor(256, 2, 32, 5000) > base
    assert deep.multinomial_floor(4, 2, 32, 5000, accept_share=1.0) > base
    assert deep.multinomial_floor(4, 2, 32, 5000, slow_per_draw=0.0) < base
