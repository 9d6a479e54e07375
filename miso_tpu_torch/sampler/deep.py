"""Deep REASSIGN events: the chain with the per-class multinomial Gibbs
step, as the hand-written CUDA kernel B3 and its plain version.

The counterpart of the JAX package's route for REASSIGN buckets of more
than 16,384 reads (``miso_tpu/pipeline.py:456-472``): ``gibbs =
"multinomial"`` through the XLA scan (``mcmc.run_batch``, Gibbs step
``model.gibbs_reassign``), never the Pallas kernel, and no per-read tiles
at all (``pad_events(per_read=False)``).  Its device memory and
per-iteration work are O(classes), whatever the depth.

- A batch on a CUDA device runs ``csrc/multinomial_kernel.cu``: the whole
  chain of every (event, chain) lane in one launch.  If the kernel does
  not build or launch, the call raises; nothing falls back.
- A batch on the CPU runs ``_multinomial_plain``: batched torch over the
  lanes, the alpha-space MH step of ``reassign_kernel._mh_chain`` around
  ``model.gibbs_reassign``, with a Python loop over iterations.
  ``chip_smoke.py`` holds the kernel against it on the card.

What bounds the kernel on an H100: the dependent chain of a step, not
bytes or operations (``multinomial_bound`` and ``multinomial_floor``).
Its design (see the .cu header) is fixed per launch by
``multinomial_plan``: a lane is a group of T threads inside a one-warp
block (a warp of its own while the launch is small), in class slots that
try a binomial draw's calls at once; the I-wide MH arithmetic they
repeat, on the lane's arrays in shared memory.

``fixed_uniform=0.4999`` replaces every uniform, as in the other
kernels; each binomial of the chain is then floor(n * ratio + u) clipped
to [0, n] (``model.gibbs_reassign``), so both routes give one chain.

``run_batch_multinomial`` takes the same batch, ``start_psi`` (E, K, I)
and result layout as ``run_batch_reassign``; the per-read fields may be
the (E, 1, I) placeholders.  ``final_n`` sums exactly to each event's
compatible reads (f32 counts are exact below 2^24 reads).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from miso_tpu_torch.sampler.mcmc import (EventBatch, SamplerConfig,
                                         SamplerResult)
from miso_tpu_torch.sampler.model import gibbs_reassign
from miso_tpu_torch.sampler.reassign_kernel import (FIXED_U, PHILOX_INT_OPS,
                                                    SMS, _checked,
                                                    _event_consts, _mh_chain,
                                                    _result, _seq_sum,
                                                    _uniforms, bound)

LAUNCHES = {"cuda": 0, "plain": 0}

# The launch plan's constants; csrc/multinomial_kernel.cu holds the same
# block size (kMaxThreads, one warp), per-isoform array count of a lane
# (kLaneArrays), cap of the randoms drawn ahead (kAheadFloats) and
# dynamic shared memory of a block (kMaxShared).  The kernel takes any
# width I at run time; a lane's arrays lie in shared memory, or, where
# they exceed it, in a scratch buffer that the wrapper allocates.
LANE_THREADS = (1, 2, 4, 8, 16, 32)
MAX_THREADS = 32
LANE_ARRAYS = 11
AHEAD_FLOATS = 4096
MAX_SHARED = 232448
# The warps a launch keeps at most, five an SM.  A lane's chain is
# latency-bound; past this count the warps' interleaving on an SM slows
# each more than lanes sharing a warp do (the deep catalog's bucket tiled
# to 384 ... 12,288 lanes, every plan timed on an H100: PERF.md).
LANE_WARPS = 5 * SMS


class MultinomialPlan(NamedTuple):
    """How one launch of the kernel is laid out."""
    T: int                 # threads of a lane (one (event, chain) chain)
    lanes_per_block: int
    threads: int           # lanes_per_block * T: one warp
    shared_bytes: int      # the lanes' arrays; 0: in scratch


def class_slots(C: int, T: int) -> int:
    """G, the class slots of a lane: the power of two at or above C, at
    most T.  A slot's T / G threads try a draw's calls at once."""
    G = 1
    while G < C and G < T:
        G *= 2
    return G


def ahead_steps(I: int, T: int) -> int:
    """D, the steps whose randoms a lane draws at once: T, fewer where
    D * (I + 1) floats would pass AHEAD_FLOATS."""
    return max(1, min(T, AHEAD_FLOATS // (I + 1)))


def lane_floats(C: int, I: int, T: int) -> int:
    """A lane's arrays in floats: LANE_ARRAYS of I, a ratio array per
    class slot, and the normals and log u_accept of D steps."""
    return ((LANE_ARRAYS + class_slots(C, T)) * I
            + ahead_steps(I, T) * (I + 1))


def _check_shape(E: int, C: int, I: int, K: int) -> None:
    if E < 1 or C < 1 or K < 1 or I < 2:
        raise ValueError("the multinomial kernel takes E, C and K positive "
                         "and I >= 2 (got E=%d, C=%d, I=%d, K=%d)"
                         % (E, C, I, K))


def _layout(C: int, I: int, T: int) -> MultinomialPlan:
    lanes_per_block = MAX_THREADS // T
    need = 4 * lanes_per_block * lane_floats(C, I, T)
    return MultinomialPlan(T=T, lanes_per_block=lanes_per_block,
                           threads=MAX_THREADS,
                           shared_bytes=need if need <= MAX_SHARED else 0)


def multinomial_plan(E: int, C: int, I: int, K: int) -> MultinomialPlan:
    """The kernel's launch for E events of (C, I) class weights and K
    chains.  A lane is one chain of 5,001 dependent steps, and a warp
    pays for the longest rejection loop among its lanes' draws, so a lane
    takes a warp of its own (T = 32: class slots for up to 32 classes,
    and the threads a slot has beyond its class try a draw's calls at
    once) up to ``LANE_WARPS`` lanes (660).  Past that, lanes share warps
    (T halves, down to 1) so that the launch keeps at most LANE_WARPS
    warps: an SM that interleaves more latency-bound warps slows each
    more than the lanes that share a warp do."""
    _check_shape(E, C, I, K)
    T = 1
    for wider in LANE_THREADS[1:]:
        if E * K * wider <= 32 * LANE_WARPS:
            T = wider
    return _layout(C, I, T)


def all_multinomial_plans(E: int, C: int, I: int, K: int):
    """Every plan the kernel can be launched with at this shape, one per
    lane width: the card's checks run them all
    (``_multinomial_cuda(..., plan=...)``).  ``plan._replace(
    shared_bytes=0)`` puts a plan's lane arrays in scratch."""
    _check_shape(E, C, I, K)
    return [_layout(C, I, T) for T in LANE_THREADS]


# Per step and lane, beside the Philox calls: the proposal and MH
# arithmetic (as reassign_bound counts it), and for every class with
# reads the I products, sums, divisions and ratios of its probabilities
# and, per binomial, the arithmetic of BTRS's quick acceptance.
MH_FP_PER_ISO = 20
CLASS_FP_PER_ISO = 6
BINOMIAL_FP = 20


def multinomial_bound(E: int, C: int, I: int, K: int, iters: int,
                      num_records: int, live_classes=None):
    """The least time an H100 could take for one launch, as
    ``reassign_bound`` gives it for REASSIGN: bytes moved (each input read
    once, each output written once) and operations of the function, each
    at the card's rate (``bound``).  Per step (iters + 1) and lane: the
    proposal's normals (one Philox call per pair) and accept draw, about
    20 I FP32 operations of proposal and MH; for each class with reads
    (``live_classes`` in all, default E * C) 6 I FP32 operations and I - 1
    binomial draws of one Philox call and 20 FP32 operations each (the
    last isoform takes the remainder)."""
    if live_classes is None:
        live_classes = E * C
    steps = iters + 1
    lanes = E * K
    in_bytes = 4 * (2 * E * C * I + E * C + 5 * E * I + 2 * E)
    out_bytes = 4 * (E * num_records * K * (I + 1) + E * K * (2 * I + 1))
    draws = K * live_classes * (I - 1)
    int_ops = steps * (lanes * ((I + 1) // 2 + 1) + draws) * PHILOX_INT_OPS
    fp_ops = steps * (lanes * MH_FP_PER_ISO * I
                      + K * live_classes * CLASS_FP_PER_ISO * I
                      + draws * BINOMIAL_FP)
    return bound(in_bytes + out_bytes, fp_ops, int_ops)


# Latencies behind ``multinomial_floor``, in clocks.  Measured on an
# H100 (NVIDIA H100 80GB HBM3, 700 W) by the latency probe of the
# step-breakdown build (``chip_smoke.py``'s ``b3_latencies``: one warp,
# 4,096 operations in a dependent chain): a double log 302, a double
# division 82, a double square root 102, a double FMA 16, an f32 logf 91,
# expf 46 and division 84, a shuffle 30 (a vote is taken as one).
# Assumed (the data sheet's): a dependent FP32 or integer instruction 4.
LOG64_CLOCKS, DIV64_CLOCKS, SQRT64_CLOCKS, FP64_CLOCKS = 302, 82, 102, 16
LOGF_CLOCKS, EXPF_CLOCKS, DIVF_CLOCKS, SHUFFLE_CLOCKS = 91, 46, 84, 30
DEP_CLOCKS = 4
# The SM clock a launch runs at: what the breakdown's stamps imply
# (a lane's clocks over the launch's time, 1,570-1,700 MHz at the deep
# shapes), not nvidia-smi's maximum of 1,980.
SM_CLOCK_HZ = 1.65e9
# The share of steps whose MH accepts (the ratios and BTRS's set-up are
# then worked out anew) and the slow tests a BTRS draw runs, at the deep
# catalog's bucket (the breakdown: 36.3 % and 0.27 x 1.14 tries).
ACCEPT_SHARE, SLOW_PER_DRAW = 0.363, 0.31


def multinomial_floor(C: int, I: int, T: int, iters: int,
                      accept_share: float = ACCEPT_SHARE,
                      slow_per_draw: float = SLOW_PER_DRAW):
    """The dependent-chain floor of one launch in milliseconds: the
    latency of the chain of a step that depends on the chain's state,
    every value in registers, times iters + 1 steps at ``SM_CLOCK_HZ``.
    Randoms are not on it: they depend on (lane, step) alone and can be
    drawn ahead (the kernel draws the normals so; a try's Philox call it
    still makes on the chain).  A step: the proposal's exp, the two logs
    of its statistics (side by side) and about 3 I + 10 dependent FP32
    instructions of the MH ratio; then, in each of the ceil(C / G) rounds
    of class slots (G = ``class_slots``), on an accept the class's ratios
    (two f32 divisions and I sums) and BTRS's set-up (a square root and
    a division), and I - 1 draws of one try each (the proposal's double
    division and 8 double instructions, two votes and a shuffle) with
    ``slow_per_draw`` slow tests (a double log and two divisions); and
    the counts' butterfly over the slots.  An estimate built from the
    measured latencies above, read against a timed launch; not a
    bound."""
    G = class_slots(C, T)
    mh = (EXPF_CLOCKS + LOGF_CLOCKS + DEP_CLOCKS * (3 * I + 10))
    fresh = accept_share * (2 * DIVF_CLOCKS + DEP_CLOCKS * I
                            + SQRT64_CLOCKS + DIV64_CLOCKS)
    draw = (DIV64_CLOCKS + 8 * FP64_CLOCKS + 3 * SHUFFLE_CLOCKS
            + slow_per_draw * (LOG64_CLOCKS + 2 * DIV64_CLOCKS))
    levels = G.bit_length() - 1   # the butterfly over the slots
    step = (mh + -(-C // G) * (fresh + (I - 1) * draw)
            + (I - 1) * levels * SHUFFLE_CLOCKS)
    return 1e3 * (iters + 1) * step / SM_CLOCK_HZ


# Barrier latencies behind ``marginal_wide_floor``, in clocks: measured
# on an H100 (NVIDIA H100 80GB HBM3, 700 W) by the barrier probe of B2w's
# step-breakdown build (``chip_smoke.py``'s ``b2w_latencies``: 4,096
# barriers in a row, nothing else): a block barrier 14.7 clocks at 32
# threads and 44.7 at 512; a cluster barrier (arrive.release,
# wait.acquire: a GPU-scope fence and an L1 invalidation in the SASS)
# 1,300-1,306 at 2 blocks of 512, 1,318-1,345 at 4, 1,376-1,404 at 8.
BLOCK_BAR_CLOCKS = {32: 14.7, 512: 44.7}
CLUSTER_BAR_CLOCKS = {2: 1303.0, 4: 1324.0, 8: 1382.0}
# B2w's barriers a step besides the one that ends the class terms
B2W_BARRIERS = 5


def marginal_wide_floor(C: int, I: int, threads: int, cluster: int,
                        iters: int, clocks=None) -> float:
    """The dependent-chain floor of one B2w launch in milliseconds: the
    latency of the chain of a step that depends on the chain's state,
    every lane's values where they are needed, times iters + 1 steps at
    ``SM_CLOCK_HZ``.  Randoms are not on it (they depend on (lane, step)
    alone and are drawn ahead).  A step, in the kernel's summing order
    (slot l adds 4 chunks(n) values in turn, then a butterfly of five
    shuffles): alpha' (two dependent FP32 instructions) and exp; the sum
    of exp over the isoforms; the division; the sum of the head's psi';
    psi' (two instructions); then, side by side, a class row's dot
    product (its 4 chunks(I) adds and butterfly), log and product by the
    count, or log psi' and the quadratics' sum; the exchange of the
    class terms (a block barrier, or at ``cluster`` > 1 a cluster
    barrier); the class terms' sum over 4 chunks(C); about ten
    instructions of MH; and ``B2W_BARRIERS`` block barriers of
    ``threads``.  ``clocks`` replaces the latencies above by a run's own
    probes (``Expf``, ``Logf``, ``Divf``, ``Shfl``, ``Bar32``, ``Bar512``,
    ``Cluster2`` ...).  An estimate built from measured latencies, read
    against a timed launch; not a bound."""
    lat = {"Expf": EXPF_CLOCKS, "Logf": LOGF_CLOCKS, "Divf": DIVF_CLOCKS,
           "Shfl": SHUFFLE_CLOCKS, "Bar32": BLOCK_BAR_CLOCKS[32],
           "Bar512": BLOCK_BAR_CLOCKS[512]}
    lat.update({"Cluster%d" % c: x for c, x in CLUSTER_BAR_CLOCKS.items()})
    lat.update(clocks or {})
    dep = DEP_CLOCKS

    def chunk_sum(n):
        return 4 * -(-n // 128) * dep + 5 * (lat["Shfl"] + dep)

    bar = lat["Bar32"] + (lat["Bar512"] - lat["Bar32"]) * (
        threads // 32 - 1) / 15
    exchange = lat["Cluster%d" % cluster] if cluster > 1 else bar
    row = chunk_sum(I) + lat["Logf"] + dep
    quad = lat["Logf"] + 3 * dep + chunk_sum(I)
    step = (2 * dep + lat["Expf"] + chunk_sum(I) + dep + lat["Divf"]
            + chunk_sum(I) + 2 * dep + max(row, quad) + exchange
            + chunk_sum(C) + 10 * dep + B2W_BARRIERS * bar)
    return 1e3 * (iters + 1) * step / SM_CLOCK_HZ


def run_batch_multinomial(seed: int, batch: EventBatch, cfg: SamplerConfig,
                          start_psi=None, fixed_uniform=None
                          ) -> SamplerResult:
    """REASSIGN with the multinomial Gibbs step over a padded batch, on
    the batch's device.  ``seed`` is an int: the kernel's Philox key or
    the plain version's ``torch.Generator`` seed.  ``start_psi`` (E, K, I)
    selects the GIVEN start."""
    if cfg.algorithm != "reassign":
        raise ValueError("run_batch_multinomial runs REASSIGN only (got %s)"
                         % cfg.algorithm)
    if cfg.lag < 1 or cfg.iters < 0 or cfg.burn_in < 0 or cfg.chains < 1:
        raise ValueError("bad sampler schedule: %r" % (cfg,))
    if fixed_uniform is not None and fixed_uniform != FIXED_U:
        raise ValueError("fixed_uniform must be None or %r" % FIXED_U)
    dev = batch.weights.device
    consts = _event_consts(batch)
    if dev.type == "cuda":
        return _multinomial_cuda(seed, batch, cfg, consts, start_psi,
                                 fixed_uniform is not None)
    if dev.type == "cpu":
        return _multinomial_plain(seed, batch, cfg, consts, start_psi,
                                  fixed_uniform)
    raise ValueError("no multinomial route for device %s" % dev)


def _multinomial_plain(seed, batch, cfg, consts, start_psi=None,
                       fixed_uniform=None) -> SamplerResult:
    """Plain PyTorch version of the kernel, batched over (E, K) lanes on
    any device.  ``fixed_uniform`` replaces every uniform and every
    binomial draw's randomness; otherwise a ``torch.Generator`` seeded
    with ``seed`` draws them."""
    LAUNCHES["plain"] += 1
    f32 = torch.float32
    gen, uniform = _uniforms(seed, batch.weights.device, fixed_uniform)
    W = batch.weights.to(f32)[:, None]                      # (E, 1, C, I)
    lr = batch.log_read.to(torch.float64)[:, None]
    # reads of classes with a compatible isoform (padded isoforms weigh
    # 0): the reads that count into some isoform, whatever psi is
    compat = W.sum(-1) > 0                                  # (E, 1, C)
    counts = torch.where(compat, batch.counts.to(f32)[:, None], 0.0)

    def gibbs(psi, want_rp):
        draws = gibbs_reassign(psi, W, counts, generator=gen,
                               uniform=fixed_uniform)       # (E, K, C, I)
        n = draws.sum(-2)
        # in double, where the integer draws times f32 scores are exact
        # and the order of the sum moves nothing the f32 result keeps
        rp = ((draws.double() * lr).sum((-1, -2)).to(f32) if want_rp
              else torch.zeros(n.shape[:2], dtype=f32, device=n.device))
        return n, rp

    # the isoform sums in the kernel's order: at 20,000 reads the MH
    # ratio multiplies their rounding by the reads, and one step of
    # another order flips an accept
    return _mh_chain(cfg, consts, start_psi, uniform, gibbs,
                     counts.sum(-1), _seq_sum)


def _multinomial_cuda(seed, batch, cfg, consts, start_psi, fixed,
                      plan=None):
    """Launch csrc/multinomial_kernel.cu on the batch's CUDA device, laid
    out by ``multinomial_plan`` (``plan`` forces another lane width: the
    card's checks run them all), on the device's current stream."""
    from miso_tpu_torch import kernels

    f32 = torch.float32
    E, C, I = batch.weights.shape
    K = cfg.chains
    RREC = max(cfg.num_records, 0)
    dev = batch.weights.device
    _check_shape(E, C, I, K)
    if plan is None:
        plan = multinomial_plan(E, C, I, K)
    inputs = [
        _checked(batch.weights, "weights", (E, C, I), f32, dev),
        _checked(batch.log_read, "log_read", (E, C, I), f32, dev),
        _checked(batch.counts, "counts", (E, C), f32, dev)]
    for name, c in zip(("log_iso_w", "hyper", "amask", "iso_mask",
                        "last_onehot"), consts[:5]):
        inputs.append(_checked(c, name, (E, I), f32, dev))
    inputs.append(_checked(consts[5], "scal", (E, 2), f32, dev))
    start = None
    if start_psi is not None:
        start = _checked(start_psi, "start_psi", (E, K, I), f32, dev)
    psi_out = torch.empty((E, RREC, K, I), dtype=f32, device=dev)
    ll_out = torch.empty((E, RREC, K), dtype=f32, device=dev)
    acc = torch.empty((E, K), dtype=torch.int32, device=dev)
    final_n = torch.empty((E, K, I), dtype=f32, device=dev)
    final_psi = torch.empty((E, K, I), dtype=f32, device=dev)
    # the lanes' arrays where the plan gives them no shared memory, for
    # every lane the launch starts
    scratch = None
    if plan.shared_bytes == 0:
        blocks = -(-E * K // max(plan.lanes_per_block, 1))
        scratch = torch.empty(
            blocks * plan.lanes_per_block * lane_floats(C, I, plan.T),
            dtype=f32, device=dev)
    lib = kernels.load()
    seed = int(seed) & ((1 << 64) - 1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.miso_multinomial(
            *[t.data_ptr() for t in inputs],
            None if start is None else start.data_ptr(),
            psi_out.data_ptr(), ll_out.data_ptr(), acc.data_ptr(),
            final_n.data_ptr(), final_psi.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            E, C, I, K, cfg.iters, cfg.burn_in, cfg.lag, RREC,
            seed & 0xFFFFFFFF, seed >> 32, int(bool(fixed)),
            plan.T, plan.lanes_per_block, plan.shared_bytes, stream)
    kernels.check(lib, rc, "multinomial kernel launch (%s)" % (plan,))
    LAUNCHES["cuda"] += 1
    return _result(psi_out, ll_out, acc, final_n, final_psi, cfg)
