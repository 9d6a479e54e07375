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
``multinomial_plan``: a lane is a group of T threads inside a warp, which
split the event's classes; the I-wide MH arithmetic they repeat.

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
from miso_tpu_torch.sampler.reassign_kernel import (FILL_WARPS, FIXED_U,
                                                    PHILOX_INT_OPS, _checked,
                                                    _event_consts, _mh_chain,
                                                    _result, _seq_sum,
                                                    _uniforms, bound)

LAUNCHES = {"cuda": 0, "plain": 0}

# The launch plan's constants; csrc/multinomial_kernel.cu holds the same
# block size (kMaxThreads) and per-isoform array count (kArrays): the
# kernel takes any width I at run time, a thread's arrays in a scratch
# buffer of SCRATCH_ARRAYS * I floats a thread that the wrapper allocates
LANE_THREADS = (1, 2, 4, 8, 16, 32)
MAX_THREADS = 128
SCRATCH_ARRAYS = 13


class MultinomialPlan(NamedTuple):
    """How one launch of the kernel is laid out."""
    T: int                 # threads of a lane (one (event, chain) chain)
    lanes_per_block: int
    threads: int           # lanes_per_block * T, a multiple of 32


def _check_shape(E: int, C: int, I: int, K: int) -> None:
    if E < 1 or C < 1 or K < 1 or I < 2:
        raise ValueError("the multinomial kernel takes E, C and K positive "
                         "and I >= 2 (got E=%d, C=%d, I=%d, K=%d)"
                         % (E, C, I, K))


def _layout(T: int) -> MultinomialPlan:
    return MultinomialPlan(T=T, lanes_per_block=MAX_THREADS // T,
                           threads=MAX_THREADS)


def multinomial_plan(E: int, C: int, I: int, K: int) -> MultinomialPlan:
    """The kernel's launch for E events of (C, I) class weights and K
    chains.  A lane's threads split the event's classes, so a step's
    Gibbs draws shorten as T grows up to C; past C a thread has no class.
    T is the widest lane that has a class for every thread (up to the
    power of two at or above C) and keeps the launch within
    ``FILL_WARPS`` warps (E * K * T / 32), one thread where none does."""
    _check_shape(E, C, I, K)
    T = 1
    for wider in LANE_THREADS[1:]:
        if wider < 2 * C and E * K * wider <= 32 * FILL_WARPS:
            T = wider
    return _layout(T)


def all_multinomial_plans(E: int, C: int, I: int, K: int):
    """Every plan the kernel can be launched with at this shape, one per
    lane width: the card's checks run them all
    (``_multinomial_cuda(..., plan=...)``)."""
    _check_shape(E, C, I, K)
    return [_layout(T) for T in LANE_THREADS]


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


# Latencies behind ``multinomial_floor`` (clocks; the data sheet's, not
# measured): a dependent FP32 or integer instruction 4, a special
# function (exp, log, sin, cos, sqrt) about 18, a shuffle about 24, a
# double-precision instruction 8; one Philox call is 10 rounds of a
# multiply-high and a three-way xor, about 10 clocks a round.
DEP_CLOCKS, MUFU_CLOCKS, SHUFFLE_CLOCKS, FP64_CLOCKS = 4, 18, 24, 8
PHILOX_CLOCKS = 100
SM_CLOCK_HZ = 1.98e9   # the H100's SM clock under load, by nvidia-smi


def multinomial_floor(C: int, I: int, T: int, iters: int):
    """The dependent-chain floor of one launch in milliseconds: the
    latency of the longest chain of a step, times iters + 1 steps, at
    ``SM_CLOCK_HZ``.  A step's chain: a Philox call and Box-Muller
    (log, sqrt, cos), the proposal's exp, the two logs and the division of
    the state's statistics, about 3 I dependent sums and 10 instructions
    of MH ratio; then each of the ceil(C / T) classes of a thread in turn:
    its I products and sum, a division, the reverse sum, and I - 1
    binomials of a Philox call and BTRS's quick acceptance (about 12
    double instructions); then a butterfly of log2(T) shuffle levels.
    An estimate for what a timed launch is read against, not a bound."""
    mh = (PHILOX_CLOCKS + 3 * MUFU_CLOCKS + MUFU_CLOCKS + 2 * MUFU_CLOCKS
          + DEP_CLOCKS * (3 * I + 10))
    per_class = (DEP_CLOCKS * (3 * I) + 2 * MUFU_CLOCKS
                 + (I - 1) * (PHILOX_CLOCKS + 12 * FP64_CLOCKS))
    levels = max(T.bit_length() - 1, 0)
    step = mh + -(-C // T) * per_class + levels * SHUFFLE_CLOCKS
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
    # a thread's per-isoform arrays, for every thread the launch starts
    blocks = -(-E * K // max(plan.lanes_per_block, 1))
    scratch = torch.empty(blocks * plan.lanes_per_block * plan.T
                          * SCRATCH_ARRAYS * I, dtype=f32, device=dev)
    lib = kernels.load()
    seed = int(seed) & ((1 << 64) - 1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.miso_multinomial(
            *[t.data_ptr() for t in inputs],
            None if start is None else start.data_ptr(),
            psi_out.data_ptr(), ll_out.data_ptr(), acc.data_ptr(),
            final_n.data_ptr(), final_psi.data_ptr(),
            scratch.data_ptr(),
            E, C, I, K, cfg.iters, cfg.burn_in, cfg.lag, RREC,
            seed & 0xFFFFFFFF, seed >> 32, int(bool(fixed)),
            plan.T, plan.lanes_per_block, stream)
    kernels.check(lib, rc, "multinomial kernel launch (%s)" % (plan,))
    LAUNCHES["cuda"] += 1
    return _result(psi_out, ll_out, acc, final_n, final_psi, cfg)
