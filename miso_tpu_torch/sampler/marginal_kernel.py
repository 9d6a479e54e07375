"""MARGINAL / CLASSES sampler: the hand-written CUDA kernel and its plain
version.

Replaces ``miso_tpu/sampler/pallas_marginal.py::_marginal_kernel``
(launcher ``run_batch_pallas_marginal``, ``pl.pallas_call`` at :322).
``run_batch_marginal`` takes the same batch, ``start_psi`` (E, K, I) and
result layout.  The collapsed algorithms have no Gibbs step, so
``final_n`` is zeros: the pipeline draws the final assignment on the host
(``CompiledEvent.final_assignment_counts``).

- A batch on a CUDA device runs ``csrc/marginal_kernel.cu`` (B2) below
  ``wide.WIDE_FROM_MARGINAL`` (64) isoforms and ``csrc/wide_kernel.cu``
  (B2w, a lane a block, any width) from there on: at 64 isoforms B2's
  sums in sequence round the MH ratio away from the reference's, and
  B2w is faster there too (``wide.py``).  If the kernel does not build or
  launch, the call raises; nothing falls back.
- A batch on the CPU runs ``_marginal_plain``: batched torch over the
  (event, chain) lanes with a Python loop over iterations.  It computes
  what the kernel computes, in the TPU kernel's psi-space form
  (``pallas_marginal.py:86-161``), and ``chip_smoke.py`` holds the kernel
  against it on the card.

What bounds the kernel on an H100: the dependent chain of a step (alpha
-> exp -> division -> log -> dot product -> log -> ordered sum ->
compare, all precise f32) times 5,001 dependent steps, then operations;
parallelism exists only across the E*K lanes.  Its design (see the .cu
header) is fixed per launch by ``marginal_plan``, plain Python that the
CPU tests check: a lane is a group of T threads inside a warp, which
split the event's classes and draw the randoms of T steps ahead of the
chain; the I-wide arithmetic they repeat, so T narrows as the card fills
and stays at two from 16 isoforms on; the current score and the state's
part of the proposal density are carried from the accepted state.

Both routes sum in a fixed order -- s_c = sum_i W_ci psi_i over isoforms,
then sum_c counts_c log s_c over classes -- and never through ``@``: a
contraction that rounds through TF32 moves the MH ratio by whole units
(docs/VALIDATION.md:106-114).  ``fixed_uniform=0.4999`` replaces every
uniform, as the TPU kernel's ``_DEBUG_NO_PRNG`` does; the proposal
normals are then cos-only Box-Muller (``pallas_kernel._normal``), so
both routes reproduce the JAX kernel's chain.  On B2w's route the plain
version sums as B2w does (``wide.wide_sum``, over isoforms and over
classes).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from miso_tpu_torch.sampler import wide
from miso_tpu_torch.sampler.mcmc import EventBatch, SamplerConfig
from miso_tpu_torch.sampler.reassign_kernel import (FILL_WARPS, FIXED_U,
                                                    KERNEL_ISO,
                                                    PHILOX_INT_OPS, TWO_PI,
                                                    _U24, _checked,
                                                    _is_record, _result,
                                                    _seq_sum, bound)

# launches of B2 ("cuda"), of B2w ("wide") and of the plain version
LAUNCHES = {"cuda": 0, "wide": 0, "plain": 0}
TINY = 1e-38
# A logf / expf call beside an FP32 instruction: the special-function
# unit takes 16 a clock on each SM, the FP32 pipe 128.
SFU_COST = 8


# The launch plan's constants; csrc/marginal_kernel.cu holds the same
# block size (kMaxThreads, its __launch_bounds__).
LANE_THREADS = (1, 2, 4, 8, 16, 32)
MAX_THREADS = 128
# A lane wider than the event's classes only draws the randoms further
# ahead: worth its redundant work up to half of FILL_WARPS.
AHEAD_WARPS = FILL_WARPS // 2
# (from this many isoforms on, the widest lane): a thread's I-wide state
# fills the register file from 16 isoforms on (206 to 255 registers,
# spills from 32); wider lanes lost at every such width timed (PERF.md).
WIDE_ISO = ((16, 2),)


class MarginalPlan(NamedTuple):
    """How one launch of the kernel is laid out."""
    T: int                 # threads of a lane (one (event, chain) chain)
    lanes_per_block: int
    threads: int           # lanes_per_block * T, a multiple of 32


def _check_shape(E: int, C: int, I: int, K: int) -> None:
    if I not in KERNEL_ISO:
        raise ValueError("the MARGINAL kernel takes I in %s, got %d"
                         % (KERNEL_ISO, I))
    if E < 1 or C < 1 or K < 1:
        raise ValueError("the MARGINAL kernel takes E, C and K positive "
                         "(got E=%d, C=%d, K=%d)" % (E, C, K))


def _layout(T: int) -> MarginalPlan:
    return MarginalPlan(T=T, lanes_per_block=MAX_THREADS // T,
                        threads=MAX_THREADS)


def marginal_plan(E: int, C: int, I: int, K: int) -> MarginalPlan:
    """The kernel's launch for E events of (C, I) class weights and K
    chains.

    A lane's threads split the event's classes and draw the randoms of
    as many steps ahead; everything I-wide they repeat.  A small launch
    is bound by the latency of a step and repeats for nothing, a full
    one pays for every repeated instruction.  So T is the widest lane
    whose launch stays within ``FILL_WARPS`` warps (E * K * T / 32), one
    thread where none does; a lane with more threads than classes stays
    within ``AHEAD_WARPS``; and wide isoform counts cap the lane
    (``WIDE_ISO``)."""
    _check_shape(E, C, I, K)
    lanes = E * K
    cap = next((t for i, t in WIDE_ISO if I >= i), LANE_THREADS[-1])
    T = 1
    for wider in LANE_THREADS[1:]:
        fill = AHEAD_WARPS if wider >= 2 * C else FILL_WARPS
        if wider <= cap and lanes * wider <= 32 * fill:
            T = wider
    return _layout(T)


def wide_plan(E: int, C: int, I: int, K: int) -> wide.WidePlan:
    """B2w's launch for E events of (C, I) class weights and K chains
    (``wide.marginal_plan``): a block, or a cluster of blocks, a lane,
    its warps over the classes and its threads over a class row's
    isoforms, the class rows in shared memory where they fit."""
    return wide.wide_plan("marginal", E, C, I, K)


def all_wide_plans(E: int, C: int, I: int, K: int):
    """Every block width, cluster size and home of the class rows B2w can
    be launched with at this shape."""
    return wide.all_wide_plans("marginal", E, C, I, K)


def all_marginal_plans(E: int, C: int, I: int, K: int):
    """Every plan the kernel can be launched with at this shape, one per
    lane width: the card's checks run them all
    (``_marginal_cuda(..., plan=...)``)."""
    _check_shape(E, C, I, K)
    return [_layout(T) for T in LANE_THREADS]


def marginal_bound(E: int, C: int, I: int, K: int, iters: int,
                   num_records: int, live_classes=None):
    """The least time an H100 could take for one MARGINAL/CLASSES launch,
    as ``reassign_bound`` gives it for REASSIGN.  Per step (iters + 1)
    and lane: for each class with reads (``live_classes`` in all,
    default E * C) I multiplies, I - 1 adds, one log and one
    multiply-add into the score; 2 I exp/log calls and about 12 I
    FP32 operations for the logistic map and the two proposal
    densities; one Philox call per normal pair and one for the accept
    draw."""
    if live_classes is None:
        live_classes = E * C
    steps = iters + 1
    lanes = E * K
    in_bytes = 4 * (E * C * I + E * C + E + E * I + 4 * E)
    out_bytes = 4 * (E * num_records * K * (I + 1) + E * K * (I + 1))
    fp_ops = steps * (K * live_classes * (2 * I + 1 + SFU_COST)
                      + lanes * (2 * I * SFU_COST + 12 * I))
    int_ops = steps * lanes * ((I + 1) // 2 + 1) * PHILOX_INT_OPS
    return bound(in_bytes + out_bytes, fp_ops, int_ops)


def _marginal_consts(batch: EventBatch):
    """Per-event constants shared by both routes (pallas_marginal.py:257-
    270): hyper h (E, I) with 1 on padded isoforms, and scal (E, 4) =
    (noise_scale, inv_sigma, prop_const, dir_const), f32.  sigma = 0.2/k^2
    and noise_scale is sigma for k = 2, else sqrt(sigma) (miso.c:188,
    :328).  k is clamped to 1 and dir_const is 0 without real isoforms,
    so padding events (k = 0) get finite constants and scores where the
    TPU kernel's are inf and NaN."""
    f32 = torch.float32
    num_iso = batch.num_iso.to(torch.int32)
    I = batch.weights.shape[2]
    ar = torch.arange(I, device=num_iso.device)[None, :]
    real = ar < num_iso[:, None]
    kf = num_iso.clamp_min(1).to(f32)
    sigma = 0.2 / (kf * kf)
    noise_scale = torch.where(num_iso == 2, sigma, torch.sqrt(sigma))
    inv_sigma = 1.0 / sigma
    prop_const = -0.5 * (kf - 1.0) * torch.log(2.0 * math.pi * sigma)
    h = torch.where(real, batch.hyper.to(f32), torch.ones_like(sigma[:, None]))
    zero = torch.zeros_like(h)
    dir_const = torch.where(
        num_iso > 0, torch.lgamma(torch.where(real, h, zero).sum(1))
        - torch.where(real, torch.lgamma(h), zero).sum(1), 0.0)
    scal = torch.stack([noise_scale, inv_sigma, prop_const, dir_const], 1)
    return h.contiguous(), scal.contiguous()


def run_batch_marginal(seed: int, batch: EventBatch, cfg: SamplerConfig,
                       start_psi=None, fixed_uniform=None):
    """MARGINAL / CLASSES over a padded batch, on the batch's device.
    ``seed`` is an int: the kernel's Philox key or the plain version's
    ``torch.Generator`` seed.  ``start_psi`` (E, K, I) selects the GIVEN
    start (miso.c:405-409).  Reads only the class tensors: ``read_w`` and
    ``read_logscore`` may be placeholders."""
    if cfg.algorithm not in ("marginal", "classes"):
        raise ValueError("run_batch_marginal runs MARGINAL or CLASSES "
                         "(got %s)" % cfg.algorithm)
    if cfg.lag < 1 or cfg.iters < 0 or cfg.burn_in < 0 or cfg.chains < 1:
        raise ValueError("bad sampler schedule: %r" % (cfg,))
    if fixed_uniform is not None and fixed_uniform != FIXED_U:
        raise ValueError("fixed_uniform must be None or %r" % FIXED_U)
    dev = batch.weights.device
    consts = _marginal_consts(batch)
    # from WIDE_FROM_MARGINAL isoforms on the wide kernel, or on the CPU
    # the plain version in its summing order
    wide_route = batch.weights.shape[2] >= wide.WIDE_FROM_MARGINAL
    if dev.type == "cuda":
        launch = _marginal_wide_cuda if wide_route else _marginal_cuda
        return launch(seed, batch, cfg, consts, start_psi,
                      fixed_uniform is not None)
    if dev.type == "cpu":
        return _marginal_plain(seed, batch, cfg, consts, start_psi,
                               fixed_uniform, wide_order=wide_route)
    raise ValueError("no MARGINAL route for device %s" % dev)


def _marginal_plain(seed, batch, cfg, consts, start_psi=None,
                    fixed_uniform=None, wide_order=None):
    """Plain PyTorch version of the kernel, batched over (E, K) lanes on
    any device.  ``fixed_uniform`` replaces every uniform; otherwise a
    ``torch.Generator`` seeded with ``seed`` draws them.  ``wide_order``
    sums as B2w does (``run_batch_marginal`` passes its route's order);
    its default is B2's order wherever B2 has an instance (up to
    ``max(KERNEL_ISO)`` isoforms: the checks hold B2 to it there), B2w's
    past it."""
    LAUNCHES["plain"] += 1
    f32 = torch.float32
    E, C, I = batch.weights.shape
    K = cfg.chains
    dev = batch.weights.device
    if wide_order is None:
        wide_order = I > max(KERNEL_ISO)
    total = wide.wide_sum if wide_order else _seq_sum
    gen = None
    if fixed_uniform is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) % (1 << 63))

    h, scal = consts
    k = batch.num_iso.to(torch.int64)[:, None, None]     # (E, 1, 1)
    ar = torch.arange(I, device=dev)
    real = ar < k                                        # (E, 1, I)
    am = ar < k - 1
    amf = am.to(f32)
    lastf = (ar == k - 1).to(f32)
    ns, inv_sigma, prop_const, dir_const = (scal[:, None, j]
                                            for j in range(4))  # (E, 1)
    zero = torch.zeros((), dtype=f32, device=dev)
    h1 = torch.where(real, h[:, None] - 1.0, zero)       # (E, 1, I)
    W = batch.weights.to(f32)[:, None]                   # (E, 1, C, I)
    cnt = batch.counts.to(f32)[:, None]                  # (E, 1, C)
    H = (I + 1) // 2

    def normals():
        if gen is None:   # every row r*cos(2*pi*u), as _normal((I, B))
            u = torch.full((E, K, I), fixed_uniform, dtype=f32, device=dev)
            return torch.sqrt(-2.0 * torch.log(u.clamp_min(_U24))) * \
                torch.cos(TWO_PI * u)
        u1 = torch.rand((E, K, H), generator=gen, dtype=f32, device=dev)
        u2 = torch.rand((E, K, H), generator=gen, dtype=f32, device=dev)
        r = torch.sqrt(-2.0 * torch.log(u1.clamp_min(_U24)))
        ang = TWO_PI * u2
        return torch.cat([r * torch.cos(ang), r * torch.sin(ang)], -1)[..., :I]

    def logistic_inv(alpha):
        e = torch.exp(alpha) * amf
        head = e / (1.0 + total(e))[..., None]
        psi = head + lastf * (1.0 - total(head))[..., None]
        return psi, torch.log(psi.clamp_min(TINY))

    def joint(psi, lp):
        if wide_order:
            s = wide.wide_sum(W * psi[:, :, None, :])   # (E, K, C)
        else:
            s = W[..., 0] * psi[..., 0:1]                # (E, K, C)
            for i in range(1, I):
                s = s + W[..., i] * psi[..., i:i + 1]
        term = torch.where(s > 0, cnt * torch.log(s.clamp_min(TINY)), zero)
        return total(term) + (total(torch.where(real, h1 * lp, zero))
                              + dir_const)

    def proposal(psi, lp, mu):
        lt = torch.log(total(psi * lastf).clamp_min(TINY))
        a = torch.where(am, lp, zero)
        t = torch.where(am, (a - lt[..., None]) - mu, zero)
        return (prop_const - total(a) - lt
                + (-0.5 * total(t * t)) * inv_sigma)

    if start_psi is not None:
        sp = start_psi.to(f32)
        lsl = torch.log(total(sp * lastf).clamp_min(1e-30))
        alpha = torch.where(am, torch.log(sp.clamp_min(1e-30))
                            - lsl[..., None], zero)
    else:
        km1 = amf.sum(-1)                                # (E, 1)
        a0 = torch.where(km1 == 1.0, torch.zeros_like(km1),
                         1.0 / km1.clamp_min(1.0))
        alpha = torch.where(am, a0[..., None], zero).expand(E, K, I)
    alpha = alpha + ns[..., None] * normals() * amf
    psi, lp = logistic_inv(alpha)
    cjs = joint(psi, lp)

    RREC = max(cfg.num_records, 0)
    psi_out = torch.empty((E, RREC, K, I), dtype=f32, device=dev)
    ll_out = torch.empty((E, RREC, K), dtype=f32, device=dev)
    acc = torch.zeros((E, K), dtype=torch.int32, device=dev)
    rec = 0
    for m in range(cfg.iters):
        alpha_new = alpha + ns[..., None] * normals() * amf
        psi_new, lp_new = logistic_inv(alpha_new)
        pjs = joint(psi_new, lp_new)
        full = 1.0 if m > 0 else 0.0
        logr = (pjs - cjs) + full * (proposal(psi, lp, alpha_new)
                                     - proposal(psi_new, lp_new, alpha))
        if gen is None:
            u = torch.full((E, K), fixed_uniform, dtype=f32, device=dev)
        else:
            u = torch.rand((E, K), generator=gen, dtype=f32, device=dev)
        accept = (logr >= 0) | (torch.log(u.clamp_min(_U24)) < logr)
        a3 = accept[..., None]
        alpha = torch.where(a3, alpha_new, alpha)
        psi = torch.where(a3, psi_new, psi)
        lp = torch.where(a3, lp_new, lp)
        cjs = torch.where(accept, pjs, cjs)
        acc += accept.to(torch.int32)
        if _is_record(m, cfg) and rec < RREC:
            psi_out[:, rec] = psi
            ll_out[:, rec] = cjs
            rec += 1
    final_n = torch.zeros((E, K, I), dtype=f32, device=dev)
    return _result(psi_out, ll_out, acc, final_n, psi, cfg)


def _class_tensors(batch, cfg, consts, start_psi):
    """(inputs, start, outputs) of a MARGINAL launch, B2's or B2w's: the
    class tensors and constants checked on the batch's device, the GIVEN
    start or None, and empty psi records, log-likelihood records,
    acceptances and final psi."""
    f32 = torch.float32
    E, C, I = batch.weights.shape
    K = cfg.chains
    RREC = max(cfg.num_records, 0)
    dev = batch.weights.device
    inputs = [
        _checked(batch.weights, "weights", (E, C, I), f32, dev),
        _checked(batch.counts, "counts", (E, C), f32, dev),
        _checked(batch.num_iso, "num_iso", (E,), torch.int32, dev),
        _checked(consts[0], "hyper", (E, I), f32, dev),
        _checked(consts[1], "scal", (E, 4), f32, dev),
    ]
    start = None
    if start_psi is not None:
        start = _checked(start_psi, "start_psi", (E, K, I), f32, dev)
    outputs = (torch.empty((E, RREC, K, I), dtype=f32, device=dev),
               torch.empty((E, RREC, K), dtype=f32, device=dev),
               torch.empty((E, K), dtype=torch.int32, device=dev),
               torch.empty((E, K, I), dtype=f32, device=dev))
    return inputs, start, outputs


def _marginal_cuda(seed, batch, cfg, consts, start_psi, fixed, plan=None):
    """Launch csrc/marginal_kernel.cu on the batch's CUDA device, laid
    out by ``marginal_plan`` (``plan`` forces another lane width: the
    card's checks run them all)."""
    from miso_tpu_torch import kernels

    f32 = torch.float32
    E, C, I = batch.weights.shape
    K = cfg.chains
    RREC = max(cfg.num_records, 0)
    dev = batch.weights.device
    _check_shape(E, C, I, K)
    if plan is None:
        plan = marginal_plan(E, C, I, K)
    inputs, start, (psi_out, ll_out, acc, final_psi) = _class_tensors(
        batch, cfg, consts, start_psi)
    lib = kernels.load()
    seed = int(seed) & ((1 << 64) - 1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.miso_marginal(
            *[t.data_ptr() for t in inputs],
            None if start is None else start.data_ptr(),
            psi_out.data_ptr(), ll_out.data_ptr(), acc.data_ptr(),
            final_psi.data_ptr(), E, C, I, K, cfg.iters, cfg.burn_in,
            cfg.lag, RREC, seed & 0xFFFFFFFF, seed >> 32, int(bool(fixed)),
            plan.T, plan.lanes_per_block, stream)
    kernels.check(lib, rc, "marginal kernel launch (%s)" % (plan,))
    LAUNCHES["cuda"] += 1
    final_n = torch.zeros((E, K, I), dtype=f32, device=dev)
    return _result(psi_out, ll_out, acc, final_n, final_psi, cfg)


def _marginal_wide_cuda(seed, batch, cfg, consts, start_psi, fixed,
                        plan=None):
    """Launch B2w (csrc/wide_kernel.cu) on the batch's CUDA device, laid
    out by ``wide_plan`` (``plan`` forces another block width, cluster or
    home of the class rows, or ``shared_bytes=0`` the lane arrays into
    scratch).  A plan the card refuses raises; nothing relaunches it in
    another."""
    from miso_tpu_torch import kernels

    f32 = torch.float32
    E, C, I = batch.weights.shape
    K = cfg.chains
    RREC = max(cfg.num_records, 0)
    dev = batch.weights.device
    if plan is None:
        plan = wide_plan(E, C, I, K)
    inputs, start, (psi_out, ll_out, acc, final_psi) = _class_tensors(
        batch, cfg, consts, start_psi)
    # the lane arrays of every block where the plan gives them no shared
    # memory
    scratch = None
    if plan.shared_bytes == 0:
        scratch = torch.empty(
            E * K * plan.cluster * wide.lane_floats("marginal", C, I),
            dtype=f32, device=dev)
    lib = kernels.load()
    seed = int(seed) & ((1 << 64) - 1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.miso_marginal_wide(
            *[t.data_ptr() for t in inputs],
            None if start is None else start.data_ptr(),
            psi_out.data_ptr(), ll_out.data_ptr(), acc.data_ptr(),
            final_psi.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            E, C, I, K, cfg.iters, cfg.burn_in, cfg.lag, RREC,
            seed & 0xFFFFFFFF, seed >> 32, int(bool(fixed)),
            plan.threads, plan.cluster, int(plan.weights == "shared"),
            wide.launch_bytes(plan, C, I), stream)
    kernels.check(lib, rc, "wide marginal kernel launch (%s)" % (plan,))
    LAUNCHES["wide"] += 1
    final_n = torch.zeros((E, K, I), dtype=f32, device=dev)
    return _result(psi_out, ll_out, acc, final_n, final_psi, cfg)
