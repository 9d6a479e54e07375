"""REASSIGN sampler: the hand-written CUDA kernel and its plain version.

Replaces ``miso_tpu/sampler/pallas_kernel.py::_sampler_kernel`` (launcher
``run_batch_pallas``, ``pl.pallas_call`` at :508).  ``run_batch_reassign``
takes the same batch, ``start_psi`` (E, K, I) and result layout.

- A batch on a CUDA device runs ``csrc/reassign_kernel.cu`` (B1) below
  ``wide.WIDE_FROM`` isoforms and ``csrc/wide_kernel.cu`` (B1w, a lane a
  block, any width) from there on.  If the kernel does not build or
  launch, the call raises; nothing falls back.
- A batch on the CPU runs ``_reassign_plain``: batched torch over the
  (event, chain) lanes with a Python loop over iterations.  It computes
  what the kernel computes, in the same alpha-space form as the TPU
  kernel (``pallas_kernel.py:177-197,293-297``), and ``chip_smoke.py``
  holds the kernel against it on the card.  Its MH chain
  (``_mh_chain``) takes the Gibbs step as a parameter: the deep route
  (``deep.py``) runs the same chain around the multinomial step.

What bounds the kernel on an H100: operations, not bytes -- one Philox
call per four reads (integer ALU) and a walk over each read's I
cumulative weights (FP32 ALU) in every step, no tensor-core work, and
tiles read once (``reassign_bound``).  Its design (see the .cu header)
is fixed per launch by ``launch_plan``, plain Python that the CPU tests
check: a lane is a group of T threads inside a warp, T the narrowest
that still fills the card with warps; a thread's reads never change, so
their weights live in shared memory, staged once per event, else behind
the cache; the randoms that depend on (lane, step) alone are drawn ahead
of the chain, one step per thread of the lane.

From ``WIDE_FROM`` isoforms on the plain version sums in B1w's order
(``wide.wide_sum``, ``wide.wide_cumsum``), so that the two follow one
chain at any width.  B1w reads a bucket's class tensors as the pipeline
hands them over (``pad_reads``; ``class_map`` lays the read slots onto
the classes): it builds no (E, R, I) read tile, where the narrow kernel
and the plain version expand one first (``expand_read_tensors``).

``fixed_uniform=0.4999`` replaces every uniform, as the TPU kernel's
``_DEBUG_NO_PRNG`` does, so both routes then reproduce the JAX kernel's
chain exactly; the proposal normals keep ``_normal_rows``' cos/sin split.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from miso_tpu_torch import trace
from miso_tpu_torch.sampler import wide
from miso_tpu_torch.sampler.mcmc import (EventBatch, SamplerConfig,
                                         SamplerResult)

# launches of B1 ("cuda"), of B1w ("wide") and of the plain version
LAUNCHES = {"cuda": 0, "wide": 0, "plain": 0}
FIXED_U = 0.4999
NEG_BIG = -1e30
TWO_PI = 2.0 * math.pi
_U24 = 2.0 ** -24
# the isoform widths both narrow kernels (B1, B2) are instantiated for:
# every bucketed I (core/events._round_up_iso) up to 64; the wide kernels
# take the buckets from wide.WIDE_FROM (REASSIGN, 128) and
# wide.WIDE_FROM_MARGINAL (64) on: B1's 64-wide instance runs the
# 64-isoform REASSIGN buckets, B2's runs only where called directly (the
# checks hold it to its plain version)
KERNEL_ISO = (2, 3, 4, 6, 8, 16, 32, 64)

# The launch plan's constants; csrc/reassign_kernel.cu holds the same
# values (kShared/kCache, kMaxThreads).
HOMES = ("shared", "cache")
LANE_THREADS = (4, 8, 16, 32)
MAX_THREADS = 256         # the kernel's __launch_bounds__
SHARED_LIMIT = 232448     # dynamic shared memory a block can ask an H100 for
# Warps that fill an H100 for this kernel, about 12 on each of 132 SMs:
# measured at I=2, R=320, K=6, every launch from 4 to 2,048 events was
# fastest at the narrowest lane that still gave the card this many
# (PERF.md).
FILL_WARPS = 1536
SMS = 132                 # an H100's streaming multiprocessors
# Shared memory an SM has for its resident blocks (228 KB), of which
# each block takes 1 KB beside what it asks for.
SM_SHARED = 233472
BLOCK_RESERVE = 1024
# Registers: 65,536 on an SM, and what ptxas gives a thread of each
# width's instance.  They cap the warps an SM holds whatever shared
# memory does; chip_smoke.py holds this table to the build's own log.
SM_REGISTERS = 65536
KERNEL_REGISTERS = {2: 64, 3: 80, 4: 100, 6: 120, 8: 156, 16: 255, 32: 255,
                    64: 255}


class LaunchPlan(NamedTuple):
    """How one launch of the kernel is laid out."""
    T: int                 # threads of a lane (one (event, chain) chain)
    lanes_per_block: int   # whole events wherever K * T allows it
    threads: int           # lanes_per_block * T, a multiple of 32
    home: str              # where a thread's weights live: one of HOMES
    shared_bytes: int      # dynamic shared memory of a block
    groups_per_thread: int  # groups of 4 reads a thread draws per step


def _layouts(E: int, R: int, I: int, K: int, T: int):
    """{home: LaunchPlan} of every home that E events of (R, I) tiles, K
    chains and lanes of T threads can be laid out in, and whether shared
    memory would leave an SM fewer blocks than fill it, than its
    registers hold and than the launch gives it."""
    per_thread = -(-(R // 4) // T)
    events = 32 // math.gcd(K * T, 32)      # whole events per block
    whole = events * K * T <= MAX_THREADS
    lanes = events * K if whole else MAX_THREADS // T
    tile_bytes = (lanes // K) * R * I * 4 if whole else 0
    fits = {"shared": whole and tile_bytes <= SHARED_LIMIT, "cache": True}
    blocks = -(-E * K // lanes)
    threads = lanes * T
    resident = SM_SHARED // (tile_bytes + BLOCK_RESERVE)
    by_registers = SM_REGISTERS // (-(-KERNEL_REGISTERS[I] // 8) * 8
                                    * threads)
    fill = -(-FILL_WARPS // SMS)            # warps that fill one SM
    wanted = min(-(-fill * 32 // threads), by_registers, -(-blocks // SMS))
    crowded = resident < wanted
    return crowded, {home: LaunchPlan(
        T=T, lanes_per_block=lanes, threads=lanes * T, home=home,
        shared_bytes=tile_bytes if home == "shared" else 0,
        groups_per_thread=per_thread) for home in HOMES if fits[home]}


def _check_tiles(E: int, R: int, I: int, K: int) -> None:
    if I not in KERNEL_ISO:
        raise ValueError("the REASSIGN kernel takes I in %s, got %d"
                         % (KERNEL_ISO, I))
    if E < 1 or R < 4 or R % 4 or K < 1:
        raise ValueError("the REASSIGN kernel takes E and K positive and R "
                         "a positive multiple of 4 (got E=%d, R=%d, K=%d)"
                         % (E, R, K))


def launch_plan(E: int, R: int, I: int, K: int) -> LaunchPlan:
    """The kernel's launch for E events of (R, I) tiles and K chains.

    T is at least the narrowest lane that gives the card ``FILL_WARPS``
    warps (E * K * T / 32), and a whole warp where none does: a full
    launch is bound by instruction throughput, and a narrow lane repeats the
    I-wide proposal arithmetic fewer times; a small launch is bound by
    the latency of a step, and a wide lane leaves each thread fewer
    reads.  A block holds whole events (K lanes each), as many as make
    its threads a multiple of 32; with K * T too wide for that it holds
    ``MAX_THREADS // T`` lanes wherever they fall, and shared memory is
    then no home.  The weights live in shared memory when the block's
    tiles fit ``SHARED_LIMIT``.  A wider lane puts fewer events in a
    block, so where the narrowest lane's tiles crowd the SM (its shared
    memory would hold fewer blocks than fill it, than its registers hold
    and than the launch gives it), T widens until they do not, and to
    the widest lane whose tiles fit where every lane's crowd it.  Only
    where no lane's tiles fit do the weights stay behind the cache, at
    the narrowest lane."""
    _check_tiles(E, R, I, K)
    widths = [t for t in LANE_THREADS if E * K * t >= 32 * FILL_WARPS]
    widths = widths or [LANE_THREADS[-1]]
    shared = None
    for T in widths:
        crowded, layouts = _layouts(E, R, I, K, T)
        shared = layouts.get("shared", shared)
        if "shared" in layouts and not crowded:
            break
    return shared or _layouts(E, R, I, K, widths[0])[1]["cache"]


def wide_plan(E: int, R: int, I: int, K: int,
              classes: Optional[int] = None) -> wide.WidePlan:
    """B1w's launch for E events of R read slots in ``classes`` classes
    (default R: read tiles, a read a class) of width I, and K chains
    (``wide.wide_plan``): a block a lane, its threads chosen from the
    launch's lanes, the lane's arrays in shared memory or scratch, the
    class table's tile."""
    return wide.wide_plan("reassign", E, R, I, K, classes)


def all_wide_plans(E: int, R: int, I: int, K: int,
                   classes: Optional[int] = None):
    """Every block width B1w can be launched with at this shape."""
    return wide.all_wide_plans("reassign", E, R, I, K, classes)


def all_plans(E: int, R: int, I: int, K: int):
    """Every plan the kernel can be launched with at this shape, one per
    (T, home) that can be laid out: the card's checks run them all
    (``_reassign_cuda(..., plan=...)``)."""
    _check_tiles(E, R, I, K)
    return [plan for T in LANE_THREADS
            for plan in _layouts(E, R, I, K, T)[1].values()]


# An H100's rates behind ``reassign_bound`` (NVIDIA's data sheet, SXM):
# 3.35 TB/s of device memory; 67 TFLOP/s of FP32 outside the tensor cores
# counts a fused multiply-add as two, so 33.5e12 FP32 instructions a
# second over the card, and half of that for the integer pipe.  The two
# pipes run side by side, fed by schedulers that issue 33.5e12
# instructions a second of either kind.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
INT_OPS_PER_S = 16.75e12
ISSUE_OPS_PER_S = 33.5e12
# One Philox4x32-10 call: 10 rounds of two 32x32->64 multiplies and two
# three-way xors (the round keys are launch constants).
PHILOX_INT_OPS = 40


def bound(nbytes: int, fp_ops: int, int_ops: int):
    """The bound's dict from a launch's bytes and operations: each pipe
    works at its own rate beside the other, both share the schedulers'
    issue rate, so the operations need the longest of the three times;
    ``bound_ms`` is the larger of that and the bytes' time."""
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * max(fp_ops / FP32_OPS_PER_S, int_ops / INT_OPS_PER_S,
                       (fp_ops + int_ops) / ISSUE_OPS_PER_S)
    return {"bytes": nbytes, "fp32_ops": fp_ops, "int_ops": int_ops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def reassign_bound(E: int, R: int, I: int, K: int, iters: int,
                   num_records: int, valid_reads: Optional[int] = None,
                   classes: Optional[int] = None):
    """The least time an H100 could take for one REASSIGN launch, as a
    dict: the bytes moved (each input read once, each output written
    once), the FP32 and integer operations of the function itself, the
    milliseconds each needs at the card's rates (``bound``), and
    ``bound_ms`` (the larger) with ``bound_by``.

    Per step (iters + 1 of them) and lane: every group of 4 reads costs
    one Philox call; every read with a compatible isoform
    (``valid_reads`` in all, default E * R) costs the uniform's
    conversion (shift, or, int-to-float: 3 integer operations) and a
    walk of I multiplies, I - 1 adds, one scale of the uniform, I - 1
    compares and I count updates (3 I - 1 FP32 operations); a padded
    read costs its I - 1 adds and one compare.  The proposal and MH
    arithmetic (about 20 I operations and one Philox call per normal
    pair, once per lane and step) is counted too; it is small beside
    the reads.

    ``classes`` (the classes with reads, in all) counts the class form
    instead, what B1w does: the reads of a class share one cumulative
    row, built once a step (I multiplies and I - 1 adds: 2 I - 1 FP32
    operations; the kernel's running maximum over the row is overhead of
    its own summing order, not work the function needs), and each valid
    read costs the
    uniform's conversion, the scale of its uniform, the ceil(log2 I)
    compares of its search and its count; the inputs are the rows of
    the classes with reads (weights and read scores) and a class index
    per read slot."""
    if valid_reads is None:
        valid_reads = E * R
    steps = iters + 1
    lanes = E * K
    groups = E * (-(-R // 4))
    if classes is None:
        in_bytes = 4 * (2 * E * R * I + 5 * E * I + 2 * E)
        int_ops = steps * K * (groups * PHILOX_INT_OPS + 3 * valid_reads)
        fp_ops = steps * K * (valid_reads * (3 * I - 1)
                              + (E * R - valid_reads) * I)
    else:
        in_bytes = 4 * (2 * classes * I + E * R + 5 * E * I + 2 * E)
        int_ops = steps * K * (groups * PHILOX_INT_OPS + 3 * valid_reads)
        fp_ops = steps * K * (classes * (2 * I - 1)
                              + valid_reads * (2 + (I - 1).bit_length()))
    out_bytes = 4 * (E * num_records * K * (I + 1) + E * K * (2 * I + 1))
    half = (I + 1) // 2
    int_ops += steps * lanes * (half + 1) * PHILOX_INT_OPS
    fp_ops += steps * lanes * 20 * I
    return bound(in_bytes + out_bytes, fp_ops, int_ops)


def _event_consts(batch: EventBatch):
    """Per-event constants shared by both routes, (E, I) or (E, 2) f32:
    clamped log efflen, hyper (1 on padded isoforms), amask, iso_mask,
    last_onehot, and scal = (noise_scale, dir_const).  noise_scale is
    sigma = 0.2/k^2 for k = 2, else sqrt(sigma) (miso.c:188, :328);
    padding events (k = 0) get a finite scale."""
    f32 = torch.float32
    num_iso = batch.num_iso.to(torch.int32)
    I = batch.read_w.shape[2]
    ar = torch.arange(I, device=num_iso.device)[None, :]
    iso_mask = (ar < num_iso[:, None]).to(f32)
    amask = (ar < (num_iso[:, None] - 1)).to(f32)
    last_onehot = (ar == (num_iso[:, None] - 1)).to(f32)
    kf = num_iso.clamp_min(1).to(f32)
    sigma = 0.2 / (kf * kf)
    noise_scale = torch.where(num_iso == 2, sigma, torch.sqrt(sigma))
    real = iso_mask > 0
    h = torch.where(real, batch.hyper.to(f32), torch.ones_like(iso_mask))
    zero = torch.zeros_like(iso_mask)
    dir_const = (torch.lgamma(torch.where(real, h, zero).sum(1))
                 - torch.where(real, torch.lgamma(h), zero).sum(1))
    log_iso_w = batch.log_iso_w.to(f32).clamp_min(NEG_BIG)
    scal = torch.stack([noise_scale, dir_const], dim=1)
    return [t.contiguous() for t in
            (log_iso_w, h, amask, iso_mask, last_onehot, scal)]


def _sum(x):
    """Sum over the last axis in torch's own order."""
    return x.sum(-1)


def _seq_sum(x):
    """Sum over the last axis in ascending index order, as the kernels
    sum (torch's reductions pick their own order, and at scores of 10^4
    one step of another order is a whole tolerance).  A loop of I torch
    operations: only the plain versions whose kernels need it to the bit
    use it (``deep._multinomial_plain``, ``marginal_kernel``)."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


def _stats(alpha, amask, last, eiw, total=_sum):
    """alpha (..., I) -> (psi, log denom, log S): e = exp(alpha) on the
    head isoforms, denom = 1 + sum(e), psi = (e + last) / denom and
    S = sum((e + last) * efflen) (pallas_kernel.py:177-187).  ``total``
    sums over the isoforms."""
    e = torch.exp(alpha) * amask
    denom = 1.0 + total(e)
    ld = torch.log(denom.clamp_min(1e-38))
    e_aug = e + last
    psi = e_aug / denom[..., None]
    logS = torch.log(total(e_aug * eiw).clamp_min(1e-38))
    return psi, ld, logS


def _log_ratio(n, d, h1, H1, n_valid, kk, ld, ld_new, logS, logS_new, full,
               total=_sum):
    """MH log-ratio of the drift d = alpha_new - alpha, in alpha space
    (pallas_kernel.py:293-297): the proposal quadratic and the read score
    cancel, the rest is linear in d.  ``full`` = 0 drops the proposal
    correction (iteration 0)."""
    return (total((n + h1) * d) - n_valid * (logS_new - logS)
            - H1 * (ld_new - ld) + full * (total(d) + kk * (ld - ld_new)))


def _joint_abs(alpha, amask, n, h1, H1, a_liw, rp, n_valid, ld, logS,
               dir_const, total=_sum):
    """Absolute joint score (miso.c:243-307) of a state, for recorded
    log-likelihoods (pallas_kernel.py:189-196)."""
    t = total((n + h1) * (alpha * amask) + n * a_liw)
    return rp + t - n_valid * logS - H1 * ld + dir_const


def _is_record(m: int, cfg: SamplerConfig) -> bool:
    """Record after 0-based step m (the mcmc.py burn-in / lag schedule)."""
    return (m < cfg.iters and m + 1 > cfg.burn_in
            and (m + 1 - cfg.burn_in) % cfg.lag == 0)


def expand_read_tensors(weights, log_read, counts, R: int):
    """Per-read tiles from the (E, C, I) class tensors, on their device:
    read slot r of event e carries the weights of the class whose
    cumulative count interval holds r (pad_events' np.repeat layout,
    class 0 first); slots past the event's reads are zero.  Returns f32
    (E, R, I) read_w and read_logscore (pipeline.py:221-243, which rounds
    them to bf16; the port keeps f32)."""
    cum = torch.cumsum(counts, dim=1)                        # (E, C)
    slots = torch.arange(R, device=counts.device, dtype=counts.dtype)
    cid = (cum[:, :, None] <= slots[None, None, :]).sum(1)   # (E, R)
    valid = (slots[None, :] < cum[:, -1:])[:, :, None]       # (E, R, 1)
    gather = cid.clamp(0, weights.shape[1] - 1)[:, :, None].expand(
        -1, -1, weights.shape[2])
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    read_w = torch.where(valid, torch.gather(weights, 1, gather), zero)
    read_ls = torch.where(valid, torch.gather(log_read, 1, gather), zero)
    return read_w.contiguous(), read_ls.contiguous()


class ClassMap(NamedTuple):
    """B1w's map of R read slots onto an event's classes (int32, on the
    counts' device; see ``class_map``)."""
    cls: torch.Tensor      # (E, A) the classes of the table
    first: torch.Tensor    # (E, A + 1) their first read slots, then the end
    slot: torch.Tensor     # (E, R) a slot's index into cls, or -1
    nact: torch.Tensor     # (E,) classes in cls
    walk: torch.Tensor     # (E, R) the slots whose reads walk, then -1
    wcls: torch.Tensor     # (E, R) the class of each of those, then -1
    nwalk: torch.Tensor    # (E,) slots in walk
    cid: torch.Tensor      # (E, R) a slot's class, -1 past the reads


def class_map(counts, R: int, walk: bool = False) -> ClassMap:
    """B1w's map of R read slots onto the (E, C) classes, as
    ``expand_read_tensors`` lays the reads out (read slot r of an event
    holds a read of the class whose cumulative count interval holds r;
    slots past the event's reads hold none).  Every class with reads
    goes into the kernel's class table: cls lists them in order (A =
    min(C, R) entries), first is the slot where each one's reads begin
    and, past the last, the event's slots with reads, slot maps each
    read to its entry.  With ``walk`` (``wide.walks``) the table is
    empty and every read walks its class's row: walk lists the slots
    with reads in order, wcls their classes.  cid is each slot's class
    (the kernel takes every field but it)."""
    E, C = counts.shape
    dev = counts.device
    A = min(C, R)
    cum = torch.cumsum(counts, dim=1)
    slots = torch.arange(R, device=dev, dtype=counts.dtype)
    # the class whose cumulative count interval holds r: the count of
    # cumulative counts <= r (cum never falls)
    cid = torch.searchsorted(cum.contiguous(),
                             slots.expand(E, R).contiguous(), right=True)
    valid = slots[None, :] < cum[:, -1:]
    cid = torch.where(valid, cid, C)
    n = torch.zeros((E, C + 1), dtype=torch.int64, device=dev).scatter_add_(
        1, cid, torch.ones_like(cid))[:, :C]                  # slots a class
    listed = (n > 0) & (not walk)        # the table's classes
    idx = torch.cumsum(listed.to(torch.int64), 1) - 1         # into cls
    classes = torch.arange(C, device=dev).expand(E, C)
    cls = torch.zeros((E, A + 1), dtype=torch.int64, device=dev).scatter_(
        1, torch.where(listed, idx, A), classes)[:, :A]
    begin = torch.cumsum(n, 1) - n
    first = n.sum(1, keepdim=True).expand(E, A + 2).clone().scatter_(
        1, torch.where(listed, idx, A + 1), begin)[:, :A + 1]
    own = cid.clamp(max=C - 1)
    walking = valid if walk else torch.zeros_like(valid)
    ar = torch.arange(R, device=dev)
    order = torch.where(walking, ar, R + ar).sort(1).values
    listed_walk = order < R
    maps = ClassMap(
        cls=cls, first=first,
        slot=torch.where(valid & ~walking, idx.gather(1, own), -1),
        nact=listed.sum(1), walk=torch.where(listed_walk, order, -1),
        wcls=torch.where(listed_walk, own.gather(1, order % R), -1),
        nwalk=walking.sum(1), cid=torch.where(valid, cid, -1))
    return ClassMap(*(t.to(torch.int32).contiguous() for t in maps))


def run_batch_reassign(seed: int, batch: EventBatch, cfg: SamplerConfig,
                       start_psi=None, fixed_uniform=None,
                       pad_reads: Optional[int] = None) -> SamplerResult:
    """REASSIGN + per-read Gibbs over a padded batch, on the batch's
    device.  ``seed`` is an int: the kernel's Philox key or the plain
    version's ``torch.Generator`` seed.  ``start_psi`` (E, K, I) selects
    the GIVEN start (miso.c:405-409).  With ``pad_reads`` the batch
    carries its reads as classes (``weights``, ``log_read``, ``counts``;
    ``read_w`` and ``read_logscore`` may be placeholders) to be read as
    ``pad_reads`` read slots: B1w reads the classes themselves, the
    other routes first expand them (``expand_read_tensors``)."""
    if cfg.algorithm != "reassign" or cfg.gibbs != "perread":
        raise ValueError("run_batch_reassign runs REASSIGN with the "
                         "per-read Gibbs step only (got %s/%s)"
                         % (cfg.algorithm, cfg.gibbs))
    if cfg.lag < 1 or cfg.iters < 0 or cfg.burn_in < 0 or cfg.chains < 1:
        raise ValueError("bad sampler schedule: %r" % (cfg,))
    if fixed_uniform is not None and fixed_uniform != FIXED_U:
        raise ValueError("fixed_uniform must be None or %r" % FIXED_U)
    dev = batch.read_w.device
    consts = _event_consts(batch)
    # from WIDE_FROM isoforms on the wide kernel, or on the CPU the plain
    # version in its summing order
    wide_route = batch.read_w.shape[2] >= wide.WIDE_FROM
    if dev.type == "cuda" and wide_route:
        return _reassign_wide_cuda(seed, batch, cfg, consts, start_psi,
                                   fixed_uniform is not None,
                                   pad_reads=pad_reads)
    if pad_reads is not None:
        rw, rls = expand_read_tensors(batch.weights, batch.log_read,
                                      batch.counts, pad_reads)
        batch = batch._replace(read_w=rw, read_logscore=rls)
    if dev.type == "cuda":
        return _reassign_cuda(seed, batch, cfg, consts, start_psi,
                              fixed_uniform is not None)
    if dev.type == "cpu":
        return _reassign_plain(seed, batch, cfg, consts, start_psi,
                               fixed_uniform, wide_order=wide_route)
    raise ValueError("no REASSIGN route for device %s" % dev)


def _result(psi_out, ll_out, acc, final_n, final_psi, cfg):
    accepted = acc.sum(dim=1).to(torch.int32)
    return SamplerResult(
        psi_samples=psi_out, loglik=ll_out, accepted=accepted,
        rejected=cfg.iters * cfg.chains - accepted,
        final_n=final_n, final_psi=final_psi)


def _uniforms(seed, dev, fixed_uniform):
    """(generator, uniform(*shape)) of a plain-version run: f32 uniforms
    in [0, 1) from a ``torch.Generator`` seeded with ``seed``, or
    ``fixed_uniform`` everywhere (generator None)."""
    if fixed_uniform is not None:
        return None, lambda *shape: torch.full(
            shape, fixed_uniform, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen, lambda *shape: torch.rand(
        shape, generator=gen, dtype=torch.float32, device=dev)


def _reassign_plain(seed, batch, cfg, consts, start_psi=None,
                    fixed_uniform=None, wide_order=None) -> SamplerResult:
    """Plain PyTorch version of the kernel, batched over (E, K) lanes on
    any device.  ``fixed_uniform`` replaces every uniform; otherwise a
    ``torch.Generator`` seeded with ``seed`` draws them.  ``wide_order``
    (default: from ``wide.WIDE_FROM`` isoforms on) sums as B1w does, the
    kernel that takes such widths on the card."""
    LAUNCHES["plain"] += 1
    f32 = torch.float32
    E, R, I = batch.read_w.shape
    K = cfg.chains
    dev = batch.read_w.device
    gen, uniform = _uniforms(seed, dev, fixed_uniform)
    if wide_order is None:
        wide_order = I >= wide.WIDE_FROM
    trace.count("launch", route="B1w.plain" if wide_order else "B1.plain",
                lanes=E)
    rw = batch.read_w.to(f32)[:, None]                 # (E, 1, R, I)
    rls = batch.read_logscore.to(f32)[:, None]
    valid = rw.sum(-1) > 0                             # (E, 1, R)
    iso = torch.arange(I, device=dev)

    # B1w's order of the cumulative weights (wide.wide_cumsum): the
    # weights laid out by quarters once, psi every step
    rw_q = wide.quarters(rw) if wide_order else None

    def wide_gibbs(psi, u, want_rp):
        # the first cumulative weight that reaches u * total, else I-1;
        # the counts and read scores by index: at wide widths an (R, I)
        # one-hot costs more than the rest of the step
        w = rw_q * wide.quarters(psi)[..., None]      # (4, C, 32, E, K, R)
        choice, _ = wide.wide_first(w, I, u)
        # padding reads (valid = False) count into no isoform
        one = valid.expand(E, K, R).to(f32)
        n = torch.zeros((E, K, I), dtype=f32, device=dev).scatter_add_(
            -1, choice, one)
        if not want_rp:
            return n, torch.zeros((E, K), dtype=f32, device=dev)
        picked = torch.gather(rls.expand(E, K, R, I), -1,
                              choice[..., None])[..., 0]
        return n, wide.read_sum(picked * one)

    def gibbs(psi, want_rp):
        u = uniform(E, K, R)
        if gen is not None:
            u = u.clamp_min(_U24)      # strictly positive Gibbs uniforms
        if wide_order:
            return wide_gibbs(psi, u, want_rp)
        # cumulative weights over isoforms, summed in order as the kernel
        # does; torch.cumsum over this short last axis ran ~100x slower
        # on the card than the whole rest of the step
        w = rw * psi[:, :, None, :]                    # (E, K, R, I)
        cums = [w[..., 0]]
        for i in range(1, I):
            cums.append(cums[-1] + w[..., i])
        ge = torch.stack(cums[:-1], -1) >= (u * cums[-1])[..., None]
        choice = (I - 1) - ge.sum(-1)          # first cums_i >= u, else I-1
        # padding reads (valid = False) count into no isoform
        onehot = ((choice[..., None] == iso) & valid[..., None]).to(f32)
        n = onehot.sum(-2)
        rp = ((onehot * rls).sum((-1, -2)) if want_rp
              else torch.zeros((E, K), dtype=f32, device=dev))
        return n, rp

    return _mh_chain(cfg, consts, start_psi, uniform, gibbs,
                     valid.sum(-1).to(f32),
                     wide.wide_sum if wide_order else _sum)


def _mh_chain(cfg, consts, start_psi, uniform, gibbs, n_valid,
              total=_sum):
    """The REASSIGN chain of every (E, K) lane in the alpha-space form of
    the kernel, around a Gibbs step: ``gibbs(psi, want_rp)`` returns the
    per-isoform counts n (E, K, I) and, when a record will read it, the
    read score rp (E, K).  ``n_valid`` (E, 1) is the reads that count
    into some isoform; ``uniform(*shape)`` draws the proposal and accept
    uniforms; ``total`` sums over the isoforms."""
    f32 = torch.float32
    log_iso_w, h, amask, iso_mask, last, scal = (c[:, None] for c in consts)
    E, _, I = log_iso_w.shape
    K = cfg.chains
    dev = log_iso_w.device
    ns = scal[..., 0:1]                                # (E, 1, 1)
    dir_const = scal[..., 1]                           # (E, 1)
    real = iso_mask > 0
    zero = torch.zeros_like(iso_mask)
    eiw = torch.exp(log_iso_w) * iso_mask
    a_liw = torch.where(real, log_iso_w, zero)
    h1 = torch.where(real, h - 1.0, zero)
    H1 = total(h1)
    km1 = amask.sum(-1)
    kk = km1 + 1.0
    H = (I + 1) // 2

    def normal_rows():
        u1 = uniform(E, K, H).clamp_min(_U24)
        u2 = uniform(E, K, H)
        r = torch.sqrt(-2.0 * torch.log(u1))
        ang = TWO_PI * u2
        return torch.cat([r * torch.cos(ang), r * torch.sin(ang)], -1)[..., :I]

    def stats(alpha):
        return _stats(alpha, amask, last, eiw, total)

    if start_psi is not None:
        sp = start_psi.to(f32)
        sp_last = (sp * last).sum(-1, keepdim=True)
        alpha = torch.where(amask > 0, torch.log(sp.clamp_min(1e-30))
                            - torch.log(sp_last.clamp_min(1e-30)), zero)
    else:
        a0 = torch.where(km1 == 1.0, torch.zeros_like(km1),
                         1.0 / km1.clamp_min(1.0))
        alpha = torch.where(amask > 0, a0[..., None], zero).expand(E, K, I)
    alpha = alpha + ns * normal_rows() * amask
    psi, ld, logS = stats(alpha)
    n, rp = gibbs(psi, _is_record(0, cfg))

    RREC = max(cfg.num_records, 0)
    psi_out = torch.empty((E, RREC, K, I), dtype=f32, device=dev)
    ll_out = torch.empty((E, RREC, K), dtype=f32, device=dev)
    acc = torch.zeros((E, K), dtype=torch.int32, device=dev)
    rec = 0
    for m in range(cfg.iters):
        d = ns * normal_rows() * amask
        alpha_new = alpha + d
        psi_new, ld_new, logS_new = stats(alpha_new)
        logr = _log_ratio(n, d, h1, H1, n_valid, kk, ld, ld_new, logS,
                          logS_new, 1.0 if m > 0 else 0.0, total)
        u = uniform(E, K).clamp_min(_U24)
        accept = (logr >= 0) | (torch.log(u) < logr)
        a3 = accept[..., None]
        alpha = torch.where(a3, alpha_new, alpha)
        psi = torch.where(a3, psi_new, psi)
        ld = torch.where(accept, ld_new, ld)
        logS = torch.where(accept, logS_new, logS)
        acc += accept.to(torch.int32)
        if _is_record(m, cfg) and rec < RREC:
            psi_out[:, rec] = psi
            ll_out[:, rec] = _joint_abs(alpha, amask, n, h1, H1, a_liw, rp,
                                        n_valid, ld, logS, dir_const,
                                        total)
            rec += 1
        n, rp = gibbs(psi, _is_record(m + 1, cfg))
    return _result(psi_out, ll_out, acc, n, psi, cfg)


def _checked(t, name, shape, dtype, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError("%s: want %s %s on %s, got %s %s on %s" % (
            name, tuple(shape), dtype, dev, tuple(t.shape), t.dtype,
            t.device))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    return t


def _read_tiles(batch):
    """The batch's per-read tiles as both REASSIGN kernels take them:
    checked f32 (E, R, I) on the batch's device, R padded to a multiple
    of 4 (the kernels draw reads four at a time, the Philox counter keyed
    by read / 4; a zero-weight read counts into no isoform)."""
    f32 = torch.float32
    E, R, I = batch.read_w.shape
    dev = batch.read_w.device
    read_w = _checked(batch.read_w, "read_w", (E, R, I), f32, dev)
    read_ls = _checked(batch.read_logscore, "read_logscore", (E, R, I), f32,
                       dev)
    if R % 4:
        pad = (0, 0, 0, 4 - R % 4)
        read_w = torch.nn.functional.pad(read_w, pad).contiguous()
        read_ls = torch.nn.functional.pad(read_ls, pad).contiguous()
    return read_w, read_ls


def _chain_outputs(E, K, I, RREC, dev):
    """A REASSIGN launch's outputs: psi records, log-likelihood records,
    acceptances, final counts and final psi."""
    f32 = torch.float32
    return (torch.empty((E, RREC, K, I), dtype=f32, device=dev),
            torch.empty((E, RREC, K), dtype=f32, device=dev),
            torch.empty((E, K), dtype=torch.int32, device=dev),
            torch.empty((E, K, I), dtype=f32, device=dev),
            torch.empty((E, K, I), dtype=f32, device=dev))


def _reassign_cuda(seed, batch, cfg, consts, start_psi, fixed, plan=None):
    """Launch csrc/reassign_kernel.cu on the batch's CUDA device, laid
    out by ``launch_plan`` (``plan`` forces another layout: the card's
    checks run every lane width and home of the weights)."""
    from miso_tpu_torch import kernels

    f32 = torch.float32
    E, R, I = batch.read_w.shape
    K = cfg.chains
    RREC = max(cfg.num_records, 0)
    dev = batch.read_w.device
    if I not in KERNEL_ISO:
        raise ValueError("the REASSIGN kernel takes I in %s, got %d"
                         % (KERNEL_ISO, I))
    read_w, read_ls = _read_tiles(batch)
    R = read_w.shape[1]
    if plan is None:
        plan = launch_plan(E, R, I, K)
    inputs = [read_w, read_ls]
    for name, c in zip(("log_iso_w", "hyper", "amask", "iso_mask",
                        "last_onehot"), consts[:5]):
        inputs.append(_checked(c, name, (E, I), f32, dev))
    inputs.append(_checked(consts[5], "scal", (E, 2), f32, dev))
    start = None
    if start_psi is not None:
        start = _checked(start_psi, "start_psi", (E, K, I), f32, dev)
    psi_out, ll_out, acc, final_n, final_psi = _chain_outputs(E, K, I, RREC,
                                                              dev)
    lib = kernels.load()
    seed = int(seed) & ((1 << 64) - 1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.miso_reassign(
            *[t.data_ptr() for t in inputs],
            None if start is None else start.data_ptr(),
            psi_out.data_ptr(), ll_out.data_ptr(), acc.data_ptr(),
            final_n.data_ptr(), final_psi.data_ptr(),
            E, R, I, K, cfg.iters, cfg.burn_in, cfg.lag, RREC,
            seed & 0xFFFFFFFF, seed >> 32, int(bool(fixed)),
            plan.T, plan.lanes_per_block, HOMES.index(plan.home),
            plan.shared_bytes, stream)
    kernels.check(lib, rc, "reassign kernel launch (%s)" % (plan,))
    LAUNCHES["cuda"] += 1
    trace.count("launch", route="B1", lanes=E)
    return _result(psi_out, ll_out, acc, final_n, final_psi, cfg)


def _wide_classes(batch, pad_reads):
    """B1w's inputs of a batch: (weights, log_read) (E, C, I) f32, the
    ``class_map`` of its read slots, the reads some isoform can take
    (E,) f32, and R.  With ``pad_reads`` the batch's class tensors, read
    as that many slots (padded to a multiple of 4: the kernel draws reads
    four at a time); without, its read tiles (``read_w``,
    ``read_logscore``, padded alike) as R classes of a read each, a
    zero-weight read a class that counts nowhere."""
    f32 = torch.float32
    E, _, I = batch.read_w.shape
    dev = batch.read_w.device
    if pad_reads is None:
        weights, log_read = _read_tiles(batch)
        R = weights.shape[1]
        counts = torch.ones((E, R), dtype=f32, device=dev)
    else:
        R = pad_reads + (-pad_reads) % 4
        C = batch.weights.shape[1]
        weights = _checked(batch.weights, "weights", (E, C, I), f32, dev)
        log_read = _checked(batch.log_read, "log_read", (E, C, I), f32, dev)
        counts = _checked(batch.counts, "counts", (E, C), f32, dev)
        if R != pad_reads:
            # the slots past pad_reads hold no read
            counts = torch.minimum(counts, (pad_reads - (
                torch.cumsum(counts, 1) - counts)).clamp_min(0))
    maps = class_map(counts, R, wide.walks(
        R, None if pad_reads is None else weights.shape[1], I))
    # a read counts where its class has some weight > 0
    some = (weights > 0).any(-1)
    taken = torch.where(maps.cid >= 0, torch.gather(
        some, 1, maps.cid.clamp_min(0).to(torch.int64)), False)
    return weights, log_read, maps, taken.sum(1).to(f32).contiguous(), R


def _reassign_wide_cuda(seed, batch, cfg, consts, start_psi, fixed,
                        plan=None, pad_reads=None):
    """Launch B1w (csrc/wide_kernel.cu) on the batch's CUDA device, laid
    out by ``wide_plan`` (``plan`` forces another block width,
    ``shared_bytes=0`` the lane arrays into scratch, or ``wide.tiled``
    another table tile).  The kernel reads the batch's classes as
    ``pad_reads`` read slots, or its read tiles as classes of one read
    each where ``pad_reads`` is None (``_wide_classes``); it never sees
    an (E, R, I) tile of a class batch."""
    from miso_tpu_torch import kernels

    f32 = torch.float32
    E, _, I = batch.read_w.shape
    K = cfg.chains
    RREC = max(cfg.num_records, 0)
    dev = batch.read_w.device
    weights, log_read, maps, nvalid, R = _wide_classes(batch, pad_reads)
    C, A = weights.shape[1], maps.cls.shape[1]
    if plan is None:
        plan = wide_plan(E, R, I, K,
                         classes=None if pad_reads is None else C)
    if pad_reads is None:
        # read tiles: read s walks row s, no lists to look up
        maps = maps._replace(walk=None, wcls=None)
    if wide.walks(R, None if pad_reads is None else C, I):
        maps = maps._replace(cls=None)    # no table: the walking kernel
    inputs = [weights, log_read, *maps[:-1], nvalid,
              _checked(consts[0], "log_iso_w", (E, I), f32, dev),
              _checked(consts[1], "hyper", (E, I), f32, dev),
              _checked(batch.num_iso, "num_iso", (E,), torch.int32, dev),
              _checked(consts[5], "scal", (E, 2), f32, dev)]
    start = None
    if start_psi is not None:
        start = _checked(start_psi, "start_psi", (E, K, I), f32, dev)
    psi_out, ll_out, acc, final_n, final_psi = _chain_outputs(E, K, I, RREC,
                                                              dev)
    scratch = None
    if plan.shared_bytes == 0:
        scratch = torch.empty(
            E * K * wide.lane_floats("reassign", R, I, plan.rows),
            dtype=f32, device=dev)
    lib = kernels.load()
    seed = int(seed) & ((1 << 64) - 1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.miso_reassign_wide(
            *[None if t is None else t.data_ptr() for t in inputs],
            None if start is None else start.data_ptr(),
            psi_out.data_ptr(), ll_out.data_ptr(), acc.data_ptr(),
            final_n.data_ptr(), final_psi.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            E, C, A, R, I, K, cfg.iters, cfg.burn_in, cfg.lag, RREC,
            seed & 0xFFFFFFFF, seed >> 32, int(bool(fixed)),
            plan.threads, plan.rows, plan.shared_bytes, stream)
    kernels.check(lib, rc, "wide reassign kernel launch (%s)" % (plan,))
    LAUNCHES["wide"] += 1
    trace.count("launch", route="B1w", lanes=E)
    return _result(psi_out, ll_out, acc, final_n, final_psi, cfg)
