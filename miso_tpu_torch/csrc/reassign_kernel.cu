// REASSIGN MH-within-Gibbs sampler for Hopper (sm_90a).
//
// Replaces miso_tpu/sampler/pallas_kernel.py::_sampler_kernel (launcher
// run_batch_pallas): the whole chain of every (event, chain) lane in one
// launch -- AUTO or GIVEN start, logistic-normal drift proposal, MH ratio
// in alpha space, per-read inverse-CDF Gibbs draw, burn-in/lag records.
// Its plain PyTorch version is _reassign_plain in
// miso_tpu_torch/sampler/reassign_kernel.py; both compute the same
// arithmetic, and under fixed_u (every uniform 0.4999f, the TPU kernel's
// NO_PRNG mode) they give the same chain.
//
// What bounds it: operations, not bytes.  The (E, R, I) tiles are read
// once and the records written once (tens of MB, tens of microseconds);
// each of the iters + 1 steps of a lane draws R uniforms (one
// Philox4x32-10 call per 4 reads, integer work) and walks R reads' I
// cumulative weights with compares (FP32 work).  No tensor-core work.
// A step is also one long dependent chain (proposal -> MH ratio ->
// accept -> Gibbs draw -> reduction -> next step): a launch with few
// lanes is bound by that latency, a full one by instruction throughput.
//
// Design, from the launch plan (launch_plan in reassign_kernel.py):
//
// - A lane is a group of T threads, T in {4, 8, 16, 32}, inside one
//   warp; a warp carries 32 / T lanes.  The group's threads split the
//   reads four at a time (group of reads g = t, t + T, ...: the Philox
//   counter is keyed by g, so the chain is the same for every T), count
//   their reads per isoform, and an xor butterfly of log2(T) levels
//   gives every thread of the lane bit-identical counts.  Each thread
//   then runs the I-wide proposal and MH arithmetic, T times redundantly
//   instead of 32, and the accept branch never diverges inside a lane.
//   The plan takes the narrowest T that still fills the card with warps:
//   a full launch is throughput bound and wants the least redundancy, a small
//   one is latency bound and wants the fewest reads per thread.  It
//   widens T where the narrow lane's block (more events, more tiles in
//   shared memory) would leave an SM too few resident warps.
// - Randoms ahead of the chain.  The proposal normals and log(u_accept)
//   depend on (lane, step) alone.  Every T steps, thread t of the lane
//   draws them for step s + t (Philox, logf, sqrtf, cosf, sinf); each
//   step then takes its values from its thread by a shuffle.  Those
//   calls leave the dependent chain and are made once per step and lane,
//   not T times.  The Philox round keys are kernel arguments.
// - Stationary weights.  A thread owns the same reads in every step.
//   Home kShared: the block holds whole events, and each event's (R, I)
//   tile is copied once into dynamic shared memory for its K lanes,
//   transposed so that the threads of a lane read neighbouring banks
//   (see Weights).  The copy is made once per launch by plain loads, so
//   it needs no asynchronous pipeline.  Home kCache (the tile does not
//   fit): read through L1/L2 every step, a group's weights as 16-byte
//   loads.  Registers are no home: kept there, the weights of 20 reads
//   took the kernel from 63 to 116 registers and halved the resident
//   warps, which cost more than the loads (PERF.md).  read_ls is read
//   one step in lag and stays in global memory.
// - The read loop has no branch: a padded read adds 0, the last
//   isoform's count is what the others leave of the valid reads, and
//   the step before a record runs a second instance of the loop that
//   also sums the read score.
// - The grid: blocks of at most kMaxThreads threads holding whole
//   events (96 threads at K = 6).  ptxas gives the I = 2 instance 64
//   registers: 10 blocks, 30 warps, on each SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Instances for I = 2 ... 64 (KERNEL_ISO in reassign_kernel.py); their
// loops over the isoforms (and the I/2 normal pairs) unroll fully, and a
// lane's per-isoform arrays live in each thread's registers.  From
// wide.WIDE_FROM isoforms on, of any width, the wide kernel
// (wide_kernel.cu) takes a bucket: a lane a block, its arrays once in
// shared memory.

constexpr float kFixedU = 0.4999f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kNegBig = -1e30f;
constexpr float kTiny = 1e-38f;
constexpr float kTwoM24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoM23 = 1.1920928955078125e-07f;  // 2^-23

// Philox counter word 3: which draw of a step the bits feed.
constexpr uint32_t kReads = 0, kNormals = 1, kAccept = 2;

// Where a thread finds its reads' weights (launch_plan's "home"), and the
// widest block (HOMES and MAX_THREADS in reassign_kernel.py).
constexpr int kShared = 0, kCache = 1;
constexpr int kMaxThreads = 256;

struct Params {
  const float* read_w;       // (E, R, I), R % 4 == 0
  const float* read_ls;      // (E, R, I)
  const float* log_iso_w;    // (E, I)
  const float* hyper;        // (E, I), 1 on padded isoforms
  const float* amask;        // (E, I)
  const float* iso_mask;     // (E, I)
  const float* last_onehot;  // (E, I)
  const float* scal;         // (E, 2): noise_scale, dir_const
  const float* start;        // (E, K, I) GIVEN start, or null for AUTO
  float* psi_out;            // (E, RREC, K, I)
  float* loglik_out;         // (E, RREC, K)
  int* acc_out;              // (E, K)
  float* final_n;            // (E, K, I)
  float* final_psi;          // (E, K, I)
  int E, R, K, iters, burn_in, lag, rrec;
  // Philox round keys of the seed (k + r * Weyl constant), worked out by
  // the launcher: a kernel argument is an operand, not an instruction
  uint32_t key0[10], key1[10];
  int fixed_u;
  // a Gibbs uniform is bits * u_scale + u_shift: (2^-24, 0), or
  // (0, 0.4999f) under fixed_u
  float u_scale, u_shift;
  int T, log_t, lanes_per_block, home;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const Params& p) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ p.key0[r], lo1, hi0 ^ c.w ^ p.key1[r], lo0);
  }
  return c;
}

// [0, 1) at 23 bits, as the TPU kernel's _u01 (proposal and MH draws).
__device__ __forceinline__ float u01(uint32_t b) {
  return (float)(b & 0x7FFFFFu) * kTwoM23;
}

// (0, 1) strictly, for the Gibbs draws: an odd 24-bit numerator.  A zero
// draw would land a read on a leading zero-weight isoform.  One fused
// multiply-add serves both modes exactly (x * 2^-24 + 0, x * 0 + 0.4999f).
__device__ __forceinline__ float gibbs_uniform(uint32_t b, const Params& p) {
  return __fmaf_rn((float)((b >> 8) | 1u), p.u_scale, p.u_shift);
}

// The T threads of one lane: T consecutive threads of a warp, aligned to
// T.  Every shuffle names the whole warp (a mask known at compile time
// costs no vote before the shuffle), so all 32 threads of a warp take
// every shuffle together: the step loop is the same for every lane, and
// a lane past the batch's end runs along and writes nothing.  xor
// offsets below T and a shuffle width of T keep the data inside the lane.
struct Group {
  int T;  // threads in the lane
  int t;  // this thread's place in it

  // xor butterfly: every thread ends with the bitwise-same sum
  __device__ __forceinline__ float sum(float v) const {
    for (int o = T >> 1; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
  // the same for N sums and one more at once: a level's shuffles are
  // independent, so they overlap instead of queueing sum after sum
  template <int N>
  __device__ __forceinline__ void sum_all(float v[N], float& extra) const {
    for (int o = T >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
      extra += __shfl_xor_sync(0xffffffffu, extra, o);
    }
  }
  // v of the lane's thread src
  __device__ __forceinline__ float from(float v, int src) const {
    return __shfl_sync(0xffffffffu, v, src, T);
  }
};

// (I,) standard normals sharing one Box-Muller radius per cos/sin pair:
// rows [0, H) take r*cos, rows [H, I) r*sin (pallas_kernel._normal_rows).
template <int I>
__device__ __forceinline__ void normal_rows(const Params& p, uint32_t lane,
                                            uint32_t step, float z[I]) {
  constexpr int H = (I + 1) / 2;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float u1 = kFixedU, u2 = kFixedU;
    if (!p.fixed_u) {
      const uint4 b = philox4x32_10(make_uint4(lane, step, j, kNormals), p);
      u1 = u01(b.x);
      u2 = u01(b.y);
    }
    const float r = sqrtf(-2.0f * logf(fmaxf(u1, kTwoM24)));
    const float ang = kTwoPi * u2;
    z[j] = r * cosf(ang);
    if (j + H < I) z[j + H] = r * sinf(ang);
  }
}

// The randoms of a step that depend on (lane, step) alone, drawn ahead
// of the chain: thread t of the lane holds those of step base + t.
template <int I>
struct Ahead {
  float z[I];   // proposal normals of this thread's step
  float log_u;  // log of its accept uniform

  __device__ __forceinline__ void refill(const Params& p, const Group& g,
                                         uint32_t lane, uint32_t base) {
    const uint32_t step = base + (uint32_t)g.t;
    normal_rows<I>(p, lane, step, z);
    float u = kFixedU;
    if (!p.fixed_u)
      u = u01(philox4x32_10(make_uint4(lane, step, 0u, kAccept), p).x);
    log_u = logf(fmaxf(u, kTwoM24));
  }

  // The normals and log(u_accept) of `step`, on every thread of the lane.
  __device__ __forceinline__ float take(const Params& p, const Group& g,
                                        uint32_t lane, uint32_t step,
                                        float zs[I]) {
    const int src = (int)(step & (uint32_t)(g.T - 1));
    if (src == 0) refill(p, g, lane, step);
#pragma unroll
    for (int i = 0; i < I; ++i) zs[i] = g.from(z[i], src);
    return g.from(log_u, src);
  }
};

// alpha -> (psi, log denom, log S) with e = exp(alpha) on the head
// isoforms, denom = 1 + sum(e), psi = (e + last) / denom and
// S = sum((e + last) * efflen).
template <int I>
__device__ __forceinline__ void stats(const float alpha[I], const float am[I],
                                      const float last[I], const float eiw[I],
                                      float psi[I], float& ld, float& logS) {
  float e[I];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    e[i] = expf(alpha[i]) * am[i];
    s += e[i];
  }
  const float denom = 1.0f + s;
  ld = logf(fmaxf(denom, kTiny));
  float S = 0.f;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const float ea = e[i] + last[i];
    psi[i] = ea / denom;
    S += ea * eiw[i];
  }
  logS = logf(fmaxf(S, kTiny));
}

// A thread's view of its event's weights; weight q = j * I + i of group g
// is isoform i of read 4g + j.  kCache: the (R, I) rows in global memory,
// a group's 4 * I weights being 16 * I contiguous bytes, 16-byte aligned
// (R % 4 == 0).  kShared: the block's copy, transposed so that the
// threads of a lane, which read neighbouring groups, read neighbouring
// banks: up to I = 8 in 16-byte pieces (piece c of group g at
// c * groups + g), wider tiles float by float (weight q at
// q * groups + g).  Up to I = 8 a group is fetched by I 16-byte loads.
template <int I>
struct Weights {
  static constexpr bool kVector = I <= 8;
  const float* base;
  bool shared;
  int groups;              // R / 4
  int stride_q, stride_g;  // wide tiles: weight q of group g

  __device__ __forceinline__ void at_home(const float* b, int home,
                                          int groups_) {
    base = b;
    shared = home == kShared;
    groups = groups_;
    stride_q = shared ? groups_ : 1;
    stride_g = shared ? 1 : 4 * I;
  }
  // where weight q of group g lies in a transposed tile
  __device__ __forceinline__ static int transposed(int g, int q, int groups_) {
    if constexpr (kVector) return ((q >> 2) * groups_ + g) * 4 + (q & 3);
    return q * groups_ + g;
  }
  // the weights of group g, for at(): a copy in registers, or nothing
  __device__ __forceinline__ void fetch(int g, float v[4 * I]) const {
    if constexpr (kVector) {
      const float4* q = reinterpret_cast<const float4*>(base);
      float4 f[I];
      if (shared) {
#pragma unroll
        for (int c = 0; c < I; ++c) f[c] = q[c * groups + g];
      } else {
#pragma unroll
        for (int c = 0; c < I; ++c) f[c] = q[g * I + c];
      }
#pragma unroll
      for (int c = 0; c < I; ++c) {
        v[4 * c] = f[c].x;
        v[4 * c + 1] = f[c].y;
        v[4 * c + 2] = f[c].z;
        v[4 * c + 3] = f[c].w;
      }
    }
  }
  __device__ __forceinline__ float at(const float v[4 * I], int g, int j,
                                      int i) const {
    if constexpr (kVector) return v[j * I + i];
    return base[(j * I + i) * stride_q + g * stride_g];
  }
};

// Per-read Gibbs draw: read r takes the first isoform i < I-1 whose
// cumulative weight reaches u_r * total, else the last one.  Reads with
// all-zero weights (padding) count into no isoform: the loop over the
// reads has no branch, a padded read adds 0.  The last isoform's count
// is what the others leave of n_valid (small integers, exact in f32).
// n gets the counts, rp the read score (RP: a record will read it).
template <int I, bool RP>
__device__ __forceinline__ void gibbs(const Params& p, const Group& grp,
                                      const Weights<I>& w, const float* rl,
                                      uint32_t lane, uint32_t step,
                                      const float psi[I], float n_valid,
                                      float n[I], float& rp) {
  float cnt[I - 1];
#pragma unroll
  for (int i = 0; i < I - 1; ++i) cnt[i] = 0.f;
  float acc_rp = 0.f;
  // one group at a time: unrolled by two, the loop took 80 registers for
  // 64 and ran 3 % slower at I = 2, 38 % slower at I = 8
#pragma unroll 1
  for (int g = grp.t; g < w.groups; g += grp.T) {
    const uint4 b =
        philox4x32_10(make_uint4(lane, step, (uint32_t)g, kReads), p);
    const uint32_t bits[4] = {b.x, b.y, b.z, b.w};
    float wv[Weights<I>::kVector ? 4 * I : 1];
    w.fetch(g, wv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float c[I];
      float wsum = w.at(wv, g, j, 0);
      // no FMA contraction: the plain version multiplies, then sums
      float acc = __fmul_rn(wsum, psi[0]);
      c[0] = acc;
#pragma unroll
      for (int i = 1; i < I; ++i) {
        const float wi = w.at(wv, g, j, i);
        wsum += wi;
        acc = __fadd_rn(acc, __fmul_rn(wi, psi[i]));
        c[i] = acc;
      }
      const bool valid = wsum > 0.f;
      const float one = valid ? 1.f : 0.f;
      const float u = gibbs_uniform(bits[j], p) * acc;
      int ch = I - 1;
#pragma unroll
      for (int i = I - 2; i >= 0; --i)
        if (c[i] >= u) ch = i;
#pragma unroll
      for (int i = 0; i < I - 1; ++i) cnt[i] += (ch == i) ? one : 0.f;
      if (RP) acc_rp += valid ? rl[(4 * g + j) * I + ch] : 0.f;
    }
  }
  grp.sum_all<I - 1>(cnt, acc_rp);  // acc_rp stays 0 without RP
  float rest = n_valid;
#pragma unroll
  for (int i = 0; i < I - 1; ++i) {
    n[i] = cnt[i];
    rest -= cnt[i];
  }
  n[I - 1] = rest;
  rp = acc_rp;
}

template <int I>
__global__ void __launch_bounds__(kMaxThreads) reassign_kernel(const Params p) {
  extern __shared__ __align__(16) float tile[];
  const int groups = p.R >> 2;
  const int tile_elems = p.R * I;
  const int in_block = (int)threadIdx.x >> p.log_t;  // lane within the block

  if (p.home == kShared) {
    // each event of the block: its (R, I) weights, once, for its K lanes
    const int per_block = p.lanes_per_block / p.K;
    const int e0 = (int)blockIdx.x * per_block;
    for (int ev = 0; ev < per_block && e0 + ev < p.E; ++ev) {
      const float* src = p.read_w + (size_t)(e0 + ev) * tile_elems;
      float* dst = tile + (size_t)ev * tile_elems;
      for (int idx = (int)threadIdx.x; idx < tile_elems;
           idx += (int)blockDim.x) {
        const int g = idx / (4 * I);
        dst[Weights<I>::transposed(g, idx - g * 4 * I, groups)] = src[idx];
      }
    }
    __syncthreads();
  }

  // a lane past the batch's end runs the last lane's chain along with
  // its warp (see Group) and writes nothing
  const long long lanes = (long long)p.E * p.K;
  const long long lane_ll =
      (long long)blockIdx.x * p.lanes_per_block + in_block;
  const int lane_i = (int)(lane_ll < lanes ? lane_ll : lanes - 1);
  const int e = lane_i / p.K;
  const int k = lane_i - e * p.K;
  const uint32_t lane = (uint32_t)lane_i;

  Group grp;
  grp.T = p.T;
  grp.t = (int)threadIdx.x & (p.T - 1);
  const bool leader = grp.t == 0 && lane_ll < lanes;

  const float* rw = p.read_w + (size_t)e * tile_elems;
  const float* rl = p.read_ls + (size_t)e * tile_elems;
  Weights<I> w;
  if (p.home == kShared)
    w.at_home(tile + (size_t)(in_block / p.K) * tile_elems, kShared, groups);
  else
    w.at_home(rw, kCache, groups);

  // per-event constants (efflen, log efflen, hyper - 1 on real isoforms)
  float am[I], last[I], eiw[I], aliw[I], h1[I];
  float km1 = 0.f, H1 = 0.f;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const size_t o = (size_t)e * I + i;
    const float liw = fmaxf(p.log_iso_w[o], kNegBig);
    const float im = p.iso_mask[o];
    am[i] = p.amask[o];
    last[i] = p.last_onehot[o];
    eiw[i] = expf(liw) * im;
    aliw[i] = im > 0.f ? liw : 0.f;
    h1[i] = im > 0.f ? p.hyper[o] - 1.0f : 0.f;
    H1 += h1[i];
    km1 += am[i];
  }
  const float kk = km1 + 1.0f;
  const float ns = p.scal[2 * e];
  const float dir_const = p.scal[2 * e + 1];

  float nv = 0.f;
  for (int r = grp.t; r < p.R; r += p.T) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < I; ++i) s += rw[(size_t)r * I + i];
    nv += s > 0.f ? 1.f : 0.f;
  }
  const float n_valid = grp.sum(nv);

  // start (miso.c:348-371 AUTO, :405-409 GIVEN), then one proposal and
  // the initial Gibbs draw (miso.c:834-843)
  float alpha[I], z[I];
  if (p.start != nullptr) {
    const float* sp = p.start + ((size_t)e * p.K + k) * I;
    float sl = 0.f;
#pragma unroll
    for (int i = 0; i < I; ++i) sl += sp[i] * last[i];
    const float lsl = logf(fmaxf(sl, 1e-30f));
#pragma unroll
    for (int i = 0; i < I; ++i)
      alpha[i] = am[i] > 0.f ? logf(fmaxf(sp[i], 1e-30f)) - lsl : 0.f;
  } else {
    const float a0 = km1 == 1.0f ? 0.f : 1.0f / fmaxf(km1, 1.0f);
#pragma unroll
    for (int i = 0; i < I; ++i) alpha[i] = am[i] > 0.f ? a0 : 0.f;
  }
  Ahead<I> ahead;
  ahead.take(p, grp, lane, 0u, z);  // step 0 has no accept draw
#pragma unroll
  for (int i = 0; i < I; ++i) alpha[i] += ns * z[i] * am[i];
  float psi[I], n[I], ld, logS, rp;
  stats<I>(alpha, am, last, eiw, psi, ld, logS);
  // a record follows 0-based step m when m + 1 > burn_in and
  // (m + 1 - burn_in) % lag == 0 (miso_tpu/sampler/mcmc.py schedule);
  // the Gibbs draw before it also sums the read score
  int next_rec = p.burn_in + p.lag - 1;
  if (next_rec == 0 && p.iters > 0)
    gibbs<I, true>(p, grp, w, rl, lane, 0u, psi, n_valid, n, rp);
  else
    gibbs<I, false>(p, grp, w, rl, lane, 0u, psi, n_valid, n, rp);

  int accepted = 0, rec = 0;
  for (int m = 0; m < p.iters; ++m) {
    const uint32_t step = (uint32_t)m + 1u;
    float d[I], an[I], pn[I], ldn, logSn;
    const float log_u = ahead.take(p, grp, lane, step, z);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      d[i] = ns * z[i] * am[i];
      an[i] = alpha[i] + d[i];
    }
    stats<I>(an, am, last, eiw, pn, ldn, logSn);
    // MH log-ratio in alpha space: the proposal quadratic and the read
    // score cancel; iteration 0 drops the proposal correction
    float s1 = 0.f, sd = 0.f;
#pragma unroll
    for (int i = 0; i < I; ++i) {
      s1 += (n[i] + h1[i]) * d[i];
      sd += d[i];
    }
    const float full = m > 0 ? 1.f : 0.f;
    const float logr = s1 - n_valid * (logSn - logS) - H1 * (ldn - ld) +
                       full * (sd + kk * (ld - ldn));
    if (logr >= 0.f || log_u < logr) {
#pragma unroll
      for (int i = 0; i < I; ++i) {
        alpha[i] = an[i];
        psi[i] = pn[i];
      }
      ld = ldn;
      logS = logSn;
      ++accepted;
    }
    if (m == next_rec) {
      next_rec += p.lag;
      if (rec < p.rrec) {
        // joint score (miso.c:243-307) with the n and read score from
        // before this step's Gibbs draw
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < I; ++i)
          t += (n[i] + h1[i]) * (alpha[i] * am[i]) + n[i] * aliw[i];
        const float score = rp + t - n_valid * logS - H1 * ld + dir_const;
        if (leader) {
          const size_t o = ((size_t)e * p.rrec + rec) * p.K + k;
#pragma unroll
          for (int i = 0; i < I; ++i) p.psi_out[o * I + i] = psi[i];
          p.loglik_out[o] = score;
        }
        ++rec;
      }
    }
    if (m + 1 == next_rec && m + 1 < p.iters)
      gibbs<I, true>(p, grp, w, rl, lane, step, psi, n_valid, n, rp);
    else
      gibbs<I, false>(p, grp, w, rl, lane, step, psi, n_valid, n, rp);
  }
  if (leader) {
    p.acc_out[lane_i] = accepted;
#pragma unroll
    for (int i = 0; i < I; ++i) {
      p.final_n[(size_t)lane_i * I + i] = n[i];
      p.final_psi[(size_t)lane_i * I + i] = psi[i];
    }
  }
}

struct Launch {
  unsigned blocks;
  int threads;
  size_t shared_bytes;
  cudaStream_t stream;
};

template <int I>
int launch(const Params& p, const Launch& l) {
  if (l.shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reassign_kernel<I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)l.shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  reassign_kernel<I><<<l.blocks, l.threads, l.shared_bytes, l.stream>>>(p);
  return (int)cudaGetLastError();
}

// f<I>(args...) for the instance of width I.
#define MISO_FOR_WIDTH(I_, f, ...)            \
  switch (I_) {                               \
    case 2: return f<2>(__VA_ARGS__);         \
    case 3: return f<3>(__VA_ARGS__);         \
    case 4: return f<4>(__VA_ARGS__);         \
    case 6: return f<6>(__VA_ARGS__);         \
    case 8: return f<8>(__VA_ARGS__);         \
    case 16: return f<16>(__VA_ARGS__);       \
    case 32: return f<32>(__VA_ARGS__);       \
    case 64: return f<64>(__VA_ARGS__);       \
    default: return -1;                       \
  }

int dispatch_launch(int I, const Params& p, const Launch& l) {
  MISO_FOR_WIDTH(I, launch, p, l)
}

// The plan's own consistency: what the kernel's indexing relies on.
bool plan_ok(int R, int I, int K, int T, int lanes_per_block, int home,
             size_t shared_bytes) {
  if (T != 4 && T != 8 && T != 16 && T != 32) return false;
  const int threads = lanes_per_block * T;
  if (lanes_per_block < 1 || threads % 32 != 0 || threads > kMaxThreads)
    return false;
  if (R < 4 || R % 4 != 0) return false;
  switch (home) {
    case kShared:
      return lanes_per_block % K == 0 &&
             shared_bytes ==
                 (size_t)(lanes_per_block / K) * R * I * sizeof(float);
    case kCache:
      return shared_bytes == 0;
    default:
      return false;
  }
}

}  // namespace

extern "C" int miso_reassign(
    const float* read_w, const float* read_ls, const float* log_iso_w,
    const float* hyper, const float* amask, const float* iso_mask,
    const float* last_onehot, const float* scal, const float* start,
    float* psi_out, float* loglik_out, int* acc_out, float* final_n,
    float* final_psi, int E, int R, int I, int K, int iters, int burn_in,
    int lag, int rrec, unsigned int seed_lo, unsigned int seed_hi,
    int fixed_u, int T, int lanes_per_block, int home,
    long long shared_bytes, void* stream) {
  const long long lanes = (long long)E * K;
  if (lanes == 0) return 0;
  if (lanes > 0x7fffffffLL || shared_bytes < 0 ||
      !plan_ok(R, I, K, T, lanes_per_block, home, (size_t)shared_bytes))
    return (int)cudaErrorInvalidValue;
  int log_t = 0;
  while ((1 << log_t) < T) ++log_t;
  Params p{read_w, read_ls, log_iso_w, hyper, amask, iso_mask,
           last_onehot, scal, start, psi_out, loglik_out, acc_out,
           final_n, final_psi, E, R, K, iters, burn_in, lag, rrec};
  for (int r = 0; r < 10; ++r) {
    p.key0[r] = seed_lo + (uint32_t)r * 0x9E3779B9u;
    p.key1[r] = seed_hi + (uint32_t)r * 0xBB67AE85u;
  }
  p.fixed_u = fixed_u;
  p.u_scale = fixed_u ? 0.f : kTwoM24;
  p.u_shift = fixed_u ? kFixedU : 0.f;
  p.T = T;
  p.log_t = log_t;
  p.lanes_per_block = lanes_per_block;
  p.home = home;
  const Launch l{
      (unsigned)((lanes + lanes_per_block - 1) / lanes_per_block),
      lanes_per_block * T, (size_t)shared_bytes,
      static_cast<cudaStream_t>(stream)};
  const int rc = dispatch_launch(I, p, l);
  return rc < 0 ? (int)cudaErrorInvalidValue : rc;
}

extern "C" const char* miso_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
