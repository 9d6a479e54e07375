// MARGINAL / CLASSES collapsed sampler for Hopper (sm_90a).
//
// Replaces miso_tpu/sampler/pallas_marginal.py::_marginal_kernel (launcher
// run_batch_pallas_marginal): the whole chain of every (event, chain) lane
// in one launch -- AUTO or GIVEN start, logistic-normal drift proposal,
// joint score sum_c counts_c * log(sum_i W_ci psi_i) plus the Dirichlet
// prior, the full proposal correction, MH accept, burn-in/lag records.
// There is no Gibbs step.  Its plain PyTorch version is _marginal_plain in
// miso_tpu_torch/sampler/marginal_kernel.py; under fixed_u (every uniform
// 0.4999f, the TPU kernel's NO_PRNG mode) both give the same chain.
//
// What bounds it: first the dependent chain, then operations; never
// bytes (a chunk's weights are a few hundred KB and stay in L1/L2).  The
// 5,001 steps of a chain depend on each other, and inside a step alpha ->
// expf -> division -> logf -> dot product -> logf -> ordered sum ->
// compare is one chain of precise f32 calls.  The only parallelism is
// across the E*K lanes (12,288 at E=2048, K=6: 384 warps of one-thread
// lanes on a card with 528 warp schedulers), so a thread a lane leaves
// every scheduler waiting on one warp's latencies.
//
// Design, from the launch plan (marginal_plan in marginal_kernel.py):
//
// - A lane is a group of T threads, T in {1, 2, 4, 8, 16, 32}, inside one
//   warp; a warp carries 32 / T lanes.  T is a launch argument.
// - An event's classes over the lane's threads.  Thread t works out
//   counts_c * log(s_c) for classes t, t + T, ...; the lane then adds the
//   terms in ascending class order, each fetched by a shuffle, so every
//   thread holds the bitwise-same score and the accept decision cannot
//   differ inside a lane.  C serial adds take the place of C serial logs.
// - Randoms ahead of the chain.  The proposal normals and log(u_accept)
//   depend on (lane, step) alone.  Every T steps, thread t of the lane
//   draws them for step s + t (Philox, logf, sqrtf, cosf, sinf); each step
//   takes its values from its thread by a shuffle.  The Philox counters
//   are (lane, step, pair, purpose) whatever T is, so one seed gives one
//   chain in every plan.  The round keys are kernel arguments.
// - Everything I-wide (psi from alpha, log psi, the two proposal
//   densities) every thread of the lane repeats: in lockstep that costs a
//   small launch no time, and a full launch T times the instructions,
//   which is why the plan narrows T as the card fills and keeps wide I to
//   two threads.
// - Less on the chain: the log of the last isoform's psi is log psi of
//   that isoform, not a log of its own; the part of the proposal density
//   that the state alone decides is carried with the accepted state, as
//   the joint score is (the TPU kernel recomputes it every step only
//   because carrying froze 3-isoform chains under Mosaic; it is the same
//   function of the same psi); the accept is a select, because the lanes
//   of a warp accept differently; a sin row that no head isoform takes is
//   not computed.
// - W and counts stay behind the read-only cache, which takes any class
//   count C; a copy in registers (one class a thread) was no faster.
//
// Build: this file is compiled with -fmad=false (kernels.py): no a*b + c is
// contracted into an FMA, since the plain version rounds every product and
// sum on its own and the two must take the same accept decisions.  Every
// sum runs in a fixed order, over classes and over isoforms in ascending
// index, as the plain version's does; logf, expf, cosf, sinf and the
// division are the precise ones.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Instances for I = 2 ... 64 (KERNEL_ISO in reassign_kernel.py); their
// loops over the isoforms (and the I/2 normal pairs) unroll fully.  From
// wide.WIDE_FROM_MARGINAL isoforms on, of any width, the wide kernel
// (wide_kernel.cu) takes a bucket: a lane a block, its arrays once in
// shared memory.

constexpr float kFixedU = 0.4999f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kTiny = 1e-38f;
constexpr float kTwoM24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoM23 = 1.1920928955078125e-07f;  // 2^-23

// Philox counter word 3: which draw of a step the bits feed.
constexpr uint32_t kNormals = 1, kAccept = 2;

// The widest block (MAX_THREADS in marginal_kernel.py).
constexpr int kMaxThreads = 128;

struct Params {
  const float* weights;  // (E, C, I) class weights
  const float* counts;   // (E, C) reads per class
  const int* num_iso;    // (E,) real isoforms, 0 on padding events
  const float* hyper;    // (E, I), 1 on padded isoforms
  const float* scal;     // (E, 4): noise_scale, inv_sigma, prop_const,
                         //         dir_const
  const float* start;    // (E, K, I) GIVEN start, or null for AUTO
  float* psi_out;        // (E, RREC, K, I)
  float* loglik_out;     // (E, RREC, K)
  int* acc_out;          // (E, K)
  float* final_psi;      // (E, K, I)
  int E, C, K, iters, burn_in, lag, rrec;
  // Philox round keys of the seed (k + r * Weyl constant), worked out by
  // the launcher: a kernel argument is an operand, not an instruction
  uint32_t key0[10], key1[10];
  int fixed_u;
  int T, log_t, lanes_per_block;
};

// Philox4x32-10, the generator of reassign_kernel.cu: counter c, 64-bit
// key.
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

// [0, 1) at 23 bits, as the TPU kernel's _u01.
__device__ __forceinline__ float u01(uint32_t b) {
  return (float)(b & 0x7FFFFFu) * kTwoM23;
}

// masks of an event with k real isoforms: the k-1 head isoforms carry the
// alpha coordinates, isoform k-1 is the last one
__device__ __forceinline__ float head(int i, int k) {
  return i < k - 1 ? 1.f : 0.f;
}
__device__ __forceinline__ float last(int i, int k) {
  return i == k - 1 ? 1.f : 0.f;
}

// The T threads of one lane: T consecutive threads of a warp, aligned to
// T (T = 1: the thread itself).  Every shuffle names the whole warp, so
// all 32 threads of a warp take every shuffle together: the step loop is
// the same for every lane, and a lane past the batch's end runs along
// and writes nothing.  A shuffle width of T keeps the data inside the
// lane.
struct Group {
  int T;  // threads in the lane
  int t;  // this thread's place in it

  // v of the lane's thread src
  __device__ __forceinline__ float from(float v, int src) const {
    return __shfl_sync(0xffffffffu, v, src, T);
  }
  // acc + v_0 + v_1 + ... + v_{n-1}, the values of the lane's first n
  // threads added one by one in thread order: every thread ends with the
  // bitwise-same sum.  n is a multiple of 4 up to T: four shuffles at a
  // time, which overlap (T = 2 has two, T = 1 none).
  __device__ __forceinline__ float add_in_order(float acc, float v,
                                                int n) const {
    if (T == 1) return acc + v;
    if (T == 2) return (acc + from(v, 0)) + from(v, 1);
#pragma unroll 1
    for (int j = 0; j < n; j += 4) {
      const float a = from(v, j), b = from(v, j + 1);
      const float c = from(v, j + 2), d = from(v, j + 3);
      acc = (((acc + a) + b) + c) + d;
    }
    return acc;
  }
};

// (I,) standard normals by Box-Muller for an event of k real isoforms.
// With Philox the cos/sin pair of one radius fills rows j and j + H; in
// fixed-uniform mode every row is r*cos(2*pi*u), as the TPU kernel's
// cos-only _normal((I, B)) gives.  Only the k - 1 head isoforms take a
// normal, so a sin row past them is left 0 and its sinf is never called
// (with two isoforms: one cosf a step, no sinf).
template <int I>
__device__ __forceinline__ void normals(const Params& p, uint32_t lane,
                                        uint32_t step, int k, float z[I]) {
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
    if (j + H < I) {
      z[j + H] = 0.f;
      if (j + H < k - 1) z[j + H] = p.fixed_u ? z[j] : r * sinf(ang);
    }
  }
}

// The randoms of a step depend on (lane, step) alone, so they are drawn
// ahead of the chain: every T steps, thread t of the lane draws those of
// step base + t, and each step takes its values from its thread.
template <int I>
struct Ahead {
  float z[I];   // proposal normals of this thread's step
  float log_u;  // log of its accept uniform

  __device__ __forceinline__ void refill(const Params& p, const Group& g,
                                         uint32_t lane, uint32_t base,
                                         int k) {
    const uint32_t step = base + (uint32_t)g.t;
    normals<I>(p, lane, step, k, z);
    float u = kFixedU;
    if (!p.fixed_u)
      u = u01(philox4x32_10(make_uint4(lane, step, 0u, kAccept), p).x);
    log_u = logf(fmaxf(u, kTwoM24));
  }

  // The normals and log(u_accept) of `step`, on every thread of the lane.
  __device__ __forceinline__ float take(const Params& p, const Group& g,
                                        uint32_t lane, uint32_t step, int k,
                                        float zs[I]) {
    const int src = (int)(step & (uint32_t)(g.T - 1));
    if (src == 0) refill(p, g, lane, step, k);
    if (g.T == 1) {
#pragma unroll
      for (int i = 0; i < I; ++i) zs[i] = z[i];
      return log_u;
    }
#pragma unroll
    for (int i = 0; i < I; ++i) zs[i] = g.from(z[i], src);
    return g.from(log_u, src);
  }
};

// alpha -> psi: e = exp(alpha) on the head isoforms, head = e / (1 +
// sum e), and the last isoform takes 1 - sum(head) (pallas_marginal.py
// logistic_inv).  An isoform that is no head has e = 0 and head = 0
// whatever its alpha: its exp and division are skipped.
template <int I>
__device__ __forceinline__ void psi_of_alpha(const float alpha[I], int k,
                                             float psi[I]) {
  float e[I];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    e[i] = 0.f;
    if (i < k - 1) e[i] = expf(alpha[i]);
    s = s + e[i];
  }
  const float denom = 1.0f + s;
  float hs = 0.f;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    if (i < k - 1) e[i] = e[i] / denom;
    hs = hs + e[i];
  }
#pragma unroll
  for (int i = 0; i < I; ++i) psi[i] = e[i] + last(i, k) * (1.0f - hs);
}

// lp = log max(psi, 1e-38), two isoforms at a time: a pair's calls
// overlap.  The first pair is worked out whatever k is, so that it can
// overlap the log of the thread's first class (first_term) too; a later
// pair of padded isoforms, whose logs nothing reads, is skipped.
template <int I>
__device__ __forceinline__ void log_psi(const float psi[I], int k,
                                        float lp[I]) {
#pragma unroll
  for (int i = 0; i < I; i += 2) {
    float a = 0.f, b = 0.f;
    if (i == 0 || i < k) {
      a = logf(fmaxf(psi[i], kTiny));
      if (i + 1 < I) b = logf(fmaxf(psi[i + 1], kTiny));
    }
    lp[i] = a;
    if (i + 1 < I) lp[i + 1] = b;
  }
}

// counts_c * log(s_c) of a class with s_c > 0 (miso.c:272-293), else 0:
// an empty class adds nothing.  A select, not a branch: the log then
// overlaps its neighbours instead of waiting behind them.
__device__ __forceinline__ float class_term(float s, float count) {
  const float term = count * logf(fmaxf(s, kTiny));
  return s > 0.f ? term : 0.f;
}

// The read term is sum_c counts_c * log(s_c), s_c = sum_i W_ci psi_i,
// over the event's W (C, I) and counts (C,), read through the read-only
// cache in every step (registers held them no faster, see PERF.md).  The
// classes are spread over the lane's threads: thread t works out the
// terms of classes t, t + T, ..., T classes a round, and the lane sums a
// round's terms in ascending class order, each term fetched from its
// thread, so that every thread holds the bitwise-same sum.  A thread's
// place past the last class adds 0, which changes no sum.
//
// round_dot: s_c of this thread's class of the round that starts at class
// c0, or 0 where it has none or the class has no reads; *count its reads.
template <int I>
__device__ __forceinline__ float round_dot(const Group& g, const float* w,
                                           const float* cnt, int C, int c0,
                                           const float psi[I],
                                           float* count) {
  const bool mine = c0 + g.t < C;
  const int c = mine ? c0 + g.t : C - 1;
  const float* wc = w + (size_t)c * I;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < I; ++i) s = s + __ldg(wc + i) * psi[i];
  *count = __ldg(cnt + c);
  return mine && *count > 0.f ? s : 0.f;
}

// The thread's term of the first round, without a branch: the step calls
// it between psi_of_alpha and log_psi, and its log overlaps theirs.
template <int I>
__device__ __forceinline__ float first_term(const Group& g, const float* w,
                                            const float* cnt, int C,
                                            const float psi[I]) {
  float count;
  const float s = round_dot<I>(g, w, cnt, C, 0, psi, &count);
  return class_term(s, count);
}

// The read term from the first round's terms and the later rounds.
// Where no thread of the warp has a class with reads and weight (padded
// classes: a bucket's C is a power of two), the warp skips a later
// round's logs and sum.
template <int I>
__device__ __forceinline__ float read_term(const Group& g, const float* w,
                                           const float* cnt, int C,
                                           const float psi[I], float first) {
  const int first_left = (C + 3) & ~3;
  float rt =
      g.add_in_order(0.f, first, first_left < g.T ? first_left : g.T);
  if (g.T == 1) {
    // one thread walks every class; an empty one costs its dot product
#pragma unroll (I <= 8 ? 4 : 1)
    for (int c = 1; c < C; ++c) {
      const float* wc = w + (size_t)c * I;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < I; ++i) s = s + __ldg(wc + i) * psi[i];
      if (s > 0.f) rt = rt + __ldg(cnt + c) * logf(fmaxf(s, kTiny));
    }
    return rt;
  }
#pragma unroll (I <= 8 ? 2 : 1)
  for (int c0 = g.T; c0 < C; c0 += g.T) {
    float count;
    const float s = round_dot<I>(g, w, cnt, C, c0, psi, &count);
    if (!__any_sync(0xffffffffu, s > 0.f)) continue;
    const int left = (C - c0 + 3) & ~3;
    rt = g.add_in_order(rt, class_term(s, count), left < g.T ? left : g.T);
  }
  return rt;
}

// A state's psi, log psi and joint score from its alpha: the read term
// plus the Dirichlet term sum_i (h_i - 1) log psi_i over the real
// isoforms and dir_const.
template <int I>
__device__ __forceinline__ float state_of_alpha(
    const Group& g, const float* w, const float* cnt, int C,
    const float alpha[I], const float h1[I], int k, float dir_const,
    float psi[I], float lp[I]) {
  psi_of_alpha<I>(alpha, k, psi);
  const float first = first_term<I>(g, w, cnt, C, psi);
  log_psi<I>(psi, k, lp);
  const float rt = read_term<I>(g, w, cnt, C, psi, first);
  float ds = 0.f;
#pragma unroll
  for (int i = 0; i < I; ++i)
    if (i < k) ds = ds + h1[i] * lp[i];
  return rt + (ds + dir_const);
}

// log q(psi | mu), the logistic-normal proposal density with diagonal
// sigma (miso.c:97-122, pallas_marginal.py proposal_score), is
// ((prop_const - sum_head lp) - lt) + (-0.5 sum_head ((lp - lt) - mu)^2)
// * inv_sigma with lt the log of the last isoform's psi.  lt is lp of
// that isoform (the sum that picks its psi adds zeros), so it costs no
// log of its own; without real isoforms it is log(1e-38).
template <int I>
__device__ __forceinline__ float last_log(const float lp[I], int k,
                                          float log_tiny) {
  // a sum over the one-hot mask, as the plain version picks psi: written
  // as a chain of selects, the compiler indexed lp by k and moved the
  // array to local memory
  float lt = 0.f;
#pragma unroll
  for (int i = 0; i < I; ++i) lt = lt + lp[i] * last(i, k);
  return k > 0 ? lt : log_tiny;
}

// The part of log q(psi | mu) that psi alone decides: it is carried with
// the accepted state.
template <int I>
__device__ __forceinline__ float proposal_base(const float lp[I], float lt,
                                               int k, float prop_const) {
  float slp = 0.f;
#pragma unroll
  for (int i = 0; i < I; ++i) slp = slp + (i < k - 1 ? lp[i] : 0.f);
  return (prop_const - slp) - lt;
}

// -0.5 sum_head ((lp - lt) - mu)^2
template <int I>
__device__ __forceinline__ float proposal_quad(const float lp[I], float lt,
                                               const float mu[I], int k) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const float t = i < k - 1 ? (lp[i] - lt) - mu[i] : 0.f;
    ss = ss + t * t;
  }
  return -0.5f * ss;
}

template <int I>
__global__ void __launch_bounds__(kMaxThreads) marginal_kernel(const Params p) {
  // a lane past the batch's end runs the last lane's chain along with
  // its warp (see Group) and writes nothing
  const long long lanes = (long long)p.E * p.K;
  const long long lane_ll = (long long)blockIdx.x * p.lanes_per_block +
                            ((int)threadIdx.x >> p.log_t);
  const int lane_i = (int)(lane_ll < lanes ? lane_ll : lanes - 1);
  const uint32_t lane = (uint32_t)lane_i;
  const int e = lane_i / p.K;
  Group grp;
  grp.T = p.T;
  grp.t = (int)threadIdx.x & (p.T - 1);
  const bool leader = grp.t == 0 && lane_ll < lanes;

  const int k = p.num_iso[e];
  const float* w = p.weights + (size_t)e * p.C * I;
  const float* cnt = p.counts + (size_t)e * p.C;
  const float ns = p.scal[4 * e];
  const float inv_sigma = p.scal[4 * e + 1];
  const float prop_const = p.scal[4 * e + 2];
  const float dir_const = p.scal[4 * e + 3];
  float h1[I];
  float km1 = 0.f;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    h1[i] = i < k ? p.hyper[(size_t)e * I + i] - 1.0f : 0.f;
    km1 = km1 + head(i, k);
  }

  // start (miso.c:348-371 AUTO, :405-409 GIVEN), then one proposal
  // (miso.c:834)
  float alpha[I], z[I], psi[I], lp[I];
  if (p.start != nullptr) {
    const float* sp = p.start + (size_t)lane_i * I;
    float sl = 0.f;
#pragma unroll
    for (int i = 0; i < I; ++i) sl = sl + sp[i] * last(i, k);
    const float lsl = logf(fmaxf(sl, 1e-30f));
#pragma unroll
    for (int i = 0; i < I; ++i)
      alpha[i] = i < k - 1 ? logf(fmaxf(sp[i], 1e-30f)) - lsl : 0.f;
  } else {
    const float a0 = km1 == 1.0f ? 0.f : 1.0f / fmaxf(km1, 1.0f);
#pragma unroll
    for (int i = 0; i < I; ++i) alpha[i] = i < k - 1 ? a0 : 0.f;
  }
  Ahead<I> ahead;
  ahead.take(p, grp, lane, 0u, k, z);  // step 0 has no accept draw
#pragma unroll
  for (int i = 0; i < I; ++i) alpha[i] = alpha[i] + ns * z[i] * head(i, k);
  float cjs =
      state_of_alpha<I>(grp, w, cnt, p.C, alpha, h1, k, dir_const, psi, lp);
  const float log_tiny = logf(kTiny);
  float lt = last_log<I>(lp, k, log_tiny);
  float base = proposal_base<I>(lp, lt, k, prop_const);

  // a record follows 0-based step m when m + 1 > burn_in and
  // (m + 1 - burn_in) % lag == 0 (miso_tpu/sampler/mcmc.py schedule)
  int next_rec = p.burn_in + p.lag - 1;
  int accepted = 0, rec = 0;
  for (int m = 0; m < p.iters; ++m) {
    const uint32_t step = (uint32_t)m + 1u;
    float an[I], pn[I], lpn[I];
    const float log_u = ahead.take(p, grp, lane, step, k, z);
#pragma unroll
    for (int i = 0; i < I; ++i) an[i] = alpha[i] + ns * z[i] * head(i, k);
    const float pjs = state_of_alpha<I>(grp, w, cnt, p.C, an, h1, k,
                                        dir_const, pn, lpn);
    // iteration 0 drops the proposal correction (pallas_marginal.py:146)
    const float ltn = last_log<I>(lpn, k, log_tiny);
    const float basen = proposal_base<I>(lpn, ltn, k, prop_const);
    const float pto_c = base + proposal_quad<I>(lp, lt, an, k) * inv_sigma;
    const float cto_p =
        basen + proposal_quad<I>(lpn, ltn, alpha, k) * inv_sigma;
    const float full = m > 0 ? 1.f : 0.f;
    const float logr = (pjs - cjs) + full * (pto_c - cto_p);
    // a select, not a branch: the lanes of a warp accept differently
    const bool acc = logr >= 0.f || log_u < logr;
#pragma unroll
    for (int i = 0; i < I; ++i) {
      alpha[i] = acc ? an[i] : alpha[i];
      psi[i] = acc ? pn[i] : psi[i];
      lp[i] = acc ? lpn[i] : lp[i];
    }
    lt = acc ? ltn : lt;
    base = acc ? basen : base;
    cjs = acc ? pjs : cjs;
    accepted += acc ? 1 : 0;
    if (m == next_rec) {
      next_rec += p.lag;
      if (rec < p.rrec) {
        if (leader) {
          // the absolute joint score of the state after this step
          const size_t o =
              ((size_t)e * p.rrec + rec) * p.K + (lane_i - e * p.K);
#pragma unroll
          for (int i = 0; i < I; ++i) p.psi_out[o * I + i] = psi[i];
          p.loglik_out[o] = cjs;
        }
        ++rec;
      }
    }
  }
  if (leader) {
    p.acc_out[lane_i] = accepted;
#pragma unroll
    for (int i = 0; i < I; ++i)
      p.final_psi[(size_t)lane_i * I + i] = psi[i];
  }
}

template <int I>
int launch(const Params& p, unsigned blocks, int threads, cudaStream_t s) {
  marginal_kernel<I><<<blocks, threads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// The plan's own consistency: what the kernel's indexing relies on.
bool plan_ok(int T, int lanes_per_block) {
  if (T < 1 || T > 32 || (T & (T - 1)) != 0) return false;
  const int threads = lanes_per_block * T;
  return lanes_per_block >= 1 && threads % 32 == 0 && threads <= kMaxThreads;
}

}  // namespace

extern "C" int miso_marginal(
    const float* weights, const float* counts, const int* num_iso,
    const float* hyper, const float* scal, const float* start,
    float* psi_out, float* loglik_out, int* acc_out, float* final_psi, int E,
    int C, int I, int K, int iters, int burn_in, int lag, int rrec,
    unsigned int seed_lo, unsigned int seed_hi, int fixed_u, int T,
    int lanes_per_block, void* stream) {
  const long long lanes = (long long)E * K;
  if (lanes == 0) return 0;
  if (lanes > 0x7fffffffLL || C < 1 || lag < 1 ||
      !plan_ok(T, lanes_per_block))
    return (int)cudaErrorInvalidValue;
  Params p{weights, counts, num_iso, hyper, scal, start, psi_out,
           loglik_out, acc_out, final_psi, E, C, K, iters, burn_in,
           lag, rrec};
  for (int r = 0; r < 10; ++r) {
    p.key0[r] = seed_lo + (uint32_t)r * 0x9E3779B9u;
    p.key1[r] = seed_hi + (uint32_t)r * 0xBB67AE85u;
  }
  p.fixed_u = fixed_u;
  p.T = T;
  p.log_t = 0;
  while ((1 << p.log_t) < T) ++p.log_t;
  p.lanes_per_block = lanes_per_block;
  const unsigned blocks =
      (unsigned)((lanes + lanes_per_block - 1) / lanes_per_block);
  const int threads = lanes_per_block * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (I) {
    case 2: return launch<2>(p, blocks, threads, s);
    case 3: return launch<3>(p, blocks, threads, s);
    case 4: return launch<4>(p, blocks, threads, s);
    case 6: return launch<6>(p, blocks, threads, s);
    case 8: return launch<8>(p, blocks, threads, s);
    case 16: return launch<16>(p, blocks, threads, s);
    case 32: return launch<32>(p, blocks, threads, s);
    case 64: return launch<64>(p, blocks, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
