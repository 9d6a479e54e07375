// Deep REASSIGN sampler for Hopper (sm_90a): the MH chain with the
// per-class multinomial Gibbs step (kernel B3).
//
// Replaces the XLA path that the JAX package runs for REASSIGN buckets of
// more than 16,384 reads: mcmc.run_batch(..., gibbs="multinomial"), the
// step of miso_tpu/sampler/mcmc.py:383-419 around _gibbs (:375-381) and
// model.gibbs_reassign (miso_tpu/sampler/model.py:198-212, one
// jax.random.multinomial per class).  That path is no Pallas kernel; it
// gets a hand kernel because its eager form (about 83 launches an
// iteration) was the bottleneck of every deep bucket on the card.  The
// whole chain of every (event, chain) lane runs in one launch: AUTO or
// GIVEN start, one proposal and the initial Gibbs draw, then per
// iteration the logistic-normal drift proposal, the MH ratio in alpha
// space (the form of reassign_kernel.cu), the accept, and the Gibbs step
// n_c ~ Multinomial(counts_c, p_c) for every class with a compatible
// isoform, p_cj = psi_j W_cj / sum_j psi_j W_cj, drawn as chained
// binomials over the isoforms (ratio_j = p_j / sum of p over j and after,
// 1 as divisor where that mass is 0, clipped to [0, 1]); the read score
// sum_c,j n_cj log_read[c, j] on recording iterations; the records,
// accepted and final_n.  Its plain PyTorch version is _multinomial_plain
// in miso_tpu_torch/sampler/deep.py; under fixed_u both give the same
// chain.
//
// The binomial draw is exact: inversion (the geometric gaps) where
// n * min(p, 1 - p) < 10, BTRS (Hormann 1993) from there on, with the
// symmetry p > 1/2 -> n - Bin(n, 1 - p), as torch.binomial and
// jax.random.binomial draw it, in double precision.  Counts are f32 and
// exact below 2^24 reads, so every class sums exactly to its count.
// Under fixed_u (every uniform 0.4999f) a draw is floor(n * ratio + u)
// clipped to [0, n]: bounded and deterministic, never the rejection loop.
//
// What bounds it: the dependent chain.  Its work per iteration is O(C * I)
// per lane, not O(R * I), and a deep bucket has few lanes (16 events x 6
// chains = 96 lanes on 132 SMs), so a step is one long chain of latencies
// (Philox -> Box-Muller -> exp -> log -> MH -> per class: division ->
// Philox -> binomial -> shuffles), repeated for 5,001 dependent steps.
// Bytes are nothing (a bucket's class tables are KB).  multinomial_bound
// and multinomial_floor in deep.py give the bound and an estimated floor.
//
// Design, from the launch plan (multinomial_plan in deep.py):
//
// - A lane is a group of T threads, T in {1, 2, 4, 8, 16, 32}, inside one
//   warp; a warp carries 32 / T lanes.  Thread t draws the classes t,
//   t + T, ...; its per-isoform counts, the lane's compatible reads and
//   the read score are summed over the lane by an xor butterfly, which
//   leaves the bitwise-same sums on every thread.  Counts are integers
//   below 2^24, so their sum is exact in any order; the read score is
//   summed in double (f32 x f32 products are exact there) and rounded to
//   f32 once.
// - The I-wide MH arithmetic every thread of the lane repeats; the
//   accept decision therefore never differs inside a lane.
// - Randoms: Philox4x32-10 as in the other kernels, counters (lane, step,
//   pair, kNormals), (lane, step, 0, kAccept) and for the Gibbs step
//   (lane, step, class, kGibbs | isoform << 10 | call), so one seed gives
//   one chain in every plan.
// - Width: one instance takes the isoform count I at run time; a
//   thread's per-isoform arrays lie in a scratch buffer that the wrapper
//   allocates (kArrays arrays of I floats a thread, behind the L1).  No
//   deep bucket is refused for its width.
//
// Build: this file is compiled with -fmad=false (kernels.py), as the
// marginal kernel is: no a*b + c is contracted, since the plain version
// rounds every product and sum on its own and the two must take the same
// accept decisions.  Every f32 sum runs over the isoforms in ascending
// order, as the plain version's do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFixedU = 0.4999f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kNegBig = -1e30f;
constexpr float kTiny = 1e-38f;
constexpr float kTwoM24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoM23 = 1.1920928955078125e-07f;  // 2^-23
constexpr double kTwoM53 = 1.1102230246251565e-16;  // 2^-53

// Philox counter word 3: which draw of a step the bits feed.
constexpr uint32_t kNormals = 1, kAccept = 2, kGibbs = 0x80000000u;

// The widest block (MAX_THREADS in deep.py).
constexpr int kMaxThreads = 128;
// Per-isoform arrays of a thread (SCRATCH_ARRAYS in deep.py), kept in
// scratch: kArrays * I floats a thread.
constexpr int kArrays = 13;
// Inversion below this mean n * min(p, 1 - p), BTRS from it on.
constexpr double kBtrsMean = 10.0;

struct Params {
  const float* weights;      // (E, C, I) class weights
  const float* log_read;     // (E, C, I) log read score of a class's read
  const float* counts;       // (E, C) reads per class
  const float* log_iso_w;    // (E, I), clamped to -1e30
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
  float* scratch;            // kArrays * I floats a thread
  int E, C, I, K, iters, burn_in, lag, rrec;
  // Philox round keys of the seed (k + r * Weyl constant), worked out by
  // the launcher
  uint32_t key0[10], key1[10];
  int fixed_u;
  int T, log_t, lanes_per_block;
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

// (0, 1) strictly at 53 bits from two words, for the binomial draws.
__device__ __forceinline__ double u53(uint32_t hi, uint32_t lo) {
  return ((double)(hi >> 5) * 67108864.0 + (double)(lo >> 6) + 0.5) *
         kTwoM53;
}

// The T threads of one lane (see marginal_kernel.cu): every shuffle names
// the whole warp, so all its threads take every shuffle together, and a
// lane past the batch's end runs along and writes nothing.  xor offsets
// below T keep the data inside the lane.
struct Group {
  int T;  // threads in the lane
  int t;  // this thread's place in it

  // xor butterfly: every thread ends with the bitwise-same sum
  template <class V>
  __device__ __forceinline__ V sum(V v) const {
    for (int o = T >> 1; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
};

// The uniforms of one binomial draw: pairs keyed by (lane, step, class,
// isoform, call), two doubles a Philox call.
struct Stream {
  uint4 ctr;
  uint32_t call;
  __device__ __forceinline__ double2 next(const Params& p) {
    uint4 c = ctr;
    c.w |= call++ & 1023u;
    const uint4 b = philox4x32_10(c, p);
    return make_double2(u53(b.x, b.y), u53(b.z, b.w));
  }
};

// Stirling's series tail log k! - [(k + 1/2) log(k + 1) - (k + 1) +
// log(2 pi) / 2] for BTRS (torch's stirling_approx_tail).
__device__ __forceinline__ double stirling_tail(double k) {
  if (k <= 9.0) {
    switch ((int)k) {
      case 0: return 0.0810614667953272;
      case 1: return 0.0413406959554092;
      case 2: return 0.0276779256849983;
      case 3: return 0.02079067210376509;
      case 4: return 0.0166446911898211;
      case 5: return 0.0138761288230707;
      case 6: return 0.0118967099458917;
      case 7: return 0.0104112652619720;
      case 8: return 0.00925546218271273;
      default: return 0.00833056343336287;
    }
  }
  const double kp1sq = (k + 1.0) * (k + 1.0);
  return (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (k + 1.0);
}

// Bin(n, q), q <= 1/2 and n q < 10: the number of geometric gaps of
// success probability q that fit in n trials.
__device__ double inversion(const Params& p, Stream& s, double n, double q) {
  const double logq = log1p(-q);
  double sum = 0.0, x = 0.0;
  for (;;) {
    const double2 u = s.next(p);
    sum += ceil(log(u.x) / logq);
    if (sum > n) return x;
    x += 1.0;
    sum += ceil(log(u.y) / logq);
    if (sum > n) return x;
    x += 1.0;
  }
}

// Bin(n, q), q <= 1/2 and n q >= 10: transformed rejection with squeeze
// (Hormann 1993, BTRS), as torch's btrs.
__device__ double btrs(const Params& p, Stream& s, double n, double q) {
  const double stddev = sqrt(n * q * (1.0 - q));
  const double b = 1.15 + 2.53 * stddev;
  const double a = -0.0873 + 0.0248 * b + 0.01 * q;
  const double c = n * q + 0.5;
  const double v_r = 0.92 - 4.2 / b;
  const double r = q / (1.0 - q);
  const double alpha = (2.83 + 5.1 / b) * stddev;
  const double m = floor((n + 1.0) * q);
  for (;;) {
    const double2 uv = s.next(p);
    const double U = uv.x - 0.5;
    double V = uv.y;
    const double us = 0.5 - fabs(U);
    const double k = floor((2.0 * a / us + b) * U + c);
    if (k < 0.0 || k > n) continue;
    if (us >= 0.07 && V <= v_r) return k;
    V = log(V * alpha / (a / (us * us) + b));
    const double upper =
        (m + 0.5) * log((m + 1.0) / (r * (n - m + 1.0))) +
        (n + 1.0) * log((n - m + 1.0) / (n - k + 1.0)) +
        (k + 0.5) * log(r * (n - k + 1.0) / (k + 1.0)) + stirling_tail(m) +
        stirling_tail(n - m) - stirling_tail(k) - stirling_tail(n - k);
    if (V <= upper) return k;
  }
}

// One draw of the chained binomials: Bin(n, ratio), or under fixed_u
// floor(n * ratio + u) clipped to [0, n].
__device__ __forceinline__ float binomial(const Params& p, Stream& s,
                                          float n, float ratio) {
  if (p.fixed_u)
    return fminf(fmaxf(floorf(n * ratio + kFixedU), 0.f), n);
  if (n <= 0.f || ratio <= 0.f) return 0.f;
  if (ratio >= 1.f) return n;
  const double dn = (double)n;
  const bool flip = ratio > 0.5f;
  const double q = flip ? 1.0 - (double)ratio : (double)ratio;
  const double k = dn * q < kBtrsMean ? inversion(p, s, dn, q)
                                      : btrs(p, s, dn, q);
  return (float)(flip ? dn - k : k);
}

// (I,) standard normals sharing one Box-Muller radius per cos/sin pair:
// rows [0, H) take r*cos, rows [H, I) r*sin (pallas_kernel._normal_rows),
// as reassign_kernel.cu draws them.
__device__ __forceinline__ void normal_rows(const Params& p, int I,
                                            uint32_t lane, uint32_t step,
                                            float* z) {
  const int H = (I + 1) / 2;
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

// alpha -> (psi, log denom, log S) with e = exp(alpha) on the head
// isoforms, denom = 1 + sum(e), psi = (e + last) / denom and
// S = sum((e + last) * efflen) (reassign_kernel._stats).
__device__ __forceinline__ void stats(int I, const float* alpha,
                                      const float* am, const float* last,
                                      const float* eiw, float* psi,
                                      float& ld, float& logS) {
  float s = 0.f;
  for (int i = 0; i < I; ++i) {
    psi[i] = expf(alpha[i]) * am[i];  // e, for now
    s = s + psi[i];
  }
  const float denom = 1.0f + s;
  ld = logf(fmaxf(denom, kTiny));
  float S = 0.f;
  for (int i = 0; i < I; ++i) {
    const float ea = psi[i] + last[i];
    psi[i] = ea / denom;
    S = S + ea * eiw[i];
  }
  logS = logf(fmaxf(S, kTiny));
}

// The Gibbs step of one thread's classes, summed over the lane: n gets
// every isoform's reads, the return value the read score (want_rp: a
// record will read it; 0 otherwise).
__device__ __forceinline__ float gibbs(const Params& p, const Group& g,
                                       int I, int e, uint32_t lane,
                                       uint32_t step, const float* psi,
                                       bool want_rp, float* n, float* probs,
                                       float* rest) {
  const float* w = p.weights + (size_t)e * p.C * I;
  const float* lr = p.log_read + (size_t)e * p.C * I;
  const float* cnt = p.counts + (size_t)e * p.C;
  for (int i = 0; i < I; ++i) n[i] = 0.f;
  double rp = 0.0;
  for (int c = g.t; c < p.C; c += g.T) {
    const float count = cnt[c];
    const float* wc = w + (size_t)c * I;
    float tot = 0.f;
    for (int j = 0; j < I; ++j) {
      probs[j] = psi[j] * wc[j];
      tot = tot + probs[j];
    }
    // a class of no reads or no mass draws nothing
    if (!(count > 0.f && tot > 0.f)) continue;
    for (int j = 0; j < I; ++j) probs[j] = probs[j] / tot;
    rest[I - 1] = probs[I - 1];
    for (int j = I - 2; j >= 0; --j) rest[j] = probs[j] + rest[j + 1];
    Stream s;
    s.ctr = make_uint4(lane, step, (uint32_t)c, kGibbs);
    float rem = count;
    for (int j = 0; j < I && rem > 0.f; ++j) {
      const float ratio = fminf(
          fmaxf(probs[j] / (rest[j] == 0.f ? 1.f : rest[j]), 0.f), 1.f);
      s.ctr.w = kGibbs | ((uint32_t)j << 10);
      s.call = 0;
      const float draw = binomial(p, s, rem, ratio);
      n[j] = n[j] + draw;
      if (want_rp) rp += (double)draw * (double)lr[(size_t)c * I + j];
      rem = rem - draw;
    }
  }
  for (int i = 0; i < I; ++i) n[i] = g.sum(n[i]);
  return want_rp ? (float)g.sum(rp) : 0.f;
}

__global__ void __launch_bounds__(kMaxThreads)
    multinomial_kernel(const Params p) {
  const int I = p.I;
  // a lane past the batch's end runs the last lane's chain along with
  // its warp (see Group) and writes nothing
  const long long lanes = (long long)p.E * p.K;
  const long long lane_ll = (long long)blockIdx.x * p.lanes_per_block +
                            ((int)threadIdx.x >> p.log_t);
  const int lane_i = (int)(lane_ll < lanes ? lane_ll : lanes - 1);
  const uint32_t lane = (uint32_t)lane_i;
  const int e = lane_i / p.K;
  const int k = lane_i - e * p.K;
  Group g;
  g.T = p.T;
  g.t = (int)threadIdx.x & (p.T - 1);
  const bool leader = g.t == 0 && lane_ll < lanes;

  // the thread's per-isoform arrays: its slice of scratch
  float* base = p.scratch +
                ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * kArrays * I;
  float* am = base;
  float* last = base + I;
  float* eiw = base + 2 * I;
  float* aliw = base + 3 * I;
  float* h1 = base + 4 * I;
  float* alpha = base + 5 * I;
  float* psi = base + 6 * I;
  float* n = base + 7 * I;
  float* d = base + 8 * I;
  float* an = base + 9 * I;
  float* pn = base + 10 * I;
  float* probs = base + 11 * I;
  float* rest = base + 12 * I;

  // per-event constants (efflen, log efflen, hyper - 1 on real isoforms)
  float km1 = 0.f, H1 = 0.f;
  for (int i = 0; i < I; ++i) {
    const size_t o = (size_t)e * I + i;
    const float liw = fmaxf(p.log_iso_w[o], kNegBig);
    const float im = p.iso_mask[o];
    am[i] = p.amask[o];
    last[i] = p.last_onehot[o];
    eiw[i] = expf(liw) * im;
    aliw[i] = im > 0.f ? liw : 0.f;
    h1[i] = im > 0.f ? p.hyper[o] - 1.0f : 0.f;
    H1 = H1 + h1[i];
    km1 = km1 + am[i];
  }
  const float kk = km1 + 1.0f;
  const float ns = p.scal[2 * e];
  const float dir_const = p.scal[2 * e + 1];

  // reads of classes with a compatible isoform: those the Gibbs step
  // places, whatever psi is (integers, exact in any order)
  float nv = 0.f;
  for (int c = g.t; c < p.C; c += g.T) {
    bool compat = false;
    for (int i = 0; i < I; ++i)
      compat = compat || p.weights[((size_t)e * p.C + c) * I + i] > 0.f;
    if (compat) nv = nv + p.counts[(size_t)e * p.C + c];
  }
  const float n_valid = g.sum(nv);

  // start (miso.c:348-371 AUTO, :405-409 GIVEN), then one proposal and
  // the initial Gibbs draw (miso.c:834-843)
  if (p.start != nullptr) {
    const float* sp = p.start + ((size_t)e * p.K + k) * I;
    float sl = 0.f;
    for (int i = 0; i < I; ++i) sl = sl + sp[i] * last[i];
    const float lsl = logf(fmaxf(sl, 1e-30f));
    for (int i = 0; i < I; ++i)
      alpha[i] = am[i] > 0.f ? logf(fmaxf(sp[i], 1e-30f)) - lsl : 0.f;
  } else {
    const float a0 = km1 == 1.0f ? 0.f : 1.0f / fmaxf(km1, 1.0f);
    for (int i = 0; i < I; ++i) alpha[i] = am[i] > 0.f ? a0 : 0.f;
  }
  normal_rows(p, I, lane, 0u, d);
  for (int i = 0; i < I; ++i) alpha[i] = alpha[i] + ns * d[i] * am[i];
  float ld, logS;
  stats(I, alpha, am, last, eiw, psi, ld, logS);
  // a record follows 0-based step m when m + 1 > burn_in and
  // (m + 1 - burn_in) % lag == 0 (miso_tpu/sampler/mcmc.py schedule);
  // the Gibbs draw before it also sums the read score
  int next_rec = p.burn_in + p.lag - 1;
  float rp = gibbs(p, g, I, e, lane, 0u, psi, next_rec == 0 && p.iters > 0,
                   n, probs, rest);

  int accepted = 0, rec = 0;
  for (int m = 0; m < p.iters; ++m) {
    const uint32_t step = (uint32_t)m + 1u;
    normal_rows(p, I, lane, step, d);
    float u = kFixedU;
    if (!p.fixed_u)
      u = u01(philox4x32_10(make_uint4(lane, step, 0u, kAccept), p).x);
    const float log_u = logf(fmaxf(u, kTwoM24));
    for (int i = 0; i < I; ++i) {
      d[i] = ns * d[i] * am[i];
      an[i] = alpha[i] + d[i];
    }
    float ldn, logSn;
    stats(I, an, am, last, eiw, pn, ldn, logSn);
    // MH log-ratio in alpha space: the proposal quadratic and the read
    // score cancel; iteration 0 drops the proposal correction
    float s1 = 0.f, sd = 0.f;
    for (int i = 0; i < I; ++i) {
      s1 = s1 + (n[i] + h1[i]) * d[i];
      sd = sd + d[i];
    }
    const float full = m > 0 ? 1.f : 0.f;
    const float logr = s1 - n_valid * (logSn - logS) - H1 * (ldn - ld) +
                       full * (sd + kk * (ld - ldn));
    if (logr >= 0.f || log_u < logr) {
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
        for (int i = 0; i < I; ++i)
          t = t + ((n[i] + h1[i]) * (alpha[i] * am[i]) + n[i] * aliw[i]);
        const float score = rp + t - n_valid * logS - H1 * ld + dir_const;
        if (leader) {
          const size_t o = ((size_t)e * p.rrec + rec) * p.K + k;
          for (int i = 0; i < I; ++i) p.psi_out[o * I + i] = psi[i];
          p.loglik_out[o] = score;
        }
        ++rec;
      }
    }
    rp = gibbs(p, g, I, e, lane, step, psi,
               m + 1 == next_rec && m + 1 < p.iters, n, probs, rest);
  }
  if (leader) {
    p.acc_out[lane_i] = accepted;
    for (int i = 0; i < I; ++i) {
      p.final_n[(size_t)lane_i * I + i] = n[i];
      p.final_psi[(size_t)lane_i * I + i] = psi[i];
    }
  }
}

// The plan's own consistency: what the kernel's indexing relies on.
bool plan_ok(int T, int lanes_per_block) {
  if (T < 1 || T > 32 || (T & (T - 1)) != 0) return false;
  const int threads = lanes_per_block * T;
  return lanes_per_block >= 1 && threads % 32 == 0 && threads <= kMaxThreads;
}

}  // namespace

extern "C" int miso_multinomial(
    const float* weights, const float* log_read, const float* counts,
    const float* log_iso_w, const float* hyper, const float* amask,
    const float* iso_mask, const float* last_onehot, const float* scal,
    const float* start, float* psi_out, float* loglik_out, int* acc_out,
    float* final_n, float* final_psi, float* scratch, int E, int C, int I,
    int K, int iters, int burn_in, int lag, int rrec, unsigned int seed_lo,
    unsigned int seed_hi, int fixed_u, int T, int lanes_per_block,
    void* stream) {
  const long long lanes = (long long)E * K;
  if (lanes == 0) return 0;
  if (lanes > 0x7fffffffLL || C < 1 || I < 2 || lag < 1 || iters < 0 ||
      burn_in < 0 || rrec < 0 || !plan_ok(T, lanes_per_block) ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p{weights, log_read, counts,
           log_iso_w, hyper, amask, iso_mask, last_onehot, scal, start,
           psi_out, loglik_out, acc_out, final_n, final_psi, scratch,
           E, C, I, K, iters, burn_in, lag, rrec};
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
  multinomial_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
