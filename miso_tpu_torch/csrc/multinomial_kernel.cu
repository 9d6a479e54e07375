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
// chains = 96 lanes on 132 SMs), so a launch is one step's latency times
// 5,001 dependent steps.  Bytes are nothing (a bucket's class tables are
// KB).  multinomial_bound and multinomial_floor in deep.py give the bound
// and the floor; the -DMISO_B3_CLOCKS build below measures a step.
//
// Design, from the launch plan (multinomial_plan in deep.py):
//
// - A block is one warp.  A lane is a group of T threads, T in {1, 2, 4,
//   8, 16, 32}; while the launch is small (a deep bucket's 96 or 384
//   lanes) T is 32, a warp of its own per lane, so no two lanes' BTRS
//   rejection loops share a warp and the launch spreads over the SMs.
// - The lane's threads form G class slots of S = T / G threads (G the
//   power of two at or above C, at most T).  Slot g draws the classes g,
//   g + G, ...; its S threads try the calls base, ..., base + S - 1 of a
//   BTRS draw at once and the draw takes the first that accepts, by
//   ballot: the same call, and so the same count, as one thread trying
//   them in turn.  The slow log-bound test runs only for tries before the
//   first squeeze hit.  Counts go into the lane's n by a butterfly over
//   the slots (integers below 2^24: exact in any order); the read score is
//   summed in double over the lane by an xor butterfly (f32 x f32
//   products are exact there) and rounded to f32 once.
// - The lane's per-isoform arrays lie in dynamic shared memory, once per
//   lane (kLaneArrays of I floats, one ratio array per class slot, the
//   randoms drawn ahead), sized by I at launch; a width whose arrays
//   exceed shared memory takes them from a scratch buffer instead (the
//   plan's shared_bytes is then 0).  Every thread of the lane repeats the
//   I-wide MH arithmetic, writing the same values; __syncwarp() separates
//   a phase's writes from the reads of another.
// - Randoms ahead of the chain: every D steps (D = T, fewer for wide I)
//   the lane's threads draw the proposal normals and log u_accept of the
//   next D steps between them into shared memory.  Philox4x32-10 as in
//   the other kernels, counters (lane, step, pair, kNormals), (lane, step,
//   0, kAccept) and for the Gibbs step (lane, step, class, kGibbs |
//   isoform << 10 | call), so one seed gives one chain in every plan.
// - Carried across steps: a class slot's ratios where psi did not move
//   (an MH reject, every class in one round of slots), and BTRS's set-up
//   where (n, q) did not change.
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
constexpr unsigned kFull = 0xffffffffu;

// Philox counter word 3: which draw of a step the bits feed.
constexpr uint32_t kNormals = 1, kAccept = 2, kGibbs = 0x80000000u;

// A block is one warp (MAX_THREADS in deep.py).
constexpr int kMaxThreads = 32;
// Per-isoform arrays of a lane (LANE_ARRAYS in deep.py); beside them one
// ratio array per class slot and the randoms of kAheadFloats floats at
// most (AHEAD_FLOATS): a lane takes lane_floats(C, I, T) floats.
constexpr int kLaneArrays = 11;
constexpr int kAheadFloats = 4096;
// The dynamic shared memory a block may take (MAX_SHARED).
constexpr int kMaxShared = 232448;
// Inversion below this mean n * min(p, 1 - p), BTRS from it on.
constexpr double kBtrsMean = 10.0;

// The step breakdown (a build with -DMISO_B3_CLOCKS, which only
// chip_smoke.py asks for; the production build has none of it): clock64()
// stamps between the phases of a step, summed over each lane's first
// thread, and counts of the binomial draws, each counted once, into one
// device array that miso_multinomial_clocks reads and clears.
enum ClockSlot {
  kClkRandoms,    // the proposal's normals and log u_accept
  kClkMH,         // proposal, stats, MH ratio, accept, record
  kClkProbs,      // a class's probabilities and ratios
  kClkSetup,      // a draw up to its first try: BTRS's set-up
  kClkTry,        // BTRS's tries: Philox, the proposal, the squeeze
  kClkVote,       // the slot's ballots and the chosen count's shuffle
  kClkSlow,       // the slow log-bound tests
  kClkDraws,      // the rest of the draws: loop ends, counts into n
  kClkButterfly,  // the sums over the lane
  kCntSteps,      // steps stamped (lanes x iterations)
  kCntDraws,      // random binomial draws (0 < ratio < 1, n > 0)
  kCntInversion,  // of them by inversion
  kCntTries,      // BTRS tries up to the accepted one, as one thread
                  // would try them in turn
  kCntSqueeze,    // BTRS draws accepted by the squeeze
  kCntSlow,       // slow log-bound tests run
  kCntRounds,     // rounds of S tries at once
  kClockSlots
};
#ifdef MISO_B3_CLOCKS
__device__ unsigned long long b3_clocks[kClockSlots];
struct Clocks {
  long long t;
  unsigned long long v[kClockSlots];
  __device__ void add(int slot) {
    const long long now = clock64();
    v[slot] += (unsigned long long)(now - t);
    t = now;
  }
};
#define CLK_PARAM , Clocks& clk
#define CLK_ARG , clk
#define CLK_MARK() (clk.t = clock64())
#define CLK_ADD(slot) clk.add(slot)
#define CLK_COUNT(slot, k) (clk.v[slot] += (k))
#else
#define CLK_PARAM
#define CLK_ARG
#define CLK_MARK() ((void)0)
#define CLK_ADD(slot) ((void)0)
#define CLK_COUNT(slot, k) ((void)0)
#endif

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
  float* scratch;            // lane arrays, or null: in shared memory
  int E, C, I, K, iters, burn_in, lag, rrec;
  // Philox round keys of the seed (k + r * Weyl constant), worked out by
  // the launcher
  uint32_t key0[10], key1[10];
  int fixed_u;
  int T, log_t, lanes_per_block;
  int G, log_s;      // class slots of a lane, log2 of their threads
  int ahead;         // steps whose randoms are drawn at once
  int lane_floats;   // a lane's arrays
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
  // (hi >> 5) * 2^26 + (lo >> 6) + 1/2, each step exact in double
  return ((double)(((uint64_t)(hi >> 5) << 26) | (lo >> 6)) + 0.5) *
         kTwoM53;
}

// A thread's place in its lane and class slot.  Every shuffle and vote
// names the whole warp, so all its threads take each together (loops
// that hold one run to the warp's longest), and a lane past the batch's
// end runs along and writes nothing.  xor offsets below T keep the data
// inside the lane.
struct Group {
  int T;         // threads in the lane
  int t;         // this thread's place in it
  int S;         // threads of a class slot
  int slot, s;   // the slot and the place in it
  int lo;        // the warp bit of the slot's first thread
  unsigned bits; // S ones

  // xor butterfly: every thread ends with the bitwise-same sum
  template <class V>
  __device__ __forceinline__ V sum(V v) const {
    for (int o = T >> 1; o > 0; o >>= 1)
      v += __shfl_xor_sync(kFull, v, o);
    return v;
  }
  // the sum over the lane's class slots of a value the slot's threads
  // share: the butterfly over offsets S ... T / 2
  __device__ __forceinline__ float slot_sum(float v) const {
    for (int o = T >> 1; o >= S; o >>= 1)
      v += __shfl_xor_sync(kFull, v, o);
    return v;
  }
  // the slot's threads that vote yes, as bits 0..S-1
  __device__ __forceinline__ unsigned vote(bool yes) const {
    return (__ballot_sync(kFull, yes) >> lo) & bits;
  }
};

// The uniforms of one binomial draw: pairs keyed by (lane, step, class,
// isoform, call), two doubles a Philox call.
struct Stream {
  uint4 ctr;
  __device__ __forceinline__ double2 at(const Params& p,
                                        uint32_t call) const {
    uint4 c = ctr;
    c.w |= call & 1023u;
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
// success probability q that fit in n trials, calls 0, 1, ... in turn.
__device__ __forceinline__ double inversion(const Params& p, const Stream& s, double n,
                            double q) {
  const double logq = log1p(-q);
  double sum = 0.0, x = 0.0;
  for (uint32_t call = 0;; ++call) {
    const double2 u = s.at(p, call);
    sum += ceil(log(u.x) / logq);
    if (sum > n) return x;
    x += 1.0;
    sum += ceil(log(u.y) / logq);
    if (sum > n) return x;
    x += 1.0;
  }
}

// BTRS's constants of Bin(n, q), q <= 1/2 and n q >= 10 (Hormann 1993,
// as torch's btrs), kept by a thread while (n, q) stays.  Those of the
// squeeze come with (n, q); those of the slow test (r, alpha, m and
// `tail`, the part of its bound that does not depend on the try) at the
// first slow test.
struct Btrs {
  double n = -1.0, q = -1.0;
  double stddev, b, a, two_a, c, v_r;
  bool slow_ready;
  double r, alpha, m, tail;

  __device__ __forceinline__ void setup(double n_, double q_) {
    if (n_ == n && q_ == q) return;
    n = n_;
    q = q_;
    stddev = sqrt(n * q * (1.0 - q));
    b = 1.15 + 2.53 * stddev;
    a = -0.0873 + 0.0248 * b + 0.01 * q;
    two_a = 2.0 * a;
    c = n * q + 0.5;
    v_r = 0.92 - 4.2 / b;
    slow_ready = false;
  }

  // the slow log-bound test of try (V, us) at k
  __device__ __forceinline__ bool accepts(double V, double us, double k) {
    if (!slow_ready) {
      r = q / (1.0 - q);
      alpha = (2.83 + 5.1 / b) * stddev;
      m = floor((n + 1.0) * q);
      tail = (m + 0.5) * log((m + 1.0) / (r * (n - m + 1.0))) +
             stirling_tail(m) + stirling_tail(n - m);
      slow_ready = true;
    }
    const double lv = log(V * alpha / (a / (us * us) + b));
    const double upper =
        tail + (n + 1.0) * log((n - m + 1.0) / (n - k + 1.0)) +
        (k + 0.5) * log(r * (n - k + 1.0) / (k + 1.0)) -
        stirling_tail(k) - stirling_tail(n - k);
    return lv <= upper;
  }
};

// One draw of the chained binomials, by the whole warp at once (each
// slot its own): Bin(n, ratio), or under fixed_u floor(n * ratio + u)
// clipped to [0, n].  The slot's S threads hold the same n and ratio and
// end with the same count.
__device__ __forceinline__ float binomial(const Params& p, const Group& g,
                                          const Stream& s, float n,
                                          float ratio, Btrs& bt CLK_PARAM) {
  if (p.fixed_u)
    return fminf(fmaxf(floorf(n * ratio + kFixedU), 0.f), n);
  const bool random = n > 0.f && ratio > 0.f && ratio < 1.f;
  const double dn = (double)n;
  const bool flip = ratio > 0.5f;
  const double q = flip ? 1.0 - (double)ratio : (double)ratio;
  double k = 0.0;
  bool pending = false;
  if (random) {
    if (g.s == 0) CLK_COUNT(kCntDraws, 1);
    if (dn * q < kBtrsMean) {
      if (g.s == 0) CLK_COUNT(kCntInversion, 1);
      k = inversion(p, s, dn, q);
    } else {
      bt.setup(dn, q);
      pending = true;
    }
  }
  CLK_ADD(kClkSetup);
  // BTRS: the slot's threads try S calls at once; the first call that
  // accepts is the draw.  A try out of [0, n] rejects; one that misses
  // the squeeze needs the slow test, but only before the first squeeze
  // hit, since a later try cannot be the first to accept.
  for (uint32_t base = 0; __any_sync(kFull, pending); base += g.S) {
    bool squeeze = false, slow = false;
    double kt = 0.0, V = 0.0, us = 0.0;
    if (pending) {
      const double2 uv = s.at(p, base + (uint32_t)g.s);
      const double U = uv.x - 0.5;
      V = uv.y;
      us = 0.5 - fabs(U);
      kt = floor((bt.two_a / us + bt.b) * U + bt.c);
      const bool in = !(kt < 0.0 || kt > dn);
      squeeze = in && us >= 0.07 && V <= bt.v_r;
      slow = in && !squeeze;
    }
    CLK_ADD(kClkTry);
    const unsigned hits = g.vote(squeeze);
    const int first_hit = hits ? __ffs(hits) - 1 : g.S;
    CLK_ADD(kClkVote);
    bool ok = false;
    if (slow && g.s < first_hit) {
      CLK_COUNT(kCntSlow, 1);
      ok = bt.accepts(V, us, kt);
    }
    CLK_ADD(kClkSlow);
    const unsigned yes = hits | g.vote(ok);
    const int first = yes ? __ffs(yes) - 1 : 0;
    const double chosen = __shfl_sync(kFull, kt, g.lo + first);
    CLK_ADD(kClkVote);
    if (pending && g.s == 0) {
      CLK_COUNT(kCntRounds, 1);
      if (yes) {
        CLK_COUNT(kCntTries, base + first + 1);
        if (first == first_hit) CLK_COUNT(kCntSqueeze, 1);
      }
    }
    if (pending && yes) {
      k = chosen;
      pending = false;
    }
  }
  CLK_ADD(kClkDraws);
  if (!random) return n > 0.f && ratio >= 1.f ? n : 0.f;
  return (float)(flip ? dn - k : k);
}

// The proposal normals and log u_accept of steps first ... first + D - 1,
// spread over the lane's threads: (I,) standard normals a step sharing
// one Box-Muller radius per cos/sin pair, rows [0, H) r*cos and rows
// [H, I) r*sin (pallas_kernel._normal_rows), as reassign_kernel.cu draws
// them.
__device__ __forceinline__ void draw_ahead(const Params& p, const Group& g,
                                           uint32_t lane, uint32_t first,
                                           float* z, float* log_u) {
  const int I = p.I;
  const int H = (I + 1) / 2;
  const int per = H + 1;
  for (int it = g.t; it < p.ahead * per; it += g.T) {
    const int row = it / per, h = it - row * per;
    const uint32_t step = first + (uint32_t)row;
    if (h < H) {
      float u1 = kFixedU, u2 = kFixedU;
      if (!p.fixed_u) {
        const uint4 b =
            philox4x32_10(make_uint4(lane, step, (uint32_t)h, kNormals), p);
        u1 = u01(b.x);
        u2 = u01(b.y);
      }
      const float r = sqrtf(-2.0f * logf(fmaxf(u1, kTwoM24)));
      const float ang = kTwoPi * u2;
      z[row * I + h] = r * cosf(ang);
      if (h + H < I) z[row * I + h + H] = r * sinf(ang);
    } else {
      float u = kFixedU;
      if (!p.fixed_u)
        u = u01(philox4x32_10(make_uint4(lane, step, 0u, kAccept), p).x);
      log_u[row] = logf(fmaxf(u, kTwoM24));
    }
  }
}

// alpha -> (psi, log denom, log S) with e = exp(alpha) on the head
// isoforms, denom = 1 + sum(e), psi = (e + last) / denom and
// S = sum((e + last) * efflen) (reassign_kernel._stats).
// stats from e and its sum s (the proposal's, worked out with the MH
// sums)
__device__ __forceinline__ void stats_of_e(int I, float s,
                                           const float* __restrict__ e,
                                           const float* __restrict__ last,
                                           const float* __restrict__ eiw,
                                           float* __restrict__ psi,
                                           float& ld, float& logS) {
  const float denom = 1.0f + s;
  ld = logf(fmaxf(denom, kTiny));
  float S = 0.f;
  for (int i = 0; i < I; ++i) {
    const float ea = e[i] + last[i];
    psi[i] = ea / denom;
    S = S + ea * eiw[i];
  }
  logS = logf(fmaxf(S, kTiny));
}

__device__ __forceinline__ void stats(int I, const float* alpha,
                                      const float* am, const float* last,
                                      const float* eiw, float* e,
                                      float* psi, float& ld, float& logS) {
  float s = 0.f;
  for (int i = 0; i < I; ++i) {
    e[i] = expf(alpha[i]) * am[i];
    s = s + e[i];
  }
  stats_of_e(I, s, e, last, eiw, psi, ld, logS);
}

// The lane's arrays (see the header).
struct Lane {
  float *am, *last, *eiw, *aliw, *h1, *alpha, *psi, *n, *an, *pn, *e;
  float* ratio;         // this thread's class slot's
  float *z, *log_u;     // the randoms drawn ahead
};

// The Gibbs step of the lane: n gets every isoform's reads, the return
// value the read score (want_rp: a record will read it; 0 otherwise).
// `fresh`: psi moved since the last step, so the slots' ratios (and
// `live`, whether the thread's class draws at all) are worked out anew;
// they are kept where every class has a slot of its own.
__device__ __forceinline__ float gibbs(const Params& p, const Group& g,
                                       const Lane& L, int e, uint32_t lane,
                                       uint32_t step, bool want_rp,
                                       bool fresh, bool& live,
                                       Btrs& bt CLK_PARAM) {
  const int I = p.I;
  const float* w = p.weights + (size_t)e * p.C * I;
  const float* lr = p.log_read + (size_t)e * p.C * I;
  const float* cnt = p.counts + (size_t)e * p.C;
  __syncwarp();
  for (int i = g.t; i < I; i += g.T) L.n[i] = 0.f;
  __syncwarp();
  const bool keep = !fresh && p.C <= p.G;
  double rp = 0.0;
  for (int c0 = 0; c0 < p.C; c0 += p.G) {
    CLK_MARK();
    const int c = c0 + g.slot;
    const float count = c < p.C ? cnt[c] : 0.f;
    if (!keep) {
      const float* wc = w + (size_t)(c < p.C ? c : 0) * I;
      float tot = 0.f;
      for (int j = 0; j < I; ++j) tot = tot + L.psi[j] * wc[j];
      // a class of no reads or no mass draws nothing
      live = c < p.C && count > 0.f && tot > 0.f;
      if (live) {
        // probs_j = p_j / tot, rest_j = probs_j + rest_{j+1} from the
        // last isoform down, ratio_j = probs_j / rest_j clipped
        float rest = 0.f;
        for (int j = I - 1; j >= 0; --j) {
          const float pj = (L.psi[j] * wc[j]) / tot;
          rest = j == I - 1 ? pj : pj + rest;
          L.ratio[j] = fminf(fmaxf(pj / (rest == 0.f ? 1.f : rest), 0.f),
                             1.f);
        }
      }
    }
    CLK_ADD(kClkProbs);
    Stream s;
    s.ctr = make_uint4(lane, step, (uint32_t)c, kGibbs);
    float rem = live ? count : 0.f;
    for (int j = 0; j < I && __any_sync(kFull, rem > 0.f); ++j) {
      s.ctr.w = kGibbs | ((uint32_t)j << 10);
      const float draw =
          binomial(p, g, s, rem, rem > 0.f ? L.ratio[j] : 0.f, bt CLK_ARG);
      // the slots' counts of isoform j (integers: exact in any order)
      const float placed = g.slot_sum(draw);
      if (g.t == 0) L.n[j] = L.n[j] + placed;
      if (want_rp && g.s == 0 && draw > 0.f)
        rp += (double)draw * (double)lr[(size_t)c * I + j];
      rem = rem - draw;
      CLK_ADD(kClkDraws);
    }
    __syncwarp();
    CLK_ADD(kClkDraws);
  }
  CLK_MARK();
  const float rp_lane = want_rp ? (float)g.sum(rp) : 0.f;
  __syncwarp();
  CLK_ADD(kClkButterfly);
  return rp_lane;
}

__global__ void __launch_bounds__(kMaxThreads)
    multinomial_kernel(const Params p) {
  extern __shared__ float4 lane_shared[];
  const int I = p.I;
  // a lane past the batch's end runs the last lane's chain along with
  // its warp (see Group) and writes nothing
  const long long lanes = (long long)p.E * p.K;
  const int in_block = (int)threadIdx.x >> p.log_t;
  const long long lane_ll =
      (long long)blockIdx.x * p.lanes_per_block + in_block;
  const int lane_i = (int)(lane_ll < lanes ? lane_ll : lanes - 1);
  const uint32_t lane = (uint32_t)lane_i;
  const int e = lane_i / p.K;
  const int k = lane_i - e * p.K;
  const bool real = lane_ll < lanes;
  Group g;
  g.T = p.T;
  g.t = (int)threadIdx.x & (p.T - 1);
  g.S = 1 << p.log_s;
  g.slot = g.t >> p.log_s;
  g.s = g.t & (g.S - 1);
  g.lo = ((int)threadIdx.x & 31 & ~(p.T - 1)) + g.slot * g.S;
  g.bits = g.S == 32 ? kFull : (1u << g.S) - 1u;
  const bool leader = g.t == 0 && real;

  // the lane's arrays: its share of the block's shared memory, or of
  // scratch
  float* base =
      p.scratch != nullptr
          ? p.scratch + ((size_t)blockIdx.x * p.lanes_per_block + in_block) *
                            p.lane_floats
          : reinterpret_cast<float*>(lane_shared) +
                (size_t)in_block * p.lane_floats;
  Lane L;
  L.am = base;
  L.last = base + 1 * I;
  L.eiw = base + 2 * I;
  L.aliw = base + 3 * I;
  L.h1 = base + 4 * I;
  L.alpha = base + 5 * I;
  L.psi = base + 6 * I;
  L.n = base + 7 * I;
  L.an = base + 8 * I;
  L.pn = base + 9 * I;
  L.e = base + 10 * I;
  L.ratio = base + (kLaneArrays + g.slot) * I;
  L.z = base + (kLaneArrays + p.G) * I;
  L.log_u = L.z + p.ahead * I;

  // per-event constants (efflen, log efflen, hyper - 1 on real isoforms)
  float km1 = 0.f, H1 = 0.f;
  for (int i = 0; i < I; ++i) {
    const size_t o = (size_t)e * I + i;
    const float liw = fmaxf(p.log_iso_w[o], kNegBig);
    const float im = p.iso_mask[o];
    const float am = p.amask[o];
    const float h1 = im > 0.f ? p.hyper[o] - 1.0f : 0.f;
    L.am[i] = am;
    L.last[i] = p.last_onehot[o];
    L.eiw[i] = expf(liw) * im;
    L.aliw[i] = im > 0.f ? liw : 0.f;
    L.h1[i] = h1;
    H1 = H1 + h1;
    km1 = km1 + am;
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
  draw_ahead(p, g, lane, 0u, L.z, L.log_u);
  __syncwarp();
  if (p.start != nullptr) {
    const float* sp = p.start + ((size_t)e * p.K + k) * I;
    float sl = 0.f;
    for (int i = 0; i < I; ++i) sl = sl + sp[i] * p.last_onehot[
        (size_t)e * I + i];
    const float lsl = logf(fmaxf(sl, 1e-30f));
    for (int i = 0; i < I; ++i) {
      const float am = p.amask[(size_t)e * I + i];
      const float a0 = am > 0.f ? logf(fmaxf(sp[i], 1e-30f)) - lsl : 0.f;
      L.alpha[i] = a0 + ns * L.z[i] * am;
    }
  } else {
    const float a0 = km1 == 1.0f ? 0.f : 1.0f / fmaxf(km1, 1.0f);
    for (int i = 0; i < I; ++i) {
      const float am = p.amask[(size_t)e * I + i];
      L.alpha[i] = (am > 0.f ? a0 : 0.f) + ns * L.z[i] * am;
    }
  }
  __syncwarp();
  float ld, logS;
  stats(I, L.alpha, L.am, L.last, L.eiw, L.e, L.psi, ld, logS);
  // a record follows 0-based step m when m + 1 > burn_in and
  // (m + 1 - burn_in) % lag == 0 (miso_tpu/sampler/mcmc.py schedule);
  // the Gibbs draw before it also sums the read score
  int next_rec = p.burn_in + p.lag - 1;
  Btrs bt;
#ifdef MISO_B3_CLOCKS
  Clocks clk = {};
#endif
  bool live = false;
  float rp = gibbs(p, g, L, e, lane, 0u, next_rec == 0 && p.iters > 0,
                   true, live, bt CLK_ARG);
#ifdef MISO_B3_CLOCKS
  clk = Clocks{};  // the iterations alone
#endif

  int accepted = 0, rec = 0;
  for (int m = 0; m < p.iters; ++m) {
    const uint32_t step = (uint32_t)m + 1u;
    CLK_MARK();
    const int row = (int)(step % (uint32_t)p.ahead);
    if (row == 0) {
      draw_ahead(p, g, lane, step, L.z, L.log_u);
      __syncwarp();
    }
    const float* z = L.z + row * I;
    const float log_u = L.log_u[row];
    CLK_ADD(kClkRandoms);
    // the proposal an = alpha + d, its e = exp(an) on the head isoforms
    // and their sum (stats' first loop), and the sums of the MH ratio,
    // in one pass over the isoforms: each sum in ascending order
    float se = 0.f, s1 = 0.f, sd = 0.f;
    {
      // disjoint arrays of the lane: loads may pass the stores
      const float* __restrict__ am_ = L.am;
      const float* __restrict__ z_ = z;
      const float* __restrict__ alpha_ = L.alpha;
      const float* __restrict__ n_ = L.n;
      const float* __restrict__ h1_ = L.h1;
      float* __restrict__ an_ = L.an;
      float* __restrict__ e_ = L.e;
      for (int i = 0; i < I; ++i) {
        const float am = am_[i];
        const float d = ns * z_[i] * am;
        const float an = alpha_[i] + d;
        const float ei = expf(an) * am;
        an_[i] = an;
        e_[i] = ei;
        se = se + ei;
        s1 = s1 + (n_[i] + h1_[i]) * d;
        sd = sd + d;
      }
    }
    float ldn, logSn;
    stats_of_e(I, se, L.e, L.last, L.eiw, L.pn, ldn, logSn);
    // MH log-ratio in alpha space: the proposal quadratic and the read
    // score cancel; iteration 0 drops the proposal correction
    const float full = m > 0 ? 1.f : 0.f;
    const float logr = s1 - n_valid * (logSn - logS) - H1 * (ldn - ld) +
                       full * (sd + kk * (ld - ldn));
    const bool accept = logr >= 0.f || log_u < logr;
    __syncwarp();
    if (accept) {
      for (int i = 0; i < I; ++i) {
        L.alpha[i] = L.an[i];
        L.psi[i] = L.pn[i];
      }
      ld = ldn;
      logS = logSn;
      ++accepted;
    }
    __syncwarp();
    if (m == next_rec) {
      next_rec += p.lag;
      if (rec < p.rrec) {
        // joint score (miso.c:243-307) with the n and read score from
        // before this step's Gibbs draw
        float t = 0.f;
        for (int i = 0; i < I; ++i)
          t = t + ((L.n[i] + L.h1[i]) * (L.alpha[i] * L.am[i]) +
                   L.n[i] * L.aliw[i]);
        const float score = rp + t - n_valid * logS - H1 * ld + dir_const;
        const size_t o = ((size_t)e * p.rrec + rec) * p.K + k;
        if (real)
          for (int i = g.t; i < I; i += g.T) p.psi_out[o * I + i] = L.psi[i];
        if (leader) p.loglik_out[o] = score;
        ++rec;
      }
    }
    CLK_ADD(kClkMH);
    rp = gibbs(p, g, L, e, lane, step, m + 1 == next_rec && m + 1 < p.iters,
               accept, live, bt CLK_ARG);
    if (g.t == 0) CLK_COUNT(kCntSteps, 1);
  }
  if (real) {
    if (g.t == 0) p.acc_out[lane_i] = accepted;
    for (int i = g.t; i < I; i += g.T) {
      p.final_n[(size_t)lane_i * I + i] = L.n[i];
      p.final_psi[(size_t)lane_i * I + i] = L.psi[i];
    }
  }
#ifdef MISO_B3_CLOCKS
  // phases from each lane's first thread, draw counts from every thread
  // (each draw counted by its slot's first)
  if (real)
    for (int i = 0; i < kClockSlots; ++i)
      if (i > kCntSteps || g.t == 0) atomicAdd(&b3_clocks[i], clk.v[i]);
#endif
}

// The plan's own consistency: what the kernel's indexing relies on.
bool plan_ok(int T, int lanes_per_block) {
  if (T < 1 || T > 32 || (T & (T - 1)) != 0) return false;
  return lanes_per_block >= 1 && lanes_per_block * T == kMaxThreads;
}

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

}  // namespace

// A lane's floats (lane_floats in deep.py): the kLaneArrays arrays, one
// ratio array per class slot and the randoms of `ahead` steps.
extern "C" long long miso_multinomial_lane_floats(int C, int I, int T) {
  int G = 1;
  while (G < C && G < T) G <<= 1;
  int ahead = kAheadFloats / (I + 1);
  ahead = ahead < 1 ? 1 : (ahead > T ? T : ahead);
  return (long long)(kLaneArrays + G) * I + (long long)ahead * (I + 1);
}

extern "C" int miso_multinomial(
    const float* weights, const float* log_read, const float* counts,
    const float* log_iso_w, const float* hyper, const float* amask,
    const float* iso_mask, const float* last_onehot, const float* scal,
    const float* start, float* psi_out, float* loglik_out, int* acc_out,
    float* final_n, float* final_psi, float* scratch, int E, int C, int I,
    int K, int iters, int burn_in, int lag, int rrec, unsigned int seed_lo,
    unsigned int seed_hi, int fixed_u, int T, int lanes_per_block,
    long long shared_bytes, void* stream) {
  const long long lanes = (long long)E * K;
  if (lanes == 0) return 0;
  if (lanes > 0x7fffffffLL || C < 1 || I < 2 || lag < 1 || iters < 0 ||
      burn_in < 0 || rrec < 0 || !plan_ok(T, lanes_per_block))
    return (int)cudaErrorInvalidValue;
  const long long lane_floats = miso_multinomial_lane_floats(C, I, T);
  // the lane arrays lie in shared memory, or in scratch when the plan
  // gives the block none
  const long long need = lane_floats * lanes_per_block * 4;
  if (lane_floats > 0x7fffffffLL ||
      (scratch == nullptr && (shared_bytes < need || need > kMaxShared)))
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
  p.log_t = log2_of(T);
  p.lanes_per_block = lanes_per_block;
  p.G = 1;
  while (p.G < C && p.G < T) p.G <<= 1;
  p.log_s = log2_of(T / p.G);
  p.ahead = kAheadFloats / (I + 1);
  p.ahead = p.ahead < 1 ? 1 : (p.ahead > T ? T : p.ahead);
  p.lane_floats = (int)lane_floats;
  const int bytes = scratch == nullptr ? (int)need : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        multinomial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  const unsigned blocks =
      (unsigned)((lanes + lanes_per_block - 1) / lanes_per_block);
  multinomial_kernel<<<blocks, kMaxThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

#ifdef MISO_B3_CLOCKS
// The step breakdown's sums since the last read (kClockSlots values),
// then cleared.
extern "C" int miso_multinomial_clocks(unsigned long long* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, b3_clocks, sizeof(b3_clocks));
  if (rc != cudaSuccess) return (int)rc;
  static const unsigned long long zeros[kClockSlots] = {};
  return (int)cudaMemcpyToSymbol(b3_clocks, zeros, sizeof(zeros));
}

#ifdef __CUDACC__
// Dependent latencies of the step's pieces, in clocks per operation,
// from one warp: each chain feeds every result into the next operation.
enum LatencySlot {
  kLatPhilox, kLatLog64, kLatDiv64, kLatSqrt64, kLatFma64, kLatLogf,
  kLatExpf, kLatDivf, kLatShfl, kLatShared, kLatGlobalL1, kLatSlots
};

__global__ void multinomial_latency_kernel(double* out, int reps,
                                           const float* l1, Params p) {
  __shared__ float sm[32];
  sm[threadIdx.x] = (float)((threadIdx.x * 7 + 1) & 31);
  __syncwarp();
  long long t;
  double x = 1.5 + threadIdx.x * 1e-3;
  float xf = 1.5f + threadIdx.x * 1e-3f;
  uint4 c = make_uint4(threadIdx.x, 1u, 2u, 3u);
  double sink = 0.0;
#define LATENCY(slot, body)                                   \
  t = clock64();                                              \
  for (int r = 0; r < reps; ++r) { body; }                    \
  if (threadIdx.x == 0)                                       \
    out[slot] = (double)(clock64() - t) / reps;
  LATENCY(kLatPhilox, c = philox4x32_10(c, p));
  sink += c.x;
  LATENCY(kLatLog64, x = log(x + 3.0));
  LATENCY(kLatDiv64, x = 1.0 / (x + 1.5));
  LATENCY(kLatSqrt64, x = sqrt(x + 1.0));
  LATENCY(kLatFma64, x = x * 0.999 + 0.5);
  sink += x;
  LATENCY(kLatLogf, xf = logf(xf + 3.0f));
  LATENCY(kLatExpf, xf = expf(-xf));
  LATENCY(kLatDivf, xf = 1.0f / (xf + 1.5f));
  LATENCY(kLatShfl, xf = __shfl_xor_sync(0xffffffffu, xf, 1) + 1.0f);
  sink += xf;
  int ix = threadIdx.x;
  LATENCY(kLatShared, ix = (int)sm[ix & 31]);
  LATENCY(kLatGlobalL1, ix = (int)l1[ix & 31]);
#undef LATENCY
  if (sink + ix == -1.0) out[kLatSlots] = sink;  // keeps every chain
}

extern "C" int miso_multinomial_latencies(double* out, int reps,
                                          const float* l1) {
  Params p = {};
  for (int r = 0; r < 10; ++r) {
    p.key0[r] = 1u + (uint32_t)r * 0x9E3779B9u;
    p.key1[r] = 2u + (uint32_t)r * 0xBB67AE85u;
  }
  multinomial_latency_kernel<<<1, 32, 0>>>(out, reps, l1, p);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
#endif  // MISO_B3_CLOCKS
