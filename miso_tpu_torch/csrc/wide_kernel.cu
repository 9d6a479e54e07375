// Wide-lane REASSIGN (B1w) and MARGINAL/CLASSES (B2w) samplers for Hopper
// (sm_90a): one (event, chain) lane a block, its isoforms over the block's
// threads, the isoform width I an argument of the launch.
//
// B1w replaces miso_tpu/sampler/pallas_kernel.py::_sampler_kernel for
// every bucket of at least WIDE_FROM isoforms and B2w
// miso_tpu/sampler/pallas_marginal.py::_marginal_kernel from
// WIDE_FROM_MARGINAL (sampler/wide.py), of any width.  They
// compute what reassign_kernel.cu and marginal_kernel.cu compute: AUTO or
// GIVEN start, the logistic-normal drift proposal, MH, burn-in/lag
// records; B1w the per-read inverse-CDF Gibbs draw with the pad
// correction and the read score on recording steps, B2w the joint score
// sum_c counts_c log(sum_i W_ci psi_i) with the Dirichlet term and the
// full proposal correction.  Their plain versions are _reassign_plain and
// _marginal_plain with the wide summing order (wide.wide_sum); under
// fixed_u (every uniform 0.4999f) both give the same chain.
//
// Design.  A narrow lane (reassign_kernel.cu) keeps a lane's I-wide state
// in every thread; from 128 isoforms on that state lay in local memory,
// 60 KB a thread at 1,024, and every thread repeated the lane's I-wide
// arithmetic.  Here:
//
// - A lane is a block of `threads` (32 ... 512, wide_plan) threads (B2w:
//   or a cluster of such blocks).  Its I-wide arrays (alpha, psi, the
//   proposal's normals, efflen terms, hyper - 1, the counts, the terms
//   summed each step; B1w's read scores and class table) lie once in
//   dynamic shared memory, or, past the block's limit (227 KB: for B1w
//   from ~5,700 isoforms), in a global scratch buffer the wrapper
//   allocates.  No width is too wide.
// - Chunks.  I is padded to P = 128 ceil(I / 128) isoforms, in chunks of
//   128: warp lane l owns isoforms 128 c + 4 l + q (q = 0 ... 3) of
//   every chunk c, so that a warp reading a chunk of a lane array, of
//   psi or of a weight row reads 512 neighbouring bytes, as 16-byte
//   pieces.  Arrays are in isoform order; elementwise work takes
//   isoforms tid, tid + threads, ...
// - Sums over isoforms (and over B2w's classes) run in one order whatever
//   the block: slot l adds its isoforms in (chunk, q) order, then a
//   butterfly over the 32 slots.  A warp makes each sum; the warps of a
//   block take the step's sums side by side.  So the chain does not
//   depend on the plan, and the plain version reproduces it
//   (wide.wide_sum).
// - B1w reads its event as classes, never as (R, I) read tiles: the
//   reads of a class share its weights, so each step builds, for every
//   class with reads, the class's cumulative row (its running maximum)
//   and total once, a warp a row, in a table in shared memory, and each
//   read then finds its isoform by a binary search in its class's row
//   (~log2 I loads of shared memory), its group's uniforms drawn by one
//   Philox call keyed by the group, as in B1.  The rows are the floats a
//   walk along each read's row computed, in the same order, so the chain
//   is the per-read walk's.  Where the whole table would not fit a block
//   beside the lane's arrays, or would leave an SM too few warps, it is
//   taken a tile of rows at a time (wide.py, table_rows), each tile
//   followed by the run of reads that falls in it.  Where a launch's
//   classes are most of its read slots (wide.walks; read tiles, a class
//   a read) a row costs more than its reads' walks: every read then
//   walks its class's row (walk_reads), as B1w did before it read
//   classes.  The counts are integers added by
//   shared atomics, so their order is free.
// - B2w keeps a lane's class weights in shared memory for the launch
//   where they fit, a lane over a thread-block cluster where one block
//   cannot hold them, and draws its randoms a step ahead (see its
//   section below).
// - Randoms: B1's and B2's Philox counters, (lane, step, pair j,
//   kNormals), (lane, step, 0, kAccept) and (lane, step, group,
//   kReads): the wide form draws the stream of the instance it replaced,
//   whichever thread, block or step draws a number.
//
// Build: -fmad=false (kernels.py), as marginal_kernel.cu: every product
// and sum rounds on its own, as in the plain versions.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFixedU = 0.4999f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kNegBig = -1e30f;
constexpr float kTiny = 1e-38f;
constexpr float kTwoM24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoM23 = 1.1920928955078125e-07f;  // 2^-23
constexpr float kNegInf = -__builtin_huge_valf();
constexpr unsigned kFull = 0xffffffffu;

// Philox counter word 3: which draw of a step the bits feed.
constexpr uint32_t kReads = 0, kNormals = 1, kAccept = 2;

// The plan's constants (wide.py: WIDE_THREADS, HEAD_FLOATS,
// REASSIGN_ARRAYS, MARGINAL_ARRAYS, ROW_SCALARS, MAX_SHARED).
constexpr int kMaxThreads = 512;
constexpr int kHeadFloats = 64;  // a lane's scalars, ahead of its arrays
constexpr int kReassignArrays = 10;
constexpr int kMarginalArrays = 9;
constexpr int kRowScalars = 2;  // a table row's total and flag
constexpr int kMaxShared = 232448;

// The head: the sums of a phase.
constexpr int kSums = 0;

// B2w's step breakdown (a build with -DMISO_B2W_CLOCKS, which only
// chip_smoke.py asks for; the production build has none of it):
// clock64() stamps between the phases of a step on each lane's first
// thread, summed over the lanes into one device array that
// miso_marginal_wide_clocks reads and clears.  A phase's clocks include
// its wait at the barrier that ends it.
enum B2wClock {
  kB2Normals,  // the proposal's normals, where they are on the chain
  kB2Exp,      // alpha' and exp
  kB2PsiSums,  // the two psi sums
  kB2DivLog,   // the division and log
  kB2Terms,    // the class terms: the first thread's rows (if any) and
               // its wait for every block's
  kB2Quad,     // the quadratics
  kB2Sums,     // the five sums
  kB2MH,       // log u_accept (where drawn on the chain), the MH
               // decision and the record
  kB2Wait,     // the first thread's waits at the step's other barriers
  kB2Rows,     // a class-row warp's rows (its first thread's clocks)
  kB2Steps,    // steps stamped (lanes x iterations)
  kB2Slots
};
#ifdef MISO_B2W_CLOCKS
__device__ unsigned long long b2w_clocks[kB2Slots];
struct B2wClocks {
  long long t;
  unsigned long long v[kB2Slots];
  __device__ void add(int slot) {
    const long long now = clock64();
    v[slot] += (unsigned long long)(now - t);
    t = now;
  }
};
#define B2_MARK() (clk.t = clock64())
#define B2_ADD(slot) clk.add(slot)
#else
#define B2_MARK() ((void)0)
#define B2_ADD(slot) ((void)0)
#endif

// The 128-isoform chunks of n (wide.chunks): n padded to 128 chunks(n).
__host__ __device__ inline int chunks(int n) { return (n + 127) / 128; }

struct Keys {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const Keys& k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.k0[r], lo1, hi0 ^ c.w ^ k.k1[r], lo0);
  }
  return c;
}

// [0, 1) at 23 bits, as the TPU kernel's _u01.
__device__ __forceinline__ float u01(uint32_t b) {
  return (float)(b & 0x7FFFFFu) * kTwoM23;
}

// log u_accept of a step, as B1 and B2 draw it; every thread of the lane
// draws it, the bitwise-same value.
__device__ __forceinline__ float log_accept(const Keys& k, int fixed_u,
                                            uint32_t lane, uint32_t step) {
  float u = kFixedU;
  if (!fixed_u)
    u = u01(philox4x32_10(make_uint4(lane, step, 0u, kAccept), k).x);
  return logf(fmaxf(u, kTwoM24));
}

// The four floats of a lane array at i0 (a multiple of 4): one 16-byte
// load of shared memory or scratch.
__device__ __forceinline__ float4 four(const float* x, int i0) {
  return *reinterpret_cast<const float4*>(x + i0);
}

// The sum of f over 128 nc isoforms in the wide order, on every lane of
// the calling warp: slot l adds f(128 c + 4 l) (four values) in (c, q)
// order, then the butterfly (every lane ends with the same bits).
template <class F>
__device__ __forceinline__ float warp_sum(int nc, F f) {
  const int l = (int)threadIdx.x & 31;
  float v = 0.f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const float4 x = f(128 * c + 4 * l);
    v = v + x.x;
    v = v + x.y;
    v = v + x.z;
    v = v + x.w;
  }
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(const float* x, int nc) {
  return warp_sum(nc, [x](int i0) { return four(x, i0); });
}

// sums[r] = the sum of xs[r] (128 nc[r] floats) for r < n, by warp_sum.
// Warp w takes r = w, w + warps, ...  The caller syncs before (inputs
// written) and after (sums read).
__device__ __forceinline__ void slot_sums(const float* const* xs, int n,
                                          const int* nc, float* sums) {
  const int warps = (int)blockDim.x >> 5, w = (int)threadIdx.x >> 5;
  for (int r = w; r < n; r += warps) {
    const float v = warp_sum(xs[r], nc[r]);
    if ((threadIdx.x & 31) == 0) sums[r] = v;
  }
}

// Four weights of isoforms i0 ... i0 + 3 of a row, 0 past I: one 16-byte
// load where the row allows it.
__device__ __forceinline__ void load4(const float* row, int i0, int I,
                                      bool vec, float w[4]) {
  if (vec && i0 + 3 < I) {
    const float4 f = *reinterpret_cast<const float4*>(row + i0);
    w[0] = f.x;
    w[1] = f.y;
    w[2] = f.z;
    w[3] = f.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = i0 + q < I ? row[i0 + q] : 0.f;
}

// ---------------------------------------------------------------- B1w
struct ReassignParams {
  const float* weights;    // (E, C, I) class weights
  const float* log_read;   // (E, C, I) a class's read score by isoform
  const int* cls;          // (E, A) the classes of the table
  const int* first;        // (E, A + 1) first read slot of each, then
                           // the event's slots with reads
  const int* slot;         // (E, R) read slot r's entry in cls, or -1
  const int* nact;         // (E,) classes in cls
  const int* walk;         // (E, R) the slots whose reads walk, then -1;
                           // null: slot s (read tiles)
  const int* wcls;         // (E, R) the class of each slot in walk; null:
                           // class s
  const int* nwalk;        // (E,) slots in walk
  const float* nvalid;     // (E,) reads some isoform can take
  const float* log_iso_w;  // (E, I), clamped at kNegBig
  const float* hyper;      // (E, I), 1 on padded isoforms
  const int* num_iso;      // (E,)
  const float* scal;       // (E, 2): noise_scale, dir_const
  const float* start;      // (E, K, I) GIVEN start, or null for AUTO
  float* psi_out;          // (E, RREC, K, I)
  float* loglik_out;       // (E, RREC, K)
  int* acc_out;            // (E, K)
  float* final_n;          // (E, K, I)
  float* final_psi;        // (E, K, I)
  float* scratch;          // lane arrays, or null: in shared memory
  int E, C, A, R, I, K, iters, burn_in, lag, rrec;
  int rows;                // class rows of a table tile
  Keys keys;
  int fixed_u;
  // a Gibbs uniform is bits * u_scale + u_shift: (2^-24, 0), or
  // (0, 0.4999f) under fixed_u
  float u_scale, u_shift;
  int nc, lane_floats;  // chunks of I; a lane's floats
  int vec;  // rows of 16-byte pieces: I % 4 == 0 and weights aligned
};

__device__ __forceinline__ float gibbs_uniform(uint32_t b,
                                               const ReassignParams& p) {
  return __fmaf_rn((float)((b >> 8) | 1u), p.u_scale, p.u_shift);
}

// The (I,) proposal normals of a step into z: pair j's radius gives
// isoform j r cos and isoform j + H r sin (pallas_kernel._normal_rows).
__device__ __forceinline__ void reassign_normals(const ReassignParams& p,
                                                 uint32_t lane,
                                                 uint32_t step, float* z) {
  const int H = (p.I + 1) / 2;
  for (int j = (int)threadIdx.x; j < H; j += (int)blockDim.x) {
    float u1 = kFixedU, u2 = kFixedU;
    if (!p.fixed_u) {
      const uint4 b =
          philox4x32_10(make_uint4(lane, step, (uint32_t)j, kNormals), p.keys);
      u1 = u01(b.x);
      u2 = u01(b.y);
    }
    const float r = sqrtf(-2.0f * logf(fmaxf(u1, kTwoM24)));
    const float ang = kTwoPi * u2;
    z[j] = r * cosf(ang);
    if (j + H < p.I) z[j + H] = r * sinf(ang);
  }
}

// The reads of a launch whose classes are about as many as its reads
// (wide.walks: read tiles, a class a read), walked as B1w walked every
// read before it read classes, no table built: a warp takes four of them
// side by side, each read's row (its class's) summed to its total (a
// lane's sums of its four, chunk after chunk, then a butterfly), then
// walked chunk by chunk to the first isoform i < I - 1 whose cumulative
// weight reaches u * total, found by a ballot (carry_c + (excl_l +
// loc_q), wide.wide_cumsum), else I - 1.  A read's uniform is its group's Philox
// call, keyed by (lane, step, slot / 4, kReads), drawn once for reads of
// one group.  Where classes hold several reads, a row shared in the
// table costs less (class_rows).
template <bool RP>
__device__ __forceinline__ void walk_reads(const ReassignParams& p, int e,
                                             uint32_t lane, uint32_t step,
                                             const float* psi, int* cnt,
                                             float* rs) {
  const int warps = (int)blockDim.x >> 5, w = (int)threadIdx.x >> 5;
  const int l = (int)threadIdx.x & 31;
  const int I = p.I, nc = p.nc, ns = p.nwalk[e];
  const bool vec = p.vec != 0;
  const int* walk = p.walk != nullptr ? p.walk + (size_t)e * p.R : nullptr;
  const int* wcls = p.wcls != nullptr ? p.wcls + (size_t)e * p.R : nullptr;
  const float* W = p.weights + (size_t)e * p.C * I;
  const float* LR = p.log_read + (size_t)e * p.C * I;
  for (int s0 = 4 * w; s0 < ns; s0 += 4 * warps) {
    int r[4], c[4];
    float u[4];
    if (walk == nullptr) {
      // read tiles: the pass is group s0 / 4, its reads' rows in turn
      const uint4 b = philox4x32_10(
          make_uint4(lane, step, (uint32_t)s0 >> 2, kReads), p.keys);
      const uint32_t bits[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = s0 + j < ns ? s0 + j : -1;
        c[j] = s0 + j < ns ? s0 + j : s0;
        u[j] = gibbs_uniform(bits[j], p);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a slot past the list repeats the pass's first, counted nowhere
        const int s = s0 + j < ns ? s0 + j : s0;
        r[j] = s0 + j < ns ? walk[s] : -1;
        c[j] = wcls[s];
      }
      uint32_t g = 0xffffffffu;
      uint4 b = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = r[j] >= 0 ? r[j] : r[0];
        if ((uint32_t)rr >> 2 != g) {
          g = (uint32_t)rr >> 2;
          b = philox4x32_10(make_uint4(lane, step, g, kReads), p.keys);
        }
        const int q = rr & 3;
        u[j] = gibbs_uniform(q == 0 ? b.x : q == 1 ? b.y : q == 2 ? b.z : b.w,
                             p);
      }
    }
    // the reads' totals: a lane's sums of its four, chunk after chunk,
    // then a butterfly over the lanes
    float total[4] = {0.f, 0.f, 0.f, 0.f};
    bool any[4] = {false, false, false, false};
    for (int ch = 0; ch < nc; ++ch) {
      const int i0 = 128 * ch + 4 * l;
      const float4 ps = four(psi, i0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float wv[4];
        load4(W + (size_t)c[j] * I, i0, I, vec, wv);
        float a = wv[0] * ps.x;
        a = a + wv[1] * ps.y;
        a = a + wv[2] * ps.z;
        a = a + wv[3] * ps.w;
        total[j] = total[j] + a;
        any[j] = any[j] || wv[0] > 0.f || wv[1] > 0.f || wv[2] > 0.f ||
                 wv[3] > 0.f;
      }
    }
    float target[4], carry[4] = {0.f, 0.f, 0.f, 0.f};
    bool valid[4];
    int found[4];  // the same on every lane
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        total[j] = total[j] + __shfl_xor_sync(kFull, total[j], o);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      valid[j] = __any_sync(kFull, any[j]) && r[j] >= 0;
      target[j] = u[j] * total[j];
      found[j] = valid[j] ? -1 : 0;  // nothing to walk for the others
    }
    for (int ch = 0; ch < nc; ++ch) {
      if (found[0] >= 0 && found[1] >= 0 && found[2] >= 0 && found[3] >= 0)
        break;
      const int i0 = 128 * ch + 4 * l;
      const float4 ps = four(psi, i0);
      float loc[4][4], incl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float wv[4];
        load4(W + (size_t)c[j] * I, i0, I, vec, wv);
        loc[j][0] = wv[0] * ps.x;
        loc[j][1] = loc[j][0] + wv[1] * ps.y;
        loc[j][2] = loc[j][1] + wv[2] * ps.z;
        loc[j][3] = loc[j][2] + wv[3] * ps.w;
        incl[j] = loc[j][3];
      }
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = __shfl_up_sync(kFull, incl[j], o);
          if (l >= o) incl[j] = incl[j] + y;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float excl = __shfl_up_sync(kFull, incl[j], 1);
        if (l == 0) excl = 0.f;
        const float chunk_total = __shfl_sync(kFull, incl[j], 31);
        if (found[j] >= 0) continue;
        int hit = -1;
#pragma unroll
        for (int q = 3; q >= 0; --q)
          if (i0 + q < I - 1 && carry[j] + (excl + loc[j][q]) >= target[j])
            hit = q;
        const unsigned hits = __ballot_sync(kFull, hit >= 0);
        if (hits != 0u)
          found[j] = __shfl_sync(kFull, i0 + hit, __ffs(hits) - 1);
        carry[j] = carry[j] + chunk_total;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!valid[j] || l != 0) continue;
      const int ch = found[j] >= 0 ? found[j] : I - 1;
      atomicAdd(&cnt[ch], 1);
      if (RP) rs[r[j]] = LR[(size_t)c[j] * I + ch];
    }
  }
}

// A tile's class rows at psi, into the table: row t (class cls[t]) gets
// its cumulative weights' running maximum at tab + t P, its total at
// tot[t] and at flag[t] whether some weight is > 0.  A cumulative weight
// at isoform 128 c + 4 l + q is carry_c + (excl_l + loc_q): lane l's
// running sums loc of its four w * psi, the warp's exclusive scan
// (shuffles up) of the lanes' sums, the chunks' totals carried in order;
// the total is each lane's sums over the chunks, added by a butterfly
// (wide.wide_cumsum): the floats a per-read walk computed, in its order.
// The scan adds the lanes' sums as a tree, so a lane's first cumulative
// weight can fall an ulp below the lane before it's last: the row keeps
// the running maximum (exact, in any order), which never falls, and
// whose first value that reaches a target is the first cumulative weight
// that does.
//
// A warp takes RPP rows (t, t + warps, ...) and CPP chunks of each at
// once, RPP * CPP = 4 slots whose loads and shuffle chains overlap: four
// rows a chunk at a time below 384 isoforms, one row four chunks at a
// time from there (wide_rows picks); the carries and maxima then
// pass from chunk to chunk in order, a few adds.  The next chunks'
// weights are loaded while these are scanned.  A warp with fewer rows
// left repeats its first and writes it once.
template <int RPP, int CPP>
__device__ __forceinline__ void class_rows(const ReassignParams& p, int e,
                                           const float* psi, const int* cls,
                                           int n, float* tab, float* tot,
                                           int* flag) {
  constexpr int NR = RPP * CPP;  // slot j: row j / CPP, chunk j % CPP
  const int warps = (int)blockDim.x >> 5, w = (int)threadIdx.x >> 5;
  const int l = (int)threadIdx.x & 31;
  const int I = p.I, P = 128 * p.nc, nc = p.nc;
  const bool vec = p.vec != 0;
  const float* W = p.weights + (size_t)e * p.C * I;
  for (int t = w; t < n; t += RPP * warps) {
    int tt[RPP];
    bool own[RPP];  // the row is this slot's to write (not a repeat)
    const float* row[RPP];
    float total[RPP], carry[RPP], cmax[RPP];
    bool any[RPP];
#pragma unroll
    for (int k = 0; k < RPP; ++k) {
      own[k] = t + k * warps < n;
      tt[k] = own[k] ? t + k * warps : t;
      row[k] = W + (size_t)cls[tt[k]] * I;
      total[k] = 0.f;
      carry[k] = 0.f;
      cmax[k] = kNegInf;
      any[k] = false;
    }
    float wn[NR][4];  // the next chunks' weights (zeros past the last)
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int c = j % CPP;
      if (c < nc) {
        load4(row[j / CPP], 128 * c + 4 * l, I, vec, wn[j]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) wn[j][q] = 0.f;
      }
    }
    for (int c0 = 0; c0 < nc; c0 += CPP) {
      float loc[NR][4], incl[NR], mx[NR], v[NR][4], wc[NR][4];
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) wc[j][q] = wn[j][q];
      if (c0 + CPP < nc) {
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int c = c0 + CPP + j % CPP;
          if (c < nc) {
            load4(row[j / CPP], 128 * c + 4 * l, I, vec, wn[j]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) wn[j][q] = 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int c = c0 + j % CPP;
        float4 ps = {0.f, 0.f, 0.f, 0.f};
        if (c < nc) ps = four(psi, 128 * c + 4 * l);
        const float* wv = wc[j];
        loc[j][0] = wv[0] * ps.x;
        loc[j][1] = loc[j][0] + wv[1] * ps.y;
        loc[j][2] = loc[j][1] + wv[2] * ps.z;
        loc[j][3] = loc[j][2] + wv[3] * ps.w;
        if (c < nc) {
          // chunk after chunk: j's chunks ascend within a row
          total[j / CPP] = total[j / CPP] + loc[j][3];
          any[j / CPP] = any[j / CPP] || wv[0] > 0.f || wv[1] > 0.f ||
                         wv[2] > 0.f || wv[3] > 0.f;
        }
        incl[j] = loc[j][3];
      }
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const float y = __shfl_up_sync(kFull, incl[j], o);
          if (l >= o) incl[j] = incl[j] + y;
        }
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        float excl = __shfl_up_sync(kFull, incl[j], 1);
        if (l == 0) excl = 0.f;
        const float chunk_total = __shfl_sync(kFull, incl[j], 31);
        const int k = j / CPP;
#pragma unroll
        for (int q = 0; q < 4; ++q) v[j][q] = carry[k] + (excl + loc[j][q]);
        carry[k] = carry[k] + chunk_total;
        mx[j] = fmaxf(fmaxf(v[j][0], v[j][1]), fmaxf(v[j][2], v[j][3]));
      }
      // the running maximum: the chunks before, the lanes before, then
      // the lane's own four
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const float y = __shfl_up_sync(kFull, mx[j], o);
          if (l >= o) mx[j] = fmaxf(mx[j], y);
        }
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int k = j / CPP, c = c0 + j % CPP;
        float before = __shfl_up_sync(kFull, mx[j], 1);
        if (l == 0) before = kNegInf;
        float m = fmaxf(cmax[k], before);
        cmax[k] = fmaxf(cmax[k], __shfl_sync(kFull, mx[j], 31));
        float4 out;
        m = fmaxf(m, v[j][0]);
        out.x = m;
        m = fmaxf(m, v[j][1]);
        out.y = m;
        m = fmaxf(m, v[j][2]);
        out.z = m;
        m = fmaxf(m, v[j][3]);
        out.w = m;
        if (own[k] && c < nc)
          *reinterpret_cast<float4*>(tab + (size_t)tt[k] * P + 128 * c +
                                     4 * l) = out;
      }
    }
#pragma unroll
    for (int k = 0; k < RPP; ++k) {
      for (int o = 16; o > 0; o >>= 1)
        total[k] = total[k] + __shfl_xor_sync(kFull, total[k], o);
      const bool some = __any_sync(kFull, any[k]);
      if (l == 0 && own[k]) {
        tot[tt[k]] = total[k];
        flag[tt[k]] = some ? 1 : 0;
      }
    }
  }
}

// The tile's rows, four slots a warp: one row four chunks at a time from
// three chunks a row, else four rows a chunk at a time.
__device__ __forceinline__ void wide_rows(const ReassignParams& p, int e,
                                          const float* psi, const int* cls,
                                          int n, float* tab, float* tot,
                                          int* flag) {
  if (p.nc >= 3)
    class_rows<1, 4>(p, e, psi, cls, n, tab, tot, flag);
  else
    class_rows<4, 1>(p, e, psi, cls, n, tab, tot, flag);
}

// One Gibbs sweep over the event's reads at psi: cnt gets the counts
// (integers: a read whose class has no weight > 0 counts nowhere), and
// the return value is the read score when RP (a record will read it),
// else 0.  Reads listed to walk are walked (walk_reads); the classes of
// the table are taken a tile of p.rows at a time:
// the warps build the tile's rows (class_rows), then each thread takes
// a group of four reads of the run of reads that falls in the tile (the
// reads are in class order), draws the group's four uniforms by one
// Philox call keyed by (lane, step, g, kReads) -- a group that straddles
// two tiles draws them in both, alike -- and finds each read's isoform:
// the first i < I - 1 whose running maximum in its class's row reaches
// u times the class's total, else I - 1, by a binary search (the four
// reads' searches side by side).  The running maximum never falls, so
// the search finds the index a walk along the row in isoform order
// finds.  A recorded step keeps each read's score (R floats, 0 for a
// read that counts nowhere) and sums them in one order whatever the
// block: group g into slot g % 32 in ascending g, a group's reads in
// turn, then a butterfly over the slots (wide.read_sum).  Ends with the
// block synchronised.
template <bool TABLE, bool RP>
__device__ float reassign_gibbs(const ReassignParams& p, int e,
                                uint32_t lane, uint32_t step,
                                const float* psi, int* cnt, float* rs,
                                float* tab, float* tot, int* flag) {
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  const int I = p.I, P = 128 * p.nc;
  for (int x = tid; x < P; x += nt) cnt[x] = 0;
  if (RP)
    for (int r = tid; r < p.R; r += nt) rs[r] = 0.f;
  __syncthreads();
  if (!TABLE) {
    walk_reads<RP>(p, e, lane, step, psi, cnt, rs);
    __syncthreads();
  }
  const int na = TABLE ? p.nact[e] : 0;
  const int* cls = p.cls + (size_t)e * p.A;
  const int* first = p.first + (size_t)e * (p.A + 1);
  const int* slot = p.slot + (size_t)e * p.R;
  const float* LR = p.log_read + (size_t)e * p.C * I;
  for (int a0 = 0; a0 < na; a0 += p.rows) {
    const int n = na - a0 < p.rows ? na - a0 : p.rows;
    wide_rows(p, e, psi, cls + a0, n, tab, tot, flag);
    __syncthreads();
    const int lo = first[a0], hi = first[a0 + n];
    for (int g = (lo >> 2) + tid; 4 * g < hi; g += nt) {
      const uint4 b =
          philox4x32_10(make_uint4(lane, step, (uint32_t)g, kReads), p.keys);
      const float u[4] = {gibbs_uniform(b.x, p), gibbs_uniform(b.y, p),
                          gibbs_uniform(b.z, p), gibbs_uniform(b.w, p)};
      const float* row[4];
      float target[4];
      int at[4], len[4], t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * g + j;
        t[j] = r >= lo && r < hi ? slot[r] - a0 : -1;
        len[j] = 0;
        at[j] = 0;
        row[j] = tab;
        target[j] = 0.f;
        if (t[j] >= 0 && flag[t[j]]) {
          row[j] = tab + (size_t)t[j] * P;
          target[j] = u[j] * tot[t[j]];
          len[j] = I - 1;
        } else {
          t[j] = -1;
        }
      }
      // lower bound over the first I - 1: "not yet reached" moves right
      // (a NaN target reaches nothing, as in a walk)
      for (;;) {
        bool more = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (len[j] > 0) {
            const int h = len[j] >> 1;
            const bool right = !(row[j][at[j] + h] >= target[j]);
            at[j] = right ? at[j] + h + 1 : at[j];
            len[j] = right ? len[j] - h - 1 : h;
            more = true;
          }
        }
        if (!more) break;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t[j] < 0) continue;
        atomicAdd(&cnt[at[j]], 1);
        if (RP) rs[4 * g + j] = LR[(size_t)cls[a0 + t[j]] * I + at[j]];
      }
    }
    __syncthreads();
  }
  if (!RP) return 0.f;
  // every warp adds the 32 slots alike
  const int l = tid & 31;
  float total = 0.f;
  for (int g = l; 4 * g < p.R; g += 32) {
    total = total + rs[4 * g];
    total = total + rs[4 * g + 1];
    total = total + rs[4 * g + 2];
    total = total + rs[4 * g + 3];
  }
  for (int o = 16; o > 0; o >>= 1)
    total = total + __shfl_xor_sync(kFull, total, o);
  return total;
}

// TABLE: the launch's reads go through the class table; else every read
// walks (wide.walks), and the kernel holds no table code.
template <bool TABLE>
__global__ void __launch_bounds__(kMaxThreads)
    reassign_wide_kernel(const ReassignParams p) {
  extern __shared__ __align__(16) float smem[];
  const int lane_i = (int)blockIdx.x;
  const int e = lane_i / p.K;
  const uint32_t lane = (uint32_t)lane_i;
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  const int I = p.I, P = 128 * p.nc;
  float* head = p.scratch != nullptr
                    ? p.scratch + (size_t)lane_i * p.lane_floats
                    : smem;
  float* alpha = head + kHeadFloats;
  float* psi = alpha + P;
  float* eiw = psi + P;
  float* aliw = eiw + P;
  float* h1 = aliw + P;
  int* cnt = reinterpret_cast<int*>(h1 + P);
  float* d = h1 + 2 * P;  // the step's normals, then its drift
  float* ex = d + P;      // exp(alpha') on the head isoforms
  float* q = ex + P;      // (ex + last) * efflen; the record's terms
  float* r1 = q + P;      // (n + h - 1) * drift
  float* rs = r1 + P;     // R read scores of a recorded step
  float* tab = rs + p.R;  // the class table: a tile's rows
  float* tot = tab + (size_t)p.rows * P;
  int* flag = reinterpret_cast<int*>(tot + p.rows);
  const int nc[4] = {p.nc, p.nc, p.nc, p.nc};

  const int k = p.num_iso[e];
  const float ns = p.scal[2 * e];
  const float dir_const = p.scal[2 * e + 1];
  const size_t eI = (size_t)e * I;
  const float km1 = k > 1 ? (float)(k - 1) : 0.f;
  const float kk = km1 + 1.0f;
  const float* sp =
      p.start != nullptr ? p.start + (size_t)lane_i * I : nullptr;
  const float lsl =
      sp != nullptr ? logf(fmaxf(k >= 1 ? sp[k - 1] : 0.f, 1e-30f)) : 0.f;
  const float a0 = km1 == 1.0f ? 0.f : 1.0f / fmaxf(km1, 1.0f);
  for (int i = tid; i < P; i += nt) {
    float v_eiw = 0.f, v_aliw = 0.f, v_h1 = 0.f, v_alpha = 0.f;
    if (i < I) {
      const float liw = fmaxf(p.log_iso_w[eI + i], kNegBig);
      const float im = i < k ? 1.f : 0.f;
      v_eiw = expf(liw) * im;
      v_aliw = im > 0.f ? liw : 0.f;
      v_h1 = im > 0.f ? p.hyper[eI + i] - 1.0f : 0.f;
      // start (miso.c:348-371 AUTO, :405-409 GIVEN)
      if (i < k - 1)
        v_alpha = sp != nullptr ? logf(fmaxf(sp[i], 1e-30f)) - lsl : a0;
    }
    eiw[i] = v_eiw;
    aliw[i] = v_aliw;
    h1[i] = v_h1;
    alpha[i] = v_alpha;
  }
  reassign_normals(p, lane, 0u, d);
  __syncthreads();
  const float n_valid = p.nvalid[e];  // reads some isoform can take
  // one proposal from the start, then the initial Gibbs draw
  // (miso.c:834-843)
  for (int i = tid; i < P; i += nt) {
    const float am = i < k - 1 ? 1.f : 0.f;
    const float last = i == k - 1 ? 1.f : 0.f;
    const float z = i < I ? d[i] : 0.f;
    const float a = alpha[i] + ns * z * am;
    alpha[i] = a;
    const float e1 = expf(a) * am;
    ex[i] = e1;
    q[i] = (e1 + last) * eiw[i];
  }
  __syncthreads();
  {
    const float* xs[3] = {h1, ex, q};
    slot_sums(xs, 3, nc, head + kSums);
  }
  __syncthreads();
  const float H1 = head[kSums];
  float ld = logf(fmaxf(1.0f + head[kSums + 1], kTiny));
  float logS = logf(fmaxf(head[kSums + 2], kTiny));
  {
    const float denom = 1.0f + head[kSums + 1];
    for (int i = tid; i < P; i += nt) {
      const float last = i == k - 1 ? 1.f : 0.f;
      psi[i] = (ex[i] + last) / denom;
    }
  }
  __syncthreads();
  // a record follows 0-based step m when m + 1 > burn_in and
  // (m + 1 - burn_in) % lag == 0 (miso_tpu/sampler/mcmc.py schedule);
  // the Gibbs draw before it also sums the read score
  int next_rec = p.burn_in + p.lag - 1;
  float rp =
      (next_rec == 0 && p.iters > 0)
          ? reassign_gibbs<TABLE, true>(p, e, lane, 0u, psi, cnt, rs, tab,
                                        tot, flag)
          : reassign_gibbs<TABLE, false>(p, e, lane, 0u, psi, cnt, rs, tab,
                                         tot, flag);

  int accepted = 0, rec = 0;
  for (int m = 0; m < p.iters; ++m) {
    const uint32_t step = (uint32_t)m + 1u;
    reassign_normals(p, lane, step, d);
    __syncthreads();
    for (int i = tid; i < P; i += nt) {
      const float am = i < k - 1 ? 1.f : 0.f;
      const float last = i == k - 1 ? 1.f : 0.f;
      const float z = i < I ? d[i] : 0.f;
      const float dd = ns * z * am;
      d[i] = dd;
      const float e1 = expf(alpha[i] + dd) * am;
      ex[i] = e1;
      q[i] = (e1 + last) * eiw[i];
      r1[i] = ((float)cnt[i] + h1[i]) * dd;
    }
    __syncthreads();
    {
      const float* xs[4] = {ex, q, r1, d};
      slot_sums(xs, 4, nc, head + kSums);
    }
    __syncthreads();
    // MH log-ratio in alpha space: the proposal quadratic and the read
    // score cancel; iteration 0 drops the proposal correction
    const float denom = 1.0f + head[kSums];
    const float ldn = logf(fmaxf(denom, kTiny));
    const float logSn = logf(fmaxf(head[kSums + 1], kTiny));
    const float full = m > 0 ? 1.f : 0.f;
    const float logr = head[kSums + 2] - n_valid * (logSn - logS) -
                       H1 * (ldn - ld) +
                       full * (head[kSums + 3] + kk * (ld - ldn));
    const float log_u = log_accept(p.keys, p.fixed_u, lane, step);
    if (logr >= 0.f || log_u < logr) {
      for (int i = tid; i < P; i += nt) {
        const float last = i == k - 1 ? 1.f : 0.f;
        alpha[i] = alpha[i] + d[i];
        psi[i] = (ex[i] + last) / denom;
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
        const size_t o = ((size_t)e * p.rrec + rec) * p.K + (lane_i - e * p.K);
        for (int i = tid; i < P; i += nt) {
          const float am = i < k - 1 ? 1.f : 0.f;
          const float n = (float)cnt[i];
          q[i] = (n + h1[i]) * (alpha[i] * am) + n * aliw[i];
          if (i < I) p.psi_out[o * I + i] = psi[i];
        }
        __syncthreads();
        {
          const float* xs[1] = {q};
          slot_sums(xs, 1, nc, head + kSums + 4);
        }
        __syncthreads();
        if (tid == 0)
          p.loglik_out[o] = rp + head[kSums + 4] - n_valid * logS - H1 * ld +
                            dir_const;
        ++rec;
      }
    }
    __syncthreads();
    rp = (m + 1 == next_rec && m + 1 < p.iters)
             ? reassign_gibbs<TABLE, true>(p, e, lane, step, psi, cnt, rs,
                                           tab, tot,
                                    flag)
             : reassign_gibbs<TABLE, false>(p, e, lane, step, psi, cnt, rs,
                                            tab, tot,
                                     flag);
  }
  if (tid == 0) p.acc_out[lane_i] = accepted;
  for (int i = tid; i < I; i += nt) {
    p.final_n[(size_t)lane_i * I + i] = (float)cnt[i];
    p.final_psi[(size_t)lane_i * I + i] = psi[i];
  }
}

// ---------------------------------------------------------------- B2w
// B2w's step is a chain of latencies: a warp sums the exp terms, then
// the head's psi (each 4 chunks(I) ordered adds and a butterfly), the
// classes' dot products with psi' (the same, a row a class) and their
// terms; its floor is deep.marginal_wide_floor, and a block of 16 warps
// also waits on its SM's schedulers.  With its rows in device memory it took
// 10,142 clocks a step at 512 isoforms, 3,820 of them the class terms'
// loads of device memory, and 29,551 at 2,048, 18,180 of them those
// loads.  Here:
//
// - The weights live in shared memory for the whole launch where a
//   block holds them (a launch of few lanes): each block copies its
//   classes' rows (padded to 128 chunks(I), zeros past I) once, and a
//   step's class terms read them there, up to four rows a warp at once.
//   Where the rows do not fit one block, a lane is a thread-block
//   cluster of `cluster` blocks that split its classes, rows =
//   ceil(C / cluster) each: every block computes the same alpha', psi',
//   log psi' and MH decision (the same floats in the same order: no
//   broadcast), its classes' terms, and writes them into every block's
//   term buffer (distributed shared memory); one cluster barrier a step
//   (arrive.release and wait.acquire: ~1,300 clocks, a GPU-scope fence
//   and an L1 invalidation in the SASS), and two term buffers by the
//   step's parity, so a block that runs ahead cannot overwrite terms a
//   slower one still sums.  Where the rows would leave the launch more
//   than one wave, or fit no cluster (wide.py), they stay in device
//   memory.
// - Randoms are drawn a step ahead, off the chain: the next step's
//   normal pairs and log u_accept by the warps that wait while warp 0
//   makes the step's two psi sums (in a cluster each block draws its
//   share of the pairs into every block), into two buffers by parity.
// - Six barriers a step in place of nine: alpha' is fused into the exp
//   pass, the Dirichlet and proposal quadratics' terms are computed by
//   the warps that sum them (warps 0-3, beside the class terms) and
//   never stored, and every warp sums the class terms itself after the
//   last barrier, then takes the MH decision.
//
// The sums keep their order (slot l adds 128 c + 4 l + q in (c, q)
// order, then the butterfly; the class terms likewise), so the chain is
// the first wide kernel's, to the bit, in every plan.
namespace cg = cooperative_groups;

struct MarginalParams {
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
  float* scratch;        // a block's lane arrays, or null: in shared memory
  int E, C, I, K, iters, burn_in, lag, rrec;
  Keys keys;
  int fixed_u;
  int nc, ncc, lane_floats;  // chunks of I and of C; a block's lane floats
  int vec;      // rows of 16-byte pieces: I % 4 == 0 and weights aligned
  int cluster;  // blocks of a lane
  int rows;     // classes of a block: ceil(C / cluster)
};

// The head: the step's sums and the drawn-ahead log u_accept.
constexpr int kS1 = 0, kS2 = 1;  // sum exp(alpha'), sum of the head's psi'
constexpr int kSq = 2;           // (h - 1) log psi', log psi' on the head,
                                 // and the two proposal quadratics
constexpr int kLogU = 8;         // two slots, by the step's parity

// The cluster barrier in two halves: arrive (releasing this thread's
// writes, the remote ones included) and wait (acquiring the others').
__device__ __forceinline__ void cluster_arrive() {
#ifdef __CUDACC__
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
#else
  shim_cluster_arrive();
#endif
}
__device__ __forceinline__ void cluster_wait() {
#ifdef __CUDACC__
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
#else
  shim_cluster_wait();
#endif
}

// The normal pairs j = j0 + g, g + cluster ... < j1 (g: this block's
// rank where the pairs are split over the cluster, else 0, every pair) of
// a step, as B2 draws them: with Philox pair j's radius gives isoform j
// r cos and isoform j + H r sin (0 past the head isoforms); under
// fixed_u every head row is r cos, as the TPU kernel's cos-only _normal
// gives.  Drawer t of n takes every n-th of them; each is written into
// z of every block that reads it (``split``: the whole cluster).
__device__ __forceinline__ void marginal_pairs(const MarginalParams& p,
                                               int k, uint32_t lane,
                                               uint32_t step, int j0, int j1,
                                               int t, int n, float* z,
                                               bool split, unsigned rank) {
  const int H = (p.I + 1) / 2;
  const int stride = split ? p.cluster : 1;
  for (int j = j0 + (split ? (int)rank : 0) + t * stride; j < j1;
       j += n * stride) {
    float u1 = kFixedU, u2 = kFixedU;
    if (!p.fixed_u) {
      const uint4 b =
          philox4x32_10(make_uint4(lane, step, (uint32_t)j, kNormals), p.keys);
      u1 = u01(b.x);
      u2 = u01(b.y);
    }
    const float r = sqrtf(-2.0f * logf(fmaxf(u1, kTwoM24)));
    const float ang = kTwoPi * u2;
    const float c = r * cosf(ang);
    float s = 0.f;
    if (j + H < p.I && j + H < k - 1) s = p.fixed_u ? c : r * sinf(ang);
    for (int q = 0; q < stride; ++q) {
      float* zq = split ? cg::this_cluster().map_shared_rank(z, (unsigned)q)
                        : z;
      zq[j] = c;
      if (j + H < p.I) zq[j + H] = s;
    }
  }
}

// A class's term counts_c log(s_c) (0 where s_c is 0), into the term
// buffer tb of every block of the lane's cluster.
__device__ __forceinline__ void marginal_term(const MarginalParams& p,
                                              const float* cnt, int c,
                                              float v, float* tb) {
  const float t = v > 0.f ? cnt[c] * logf(fmaxf(v, kTiny)) : 0.f;
  if (p.cluster == 1) {
    tb[c] = t;
    return;
  }
  for (int q = 0; q < p.cluster; ++q)
    cg::this_cluster().map_shared_rank(tb, (unsigned)q)[c] = t;
}

// Chunk ch of RPP class rows into their sums v: slot l adds w * psi of
// its four isoforms in turn.  Every row's weights are loaded before any
// is added, so that the rows' loads overlap.
template <int RPP>
__device__ __forceinline__ void row_chunk(const float* const* row,
                                          const float* psi, int ch, int len,
                                          bool vec, float* v) {
  const int i0 = 128 * ch + 4 * ((int)threadIdx.x & 31);
  const float4 ps = four(psi, i0);
  float wv[RPP][4];
#pragma unroll
  for (int j = 0; j < RPP; ++j) load4(row[j], i0, len, vec, wv[j]);
#pragma unroll
  for (int j = 0; j < RPP; ++j) {
    v[j] = v[j] + wv[j][0] * ps.x;
    v[j] = v[j] + wv[j][1] * ps.y;
    v[j] = v[j] + wv[j][2] * ps.z;
    v[j] = v[j] + wv[j][3] * ps.w;
  }
}

// This block's class terms, s_c = sum_i W_ci psi_i.  The rows go round
// the warps w0 ... (RW of them): warp w0 + r takes rows r, r + RW, ...
// RPP at a time, its lanes a row's chunks' isoforms (a warp past its
// last row repeats its first and keeps nothing of it).  A row's sum is
// kept by the lane whose turn it is, and every 32 rows the lanes take
// their rows' logs at once.
template <bool WS, int RPP>
__device__ __forceinline__ void marginal_rows(const MarginalParams& p,
                                              int e, int c0, int nrows,
                                              const float* wrow,
                                              const float* psi, float* tb,
                                              int w0) {
  const int w = (int)threadIdx.x >> 5, l = (int)threadIdx.x & 31;
  const int RW = ((int)blockDim.x >> 5) - w0, r = w - w0;
  const int I = p.I, P = 128 * p.nc, nc = p.nc;
  const int len = WS ? P : I;
  const bool vec = WS || p.vec != 0;
  const float* W = p.weights + (size_t)e * p.C * I;
  const float* cnt = p.counts + (size_t)e * p.C;
  if (r < 0) return;
  float mine = 0.f;  // this lane's row's sum, of class mine_c
  int mine_c = -1, kept = 0;
  for (int t0 = r; t0 < nrows; t0 += RPP * RW) {
    int tt[RPP];
    bool own[RPP];
    const float* row[RPP];
    float v[RPP];
#pragma unroll
    for (int j = 0; j < RPP; ++j) {
      own[j] = t0 + j * RW < nrows;
      tt[j] = own[j] ? t0 + j * RW : t0;
      row[j] = WS ? wrow + (size_t)tt[j] * P : W + (size_t)(c0 + tt[j]) * I;
      v[j] = 0.f;
    }
    for (int ch = 0; ch < nc; ++ch) row_chunk<RPP>(row, psi, ch, len, vec, v);
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < RPP; ++j)
        v[j] = v[j] + __shfl_xor_sync(kFull, v[j], o);
    }
#pragma unroll
    for (int j = 0; j < RPP; ++j) {
      if (!own[j]) continue;
      if (l == kept) {
        mine = v[j];
        mine_c = c0 + tt[j];
      }
      if (++kept == 32) {
        marginal_term(p, cnt, mine_c, mine, tb);
        mine_c = -1;
        kept = 0;
      }
    }
  }
  if (mine_c >= 0) marginal_term(p, cnt, mine_c, mine, tb);
}

// Rows in shared memory (a launch of few lanes, whose step is a chain of
// latencies) go to the warps past the four that sum the quadratics, up
// to four at once; rows in device memory (a launch that fills the card)
// to every warp, two at once.  Either way a warp's lanes take their
// rows' logs 32 at once: at 2,048 events, 100 x 6, in blocks of 64 and
// 32 threads, of 64 isoforms and 256 classes 35.48 ms, of 2,048 and 64
// 768.81 ms, where two rows a warp with their logs on lane 0 (the first
// wide kernel's way) took 47.63 and 817.99 (wide_times.py --marginal on an
// H100, that layout forced).  A warp
// takes its share in as few passes as it can, its rows as even over them
// as they go.
template <bool WS>
__device__ __forceinline__ void marginal_terms(const MarginalParams& p,
                                               int e, int c0, int nrows,
                                               const float* wrow,
                                               const float* psi, float* tb) {
  constexpr int kMost = WS ? 4 : 2;
  const int warps = (int)blockDim.x >> 5;
  const int w0 = WS && warps >= 8 ? 4 : 0;
  const int per = (nrows + warps - w0 - 1) / (warps - w0);  // rows a warp
  const int passes = (per + kMost - 1) / kMost;
  switch (passes > 0 ? (per + passes - 1) / passes : 1) {
    case 4:
      marginal_rows<WS, WS ? 4 : 2>(p, e, c0, nrows, wrow, psi, tb, w0);
      break;
    case 3:
      marginal_rows<WS, WS ? 3 : 2>(p, e, c0, nrows, wrow, psi, tb, w0);
      break;
    case 2:
      marginal_rows<WS, 2>(p, e, c0, nrows, wrow, psi, tb, w0);
      break;
    default:
      marginal_rows<WS, 1>(p, e, c0, nrows, wrow, psi, tb, w0);
  }
}

// Registers: with its rows in device memory (a launch that fills the
// card) at most 64 a thread, two blocks of 512 an SM, as the first wide
// kernel took; with its rows in shared memory (a block an SM) up to 128, which
// its four rows at once need.  The step-breakdown build leaves its
// stamps' registers free of the former bound, lest they spill.
#ifdef MISO_B2W_CLOCKS
#define B2W_BOUNDS __launch_bounds__(kMaxThreads)
#else
#define B2W_BOUNDS __launch_bounds__(kMaxThreads, WS ? 1 : 2)
#endif
template <bool WS>
__global__ void B2W_BOUNDS marginal_wide_kernel(const MarginalParams p) {
  extern __shared__ __align__(16) float smem[];
  const int cl = p.cluster;
  const unsigned rank = cl > 1 ? cg::this_cluster().block_rank() : 0u;
  const int lane_i = (int)blockIdx.x / cl;
  const int e = lane_i / p.K;
  const uint32_t lane = (uint32_t)lane_i;
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  const int warps = nt >> 5, w = tid >> 5;
  const int I = p.I, C = p.C, P = 128 * p.nc, PC = 128 * p.ncc;
  // shared: the two term buffers, this block's weight rows (WS), then
  // the lane's arrays unless they lie in scratch
  float* terms = smem;
  float* wrow = smem + 2 * PC;
  float* head = p.scratch != nullptr
                    ? p.scratch + (size_t)blockIdx.x * p.lane_floats
                    : wrow + (WS ? (size_t)p.rows * P : 0);
  // the current state and the proposal's swap places on an accept
  float* alpha = head + kHeadFloats;
  float* psi = alpha + P;
  float* lp = psi + P;
  float* h1 = lp + P;
  float* an = h1 + P;
  float* pn = an + P;
  float* lpn = pn + P;
  float* zb = lpn + P;  // two steps' normals, by parity
  const int c0 = (int)rank * p.rows;
  const int nrows = C - c0 < p.rows ? (C - c0 > 0 ? C - c0 : 0) : p.rows;
  // the next step's pairs go to every block of the cluster where the
  // lane arrays lie in shared memory; in scratch each block draws all
  const bool split = cl > 1 && p.scratch == nullptr;
  // drawers: every warp but warp 0, which sums meanwhile (all of a
  // one-warp block, after its sum)
  const int d0 = warps > 1 ? 32 : 0;

  const int k = p.num_iso[e];
  const float ns = p.scal[4 * e];
  const float inv_sigma = p.scal[4 * e + 1];
  const float prop_const = p.scal[4 * e + 2];
  const float dir_const = p.scal[4 * e + 3];
  const size_t eI = (size_t)e * I;
  const float km1 = k > 1 ? (float)(k - 1) : 0.f;
  const float* sp =
      p.start != nullptr ? p.start + (size_t)lane_i * I : nullptr;
  const float lsl =
      sp != nullptr ? logf(fmaxf(k >= 1 ? sp[k - 1] : 0.f, 1e-30f)) : 0.f;
  const float a0 = km1 == 1.0f ? 0.f : 1.0f / fmaxf(km1, 1.0f);
  for (int i = tid; i < P; i += nt) {
    float v_h1 = 0.f, v_alpha = 0.f;
    if (i < I) {
      v_h1 = i < k ? p.hyper[eI + i] - 1.0f : 0.f;
      // start (miso.c:348-371 AUTO, :405-409 GIVEN)
      if (i < k - 1)
        v_alpha = sp != nullptr ? logf(fmaxf(sp[i], 1e-30f)) - lsl : a0;
    }
    h1[i] = v_h1;
    alpha[i] = v_alpha;
    psi[i] = 0.f;
    lp[i] = 0.f;
  }
  for (int c = tid; c < 2 * PC; c += nt) terms[c] = 0.f;
  if (WS) {
    // this block's rows, once for the launch
    const float* W = p.weights + ((size_t)e * C + c0) * I;
    for (int x = tid; x < p.rows * P; x += nt) {
      const int t = x / P, i = x - t * P;
      wrow[x] = t < nrows && i < I ? W[(size_t)t * I + i] : 0.f;
    }
  }
  // step 0's normals, every pair in every block
  marginal_pairs(p, k, lane, 0u, 0, (I + 1) / 2, tid, nt, zb, false, 0u);
  if (cl > 1) {  // every block has started before any writes a peer
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  const float log_tiny = logf(kTiny);
  // the first window's pairs: half, or all where one warp sums and draws
  const int H = (I + 1) / 2, H2 = warps > 1 ? (H + 1) / 2 : H;
  float cjs = 0.f, lt = 0.f, base = 0.f;
  int next_rec = p.burn_in + p.lag - 1;
  int accepted = 0, rec = 0;
#ifdef MISO_B2W_CLOCKS
  B2wClocks clk = {};
#endif
  // s = 0: one proposal from the start, always taken (miso.c:834); s =
  // m + 1: MH step m
  for (int s = 0; s <= p.iters; ++s) {
    B2_MARK();
    const float* z = zb + (s & 1) * P;
    float* zn = zb + ((s + 1) & 1) * P;
    const bool draw = s < p.iters;
    // h = 0: alpha' and exp, then their sum; h = 1: the division, then
    // the head's psi' sum.  Meanwhile the other warps draw the next
    // step's pairs, half each time, and log u_accept.
    for (int h = 0; h < 2; ++h) {
      if (h == 0) {
        for (int i = tid; i < P; i += nt) {
          const float hd = i < k - 1 ? 1.f : 0.f;
          const float zi = i < I ? z[i] : 0.f;
          const float a = alpha[i] + ns * zi * hd;
          an[i] = a;
          pn[i] = i < k - 1 ? expf(a) : 0.f;
        }
      } else {
        const float denom = 1.0f + head[kS1];
        for (int i = tid; i < P; i += nt)
          if (i < k - 1) pn[i] = pn[i] / denom;
      }
      if (h == 0)
        B2_ADD(kB2Exp);
      else
        B2_ADD(kB2DivLog);
      __syncthreads();
      B2_ADD(kB2Wait);
      if (w == 0) {
        const float sum = warp_sum(pn, p.nc);
        if (tid == 0) head[kS1 + h] = sum;
        B2_ADD(kB2PsiSums);
      }
      if (draw && tid >= d0) {
        if (h == 0 && tid == d0)
          head[kLogU + ((s + 1) & 1)] =
              log_accept(p.keys, p.fixed_u, lane, (uint32_t)s + 1u);
        marginal_pairs(p, k, lane, (uint32_t)s + 1u, h == 0 ? 0 : H2,
                       h == 0 ? H2 : H, tid - d0, nt - d0, zn, split, rank);
        B2_ADD(kB2Normals);
      }
      __syncthreads();
      B2_ADD(kB2Wait);
    }
    // psi' (the last isoform takes 1 - the head's sum) and log psi'
    const float rest = 1.0f - head[kS2];
    for (int i = tid; i < P; i += nt) {
      const float last = i == k - 1 ? 1.f : 0.f;
      const float v = pn[i] + last * rest;
      pn[i] = v;
      lpn[i] = i < k ? logf(fmaxf(v, kTiny)) : 0.f;
    }
    B2_ADD(kB2DivLog);
    __syncthreads();
    B2_ADD(kB2Wait);
    const float ltn = k > 0 ? lpn[k - 1] : log_tiny;
    float* tb = terms + (s & 1) * PC;
    marginal_terms<WS>(p, e, c0, nrows, wrow, pn, tb);
    if (tid == nt - 32)
      B2_ADD(kB2Rows);
    else
      B2_ADD(kB2Terms);
    // warps 0-3: the Dirichlet term (j = 0), log psi' on the head (1), and
    // the proposal densities' quadratics, log q(psi | alpha') of the
    // current state (2: (log psi'_i - log psi'_last) - alpha_i) and
    // log q(psi' | alpha) of the proposal (3: (log psi_i - log psi_last)
    // - alpha'_i) (miso.c:97-122, pallas_marginal.py proposal_score),
    // summed as they are computed
    for (int j = w; j < 4; j += warps) {
      float v;
      if (j == 0) {
        v = warp_sum(p.nc, [&](int i0) {
          const float4 h = four(h1, i0), lg = four(lpn, i0);
          return make_float4(i0 < k ? h.x * lg.x : 0.f,
                             i0 + 1 < k ? h.y * lg.y : 0.f,
                             i0 + 2 < k ? h.z * lg.z : 0.f,
                             i0 + 3 < k ? h.w * lg.w : 0.f);
        });
      } else if (j == 1) {
        v = warp_sum(p.nc, [&](int i0) {
          const float4 lg = four(lpn, i0);
          return make_float4(i0 < k - 1 ? lg.x : 0.f, i0 + 1 < k - 1 ? lg.y : 0.f,
                             i0 + 2 < k - 1 ? lg.z : 0.f,
                             i0 + 3 < k - 1 ? lg.w : 0.f);
        });
      } else {
        const float* lq = j == 2 ? lpn : lp;
        const float* am = j == 2 ? alpha : an;
        const float last = j == 2 ? ltn : lt;
        v = warp_sum(p.nc, [&](int i0) {
          const float4 lg = four(lq, i0), a = four(am, i0);
          const float d0 = i0 < k - 1 ? (lg.x - last) - a.x : 0.f;
          const float d1 = i0 + 1 < k - 1 ? (lg.y - last) - a.y : 0.f;
          const float d2 = i0 + 2 < k - 1 ? (lg.z - last) - a.z : 0.f;
          const float d3 = i0 + 3 < k - 1 ? (lg.w - last) - a.w : 0.f;
          return make_float4(d0 * d0, d1 * d1, d2 * d2, d3 * d3);
        });
      }
      if ((tid & 31) == 0) head[kSq + j] = v;
    }
    B2_ADD(kB2Quad);
    if (cl > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
    B2_ADD(kB2Terms);
    // every warp sums the class terms alike
    const float s0 = warp_sum(tb, p.ncc);
    B2_ADD(kB2Sums);
    const float pjs = s0 + (head[kSq] + dir_const);
    const float basen = (prop_const - head[kSq + 1]) - ltn;
    bool take = s == 0;
    if (s > 0) {
      const float pto_c = base + (-0.5f * head[kSq + 3]) * inv_sigma;
      const float cto_p = basen + (-0.5f * head[kSq + 2]) * inv_sigma;
      // iteration 0 drops the proposal correction (pallas_marginal.py:146)
      const float full = s > 1 ? 1.f : 0.f;
      const float logr = (pjs - cjs) + full * (pto_c - cto_p);
      const float log_u = head[kLogU + (s & 1)];
      take = logr >= 0.f || log_u < logr;
      accepted += take ? 1 : 0;
    }
    if (take) {
      float* t = alpha;
      alpha = an;
      an = t;
      t = psi;
      psi = pn;
      pn = t;
      t = lp;
      lp = lpn;
      lpn = t;
      lt = ltn;
      base = basen;
      cjs = pjs;
    }
    if (s > 0 && s - 1 == next_rec) {
      next_rec += p.lag;
      if (rec < p.rrec) {
        if (rank == 0) {
          const size_t o =
              ((size_t)e * p.rrec + rec) * p.K + (lane_i - e * p.K);
          for (int i = tid; i < I; i += nt) p.psi_out[o * I + i] = psi[i];
          if (tid == 0) p.loglik_out[o] = cjs;
        }
        ++rec;
      }
    }
    B2_ADD(kB2MH);
#ifdef MISO_B2W_CLOCKS
    if (s == 0)
      clk = B2wClocks{};  // the iterations alone
    else
      clk.v[kB2Steps] += 1;
#endif
  }
#ifdef MISO_B2W_CLOCKS
  // each lane's first thread, and the class rows from its last warp's
  if (rank == 0 && tid == 0)
    for (int i = 0; i < kB2Slots; ++i)
      if (i != kB2Rows || nt == 32) atomicAdd(&b2w_clocks[i], clk.v[i]);
  if (rank == 0 && tid == nt - 32 && nt > 32)
    atomicAdd(&b2w_clocks[kB2Rows], clk.v[kB2Rows]);
#endif
  if (rank == 0) {
    if (tid == 0) p.acc_out[lane_i] = accepted;
    for (int i = tid; i < I; i += nt)
      p.final_psi[(size_t)lane_i * I + i] = psi[i];
  }
  if (cl > 1) {  // no block leaves while a peer may still read it
    cluster_arrive();
    cluster_wait();
  }
}

// A lane's floats: the head, the kernel's I-wide arrays (128 chunks(I)
// each), for B1w its n = R read scores and a class table of `rows` rows
// (rounded up to whole 16 bytes, which the lanes' float4 loads in
// scratch need); for B2w a block's (kind 0: B1w, 1: B2w), whose class
// terms and weight rows lie apart (marginal_shared_floats).
long long lane_floats(int kind, int n, int I, int rows) {
  const long long P = 128LL * chunks(I);
  if (kind == 0)  // whole 16 bytes: the next lane's arrays in scratch
    return (kHeadFloats + kReassignArrays * P + n +
            (long long)rows * (P + kRowScalars) + 3) / 4 * 4;
  return kHeadFloats + kMarginalArrays * P;
}

// B2w's shared floats: its two term buffers, its block's weight rows
// where they lie in shared memory, and its lane floats where they do.
long long marginal_shared_floats(int C, int I, int cluster, int wshared,
                                 int arrays_shared) {
  const long long P = 128LL * chunks(I);
  const long long rows = (C + cluster - 1) / cluster;
  return 2 * 128LL * chunks(C) + (wshared ? rows * P : 0) +
         (arrays_shared ? lane_floats(1, C, I, 0) : 0);
}

// A block of whole warps within the bounds.
bool block_ok(int threads) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

// The plan's own consistency: a block_ok block, and the lane's arrays in
// shared memory (exactly their size) or in scratch (no shared memory).
bool plan_ok(int threads, long long floats, long long shared_bytes,
             const float* scratch) {
  if (!block_ok(threads)) return false;
  if (scratch != nullptr) return shared_bytes == 0;
  return shared_bytes == floats * 4 && shared_bytes <= kMaxShared;
}

// B2w's: a block_ok block, a cluster of 1, 2, 4 or 8 blocks, and exactly
// the shared memory its layout takes, within a block's.
bool marginal_plan_ok(int threads, int C, int I, int cluster, int wshared,
                      long long shared_bytes, const float* scratch) {
  if (!block_ok(threads)) return false;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return false;
  if (wshared != 0 && wshared != 1) return false;
  const long long need =
      4 * marginal_shared_floats(C, I, cluster, wshared, scratch == nullptr);
  return shared_bytes == need && shared_bytes <= kMaxShared;
}

// A launch of `blocks` blocks, in clusters of `cluster` (consecutive
// blocks form one; 1: no cluster dimension); a launch the card cannot
// place returns its error.
template <class Kernel, class Params>
int launch(Kernel kernel, const Params& p, int blocks, int threads,
           long long shared_bytes, void* stream, int cluster = 1) {
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1u, 1u);
  cfg.blockDim = dim3((unsigned)threads, 1u, 1u);
  cfg.dynamicSmemBytes = (size_t)shared_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

void set_keys(Keys& k, unsigned int seed_lo, unsigned int seed_hi) {
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = seed_lo + (uint32_t)r * 0x9E3779B9u;
    k.k1[r] = seed_hi + (uint32_t)r * 0xBB67AE85u;
  }
}

}  // namespace

extern "C" long long miso_wide_lane_floats(int kind, int n, int I,
                                           int rows) {
  return lane_floats(kind, n, I, rows);
}

extern "C" int miso_reassign_wide(
    const float* weights, const float* log_read, const int* cls,
    const int* first, const int* slot, const int* nact, const int* walk,
    const int* wcls, const int* nwalk, const float* nvalid,
    const float* log_iso_w, const float* hyper, const int* num_iso,
    const float* scal, const float* start, float* psi_out,
    float* loglik_out, int* acc_out, float* final_n, float* final_psi,
    float* scratch, int E, int C, int A, int R, int I, int K, int iters,
    int burn_in, int lag, int rrec, unsigned int seed_lo,
    unsigned int seed_hi, int fixed_u, int threads, int rows,
    long long shared_bytes, void* stream) {
  const long long lanes = (long long)E * K;
  if (lanes == 0) return 0;
  const long long floats = lane_floats(0, R, I, rows);
  if (lanes > 0x7fffffffLL || I < 2 || C < 1 || A < 1 || R < 4 ||
      R % 4 != 0 || rows < 1 || lag < 1 || floats > 0x7fffffffLL ||
      !plan_ok(threads, floats, shared_bytes, scratch))
    return (int)cudaErrorInvalidValue;
  ReassignParams p{weights, log_read, cls, first, slot, nact, walk, wcls,
                   nwalk, nvalid, log_iso_w, hyper, num_iso, scal, start,
                   psi_out, loglik_out, acc_out, final_n, final_psi,
                   scratch, E, C, A, R, I, K, iters, burn_in, lag, rrec,
                   rows};
  set_keys(p.keys, seed_lo, seed_hi);
  p.fixed_u = fixed_u;
  p.u_scale = fixed_u ? 0.f : kTwoM24;
  p.u_shift = fixed_u ? kFixedU : 0.f;
  p.nc = chunks(I);
  p.lane_floats = (int)floats;
  p.vec = I % 4 == 0 && reinterpret_cast<uintptr_t>(weights) % 16 == 0;
  // a table, or (no cls) every read walks
  if (cls == nullptr)
    return launch(reassign_wide_kernel<false>, p, (int)lanes, threads,
                  shared_bytes, stream);
  return launch(reassign_wide_kernel<true>, p, (int)lanes, threads,
                shared_bytes, stream);
}

extern "C" int miso_marginal_wide(
    const float* weights, const float* counts, const int* num_iso,
    const float* hyper, const float* scal, const float* start,
    float* psi_out, float* loglik_out, int* acc_out, float* final_psi,
    float* scratch, int E, int C, int I, int K, int iters, int burn_in,
    int lag, int rrec, unsigned int seed_lo, unsigned int seed_hi,
    int fixed_u, int threads, int cluster, int wshared,
    long long shared_bytes, void* stream) {
  const long long lanes = (long long)E * K;
  if (lanes == 0) return 0;
  const long long floats = lane_floats(1, C, I, 0);
  if (lanes * cluster > 0x7fffffffLL || I < 2 || C < 1 || lag < 1 ||
      !marginal_plan_ok(threads, C, I, cluster, wshared, shared_bytes,
                        scratch))
    return (int)cudaErrorInvalidValue;
  MarginalParams p{weights, counts, num_iso, hyper, scal, start, psi_out,
                   loglik_out, acc_out, final_psi, scratch, E, C, I, K,
                   iters, burn_in, lag, rrec};
  set_keys(p.keys, seed_lo, seed_hi);
  p.fixed_u = fixed_u;
  p.nc = chunks(I);
  p.ncc = chunks(C);
  p.lane_floats = (int)floats;
  p.vec = I % 4 == 0 && reinterpret_cast<uintptr_t>(weights) % 16 == 0;
  p.cluster = cluster;
  p.rows = (C + cluster - 1) / cluster;
  const int blocks = (int)(lanes * cluster);
  return wshared ? launch(marginal_wide_kernel<true>, p, blocks, threads,
                          shared_bytes, stream, cluster)
                 : launch(marginal_wide_kernel<false>, p, blocks, threads,
                          shared_bytes, stream, cluster);
}

#ifdef MISO_B2W_CLOCKS
// The step breakdown's sums since the last read (kB2Slots values), then
// cleared.
extern "C" int miso_marginal_wide_clocks(unsigned long long* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, b2w_clocks, sizeof(b2w_clocks));
  if (rc != cudaSuccess) return (int)rc;
  static const unsigned long long zeros[kB2Slots] = {};
  return (int)cudaMemcpyToSymbol(b2w_clocks, zeros, sizeof(zeros));
}

#ifdef __CUDACC__
#include <cooperative_groups.h>

// Latencies of B2w's synchronisation, in clocks per barrier, from one
// block (or one cluster) doing nothing else: a block barrier of 32 and
// of 512 threads, a cluster barrier over clusters of 2, 4 and 8 blocks of
// 512 threads, and, in a cluster of 4, a barrier after each block's first
// thread stores a float into the next block's shared memory.
enum B2wLatency {
  kLatBar32, kLatBar512, kLatCluster2, kLatCluster4, kLatCluster8,
  kLatRemote4, kB2wLatSlots
};

__global__ void wide_barrier_probe(double* out, int reps, int slot) {
  const long long t = clock64();
  for (int r = 0; r < reps; ++r) __syncthreads();
  if (threadIdx.x == 0) out[slot] = (double)(clock64() - t) / reps;
}

__global__ void wide_cluster_probe(double* out, int reps, int slot,
                                   int remote) {
  __shared__ float box[64];
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  box[threadIdx.x & 63] = 0.f;
  cl.sync();
  const unsigned next = (cl.block_rank() + 1) % cl.num_blocks();
  const long long t = clock64();
  for (int r = 0; r < reps; ++r) {
    if (remote && threadIdx.x == 0)
      cl.map_shared_rank(box, next)[r & 63] = (float)r;
    cl.sync();
  }
  if (threadIdx.x == 0 && cl.block_rank() == 0)
    out[slot] = (double)(clock64() - t) / reps;
}

extern "C" int miso_wide_latencies(double* out, int reps) {
  wide_barrier_probe<<<1, 32, 0>>>(out, reps, kLatBar32);
  wide_barrier_probe<<<1, 512, 0>>>(out, reps, kLatBar512);
  const int clusters[4] = {2, 4, 8, 4};
  const int slots[4] = {kLatCluster2, kLatCluster4, kLatCluster8,
                        kLatRemote4};
  for (int j = 0; j < 4; ++j) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)clusters[j], 1u, 1u);
    cfg.blockDim = dim3(512u, 1u, 1u);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)clusters[j];
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(&cfg, wide_cluster_probe, out,
                                              reps, slots[j], j == 3 ? 1 : 0);
    if (rc != cudaSuccess) return (int)rc;
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
#endif  // MISO_B2W_CLOCKS
