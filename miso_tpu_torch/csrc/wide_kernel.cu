// Wide-lane REASSIGN (B1w) and MARGINAL/CLASSES (B2w) samplers for Hopper
// (sm_90a): one (event, chain) lane a block, its isoforms over the block's
// threads, the isoform width I an argument of the launch.
//
// B1w replaces miso_tpu/sampler/pallas_kernel.py::_sampler_kernel and B2w
// miso_tpu/sampler/pallas_marginal.py::_marginal_kernel for every bucket
// of at least WIDE_FROM isoforms (sampler/wide.py), of any width.  They
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
// - A lane is a block of `threads` (32 ... 512, wide_plan) threads.  Its
//   I-wide arrays (alpha, psi, the proposal's normals, efflen terms, hyper
//   - 1, the counts, the terms summed each step) lie once in dynamic
//   shared memory, or, past the block's limit (227 KB: from 5,761
//   isoforms for B1w), in a global scratch buffer the wrapper allocates.
//   No width is too wide.
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
// - B1w's Gibbs draw is warp-cooperative: a warp takes a group of four
//   reads (one Philox call keyed by the group, as in B1) and walks them
//   side by side.  A chunk's cumulative weights are a lane's running sum
//   of its four w * psi, a warp scan (shuffles up) of the lanes' sums,
//   and the chunks before it carried in order; a first pass sums the
//   read to its total (a lane's chunks, then a butterfly: no scan), a
//   second walks the chunks again to the first isoform that reaches
//   u * total, found by a ballot, and stops there: the inverse CDF in
//   isoform order.  The reads' (R, I) tile stays in global memory, read
//   in whole chunks through L1; the counts are integers added by shared
//   atomics, so their order is free.  A lane is one SM, and its step is
//   bound by the instructions that SM issues: ~50 shuffles and two
//   passes a group (PERF.md).
// - B2w's warps split the classes (two at a time), the lanes of a warp
//   a class row's isoforms.
// - Randoms: B1's and B2's Philox counters, (lane, step, pair j,
//   kNormals), (lane, step, 0, kAccept) and (lane, step, group,
//   kReads): the wide form draws the stream of the instance it replaced;
//   a thread draws the normal pairs it owns.
//
// Build: -fmad=false (kernels.py), as marginal_kernel.cu: every product
// and sum rounds on its own, as in the plain versions.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFixedU = 0.4999f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kNegBig = -1e30f;
constexpr float kTiny = 1e-38f;
constexpr float kTwoM24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoM23 = 1.1920928955078125e-07f;  // 2^-23
constexpr unsigned kFull = 0xffffffffu;

// Philox counter word 3: which draw of a step the bits feed.
constexpr uint32_t kReads = 0, kNormals = 1, kAccept = 2;

// The plan's constants (wide.py: WIDE_THREADS, HEAD_FLOATS,
// REASSIGN_ARRAYS, MARGINAL_ARRAYS, MAX_SHARED).
constexpr int kMaxThreads = 512;
constexpr int kHeadFloats = 64;  // a lane's scalars, ahead of its arrays
constexpr int kReassignArrays = 10;
constexpr int kMarginalArrays = 11;
constexpr int kMaxShared = 232448;

// The head: sums of a phase, and 32 partial sums (per warp, or the read
// score's 32 slots).
constexpr int kSums = 0, kParts = 32;

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

// sums[r] = the sum of xs[r] (128 nc[r] floats) for r < n: slot (warp lane)
// l adds isoforms 128 c + 4 l + q in (c, q) order, then a butterfly over
// the 32 slots.  Warp w takes r = w, w + warps, ...  The caller syncs
// before (inputs written) and after (sums read).
__device__ __forceinline__ void slot_sums(const float* const* xs, int n,
                                          const int* nc, float* sums) {
  const int warps = (int)blockDim.x >> 5, w = (int)threadIdx.x >> 5;
  const int l = (int)threadIdx.x & 31;
  for (int r = w; r < n; r += warps) {
    const float* x = xs[r];
    float v = 0.f;
    for (int c = 0; c < nc[r]; ++c) {
      const float4 f = four(x, 128 * c + 4 * l);
      v = v + f.x;
      v = v + f.y;
      v = v + f.z;
      v = v + f.w;
    }
    for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
    if (l == 0) sums[r] = v;
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
  const float* read_w;     // (E, R, I), R % 4 == 0
  const float* read_ls;    // (E, R, I)
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
  int E, R, I, K, iters, burn_in, lag, rrec;
  Keys keys;
  int fixed_u;
  // a Gibbs uniform is bits * u_scale + u_shift: (2^-24, 0), or
  // (0, 0.4999f) under fixed_u
  float u_scale, u_shift;
  int nc, lane_floats;  // chunks of I; a lane's floats
  int vec;  // rows of 16-byte pieces: I % 4 == 0 and read_w aligned
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

// A chunk of a group's four reads: each lane's running sums loc of its
// four w * psi, and the warp's inclusive scan incl of the lanes' sums.
__device__ __forceinline__ void chunk_scan(const float* row, int I, int i0,
                                           bool vec, const float* psi,
                                           float loc[4][4], float incl[4]) {
  const int l = (int)threadIdx.x & 31;
  const float4 ps = four(psi, i0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float wv[4];
    load4(row + (size_t)j * I, i0, I, vec, wv);
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
}

// One Gibbs sweep over the event's reads at psi: cnt gets the counts
// (integers: a read that no isoform can take counts nowhere), and the
// return value is the read score when RP (a record will read it), else 0.
// A read's cumulative weight at isoform 128 c + 4 l + q is carry_c +
// (excl_l + loc_q): the chunks' totals carried in order, the lane's
// exclusive scan, its running sum; its total is each lane's sums over
// the chunks, added by a butterfly (wide.wide_cumsum).  The read score,
// too, is summed in one order whatever the block: group of four reads g
// adds into slot g % 32 (warp w takes the groups, and so the slots, w,
// w + warps, ...: lane m of warp w keeps slot w + warps m), in ascending
// g, then a butterfly over the slots.  Ends with the block synchronised.
template <bool RP>
__device__ float reassign_gibbs(const ReassignParams& p, int e,
                                uint32_t lane, uint32_t step,
                                const float* psi, int* cnt, float* head) {
  const int I = p.I, nc = p.nc;
  for (int x = (int)threadIdx.x; x < 128 * nc; x += (int)blockDim.x)
    cnt[x] = 0;
  __syncthreads();
  const int warps = (int)blockDim.x >> 5, w = (int)threadIdx.x >> 5;
  const int l = (int)threadIdx.x & 31;
  const bool vec = p.vec != 0;
  const float* rw = p.read_w + (size_t)e * p.R * I;
  const float* rl = p.read_ls + (size_t)e * p.R * I;
  const int slots = 32 / warps;  // read-score slots of a warp
  float rp = 0.f;
  for (int g = w, turn = 0; g < (p.R >> 2); g += warps, ++turn) {
    const uint4 b =
        philox4x32_10(make_uint4(lane, step, (uint32_t)g, kReads), p.keys);
    const float u[4] = {gibbs_uniform(b.x, p), gibbs_uniform(b.y, p),
                        gibbs_uniform(b.z, p), gibbs_uniform(b.w, p)};
    const float* row = rw + (size_t)(4 * g) * I;
    // the reads' totals: a lane's sums of its four, chunk after chunk,
    // then a butterfly over the lanes
    float total[4] = {0.f, 0.f, 0.f, 0.f};
    bool any[4] = {false, false, false, false};
    for (int c = 0; c < nc; ++c) {
      const int i0 = 128 * c + 4 * l;
      const float4 ps = four(psi, i0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float wv[4];
        load4(row + (size_t)j * I, i0, I, vec, wv);
        float a = wv[0] * ps.x;
        a = a + wv[1] * ps.y;
        a = a + wv[2] * ps.z;
        a = a + wv[3] * ps.w;
        total[j] = total[j] + a;
        any[j] = any[j] || wv[0] > 0.f || wv[1] > 0.f || wv[2] > 0.f ||
                 wv[3] > 0.f;
      }
    }
    float loc[4][4], incl[4], target[4], carry[4] = {0.f, 0.f, 0.f, 0.f};
    bool valid[4];
    int found[4] = {-1, -1, -1, -1};  // the same on every lane
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        total[j] = total[j] + __shfl_xor_sync(kFull, total[j], o);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      valid[j] = __any_sync(kFull, any[j]);
      target[j] = u[j] * total[j];
    }
    // the first isoform i < I - 1 whose cumulative weight reaches the
    // read's target, chunk by chunk until each read has one
    for (int c = 0; c < nc; ++c) {
      if (found[0] >= 0 && found[1] >= 0 && found[2] >= 0 && found[3] >= 0)
        break;
      const int i0 = 128 * c + 4 * l;
      chunk_scan(row, I, i0, vec, psi, loc, incl);
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
      const int ch = found[j] >= 0 ? found[j] : I - 1;
      if (l == 0 && valid[j]) atomicAdd(&cnt[ch], 1);
      if (RP && valid[j] && l == turn % slots)
        rp = rp + rl[(size_t)(4 * g + j) * I + ch];
    }
  }
  if (RP && l < slots) head[kParts + w + warps * l] = rp;
  __syncthreads();
  if (!RP) return 0.f;
  // every warp adds the 32 slots alike
  float total = head[kParts + l];
  for (int o = 16; o > 0; o >>= 1)
    total = total + __shfl_xor_sync(kFull, total, o);
  return total;
}

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
  // the reads that some isoform can take: a warp a read
  {
    const int warps = nt >> 5, w = tid >> 5, l = tid & 31;
    const float* rw = p.read_w + (size_t)e * p.R * I;
    int nv = 0;
    for (int r = w; r < p.R; r += warps) {
      bool any = false;
      for (int i = l; i < I; i += 32) any = any || rw[(size_t)r * I + i] > 0.f;
      nv += __any_sync(kFull, any) ? 1 : 0;
    }
    if (l == 0) head[kParts + w] = (float)nv;
  }
  reassign_normals(p, lane, 0u, d);
  __syncthreads();
  float n_valid = 0.f;
  for (int v = 0; v < (nt >> 5); ++v) n_valid = n_valid + head[kParts + v];
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
  float rp = (next_rec == 0 && p.iters > 0)
                 ? reassign_gibbs<true>(p, e, lane, 0u, psi, cnt, head)
                 : reassign_gibbs<false>(p, e, lane, 0u, psi, cnt, head);

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
             ? reassign_gibbs<true>(p, e, lane, step, psi, cnt, head)
             : reassign_gibbs<false>(p, e, lane, step, psi, cnt, head);
  }
  if (tid == 0) p.acc_out[lane_i] = accepted;
  for (int i = tid; i < I; i += nt) {
    p.final_n[(size_t)lane_i * I + i] = (float)cnt[i];
    p.final_psi[(size_t)lane_i * I + i] = psi[i];
  }
}

// ---------------------------------------------------------------- B2w
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
  float* scratch;        // lane arrays, or null: in shared memory
  int E, C, I, K, iters, burn_in, lag, rrec;
  Keys keys;
  int fixed_u;
  int nc, ncc, lane_floats;  // chunks of I and of C; a lane's floats
  int vec;  // rows of 16-byte pieces: I % 4 == 0 and weights aligned
};

// The (I,) proposal normals of a step into z, as B2 draws them: with
// Philox pair j's radius gives isoform j r cos and isoform j + H r sin
// (0 past the head isoforms); under fixed_u every head row is r cos, as
// the TPU kernel's cos-only _normal gives.
__device__ __forceinline__ void marginal_normals(const MarginalParams& p,
                                                 int k, uint32_t lane,
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
    const float c = r * cosf(ang);
    z[j] = c;
    if (j + H < p.I) {
      float s = 0.f;
      if (j + H < k - 1) s = p.fixed_u ? c : r * sinf(ang);
      z[j + H] = s;
    }
  }
}

// psi and log psi of alpha a (pallas_marginal.py logistic_inv): e =
// exp(a) on the head isoforms, head = e / (1 + sum e), the last isoform
// takes 1 - sum(head); lp = log max(psi, 1e-38) on the real isoforms.
// Also the Dirichlet terms (h - 1) log psi and the head's log psi, for
// the step's sums.  Two sums of its own; ends synchronised.
__device__ __forceinline__ void marginal_psi(int P, int k, const int* nc,
                                             const float* a, const float* h1,
                                             float* psi, float* lp,
                                             float* t_dir, float* t_head,
                                             float* head) {
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  for (int i = tid; i < P; i += nt) psi[i] = i < k - 1 ? expf(a[i]) : 0.f;
  __syncthreads();
  {
    const float* xs[1] = {psi};
    slot_sums(xs, 1, nc, head + kSums + 8);
  }
  __syncthreads();
  const float denom = 1.0f + head[kSums + 8];
  for (int i = tid; i < P; i += nt)
    if (i < k - 1) psi[i] = psi[i] / denom;
  __syncthreads();
  {
    const float* xs[1] = {psi};
    slot_sums(xs, 1, nc, head + kSums + 9);
  }
  __syncthreads();
  const float rest = 1.0f - head[kSums + 9];
  for (int i = tid; i < P; i += nt) {
    const float last = i == k - 1 ? 1.f : 0.f;
    const float v = psi[i] + last * rest;
    const float l = i < k ? logf(fmaxf(v, kTiny)) : 0.f;
    psi[i] = v;
    lp[i] = l;
    t_dir[i] = i < k ? h1[i] * l : 0.f;
    t_head[i] = i < k - 1 ? l : 0.f;
  }
  __syncthreads();
}

// The read term's class terms counts_c log(s_c), s_c = sum_i W_ci psi_i
// (0 where s_c is 0), at their class: a warp a class row (two at once,
// c and c + warps, whose loads and sums overlap), its lanes the chunks'
// isoforms.
__device__ __forceinline__ void marginal_terms(const MarginalParams& p,
                                               int e, const float* psi,
                                               float* term) {
  const int warps = (int)blockDim.x >> 5, w = (int)threadIdx.x >> 5;
  const int l = (int)threadIdx.x & 31;
  const int I = p.I;
  const bool vec = p.vec != 0;
  const float* W = p.weights + (size_t)e * p.C * I;
  for (int c = w; c < p.C; c += 2 * warps) {
    const int c2 = c + warps < p.C ? c + warps : c;
    const float* row = W + (size_t)c * I;
    const float* row2 = W + (size_t)c2 * I;
    float v = 0.f, v2 = 0.f;
    for (int ch = 0; ch < p.nc; ++ch) {
      const int i0 = 128 * ch + 4 * l;
      const float4 ps = four(psi, i0);
      float wv[4], wv2[4];
      load4(row, i0, I, vec, wv);
      load4(row2, i0, I, vec, wv2);
      v = v + wv[0] * ps.x;
      v2 = v2 + wv2[0] * ps.x;
      v = v + wv[1] * ps.y;
      v2 = v2 + wv2[1] * ps.y;
      v = v + wv[2] * ps.z;
      v2 = v2 + wv2[2] * ps.z;
      v = v + wv[3] * ps.w;
      v2 = v2 + wv2[3] * ps.w;
    }
    for (int o = 16; o > 0; o >>= 1) {
      v = v + __shfl_xor_sync(kFull, v, o);
      v2 = v2 + __shfl_xor_sync(kFull, v2, o);
    }
    if (l == 0) {
      const float* cnt = p.counts + (size_t)e * p.C;
      term[c] = v > 0.f ? cnt[c] * logf(fmaxf(v, kTiny)) : 0.f;
      if (c2 != c)
        term[c2] = v2 > 0.f ? cnt[c2] * logf(fmaxf(v2, kTiny)) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    marginal_wide_kernel(const MarginalParams p) {
  extern __shared__ __align__(16) float smem[];
  const int lane_i = (int)blockIdx.x;
  const int e = lane_i / p.K;
  const uint32_t lane = (uint32_t)lane_i;
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  const int I = p.I, P = 128 * p.nc, PC = 128 * p.ncc;
  float* head = p.scratch != nullptr
                    ? p.scratch + (size_t)lane_i * p.lane_floats
                    : smem;
  // the current state and the proposal's swap places on an accept
  float* alpha = head + kHeadFloats;
  float* psi = alpha + P;
  float* lp = psi + P;
  float* h1 = lp + P;
  float* an = h1 + P;
  float* pn = an + P;
  float* lpn = pn + P;
  float* t_dir = lpn + P;     // the step's normals, then (h - 1) log psi'
  float* t_head = t_dir + P;  // log psi' on the head isoforms
  float* t_cp = t_head + P;   // the two proposal quadratics' terms
  float* t_pc = t_cp + P;
  float* term = t_pc + P;     // PC classes
  // the chunks of each sum of a step: the class terms', then I's
  const int nc[5] = {p.ncc, p.nc, p.nc, p.nc, p.nc};

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
  }
  for (int c = tid; c < PC; c += nt) term[c] = 0.f;
  marginal_normals(p, k, lane, 0u, t_dir);
  __syncthreads();
  // one proposal from the start (miso.c:834)
  for (int i = tid; i < P; i += nt) {
    const float hd = i < k - 1 ? 1.f : 0.f;
    const float z = i < I ? t_dir[i] : 0.f;
    alpha[i] = alpha[i] + ns * z * hd;
  }
  __syncthreads();
  const float log_tiny = logf(kTiny);
  marginal_psi(P, k, nc + 1, alpha, h1, psi, lp, t_dir, t_head, head);
  marginal_terms(p, e, psi, term);
  __syncthreads();
  {
    const float* xs[3] = {term, t_dir, t_head};
    slot_sums(xs, 3, nc, head + kSums);
  }
  __syncthreads();
  float cjs = head[kSums] + (head[kSums + 1] + dir_const);
  float lt = k > 0 ? lp[k - 1] : log_tiny;
  float base = (prop_const - head[kSums + 2]) - lt;

  int next_rec = p.burn_in + p.lag - 1;
  int accepted = 0, rec = 0;
  for (int m = 0; m < p.iters; ++m) {
    const uint32_t step = (uint32_t)m + 1u;
    marginal_normals(p, k, lane, step, t_dir);
    __syncthreads();
    for (int i = tid; i < P; i += nt) {
      const float hd = i < k - 1 ? 1.f : 0.f;
      const float z = i < I ? t_dir[i] : 0.f;
      an[i] = alpha[i] + ns * z * hd;
    }
    __syncthreads();
    marginal_psi(P, k, nc + 1, an, h1, pn, lpn, t_dir, t_head, head);
    marginal_terms(p, e, pn, term);
    // the proposal densities' quadratics: log q(psi | alpha') of the
    // current state and log q(psi' | alpha) of the proposal
    // (miso.c:97-122, pallas_marginal.py proposal_score)
    const float ltn = k > 0 ? lpn[k - 1] : log_tiny;
    for (int i = tid; i < P; i += nt) {
      float cp = 0.f, pc = 0.f;
      if (i < k - 1) {
        cp = (lpn[i] - ltn) - alpha[i];
        pc = (lp[i] - lt) - an[i];
      }
      t_cp[i] = cp * cp;
      t_pc[i] = pc * pc;
    }
    __syncthreads();
    {
      const float* xs[5] = {term, t_dir, t_head, t_cp, t_pc};
      slot_sums(xs, 5, nc, head + kSums);
    }
    __syncthreads();
    const float pjs = head[kSums] + (head[kSums + 1] + dir_const);
    const float basen = (prop_const - head[kSums + 2]) - ltn;
    const float pto_c = base + (-0.5f * head[kSums + 4]) * inv_sigma;
    const float cto_p = basen + (-0.5f * head[kSums + 3]) * inv_sigma;
    // iteration 0 drops the proposal correction (pallas_marginal.py:146)
    const float full = m > 0 ? 1.f : 0.f;
    const float logr = (pjs - cjs) + full * (pto_c - cto_p);
    const float log_u = log_accept(p.keys, p.fixed_u, lane, step);
    if (logr >= 0.f || log_u < logr) {
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
      ++accepted;
    }
    if (m == next_rec) {
      next_rec += p.lag;
      if (rec < p.rrec) {
        const size_t o = ((size_t)e * p.rrec + rec) * p.K + (lane_i - e * p.K);
        for (int i = tid; i < I; i += nt) p.psi_out[o * I + i] = psi[i];
        if (tid == 0) p.loglik_out[o] = cjs;
        ++rec;
      }
    }
  }
  if (tid == 0) p.acc_out[lane_i] = accepted;
  for (int i = tid; i < I; i += nt)
    p.final_psi[(size_t)lane_i * I + i] = psi[i];
}

// A lane's floats: the head, the kernel's I-wide arrays (128 chunks(I)
// each), and B2w's class terms (kind 0: B1w, 1: B2w; n the class count
// for B2w).
long long lane_floats(int kind, int n, int I) {
  const long long P = 128LL * chunks(I);
  if (kind == 0) return kHeadFloats + kReassignArrays * P;
  return kHeadFloats + kMarginalArrays * P + 128LL * chunks(n);
}

// The plan's own consistency: a block of whole warps within the bounds,
// and the lane's arrays in shared memory (exactly their size) or in
// scratch (no shared memory).
bool plan_ok(int threads, long long floats, long long shared_bytes,
             const float* scratch) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return false;
  if (scratch != nullptr) return shared_bytes == 0;
  return shared_bytes == floats * 4 && shared_bytes <= kMaxShared;
}

template <class Kernel, class Params>
int launch(Kernel kernel, const Params& p, int blocks, int threads,
           long long shared_bytes, void* stream) {
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, threads, (size_t)shared_bytes,
           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

void set_keys(Keys& k, unsigned int seed_lo, unsigned int seed_hi) {
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = seed_lo + (uint32_t)r * 0x9E3779B9u;
    k.k1[r] = seed_hi + (uint32_t)r * 0xBB67AE85u;
  }
}

}  // namespace

extern "C" long long miso_wide_lane_floats(int kind, int n, int I) {
  return lane_floats(kind, n, I);
}

extern "C" int miso_reassign_wide(
    const float* read_w, const float* read_ls, const float* log_iso_w,
    const float* hyper, const int* num_iso, const float* scal,
    const float* start, float* psi_out, float* loglik_out, int* acc_out,
    float* final_n, float* final_psi, float* scratch, int E, int R, int I,
    int K, int iters, int burn_in, int lag, int rrec, unsigned int seed_lo,
    unsigned int seed_hi, int fixed_u, int threads, long long shared_bytes,
    void* stream) {
  const long long lanes = (long long)E * K;
  if (lanes == 0) return 0;
  const long long floats = lane_floats(0, R, I);
  if (lanes > 0x7fffffffLL || I < 2 || R < 4 || R % 4 != 0 || lag < 1 ||
      !plan_ok(threads, floats, shared_bytes, scratch))
    return (int)cudaErrorInvalidValue;
  ReassignParams p{read_w, read_ls, log_iso_w, hyper, num_iso, scal, start,
                   psi_out, loglik_out, acc_out, final_n, final_psi,
                   scratch, E, R, I, K, iters, burn_in, lag, rrec};
  set_keys(p.keys, seed_lo, seed_hi);
  p.fixed_u = fixed_u;
  p.u_scale = fixed_u ? 0.f : kTwoM24;
  p.u_shift = fixed_u ? kFixedU : 0.f;
  p.nc = chunks(I);
  p.lane_floats = (int)floats;
  p.vec = I % 4 == 0 && reinterpret_cast<uintptr_t>(read_w) % 16 == 0;
  return launch(reassign_wide_kernel, p, (int)lanes, threads, shared_bytes,
                stream);
}

extern "C" int miso_marginal_wide(
    const float* weights, const float* counts, const int* num_iso,
    const float* hyper, const float* scal, const float* start,
    float* psi_out, float* loglik_out, int* acc_out, float* final_psi,
    float* scratch, int E, int C, int I, int K, int iters, int burn_in,
    int lag, int rrec, unsigned int seed_lo, unsigned int seed_hi,
    int fixed_u, int threads, long long shared_bytes, void* stream) {
  const long long lanes = (long long)E * K;
  if (lanes == 0) return 0;
  const long long floats = lane_floats(1, C, I);
  if (lanes > 0x7fffffffLL || I < 2 || C < 1 || lag < 1 ||
      !plan_ok(threads, floats, shared_bytes, scratch))
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
  return launch(marginal_wide_kernel, p, (int)lanes, threads, shared_bytes,
                stream);
}
