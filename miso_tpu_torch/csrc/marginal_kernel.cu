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
// What bounds it: each step of a lane is a serial chain of scalar work --
// 2*C*I products for the proposed score, C logs, ~2*I exps and logs, two
// proposal densities, I/2 Philox calls for the normals and one for the
// accept draw -- and the 5,000 steps of a chain depend on each other.  The
// only parallelism is across the E*K lanes (12,288 at E=2048, K=6), so
// the kernel is latency bound, not bandwidth bound: the (E, C, I) weights
// of a chunk are a few hundred KB and stay in L1/L2.
// Design: one thread per lane, the K chains of an event on neighbouring
// threads, so their reads of the event's W and counts hit the same cache
// lines.  W is read through the read-only cache and never staged in
// shared memory, so any class count C works (CLASSES events can have tens
// of classes).  The current joint score and log psi are carried from the
// accepted state: the TPU kernel recomputes them every step only because
// carrying froze 3-isoform chains under Mosaic; they are the same function
// of the same psi, so the chain does not change.
//
// Build: this file is compiled with -fmad=false (kernels.py): no a*b + c is
// contracted into an FMA, since the plain version rounds every product and
// sum on its own and the two must take the same accept decisions.  Every
// sum runs in a fixed order, over classes and over isoforms in ascending
// index, as the plain version's does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Loops over the isoforms (and the I/2 normal pairs) unroll fully up to
// I = 64.  The 128- and 256-wide instances keep their per-isoform arrays
// in local memory either way, and unrolled they took ptxas minutes to
// build, so their loops stay rolled: "#pragma unroll (I > 64 ? 1 : I)".

constexpr float kFixedU = 0.4999f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kTiny = 1e-38f;
constexpr float kTwoM24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoM23 = 1.1920928955078125e-07f;  // 2^-23

// Philox counter word 3: which draw of a step the bits feed.
constexpr uint32_t kNormals = 1, kAccept = 2;

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
  uint32_t k0, k1;
  int fixed_u;
};

// Philox4x32-10, the generator of reassign_kernel.cu: counter c, 64-bit
// key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// [0, 1) at 23 bits, as the TPU kernel's _u01.
__device__ __forceinline__ float u01(uint32_t b) {
  return (float)(b & 0x7FFFFFu) * kTwoM23;
}

// Record after 0-based step m iff m+1 > burn_in and
// (m+1 - burn_in) % lag == 0 (miso_tpu/sampler/mcmc.py schedule).
__device__ __forceinline__ bool is_record(int m, const Params& p) {
  return m < p.iters && m + 1 > p.burn_in && (m + 1 - p.burn_in) % p.lag == 0;
}

// masks of an event with k real isoforms: the k-1 head isoforms carry the
// alpha coordinates, isoform k-1 is the last one
__device__ __forceinline__ float head(int i, int k) {
  return i < k - 1 ? 1.f : 0.f;
}
__device__ __forceinline__ float last(int i, int k) {
  return i == k - 1 ? 1.f : 0.f;
}

// (I,) standard normals by Box-Muller.  With Philox the cos/sin pair of
// one radius fills rows j and j + H; in fixed-uniform mode every row is
// r*cos(2*pi*u), as the TPU kernel's cos-only _normal((I, B)) gives.
template <int I>
__device__ __forceinline__ void normals(const Params& p, uint32_t lane,
                                        uint32_t step, float z[I]) {
  constexpr int H = (I + 1) / 2;
#pragma unroll (I > 64 ? 1 : I)
  for (int j = 0; j < H; ++j) {
    float u1 = kFixedU, u2 = kFixedU;
    if (!p.fixed_u) {
      const uint4 b = philox4x32_10(make_uint4(lane, step, j, kNormals),
                                    p.k0, p.k1);
      u1 = u01(b.x);
      u2 = u01(b.y);
    }
    const float r = sqrtf(-2.0f * logf(fmaxf(u1, kTwoM24)));
    const float ang = kTwoPi * u2;
    z[j] = r * cosf(ang);
    if (j + H < I) z[j + H] = p.fixed_u ? z[j] : r * sinf(ang);
  }
}

// alpha -> psi: e = exp(alpha) on the head isoforms, head = e / (1 +
// sum e), and the last isoform takes 1 - sum(head) (pallas_marginal.py
// logistic_inv); lp = log max(psi, 1e-38).
template <int I>
__device__ __forceinline__ void logistic_inv(const float alpha[I], int k,
                                             float psi[I], float lp[I]) {
  float e[I];
  float s = 0.f;
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) {
    e[i] = expf(alpha[i]) * head(i, k);
    s = s + e[i];
  }
  const float denom = 1.0f + s;
  float hs = 0.f;
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) {
    e[i] = e[i] / denom;
    hs = hs + e[i];
  }
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) {
    psi[i] = e[i] + last(i, k) * (1.0f - hs);
    lp[i] = logf(fmaxf(psi[i], kTiny));
  }
}

// Joint score: the read term sum_c counts_c * log(s_c), s_c = sum_i W_ci
// psi_i over classes with s_c > 0 (miso.c:272-293), plus the Dirichlet
// term sum_i (h_i - 1) log psi_i over the real isoforms and dir_const.
template <int I>
__device__ __forceinline__ float joint_score(const float* w, const float* cnt,
                                             int C, const float psi[I],
                                             const float lp[I],
                                             const float h1[I], int k,
                                             float dir_const) {
  float rt = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* wc = w + (size_t)c * I;
    float s = 0.f;
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i) s = s + __ldg(wc + i) * psi[i];
    if (s > 0.f) rt = rt + __ldg(cnt + c) * logf(fmaxf(s, kTiny));
  }
  float ds = 0.f;
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i)
    if (i < k) ds = ds + h1[i] * lp[i];
  return rt + (ds + dir_const);
}

// log q(psi | mu): the logistic-normal proposal density with diagonal
// sigma (miso.c:97-122, pallas_marginal.py proposal_score).
template <int I>
__device__ __forceinline__ float proposal_score(const float psi[I],
                                                const float lp[I],
                                                const float mu[I], int k,
                                                float inv_sigma,
                                                float prop_const) {
  float lth = 0.f;
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) lth = lth + psi[i] * last(i, k);
  const float lt = logf(fmaxf(lth, kTiny));
  float slp = 0.f, ss = 0.f;
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) {
    const bool h = i < k - 1;
    const float a = h ? lp[i] : 0.f;
    const float t = h ? (a - lt) - mu[i] : 0.f;
    slp = slp + a;
    ss = ss + t * t;
  }
  return ((prop_const - slp) - lt) + (-0.5f * ss) * inv_sigma;
}

template <int I>
__global__ void __launch_bounds__(128) marginal_kernel(const Params p) {
  const int lane = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (lane >= p.E * p.K) return;
  const int e = lane / p.K;
  const int k = p.num_iso[e];
  const float* w = p.weights + (size_t)e * p.C * I;
  const float* cnt = p.counts + (size_t)e * p.C;
  const float ns = p.scal[4 * e];
  const float inv_sigma = p.scal[4 * e + 1];
  const float prop_const = p.scal[4 * e + 2];
  const float dir_const = p.scal[4 * e + 3];
  float h1[I];
  float km1 = 0.f;
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) {
    h1[i] = i < k ? p.hyper[(size_t)e * I + i] - 1.0f : 0.f;
    km1 = km1 + head(i, k);
  }

  // start (miso.c:348-371 AUTO, :405-409 GIVEN), then one proposal
  // (miso.c:834)
  float alpha[I], z[I], psi[I], lp[I];
  if (p.start != nullptr) {
    const float* sp = p.start + (size_t)lane * I;
    float sl = 0.f;
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i) sl = sl + sp[i] * last(i, k);
    const float lsl = logf(fmaxf(sl, 1e-30f));
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i)
      alpha[i] = i < k - 1 ? logf(fmaxf(sp[i], 1e-30f)) - lsl : 0.f;
  } else {
    const float a0 = km1 == 1.0f ? 0.f : 1.0f / fmaxf(km1, 1.0f);
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i) alpha[i] = i < k - 1 ? a0 : 0.f;
  }
  normals<I>(p, (uint32_t)lane, 0u, z);
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) alpha[i] = alpha[i] + ns * z[i] * head(i, k);
  logistic_inv<I>(alpha, k, psi, lp);
  float cjs = joint_score<I>(w, cnt, p.C, psi, lp, h1, k, dir_const);

  int accepted = 0, rec = 0;
  for (int m = 0; m < p.iters; ++m) {
    const uint32_t step = (uint32_t)m + 1u;
    float an[I], pn[I], lpn[I];
    normals<I>(p, (uint32_t)lane, step, z);
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i) an[i] = alpha[i] + ns * z[i] * head(i, k);
    logistic_inv<I>(an, k, pn, lpn);
    const float pjs = joint_score<I>(w, cnt, p.C, pn, lpn, h1, k, dir_const);
    // iteration 0 drops the proposal correction (pallas_marginal.py:146)
    const float pto_c = proposal_score<I>(psi, lp, an, k, inv_sigma,
                                          prop_const);
    const float cto_p = proposal_score<I>(pn, lpn, alpha, k, inv_sigma,
                                          prop_const);
    const float full = m > 0 ? 1.f : 0.f;
    const float logr = (pjs - cjs) + full * (pto_c - cto_p);
    float u = kFixedU;
    if (!p.fixed_u)
      u = u01(philox4x32_10(make_uint4((uint32_t)lane, step, 0u, kAccept),
                            p.k0, p.k1).x);
    u = fmaxf(u, kTwoM24);
    if (logr >= 0.f || logf(u) < logr) {
#pragma unroll (I > 64 ? 1 : I)
      for (int i = 0; i < I; ++i) {
        alpha[i] = an[i];
        psi[i] = pn[i];
        lp[i] = lpn[i];
      }
      cjs = pjs;
      ++accepted;
    }
    if (is_record(m, p) && rec < p.rrec) {
      // the absolute joint score of the state after this step
      const size_t o = ((size_t)e * p.rrec + rec) * p.K + (lane - e * p.K);
#pragma unroll (I > 64 ? 1 : I)
      for (int i = 0; i < I; ++i) p.psi_out[o * I + i] = psi[i];
      p.loglik_out[o] = cjs;
      ++rec;
    }
  }
  p.acc_out[lane] = accepted;
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) p.final_psi[(size_t)lane * I + i] = psi[i];
}

}  // namespace

extern "C" int miso_marginal(
    const float* weights, const float* counts, const int* num_iso,
    const float* hyper, const float* scal, const float* start,
    float* psi_out, float* loglik_out, int* acc_out, float* final_psi, int E,
    int C, int I, int K, int iters, int burn_in, int lag, int rrec,
    unsigned int seed_lo, unsigned int seed_hi, int fixed_u, void* stream) {
  const Params p{weights, counts, num_iso, hyper, scal, start, psi_out,
                 loglik_out, acc_out, final_psi, E, C, K, iters, burn_in,
                 lag, rrec, seed_lo, seed_hi, fixed_u};
  const long long lanes = (long long)E * K;
  if (lanes == 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (I) {
    case 2: marginal_kernel<2><<<blocks, threads, 0, s>>>(p); break;
    case 3: marginal_kernel<3><<<blocks, threads, 0, s>>>(p); break;
    case 4: marginal_kernel<4><<<blocks, threads, 0, s>>>(p); break;
    case 6: marginal_kernel<6><<<blocks, threads, 0, s>>>(p); break;
    case 8: marginal_kernel<8><<<blocks, threads, 0, s>>>(p); break;
    case 16: marginal_kernel<16><<<blocks, threads, 0, s>>>(p); break;
    case 32: marginal_kernel<32><<<blocks, threads, 0, s>>>(p); break;
    case 64: marginal_kernel<64><<<blocks, threads, 0, s>>>(p); break;
    case 128: marginal_kernel<128><<<blocks, threads, 0, s>>>(p); break;
    case 256: marginal_kernel<256><<<blocks, threads, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
