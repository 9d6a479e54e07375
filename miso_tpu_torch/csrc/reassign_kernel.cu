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
// What bounds it: each step of each lane draws R uniforms (one
// Philox4x32-10 call per 4 reads) and walks R reads' I cumulative weights
// with compares -- integer and FP32 ALU work over R reads, no tensor-core
// work.  The (E, R, I) read tiles of a chunk are a few MB and stay in L2.
// Design: one warp per lane (2,000 events x 6 chains = 12k warps, 384k
// threads; one thread per lane would fill under 5% of the card's thread
// slots).  The warp's threads split the reads four at a time, count their
// reads per isoform, and a shuffle reduction gives every thread the same
// counts; each thread then runs the I-wide proposal and MH math
// redundantly, so no broadcast is needed.  Records go straight into the
// (E, RREC, K, I) result layout.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Loops over the isoforms (and the I/2 normal pairs) unroll fully up to
// I = 64.  The 128- and 256-wide instances keep their per-isoform arrays
// in local memory either way, and unrolled they took ptxas minutes to
// build, so their loops stay rolled: "#pragma unroll (I > 64 ? 1 : I)".

constexpr float kFixedU = 0.4999f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kNegBig = -1e30f;
constexpr float kTiny = 1e-38f;
constexpr float kTwoM24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoM23 = 1.1920928955078125e-07f;  // 2^-23

// Philox counter word 3: which draw of a step the bits feed.
constexpr uint32_t kReads = 0, kNormals = 1, kAccept = 2;

struct Params {
  const float* read_w;       // (E, R, I)
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
  uint32_t k0, k1;
  int fixed_u;
};

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

// [0, 1) at 23 bits, as the TPU kernel's _u01 (proposal and MH draws).
__device__ __forceinline__ float u01(uint32_t b) {
  return (float)(b & 0x7FFFFFu) * kTwoM23;
}

// (0, 1) strictly, for the Gibbs draws: an odd 24-bit numerator.  A zero
// draw would land a read on a leading zero-weight isoform.
__device__ __forceinline__ float u01_open(uint32_t b) {
  return (float)((b >> 8) | 1u) * kTwoM24;
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every thread ends with the bitwise-same sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Record after 0-based step m iff m+1 > burn_in and
// (m+1 - burn_in) % lag == 0 (miso_tpu/sampler/mcmc.py schedule).
__device__ __forceinline__ bool is_record(int m, const Params& p) {
  return m < p.iters && m + 1 > p.burn_in && (m + 1 - p.burn_in) % p.lag == 0;
}

// (I,) standard normals sharing one Box-Muller radius per cos/sin pair:
// rows [0, H) take r*cos, rows [H, I) r*sin (pallas_kernel._normal_rows).
template <int I>
__device__ __forceinline__ void normal_rows(const Params& p, uint32_t lane,
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
    if (j + H < I) z[j + H] = r * sinf(ang);
  }
}

// alpha -> (psi, log denom, log S) with e = exp(alpha) on the head
// isoforms, denom = 1 + sum(e), psi = (e + last) / denom and
// S = sum((e + last) * efflen).
template <int I>
__device__ __forceinline__ void stats(const float alpha[I], const float am[I],
                                      const float last[I], const float eiw[I],
                                      float psi[I], float& ld, float& logS) {
  float e[I];
  float s = 0.f;
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) {
    e[i] = expf(alpha[i]) * am[i];
    s += e[i];
  }
  const float denom = 1.0f + s;
  ld = logf(fmaxf(denom, kTiny));
  float S = 0.f;
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) {
    const float ea = e[i] + last[i];
    psi[i] = ea / denom;
    S += ea * eiw[i];
  }
  logS = logf(fmaxf(S, kTiny));
}

// Per-read Gibbs draw: read r takes the first isoform i < I-1 whose
// cumulative weight reaches u_r * total, else the last one.  Reads with
// all-zero weights (padding) count into no isoform.  n gets the counts,
// rp the read score (only when a record will read it).
template <int I>
__device__ __forceinline__ void gibbs(const Params& p, const float* rw,
                                      const float* rl, uint32_t lane,
                                      uint32_t step, const float psi[I],
                                      bool want_rp, float n[I], float& rp) {
  float cnt[I];
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) cnt[i] = 0.f;
  float acc_rp = 0.f;
  const int groups = (p.R + 3) >> 2;
  for (int g = threadIdx.x & 31; g < groups; g += 32) {
    uint4 b = make_uint4(0u, 0u, 0u, 0u);
    if (!p.fixed_u)
      b = philox4x32_10(make_uint4(lane, step, (uint32_t)g, kReads), p.k0,
                        p.k1);
    const uint32_t bits[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * g + j;
      if (r >= p.R) break;
      const float* w = rw + (size_t)r * I;
      float c[I];
      float acc = 0.f, wsum = 0.f;
#pragma unroll (I > 64 ? 1 : I)
      for (int i = 0; i < I; ++i) {
        const float wi = w[i];
        wsum += wi;
        // no FMA contraction: the plain version multiplies, then sums
        acc = __fadd_rn(acc, __fmul_rn(wi, psi[i]));
        c[i] = acc;
      }
      if (!(wsum > 0.f)) continue;
      const float u = (p.fixed_u ? kFixedU : u01_open(bits[j])) * acc;
      int ch = I - 1;
#pragma unroll (I > 64 ? 1 : I)
      for (int i = I - 2; i >= 0; --i)
        if (c[i] >= u) ch = i;
#pragma unroll (I > 64 ? 1 : I)
      for (int i = 0; i < I; ++i) cnt[i] += (ch == i) ? 1.f : 0.f;
      if (want_rp) acc_rp += rl[(size_t)r * I + ch];
    }
  }
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) n[i] = warp_sum(cnt[i]);
  rp = want_rp ? warp_sum(acc_rp) : 0.f;
}

template <int I>
__global__ void __launch_bounds__(128) reassign_kernel(const Params p) {
  const int warp = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
  if (warp >= p.E * p.K) return;  // whole warps only: blockDim % 32 == 0
  const int e = warp / p.K;
  const int k = warp - e * p.K;
  const bool leader = (threadIdx.x & 31) == 0;
  const uint32_t lane = (uint32_t)warp;
  const float* rw = p.read_w + (size_t)e * p.R * I;
  const float* rl = p.read_ls + (size_t)e * p.R * I;

  // per-event constants (efflen, log efflen, hyper - 1 on real isoforms)
  float am[I], last[I], eiw[I], aliw[I], h1[I];
  float km1 = 0.f, H1 = 0.f;
#pragma unroll (I > 64 ? 1 : I)
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
  for (int r = threadIdx.x & 31; r < p.R; r += 32) {
    float s = 0.f;
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i) s += rw[(size_t)r * I + i];
    nv += s > 0.f ? 1.f : 0.f;
  }
  const float n_valid = warp_sum(nv);

  // start (miso.c:348-371 AUTO, :405-409 GIVEN), then one proposal and
  // the initial Gibbs draw (miso.c:834-843)
  float alpha[I], z[I];
  if (p.start != nullptr) {
    const float* sp = p.start + ((size_t)e * p.K + k) * I;
    float sl = 0.f;
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i) sl += sp[i] * last[i];
    const float lsl = logf(fmaxf(sl, 1e-30f));
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i)
      alpha[i] = am[i] > 0.f ? logf(fmaxf(sp[i], 1e-30f)) - lsl : 0.f;
  } else {
    const float a0 = km1 == 1.0f ? 0.f : 1.0f / fmaxf(km1, 1.0f);
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i) alpha[i] = am[i] > 0.f ? a0 : 0.f;
  }
  normal_rows<I>(p, lane, 0u, z);
#pragma unroll (I > 64 ? 1 : I)
  for (int i = 0; i < I; ++i) alpha[i] += ns * z[i] * am[i];
  float psi[I], n[I], ld, logS, rp;
  stats<I>(alpha, am, last, eiw, psi, ld, logS);
  gibbs<I>(p, rw, rl, lane, 0u, psi, is_record(0, p), n, rp);

  int accepted = 0, rec = 0;
  for (int m = 0; m < p.iters; ++m) {
    const uint32_t step = (uint32_t)m + 1u;
    float d[I], an[I], pn[I], ldn, logSn;
    normal_rows<I>(p, lane, step, z);
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i) {
      d[i] = ns * z[i] * am[i];
      an[i] = alpha[i] + d[i];
    }
    stats<I>(an, am, last, eiw, pn, ldn, logSn);
    // MH log-ratio in alpha space: the proposal quadratic and the read
    // score cancel; iteration 0 drops the proposal correction
    float s1 = 0.f, sd = 0.f;
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i) {
      s1 += (n[i] + h1[i]) * d[i];
      sd += d[i];
    }
    const float full = m > 0 ? 1.f : 0.f;
    const float logr = s1 - n_valid * (logSn - logS) - H1 * (ldn - ld) +
                       full * (sd + kk * (ld - ldn));
    float u = kFixedU;
    if (!p.fixed_u)
      u = u01(philox4x32_10(make_uint4(lane, step, 0u, kAccept), p.k0, p.k1).x);
    u = fmaxf(u, kTwoM24);
    if (logr >= 0.f || logf(u) < logr) {
#pragma unroll (I > 64 ? 1 : I)
      for (int i = 0; i < I; ++i) {
        alpha[i] = an[i];
        psi[i] = pn[i];
      }
      ld = ldn;
      logS = logSn;
      ++accepted;
    }
    if (is_record(m, p) && rec < p.rrec) {
      // joint score (miso.c:243-307) with the n and read score from
      // before this step's Gibbs draw
      float t = 0.f;
#pragma unroll (I > 64 ? 1 : I)
      for (int i = 0; i < I; ++i)
        t += (n[i] + h1[i]) * (alpha[i] * am[i]) + n[i] * aliw[i];
      const float score = rp + t - n_valid * logS - H1 * ld + dir_const;
      if (leader) {
        const size_t o = ((size_t)e * p.rrec + rec) * p.K + k;
#pragma unroll (I > 64 ? 1 : I)
        for (int i = 0; i < I; ++i) p.psi_out[o * I + i] = psi[i];
        p.loglik_out[o] = score;
      }
      ++rec;
    }
    gibbs<I>(p, rw, rl, lane, step, psi, is_record(m + 1, p), n, rp);
  }
  if (leader) {
    p.acc_out[warp] = accepted;
#pragma unroll (I > 64 ? 1 : I)
    for (int i = 0; i < I; ++i) {
      p.final_n[(size_t)warp * I + i] = n[i];
      p.final_psi[(size_t)warp * I + i] = psi[i];
    }
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
    int fixed_u, void* stream) {
  const Params p{read_w, read_ls, log_iso_w, hyper, amask, iso_mask,
                 last_onehot, scal, start, psi_out, loglik_out, acc_out,
                 final_n, final_psi, E, R, K, iters, burn_in, lag, rrec,
                 seed_lo, seed_hi, fixed_u};
  const long long lanes = (long long)E * K;
  if (lanes == 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((lanes * 32 + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (I) {
    case 2: reassign_kernel<2><<<blocks, threads, 0, s>>>(p); break;
    case 3: reassign_kernel<3><<<blocks, threads, 0, s>>>(p); break;
    case 4: reassign_kernel<4><<<blocks, threads, 0, s>>>(p); break;
    case 6: reassign_kernel<6><<<blocks, threads, 0, s>>>(p); break;
    case 8: reassign_kernel<8><<<blocks, threads, 0, s>>>(p); break;
    case 16: reassign_kernel<16><<<blocks, threads, 0, s>>>(p); break;
    case 32: reassign_kernel<32><<<blocks, threads, 0, s>>>(p); break;
    case 64: reassign_kernel<64><<<blocks, threads, 0, s>>>(p); break;
    case 128: reassign_kernel<128><<<blocks, threads, 0, s>>>(p); break;
    case 256: reassign_kernel<256><<<blocks, threads, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* miso_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
