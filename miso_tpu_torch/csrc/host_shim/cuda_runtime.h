// The least of the CUDA runtime that the port's kernel sources use, for
// running them on the CPU: tests/test_torch_kernel_source.py compiles
// the *.cu files one directory up with a C++20 host compiler against this
// header (after turning each `kernel<<<grid, block, shared, stream>>>(args)`
// into `shim_launch(kernel, grid, block, shared, args)`) and holds the
// result to the plain PyTorch versions.  A block's threads run as std::threads,
// block after block.  A warp is 32 consecutive threads; a shuffle goes
// through a buffer and a barrier of the warp, so every thread of a warp
// must take every shuffle and vote (the kernels' own rule), and
// `__syncthreads` is a barrier of the block.  Nothing here measures
// anything.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct uint4 { unsigned x, y, z, w; };
struct double2 { double x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct dim3 { unsigned x = 1, y = 1, z = 1; };
static thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return uint4{a, b, c, d};
}
inline double2 make_double2(double x, double y) { return double2{x, y}; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmaf_rn(float a, float b, float c) {
  return std::fmaf(a, b, c);
}
template <class T> inline T __ldg(const T* p) { return *p; }

struct ShimWarp {
  std::barrier<> bar;
  int threads;
  double buf[32];  // a float or a double of each thread
  explicit ShimWarp(int threads_) : bar(threads_), threads(threads_) {}
};
static thread_local ShimWarp* shim_warp;
static thread_local std::barrier<>* shim_block;
static thread_local float* shim_shared;

template <class V>
inline V shim_exchange(V v, int from) {
  shim_warp->buf[threadIdx.x & 31u] = v;
  shim_warp->bar.arrive_and_wait();
  const V r = (V)shim_warp->buf[from];
  shim_warp->bar.arrive_and_wait();
  return r;
}
template <class V>
inline V __shfl_xor_sync(unsigned, V v, int offset, int = 32) {
  return shim_exchange(v, (int)(threadIdx.x & 31u) ^ offset);
}
template <class V>
inline V __shfl_sync(unsigned, V v, int src, int width = 32) {
  const int lane = (int)(threadIdx.x & 31u);
  return shim_exchange(v, (lane & ~(width - 1)) | (src & (width - 1)));
}
inline int __any_sync(unsigned, int pred) {
  shim_warp->buf[threadIdx.x & 31u] = pred ? 1.0 : 0.0;
  shim_warp->bar.arrive_and_wait();
  int any = 0;
  for (int t = 0; t < shim_warp->threads; ++t)
    any |= shim_warp->buf[t] != 0.0;
  shim_warp->bar.arrive_and_wait();
  return any;
}
inline void __syncthreads() { shim_block->arrive_and_wait(); }
// the block's dynamic shared memory (`extern __shared__ ... name[];`)
inline float* shim_dynamic_shared() { return shim_shared; }

template <class Kernel, class... Args>
void shim_launch(Kernel kernel, unsigned blocks, unsigned threads,
                 size_t shared_bytes, Args... args) {
  for (unsigned b = 0; b < blocks; ++b) {
    std::vector<float4> shared(shared_bytes / sizeof(float4) + 1);
    std::barrier<> block_barrier(threads);
    std::vector<std::unique_ptr<ShimWarp>> warps;
    for (unsigned first = 0; first < threads; first += 32)
      warps.emplace_back(new ShimWarp(
          (int)(threads - first < 32 ? threads - first : 32)));
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = threads;
        gridDim.x = blocks;
        shim_warp = warps[t / 32].get();
        shim_block = &block_barrier;
        shim_shared = reinterpret_cast<float*>(shared.data());
        kernel(args...);
      });
    for (auto& th : pool) th.join();
  }
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t code) {
  return code == 0 ? "no error" : "invalid argument";
}
