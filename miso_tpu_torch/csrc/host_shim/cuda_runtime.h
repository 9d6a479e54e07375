// The least of the CUDA runtime that the port's kernel sources use, for
// running them on the CPU: tests/test_torch_kernel_source.py compiles
// the *.cu files one directory up with a C++20 host compiler against this
// header (after turning each `kernel<<<grid, block, shared, stream>>>(args)`
// into `shim_launch(kernel, grid, block, shared, args)`) and holds the
// result to the plain PyTorch versions.  A block's threads run as
// fibers (ucontext) on the launching thread, block after block (a
// cluster's blocks together, for `cudaLaunchKernelEx` with a cluster
// dimension): a thread runs until it waits at a barrier, then the next
// one runs.  A warp is 32 consecutive threads; a shuffle goes through a
// buffer and a barrier of the warp, so every thread of a warp must take
// every shuffle and vote (the kernels' own rule), `__syncthreads` is a
// barrier of the block, and the cluster barrier (`shim_cluster_arrive`
// and `shim_cluster_wait`, `cooperative_groups::this_cluster().sync()`
// in cooperative_groups.h here) one of the cluster's blocks, whose
// `map_shared_rank` points into a peer block's dynamic shared memory.
// Nothing here measures anything.
#pragma once
#include <ucontext.h>

#include <atomic>
#include <chrono>
#include <functional>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

// Everything below has internal linkage: each kernel source is its own
// translation unit of one library, and a function merged across them
// would read another unit's thread registers.
namespace {

struct uint4 { unsigned x, y, z, w; };
struct double2 { double x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned x_, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
static thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return uint4{a, b, c, d};
}
inline double2 make_double2(double x, double y) { return double2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmaf_rn(float a, float b, float c) {
  return std::fmaf(a, b, c);
}
template <class T> inline T __ldg(const T* p) { return *p; }

// The fibers of the block that runs on this thread, and the one running.
struct ShimFiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  unsigned tid = 0;
  unsigned rank = 0;     // its block's rank in the cluster
  unsigned arrived = 0;  // the cluster barrier's generation it arrived at
  bool done = false;
};
static thread_local ucontext_t shim_scheduler;
static thread_local std::vector<ShimFiber>* shim_fibers;
static thread_local int shim_running;
static thread_local std::function<void()>* shim_body;

// back to the scheduler, which runs the block's next thread
inline void shim_yield() {
  swapcontext(&(*shim_fibers)[shim_running].ctx, &shim_scheduler);
}

// A barrier of `expected` threads: each arrival waits, yielding, until
// the last one opens the barrier's next generation (arrive and wait may
// be taken apart: wait for the generation arrive returned).
struct ShimBarrier {
  int expected, count = 0;
  unsigned generation = 0;
  explicit ShimBarrier(int expected_) : expected(expected_) {}
  unsigned arrive() {
    const unsigned g = generation;
    if (++count == expected) {
      count = 0;
      ++generation;
    }
    return g;
  }
  void wait(unsigned g) {
    while (generation == g) shim_yield();
  }
  void arrive_and_wait() { wait(arrive()); }
};

struct ShimWarp {
  ShimBarrier bar;
  int threads;
  double buf[32];  // a float or a double of each thread
  explicit ShimWarp(int threads_) : bar(threads_), threads(threads_) {}
};
static thread_local ShimWarp* shim_warp;
static thread_local ShimBarrier* shim_block;
static thread_local float* shim_shared;
// the running cluster: its barrier, its blocks' shared memory, and the
// running fiber's block's rank in it
static thread_local ShimBarrier* shim_cluster_bar;
static thread_local std::vector<float*>* shim_cluster_shared;
static thread_local unsigned shim_cluster_rank;

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
template <class V>
inline V __shfl_up_sync(unsigned, V v, unsigned delta, int = 32) {
  const int lane = (int)(threadIdx.x & 31u);
  return shim_exchange(v, lane >= (int)delta ? lane - (int)delta : lane);
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
inline unsigned __ballot_sync(unsigned, int pred) {
  shim_warp->buf[threadIdx.x & 31u] = pred ? 1.0 : 0.0;
  shim_warp->bar.arrive_and_wait();
  unsigned bits = 0;
  for (int t = 0; t < shim_warp->threads; ++t)
    bits |= (shim_warp->buf[t] != 0.0 ? 1u : 0u) << t;
  shim_warp->bar.arrive_and_wait();
  return bits;
}
inline int __ffs(unsigned v) { return v ? __builtin_ctz(v) + 1 : 0; }
inline void __syncwarp(unsigned = 0xffffffffu) {
  shim_warp->bar.arrive_and_wait();
}
inline void __syncthreads() { shim_block->arrive_and_wait(); }
// the block's dynamic shared memory (`extern __shared__ ... name[];`)
inline float* shim_dynamic_shared() { return shim_shared; }
// the cluster barrier, in its two halves
inline void shim_cluster_arrive() {
  (*shim_fibers)[shim_running].arrived = shim_cluster_bar->arrive();
}
inline void shim_cluster_wait() {
  shim_cluster_bar->wait((*shim_fibers)[shim_running].arrived);
}
// the address in block `rank`'s shared memory of `addr` in this block's
template <class T>
inline T* shim_map_shared_rank(T* addr, unsigned rank) {
  const std::ptrdiff_t off =
      reinterpret_cast<char*>(addr) - reinterpret_cast<char*>(shim_shared);
  return reinterpret_cast<T*>(
      reinterpret_cast<char*>((*shim_cluster_shared)[rank]) + off);
}

inline void shim_fiber_main() {
  (*shim_body)();
  (*shim_fibers)[shim_running].done = true;
  // returns to the scheduler through uc_link
}

// Runs the `threads` fibers of each cluster's `cluster` blocks (blocks
// b, b + 1, ... b + cluster - 1) in turn until all return, cluster after
// cluster; a fiber's thread registers (threadIdx, blockIdx, its warp, its
// block's barrier and shared memory) are set as it resumes.
template <class Kernel, class... Args>
void shim_launch_clusters(Kernel kernel, unsigned blocks, unsigned threads,
                          size_t shared_bytes, unsigned cluster,
                          Args... args) {
  constexpr size_t kStack = 1 << 20;  // the kernels' local arrays
  const unsigned n = threads * cluster;
  std::vector<ShimFiber> fibers(n);
  for (auto& f : fibers) f.stack.reset(new char[kStack]);
  std::function<void()> body = [&] { kernel(args...); };
  for (unsigned b = 0; b < blocks; b += cluster) {
    std::vector<std::vector<float4>> shared(cluster);
    std::vector<float*> bases(cluster);
    std::vector<std::unique_ptr<ShimBarrier>> block_barriers;
    std::vector<std::vector<std::unique_ptr<ShimWarp>>> warps(cluster);
    for (unsigned r = 0; r < cluster; ++r) {
      shared[r].resize(shared_bytes / sizeof(float4) + 1);
      bases[r] = reinterpret_cast<float*>(shared[r].data());
      block_barriers.emplace_back(new ShimBarrier((int)threads));
      for (unsigned first = 0; first < threads; first += 32)
        warps[r].emplace_back(new ShimWarp(
            (int)(threads - first < 32 ? threads - first : 32)));
    }
    ShimBarrier cluster_barrier((int)n);
    blockDim.x = threads;
    gridDim.x = blocks;
    shim_fibers = &fibers;
    shim_body = &body;
    shim_cluster_bar = &cluster_barrier;
    shim_cluster_shared = &bases;
    for (unsigned x = 0; x < n; ++x) {
      ShimFiber& f = fibers[x];
      f.tid = x % threads;
      f.rank = x / threads;
      f.done = false;
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.get();
      f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = &shim_scheduler;
      makecontext(&f.ctx, shim_fiber_main, 0);
    }
    for (bool live = true; live;) {
      live = false;
      for (unsigned x = 0; x < n; ++x) {
        ShimFiber& f = fibers[x];
        if (f.done) continue;
        live = true;
        shim_running = (int)x;
        threadIdx.x = f.tid;
        blockIdx.x = b + f.rank;
        shim_cluster_rank = f.rank;
        shim_warp = warps[f.rank][f.tid / 32].get();
        shim_block = block_barriers[f.rank].get();
        shim_shared = bases[f.rank];
        swapcontext(&shim_scheduler, &f.ctx);
      }
    }
  }
  shim_fibers = nullptr;
  shim_body = nullptr;
  shim_cluster_bar = nullptr;
  shim_cluster_shared = nullptr;
}

// `kernel<<<blocks, threads, shared_bytes, stream>>>(args...)`
template <class Kernel, class... Args>
void shim_launch(Kernel kernel, unsigned blocks, unsigned threads,
                 size_t shared_bytes, Args... args) {
  shim_launch_clusters(kernel, blocks, threads, shared_bytes, 1u, args...);
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }

// cudaLaunchKernelEx with a cluster dimension (x alone)
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};
template <class Kernel, class... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, Kernel kernel,
                               Args... args) {
  unsigned cluster = 1;
  for (unsigned a = 0; a < cfg->numAttrs; ++a)
    if (cfg->attrs[a].id == cudaLaunchAttributeClusterDimension)
      cluster = cfg->attrs[a].val.clusterDim.x;
  if (cluster < 1 || cfg->gridDim.x % cluster != 0) return 1;
  shim_launch_clusters(kernel, cfg->gridDim.x, cfg->blockDim.x,
                       cfg->dynamicSmemBytes, cluster, args...);
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t code) {
  return code == 0 ? "no error" : "invalid argument";
}

// the step breakdown's build (-DMISO_B3_CLOCKS): its stamps, sums and
// device array
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
template <class V>
inline V atomicAdd(V* at, V v) {
  return std::atomic_ref<V>(*at).fetch_add(v);
}
template <class S>
cudaError_t cudaMemcpyFromSymbol(void* dst, const S& symbol, size_t bytes) {
  std::memcpy(dst, &symbol, bytes);
  return 0;
}
template <class S>
cudaError_t cudaMemcpyToSymbol(S& symbol, const void* src, size_t bytes) {
  std::memcpy(&symbol, src, bytes);
  return 0;
}

}  // namespace
