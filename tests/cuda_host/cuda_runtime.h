// A stand-in for <cuda_runtime.h> with which g++ compiles a kernel source
// of drtk_tpu_torch/csrc for the host, so that its arithmetic can be held
// against its plain version on the CPU (tests/test_torch_edge_grad_kernel.py,
// tests/test_torch_mipmap_kernel.py).
// The test rewrites each launch `kernel<<<grid, threads, ...>>>(args);` as
// `drtk_host_launch(grid, threads, [&] { kernel(args); });`, which runs the
// grid's blocks one after another on `threads` std::threads, one per CUDA
// thread; __syncthreads waits at a std::barrier of the block, __syncwarp at
// one of the warp (32 consecutive threads). The warp intrinsics (shuffle
// down, ballot, match, max) exchange values through a table of the warp's lanes between
// two waits at the warp's barrier, so every lane of a warp must call them
// the same number of times, as on the card under a full mask.
// __shared__ arrays are static: one block runs at a time. The
// __f*_rn and __d*_rn intrinsics are plain IEEE operations; the test
// compiles with -ffp-contract=off, so each rounds on its own, as on the card.
// atomicAdd on float, double and unsigned long long is std::atomic_ref's
// fetch_add, atomic across the block's threads, which run at once; atomicMin
// and atomicMax on int a compare-and-swap loop.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))

struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
typedef int cudaError_t;
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }

template <typename T> T __ldg(const T* p) { return *p; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline double2 make_double2(double x, double y) { return {x, y}; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
using std::max;
using std::min;

template <typename T>
T atomicAdd(T* address, T val) {
  return std::atomic_ref<T>(*address).fetch_add(val);
}

inline int atomicMin(int* address, int val) {
  std::atomic_ref<int> a(*address);
  int old = a.load();
  while (val < old && !a.compare_exchange_weak(old, val)) {
  }
  return old;
}

inline int atomicMax(int* address, int val) {
  std::atomic_ref<int> a(*address);
  int old = a.load();
  while (val > old && !a.compare_exchange_weak(old, val)) {
  }
  return old;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }

inline thread_local uint3 threadIdx;
inline thread_local uint3 blockIdx;
inline std::barrier<>* drtk_host_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> drtk_host_warp_barriers;
inline uint64_t drtk_host_lanes[32][32];  // [warp][lane]: the values a warp exchanges
inline int drtk_host_threads = 0;  // of the block
inline void __syncthreads() { drtk_host_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { drtk_host_warp_barriers[threadIdx.x / 32]->arrive_and_wait(); }

// Every lane of the warp posts `v`; returns what lane `src` posted (its own
// where `src` lies outside the warp).
template <typename T>
T drtk_host_exchange(T v, int src) {
  static_assert(sizeof(T) <= sizeof(uint64_t));
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::memcpy(&drtk_host_lanes[warp][lane], &v, sizeof(T));
  __syncwarp();
  T out = v;
  if (src >= 0 && src < 32 && static_cast<int>(warp * 32) + src < drtk_host_threads) {
    std::memcpy(&out, &drtk_host_lanes[warp][src], sizeof(T));
  }
  __syncwarp();
  return out;
}

template <typename T> T __shfl_down_sync(unsigned, T v, unsigned d) {
  return drtk_host_exchange(v, static_cast<int>(threadIdx.x % 32 + d));
}

// op folded over the values the warp's lanes post, lane by lane.
template <typename T, typename F>
T drtk_host_warp_fold(T v, T init, F op) {
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::memcpy(&drtk_host_lanes[warp][lane], &v, sizeof(T));
  __syncwarp();
  T acc = init;
  for (int src = 0; src < 32 && static_cast<int>(warp * 32) + src < drtk_host_threads; ++src) {
    T got;
    std::memcpy(&got, &drtk_host_lanes[warp][src], sizeof(T));
    acc = op(acc, got, src);
  }
  __syncwarp();
  return acc;
}

inline unsigned __ballot_sync(unsigned, int pred) {
  return drtk_host_warp_fold<unsigned>(pred ? 1u : 0u, 0u,
                                       [](unsigned acc, unsigned p, int src) { return acc | (p << src); });
}
template <typename T> unsigned __match_any_sync(unsigned, T v) {
  return static_cast<unsigned>(drtk_host_warp_fold<uint64_t>(
      static_cast<uint64_t>(v), 0, [v](uint64_t acc, uint64_t got, int src) {
        return got == static_cast<uint64_t>(v) ? acc | (uint64_t{1} << src) : acc;
      }));
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return drtk_host_warp_fold<unsigned>(v, 0u, [](unsigned acc, unsigned x, int) { return acc > x ? acc : x; });
}

template <typename F>
void drtk_host_launch(dim3 grid, int threads, F body) {
  std::barrier<> barrier(threads);
  drtk_host_block_barrier = &barrier;
  drtk_host_threads = threads;
  drtk_host_warp_barriers.clear();
  for (int w = 0; w * 32 < threads; ++w) {
    drtk_host_warp_barriers.push_back(std::make_unique<std::barrier<>>(std::min(32, threads - w * 32)));
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&, t] {
      threadIdx = {static_cast<unsigned>(t), 0, 0};
      for (unsigned by = 0; by < grid.y; ++by) {
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          blockIdx = {bx, by, 0};
          body();
          barrier.arrive_and_wait();  // the block's shared memory is the next block's
        }
      }
    });
  }
  for (auto& th : pool) th.join();
}
