// A stand-in for <cuda_runtime.h> with which g++ compiles a kernel source
// of drtk_tpu_torch/csrc for the host, so that its arithmetic can be held
// against its plain version on the CPU (tests/test_torch_edge_grad_kernel.py).
// The test rewrites each launch `kernel<<<grid, threads, ...>>>(args);` as
// `drtk_host_launch(grid, threads, [&] { kernel(args); });`, which runs the
// grid's blocks one after another on `threads` std::threads, one per CUDA
// thread; __syncthreads waits at a std::barrier of the block, and so does
// __syncwarp (the kernels that use it reach it with every thread of the
// block). __shared__ arrays are static: one block runs at a time. The
// __f*_rn and __d*_rn intrinsics are plain IEEE operations; the test
// compiles with -ffp-contract=off, so each rounds on its own, as on the card.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
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

inline thread_local uint3 threadIdx;
inline thread_local uint3 blockIdx;
inline std::barrier<>* drtk_host_block_barrier = nullptr;
inline void __syncthreads() { drtk_host_block_barrier->arrive_and_wait(); }
inline void __syncwarp() { drtk_host_block_barrier->arrive_and_wait(); }

template <typename F>
void drtk_host_launch(dim3 grid, int threads, F body) {
  std::barrier<> barrier(threads);
  drtk_host_block_barrier = &barrier;
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
