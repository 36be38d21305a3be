// 2-D tap accumulation, the texture-gradient scatter (kernel B4 of
// drtk_tpu_torch).
//
// Replaces: drtk_tpu/ops/window_accum.py::_window_kernel (launched by
//   _windowed_accumulate_one from window_accumulate, behind
//   row_gather._scatter_impl). The TPU kernel turned each block of
//   spatially coherent taps into a dense texel window with one-hot bf16x3
//   matrix products and read-modify-wrote the window, because a TPU has no
//   atomics. Hopper has native float and double atomicAdd, so this is a
//   direct scatter-add and none of the TPU's layout limits (8-row and
//   128-column alignment, blocked tap order, the window-overflow fallback)
//   apply.
//
// Computes: out[n, k, iy[n, p], ix[n, p]] += rows[n, k, p] for every tap p
//   with iy[n, p] >= 0 (negative iy marks an inert tap, whose rows are
//   ignored). Taps outside [0, out_h) x [0, out_w) are dropped as well, so a
//   bad coordinate can never write out of bounds. `out` is zeroed by the
//   caller.
//
// Order: atomics add in whatever order the threads arrive, which changes
//   from run to run, so the result is not bit-reproducible (the TPU kernel
//   is). It agrees with an ordered sum to float rounding.
//
// Bound on this card: bytes. Per live tap it reads K values and two int32
//   coordinates once; the table (K * out_h * out_w values, 12.6 MB for the
//   12-channel quad rows of a 512x512 texture) stays in the 50 MB L2, where
//   the atomics resolve.
//
// Design: one thread per tap looping over K. `rows` is read through
//   strides, so the caller's [N, P, K] cotangent is passed as its
//   [N, K, P] transpose without a copy: each thread then reads K
//   consecutive values. Neighbouring pixels sample neighbouring texels (two
//   pixels per texel at 1024^2 from 512^2), so same-address atomics within
//   a warp are few. A shared-memory tile of the target, the TPU design's
//   window, is the natural first redesign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void window_accum_kernel(const T* __restrict__ rows,
                                    const int32_t* __restrict__ iy,
                                    const int32_t* __restrict__ ix,
                                    T* __restrict__ out, int64_t n_taps,
                                    int32_t k_dim, int64_t stride_n,
                                    int64_t stride_k, int64_t stride_p,
                                    int32_t out_h, int32_t out_w,
                                    int64_t total) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= total) return;  // i = flat (batch, tap)
  const int32_t y = __ldg(iy + i);
  const int32_t x = __ldg(ix + i);
  if (y < 0 || y >= out_h || x < 0 || x >= out_w) return;
  const int64_t batch = i / n_taps;
  const int64_t p = i - batch * n_taps;
  const int64_t plane = static_cast<int64_t>(out_h) * out_w;
  const T* src = rows + batch * stride_n + p * stride_p;
  T* dst = out + batch * k_dim * plane + static_cast<int64_t>(y) * out_w + x;
  for (int32_t k = 0; k < k_dim; ++k) {
    atomicAdd(dst + k * plane, __ldg(src + k * stride_k));
  }
}

template <typename T>
int launch(const void* rows, const void* iy, const void* ix, void* out,
           int64_t n_batch, int64_t n_taps, int32_t k_dim, int64_t stride_n,
           int64_t stride_k, int64_t stride_p, int32_t out_h, int32_t out_w,
           void* stream) {
  const int64_t total = n_batch * n_taps;
  if (total == 0 || k_dim == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  window_accum_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const int32_t*>(iy),
      static_cast<const int32_t*>(ix), static_cast<T*>(out), n_taps, k_dim,
      stride_n, stride_k, stride_p, out_h, out_w, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows [N, K, P] read through element strides (stride_n, stride_k,
// stride_p); iy, ix [N, P] int32 contiguous; out [N, K, out_h, out_w]
// contiguous and zeroed; all on the device of `stream`. Returns
// cudaGetLastError() after the launch.
int drtk_window_accum_f32(const void* rows, const void* iy, const void* ix,
                          void* out, int64_t n_batch, int64_t n_taps,
                          int32_t k_dim, int64_t stride_n, int64_t stride_k,
                          int64_t stride_p, int32_t out_h, int32_t out_w,
                          void* stream) {
  return launch<float>(rows, iy, ix, out, n_batch, n_taps, k_dim, stride_n,
                       stride_k, stride_p, out_h, out_w, stream);
}

int drtk_window_accum_f64(const void* rows, const void* iy, const void* ix,
                          void* out, int64_t n_batch, int64_t n_taps,
                          int32_t k_dim, int64_t stride_n, int64_t stride_k,
                          int64_t stride_p, int32_t out_h, int32_t out_w,
                          void* stream) {
  return launch<double>(rows, iy, ix, out, n_batch, n_taps, k_dim, stride_n,
                        stride_k, stride_p, out_h, out_w, stream);
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
