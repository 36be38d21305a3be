// Pixel -> face row accumulation (kernel B3 of drtk_tpu_torch).
//
// Replaces: drtk_tpu/ops/segment_rows.py::_accumulate_kernel (launched by
//   _binned_partials from scatter_rows_to_faces). The TPU kernel summed each
//   tile's rows per candidate face with one-hot bf16x3 matrix products,
//   because a TPU has no atomics and scatters slowly. Hopper has native
//   float and double atomicAdd in device memory, so this is a direct
//   scatter-add.
//
// Computes: out[n, min(index[n, p], F - 1), k] += rows[n, p, k] for every
//   pixel p with index[n, p] >= 0; background pixels (index < 0) are
//   dropped. `out` is zeroed by the caller. The clamp makes it the adjoint
//   of kernel B2's clamping gather.
//
// Order: atomics add in whatever order the threads arrive, which changes
//   from run to run, so the result is not bit-reproducible (the TPU kernel
//   is). It agrees with an ordered sum to float rounding.
//
// Bound on this card: bytes. Per foreground pixel it reads K values and the
//   index once; the face table (F*K values, ~1.8 MB at K=9 for the
//   51,200-face textured scene) stays in the 50 MB L2, where the atomics
//   resolve. No arithmetic beyond one add per value.
//
// Design: one thread per (pixel, k), so a warp reads 32 neighbouring values
//   (coalesced) and its atomics go to K distinct addresses per pixel.
//   Neighbouring pixels mostly share a face (~20 px per triangle in the
//   textured scene), so a warp's 3-4 pixels often target the same K
//   addresses and those atomics serialize in L2. A warp-segmented sum
//   before the atomic (as the reference DRTK's interpolate backward does)
//   is the first redesign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void scatter_rows_kernel(const T* __restrict__ rows,
                                    const int32_t* __restrict__ index,
                                    T* __restrict__ out, int64_t n_pix,
                                    int32_t n_faces, int32_t k_dim,
                                    int64_t total) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int64_t row = i / k_dim;  // flat (batch, pixel)
  const int32_t f = __ldg(index + row);
  if (f < 0) return;
  const int32_t k = static_cast<int32_t>(i - row * k_dim);
  const int64_t batch = row / n_pix;
  const int64_t face = f < n_faces ? f : n_faces - 1;
  atomicAdd(out + (batch * n_faces + face) * k_dim + k, __ldg(rows + i));
}

template <typename T>
int launch(const void* rows, const void* index, void* out, int64_t n_batch,
           int64_t n_pix, int32_t n_faces, int32_t k_dim, void* stream) {
  const int64_t total = n_batch * n_pix * k_dim;
  if (total == 0 || n_faces == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  scatter_rows_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const int32_t*>(index),
      static_cast<T*>(out), n_pix, n_faces, k_dim, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows [N, P, K], index [N, P] int32, out [N, F, K] (zeroed); all
// contiguous, on the device of `stream`. Returns cudaGetLastError() after
// the launch.
int drtk_scatter_rows_f32(const void* rows, const void* index, void* out,
                          int64_t n_batch, int64_t n_pix, int32_t n_faces,
                          int32_t k_dim, void* stream) {
  return launch<float>(rows, index, out, n_batch, n_pix, n_faces, k_dim,
                       stream);
}

int drtk_scatter_rows_f64(const void* rows, const void* index, void* out,
                          int64_t n_batch, int64_t n_pix, int32_t n_faces,
                          int32_t k_dim, void* stream) {
  return launch<double>(rows, index, out, n_batch, n_pix, n_faces, k_dim,
                        stream);
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
