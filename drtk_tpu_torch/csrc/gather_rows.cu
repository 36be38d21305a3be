// Per-pixel face-row gather (kernel B2 of drtk_tpu_torch).
//
// Replaces: drtk_tpu/ops/segment_rows.py::_gather_kernel (launched by
//   _binned_gather from gather_rows_by_index). The TPU kernel rebuilt each
//   row with a one-hot bf16x3 matrix product over per-tile candidate bins,
//   because a TPU gathers slowly. Hopper gathers natively, so this is a
//   direct gather and is bit-exact by construction.
//
// Computes: out[n, p, k] = table[n, min(index[n, p], F - 1), k], and 0 where
//   index[n, p] < 0 (background) or F == 0. Same clamp as the plain version.
//
// Bound on this card: bytes. Per output element it moves one 4-byte store
//   and a share of one 4-byte index load; the table (F*K floats, ~2 MB for
//   the 51,200-face textured scene) stays in the 50 MB L2. No arithmetic.
//
// Design: one thread per output element (pixel, k), so neighbouring threads
//   store neighbouring floats (fully coalesced writes, the dominant traffic)
//   and the K threads of one pixel share its index load through L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ table,
                                   const int32_t* __restrict__ index,
                                   T* __restrict__ out, int64_t n_pix,
                                   int32_t n_faces, int32_t k_dim,
                                   int64_t total) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int64_t row = i / k_dim;  // flat (batch, pixel)
  const int32_t k = static_cast<int32_t>(i - row * k_dim);
  const int64_t batch = row / n_pix;
  const int32_t f = __ldg(index + row);
  T val = T(0);
  if (f >= 0 && n_faces > 0) {
    const int64_t face = f < n_faces ? f : n_faces - 1;
    val = __ldg(table + (batch * n_faces + face) * k_dim + k);
  }
  out[i] = val;
}

template <typename T>
int launch(const void* table, const void* index, void* out, int64_t n_batch,
           int64_t n_pix, int32_t n_faces, int32_t k_dim, void* stream) {
  const int64_t total = n_batch * n_pix * k_dim;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  gather_rows_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(index),
      static_cast<T*>(out), n_pix, n_faces, k_dim, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table [N, F, K], index [N, P] int32, out [N, P, K]; all contiguous, on the
// device of `stream`. Returns cudaGetLastError() after the launch.
int drtk_gather_rows_f32(const void* table, const void* index, void* out,
                         int64_t n_batch, int64_t n_pix, int32_t n_faces,
                         int32_t k_dim, void* stream) {
  return launch<float>(table, index, out, n_batch, n_pix, n_faces, k_dim,
                       stream);
}

int drtk_gather_rows_f64(const void* table, const void* index, void* out,
                         int64_t n_batch, int64_t n_pix, int32_t n_faces,
                         int32_t k_dim, void* stream) {
  return launch<double>(table, index, out, n_batch, n_pix, n_faces, k_dim,
                        stream);
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
