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
// Bound on this card: bytes. Each index is read once (4 bytes a pixel) and
//   each output row written once (K * sizeof(T) bytes a pixel); the table
//   (F*K values, ~1.8 MB at K = 9 for the 51,200-face textured scene) stays
//   in the 50 MB L2. No arithmetic: what can keep it from the bytes bound is
//   instructions per element and store coalescing.
//
// Design: a block owns kPixels consecutive pixels of one batch (blockIdx.y),
//   so its output [pixels x K] is one contiguous run.
//   1. One thread per pixel loads the pixel's index once and puts the offset
//      of its table row (clamped face * K, or -1 for a zero row) in shared
//      memory.
//   2. The block writes its run as 16-byte vectors (float4, double2): thread
//      v fills vector v through the row offsets in shared memory, a scalar
//      head and tail covering the ends that are not 16-byte aligned (an odd
//      P * K shifts each batch's runs). Where the rows are themselves whole vectors (K a
//      multiple of 4 floats or 2 doubles, on an aligned table) each vector
//      is one row chunk and is read as a vector; otherwise (K = 6, 9) its
//      values are read with scalar __ldg, since those rows are not 16-byte
//      aligned.
//   K = 6 and 9 (interpolate, render) are template constants, so the
//   division that maps an element of the run to its (pixel, k) is a
//   multiply and shift, done once per vector; any other K runs the same
//   kernel with K at run time. Offsets within a batch are 32-bit (the
//   wrapper raises when P*K or F*K reaches 2^31): no 64-bit division.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 256;  // pixels per block: one thread each in step 1

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

// KC > 0: K known at compile time; KC == 0: K = k_rt.
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table, const int32_t* __restrict__ index,
                   T* __restrict__ out, int32_t n_pix, int32_t n_faces, int32_t k_rt,
                   bool vector_rows) {
  using V = typename Vec<T>::type;
  constexpr int kVec = Vec<T>::n;
  const int32_t k_dim = KC > 0 ? KC : k_rt;
  __shared__ int32_t row_at[kPixels];

  const int32_t p0 = blockIdx.x * kPixels;
  const int32_t n_here = min(kPixels, n_pix - p0);
  const int64_t batch = blockIdx.y;
  const T* tab = table + batch * n_faces * k_dim;
  if (static_cast<int32_t>(threadIdx.x) < n_here) {
    const int32_t f = __ldg(index + batch * n_pix + p0 + threadIdx.x);
    row_at[threadIdx.x] = (f >= 0 && n_faces > 0) ? min(f, n_faces - 1) * k_dim : -1;
  }
  __syncthreads();

  T* dst = out + batch * n_pix * k_dim + p0 * k_dim;
  const int32_t len = n_here * k_dim;
  const int32_t misalign = static_cast<int32_t>((reinterpret_cast<uintptr_t>(dst) / sizeof(T)) % kVec);
  const int32_t head = min(len, (kVec - misalign) % kVec);
  const int32_t n_vec = (len - head) / kVec;
  const int32_t tail = head + n_vec * kVec;

  // The scalar head and tail, fewer than kVec elements each.
  if (static_cast<int32_t>(threadIdx.x) < head + (len - tail)) {
    const int32_t t = threadIdx.x;
    const int32_t j = t < head ? t : tail + (t - head);
    const int32_t p = j / k_dim;
    const int32_t r = row_at[p];
    dst[j] = r < 0 ? T(0) : __ldg(tab + r + (j - p * k_dim));
  }

  V* vdst = reinterpret_cast<V*>(dst + head);
  for (int32_t v = threadIdx.x; v < n_vec; v += kThreads) {
    const int32_t j = head + v * kVec;
    int32_t p = j / k_dim;
    int32_t k = j - p * k_dim;
    int32_t r = row_at[p];
    if (KC > 0 && KC % kVec == 0 && vector_rows) {
      // head == 0 here, so the vector is kVec values of one row.
      vdst[v] = r < 0 ? V{} : __ldg(reinterpret_cast<const V*>(tab + r + k));
      continue;
    }
    T vals[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      vals[e] = r < 0 ? T(0) : __ldg(tab + r + k);
      if (++k == k_dim && e + 1 < kVec) {
        k = 0;
        r = row_at[++p];
      }
    }
    V x;
    if constexpr (kVec == 4) {
      x = make_float4(vals[0], vals[1], vals[2], vals[3]);
    } else {
      x = make_double2(vals[0], vals[1]);
    }
    vdst[v] = x;
  }
}

template <typename T>
int launch(const void* table, const void* index, void* out, int32_t n_batch,
           int32_t n_pix, int32_t n_faces, int32_t k_dim, void* stream) {
  if (n_batch == 0 || n_pix == 0 || k_dim == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned int>((n_pix + kPixels - 1) / kPixels),
                  static_cast<unsigned int>(n_batch));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* t = static_cast<const T*>(table);
  const int32_t* i = static_cast<const int32_t*>(index);
  T* o = static_cast<T*>(out);
  // Vector row reads need 16-byte aligned rows: an aligned table and output
  // (the output's runs then start aligned too, since K * sizeof(T) is a
  // multiple of 16 whenever K % kVec == 0).
  const bool aligned = reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  switch (k_dim) {
    case 6:
      gather_rows_kernel<T, 6><<<grid, kThreads, 0, s>>>(t, i, o, n_pix, n_faces, k_dim, aligned);
      break;
    case 9:
      gather_rows_kernel<T, 9><<<grid, kThreads, 0, s>>>(t, i, o, n_pix, n_faces, k_dim, aligned);
      break;
    default:
      gather_rows_kernel<T, 0><<<grid, kThreads, 0, s>>>(t, i, o, n_pix, n_faces, k_dim, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table [N, F, K], index [N, P] int32, out [N, P, K]; all contiguous, on the
// device of `stream`; N <= 65535, P*K and F*K below 2^31. Returns
// cudaGetLastError() after the launch.
int drtk_gather_rows_f32(const void* table, const void* index, void* out,
                         int32_t n_batch, int32_t n_pix, int32_t n_faces,
                         int32_t k_dim, void* stream) {
  return launch<float>(table, index, out, n_batch, n_pix, n_faces, k_dim,
                       stream);
}

int drtk_gather_rows_f64(const void* table, const void* index, void* out,
                         int32_t n_batch, int32_t n_pix, int32_t n_faces,
                         int32_t k_dim, void* stream) {
  return launch<double>(table, index, out, n_batch, n_pix, n_faces, k_dim,
                        stream);
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
