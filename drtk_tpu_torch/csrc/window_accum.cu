// 2-D tap accumulation, the texture-gradient scatter (kernel B4 of
// drtk_tpu_torch).
//
// Replaces: drtk_tpu/ops/window_accum.py::_window_kernel (launched by
//   _windowed_accumulate_one from window_accumulate, behind
//   row_gather._scatter_impl). The TPU kernel turned each block of
//   spatially coherent taps into a dense texel window with one-hot bf16x3
//   matrix products and read-modify-wrote the window, because a TPU has no
//   atomics. Hopper adds floats atomically in device memory (in L2), but not
//   in shared memory: there a float atomicAdd compiles to a compare-and-swap
//   loop (ATOMS.CAST.SPIN), which taps that share a texel repeat. So this
//   kernel sums the taps that share a texel within a warp, in registers, and
//   adds each sum to the table with one global atomic. None of the TPU's
//   layout limits (8-row and 128-column alignment, a padded tap order) apply.
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
//   coordinates once, and the table (K * out_h * out_w values) is written
//   once: 0.0201 ms for the textured fitting step (12-channel quad rows of
//   ~1 M taps, a 512x512 table). The first port (one thread per tap, one
//   global atomicAdd per (tap, k)) ran at a third of that, at ~200 G
//   atomics/s.
//
// Design: the caller gives the taps their 2-D shape (rows_h x rows_w, the
//   sampling grid that P flattens), and neighbouring pixels sample
//   neighbouring texels.
//   1. A warp takes an 8 x 4 patch of taps (32 consecutive taps of a grid
//      of fewer than 8 rows), one lane per tap, and reads each tap's
//      (iy, ix) once; a block of 8 warps covers 32 x 8 taps (1 x 256).
//   2. The live taps' rows are staged in shared memory with asynchronous
//      copies (cp.async), 16 bytes at a time for the [N, K, P] transpose
//      view of an [N, P, K] cotangent (read through strides, no copy), the
//      lanes handing each other their taps' offsets with shuffles.
//   3. __match_any_sync groups the warp's taps by texel; the lowest lane of
//      each group sums the group's rows (K = 12, the quad rows of a
//      3-channel texture, at compile time; any other K in chunks of 12
//      floats or 6 doubles) and adds them with one global atomicAdd per
//      (texel, k).
//   On the textured scene (1024^2 pixels sampling a 512^2 texture, 2 x 2
//   pixels per texel) a patch of 32 taps touches ~8-12 texels, so the
//   global atomics fall ~2.8x (counted from the taps, chip_smoke.py); more
//   on the inverse8 views (~3.5x), where more taps share each texel. A shared-memory texel window over each block's
//   bounding box, the TPU kernel's design, needs ~20 % fewer global
//   atomics, but its best variant ran 1.3x slower than this design on
//   this card, its shared-memory adds being compare-and-swap loops
//   (PERF.md, PR 5).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // taps per block, one per thread
constexpr int kStageBytes = 12288;  // the block's tap rows, a chunk of channels at a time
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<double> { static constexpr int n = 2; };

template <typename T>
__host__ __device__ constexpr int max_chunk() { return kStageBytes / (kThreads * static_cast<int>(sizeof(T))); }

// Asynchronous copy of kBytes from device to shared memory (cp.async); the
// thread goes on at once, and wait_copies() waits for all of its copies.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst_shared, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(kBytes) : "memory");
  }
}

__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Start copying the rows of a warp's live taps into run[i * kc + k]: lane i
// holds tap i at `tap` (its index in the batch's P taps; bit i of `live`),
// k < kc channels from `src` (the batch's channel k0). The lanes hand each
// other their taps' offsets with shuffles. With the [N, K, P] transpose view
// of an [N, P, K] cotangent whose rows are whole 16-byte vectors
// (`vector_rows`: stride_p == K, stride_k == 1, one chunk) each tap's row is
// copied in 16-byte vectors; otherwise value by value, the lanes walking the
// (tap, k) pairs in order.
template <typename T>
__device__ __forceinline__ void stage_taps(T* run, const T* src, int32_t tap, uint32_t live, int32_t kc,
                                           int64_t stride_k, int64_t stride_p, bool vector_rows, int lane) {
  constexpr int kVec = Vec<T>::n;
  if (vector_rows) {
    for (int32_t v = lane; v < 32 * kc / kVec; v += 32) {
      const int32_t i = v * kVec / kc;
      const int32_t at = __shfl_sync(kFull, tap, i);
      if ((live >> i) & 1u) copy_async<16>(run + v * kVec, src + static_cast<int64_t>(at) * kc + (v * kVec - i * kc));
    }
    return;
  }
  int32_t i = lane / kc;
  int32_t k = lane % kc;
  for (int32_t e = lane; e < 32 * kc; e += 32) {
    const int32_t at = __shfl_sync(kFull, tap, i);
    if ((live >> i) & 1u) copy_async<sizeof(T)>(run + e, src + at * stride_p + k * stride_k);
    i += 32 / kc;
    k += 32 % kc;
    if (k >= kc) {
      k -= kc;
      ++i;
    }
  }
}

// KT > 0: K known at compile time (and one chunk); KT == 0: K = k_rt.
template <typename T, int KT>
__global__ void __launch_bounds__(kThreads)
window_accum_kernel(const T* __restrict__ rows, const int32_t* __restrict__ iy,
                    const int32_t* __restrict__ ix, T* __restrict__ out,
                    int32_t rows_h, int32_t rows_w, int32_t k_rt,
                    int32_t chunk, int64_t stride_n, int64_t stride_k, int64_t stride_p,
                    int32_t out_h, int32_t out_w, bool vector_rows) {
  const int32_t k_dim = KT > 0 ? KT : k_rt;
  __shared__ __align__(16) T stage[kThreads * max_chunk<T>()];  // per warp: [tap][k of the chunk]

  // 1. This lane's tap: warp `warp` of the block takes patch (warp / per_row,
  // warp % per_row) of the block's rectangle, per_row patches side by side:
  // 8 x 4 patches, four to a row, or on a grid of fewer than 8 rows 1 x 32,
  // eight to a row.
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int32_t patch_w = rows_h >= 8 ? 8 : 32;
  const int32_t patch_h = 32 / patch_w;
  const int32_t per_row = patch_w == 8 ? 4 : 8;
  const int32_t tile_w = per_row * patch_w;
  const int32_t tiles_x = (rows_w + tile_w - 1) / tile_w;
  const int32_t gy = (blockIdx.x / tiles_x) * (kThreads / tile_w) + warp / per_row * patch_h + lane / patch_w;
  const int32_t gx = (blockIdx.x % tiles_x) * tile_w + warp % per_row * patch_w + lane % patch_w;
  const int64_t batch = blockIdx.y;
  const bool inside = gy < rows_h && gx < rows_w;
  const int32_t tap = inside ? gy * rows_w + gx : 0;
  int32_t y = -1, x = -1;
  if (inside) {
    y = __ldg(iy + batch * rows_h * rows_w + tap);
    x = __ldg(ix + batch * rows_h * rows_w + tap);
  }
  const bool live = y >= 0 && y < out_h && x >= 0 && x < out_w;
  const uint32_t warp_live = __ballot_sync(kFull, live);
  if (!warp_live) return;  // the same for the whole warp, which shares nothing with the others

  // 2. The first chunk of the live taps' rows starts on its way, then the
  // taps are grouped by texel while it flies.
  T* run = stage + warp * 32 * chunk;
  const T* src = rows + batch * stride_n;
  stage_taps(run, src, tap, warp_live, chunk, stride_k, stride_p, vector_rows, lane);
  const int64_t plane = static_cast<int64_t>(out_h) * out_w;
  const int32_t texel = live ? y * out_w + x : -1;
  const uint32_t group = __match_any_sync(kFull, texel);  // the lanes whose tap shares my texel
  const bool leader = live && __ffs(group) - 1 == lane;

  // 3. Each group's leader sums the group's rows and adds them to the table.
  for (int32_t k0 = 0; k0 < k_dim; k0 += chunk) {
    const int32_t kc = KT > 0 ? KT : min(chunk, k_dim - k0);
    if (k0 > 0) {
      __syncwarp();  // the warp is done with the last chunk's values
      stage_taps(run, src + k0 * stride_k, tap, warp_live, kc, stride_k, stride_p, vector_rows, lane);
    }
    wait_copies();
    __syncwarp();
    if (!leader) continue;
    T* dst = out + (batch * k_dim + k0) * plane + texel;
    if constexpr (KT > 0) {
      T sum[KT] = {};
      for (uint32_t m = group; m; m &= m - 1) {
        const T* row = run + (__ffs(m) - 1) * KT;
#pragma unroll
        for (int k = 0; k < KT; ++k) sum[k] += row[k];
      }
#pragma unroll
      for (int k = 0; k < KT; ++k) atomicAdd(dst + k * plane, sum[k]);
    } else {
      for (int32_t k = 0; k < kc; ++k) {
        T sum = T(0);
        for (uint32_t m = group; m; m &= m - 1) sum += run[(__ffs(m) - 1) * kc + k];
        atomicAdd(dst + k * plane, sum);
      }
    }
  }
}

template <typename T>
int launch(const void* rows, const void* iy, const void* ix, void* out,
           int32_t n_batch, int32_t rows_h, int32_t rows_w, int32_t k_dim,
           int64_t stride_n, int64_t stride_k, int64_t stride_p,
           int32_t out_h, int32_t out_w, void* stream) {
  if (n_batch == 0 || rows_h == 0 || rows_w == 0 || k_dim == 0 || out_h == 0 || out_w == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int32_t n_chunks = (k_dim + max_chunk<T>() - 1) / max_chunk<T>();
  const int32_t chunk = (k_dim + n_chunks - 1) / n_chunks;
  // 16-byte copies of whole rows: the transpose view of a contiguous
  // [N, P, K] tensor whose rows are whole vectors, on an aligned base, all
  // channels in one chunk; a vector then never straddles two taps.
  const bool vector_rows = stride_k == 1 && stride_p == k_dim && stride_n % Vec<T>::n == 0 &&
                           chunk == k_dim && k_dim % Vec<T>::n == 0 &&
                           reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const int32_t tile_w = rows_h >= 8 ? 32 : 256;  // the block's rectangle, as the kernel tiles it
  const int32_t tile_h = kThreads / tile_w;
  const int64_t tiles = static_cast<int64_t>((rows_w + tile_w - 1) / tile_w) * ((rows_h + tile_h - 1) / tile_h);
  const dim3 grid(static_cast<unsigned int>(tiles), static_cast<unsigned int>(n_batch));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* r = static_cast<const T*>(rows);
  const int32_t* y = static_cast<const int32_t*>(iy);
  const int32_t* x = static_cast<const int32_t*>(ix);
  T* o = static_cast<T*>(out);
  if (k_dim == 12 && chunk == 12) {  // 3-channel quad rows, grid_sample's bilinear texture gradient
    window_accum_kernel<T, 12><<<grid, kThreads, 0, s>>>(r, y, x, o, rows_h, rows_w, k_dim, chunk,
                                                         stride_n, stride_k, stride_p, out_h, out_w, vector_rows);
  } else {
    window_accum_kernel<T, 0><<<grid, kThreads, 0, s>>>(r, y, x, o, rows_h, rows_w, k_dim, chunk,
                                                        stride_n, stride_k, stride_p, out_h, out_w, vector_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows [N, K, P] read through element strides (stride_n, stride_k,
// stride_p); iy, ix [N, P] int32 contiguous, P = rows_h * rows_w; out
// [N, K, out_h, out_w] contiguous and zeroed, out_h * out_w below 2^31;
// all on the device of `stream`; N <= 65535. Returns cudaGetLastError()
// after the launch.
int drtk_window_accum_f32(const void* rows, const void* iy, const void* ix,
                          void* out, int32_t n_batch, int32_t rows_h,
                          int32_t rows_w, int32_t k_dim,
                          int64_t stride_n, int64_t stride_k, int64_t stride_p,
                          int32_t out_h, int32_t out_w, void* stream) {
  return launch<float>(rows, iy, ix, out, n_batch, rows_h, rows_w, k_dim,
                       stride_n, stride_k, stride_p, out_h, out_w, stream);
}

int drtk_window_accum_f64(const void* rows, const void* iy, const void* ix,
                          void* out, int32_t n_batch, int32_t rows_h,
                          int32_t rows_w, int32_t k_dim,
                          int64_t stride_n, int64_t stride_k, int64_t stride_p,
                          int32_t out_h, int32_t out_w, void* stream) {
  return launch<double>(rows, iy, ix, out, n_batch, rows_h, rows_w, k_dim,
                        stride_n, stride_k, stride_p, out_h, out_w, stream);
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
