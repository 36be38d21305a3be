// Pixel -> face row accumulation (kernel B3 of drtk_tpu_torch).
//
// Replaces: drtk_tpu/ops/segment_rows.py::_accumulate_kernel (launched by
//   _binned_partials from scatter_rows_to_faces). The TPU kernel summed each
//   tile's rows per candidate face with one-hot bf16x3 matrix products,
//   because a TPU has no atomics and scatters slowly. Hopper has native
//   float and double atomicAdd, in shared and in device memory, so this
//   kernel sums on chip and adds each tile's per-face partials atomically.
//
// Computes: out[n, min(index[n, y, x], F - 1), k] += rows[n, y, x, k] for
//   every pixel with index >= 0; background pixels (index < 0) are dropped,
//   whatever their rows hold. `out` is zeroed by the caller. The clamp makes
//   it the adjoint of kernel B2's clamping gather, so every key below is the
//   clamped face.
//
// Order: the partials are added with atomics in whatever order the blocks
//   arrive, which changes from run to run, so the result is not
//   bit-reproducible (the TPU kernel is). It agrees with an ordered sum to
//   float rounding.
//
// Bound on this card: bytes. Each foreground pixel's K values and each index
//   are read once, each face row written once: 0.0122 ms at K = 9 on the
//   textured scene (0.97 M foreground pixels of 1024^2, 51,200 faces). No
//   arithmetic beyond one add per value. The first port (one thread and one
//   global atomicAdd per (pixel, k)) ran at a quarter of that: neighbouring
//   pixels mostly share a face (~20 px per triangle), so a warp's atomics
//   landed on the same few addresses and serialised in L2 at ~175 G/s.
//
// Design: one block of 256 threads per 32 x 8 pixel tile of one image (the
//   batch on blockIdx.y), one warp per tile row, one lane per pixel.
//   1. Each lane reads its pixel's index once and clamps it; lanes past the
//      ragged right or bottom edge count as background.
//   2. Runs of equal faces along the warp's row are found with one
//      __shfl_up_sync (head flags) and one __ballot_sync (each lane's
//      segment end).
//   3. The head of each foreground run enters its face into a shared-memory
//      table (512 slots, open addressing with atomicCAS on the key; a tile
//      has at most 256 faces, so it never fills), which gives the tile's
//      distinct faces dense ids.
//   4. Per chunk of channels, each warp stages its row's run of 32 x K
//      contiguous values in shared memory with asynchronous copies
//      (cp.async, 16 bytes where the run is aligned), the first chunk's
//      issued before step 1 so that the rows and the indices are read at
//      once; then it sums each run of equal faces with a segmented shuffle
//      reduction, four channels interleaved so that their shuffle chains
//      overlap, and the run's head adds the partial into its face's row of
//      a shared-memory sum table (a shared-memory float atomicAdd is a
//      compare-and-swap loop on this card, so it is kept to one per run and
//      channel, and the heads of one warp rarely share a face).
//   5. The block adds each distinct face's row of sums to `out`: one global
//      atomicAdd per (distinct face, k) per tile, consecutive threads on
//      consecutive k.
//   The global atomics fall from one per foreground (pixel, k) to one per
//   (tile, distinct face, k): ~11x fewer on the textured scene (counted
//   from the index image, chip_smoke.py), where a
//   tile of ~240 foreground pixels holds ~20 faces. Channels are staged in
//   chunks of at most 12 floats or 6 doubles (29 KB of static shared
//   memory, seven blocks an SM), so any K runs; the callers' K = 9
//   (render's and edge_grad's backward) and 6 (interpolate's) are template
//   constants and take one chunk in f32. What is left is instructions and
//   the block's phases one after another (index, table, sums, flush), not
//   the atomics (PERF.md, PR 5).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;  // tile columns: the lanes of a warp
constexpr int kTileH = 8;   // tile rows: the warps of a block
constexpr int kThreads = kTileW * kTileH;
constexpr int kSlots = 512;        // face table slots, a power of two >= 2 * kThreads
constexpr int kSlotBits = 9;       // log2(kSlots)
constexpr int kValueBytes = 12288;  // staged rows, and again the sums, per block
constexpr int kIlp = 4;            // channels whose segmented sums run interleaved
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__host__ __device__ constexpr int max_chunk() { return kValueBytes / (kThreads * static_cast<int>(sizeof(T))); }

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

// Start copying a warp's run: kc values (channels k0 .. k0 + kc - 1) of each
// of its n_run pixels, from rows at src (the run's first pixel, channel k0),
// into run[pixel * kc + k]. One contiguous run when kc == k_dim: 16-byte
// copies where it is aligned.
template <typename T>
__device__ __forceinline__ void stage_run(T* run, const T* src, int32_t n_run, int32_t kc, int32_t k_dim,
                                          int lane) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int32_t len = n_run * kc;
  if (kc == k_dim) {
    int32_t done = 0;
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      done = len / kVec * kVec;
      for (int32_t v = lane * kVec; v < done; v += kTileW * kVec) copy_async<16>(run + v, src + v);
    }
    for (int32_t j = done + lane; j < len; j += kTileW) copy_async<sizeof(T)>(run + j, src + j);
  } else {
    for (int32_t j = lane; j < len; j += kTileW) {
      const int32_t p = j / kc;
      copy_async<sizeof(T)>(run + j, src + p * k_dim + (j - p * kc));
    }
  }
}

// KT > 0: K known at compile time (and one chunk); KT == 0: K = k_rt.
template <typename T, int KT>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const T* __restrict__ rows, const int32_t* __restrict__ index,
                    T* __restrict__ out, int32_t h, int32_t w, int32_t n_faces,
                    int32_t k_rt, int32_t chunk) {
  const int32_t k_dim = KT > 0 ? KT : k_rt;
  __shared__ __align__(16) T stage[kThreads * max_chunk<T>()];
  __shared__ T sums[kThreads * max_chunk<T>()];
  __shared__ int32_t slot_face[kSlots];
  __shared__ int32_t slot_id[kSlots];
  __shared__ int32_t face_of_id[kThreads];
  __shared__ int32_t n_distinct;

  const int lane = threadIdx.x % kTileW;
  const int warp = threadIdx.x / kTileW;
  const int32_t tiles_x = (w + kTileW - 1) / kTileW;
  const int32_t x0 = (blockIdx.x % tiles_x) * kTileW;
  const int32_t y = (blockIdx.x / tiles_x) * kTileH + warp;
  const int64_t batch = blockIdx.y;
  const int32_t n_run = y < h ? min(kTileW, w - x0) : 0;  // this warp's pixels
  const int64_t pix0 = (batch * h + y) * w + x0;
  T* run = stage + warp * kTileW * chunk;

  // 0. The first chunk's rows start on their way before the indices, so the
  // two reads overlap.
  stage_run(run, rows + pix0 * k_dim, n_run, min(chunk, k_dim), k_dim, lane);
  for (int i = threadIdx.x; i < kSlots; i += kThreads) slot_face[i] = -1;
  if (threadIdx.x == 0) n_distinct = 0;

  // 1-2. Clamped faces and the runs of equal faces along the row.
  int32_t f = -1;
  if (lane < n_run) {
    f = __ldg(index + pix0 + lane);
    if (f >= 0) f = min(f, n_faces - 1);
  }
  const int32_t left = __shfl_up_sync(kFull, f, 1);
  const bool head = lane == 0 || f != left;
  const uint32_t later_heads = __ballot_sync(kFull, head) & ~((2u << lane) - 1u);
  const int seg_end = later_heads ? __ffs(later_heads) - 1 : kTileW;
  __syncthreads();

  // 3. Dense ids for the tile's distinct faces.
  int32_t slot = -1;
  if (head && f >= 0) {
    slot = static_cast<int32_t>((static_cast<uint32_t>(f) * 2654435761u) >> (32 - kSlotBits));
    for (;;) {
      const int32_t was = atomicCAS(&slot_face[slot], -1, f);
      if (was == -1) {
        const int32_t id = atomicAdd(&n_distinct, 1);
        slot_id[slot] = id;
        face_of_id[id] = f;
        break;
      }
      if (was == f) break;
      slot = (slot + 1) & (kSlots - 1);
    }
  }
  __syncthreads();
  const int32_t distinct = n_distinct;
  if (distinct == 0) {  // the same for every thread of the block
    wait_copies();  // no copy may land in shared memory after the block ends
    return;
  }
  const int32_t id = slot >= 0 ? slot_id[slot] : -1;

  for (int32_t k0 = 0; k0 < k_dim; k0 += chunk) {
    const int32_t kc = KT > 0 ? KT : min(chunk, k_dim - k0);
    if (k0 > 0) stage_run(run, rows + pix0 * k_dim + k0, n_run, kc, k_dim, lane);
    for (int32_t i = threadIdx.x; i < distinct * kc; i += kThreads) sums[i] = T(0);
    wait_copies();
    __syncthreads();  // the sums zeroed, the runs staged

    // 4. Segmented sums, kIlp channels at a time so their shuffles overlap.
    for (int32_t k = 0; k < kc; k += kIlp) {
      T v[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) v[u] = lane < n_run && k + u < kc ? run[lane * kc + k + u] : T(0);
#pragma unroll
      for (int d = 1; d < kTileW; d <<= 1) {
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          const T o = __shfl_down_sync(kFull, v[u], d);
          if (lane + d < seg_end) v[u] += o;
        }
      }
      if (id >= 0) {
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          if (k + u < kc) atomicAdd(&sums[id * kc + k + u], v[u]);
        }
      }
    }
    __syncthreads();

    // 5. One global atomic per (distinct face, k).
    for (int32_t i = threadIdx.x; i < distinct * kc; i += kThreads) {
      const int32_t d = i / kc;
      atomicAdd(out + (batch * n_faces + face_of_id[d]) * k_dim + k0 + (i - d * kc), sums[i]);
    }
    __syncthreads();  // before the next chunk restages and zeroes the sums
  }
}

template <typename T>
int launch(const void* rows, const void* index, void* out, int32_t n_batch,
           int32_t h, int32_t w, int32_t n_faces, int32_t k_dim, void* stream) {
  if (n_batch == 0 || h == 0 || w == 0 || k_dim == 0 || n_faces == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int32_t n_chunks = (k_dim + max_chunk<T>() - 1) / max_chunk<T>();
  const int32_t chunk = (k_dim + n_chunks - 1) / n_chunks;
  const int64_t tiles = static_cast<int64_t>((w + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  const dim3 grid(static_cast<unsigned int>(tiles), static_cast<unsigned int>(n_batch));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* r = static_cast<const T*>(rows);
  const int32_t* i = static_cast<const int32_t*>(index);
  T* o = static_cast<T*>(out);
  if (chunk == k_dim && k_dim == 9) {  // render's and edge_grad's backward
    scatter_rows_kernel<T, 9><<<grid, kThreads, 0, s>>>(r, i, o, h, w, n_faces, k_dim, chunk);
  } else if (chunk == k_dim && k_dim == 6) {  // interpolate's backward
    scatter_rows_kernel<T, 6><<<grid, kThreads, 0, s>>>(r, i, o, h, w, n_faces, k_dim, chunk);
  } else {
    scatter_rows_kernel<T, 0><<<grid, kThreads, 0, s>>>(r, i, o, h, w, n_faces, k_dim, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows [N, H, W, K], index [N, H, W] int32, out [N, F, K] (zeroed); all
// contiguous, on the device of `stream`; N <= 65535. Returns
// cudaGetLastError() after the launch.
int drtk_scatter_rows_f32(const void* rows, const void* index, void* out,
                          int32_t n_batch, int32_t h, int32_t w,
                          int32_t n_faces, int32_t k_dim, void* stream) {
  return launch<float>(rows, index, out, n_batch, h, w, n_faces, k_dim, stream);
}

int drtk_scatter_rows_f64(const void* rows, const void* index, void* out,
                          int32_t n_batch, int32_t h, int32_t w,
                          int32_t n_faces, int32_t k_dim, void* stream) {
  return launch<double>(rows, index, out, n_batch, h, w, n_faces, k_dim, stream);
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
