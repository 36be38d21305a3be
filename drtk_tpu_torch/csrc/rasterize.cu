// Z-buffer resolve of the triangle rasterizer (kernel B1 of drtk_tpu_torch).
//
// Replaces: drtk_tpu/ops/rasterize_pallas.py::_tile_kernel (launched by
//   rasterize_pallas). The TPU kernel has no atomics, so it bins triangles
//   into 32x128 tiles (sort, segments, supertile and global lists) and keeps
//   each tile's z-buffer in registers. None of that is carried over: this is
//   the reference DRTK's own design, one thread per (batch, triangle) with a
//   packed 64-bit atomicMin.
//
// Computes, from the per-triangle setup rows that the wrapper packs with
//   torch ops (drtk_tpu_torch/ops/rasterize_cuda.py):
//   for every pixel centre (x, y) in the triangle's clipped bbox, the edge
//   values e_i = (ea_i*x + eb_i*y) + ec_i; the pixel is covered when every
//   e_i > 0, or e_i == 0 on a top-left edge. Its inverse depth is
//   di = (e_0*q_0 + e_1*q_1) + e_2*q_2. Each pixel keeps the largest di,
//   ties to the smaller triangle id, through
//     atomicMin(key, (~float_bits(di) << 32) | id)
//   (di >= 0 on covered pixels, so the float bits order like the floats).
//   A second kernel unpacks: depth = 1 / max(di, 1e-8), index = id, and
//   depth 0 / index -1 where the id field is still 0xFFFFFFFF.
//   Row-tile viewports: the wrapper clips the pixel ranges to the frame rows
//   [y_offset, y_offset + height); edge values use the frame's y and the
//   key of row y lands in row y - y_offset, so a tile equals the same rows
//   of the full frame bit for bit.
//   Every product and sum is rounded on its own (__fmul_rn / __fadd_rn), in
//   the order of the plain version, so nvcc cannot contract them into FMAs
//   and the kernel agrees with the plain version bit for bit.
//
// Bound on this card: bytes, at the shapes of the textured scene (1024^2,
//   51,200 triangles of ~20 pixels): 8 bytes of depth and index written per
//   pixel and 68 bytes of setup read per triangle, against ~15 flops per
//   tested pixel centre. The 8-byte key buffer adds one memset, one atomic
//   per covered (pixel, triangle) and one read per pixel.
//
// Design limit: a thread walks its whole bbox serially, so canvas-sized
//   triangles (the 256^2 entry scene) serialize on single threads. That
//   load imbalance is left for a later redesign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCoef = 12;  // ea[3], eb[3], ec[3], q[3]
constexpr int kMeta = 5;   // top-left bits, x_lo, x_hi, y_lo, y_hi
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ float edge(float a, float b, float c, float px,
                                      float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__global__ void resolve_kernel(const float* __restrict__ coef,
                               const int32_t* __restrict__ meta,
                               unsigned long long* __restrict__ keys,
                               int32_t n_batch, int32_t n_faces,
                               int32_t height, int32_t width,
                               int32_t y_offset) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<int64_t>(n_batch) * n_faces) return;
  const int32_t batch = static_cast<int32_t>(t / n_faces);
  const uint32_t tri = static_cast<uint32_t>(t - static_cast<int64_t>(batch) * n_faces);

  const int32_t* m = meta + t * kMeta;
  const int32_t x_lo = m[1], x_hi = m[2], y_lo = m[3], y_hi = m[4];
  if (x_lo > x_hi || y_lo > y_hi) return;  // culled, or off the canvas
  const bool tl0 = m[0] & 1, tl1 = m[0] & 2, tl2 = m[0] & 4;

  const float* c = coef + t * kCoef;
  const float ea0 = c[0], ea1 = c[1], ea2 = c[2];
  const float eb0 = c[3], eb1 = c[4], eb2 = c[5];
  const float ec0 = c[6], ec1 = c[7], ec2 = c[8];
  const float q0 = c[9], q1 = c[10], q2 = c[11];

  unsigned long long* kb = keys + static_cast<int64_t>(batch) * height * width;
  for (int32_t y = y_lo; y <= y_hi; ++y) {
    const float py = static_cast<float>(y);
    unsigned long long* krow = kb + static_cast<int64_t>(y - y_offset) * width;
    for (int32_t x = x_lo; x <= x_hi; ++x) {
      const float px = static_cast<float>(x);
      const float e0 = edge(ea0, eb0, ec0, px, py);
      const float e1 = edge(ea1, eb1, ec1, px, py);
      const float e2 = edge(ea2, eb2, ec2, px, py);
      const bool keep = (e0 > 0.f || (e0 == 0.f && tl0)) &&
                        (e1 > 0.f || (e1 == 0.f && tl1)) &&
                        (e2 > 0.f || (e2 == 0.f && tl2));
      if (!keep) continue;
      const float di = __fadd_rn(__fadd_rn(__fmul_rn(e0, q0), __fmul_rn(e1, q1)),
                                 __fmul_rn(e2, q2));
      // di >= 0 here; clearing the sign bit maps -0.0 to +0.0, which the
      // plain version's float comparisons treat as equal.
      const uint32_t bits = __float_as_uint(di) & 0x7FFFFFFFu;
      const unsigned long long key =
          (static_cast<unsigned long long>(~bits) << 32) | tri;
      atomicMin(krow + x, key);
    }
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ keys,
                              float* __restrict__ depth,
                              int32_t* __restrict__ index, int64_t total) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const unsigned long long k = keys[i];
  const uint32_t id = static_cast<uint32_t>(k & 0xFFFFFFFFull);
  if (id == 0xFFFFFFFFu) {
    depth[i] = 0.f;
    index[i] = -1;
    return;
  }
  const float di = __uint_as_float(~static_cast<uint32_t>(k >> 32));
  depth[i] = 1.0f / fmaxf(di, 1e-8f);  // 1 / epsclamp(di) for di >= 0
  index[i] = static_cast<int32_t>(id);
}

}  // namespace

extern "C" {

// coef [N, F, 12] f32, meta [N, F, 5] int32 (pixel ranges in frame rows
// within [y_offset, y_offset + height)), keys [N, H, W] uint64 scratch,
// depth [N, H, W] f32, index [N, H, W] int32; all contiguous, on the device
// of `stream`. Returns the first CUDA error of the memset and both launches.
int drtk_rasterize_f32(const void* coef, const void* meta, void* keys,
                       void* depth, void* index, int32_t n_batch,
                       int32_t n_faces, int32_t height, int32_t width,
                       int32_t y_offset, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_pix = static_cast<int64_t>(n_batch) * height * width;
  cudaError_t err = cudaMemsetAsync(keys, 0xFF, n_pix * sizeof(kEmpty), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 128;
  const int64_t n_tri = static_cast<int64_t>(n_batch) * n_faces;
  if (n_tri > 0) {
    resolve_kernel<<<static_cast<unsigned int>((n_tri + kThreads - 1) / kThreads),
                     kThreads, 0, s>>>(
        static_cast<const float*>(coef), static_cast<const int32_t*>(meta),
        static_cast<unsigned long long*>(keys), n_batch, n_faces, height,
        width, y_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kUnpackThreads = 256;
  if (n_pix > 0) {
    unpack_kernel<<<static_cast<unsigned int>((n_pix + kUnpackThreads - 1) /
                                              kUnpackThreads),
                    kUnpackThreads, 0, s>>>(
        static_cast<const unsigned long long*>(keys), static_cast<float*>(depth),
        static_cast<int32_t*>(index), n_pix);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
