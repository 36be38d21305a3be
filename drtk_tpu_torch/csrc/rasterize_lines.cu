// Wireframe (diamond-exit) resolve of the rasterizer (kernel B5 of
// drtk_tpu_torch).
//
// Replaces: drtk_tpu/ops/rasterize_pallas.py::_lines_tile_kernel (launched
//   by rasterize_lines_pallas). The TPU kernel has no atomics, so it bins
//   triangles into 32x128 tiles (sorted segments, supertiles, a global list,
//   32-float SMEM rows with the id split in two 14-bit halves) and keeps each
//   tile's z-buffer in registers. None of that is carried over.
//
// Computes, from the per-triangle rows that the wrapper packs with torch ops
//   (drtk_tpu_torch/ops/rasterize_cuda.py: pack_lines), for every pixel
//   centre (x, y) of the triangle's window (its bbox grown by one pixel,
//   clipped to the rows and columns off the frame border):
//   - e_i = (ea_i*x + eb_i*y) + ec_i; inside when every e_i > 0, or == 0 on a
//     top-left edge;
//   - crossing when a visible edge's segment meets one of the four sides of
//     the pixel's unit diamond at a point inside both (_diamond_crossing in
//     drtk_tpu_torch/ops/rasterize.py);
//   - where inside or crossing, the inverse depth from the clipped and
//     renormalised barycentrics b_i = clip(e_i*inv_den, 0, 1), bs = (b_0 +
//     b_1) + b_2, di = ((b_0/bs)*d_0 + (b_1/bs)*d_1) + (b_2/bs)*d_2, into
//       atomicMin(key, (~float_bits(di) << 32) | id)
//     with id the triangle's on crossing pixels and INT32_MAX on interior
//     ones: those occlude by depth and lose id ties. The unpack writes their
//     depth and index -1; untouched keys give depth 0 and index -1.
//   Every product, sum and quotient is rounded on its own (__fmul_rn,
//   __fadd_rn, __fsub_rn, __fdiv_rn) in the plain version's order, so nvcc
//   cannot contract them into FMAs and the kernel agrees with the plain
//   version bit for bit. Row-tile viewports work as in kernel B1: frame y in
//   the math, row y - y_offset in the output.
//
// Work split: one thread per (triangle, window pixel), in a grid-stride
//   loop. The wrapper's inclusive running sum of window areas (`ends`) maps
//   a thread's number to its triangle by binary search, so a canvas-sized
//   triangle spreads over as many threads as it has pixels (kernel B1's one
//   thread per triangle serializes it). The total is read on the device, so
//   the launch needs no host synchronisation.
//
// Bound on this card: operations, at the textured scene's shapes (1024^2,
//   51,200 triangles, all edges visible, ~100 window pixels each): per
//   pixel test three edge values, then four diamond-side intersections per
//   visible edge with two divisions each, ~240 flops, against 104 bytes of
//   setup per triangle and 16 bytes of key and outputs per pixel. The
//   binary search adds ~17 dependent loads per thread, mostly from L1.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 19;   // ea[3], eb[3], ec[3], p0 p1 p2 (x, y), d_inv[3], inv_den
constexpr int kMeta = 5;   // bits (top-left 0-2, visible 3-5), x_lo, x_hi, y_lo, y_hi
constexpr unsigned long long kEmpty = ~0ull;
constexpr uint32_t kInterior = 0x7FFFFFFFu;  // id of a pixel no visible edge crosses

__device__ __forceinline__ float edge(float a, float b, float c, float px,
                                      float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ bool keep(float e, bool tl) {
  return e > 0.f || (e == 0.f && tl);
}

__device__ __forceinline__ bool in_seg(float ax, float ay, float bx, float by,
                                       float cx, float cy) {
  return ((bx >= cx && cx >= ax) || (bx <= cx && cx <= ax)) &&
         ((by >= cy && cy >= ay) || (by <= cy && cy <= ay));
}

// Segment (p1, p2), whose line is a0*x + b0*y + c0 = 0, against the diamond
// side (s0, s1).
__device__ __forceinline__ bool seg_cross(float a0, float b0, float c0,
                                          float p1x, float p1y, float p2x,
                                          float p2y, float s0x, float s0y,
                                          float s1x, float s1y) {
  const float a2 = __fsub_rn(s0y, s1y);
  const float b2 = __fsub_rn(s1x, s0x);
  const float c2 = __fsub_rn(__fmul_rn(s0x, s1y), __fmul_rn(s1x, s0y));
  const float d = __fsub_rn(__fmul_rn(a0, b2), __fmul_rn(a2, b0));
  float cx = FLT_MAX, cy = FLT_MAX;
  if (d != 0.f) {
    cx = __fdiv_rn(__fsub_rn(__fmul_rn(b0, c2), __fmul_rn(b2, c0)), d);
    cy = __fdiv_rn(__fsub_rn(__fmul_rn(a2, c0), __fmul_rn(a0, c2)), d);
  }
  return in_seg(s0x, s0y, s1x, s1y, cx, cy) && in_seg(p1x, p1y, p2x, p2y, cx, cy);
}

__device__ bool diamond_crossing(float p1x, float p1y, float p2x, float p2y,
                                 float px, float py) {
  const float a0 = __fsub_rn(p1y, p2y);
  const float b0 = __fsub_rn(p2x, p1x);
  const float c0 = __fsub_rn(__fmul_rn(p1x, p2y), __fmul_rn(p2x, p1y));
  const float xl = __fsub_rn(px, 0.5f), xr = __fadd_rn(px, 0.5f);
  const float yt = __fsub_rn(py, 0.5f), yb = __fadd_rn(py, 0.5f);
  return seg_cross(a0, b0, c0, p1x, p1y, p2x, p2y, px, yt, xr, py) ||
         seg_cross(a0, b0, c0, p1x, p1y, p2x, p2y, xr, py, px, yb) ||
         seg_cross(a0, b0, c0, p1x, p1y, p2x, p2y, px, yb, xl, py) ||
         seg_cross(a0, b0, c0, p1x, p1y, p2x, p2y, xl, py, px, yt);
}

__global__ void lines_kernel(const float* __restrict__ rows,
                             const int32_t* __restrict__ meta,
                             const int64_t* __restrict__ ends,
                             unsigned long long* __restrict__ keys,
                             int32_t n_batch, int32_t n_faces, int32_t height,
                             int32_t width, int32_t y_offset) {
  const int64_t n_tri = static_cast<int64_t>(n_batch) * n_faces;
  const int64_t total = ends[n_tri - 1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       t < total; t += stride) {
    // The triangle: the first i with ends[i] > t (empty windows are skipped).
    int64_t lo = 0, hi = n_tri - 1;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (ends[mid] > t) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const int64_t i = lo;
    const int64_t off = t - (i == 0 ? 0 : ends[i - 1]);
    const int32_t* m = meta + i * kMeta;
    const int32_t bits = m[0], x_lo = m[1], x_hi = m[2], y_lo = m[3];
    const int64_t w_cols = x_hi - x_lo + 1;
    const int32_t y = y_lo + static_cast<int32_t>(off / w_cols);
    const int32_t x = x_lo + static_cast<int32_t>(off - (off / w_cols) * w_cols);
    const float px = static_cast<float>(x), py = static_cast<float>(y);

    const float* r = rows + i * kRow;
    const float e0 = edge(r[0], r[3], r[6], px, py);
    const float e1 = edge(r[1], r[4], r[7], px, py);
    const float e2 = edge(r[2], r[5], r[8], px, py);
    const bool inside = keep(e0, bits & 1) && keep(e1, bits & 2) && keep(e2, bits & 4);
    const float p0x = r[9], p0y = r[10], p1x = r[11], p1y = r[12];
    const float p2x = r[13], p2y = r[14];
    const bool crossing =
        ((bits & 8) && diamond_crossing(p0x, p0y, p1x, p1y, px, py)) ||
        ((bits & 16) && diamond_crossing(p1x, p1y, p2x, p2y, px, py)) ||
        ((bits & 32) && diamond_crossing(p0x, p0y, p2x, p2y, px, py));
    if (!inside && !crossing) continue;

    const float inv_den = r[18];
    const float b0 = fminf(fmaxf(__fmul_rn(e0, inv_den), 0.f), 1.f);
    const float b1 = fminf(fmaxf(__fmul_rn(e1, inv_den), 0.f), 1.f);
    const float b2 = fminf(fmaxf(__fmul_rn(e2, inv_den), 0.f), 1.f);
    const float bs = __fadd_rn(__fadd_rn(b0, b1), b2);
    const float di = __fadd_rn(
        __fadd_rn(__fmul_rn(__fdiv_rn(b0, bs), r[15]), __fmul_rn(__fdiv_rn(b1, bs), r[16])),
        __fmul_rn(__fdiv_rn(b2, bs), r[17]));
    // di >= 0 here; clearing the sign bit maps -0.0 to +0.0, which the
    // plain version's float comparisons treat as equal.
    const uint32_t dbits = __float_as_uint(di) & 0x7FFFFFFFu;
    const int32_t batch = static_cast<int32_t>(i / n_faces);
    const uint32_t id = crossing ? static_cast<uint32_t>(i - static_cast<int64_t>(batch) * n_faces)
                                 : kInterior;
    const unsigned long long key = (static_cast<unsigned long long>(~dbits) << 32) | id;
    atomicMin(keys + (static_cast<int64_t>(batch) * height + (y - y_offset)) * width + x, key);
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ keys,
                              float* __restrict__ depth,
                              int32_t* __restrict__ index, int64_t total) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const unsigned long long k = keys[i];
  if (k == kEmpty) {
    depth[i] = 0.f;
    index[i] = -1;
    return;
  }
  const uint32_t id = static_cast<uint32_t>(k & 0xFFFFFFFFull);
  const float di = __uint_as_float(~static_cast<uint32_t>(k >> 32));
  depth[i] = 1.0f / fmaxf(di, 1e-8f);  // 1 / epsclamp(di) for di >= 0
  index[i] = id == kInterior ? -1 : static_cast<int32_t>(id);
}

}  // namespace

extern "C" {

// rows [N, F, 19] f32, meta [N, F, 5] int32 (windows in frame rows within
// [y_offset, y_offset + height)), ends [N*F] int64 (inclusive running sum of
// the window areas), keys [N, H, W] uint64 scratch, depth [N, H, W] f32,
// index [N, H, W] int32; all contiguous, on the device of `stream`. Returns
// the first CUDA error of the memset and both launches.
int drtk_rasterize_lines_f32(const void* rows, const void* meta,
                             const void* ends, void* keys, void* depth,
                             void* index, int32_t n_batch, int32_t n_faces,
                             int32_t height, int32_t width, int32_t y_offset,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_pix = static_cast<int64_t>(n_batch) * height * width;
  cudaError_t err = cudaMemsetAsync(keys, 0xFF, n_pix * sizeof(kEmpty), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<int64_t>(n_batch) * n_faces > 0) {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int kThreads = 256;
    lines_kernel<<<sms * 8, kThreads, 0, s>>>(
        static_cast<const float*>(rows), static_cast<const int32_t*>(meta),
        static_cast<const int64_t*>(ends),
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
