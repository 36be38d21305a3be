// Z-buffer resolve of the triangle rasterizer (kernel B1 of drtk_tpu_torch).
//
// Replaces: drtk_tpu/ops/rasterize_pallas.py::_tile_kernel (launched by
//   rasterize_pallas). The TPU kernel bins triangles into 32x128 tiles
//   (_segment_pairs: tile segments, supertile and global lists of static
//   capacity F * MAX_SPAN) and keeps each tile's z-buffer on chip. This
//   kernel keeps that idea with Hopper's means: the bins are built on the
//   device with atomics, and each tile's z-buffer lives in registers.
//
// Computes, from the per-triangle setup rows that the wrapper packs with
//   torch ops (drtk_tpu_torch/ops/rasterize_cuda.py):
//   for every pixel centre (x, y) in the triangle's clipped bbox, the edge
//   values e_i = (ea_i*x + eb_i*y) + ec_i; the pixel is covered when every
//   e_i > 0, or e_i == 0 on a top-left edge. Its inverse depth is
//   di = (e_0*q_0 + e_1*q_1) + e_2*q_2. Each pixel keeps the largest di,
//   ties to the smaller triangle id, as the smallest key
//     (~float_bits(di) << 32) | id
//   (di >= 0 on covered pixels, so the float bits order like the floats).
//   It writes depth = 1 / max(di, 1e-8) and index = id, or depth 0 and
//   index -1 where no triangle covers the pixel.
//   Row-tile viewports: the wrapper clips the pixel ranges to the frame rows
//   [y_offset, y_offset + height); edge values use the frame's y and row y
//   lands in row y - y_offset, so a tile equals the same rows of the full
//   frame bit for bit.
//   Every product and sum is rounded on its own (__fmul_rn / __fadd_rn), in
//   the order of the plain version, so nvcc cannot contract them into FMAs
//   and the kernel agrees with the plain version bit for bit. A minimum of
//   keys does not depend on the order in which they arrive, so neither does
//   the result.
//
// Bound on this card: bytes at the shapes of the textured scene (1024^2,
//   51,200 triangles of ~20 pixels: 8 bytes of depth and index written per
//   pixel, 68 bytes of setup read per triangle), operations on the inverse8
//   views (~335 pixel centres tested per sliver triangle, 17 flops each).
//   What the kernel spends is instructions per tested centre, and the
//   binning's fixed cost of four dependent launches.
//
// Design: five operations on the caller's stream, no host synchronisation.
//   1. A memset zeroes the tile and big-list counts.
//   2. count: one thread per triangle finds the kTile x kTile screen tiles
//      that its pixel range touches. A triangle touching at most kMaxTiles
//      tiles adds one to each tile's count; a larger one appends itself to
//      its batch's big list.
//   3. scan: one block turns the tile counts into segment starts.
//   4. fill: one thread per triangle writes its id into each of its tiles'
//      segments. The pair buffer has the static capacity N * F * kMaxTiles
//      and the big lists N * F, so nothing is read back to the host.
//   5. resolve: one block of 128 threads per (tile, batch). A thread owns
//      two pixels of one column, 8 rows apart, and keeps each one's best key
//      in a register; a warp covers two blocks of 8 x 4 pixels. The block
//      stages its segment's triangles in shared memory, 256 at a time, and
//      marches them; then its batch's big list, keeping only the triangles
//      whose range meets the tile. Each thread tests a triangle only at those
//      of its pixels that its pixel range holds, so every (pixel, triangle)
//      of the plain version is tested once. The fill rule is one comparison
//      per edge against a staged threshold. Depth and index are written
//      straight from the registers: no key buffer and no global atomicMin.
//   A canvas-sized triangle costs one test per pixel spread over every tile
//   of the frame, instead of one thread walking its whole bbox.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCoef = 12;  // ea[3], eb[3], ec[3], q[3]
constexpr int kMeta = 5;   // top-left bits, x_lo, x_hi, y_lo, y_hi
constexpr int kTile = 16;      // tile side in pixels (TILE in ops/rasterize_cuda.py)
constexpr int kMaxTiles = 16;  // a triangle on more tiles goes to the big list (MAX_TILES there)
constexpr int kTileThreads = kTile * kTile / 2;  // two pixels per thread
constexpr int kChunk = 256;    // triangles staged in shared memory at a time
constexpr int kBinThreads = 256;
constexpr int kScanThreads = 1024;
constexpr unsigned long long kEmpty = ~0ull;
// The smallest positive float. The fill-rule thresholds need denormals kept:
// no -ftz / --use_fast_math in the build flags.
constexpr float kDenormMin = 0x1p-149f;
static_assert(kTile == 16, "resolve_kernel maps its 4 warps to 2 x (8 x 4) pixels of a 16 x 16 tile");

__device__ __forceinline__ float edge(float a, float b, float c, float px,
                                      float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

struct Span {
  int32_t tx0, tx1, ty0, ty1;  // inclusive tile range; empty when tx0 > tx1
};

// The tiles that triangle m's pixel range touches, clipped to the viewport.
__device__ __forceinline__ Span tile_span(const int32_t* m, int32_t height,
                                          int32_t width, int32_t y_offset) {
  const int32_t x_lo = max(m[1], 0), x_hi = min(m[2], width - 1);
  const int32_t y_lo = max(m[3] - y_offset, 0), y_hi = min(m[4] - y_offset, height - 1);
  if (x_lo > x_hi || y_lo > y_hi) return {0, -1, 0, -1};
  return {x_lo / kTile, x_hi / kTile, y_lo / kTile, y_hi / kTile};
}

__device__ __forceinline__ int64_t tiles_of(const Span& s) {
  return static_cast<int64_t>(s.tx1 - s.tx0 + 1) * (s.ty1 - s.ty0 + 1);
}

// One thread per triangle. Count pass (kFill false): add one to the count of
// each tile that the triangle's pixel range touches or, past kMaxTiles
// tiles, append the triangle to its batch's big list. Fill pass (kFill
// true): write the triangle into each of those tiles' segments, at the
// cursors that the scan left in `count`.
template <bool kFill>
__global__ void __launch_bounds__(kBinThreads)
bin_kernel(const int32_t* __restrict__ meta, int32_t* __restrict__ count,
           int32_t* __restrict__ big_count, int32_t* __restrict__ big,
           int32_t* __restrict__ pairs, int32_t n_faces, int32_t height, int32_t width,
           int32_t y_offset, int32_t tiles_x, int32_t tiles_per_batch) {
  const int32_t tri = blockIdx.x * kBinThreads + threadIdx.x;
  if (tri >= n_faces) return;
  const int32_t batch = blockIdx.y;
  const Span s = tile_span(meta + (static_cast<int64_t>(batch) * n_faces + tri) * kMeta,
                           height, width, y_offset);
  if (s.tx0 > s.tx1) return;
  if (tiles_of(s) > kMaxTiles) {
    if (!kFill) big[static_cast<int64_t>(batch) * n_faces + atomicAdd(big_count + batch, 1)] = tri;
    return;
  }
  int32_t* c = count + static_cast<int64_t>(batch) * tiles_per_batch;
  for (int32_t ty = s.ty0; ty <= s.ty1; ++ty) {
    for (int32_t tx = s.tx0; tx <= s.tx1; ++tx) {
      const int32_t at = atomicAdd(c + ty * tiles_x + tx, 1);
      if (kFill) pairs[at] = tri;
    }
  }
}

// Exclusive scan of count[0, m) into start[0, m], start[m] the total, in
// rounds of kScanThreads consecutive counts; count becomes the fill cursors
// (a copy of the starts).
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int32_t* __restrict__ count, int32_t* __restrict__ start, int32_t m) {
  __shared__ int32_t warp_sum[kScanThreads / 32];
  __shared__ int32_t carry;
  if (threadIdx.x == 0) carry = 0;
  const int32_t lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int32_t base = 0; base < m; base += kScanThreads) {
    const int32_t i = base + static_cast<int32_t>(threadIdx.x);
    const int32_t c = i < m ? count[i] : 0;
    int32_t incl = c;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp sums
      int32_t w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t o = __shfl_up_sync(0xFFFFFFFFu, w, d);
        if (lane >= d) w += o;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int32_t excl = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + incl - c;
    if (i < m) {
      start[i] = excl;
      count[i] = excl;
    }
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = excl + c;
    __syncthreads();
  }
  if (threadIdx.x == 0) start[m] = carry;
}

// Test the staged triangle t at pixel (px, py): fold its key into best when
// the pixel is covered.
__device__ __forceinline__ void test_pixel(const float4* t, float px, float py,
                                           unsigned long long& best) {
  // t[0] = ea0 ea1 ea2 eb0, t[1] = eb1 eb2 ec0 ec1, t[2] = ec2 q0 q1 q2,
  // t[3] = the thresholds and the id
  const float4 c0 = t[0], c1 = t[1], c2 = t[2], c3 = t[3];
  const float e0 = edge(c0.x, c0.w, c1.z, px, py);
  const float e1 = edge(c0.y, c1.x, c1.w, px, py);
  const float e2 = edge(c0.z, c1.y, c2.x, px, py);
  if (!(e0 > c3.x && e1 > c3.y && e2 > c3.z)) return;
  const float di = __fadd_rn(__fadd_rn(__fmul_rn(e0, c2.y), __fmul_rn(e1, c2.z)),
                             __fmul_rn(e2, c2.w));
  // di >= 0 here; clearing the sign bit maps -0.0 to +0.0, which the plain
  // version's float comparisons treat as equal.
  const uint32_t bits = __float_as_uint(di) & 0x7FFFFFFFu;
  const unsigned long long key =
      (static_cast<unsigned long long>(~bits) << 32) | __float_as_uint(c3.w);
  best = key < best ? key : best;
}

// Write one pixel's depth and index from its best key.
__device__ __forceinline__ void write_pixel(unsigned long long best, int64_t out,
                                            float* __restrict__ depth,
                                            int32_t* __restrict__ index) {
  if (best == kEmpty) {
    depth[out] = 0.f;
    index[out] = -1;
    return;
  }
  const float di = __uint_as_float(~static_cast<uint32_t>(best >> 32));
  depth[out] = 1.0f / fmaxf(di, 1e-8f);  // 1 / epsclamp(di) for di >= 0
  index[out] = static_cast<int32_t>(best & 0xFFFFFFFFull);
}

__global__ void __launch_bounds__(kTileThreads)
resolve_kernel(const float* __restrict__ coef, const int32_t* __restrict__ meta,
               const int32_t* __restrict__ start, const int32_t* __restrict__ pairs,
               const int32_t* __restrict__ big_count, const int32_t* __restrict__ big,
               float* __restrict__ depth, int32_t* __restrict__ index,
               int32_t n_faces, int32_t height, int32_t width, int32_t y_offset,
               int32_t tiles_x, int32_t tiles_per_batch) {
  // A staged triangle: its setup row, then its three edge thresholds and
  // its id (as float bits), as four float4 read back as broadcasts; and its
  // pixel range.
  __shared__ float4 s_tri[kChunk][4];
  __shared__ int4 s_range[kChunk];
  __shared__ int32_t s_n;

  const int32_t batch = blockIdx.y;
  const int32_t tile = blockIdx.x;
  const int32_t ty = tile / tiles_x;
  const int32_t tx = tile - ty * tiles_x;
  // A warp covers 8 columns by 4 rows of the tile, the shape that wastes
  // the fewest lanes on small and thin triangles, in rows 0-7 and again 8
  // rows lower: a thread owns the pixels (x, row) and (x, row + 8).
  const int32_t warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int32_t x = tx * kTile + warp % 2 * 8 + lane % 8;
  const int32_t row = ty * kTile + warp / 2 * 4 + lane / 8;
  const int32_t y = row + y_offset;  // frame rows y and y + 8
  const float px = static_cast<float>(x);
  const float py0 = static_cast<float>(y), py1 = static_cast<float>(y + 8);
  const int32_t tile_x0 = tx * kTile, tile_y0 = ty * kTile + y_offset;
  const float* cb = coef + static_cast<int64_t>(batch) * n_faces * kCoef;
  const int32_t* mb = meta + static_cast<int64_t>(batch) * n_faces * kMeta;
  unsigned long long best0 = kEmpty, best1 = kEmpty;

  // Stage list[0, n) in chunks, keeping the triangles whose range meets the
  // tile (all of a tile segment's do), and test them at this thread's pixels.
  auto march = [&](const int32_t* list, int32_t n) {
    for (int32_t base = 0; base < n; base += kChunk) {
      if (threadIdx.x == 0) s_n = 0;
      __syncthreads();
      for (int32_t i = base + static_cast<int32_t>(threadIdx.x); i < min(base + kChunk, n);
           i += kTileThreads) {
        const int32_t tri = list[i];
        const int32_t* m = mb + static_cast<int64_t>(tri) * kMeta;
        const int4 r = make_int4(m[1], m[2], m[3], m[4]);
        if (r.x <= tile_x0 + kTile - 1 && r.y >= tile_x0 && r.z <= tile_y0 + kTile - 1 &&
            r.w >= tile_y0) {
          const int32_t slot = atomicAdd(&s_n, 1);
          const float* c = cb + static_cast<int64_t>(tri) * kCoef;
          s_tri[slot][0] = make_float4(c[0], c[1], c[2], c[3]);
          s_tri[slot][1] = make_float4(c[4], c[5], c[6], c[7]);
          s_tri[slot][2] = make_float4(c[8], c[9], c[10], c[11]);
          // Edge i covers the pixel when e_i > 0, or e_i == 0 on a top-left
          // edge: e_i > threshold_i, with -(the smallest denormal) on a
          // top-left edge (no float lies between it and -0.0) and 0 elsewhere.
          s_tri[slot][3] = make_float4((m[0] & 1) ? -kDenormMin : 0.f, (m[0] & 2) ? -kDenormMin : 0.f,
                                       (m[0] & 4) ? -kDenormMin : 0.f, __int_as_float(tri));
          s_range[slot] = r;
        }
      }
      __syncthreads();
      const int32_t staged = s_n;
      for (int32_t j = 0; j < staged; ++j) {
        const int4 r = s_range[j];
        if (x < r.x || x > r.y) continue;
        const bool in0 = y >= r.z && y <= r.w, in1 = y + 8 >= r.z && y + 8 <= r.w;
        if (in0) test_pixel(s_tri[j], px, py0, best0);
        if (in1) test_pixel(s_tri[j], px, py1, best1);
      }
      __syncthreads();
    }
  };

  const int64_t seg = static_cast<int64_t>(batch) * tiles_per_batch + tile;
  march(pairs + start[seg], start[seg + 1] - start[seg]);
  march(big + static_cast<int64_t>(batch) * n_faces, big_count[batch]);

  if (x >= width) return;
  const int64_t out = (static_cast<int64_t>(batch) * height + row) * width + x;
  if (row < height) write_pixel(best0, out, depth, index);
  if (row + 8 < height) write_pixel(best1, out + 8 * static_cast<int64_t>(width), depth, index);
}

}  // namespace

extern "C" {

// coef [N, F, 12] f32, meta [N, F, 5] int32 (pixel ranges in frame rows
// within [y_offset, y_offset + height)), depth [N, H, W] f32, index
// [N, H, W] int32, and int32 scratch of N*T + N + N*T + 1 + N*F*kMaxTiles +
// N*F words: the tile counts, the big-list counts, the segment starts (the
// last one the pairs in use), the pairs and the big lists (batch n's from
// n*F), with T = ceil(H / kTile) * ceil(W / kTile); all contiguous, on the
// device of `stream`. Returns the first CUDA error of the memset and the
// launches.
int drtk_rasterize_f32(const void* coef, const void* meta, void* depth, void* index, void* scratch,
                       int32_t n_batch, int32_t n_faces, int32_t height, int32_t width,
                       int32_t y_offset, void* stream) {
  if (n_batch == 0 || height == 0 || width == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t tiles_x = (width + kTile - 1) / kTile;
  const int32_t tiles_per_batch = tiles_x * ((height + kTile - 1) / kTile);
  const int32_t n_tiles = n_batch * tiles_per_batch;
  int32_t* count = static_cast<int32_t*>(scratch);
  int32_t* big_count = count + n_tiles;
  int32_t* start = big_count + n_batch;
  int32_t* pair = start + n_tiles + 1;
  int32_t* big_list = pair + static_cast<int64_t>(n_batch) * n_faces * kMaxTiles;
  cudaError_t err =
      cudaMemsetAsync(count, 0, (static_cast<size_t>(n_tiles) + n_batch) * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 bin_grid(static_cast<unsigned int>((n_faces + kBinThreads - 1) / kBinThreads),
                      static_cast<unsigned int>(n_batch));
  const int32_t* m = static_cast<const int32_t*>(meta);
  if (n_faces > 0) {
    bin_kernel<false><<<bin_grid, kBinThreads, 0, s>>>(m, count, big_count, big_list, pair, n_faces,
                                                       height, width, y_offset, tiles_x,
                                                       tiles_per_batch);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<<<1, kScanThreads, 0, s>>>(count, start, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n_faces > 0) {
    bin_kernel<true><<<bin_grid, kBinThreads, 0, s>>>(m, count, big_count, big_list, pair, n_faces,
                                                      height, width, y_offset, tiles_x,
                                                      tiles_per_batch);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  resolve_kernel<<<dim3(static_cast<unsigned int>(tiles_per_batch), static_cast<unsigned int>(n_batch)),
                   kTileThreads, 0, s>>>(
      static_cast<const float*>(coef), m, start, pair, big_count, big_list,
      static_cast<float*>(depth), static_cast<int32_t*>(index),
      n_faces, height, width, y_offset, tiles_x, tiles_per_batch);
  return static_cast<int>(cudaGetLastError());
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
