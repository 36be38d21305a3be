// Render (kernel R1 of drtk_tpu_torch): the depth and perspective-correct
// barycentric images of an index image, and their VJP to the vertices, one
// thread per pixel each way.
//
// Replaces: drtk_tpu/ops/render.py:69 _render_fwd_math and :118
//   _render_core_bwd, plain XLA around kernel B2's gather of a [N, H, W, 9]
//   row of each pixel's corners (segment_rows.py:359) and, in the backward,
//   around kernel B3's accumulate of the [N, H, W, 9] gradient rows into
//   face rows (segment_rows.py:129) and the scatter of those to the
//   vertices. It has no pl.pallas_call of its own: R1 takes the XLA, B2 and
//   B3 of the op into one pass each way.
//
// Computes, per pixel (y, x) of rows [y_offset, y_offset + H) whose index
//   f = index[n, y, x] is >= 0 (clamped to F - 1), from the corners p_k of
//   face f of batch n (vertex ids clamped to [0, V - 1]), in the plain
//   version's order (drtk_tpu_torch/ops/render.py, _render_fwd_math):
//     den = epsclamp((p1 - p0).x * (p2 - p0).y - (p1 - p0).y * (p2 - p0).x),
//     b1, b2 = the pixel centre's edge functions over den,
//     b0 = (1 - b1) - b2, d_k = 1 / epsclamp(z_k),
//     depth = 1 / epsclamp((d_0 b0 + d_1 b1) + d_2 b2), bary_k = (d_k b_k) depth.
//   The forward writes depth [N, H, W] and bary [N, 3, H, W], zeros where
//   f < 0. The backward recomputes all of it from v, vi and the index
//   (nothing per pixel is kept from the forward), applies the clamp-aware
//   VJP of _render_bwd_math to the pixel's cotangents (a den, z_k or
//   depth_inv that epsclamp clamped kills its gradient path), adds the
//   nine values to face f's row of face_rows [N, F, 9], then folds each
//   face's row into its three vertices of grad_v [N, V, 3] (a second,
//   small launch); the wrapper zeroes both. A null cotangent reads as
//   zeros.
//
// Exactness: every product, sum and quotient is rounded on its own
//   (__fmul_rn and friends; nvcc would otherwise contract a * b + c into an
//   FMA), in the plain version's order, so the forward equals the plain
//   version's separately rounded torch ops bit for bit (background zeros
//   up to their sign). The backward's values are the plain version's up to
//   the order of two three-term sums (torch's .sum(-1)); the sums over a
//   face's pixels differ in order, as kernel B3's atomics do, and change
//   from run to run.
//
// Bound on this card: bytes. Forward: the index read (4 B a pixel), depth
//   and bary written (16 B); backward: the index and the cotangents read
//   (20 B). vi and v are read through L2 (600 KB and 300 KB on inverse8's
//   8 x 51,200 faces), and grad_v is added to there. ~60 flops a pixel
//   forward and ~130 backward are far under the card's rate. The backward's
//   cost beyond the bytes is its atomics: every covered pixel has 9 values.
//
// Design: one thread per pixel, a block of 32 x 8 threads per 32 x 8 pixel
//   tile (batch on blockIdx.y), a warp per tile row, so that a warp's
//   index, depth, bary and cotangent accesses are contiguous runs. A
//   covered pixel fetches its face's vertex ids, then its corners
//   (dependent loads; neighbouring pixels share faces, so they hit L1).
//   In the backward, the pixels of a warp's row mostly share faces: the
//   warp sums its 9 values over each run of equal face ids with segmented
//   shuffles, toward the run's first lane, which alone issues the 9
//   atomicAdds, to its face's row rather than to the vertices, which six
//   faces share. Measured on this card (PERF.md section 6): without the
//   combine the backward took 2.6x (inverse8's 8 x 1024^2) and 8.5x (a
//   8 x 1024 x 4096 block of rows4) the time; adding to the vertices
//   was 4 % faster on the first and 35 % slower on the second, where a
//   vertex gathers ~1,000 pixels' adds. Offsets within a batch are 32-bit
//   (the wrapper raises when an extent reaches 2^31).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFoldThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// epsclamp (ops/math.py): v < 0 ? min(v, -eps) : max(v, eps), NaN kept;
// -0.0 maps to +eps.
template <typename T>
__device__ __forceinline__ T epsclamp(T v) {
  const T eps = sizeof(T) == 8 ? T(1e-16) : T(1e-8);
  if (v < T(0)) return v < -eps ? v : -eps;
  return !(v < eps) ? v : eps;
}

template <typename T>
struct Args {
  const T* v;                // [N, V, 3] rows contiguous, batch stride v_sn (0: one v for all)
  const int32_t* vi;         // [N, F, 3] rows contiguous, batch stride vi_sn (0: one vi for all)
  const int32_t* index;      // [N, H, W] contiguous
  const T* grad_depth;       // [N, H, W], strides gd_sn, gd_sh, gd_sw; null: zeros
  const T* grad_bary;        // [N, 3, H, W], strides gb_sn, gb_sc, gb_sh, gb_sw; null: zeros
  T* depth;                  // [N, H, W] contiguous (forward)
  T* bary;                   // [N, 3, H, W] contiguous (forward)
  T* face_rows;              // [N, F, 9] contiguous, added to (backward)
  T* grad_v;                 // [N, V, 3] contiguous, added to (backward)
  int64_t v_sn, vi_sn, gd_sn, gd_sh, gd_sw, gb_sn, gb_sc, gb_sh, gb_sw;
  int32_t h, w, n_verts, n_faces, y_offset, tiles_x;
};

// The pixel of this thread: batch n, row y and column x of the block.
struct Pixel {
  int32_t n, y, x;
};

__device__ __forceinline__ Pixel this_pixel(int32_t tiles_x) {
  const int32_t tile = static_cast<int32_t>(blockIdx.x);
  return {static_cast<int32_t>(blockIdx.y), (tile / tiles_x) * kTileH + static_cast<int32_t>(threadIdx.x) / kTileW,
          (tile % tiles_x) * kTileW + static_cast<int32_t>(threadIdx.x) % kTileW};
}

// The corners (x, y, z at 0, 3, 6) of face f >= 0 of batch n, f clamped to
// F - 1 and its vertex ids to [0, V - 1] as the plain version's gathers
// clamp them; zeros without faces or vertices, as the plain gather's rows.
template <typename T>
__device__ __forceinline__ void face_corners(const Args<T>& a, int32_t n, int32_t f, T (&p)[9]) {
  if (a.n_faces == 0 || a.n_verts == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = T(0);
    return;
  }
  const int32_t* row = a.vi + n * a.vi_sn + min(f, a.n_faces - 1) * 3;
  int32_t id[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) id[k] = min(max(__ldg(row + k), 0), a.n_verts - 1);
  const T* v = a.v + n * a.v_sn;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) p[3 * k + c] = __ldg(v + id[k] * 3 + c);
  }
}

// The forward's intermediates at pixel centre (px, py) of a face of
// corners p, in _render_fwd_math's order.
template <typename T>
struct Fwd {
  T v01x, v01y, v02x, v02y;  // edges from corner 0
  T den_raw, den;            // the signed area, clamped
  T vx, vy;                  // pixel centre - corner 0
  T b[3];                    // 2-D barycentrics, b[1] and b[2] from b12 / den
  T z[3], z_eps[3], d_inv[3];  // z_k, epsclamp(z_k), 1 / z_eps
  T db[3];                   // d_inv * b
  T depth_inv_raw, depth_inv, depth;
};

template <typename T>
__device__ __forceinline__ Fwd<T> forward_math(const T (&p)[9], T px, T py) {
  Fwd<T> o;
  o.v01x = sub_rn(p[3], p[0]);
  o.v01y = sub_rn(p[4], p[1]);
  o.v02x = sub_rn(p[6], p[0]);
  o.v02y = sub_rn(p[7], p[1]);
  o.den_raw = sub_rn(mul_rn(o.v01x, o.v02y), mul_rn(o.v01y, o.v02x));
  o.den = epsclamp(o.den_raw);
  o.vx = sub_rn(px, p[0]);
  o.vy = sub_rn(py, p[1]);
  o.b[1] = div_rn(sub_rn(mul_rn(o.vx, o.v02y), mul_rn(o.vy, o.v02x)), o.den);
  o.b[2] = div_rn(sub_rn(mul_rn(o.vy, o.v01x), mul_rn(o.vx, o.v01y)), o.den);
  o.b[0] = sub_rn(sub_rn(T(1), o.b[1]), o.b[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.z[k] = p[3 * k + 2];
    o.z_eps[k] = epsclamp(o.z[k]);
    o.d_inv[k] = div_rn(T(1), o.z_eps[k]);
    o.db[k] = mul_rn(o.d_inv[k], o.b[k]);
  }
  o.depth_inv_raw = add_rn(add_rn(o.db[0], o.db[1]), o.db[2]);
  o.depth_inv = epsclamp(o.depth_inv_raw);
  o.depth = div_rn(T(1), o.depth_inv);
  return o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) render_forward_kernel(const Args<T> a) {
  const Pixel q = this_pixel(a.tiles_x);
  if (q.y >= a.h || q.x >= a.w) return;
  const int64_t hw = int64_t(a.h) * a.w;
  const int64_t at = q.n * hw + int64_t(q.y) * a.w + q.x;
  const int32_t f = __ldg(a.index + at);
  T depth = T(0), bary[3] = {T(0), T(0), T(0)};
  if (f >= 0) {
    T p[9];
    face_corners(a, q.n, f, p);
    const Fwd<T> m = forward_math(p, T(q.x), T(q.y + a.y_offset));
    depth = m.depth;
#pragma unroll
    for (int k = 0; k < 3; ++k) bary[k] = mul_rn(m.db[k], m.depth);
  }
  a.depth[at] = depth;
  T* out = a.bary + q.n * 3 * hw + int64_t(q.y) * a.w + q.x;
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k * hw] = bary[k];
}

// _render_bwd_math at one covered pixel: the gradient of its corner k's
// coordinate c at g[3 * k + c], from the cotangents gd (depth) and gb
// (bary), every clamped path killed.
template <typename T>
__device__ __forceinline__ void backward_math(const Fwd<T>& m, T gd, const T (&gb)[3], T (&g)[9]) {
  // dL/ddepth includes the path through bary_3d = d_inv * bary * depth.
  T t[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = mul_rn(mul_rn(gb[k], m.d_inv[k]), m.b[k]);
  const T dl_depth = add_rn(gd, add_rn(add_rn(t[0], t[1]), t[2]));
  const T dl_depth_inv =
      m.depth_inv != m.depth_inv_raw ? T(0) : div_rn(-dl_depth, mul_rn(m.depth_inv_raw, m.depth_inv_raw));
  T dl_bary[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T dl_d_inv = add_rn(mul_rn(mul_rn(gb[k], m.b[k]), m.depth), mul_rn(dl_depth_inv, m.b[k]));
    g[3 * k + 2] = m.z_eps[k] != m.z[k] ? T(0) : div_rn(-dl_d_inv, mul_rn(m.z_eps[k], m.z_eps[k]));
    dl_bary[k] = add_rn(mul_rn(mul_rn(gb[k], m.d_inv[k]), m.depth), mul_rn(dl_depth_inv, m.d_inv[k]));
  }
  const T pre0 = div_rn(add_rn(-dl_bary[0], dl_bary[1]), m.den);
  const T pre1 = div_rn(add_rn(-dl_bary[0], dl_bary[2]), m.den);
  const T dl_den = m.den != m.den_raw ? T(0) : -add_rn(mul_rn(pre0, m.b[1]), mul_rn(pre1, m.b[2]));
  const T dl_vx = sub_rn(mul_rn(pre0, m.v02y), mul_rn(pre1, m.v01y));
  const T dl_vy = add_rn(mul_rn(-pre0, m.v02x), mul_rn(pre1, m.v01x));
  g[6] = sub_rn(mul_rn(-pre0, m.vy), mul_rn(dl_den, m.v01y));  // dl_v02
  g[7] = add_rn(mul_rn(pre0, m.vx), mul_rn(dl_den, m.v01x));
  g[3] = add_rn(mul_rn(pre1, m.vy), mul_rn(dl_den, m.v02y));  // dl_v01
  g[4] = sub_rn(mul_rn(-pre1, m.vx), mul_rn(dl_den, m.v02x));
  g[0] = sub_rn(sub_rn(-g[6], g[3]), dl_vx);  // dl_p0
  g[1] = sub_rn(sub_rn(-g[7], g[4]), dl_vy);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) render_backward_kernel(const Args<T> a) {
  const Pixel q = this_pixel(a.tiles_x);
  if (q.y >= a.h) return;  // the whole warp: a warp is one row of the tile
  const int64_t hw = int64_t(a.h) * a.w;
  const int32_t f = q.x < a.w ? __ldg(a.index + q.n * hw + int64_t(q.y) * a.w + q.x) : -1;
  const int32_t face = f >= 0 ? min(f, a.n_faces - 1) : -1;
  if (__ballot_sync(kFull, face >= 0) == 0u) return;  // a row of background
  T g[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  if (face >= 0) {
    T p[9];
    face_corners(a, q.n, f, p);
    const Fwd<T> m = forward_math(p, T(q.x), T(q.y + a.y_offset));
    const T gd = a.grad_depth == nullptr
                     ? T(0)
                     : __ldg(a.grad_depth + q.n * a.gd_sn + q.y * a.gd_sh + q.x * a.gd_sw);
    T gb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gb[k] = a.grad_bary == nullptr
                  ? T(0)
                  : __ldg(a.grad_bary + q.n * a.gb_sn + k * a.gb_sc + q.y * a.gb_sh + q.x * a.gb_sw);
    }
    backward_math(m, gd, gb, g);
  }
  // Runs of equal faces along the warp's row: each lane sums the values of
  // the lanes after it up to its run's end, toward the run's first lane (a
  // segmented shuffle-down reduction), which alone adds them to the face's
  // row.
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int32_t next = __shfl_down_sync(kFull, face, 1);
  const unsigned ends = __ballot_sync(kFull, lane == 31 || next != face);
  const int run_end = __ffs(ends & (kFull << lane));  // one past the run's last lane
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const T o = __shfl_down_sync(kFull, g[j], d);
      if (lane + d < run_end) g[j] = add_rn(g[j], o);
    }
  }
  const bool first = lane == 0 || ((ends >> (lane - 1)) & 1u) != 0u;
  if (face < 0 || !first) return;
  T* row = a.face_rows + (int64_t(q.n) * a.n_faces + face) * 9;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    if (g[j] != T(0)) atomicAdd(row + j, g[j]);
  }
}

// The face rows to the vertices: one thread per face f of batch n adds its
// row's three corners to its vertices (ids clamped to [0, V - 1]), as the
// plain version's index_add_ does.
template <typename T>
__global__ void __launch_bounds__(kFoldThreads) faces_to_verts_kernel(const Args<T> a) {
  const int32_t f = static_cast<int32_t>(blockIdx.x) * kFoldThreads + static_cast<int32_t>(threadIdx.x);
  if (f >= a.n_faces) return;
  const int32_t n = static_cast<int32_t>(blockIdx.y);
  const T* row = a.face_rows + (int64_t(n) * a.n_faces + f) * 9;
  const int32_t* ids = a.vi + n * a.vi_sn + f * 3;
  T* out = a.grad_v + int64_t(n) * a.n_verts * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int32_t id = min(max(__ldg(ids + k), 0), a.n_verts - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T val = row[3 * k + c];
      if (val != T(0)) atomicAdd(out + id * 3 + c, val);
    }
  }
}

// The launch's scalars: extents, y_offset, the batch strides of v and vi
// and the strides of the cotangents (all in elements).
struct Shape {
  int32_t n_batch, h, w, n_verts, n_faces, y_offset;
  int64_t v_sn, vi_sn, gd_sn, gd_sh, gd_sw, gb_sn, gb_sc, gb_sh, gb_sw;
};

template <typename T>
int launch(const void* v, const void* vi, const void* index, const void* grad_depth, const void* grad_bary,
           void* depth, void* bary, void* face_rows, void* grad_v, const Shape& d, void* stream) {
  if (d.n_batch == 0 || d.h == 0 || d.w == 0) return static_cast<int>(cudaGetLastError());
  const bool backward = grad_v != nullptr;
  // The backward adds nothing where no face or vertex can receive it, or
  // where no cotangent arrived.
  if (backward && (d.n_faces == 0 || d.n_verts == 0 || (grad_depth == nullptr && grad_bary == nullptr))) {
    return static_cast<int>(cudaGetLastError());
  }
  Args<T> a;
  a.v = static_cast<const T*>(v);
  a.vi = static_cast<const int32_t*>(vi);
  a.index = static_cast<const int32_t*>(index);
  a.grad_depth = static_cast<const T*>(grad_depth);
  a.grad_bary = static_cast<const T*>(grad_bary);
  a.depth = static_cast<T*>(depth);
  a.bary = static_cast<T*>(bary);
  a.face_rows = static_cast<T*>(face_rows);
  a.grad_v = static_cast<T*>(grad_v);
  a.v_sn = d.v_sn;
  a.vi_sn = d.vi_sn;
  a.gd_sn = d.gd_sn;
  a.gd_sh = d.gd_sh;
  a.gd_sw = d.gd_sw;
  a.gb_sn = d.gb_sn;
  a.gb_sc = d.gb_sc;
  a.gb_sh = d.gb_sh;
  a.gb_sw = d.gb_sw;
  a.h = d.h;
  a.w = d.w;
  a.n_verts = d.n_verts;
  a.n_faces = d.n_faces;
  a.y_offset = d.y_offset;
  a.tiles_x = (d.w + kTileW - 1) / kTileW;
  const dim3 grid(static_cast<unsigned int>(a.tiles_x * ((d.h + kTileH - 1) / kTileH)),
                  static_cast<unsigned int>(d.n_batch));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (backward) {
    render_backward_kernel<T><<<grid, kThreads, 0, s>>>(a);
    const dim3 fold((static_cast<unsigned int>(d.n_faces) + kFoldThreads - 1) / kFoldThreads,
                    static_cast<unsigned int>(d.n_batch));
    faces_to_verts_kernel<T><<<fold, kFoldThreads, 0, s>>>(a);
  } else {
    render_forward_kernel<T><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// v [N, V, 3] and vi [N, F, 3] int32 with contiguous rows (batch strides in
// `shape`, 0 for one shared by every batch); index [N, H, W] int32,
// contiguous; depth [N, H, W] and bary [N, 3, H, W], contiguous, written.
// All on the device of `stream`; N <= 65535; offsets within a batch below
// 2^31. Row 0 of the index is global row y_offset. Returns
// cudaGetLastError() after the launch.
int drtk_render_fwd_f32(const void* v, const void* vi, const void* index, void* depth, void* bary,
                        const void* shape, void* stream) {
  return launch<float>(v, vi, index, nullptr, nullptr, depth, bary, nullptr, nullptr,
                       *static_cast<const Shape*>(shape), stream);
}

int drtk_render_fwd_f64(const void* v, const void* vi, const void* index, void* depth, void* bary,
                        const void* shape, void* stream) {
  return launch<double>(v, vi, index, nullptr, nullptr, depth, bary, nullptr, nullptr,
                        *static_cast<const Shape*>(shape), stream);
}

// As the forward, with grad_depth [N, H, W] and grad_bary [N, 3, H, W] of
// any strides (in `shape`; null: zeros), face_rows [N, F, 9] (scratch) and
// grad_v [N, V, 3], both contiguous, zeroed by the caller; grad_v is added
// to. Launches the pixel pass and then the fold of the face rows.
int drtk_render_bwd_f32(const void* v, const void* vi, const void* index, const void* grad_depth,
                        const void* grad_bary, void* face_rows, void* grad_v, const void* shape, void* stream) {
  return launch<float>(v, vi, index, grad_depth, grad_bary, nullptr, nullptr, face_rows, grad_v,
                       *static_cast<const Shape*>(shape), stream);
}

int drtk_render_bwd_f64(const void* v, const void* vi, const void* index, const void* grad_depth,
                        const void* grad_bary, void* face_rows, void* grad_v, const void* shape, void* stream) {
  return launch<double>(v, vi, index, grad_depth, grad_bary, nullptr, nullptr, face_rows, grad_v,
                        *static_cast<const Shape*>(shape), stream);
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
