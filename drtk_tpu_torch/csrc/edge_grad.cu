// Edge-gradient CRD stencil (kernel E1 of drtk_tpu_torch).
//
// Replaces: drtk_tpu/ops/edge_grad.py:114 _edge_grad_backward, which is one
//   Pallas launch (kernel B2's K = 16 gather of a per-face stencil row,
//   segment_rows.py:396) and the XLA around it that jax.jit fuses into the
//   step: ~100 elementwise ops over [N, H, W], which the port ran as ~590
//   eager launches and a [N, H, W, 16] gathered intermediate.
//
// Computes, for every stencil centre (y, x) with x < W - 1 and y < H - 1
//   (on a row tile also y + y_offset < full_height - 1), the Centre / Right /
//   Down stencil of the plain version (drtk_tpu_torch/ops/edge_grad.py,
//   _stencil_plain): where the index changes to the right (below), the
//   coverage of each pixel centre by the other pixel's triangle under the
//   top-left rule, classified as overlap, intersection or adjacent; the
//   image-difference dot gdx (gdy) of the C channels, in channel order; the
//   contributions gvc (x, y, z), gvr (x, z) and gvd (y, z), spread through
//   dp_dr of the projected face normals at intersections. Then each output
//   pixel once, in the plain version's order:
//     out(y, x) = ((0 - gvc(y, x)) - gvr(y, x - 1)) - gvd(y - 1, x)
//   Image mode writes out [N, 3, H, W]; rows mode writes the per-pixel rows
//   bary[k] * out[j] at 3k + j, [N, H, W, 9], that kernel B3 reduces.
//
// Exactness: every product, sum, quotient and square root is rounded on its
//   own (__fmul_rn and friends; nvcc would otherwise contract a * b + c into
//   an FMA), in the plain version's order, so coverage and the classes match
//   its separately rounded torch ops bit for bit, pixel centres on edges
//   included. Only the channel sum and the norms may differ from torch's in
//   the last bits, where torch sums in another order. No atomics: each output
//   is written once, so the result is deterministic.
//
// Bound on this card: bytes. Each pixel's index (4 B), bary (12 B) and rows
//   (36 B) or image gradient (12 B) are read or written once; img and the
//   cotangent (4C B each) are read only at pixels whose index differs from
//   the right or lower neighbour's, and the table's rows (48 of each 64 B
//   row) stay in the 50 MB L2. Per stencil at a discontinuity the kernel
//   does ~100-200 flops, well under the card's f32 rate at this byte count.
//
// Design: one block of 32 x 8 threads per 32 x 8 pixel tile (batch on
//   blockIdx.y), a thread per pixel, a warp per tile row, so the index and
//   image loads of a warp are one contiguous run. Each thread evaluates its
//   own stencil (nothing to read past the index where the index does not
//   change, most pixels of a mesh), keeps gvc in registers and puts gvr and
//   gvd in shared memory; 40 threads then evaluate the halo stencils (the
//   row above the tile, the column left of it); after one barrier each
//   thread sums its pixel. In rows mode each thread loads its bary before
//   its stencil, and each warp stages its 32 rows of 9 values in shared
//   memory and writes them as one run of 16-byte vectors. Stencil rows are gathered by index inside the
//   stencil (a zero row where the index is negative, the index clamped to
//   F - 1 as B2 does) with 16-byte loads. Offsets within a batch are 32-bit
//   (the wrapper raises when an extent reaches 2^31).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kHalo = kTileW + kTileH;  // the row above the tile, then the column left of it
constexpr int kRowStride = 16;          // floats per stencil table row: corners 9, normal 3, zeros 4
constexpr int kRowUsed = 12;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

// epsclamp (ops/math.py): v < 0 ? min(v, -eps) : max(v, eps), NaN kept.
template <typename T>
__device__ __forceinline__ T epsclamp(T v) {
  const T eps = sizeof(T) == 8 ? T(1e-16) : T(1e-8);
  if (v < T(0)) return v < -eps ? v : -eps;
  return !(v < eps) ? v : eps;
}

// torch.maximum: NaN if either is NaN.
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T>
struct Args {
  const T* table;          // [N, F, 16]
  const int32_t* index;    // [N, H, W] rows contiguous, batch stride idx_sn
  const T* img;            // [N, C, H, W] rows contiguous, strides img_sn, img_sc
  const T* grad;           // [N, C, H, W] rows contiguous, strides grad_sn, grad_sc
  const T* bary;           // [N, 3, H, W] rows contiguous (rows mode), strides bary_sn, bary_sc
  T* out;                  // [N, H, W, 9] (rows mode) or [N, 3, H, W], contiguous
  int64_t idx_sn, img_sn, grad_sn, bary_sn;
  int32_t img_sc, grad_sc, bary_sc;
  int32_t c_dim, h, w, n_faces, y_offset;
  int32_t y_end;           // stencil centres lie in rows [0, y_end) of the block
  int32_t tiles_x;
  bool clamp;              // max_dp_dr > 0
  T max_dp_dr;
};

template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ tab, int32_t f, int32_t n_faces,
                                         T (&row)[kRowUsed]) {
  if (f < 0 || n_faces == 0) {
#pragma unroll
    for (int i = 0; i < kRowUsed; ++i) row[i] = T(0);
    return;
  }
  using V = typename Vec<T>::type;
  const V* src = reinterpret_cast<const V*>(tab + min(f, n_faces - 1) * kRowStride);
#pragma unroll
  for (int i = 0; i < kRowUsed / Vec<T>::n; ++i) {
    const V v = __ldg(src + i);
    if constexpr (Vec<T>::n == 4) {
      row[4 * i] = v.x; row[4 * i + 1] = v.y; row[4 * i + 2] = v.z; row[4 * i + 3] = v.w;
    } else {
      row[2 * i] = v.x; row[2 * i + 1] = v.y;
    }
  }
}

// The top-left rule for edge e of a triangle of signed area den.
template <typename T>
__device__ __forceinline__ bool top_left(T ex, T ey, T den, bool invert) {
  bool pos = ey < T(0) || (ey == T(0) && ex > T(0));
  bool neg = ey > T(0) || (ey == T(0) && ex < T(0));
  if (invert) {
    const bool t = pos;
    pos = neg;
    neg = t;
  }
  return den > T(0) ? pos : neg;
}

// _pix_in_tri: is (px, py) covered by the triangle of row p (corners at 0, 3, 6)?
template <typename T>
__device__ bool pix_in_tri(const T (&p)[kRowUsed], T px, T py) {
  const T v01x = sub_rn(p[3], p[0]), v01y = sub_rn(p[4], p[1]);
  const T v02x = sub_rn(p[6], p[0]), v02y = sub_rn(p[7], p[1]);
  const T v12x = sub_rn(p[6], p[3]), v12y = sub_rn(p[7], p[4]);
  const T den = sub_rn(mul_rn(v01x, v02y), mul_rn(v01y, v02x));
  const T sgn = T(int(T(0) < den) - int(den < T(0)));  // torch.sign: 0 for NaN
  const T vp0x = sub_rn(px, p[0]), vp0y = sub_rn(py, p[1]);
  const T vp1x = sub_rn(px, p[3]), vp1y = sub_rn(py, p[4]);
  const T b0 = mul_rn(sub_rn(mul_rn(vp1y, v12x), mul_rn(vp1x, v12y)), sgn);
  const T b1 = mul_rn(sub_rn(mul_rn(vp0x, v02y), mul_rn(vp0y, v02x)), sgn);
  const T b2 = mul_rn(sub_rn(mul_rn(vp0y, v01x), mul_rn(vp0x, v01y)), sgn);
  const bool tl0 = top_left(v12x, v12y, den, false);
  const bool tl1 = top_left(v02x, v02y, den, true);
  const bool tl2 = top_left(v01x, v01y, den, false);
  const bool inside = b0 >= T(0) && b1 >= T(0) && b2 >= T(0);
  const bool reject = (b0 == T(0) && !tl0) || (b1 == T(0) && !tl1) || (b2 == T(0) && !tl2);
  return inside && !reject && den != T(0);
}

// _safe_normalize of a 2-vector, in place.
template <typename T>
__device__ __forceinline__ void normalize2(T& a, T& b) {
  const T n = sqrt_rn(add_rn(mul_rn(a, a), mul_rn(b, b)));
  const T d = n == T(0) ? T(1) : n;
  a = div_rn(a, d);
  b = div_rn(b, d);
}

// _get_dp_dr: the factors (o0, o1) that spread the dot when the face of
// normal (v0, v1) moves against the fixed face of normal (f0, f1).
template <typename T>
__device__ void dp_dr(T v0, T v1, T f0, T f1, bool clamp, T max_dp_dr, T& o0, T& o1) {
  normalize2(v0, v1);
  normalize2(f0, f1);
  const T bx = -f1, by = f0;
  const T d = add_rn(mul_rn(bx, v0), mul_rn(by, v1));
  T scale;
  if (clamp) {
    const T abs_bx_over_m = div_rn(abs_of(bx), max_dp_dr);
    const T sign_d = d >= T(0) ? T(1) : T(-1);
    const T safe_d = mul_rn(sign_d, epsclamp(maximum(abs_of(d), abs_bx_over_m)));
    scale = div_rn(bx, safe_d);
  } else {
    scale = div_rn(bx, epsclamp(d));
  }
  o0 = mul_rn(scale, v0);
  o1 = mul_rn(scale, v1);
}

template <typename T>
struct Contrib {
  T cx, cy, cz;  // gvc
  T rx, rz;      // gvr
  T dy, dz;      // gvd
};

// sum_c (img[q + step] - img[q]) * (0.5 * (g[q + step] + g[q])), channels in order.
template <typename T>
__device__ __forceinline__ T image_dot(const Args<T>& a, const T* img, const T* g, int32_t p, int32_t step) {
  T acc = T(0);
  for (int32_t ch = 0; ch < a.c_dim; ++ch) {
    const T* ic = img + ch * a.img_sc + p;
    const T* gc = g + ch * a.grad_sc + p;
    const T di = sub_rn(__ldg(ic + step), __ldg(ic));
    const T gs = mul_rn(T(0.5), add_rn(__ldg(gc + step), __ldg(gc)));
    acc = add_rn(acc, mul_rn(di, gs));
  }
  return acc;
}

// The contributions of the stencil centred at (y, x) of batch n; zeros
// outside the stencil centres.
template <typename T>
__device__ __forceinline__ Contrib<T> stencil(const Args<T>& a, int32_t n, int32_t y, int32_t x) {
  Contrib<T> o = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  if (y < 0 || x < 0 || y >= a.y_end || x >= a.w - 1) return o;
  const int32_t* idx = a.index + n * a.idx_sn;
  const int32_t p = y * a.w + x;
  const int32_t ic = __ldg(idx + p), ir = __ldg(idx + p + 1), id = __ldg(idx + p + a.w);
  const bool lr = ic != ir, ud = ic != id;
  if (!lr && !ud) return o;
  const bool cv = ic >= 0, rv = ir >= 0, dv = id >= 0;
  const T* img = a.img + n * a.img_sn;
  const T* g = a.grad + n * a.grad_sn;
  const T* tab = a.table + n * int64_t(a.n_faces) * kRowStride;
  T rc[kRowUsed];
  if (cv && ((lr && rv) || (ud && dv))) load_row(tab, ic, a.n_faces, rc);
  const T px = T(x), py = T(y + a.y_offset);
  T zx = T(0), zy = T(0);
  if (lr) {
    const T gdx = image_dot(a, img, g, p, 1);
    T rr[kRowUsed];
    bool c_in_r = false, r_in_c = false;
    if (cv && rv) {
      load_row(tab, ir, a.n_faces, rr);
      c_in_r = pix_in_tri(rr, px, py);
      r_in_c = pix_in_tri(rc, add_rn(px, T(1)), py);
    }
    if (c_in_r && r_in_c) {  // intersection: x and z of both sides through dp_dr
      T c0, c1, r0, r1;
      dp_dr(rc[9], rc[11], rr[9], rr[11], a.clamp, a.max_dp_dr, c0, c1);
      dp_dr(rr[9], rr[11], rc[9], rc[11], a.clamp, a.max_dp_dr, r0, r1);
      o.cx = mul_rn(gdx, c0);
      zx = mul_rn(gdx, c1);
      o.rx = mul_rn(gdx, r0);
      o.rz = mul_rn(gdx, r1);
    } else {
      const bool adjacent = cv && rv && !c_in_r && !r_in_c;
      o.cx = (cv && !r_in_c && !adjacent) ? gdx : T(0);  // not (right over left)
      o.rx = (rv && !c_in_r && !adjacent) ? gdx : T(0);  // not (left over right)
    }
  }
  if (ud) {
    const T gdy = image_dot(a, img, g, p, a.w);
    T rd[kRowUsed];
    bool c_in_d = false, d_in_c = false;
    if (cv && dv) {
      load_row(tab, id, a.n_faces, rd);
      c_in_d = pix_in_tri(rd, px, py);
      d_in_c = pix_in_tri(rc, px, add_rn(py, T(1)));
    }
    if (c_in_d && d_in_c) {
      T c0, c1, d0, d1;
      dp_dr(rc[10], rc[11], rd[10], rd[11], a.clamp, a.max_dp_dr, c0, c1);
      dp_dr(rd[10], rd[11], rc[10], rc[11], a.clamp, a.max_dp_dr, d0, d1);
      o.cy = mul_rn(gdy, c0);
      zy = mul_rn(gdy, c1);
      o.dy = mul_rn(gdy, d0);
      o.dz = mul_rn(gdy, d1);
    } else {
      const bool adjacent = cv && dv && !c_in_d && !d_in_c;
      o.cy = (cv && !d_in_c && !adjacent) ? gdy : T(0);  // not (down over up)
      o.dy = (dv && !c_in_d && !adjacent) ? gdy : T(0);  // not (up over down)
    }
  }
  o.cz = add_rn(zx, zy);
  return o;
}

template <typename T, bool kRows>
__global__ void __launch_bounds__(kThreads) edge_grad_kernel(const Args<T> a) {
  __shared__ T right_of[kTileH][kTileW + 1][2];  // gvr (x, z) of centre (y0 + i, x0 - 1 + j)
  __shared__ T down_of[kTileH + 1][kTileW][2];   // gvd (y, z) of centre (y0 - 1 + i, x0 + j)
  // Rows mode: each warp's 32 rows of 9 values, written out as one run.
  __shared__ __align__(16) T rows_of[kRows ? kTileH : 1][kRows ? kTileW * 9 : 1];
  const int32_t n = blockIdx.y;
  const int32_t y0 = (blockIdx.x / a.tiles_x) * kTileH;
  const int32_t x0 = (blockIdx.x % a.tiles_x) * kTileW;
  const int32_t tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
  const int32_t y = y0 + ty, x = x0 + tx;
  const bool inside = y < a.h && x < a.w;
  const int32_t p = y * a.w + x;
  const int64_t hw = int64_t(a.h) * a.w;

  // bary does not depend on the stencil: its loads are issued first.
  T bary[3] = {T(0), T(0), T(0)};
  if constexpr (kRows) {
    if (inside) {
#pragma unroll
      for (int k = 0; k < 3; ++k) bary[k] = __ldg(a.bary + n * a.bary_sn + k * a.bary_sc + p);
    }
  }

  // Pass 0: this thread's own stencil; pass 1: threads 0-39 take the halo
  // (threads 0-31 the row above the tile, 32-39 the column left of it).
  Contrib<T> own = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    int32_t sy = y, sx = x;
    if (pass == 1) {
      if (threadIdx.x >= kHalo) break;
      const bool above = threadIdx.x < kTileW;
      sy = above ? y0 - 1 : y0 + static_cast<int32_t>(threadIdx.x) - kTileW;
      sx = above ? x0 + static_cast<int32_t>(threadIdx.x) : x0 - 1;
    }
    const Contrib<T> c = stencil(a, n, sy, sx);
    if (pass == 0) {
      own = c;
      right_of[ty][tx + 1][0] = c.rx;
      right_of[ty][tx + 1][1] = c.rz;
      down_of[ty + 1][tx][0] = c.dy;
      down_of[ty + 1][tx][1] = c.dz;
    } else if (threadIdx.x < kTileW) {
      down_of[0][threadIdx.x][0] = c.dy;
      down_of[0][threadIdx.x][1] = c.dz;
    } else {
      right_of[threadIdx.x - kTileW][0][0] = c.rx;
      right_of[threadIdx.x - kTileW][0][1] = c.rz;
    }
  }
  __syncthreads();

  const T ox = sub_rn(sub_rn(T(0), own.cx), right_of[ty][tx][0]);
  const T oy = sub_rn(sub_rn(T(0), own.cy), down_of[ty][tx][0]);
  const T oz = sub_rn(sub_rn(sub_rn(T(0), own.cz), right_of[ty][tx][1]), down_of[ty][tx][1]);
  if constexpr (kRows) {
    T* stage = rows_of[ty];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      stage[tx * 9 + 3 * k] = mul_rn(bary[k], ox);
      stage[tx * 9 + 3 * k + 1] = mul_rn(bary[k], oy);
      stage[tx * 9 + 3 * k + 2] = mul_rn(bary[k], oz);
    }
    __syncwarp();
    if (y < a.h) {  // the warp's run: its row's pixels [x0, x0 + count), 9 values each
      const int32_t len = min(kTileW, a.w - x0) * 9;
      T* dst = a.out + (n * hw + int64_t(y) * a.w + x0) * 9;
      using V = typename Vec<T>::type;
      constexpr int kVec = Vec<T>::n;
      if (reinterpret_cast<uintptr_t>(dst) % 16 == 0 && len % kVec == 0) {
        for (int32_t v = tx; v < len / kVec; v += kTileW) {
          reinterpret_cast<V*>(dst)[v] = reinterpret_cast<const V*>(stage)[v];
        }
      } else {
        for (int32_t j = tx; j < len; j += kTileW) dst[j] = stage[j];
      }
    }
  } else if (inside) {
    T* dst = a.out + n * 3 * hw + p;
    dst[0] = ox;
    dst[hw] = oy;
    dst[2 * hw] = oz;
  }
}

template <typename T>
int launch(const void* table, const void* index, const void* img, const void* grad, const void* bary, void* out,
           int32_t n_batch, int32_t c_dim, int32_t h, int32_t w, int32_t n_faces, int64_t idx_sn, int64_t img_sn,
           int64_t img_sc, int64_t grad_sn, int64_t grad_sc, int64_t bary_sn, int64_t bary_sc, double max_dp_dr,
           int32_t y_offset, int32_t y_end, void* stream) {
  if (n_batch == 0 || h == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  Args<T> a;
  a.table = static_cast<const T*>(table);
  a.index = static_cast<const int32_t*>(index);
  a.img = static_cast<const T*>(img);
  a.grad = static_cast<const T*>(grad);
  a.bary = static_cast<const T*>(bary);
  a.out = static_cast<T*>(out);
  a.idx_sn = idx_sn;
  a.img_sn = img_sn;
  a.grad_sn = grad_sn;
  a.bary_sn = bary_sn;
  a.img_sc = static_cast<int32_t>(img_sc);
  a.grad_sc = static_cast<int32_t>(grad_sc);
  a.bary_sc = static_cast<int32_t>(bary_sc);
  a.c_dim = c_dim;
  a.h = h;
  a.w = w;
  a.n_faces = n_faces;
  a.y_offset = y_offset;
  a.y_end = y_end;
  a.tiles_x = (w + kTileW - 1) / kTileW;
  a.clamp = max_dp_dr > 0;
  a.max_dp_dr = static_cast<T>(max_dp_dr);
  const dim3 grid(static_cast<unsigned int>(a.tiles_x * ((h + kTileH - 1) / kTileH)),
                  static_cast<unsigned int>(n_batch));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bary != nullptr) {
    edge_grad_kernel<T, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    edge_grad_kernel<T, false><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table [N, F, 16] contiguous and 16-byte aligned; index [N, H, W] int32,
// img and grad [N, C, H, W], bary [N, 3, H, W] or null (image mode), each
// with contiguous rows and the given batch (and channel) strides in
// elements; out [N, H, W, 9] (rows mode) or [N, 3, H, W], contiguous. All on
// the device of `stream`; N <= 65535; offsets within a batch below 2^31.
// Stencil centres lie in rows [0, y_end); y_offset is the global row of row
// 0. Returns cudaGetLastError() after the launch.
int drtk_edge_grad_f32(const void* table, const void* index, const void* img, const void* grad, const void* bary,
                       void* out, int32_t n_batch, int32_t c_dim, int32_t h, int32_t w, int32_t n_faces,
                       int64_t idx_sn, int64_t img_sn, int64_t img_sc, int64_t grad_sn, int64_t grad_sc,
                       int64_t bary_sn, int64_t bary_sc, double max_dp_dr, int32_t y_offset, int32_t y_end,
                       void* stream) {
  return launch<float>(table, index, img, grad, bary, out, n_batch, c_dim, h, w, n_faces, idx_sn, img_sn, img_sc,
                       grad_sn, grad_sc, bary_sn, bary_sc, max_dp_dr, y_offset, y_end, stream);
}

int drtk_edge_grad_f64(const void* table, const void* index, const void* img, const void* grad, const void* bary,
                       void* out, int32_t n_batch, int32_t c_dim, int32_t h, int32_t w, int32_t n_faces,
                       int64_t idx_sn, int64_t img_sn, int64_t img_sc, int64_t grad_sn, int64_t grad_sc,
                       int64_t bary_sn, int64_t bary_sc, double max_dp_dr, int32_t y_offset, int32_t y_end,
                       void* stream) {
  return launch<double>(table, index, img, grad, bary, out, n_batch, c_dim, h, w, n_faces, idx_sn, img_sn, img_sc,
                        grad_sn, grad_sc, bary_sn, bary_sc, max_dp_dr, y_offset, y_end, stream);
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
