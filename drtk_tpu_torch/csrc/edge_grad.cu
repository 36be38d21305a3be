// Edge-gradient backward (kernel E1 of drtk_tpu_torch): the CRD stencil of
// the index image and its reduction to a vertex gradient, in one launch.
//
// Replaces: drtk_tpu/ops/edge_grad.py:114 _edge_grad_backward and :288-318
//   _edge_grad_core_bwd. In JAX that is kernel B2's K = 16 gather of a
//   per-face stencil row (corners and normal, segment_rows.py:396), the XLA
//   stencil over [N, H, W] that jax.jit fuses, kernel B3's Pallas
//   accumulate of the per-pixel bary x g rows into face rows
//   (segment_rows.py:129) and the .at[].add scatter of the face rows to the
//   vertices.
//
// Computes, for every stencil centre (y, x) with x < W - 1 and y < H - 1
//   (on a row tile also y + y_offset < full_height - 1), the Centre / Right /
//   Down stencil of the plain version (drtk_tpu_torch/ops/edge_grad.py,
//   _stencil_plain): where the index changes to the right (below), the
//   coverage of each pixel centre by the other pixel's triangle under the
//   top-left rule, classified as overlap, intersection or adjacent; the
//   image-difference dot gdx (gdy) of the C channels, in channel order; the
//   contributions gvc (x, y, z), gvr (x, z) and gvd (y, z), spread through
//   dp_dr of the projected face normals at intersections. Each part belongs
//   to one pixel q: gvc to (y, x), gvr to (y, x + 1), gvd to (y + 1, x).
//   Verts mode (the backward): for each nonzero part, where f = index[q] >= 0
//   (clamped to F - 1), adds -bary_k(q) * part_j to
//   grad_v[n, clamp(vi[n, f, k], 0, V - 1), j] with atomicAdd; the wrapper
//   zeroes grad_v and may pass one accumulator to several launches (the
//   bands of a frame). Image mode (edge_grad_image) writes each pixel of
//   [N, 3, H, W] once, in the plain version's order:
//     out(y, x) = ((0 - gvc(y, x)) - gvr(y, x - 1)) - gvd(y - 1, x)
//   A pixel that gets two or three parts is summed per vertex in verts mode,
//   per pixel in image mode: the values differ only in rounding, and the
//   atomics' order, like kernel B3's, changes from run to run.
//
// Exactness: every product, sum, quotient and square root is rounded on its
//   own (__fmul_rn and friends; nvcc would otherwise contract a * b + c into
//   an FMA), in the plain version's order, so coverage and the classes match
//   its separately rounded torch ops bit for bit, pixel centres on edges
//   included. The corners are gathered from v_pix through vi (exact), and a
//   face normal, normalize(cross(p0 - p2, p1 - p0)), is computed only at an
//   intersection, its norms as the plain version computes them (squares
//   summed in axis order). Only the channel sum may differ from torch's in
//   the last bits, where torch sums in another order.
//
// Bound on this card: bytes, and on a mesh those of the index alone. Every
//   centre reads its own, right and lower index (4 B a pixel from device
//   memory; the neighbours' come from L1). All else is sparse: img and the
//   cotangent (4C B each, two pixels) only at centres where a class gives a
//   nonzero part (4,353 of 1,048,576 pixels on the textured scene), bary
//   (12 B) only at the pixels that receive one, the corners through vi at
//   index changes (L2-resident), and 9 atomics per part. The flops, ~100-200
//   per contributing stencil, are far under the f32 rate.
//
// Design: one thread per stencil centre, a block of 32 x 8 threads per
//   32 x 8 pixel tile (batch on blockIdx.y), a warp per tile row, so the
//   index loads of a warp are one contiguous run. A thread whose index does
//   not change to the right or below (most pixels of a mesh) stops after
//   its three index loads. Otherwise it classifies the pair from the index
//   and the corners first, and reads the image and the cotangent only where
//   a class gives a nonzero part; then it sends each part to its pixel's
//   three vertices. No per-pixel rows, no shared memory, no barrier, and no
//   second pass over a halo: each stencil is evaluated once, by its centre.
//   The faces a stencil needs are fetched together (vertex ids, then
//   corners), so that their loads overlap. Lanes whose parts go to one face
//   are not summed in the warp before the atomics: that combine
//   (__match_any_sync) gained little where a warp's lanes meet on a few
//   faces and cost more elsewhere (PERF.md section 6).
//   Image mode keeps a pixel's three parts in one thread instead, so that
//   each output is written once: each thread keeps gvc in registers and puts
//   gvr and gvd in shared memory, 40 threads then evaluate the halo
//   stencils (the row above the tile, the column left of it), and after one
//   barrier each thread sums its pixel. Offsets within a batch are 32-bit
//   (the wrapper raises when an extent reaches 2^31).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kHalo = kTileW + kTileH;  // the row above the tile, then the column left of it

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
  const T* v;              // [N, V, 3] rows contiguous, batch stride v_sn
  const int32_t* vi;       // [N, F, 3] rows contiguous, batch stride vi_sn (0: one vi for all)
  const int32_t* index;    // [N, H, W] rows contiguous, batch stride idx_sn
  const T* img;            // [N, C, H, W], strides img_sn, img_sc, img_sh, img_sw
  const T* grad;           // [N, C, H, W], strides grad_sn, grad_sc, grad_sh, grad_sw
  const T* bary;           // [N, 3, H, W] (verts mode), strides bary_sn, bary_sc, bary_sh, bary_sw
  T* out;                  // [N, V, 3] (verts mode, added to) or [N, 3, H, W], contiguous
  int64_t v_sn, vi_sn, idx_sn, img_sn, grad_sn, bary_sn;
  int32_t img_sc, img_sh, img_sw, grad_sc, grad_sh, grad_sw, bary_sc, bary_sh, bary_sw;
  int32_t c_dim, h, w, n_verts, n_faces, y_offset;
  int32_t y_end;           // stencil centres lie in rows [0, y_end) of the block
  int32_t tiles_x;
  bool clamp;              // max_dp_dr > 0
  T max_dp_dr;
};

// The vertex ids of face min(f, F - 1) of batch n (f >= 0, F > 0), each
// clamped to [0, V - 1] as the plain version's gathers clamp them.
template <typename T>
__device__ __forceinline__ void vertex_ids(const Args<T>& a, int32_t n, int32_t f, int32_t (&id)[3]) {
  const int32_t* row = a.vi + n * a.vi_sn + min(f, a.n_faces - 1) * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) id[k] = min(max(__ldg(row + k), 0), a.n_verts - 1);
}

// The corners (x, y, z) of the vertices id, at 0, 3, 6.
template <typename T>
__device__ __forceinline__ void corners(const Args<T>& a, int32_t n, const int32_t (&id)[3], T (&p)[9]) {
  const T* v = a.v + n * a.v_sn;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) p[3 * k + c] = __ldg(v + id[k] * 3 + c);
  }
}

// _face_normals: normalize(cross(p0 - p2, p1 - p0)), the norm's squares
// summed in axis order.
template <typename T>
__device__ void face_normal(const T (&p)[9], T (&nrm)[3]) {
  const T ax = sub_rn(p[0], p[6]), ay = sub_rn(p[1], p[7]), az = sub_rn(p[2], p[8]);
  const T bx = sub_rn(p[3], p[0]), by = sub_rn(p[4], p[1]), bz = sub_rn(p[5], p[2]);
  const T cx = sub_rn(mul_rn(ay, bz), mul_rn(az, by));
  const T cy = sub_rn(mul_rn(az, bx), mul_rn(ax, bz));
  const T cz = sub_rn(mul_rn(ax, by), mul_rn(ay, bx));
  const T len = sqrt_rn(add_rn(add_rn(mul_rn(cx, cx), mul_rn(cy, cy)), mul_rn(cz, cz)));
  const T d = len == T(0) ? T(1) : len;
  nrm[0] = div_rn(cx, d);
  nrm[1] = div_rn(cy, d);
  nrm[2] = div_rn(cz, d);
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

// _pix_in_tri: is (px, py) covered by the triangle of corners p?
template <typename T>
__device__ bool pix_in_tri(const T (&p)[9], T px, T py) {
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

// sum_c (img[q'] - img[q]) * (0.5 * (g[q'] + g[q])), channels in order, for
// q = (y, x) and q' its right (axis 0) or lower (axis 1) neighbour.
template <typename T>
__device__ __forceinline__ T image_dot(const Args<T>& a, int32_t n, int32_t y, int32_t x, int32_t axis) {
  const T* img = a.img + n * a.img_sn + y * a.img_sh + x * a.img_sw;
  const T* g = a.grad + n * a.grad_sn + y * a.grad_sh + x * a.grad_sw;
  const int32_t si = axis == 0 ? a.img_sw : a.img_sh, sg = axis == 0 ? a.grad_sw : a.grad_sh;
  T acc = T(0);
  for (int32_t ch = 0; ch < a.c_dim; ++ch) {
    const T* ic = img + ch * a.img_sc;
    const T* gc = g + ch * a.grad_sc;
    const T di = sub_rn(__ldg(ic + si), __ldg(ic));
    const T gs = mul_rn(T(0.5), add_rn(__ldg(gc + sg), __ldg(gc)));
    acc = add_rn(acc, mul_rn(di, gs));
  }
  return acc;
}

// One leg of the stencil: the centre (y, x), of face corners pc, against
// its right (axis 0) or lower (axis 1) neighbour, of corners pn (both
// faces valid: `both`). Classifies the pair from the indices and the
// corners, reads the image only where a class gives a nonzero part, and
// sets the centre's part (moving coordinate cm, its z in cz) and the
// neighbour's (nm, nz). The normals' components are (axis, z).
template <typename T>
__device__ __forceinline__ void stencil_leg(const Args<T>& a, int32_t n, int32_t y, int32_t x, int32_t axis,
                                            bool cv, bool nv, bool both, const T (&pc)[9], const T (&pn)[9],
                                            T& cm, T& cz, T& nm, T& nz) {
  const T px = T(x), py = T(y + a.y_offset);
  const bool c_in_n = both && pix_in_tri(pn, px, py);
  const bool n_in_c = both && pix_in_tri(pc, add_rn(px, T(axis == 0)), add_rn(py, T(axis == 1)));
  const bool intersect = c_in_n && n_in_c;
  const bool adjacent = both && !c_in_n && !n_in_c;
  const bool take_c = cv && !n_in_c && !adjacent;  // not (neighbour over centre)
  const bool take_n = nv && !c_in_n && !adjacent;  // not (centre over neighbour)
  if (!intersect && !take_c && !take_n) return;    // adjacent faces, or background on both sides
  const T dot = image_dot(a, n, y, x, axis);
  if (intersect) {  // the moving coordinate and z of both sides through dp_dr
    T nc[3], nn[3], c0, c1, n0, n1;
    face_normal(pc, nc);
    face_normal(pn, nn);
    dp_dr(nc[axis], nc[2], nn[axis], nn[2], a.clamp, a.max_dp_dr, c0, c1);
    dp_dr(nn[axis], nn[2], nc[axis], nc[2], a.clamp, a.max_dp_dr, n0, n1);
    cm = mul_rn(dot, c0);
    cz = mul_rn(dot, c1);
    nm = mul_rn(dot, n0);
    nz = mul_rn(dot, n1);
  } else {
    cm = take_c ? dot : T(0);
    nm = take_n ? dot : T(0);
  }
}

// The contributions of the stencil centred at (y, x) of batch n; zeros
// outside the stencil centres.
template <typename T>
__device__ __forceinline__ Contrib<T> stencil(const Args<T>& a, int32_t n, int32_t y, int32_t x) {
  Contrib<T> o = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  if (y < 0 || x < 0 || y >= a.y_end || x >= a.w - 1) return o;
  const int32_t* idx = a.index + n * a.idx_sn + y * a.w + x;
  const int32_t ic = __ldg(idx), ir = __ldg(idx + 1), id = __ldg(idx + a.w);
  const bool lr = ic != ir, ud = ic != id;
  if (!lr && !ud) return o;
  const bool cv = ic >= 0, rv = ir >= 0, dv = id >= 0;
  const bool both_r = lr && cv && rv, both_d = ud && cv && dv;
  // The faces the classes need, fetched together (their vertex ids, then
  // their corners), so that their loads overlap; zeros without faces or
  // vertices (a degenerate triangle covers nothing).
  T pc[9] = {}, pr[9] = {}, pd[9] = {};
  if ((both_r || both_d) && a.n_faces > 0 && a.n_verts > 0) {
    int32_t idc[3], idr[3], idd[3];
    vertex_ids(a, n, ic, idc);
    if (both_r) vertex_ids(a, n, ir, idr);
    if (both_d) vertex_ids(a, n, id, idd);
    corners(a, n, idc, pc);
    if (both_r) corners(a, n, idr, pr);
    if (both_d) corners(a, n, idd, pd);
  }
  T zx = T(0), zy = T(0);
  if (lr) stencil_leg(a, n, y, x, 0, cv, rv, both_r, pc, pr, o.cx, zx, o.rx, o.rz);
  if (ud) stencil_leg(a, n, y, x, 1, cv, dv, both_d, pc, pd, o.cy, zy, o.dy, o.dz);
  o.cz = add_rn(zx, zy);
  return o;
}

// Verts mode: the part (gx, gy, gz) of pixel (y, x) through its face's
// three vertices, -bary_k * part_j at (vertex k, coordinate j); nothing at
// background pixels, and no atomic for a zero.
template <typename T>
__device__ __forceinline__ void add_part(const Args<T>& a, int32_t n, int32_t y, int32_t x, T gx, T gy, T gz) {
  const int32_t f = __ldg(a.index + n * a.idx_sn + y * a.w + x);
  if (f < 0) return;
  int32_t id[3];
  vertex_ids(a, n, f, id);
  const T g[3] = {sub_rn(T(0), gx), sub_rn(T(0), gy), sub_rn(T(0), gz)};
  const T* bary = a.bary + n * a.bary_sn + y * a.bary_sh + x * a.bary_sw;
  T* out = a.out + int64_t(n) * a.n_verts * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T b = __ldg(bary + k * a.bary_sc);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T val = mul_rn(b, g[j]);
      if (val != T(0)) atomicAdd(out + id[k] * 3 + j, val);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) edge_grad_verts_kernel(const Args<T> a) {
  const int32_t n = blockIdx.y;
  const int32_t y = (blockIdx.x / a.tiles_x) * kTileH + static_cast<int32_t>(threadIdx.x) / kTileW;
  const int32_t x = (blockIdx.x % a.tiles_x) * kTileW + static_cast<int32_t>(threadIdx.x) % kTileW;
  const Contrib<T> c = stencil(a, n, y, x);
  if (c.cx != T(0) || c.cy != T(0) || c.cz != T(0)) add_part(a, n, y, x, c.cx, c.cy, c.cz);
  if (c.rx != T(0) || c.rz != T(0)) add_part(a, n, y, x + 1, c.rx, T(0), c.rz);
  if (c.dy != T(0) || c.dz != T(0)) add_part(a, n, y + 1, x, T(0), c.dy, c.dz);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) edge_grad_image_kernel(const Args<T> a) {
  __shared__ T right_of[kTileH][kTileW + 1][2];  // gvr (x, z) of centre (y0 + i, x0 - 1 + j)
  __shared__ T down_of[kTileH + 1][kTileW][2];   // gvd (y, z) of centre (y0 - 1 + i, x0 + j)
  const int32_t n = blockIdx.y;
  const int32_t y0 = (blockIdx.x / a.tiles_x) * kTileH;
  const int32_t x0 = (blockIdx.x % a.tiles_x) * kTileW;
  const int32_t tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
  const int32_t y = y0 + ty, x = x0 + tx;

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

  if (y < a.h && x < a.w) {
    const int64_t hw = int64_t(a.h) * a.w;
    T* dst = a.out + n * 3 * hw + y * a.w + x;
    dst[0] = sub_rn(sub_rn(T(0), own.cx), right_of[ty][tx][0]);
    dst[hw] = sub_rn(sub_rn(T(0), own.cy), down_of[ty][tx][0]);
    dst[2 * hw] = sub_rn(sub_rn(sub_rn(T(0), own.cz), right_of[ty][tx][1]), down_of[ty][tx][1]);
  }
}

// The launch's scalars: extents, the batch strides of v, vi, index, img, grad
// and bary, the channel, row and column strides of img, grad and bary (all
// in elements), max_dp_dr, y_offset and y_end.
struct Shape {
  int32_t n_batch, c_dim, h, w, n_verts, n_faces;
  int64_t v_sn, vi_sn, idx_sn, img_sn, grad_sn, bary_sn;
  int32_t img_sc, img_sh, img_sw, grad_sc, grad_sh, grad_sw, bary_sc, bary_sh, bary_sw;
  double max_dp_dr;
  int32_t y_offset, y_end;
};

template <typename T>
int launch(const void* v, const void* vi, const void* index, const void* img, const void* grad, const void* bary,
           void* out, const Shape& d, void* stream) {
  if (d.n_batch == 0 || d.h == 0 || d.w == 0) return static_cast<int>(cudaGetLastError());
  // Verts mode adds nothing where no face or no vertex can receive it.
  if (bary != nullptr && (d.n_faces == 0 || d.n_verts == 0)) return static_cast<int>(cudaGetLastError());
  Args<T> a;
  a.v = static_cast<const T*>(v);
  a.vi = static_cast<const int32_t*>(vi);
  a.index = static_cast<const int32_t*>(index);
  a.img = static_cast<const T*>(img);
  a.grad = static_cast<const T*>(grad);
  a.bary = static_cast<const T*>(bary);
  a.out = static_cast<T*>(out);
  a.v_sn = d.v_sn;
  a.vi_sn = d.vi_sn;
  a.idx_sn = d.idx_sn;
  a.img_sn = d.img_sn;
  a.grad_sn = d.grad_sn;
  a.bary_sn = d.bary_sn;
  a.img_sc = d.img_sc;
  a.img_sh = d.img_sh;
  a.img_sw = d.img_sw;
  a.grad_sc = d.grad_sc;
  a.grad_sh = d.grad_sh;
  a.grad_sw = d.grad_sw;
  a.bary_sc = d.bary_sc;
  a.bary_sh = d.bary_sh;
  a.bary_sw = d.bary_sw;
  a.c_dim = d.c_dim;
  a.h = d.h;
  a.w = d.w;
  a.n_verts = d.n_verts;
  a.n_faces = d.n_faces;
  a.y_offset = d.y_offset;
  a.y_end = d.y_end;
  a.tiles_x = (d.w + kTileW - 1) / kTileW;
  a.clamp = d.max_dp_dr > 0;
  a.max_dp_dr = static_cast<T>(d.max_dp_dr);
  const dim3 grid(static_cast<unsigned int>(a.tiles_x * ((d.h + kTileH - 1) / kTileH)),
                  static_cast<unsigned int>(d.n_batch));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bary != nullptr) {
    edge_grad_verts_kernel<T><<<grid, kThreads, 0, s>>>(a);
  } else {
    edge_grad_image_kernel<T><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// v [N, V, 3] and vi [N, F, 3] int32 with contiguous rows (vi's batch
// stride may be 0); index [N, H, W] int32 with contiguous rows; img and grad
// [N, C, H, W] and bary [N, 3, H, W] (null: image mode) of any strides
// (`shape`: extents and strides in elements); out [N, V, 3] (verts mode:
// added to) or [N, 3, H, W] (image mode: written), contiguous. All on the
// device of `stream`; N <= 65535; offsets within a batch below 2^31.
// Stencil centres lie in rows [0, y_end); y_offset is the global row of
// row 0. Returns cudaGetLastError() after the launch.
int drtk_edge_grad_f32(const void* v, const void* vi, const void* index, const void* img, const void* grad,
                       const void* bary, void* out, const void* shape, void* stream) {
  return launch<float>(v, vi, index, img, grad, bary, out, *static_cast<const Shape*>(shape), stream);
}

int drtk_edge_grad_f64(const void* v, const void* vi, const void* index, const void* img, const void* grad,
                       const void* bary, void* out, const void* shape, void* stream) {
  return launch<double>(v, vi, index, img, grad, bary, out, *static_cast<const Shape*>(shape), stream);
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
