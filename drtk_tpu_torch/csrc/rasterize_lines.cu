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
// Work split: one thread per (triangle, window pixel). The wrapper's
//   inclusive running sum of window areas (`ends`, int64, its total read on
//   the device, so the launch needs no host synchronisation) numbers them;
//   one wave of blocks runs, each warp a contiguous run of those numbers,
//   32 at a time, lane j on j, j + 32, .... A lane binary-searches its
//   first triangle once; after that it walks (seek): 32 numbers on is the
//   same window 32 / width rows and 32 % width columns on, or a later
//   window, so a step costs no search and no division. Each lane keeps its
//   triangle's edge functions, corners and per-edge reject bounds in
//   registers (Tri) and reloads them only when its triangle changes. The
//   in-window offset, row and column are 32-bit (a window holds at most
//   H*W < 2^31 pixels; the wrapper raises beyond).
//
// The crossing test is where the work is: 4 sides x 3 edges with two IEEE
//   divisions each, and almost no pixel is crossed. Before it, per visible
//   edge and pixel:
//   - a line-distance reject per pair of parallel sides, against a
//     threshold per triangle with the rounding margin proved below;
//   - the surviving (pixel, edge) pairs go to a queue of the warp in shared
//     memory (ballot, popc), and each time it holds 32 they are tested one
//     per lane; a lane whose pair is crossed writes the pixel's key itself.
//     (Compacting within one step of 32 pixels fills a pass with ~5 pairs
//     on the inverse8 frame; the queue fills it with 32.)
//   - on the queue's lane, a bounding-box reject per side, exact by
//     construction, before the side tests. Where the line reject does not
//     apply (see its guard) the box reject runs on the owner lane instead.
//   A skipped side test is one that would have returned false, so the
//   result is the plain version's bit for bit.
//
// Bound on this card: what the function needs is to read the rows, meta
//   and ends once and write 8 bytes of depth and index per pixel (bytes),
//   and to evaluate three edge functions per window pixel (operations); at
//   the inverse8 frame's shapes (8 x 512^2, 12,800 triangles, ~40 M window
//   pixels) the bytes set it, ~0.008 ms. The key buffer (24 bytes per
//   pixel with its memset and unpack) is this design's own. The time goes
//   to instructions: per window pixel the walk, the inside test and the
//   line reject, per inside pixel its key, and per queued pair the box
//   reject and the side tests.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 19;   // ea[3], eb[3], ec[3], p0 p1 p2 (x, y), d_inv[3], inv_den
constexpr int kMeta = 5;   // bits (top-left 0-2, visible 3-5), x_lo, x_hi, y_lo, y_hi
constexpr unsigned long long kEmpty = ~0ull;
constexpr uint32_t kInterior = 0x7FFFFFFFu;  // id of a pixel no visible edge crosses
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// Whether segment (p1, p2) crosses the unit diamond at (px, py) on one of
// the sides in `sides` (bits 0-3, in the order below); the callers leave
// out only sides that this test would reject.
__device__ bool diamond_crossing(float p1x, float p1y, float p2x, float p2y,
                                 float px, float py, uint32_t sides) {
  const float a0 = __fsub_rn(p1y, p2y);
  const float b0 = __fsub_rn(p2x, p1x);
  const float c0 = __fsub_rn(__fmul_rn(p1x, p2y), __fmul_rn(p2x, p1y));
  const float xl = __fsub_rn(px, 0.5f), xr = __fadd_rn(px, 0.5f);
  const float yt = __fsub_rn(py, 0.5f), yb = __fadd_rn(py, 0.5f);
  return ((sides & 1) && seg_cross(a0, b0, c0, p1x, p1y, p2x, p2y, px, yt, xr, py)) ||
         ((sides & 2) && seg_cross(a0, b0, c0, p1x, p1y, p2x, p2y, xr, py, px, yb)) ||
         ((sides & 4) && seg_cross(a0, b0, c0, p1x, p1y, p2x, p2y, px, yb, xl, py)) ||
         ((sides & 8) && seg_cross(a0, b0, c0, p1x, p1y, p2x, p2y, xl, py, px, yt));
}

// What a lane keeps of its current triangle between steps: the edge
// functions for the inside test, the corners, and per edge the line
// reject's thresholds.
struct Tri {
  int32_t i = -1;
  // top-left 0-2, visible 3-5, a non-finite line coefficient 6-8, the line
  // reject applies 9-11 (per edge)
  int32_t bits = 0;
  int32_t x_lo = 0, y_lo = 0;
  int32_t w_cols = 1, rows32 = 0, cols32 = 0;  // window width; 32 pixels on as (rows, columns)
  float ea[3], eb[3], ec[3];
  float p[6];         // p0 p1 p2 (x, y)
  float line[3][3];   // per edge, a0 b0 c0
  float reach[3][2];  // per edge, the thresholds on |L| of sides (0, 2) and (1, 3)
};

// Offsets of the corners of edge k, (p0, p1), (p1, p2) or (p0, p2), in
// p0x p0y p1x p1y p2x p2y (row offset 9 + these).
__device__ __forceinline__ int edge_first(int k) { return k == 1 ? 2 : 0; }
__device__ __forceinline__ int edge_second(int k) { return k == 0 ? 2 : 4; }

// Edge (p1, p2)'s line a0*x + b0*y + c0 = 0, as diamond_crossing computes it.
__device__ __forceinline__ void line_of(float p1x, float p1y, float p2x, float p2y, float& a0,
                                        float& b0, float& c0) {
  a0 = __fsub_rn(p1y, p2y);
  b0 = __fsub_rn(p2x, p1x);
  c0 = __fsub_rn(__fmul_rn(p1x, p2y), __fmul_rn(p2x, p1y));
}

__device__ __forceinline__ bool normal_or_zero(float v) {
  const float a = fabsf(v);
  return a == 0.f || (a >= 0x1p-100f && a <= FLT_MAX);
}

// The line reject's thresholds: the pair of sides (0, 2) or (1, 3) is skipped at a
// pixel of the window where |L| = |(a0*px + b0*py) + c0|, rounded op by op
// in float, exceeds reach[0] or reach[1]. Returns whether the guard below
// holds; where it does not, no threshold is set and nothing is skipped.
//
// Claim. Let a0, b0, c0 be the float coefficients diamond_crossing computes
// for the edge, L = a0*px + b0*py + c0 (exact), M = max(|a0|, |b0|), X =
// px + 1/2, Y = py + 1/2, |D| = |a0 +- b0|/2 the exact |a0*b2 - a2*b0| of
// the pair of parallel sides (+ for sides 0 and 2, - for 1 and 3), and u =
// 2^-24. If a side of the pair reports a crossing, then
//   |L| <= M/2 + 2M*(E2 + w*(X + Y) + w*(2M*C2 + |c0|)/|D|),
//   w = 2.0001u, E2 = 2.0002u*XY + u*(X + Y)/2, C2 = (X + Y)/2 + E2.
//
// Proof, in the standard model (each float op rounds with |delta| <= u),
// under the guard below: a0, b0, c0 finite, each 0 or at least 2^-100 in
// magnitude, M <= 2^40, |c0| <= 2^80, and the window within [1, 2^22]^2.
// Then px +- 1/2, py +- 1/2, a2, b2 = +-1/2 and the products a0*b2, a2*b0,
// b2*c0, a2*c0 are exact, no product in the test underflows (|c2| is 0 or
// >= 1/4), a difference of floats never underflows inexactly, and a
// division that overflows or yields NaN reports no crossing. Take side 0,
// corners (px, yt) and (xr, py); the others follow by symmetry.
// - d = fl(D) is 0 iff D = 0, and then cx = FLT_MAX lies in no side box.
// - The exact c2 = (px - py)/2 + 1/4, so |c2| <= (X + Y)/2; its two products
//   are at most XY each, so |c2~ - c2| <= 2.0002u*XY + u*|c2| <= E2 and
//   |c2~| <= C2.
// - Let x* be the exact intersection of line A (a0, b0, c0) with line B
//   (a2, b2, c2~). The numerator fl(fl(b0*c2~) - b2*c0) differs from the
//   exact one by at most eX = w*(|b0|*C2 + |c0|/2) (eY the same with |a0|),
//   and cx = (N~/d)(1 + e4) with d = D(1 + e3), so dx = cx - x* obeys
//   |dx| <= w*|cx| + eX/|D|. A crossing puts c in the side's box, so |cx| <=
//   X, |cy| <= Y, and |dx| + |dy| <= w*(X + Y + (2M*C2 + |c0|)/|D|).
// - Residuals at c: R_A = a0*cx + b0*cy + c0 = a0*dx + b0*dy, and, with the
//   exact c2, R_B = a2*cx + b2*cy + c2 = (a2*dx + b2*dy) + (c2 - c2~).
// - In the box, cx = px + s and cy = py - t with s, t in [0, 1/2], and R_B
//   = (1/2 - (s + t))/2, so s + t = 1/2 - 2R_B. Then L = R_A - a0*s + b0*t
//   and |L| <= |R_A| + M*(s + t) <= M/2 + 2M*(|dx| + |dy|) + 2M*|c2~ - c2|,
//   which is the claim.
// The bound grows with X and Y, so it holds over the window at its largest
// X and Y; and |L~ - L| <= 3.0001u*(M*(X + Y) + |c0|) for the float L~. The
// thresholds evaluate bound plus that error with 2^-22 for w and 2.0002u,
// 2^-24 for u/2 and 2^-22 for 3.0001u, then add 2^-18 of the total, which
// covers the rounding of their own evaluation (under 30u; an overflow
// gives an infinite threshold, which skips nothing). D = 0 skips the pair
// at every pixel. Outside the guard, or for any non-finite input, nothing
// is skipped.
__device__ __forceinline__ bool line_reach(float a0, float b0, float c0, int32_t x_lo, int32_t x_hi,
                                           int32_t y_lo, int32_t y_hi, float* reach) {
  const float m = fmaxf(fabsf(a0), fabsf(b0)), c = fabsf(c0);
  if (!(normal_or_zero(a0) && normal_or_zero(b0) && normal_or_zero(c0) && m <= 0x1p40f &&
        c <= 0x1p80f && x_lo >= 1 && y_lo >= 1 && x_hi <= (1 << 22) && y_hi <= (1 << 22))) {
    return false;
  }
  const float x = __fadd_rn(static_cast<float>(x_hi), 0.5f), y = __fadd_rn(static_cast<float>(y_hi), 0.5f);
  const float s = __fadd_rn(x, y), xy = __fmul_rn(x, y);
  const float e2 = __fadd_rn(__fmul_rn(0x1p-22f, xy), __fmul_rn(0x1p-24f, s));
  const float c2 = __fadd_rn(__fmul_rn(0.5f, s), e2);
  const float two_m = __fmul_rn(2.f, m);
  const float r1 = __fadd_rn(__fadd_rn(__fmul_rn(0.5f, m), __fmul_rn(two_m, __fadd_rn(e2, __fmul_rn(0x1p-22f, s)))),
                             __fmul_rn(0x1p-22f, __fadd_rn(__fmul_rn(m, s), c)));
  const float r2 = __fmul_rn(__fmul_rn(two_m, 0x1p-22f), __fadd_rn(__fmul_rn(two_m, c2), c));
  const float d02 = __fmul_rn(0.5f, fabsf(__fadd_rn(a0, b0)));
  const float d13 = __fmul_rn(0.5f, fabsf(__fsub_rn(a0, b0)));
  constexpr float kRoom = 1.f + 0x1p-18f;
  reach[0] = d02 == 0.f ? -1.f : __fmul_rn(__fadd_rn(r1, __fmul_rn(__frcp_rn(d02), r2)), kRoom);
  reach[1] = d13 == 0.f ? -1.f : __fmul_rn(__fadd_rn(r1, __fmul_rn(__frcp_rn(d13), r2)), kRoom);
  return true;
}

// The box reject, exact by construction: the sides of the diamond at (px, py),
// bits 0-3 in diamond_crossing's order, whose boxes meet the segment's. A
// side accepts only a computed point c with in_seg(s0, s1, c) and
// in_seg(p1, p2, c), so c lies in the side's box ([px, xr] or [xl, px] by
// [yt, py] or [py, yb], with the rounded xl, xr, yt, yb of the test) and in
// the segment's; where the boxes are disjoint the side cannot report a
// crossing. For finite corners.
__device__ __forceinline__ uint32_t box_sides(float p1x, float p1y, float p2x, float p2y, float px,
                                              float py) {
  const float xl = __fsub_rn(px, 0.5f), xr = __fadd_rn(px, 0.5f);
  const float yt = __fsub_rn(py, 0.5f), yb = __fadd_rn(py, 0.5f);
  const float min_x = fminf(p1x, p2x), max_x = fmaxf(p1x, p2x);
  const float min_y = fminf(p1y, p2y), max_y = fmaxf(p1y, p2y);
  const bool right = !(max_x < px || min_x > xr);
  const bool left = !(max_x < xl || min_x > px);
  const bool top = !(max_y < yt || min_y > py);
  const bool bottom = !(max_y < py || min_y > yb);
  return static_cast<uint32_t>(right && top) | (static_cast<uint32_t>(right && bottom) << 1) |
         (static_cast<uint32_t>(left && bottom) << 2) | (static_cast<uint32_t>(left && top) << 3);
}

// The sides of the diamond at (px, py) left to test on edge k, bits 0-3:
// none where the edge is invisible, all four where a line coefficient is
// not finite (load_tri sets their lines and thresholds so), else those that
// pass the line reject. Where the line reject applies, the box reject is
// left to the queue's lane, since it costs more than the line's; where it
// does not (an infinite threshold), the box reject runs here.
__device__ __forceinline__ uint32_t edge_sides(const Tri& tri, int k, float px, float py) {
  const float l = fabsf(__fadd_rn(__fadd_rn(__fmul_rn(tri.line[k][0], px), __fmul_rn(tri.line[k][1], py)),
                                  tri.line[k][2]));
  uint32_t sides = (l > tri.reach[k][0] ? 0xAu : 0xFu) & (l > tri.reach[k][1] ? 0x5u : 0xFu);
  if (!((tri.bits >> (9 + k)) & 1) && !((tri.bits >> (6 + k)) & 1) && sides != 0u) {
    const int f = edge_first(k), s = edge_second(k);
    sides &= box_sides(tri.p[f], tri.p[f + 1], tri.p[s], tri.p[s + 1], px, py);
  }
  return sides;
}

// The first triangle in [lo, hi] whose running window-area sum exceeds t.
__device__ __forceinline__ int32_t find_triangle(const int64_t* __restrict__ ends,
                                                 int32_t lo, int32_t hi, int64_t t) {
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (ends[mid] > t) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Load triangle i's row and meta into `tri`, with its edges' thresholds.
__device__ __forceinline__ void load_tri(Tri& tri, int32_t i, const float* __restrict__ rows,
                                         const int32_t* __restrict__ meta) {
  const int32_t* m = meta + static_cast<int64_t>(i) * kMeta;
  const float* r = rows + static_cast<int64_t>(i) * kRow;
  tri.i = i;
  tri.bits = m[0];
  tri.x_lo = m[1];
  tri.w_cols = m[2] - m[1] + 1;
  tri.rows32 = 32 / tri.w_cols;
  tri.cols32 = 32 - tri.rows32 * tri.w_cols;
  tri.y_lo = m[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    tri.ea[k] = r[k];
    tri.eb[k] = r[3 + k];
    tri.ec[k] = r[6 + k];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) tri.p[k] = r[9 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int f = edge_first(k), s = edge_second(k);
    float a0, b0, c0;
    line_of(tri.p[f], tri.p[f + 1], tri.p[s], tri.p[s + 1], a0, b0, c0);
    tri.line[k][0] = a0;
    tri.line[k][1] = b0;
    tri.line[k][2] = c0;
    tri.reach[k][0] = tri.reach[k][1] = INFINITY;
    if (!((tri.bits >> (3 + k)) & 1) || !(isfinite(a0) && isfinite(b0) && isfinite(c0))) {
      tri.line[k][0] = tri.line[k][1] = tri.line[k][2] = 0.f;
      if ((tri.bits >> (3 + k)) & 1) {
        tri.bits |= 1 << (6 + k);
      } else {
        tri.reach[k][0] = tri.reach[k][1] = -1.f;
      }
    } else if (line_reach(a0, b0, c0, m[1], m[2], m[3], m[4], tri.reach[k])) {
      tri.bits |= 1 << (9 + k);
    }
  }
}

// The packed key of pixel (px, py) of triangle i (row r): its inverse depth
// from the clipped, renormalised barycentrics, and the triangle's id where
// an edge crosses the pixel, INT32_MAX where none does.
__device__ __forceinline__ void write_key(unsigned long long* __restrict__ keys, const float* r,
                                          float e0, float e1, float e2, int32_t i, bool crossing,
                                          int32_t x, int32_t y, int32_t n_faces, int32_t height,
                                          int32_t width, int32_t y_offset) {
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
  const int32_t batch = i / n_faces;
  const uint32_t id = crossing ? static_cast<uint32_t>(i - batch * n_faces) : kInterior;
  const unsigned long long key = (static_cast<unsigned long long>(~dbits) << 32) | id;
  atomicMin(keys + (static_cast<int64_t>(batch) * height + (y - y_offset)) * width + x, key);
}

// Where a lane stands in its walk: thread number t, the running sum that
// ends its triangle's window, and the pixel's row and column in it.
struct Walk {
  int64_t t = 0, tri_end = 0;
  int32_t row = 0, col = 0;
};

// Move a lane to thread number t, whose triangle is `i` or one after it:
// up to 8 triangles one by one (the next window, past empty ones), then a
// binary search; load the triangle and find the pixel with one division.
__device__ __forceinline__ void seek(Tri& tri, Walk& w, int64_t t, int32_t i, int32_t n_tri,
                                     const float* __restrict__ rows, const int32_t* __restrict__ meta,
                                     const int64_t* __restrict__ ends) {
  for (int n = 0; ends[i] <= t; ++i) {
    if (++n == 8) {
      i = find_triangle(ends, i, n_tri - 1, t);
      break;
    }
  }
  w.t = t;
  w.tri_end = ends[i];
  const int32_t off = static_cast<int32_t>(t - (i == 0 ? 0 : ends[i - 1]));
  load_tri(tri, i, rows, meta);
  w.row = off / tri.w_cols;
  w.col = off - w.row * tri.w_cols;
}

constexpr int kThreads = 256;
constexpr int kQueue = 128;  // (pixel, edge) pairs a warp holds before it tests them
// A queued pair is (x, y, triangle, edge | sides << 2 | kWholeTest); the
// flag marks an edge with a non-finite line coefficient, tested whole.
constexpr int32_t kWholeTest = 1 << 6;

__global__ void __launch_bounds__(kThreads) lines_kernel(
    const float* __restrict__ rows, const int32_t* __restrict__ meta,
    const int64_t* __restrict__ ends, unsigned long long* __restrict__ keys,
    int32_t n_batch, int32_t n_faces, int32_t height, int32_t width,
    int32_t y_offset) {
  __shared__ int4 queues[kThreads / 32][kQueue];
  const int32_t n_tri = n_batch * n_faces;
  const int64_t total = ends[n_tri - 1];
  const int lane = threadIdx.x & 31;
  int4* queue = queues[threadIdx.x >> 5];
  uint32_t head = 0, tail = 0;  // the warp's queue: entries [head, tail), mod kQueue
  // Test the next n <= 32 queued pairs, one per lane; a crossed pair
  // writes the pixel's key with the triangle's id.
  const auto drain = [&](uint32_t n) {
    __syncwarp();
    const int4 pair = queue[(head + lane) % kQueue];
    __syncwarp();
    head += n;
    if (static_cast<uint32_t>(lane) >= n) return;
    const int32_t i = pair.z, k = pair.w & 3;
    const float* r = rows + static_cast<int64_t>(i) * kRow;
    const float px = static_cast<float>(pair.x), py = static_cast<float>(pair.y);
    const int f = 9 + edge_first(k), s = 9 + edge_second(k);
    uint32_t sides = (static_cast<uint32_t>(pair.w) >> 2) & 0xFu;
    if (!(pair.w & kWholeTest)) sides &= box_sides(r[f], r[f + 1], r[s], r[s + 1], px, py);
    if (sides != 0u && diamond_crossing(r[f], r[f + 1], r[s], r[s + 1], px, py, sides)) {
      write_key(keys, r, edge(r[0], r[3], r[6], px, py), edge(r[1], r[4], r[7], px, py),
                edge(r[2], r[5], r[8], px, py), i, true, pair.x, pair.y, n_faces, height, width, y_offset);
    }
  };

  // Each warp takes a contiguous run of thread numbers, a multiple of 32
  // long, and steps through it 32 at a time, lane j on numbers j, j + 32,
  // ...; every lane takes part in the ballots, and a lane past the end only
  // holds a predicate. A lane finds its first triangle by binary search and
  // then walks: 32 pixels on is the same window 32 / width rows and 32 %
  // width columns on, or a later window (seek).
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  const int64_t per_warp = ((total + warps - 1) / warps + 31) & ~int64_t{31};
  const int64_t begin = (blockIdx.x * static_cast<int64_t>(blockDim.x >> 5) + (threadIdx.x >> 5)) * per_warp;
  const int64_t end = begin + per_warp < total ? begin + per_warp : total;
  Tri tri;
  Walk w;
  if (begin + lane < end) {
    seek(tri, w, begin + lane, find_triangle(ends, 0, n_tri - 1, begin + lane), n_tri, rows, meta, ends);
  }
  for (int64_t base = begin; base < end; base += 32) {
    const bool active = base + lane < end;
    const int32_t i = tri.i;
    const int32_t x = tri.x_lo + w.col, y = tri.y_lo + w.row;
    const float px = static_cast<float>(x), py = static_cast<float>(y);
    const float e0 = edge(tri.ea[0], tri.eb[0], tri.ec[0], px, py);
    const float e1 = edge(tri.ea[1], tri.eb[1], tri.ec[1], px, py);
    const float e2 = edge(tri.ea[2], tri.eb[2], tri.ec[2], px, py);
    const bool inside = active && keep(e0, tri.bits & 1) && keep(e1, tri.bits & 2) && keep(e2, tri.bits & 4);
    uint32_t sides[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) sides[k] = active ? edge_sides(tri, k, px, py) : 0u;

    // Interior keys now; the surviving (pixel, edge) pairs go to the
    // queue, and whenever it holds 32 a pass tests them on dense lanes. A
    // crossed pixel's key has the same depth as its interior key and a
    // smaller id, so the atomicMin ends where the plain version does in
    // whichever order the two come.
    const uint32_t below = (1u << lane) - 1u;
    const auto push = [&](bool own, int32_t what) {
      const uint32_t owners = __ballot_sync(kFull, own);
      if (own) queue[(tail + __popc(owners & below)) % kQueue] = make_int4(x, y, i, what);
      tail += __popc(owners);
    };
    if (inside) {
      write_key(keys, rows + static_cast<int64_t>(i) * kRow, e0, e1, e2, i, false, x, y, n_faces, height,
                width, y_offset);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      push(sides[k] != 0u,
           k | static_cast<int32_t>(sides[k] << 2) | (((tri.bits >> (6 + k)) & 1) ? kWholeTest : 0));
    }
    while (tail - head >= 32u) drain(32u);

    // 32 pixels on: the same window, or a later one.
    if (base + 32 + lane < end) {
      w.t += 32;
      if (w.t < w.tri_end) {
        w.row += tri.rows32;
        w.col += tri.cols32;
        if (w.col >= tri.w_cols) {
          w.col -= tri.w_cols;
          ++w.row;
        }
      } else {
        seek(tri, w, w.t, i + 1, n_tri, rows, meta, ends);
      }
    }
  }
  if (tail != head) drain(tail - head);
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
// index [N, H, W] int32; all contiguous, on the device of `stream`; N*F and
// H*W below 2^31. Returns the first CUDA error of the memset and both
// launches.
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
    int per_sm = 0;  // one wave of blocks: each warp walks one run of pixels
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lines_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    lines_kernel<<<sms * (per_sm > 0 ? per_sm : 1), kThreads, 0, s>>>(
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
