// Mipmapped, anisotropic bilinear texture sampling, forward and backward
// (kernel M1 of drtk_tpu_torch).
//
// Replaces: drtk_tpu/ops/mipmap_grid_sample.py:441-585 _mipmap_grid_sample_impl
//   (bilinear) and the window-accumulate backward of its quad gather,
//   :218-283 _quad_rows_gather_bwd (kernel B4's Pallas _window_kernel, one
//   pass per mip level). There, as in the port's composite path
//   (drtk_tpu_torch/ops/mipmap_grid_sample.py, which bicubic, impl="plain"
//   and CPU tensors keep), the pyramid is packed into an atlas, the atlas
//   into a quad table of four shifted copies, and every pixel's 2 x max_aniso
//   taps become [N, 2T, H, W] tensors of coordinates, weights and 4C-float
//   quad rows, gathered, weighted and summed op by op; the backward scatters
//   the rows' gradient into the quad table with B4.
//
// Computes, per output pixel (n, y, x), what the composite computes (its
//   module docstring): the mip selection from the 2 x 2 uv Jacobian (px, py
//   with the 1e-12, N taps, lambda with NaN/Inf to 0, the clamp at
//   levels - 1 - 1e-6, the clip_grad rescaling); then for level d1 with
//   weight (1 - a) / N and level min(d1 + 1, q - 1) with weight a / N (d1
//   alone when q == 1), and each tap i < N at uv + step * ((i + 1) / (N + 1)
//   * 2 - 1), the padding fold and a bilinear sample of the level's [C, H, W]
//   planes. Forward: out[n, c, y, x]. Backward: the grid's gradient, written
//   once per pixel (floor has none; a clamp's bound halves it, as
//   torch.maximum and torch.minimum split a tie; reflection's fold flips its
//   sign with the fold's parity; the Jacobian gets none), and each level's
//   gradient, g * w_tap * w_corner added at the corner's texel. Taps past N
//   and a level of weight 0 add exactly 0 for finite levels and are skipped,
//   as row_gather drops all-zero rows; so are corners of weight 0, corners
//   outside the level under zeros padding (masked), and pixels whose
//   cotangent is 0 in every channel (for the levels). A corner one past a
//   level's last column reads the atlas' neighbour there, the next level's
//   first column (0 below its height or past the last level), as the
//   composite does: it has weight 0, so only the grid gradient at an exact
//   right edge sees it. A pixel whose Jacobian is not finite (N is NaN
//   there) reads NaN and has a NaN grid gradient, as in the composite, and
//   adds nothing to the levels (the composite spreads NaN there).
//
// Exactness: every product, sum and quotient is rounded on its own
//   (__fmul_rn and friends; nvcc would otherwise contract a * b + c into an
//   FMA), in the composite's order, so tap coordinates, floors and clamp ties
//   are the composite's bit for bit; log2 and exp2 may differ from torch's in
//   the last bit. The sums over taps and channels and the backward's atomics
//   add in other orders: values agree to float rounding, and the atomics'
//   order changes from run to run.
//
// Bound on this card: bytes. Forward: the grid (8 B) and the Jacobian (16 B)
//   read and C floats written per pixel, 36 B at C = 3, and the pyramid read
//   once (4.2 MB at 3 x 512^2 .. 64^2, held in L2). Backward: the cotangent
//   (12 B), the grid and the Jacobian read and the grid's gradient (8 B)
//   written, 44 B a pixel, and the levels' gradients written once. A 1024 x
//   4096 band of the avatar4k step: 151 MB forward, 185 MB backward, 0.046
//   and 0.057 ms at 3.35 TB/s. The design moves those bytes and no others
//   through device memory: every intermediate (levels, taps, weights,
//   texel values, per-tap gradients) lives in registers or shared memory,
//   and the texel reads hit L1 and L2. What keeps it from the bound is
//   latency and issue: dependent texel loads per tap, and in the backward
//   the warp's texel groups and the shared-memory adds (PERF.md section 6).
//
// Design: one thread per output pixel, a block of 32 x 8 threads per 32 x 8
//   pixel tile (batch on blockIdx.y), a warp per tile row. A thread reads its
//   uv and its Jacobian once, selects levels and taps in registers and reads
//   its texels straight from the levels' planes, through L1 and L2, which
//   neighbouring pixels share: no atlas, quad table or tap tensor exists. The
//   forward writes C floats. The backward recomputes the same from the inputs
//   (the forward saves nothing but them), writes the grid's gradient, and
//   gathers the levels' gradient in shared memory before any global atomic:
//   1. the block's windows are the bounding boxes of its live corners at the
//      finest level d1 of its pixels and at the next level, each kept if it
//      fits (kWindowBytes, the first first);
//   2. the warp walks its taps in lockstep, a tap slot at a time; for each
//      corner, the lanes whose corners fall on one texel (__match_any_sync)
//      stage their values in shared memory, and the group's lowest lane adds
//      their sum into its window, or, outside any window, into device memory
//      with a global atomic (the fallback);
//   3. after a barrier, each nonzero window sum goes to device memory with
//      one global atomicAdd per (block, texel, channel).
//   At avatar4k's ~8:1 magnification a 32 x 8 tile touches a handful of
//   texels, so the global atomics fall ~100-fold from one per (pixel, tap,
//   corner, channel). A shared-memory float atomicAdd is a compare-and-swap
//   loop on this card (PERF.md section 6); the warp's group sums keep them few.
//   Given a counter buffer, the backward counts the corner adds that went to
//   a window and to the fallback.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kMaxLevels = 11;
constexpr int kChunk = 4;            // forward: channels summed in registers at a time
constexpr int kWindowBytes = 24576;  // backward: the block's windows of level gradients
constexpr unsigned kFull = 0xffffffffu;

enum Padding : int32_t { kZeros = 0, kBorder = 1, kReflection = 2 };

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
__device__ __forceinline__ float floor_of(float a) { return floorf(a); }
__device__ __forceinline__ double floor_of(double a) { return floor(a); }
__device__ __forceinline__ float ceil_of(float a) { return ceilf(a); }
__device__ __forceinline__ double ceil_of(double a) { return ceil(a); }
__device__ __forceinline__ float log2_of(float a) { return log2f(a); }
__device__ __forceinline__ double log2_of(double a) { return log2(a); }
__device__ __forceinline__ float exp2_of(float a) { return exp2f(a); }
__device__ __forceinline__ double exp2_of(double a) { return exp2(a); }
__device__ __forceinline__ float fmod_of(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_of(double a, double b) { return fmod(a, b); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }
__device__ __forceinline__ float nan_of(float) { return nanf(""); }
__device__ __forceinline__ double nan_of(double) { return nan(""); }

// NaN and infinity: false.
template <typename T>
__device__ __forceinline__ bool finite(T a) { return sub_rn(a, a) == T(0); }

// torch.maximum and torch.minimum: NaN if either is NaN.
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// The launch's scalars (the wrapper's _Shape): the levels, each [N, C, H, W]
// with contiguous planes and any batch stride (0: one level for every batch,
// all in elements); the grid's and the cotangent's strides in elements.
struct Shape {
  const void* levels[kMaxLevels];
  int64_t level_sn[kMaxLevels];
  int32_t level_w[kMaxLevels], level_h[kMaxLevels];
  int64_t grid_s[4];  // grid [N, H, W, 2]: n, h, w, component
  int64_t grad_s[4];  // cotangent [N, C, H, W]: n, c, h, w
  int32_t n_batch, n_levels, c_dim, h, w, max_aniso, padding, clip_grad, force_max_aniso;
};

template <typename T>
struct Args {
  const T* level[kMaxLevels];
  int64_t level_sn[kMaxLevels];
  int32_t level_w[kMaxLevels], level_h[kMaxLevels];
  int32_t key_off[kMaxLevels];  // level l's first texel among all levels' H x W texels
  const T* grid;                // [N, H, W, 2], strides grid_s
  const T* jac;                 // [N, H, W, 2, 2] contiguous
  const T* grad;                // backward: the cotangent [N, C, H, W], strides grad_s
  T* out;                       // forward: [N, C, H, W]; backward: the grid's gradient [N, H, W, 2]
  T* grad_levels;               // backward: level l's gradient [N, C, H_l, W_l] at N * C * key_off[l], or null
  unsigned long long* counts;   // backward: corner adds to [a window, the fallback], or null
  int64_t grid_s[4], grad_s[4];
  int32_t n_batch, n_levels, c_dim, h, w, max_aniso, padding, tiles_x;
  bool clip_grad, force_max_aniso;
};

// A pixel's mip levels, their weights, its tap count and uv step.
template <typename T>
struct Selection {
  int32_t level[2];  // d1, min(d1 + 1, q - 1)
  T weight[2];       // (1 - a) / N, a / N
  int32_t n_used;    // levels sampled: 1, 2, or 0 where N is NaN
  int32_t n_taps;
  T n_f, du, dv;
};

// d: the pixel's Jacobian (d/dx, d/dy of u, v), in the composite's order.
template <typename T>
__device__ __forceinline__ Selection<T> select(const Args<T>& a, const T* d) {
  T dudx = d[0], dvdx = d[1], dudy = d[2], dvdy = d[3];
  const T bw = T(a.level_w[0]), bh = T(a.level_h[0]);
  const T xu = mul_rn(dudx, bw), xv = mul_rn(dvdx, bh), yu = mul_rn(dudy, bw), yv = mul_rn(dvdy, bh);
  const T px = sqrt_rn(add_rn(add_rn(mul_rn(xu, xu), mul_rn(xv, xv)), T(1e-12)));
  const T py = sqrt_rn(add_rn(add_rn(mul_rn(yu, yu), mul_rn(yv, yv)), T(1e-12)));
  const T p_max = maximum(px, py), p_min = minimum(px, py);
  T n_taps = ceil_of(div_rn(p_max, p_min));
  n_taps = n_taps > T(a.max_aniso) ? T(a.max_aniso) : n_taps;  // torch.clamp(max=): NaN stays
  if (p_min == T(0) || n_taps == T(0)) n_taps = T(1);
  T lam = log2_of(div_rn(p_max, n_taps));
  if (!finite(lam)) lam = T(0);
  const int32_t q = a.n_levels;
  const T top = T(double(q) - 1.0 - 1e-6);
  T l = lam > top ? top : lam;
  if (a.clip_grad && lam > T(q - 1)) {  // truncated pyramid: keep the taps texel-spaced
    const T scaling = div_rn(mul_rn(exp2_of(l), n_taps), p_max);
    dudx = mul_rn(dudx, scaling);
    dvdx = mul_rn(dvdx, scaling);
    dudy = mul_rn(dudy, scaling);
    dvdy = mul_rn(dvdy, scaling);
  }
  l = l < T(0) ? T(0) : l;
  const T fl = floor_of(l);
  const T frac_l = sub_rn(l, fl);
  Selection<T> s;
  s.n_taps = n_taps != n_taps ? 0 : static_cast<int32_t>(n_taps);
  if (a.force_max_aniso) s.n_taps = a.max_aniso;
  s.n_f = T(s.n_taps);
  const bool x_dom = px > py;
  s.du = x_dom ? dudx : dudy;
  s.dv = x_dom ? dvdx : dvdy;
  const T inv_n = div_rn(T(1), s.n_f);
  s.level[0] = static_cast<int32_t>(fl);
  s.level[1] = min(s.level[0] + 1, q - 1);
  s.weight[0] = mul_rn(sub_rn(T(1), frac_l), inv_n);
  s.weight[1] = mul_rn(frac_l, inv_n);
  s.n_used = s.n_taps == 0 ? 0 : (q > 1 && s.weight[1] != T(0) ? 2 : 1);
  return s;
}

// _clip: minimum(high, maximum(low, x)); returns its gradient, halved at
// each tie.
template <typename T>
__device__ __forceinline__ T clip(T& x, T low, T high) {
  T grad = x > low ? T(1) : (x == low ? T(0.5) : T(0));
  const T m = maximum(low, x);
  grad = m < high ? grad : (m == high ? mul_rn(grad, T(0.5)) : T(0));
  x = minimum(high, m);
  return grad;
}

// One axis of a tap: the folded coordinate's floor and fraction, and its
// derivative by the normalized coordinate.
template <typename T>
struct Axis {
  int32_t i0;
  T t, slope;
};

template <typename T>
__device__ __forceinline__ Axis<T> axis(T coord, int32_t size, int32_t padding) {
  const T s = T(size);
  T x = div_rn(sub_rn(mul_rn(add_rn(coord, T(1)), s), T(1)), T(2));
  T slope = div_rn(s, T(2));
  if (padding == kReflection) {  // _reflect_dyn(x, -0.5, size - 0.5)
    const T low = T(-0.5);
    T span = sub_rn(sub_rn(s, T(0.5)), low);
    if (span == T(0)) span = T(1);
    const T diff = sub_rn(x, low);
    const T cc = abs_of(diff);
    const T extra = fmod_of(cc, span);  // torch.remainder of non-negative values
    const bool even = fmod_of(floor_of(div_rn(cc, span)), T(2)) == T(0);
    x = even ? add_rn(extra, low) : add_rn(sub_rn(span, extra), low);
    const T sign = diff > T(0) ? T(1) : (diff < T(0) ? T(-1) : T(0));  // abs' gradient, 0 at 0
    slope = mul_rn(slope, even ? sign : -sign);
  }
  if (padding != kZeros) slope = mul_rn(slope, clip(x, T(0), sub_rn(s, T(1))));
  const T fl = floor_of(x);
  Axis<T> r;
  // zeros padding: a floor far outside stays outside, in int32
  r.i0 = static_cast<int32_t>(fl < T(-(1 << 30)) ? T(-(1 << 30)) : (fl > T(1 << 30) ? T(1 << 30) : fl));
  r.t = sub_rn(x, fl);
  r.slope = slope;
  return r;
}

// One tap at one level: corner c is (x0 + (c & 1), y0 + (c >> 1)).
template <typename T>
struct Tap {
  int32_t level, x0, y0;
  T tx, ty, sx, sy;
  T w[4];        // corner weights, 0 where masked
  bool live[4];  // the corner takes a level gradient: inside the level, weight not 0
};

template <typename T>
__device__ __forceinline__ Tap<T> make_tap(const Args<T>& a, const Selection<T>& s, int32_t k, int32_t i, T u, T v) {
  const T frac = sub_rn(mul_rn(div_rn(T(i + 1), add_rn(s.n_f, T(1))), T(2)), T(1));
  Tap<T> t;
  t.level = s.level[k];
  const int32_t lw = a.level_w[t.level], lh = a.level_h[t.level];
  const Axis<T> ax = axis(add_rn(u, mul_rn(s.du, frac)), lw, a.padding);
  const Axis<T> ay = axis(add_rn(v, mul_rn(s.dv, frac)), lh, a.padding);
  t.x0 = ax.i0;
  t.y0 = ay.i0;
  t.tx = ax.t;
  t.ty = ay.t;
  t.sx = ax.slope;
  t.sy = ay.slope;
  const T ux = sub_rn(T(1), ax.t), uy = sub_rn(T(1), ay.t);
  t.w[0] = mul_rn(ux, uy);
  t.w[1] = mul_rn(ax.t, uy);
  t.w[2] = mul_rn(ux, ay.t);
  t.w[3] = mul_rn(ax.t, ay.t);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int32_t xc = t.x0 + (c & 1), yc = t.y0 + (c >> 1);
    const bool inside = xc >= 0 && xc < lw && yc >= 0 && yc < lh;
    if (a.padding == kZeros && !inside) t.w[c] = T(0);
    t.live[c] = inside && t.w[c] != T(0);
  }
  return t;
}

// Texel (x, y) of channel c of level l as the composite's quad table reads
// it: 0 outside the level under zeros padding (masked) and below it; one
// past the last column, the atlas' neighbour (the next level's first
// column).
template <typename T>
__device__ __forceinline__ T texel(const Args<T>& a, int32_t n, int32_t l, int32_t c, int32_t x, int32_t y) {
  if (x < 0 || y < 0) return T(0);
  if (x >= a.level_w[l]) {
    if (a.padding == kZeros || x > a.level_w[l] || l + 1 >= a.n_levels) return T(0);
    l += 1;
    x = 0;
  }
  if (y >= a.level_h[l]) return T(0);
  return __ldg(a.level[l] + n * a.level_sn[l] + (static_cast<int64_t>(c) * a.level_h[l] + y) * a.level_w[l] + x);
}

// The tap's bilinear sample of channel c, in the composite's order.
template <typename T>
__device__ __forceinline__ T sample(const Args<T>& a, const Tap<T>& t, int32_t n, int32_t c) {
  T out = mul_rn(texel(a, n, t.level, c, t.x0, t.y0), t.w[0]);
  out = add_rn(out, mul_rn(texel(a, n, t.level, c, t.x0 + 1, t.y0), t.w[1]));
  out = add_rn(out, mul_rn(texel(a, n, t.level, c, t.x0, t.y0 + 1), t.w[2]));
  return add_rn(out, mul_rn(texel(a, n, t.level, c, t.x0 + 1, t.y0 + 1), t.w[3]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mipmap_forward_kernel(const Args<T> a) {
  const int32_t x = static_cast<int32_t>(blockIdx.x % a.tiles_x) * kTileW + static_cast<int32_t>(threadIdx.x) % kTileW;
  const int32_t y = static_cast<int32_t>(blockIdx.x / a.tiles_x) * kTileH + static_cast<int32_t>(threadIdx.x) / kTileW;
  const int32_t n = blockIdx.y;
  if (x >= a.w || y >= a.h) return;
  const T* g = a.grid + n * a.grid_s[0] + y * a.grid_s[1] + x * a.grid_s[2];
  const T u = __ldg(g), v = __ldg(g + a.grid_s[3]);
  const int64_t pix = (static_cast<int64_t>(n) * a.h + y) * a.w + x;
  T d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = __ldg(a.jac + pix * 4 + k);
  const Selection<T> s = select(a, d);
  const int64_t plane = static_cast<int64_t>(a.h) * a.w;
  T* out = a.out + static_cast<int64_t>(n) * a.c_dim * plane + static_cast<int64_t>(y) * a.w + x;
  for (int32_t c0 = 0; c0 < a.c_dim; c0 += kChunk) {
    T acc[kChunk] = {};
    for (int32_t k = 0; k < s.n_used; ++k) {
      for (int32_t i = 0; i < s.n_taps; ++i) {
        const Tap<T> t = make_tap(a, s, k, i, u, v);
#pragma unroll
        for (int cc = 0; cc < kChunk; ++cc) {
          if (c0 + cc < a.c_dim) acc[cc] = add_rn(acc[cc], mul_rn(sample(a, t, n, c0 + cc), s.weight[k]));
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < kChunk; ++cc) {
      if (c0 + cc < a.c_dim) out[(c0 + cc) * plane] = s.n_used == 0 ? nan_of(T(0)) : acc[cc];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mipmap_backward_kernel(const Args<T> a) {
  constexpr int32_t kWindow = kWindowBytes / static_cast<int32_t>(sizeof(T));
  __shared__ T window[kWindow];  // window k, channel c, texel p at (start[k] * C + c * area[k] + p)
  __shared__ int32_t box[2][4];  // per window: least x, least y, greatest x, greatest y
  __shared__ int32_t finest;     // the least d1 of the block's live pixels
  __shared__ T stage[kThreads][kChunk];  // each lane's corner values, a chunk of channels at a time

  const int32_t lane = static_cast<int32_t>(threadIdx.x) % 32;
  const int32_t warp_base = static_cast<int32_t>(threadIdx.x) - lane;
  const int32_t x = static_cast<int32_t>(blockIdx.x % a.tiles_x) * kTileW + static_cast<int32_t>(threadIdx.x) % kTileW;
  const int32_t y = static_cast<int32_t>(blockIdx.x / a.tiles_x) * kTileH + static_cast<int32_t>(threadIdx.x) / kTileW;
  const int32_t n = blockIdx.y;
  const bool inside = x < a.w && y < a.h;

  T u = T(0), v = T(0);
  Selection<T> s{};
  bool active = false;  // a cotangent not 0 in every channel, finite N: the pixel has gradients to send
  const T* g = a.grad + n * a.grad_s[0] + y * a.grad_s[2] + x * a.grad_s[3];
  if (inside) {
    const T* gp = a.grid + n * a.grid_s[0] + y * a.grid_s[1] + x * a.grid_s[2];
    u = __ldg(gp);
    v = __ldg(gp + a.grid_s[3]);
    const int64_t pix = (static_cast<int64_t>(n) * a.h + y) * a.w + x;
    T d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = __ldg(a.jac + pix * 4 + k);
    s = select(a, d);
    for (int32_t c = 0; c < a.c_dim && s.n_used > 0; ++c) active = active || __ldg(g + c * a.grad_s[1]) != T(0);
  }
  const bool sends = active && a.grad_levels != nullptr;

  // 1. The windows: the bounding boxes of the live corners at the finest
  // level and the next.
  if (threadIdx.x == 0) {
    finest = INT_MAX;
    for (int k = 0; k < 2; ++k) {
      box[k][0] = box[k][1] = INT_MAX;
      box[k][2] = box[k][3] = INT_MIN;
    }
  }
  __syncthreads();
  if (sends) atomicMin(&finest, s.level[0]);
  __syncthreads();
  const int32_t first = finest;
  if (sends) {
    int32_t lo[2][2] = {{INT_MAX, INT_MAX}, {INT_MAX, INT_MAX}}, hi[2][2] = {{INT_MIN, INT_MIN}, {INT_MIN, INT_MIN}};
    for (int32_t k = 0; k < s.n_used; ++k) {
      const int32_t wk = s.level[k] - first;
      if (wk > 1) continue;
      for (int32_t i = 0; i < s.n_taps; ++i) {
        const Tap<T> t = make_tap(a, s, k, i, u, v);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!t.live[c]) continue;
          const int32_t xc = t.x0 + (c & 1), yc = t.y0 + (c >> 1);
          lo[wk][0] = min(lo[wk][0], xc);
          lo[wk][1] = min(lo[wk][1], yc);
          hi[wk][0] = max(hi[wk][0], xc);
          hi[wk][1] = max(hi[wk][1], yc);
        }
      }
    }
    for (int k = 0; k < 2; ++k) {
      if (lo[k][0] > hi[k][0]) continue;
      atomicMin(&box[k][0], lo[k][0]);
      atomicMin(&box[k][1], lo[k][1]);
      atomicMax(&box[k][2], hi[k][0]);
      atomicMax(&box[k][3], hi[k][1]);
    }
  }
  __syncthreads();
  int32_t bw[2], area[2], start[2];
  bool on[2];
  int32_t used = 0;  // texels
  for (int k = 0; k < 2; ++k) {
    bw[k] = box[k][2] >= box[k][0] ? box[k][2] - box[k][0] + 1 : 0;
    const int64_t ar = static_cast<int64_t>(bw[k]) * (box[k][3] - box[k][1] + 1);
    on[k] = bw[k] > 0 && (used + ar) * a.c_dim <= kWindow;
    area[k] = on[k] ? static_cast<int32_t>(ar) : 0;
    start[k] = used;
    used += area[k];
  }
  for (int32_t e = threadIdx.x; e < used * a.c_dim; e += kThreads) window[e] = T(0);
  __syncthreads();

  // 2. The taps, a slot at a time across the warp: the grid's gradient in
  // registers, the corners' level gradients summed over the lanes that share
  // a texel.
  const uint32_t items = active ? static_cast<uint32_t>(s.n_used * s.n_taps) : 0u;
  const uint32_t slots = __reduce_max_sync(kFull, items);
  T gu = T(0), gv = T(0);
  unsigned long long to_window = 0, to_fallback = 0;
  for (uint32_t slot = 0; slot < slots; ++slot) {
    const bool has = slot < items;
    Tap<T> t{};
    T wt = T(0);
    if (has) {
      const int32_t k = static_cast<int32_t>(slot) / s.n_taps;
      t = make_tap(a, s, k, static_cast<int32_t>(slot) % s.n_taps, u, v);
      wt = s.weight[k];
      T gx = T(0), gy = T(0);
      for (int32_t c = 0; c < a.c_dim; ++c) {
        const T gw = mul_rn(__ldg(g + c * a.grad_s[1]), wt);
        const T r0 = texel(a, n, t.level, c, t.x0, t.y0), r1 = texel(a, n, t.level, c, t.x0 + 1, t.y0);
        const T r2 = texel(a, n, t.level, c, t.x0, t.y0 + 1), r3 = texel(a, n, t.level, c, t.x0 + 1, t.y0 + 1);
        // (a corner masked under zeros padding reads 0: no gradient through its weight)
        const T dtx = add_rn(mul_rn(sub_rn(r1, r0), sub_rn(T(1), t.ty)), mul_rn(sub_rn(r3, r2), t.ty));
        const T dty = add_rn(mul_rn(sub_rn(r2, r0), sub_rn(T(1), t.tx)), mul_rn(sub_rn(r3, r1), t.tx));
        gx = add_rn(gx, mul_rn(gw, dtx));
        gy = add_rn(gy, mul_rn(gw, dty));
      }
      gu = add_rn(gu, mul_rn(gx, t.sx));
      gv = add_rn(gv, mul_rn(gy, t.sy));
    }
    if (a.grad_levels == nullptr) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool mine = has && t.live[c];
      const int32_t xc = t.x0 + (c & 1), yc = t.y0 + (c >> 1);
      const int32_t key = mine ? a.key_off[t.level] + yc * a.level_w[t.level] + xc : -1;
      const uint32_t group = __match_any_sync(kFull, key);  // the lanes whose corner is on my texel
      const bool leader = mine && __ffs(group) - 1 == lane;
      const int32_t wk = mine ? t.level - first : 2;
      const bool in_window = wk < 2 && on[wk];
      if (mine) ++(in_window ? to_window : to_fallback);
      T* dst = nullptr;
      int64_t dst_c = 0;  // the channel stride of dst
      if (leader && in_window) {
        dst = window + start[wk] * a.c_dim + (yc - box[wk][1]) * bw[wk] + (xc - box[wk][0]);
        dst_c = area[wk];
      } else if (leader) {
        const int64_t texels = static_cast<int64_t>(a.level_h[t.level]) * a.level_w[t.level];
        dst = a.grad_levels + static_cast<int64_t>(a.n_batch) * a.c_dim * a.key_off[t.level] +
              static_cast<int64_t>(n) * a.c_dim * texels + static_cast<int64_t>(yc) * a.level_w[t.level] + xc;
        dst_c = texels;
      }
      for (int32_t c0 = 0; c0 < a.c_dim; c0 += kChunk) {
#pragma unroll
        for (int cc = 0; cc < kChunk; ++cc) {
          if (mine && c0 + cc < a.c_dim) {
            stage[threadIdx.x][cc] = mul_rn(mul_rn(__ldg(g + (c0 + cc) * a.grad_s[1]), wt), t.w[c]);
          }
        }
        __syncwarp();
        if (leader) {  // the group's sum, in lane order, to its texel
#pragma unroll
          for (int cc = 0; cc < kChunk; ++cc) {
            if (c0 + cc >= a.c_dim) break;
            T sum = T(0);
            for (uint32_t m = group; m; m &= m - 1) sum = add_rn(sum, stage[warp_base + __ffs(m) - 1][cc]);
            atomicAdd(dst + (c0 + cc) * dst_c, sum);
          }
        }
        __syncwarp();  // the warp is done with the stage
      }
    }
  }
  if (inside) {
    T* out = a.out + ((static_cast<int64_t>(n) * a.h + y) * a.w + x) * 2;
    out[0] = s.n_used == 0 ? nan_of(T(0)) : gu;
    out[1] = s.n_used == 0 ? nan_of(T(0)) : gv;
  }

  // 3. The windows' sums to device memory, one atomic per texel and channel.
  __syncthreads();
  for (int32_t e = threadIdx.x; e < used * a.c_dim; e += kThreads) {
    const T val = window[e];
    if (val == T(0)) continue;
    const int k = e < (start[0] + area[0]) * a.c_dim ? 0 : 1;
    const int32_t local = e - start[k] * a.c_dim;
    const int32_t ch = local / area[k], p = local % area[k];
    const int32_t l = first + k;
    const int32_t xc = box[k][0] + p % bw[k], yc = box[k][1] + p / bw[k];
    const int64_t texels = static_cast<int64_t>(a.level_h[l]) * a.level_w[l];
    atomicAdd(a.grad_levels + static_cast<int64_t>(a.n_batch) * a.c_dim * a.key_off[l] +
                  (static_cast<int64_t>(n) * a.c_dim + ch) * texels + static_cast<int64_t>(yc) * a.level_w[l] + xc,
              val);
  }
  if (a.counts != nullptr) {
#pragma unroll
    for (int32_t d = 16; d > 0; d /= 2) {
      to_window += __shfl_down_sync(kFull, to_window, d);
      to_fallback += __shfl_down_sync(kFull, to_fallback, d);
    }
    if (lane == 0) {
      atomicAdd(a.counts, to_window);
      atomicAdd(a.counts + 1, to_fallback);
    }
  }
}

template <typename T>
int launch(const void* grid, const void* jac, const void* grad, void* out, void* grad_levels, void* counts,
           const Shape& d, void* stream) {
  if (d.n_batch == 0 || d.h == 0 || d.w == 0 || d.c_dim == 0) return static_cast<int>(cudaGetLastError());
  Args<T> a;
  int32_t texels = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < d.n_levels;
    a.level[l] = used ? static_cast<const T*>(d.levels[l]) : nullptr;
    a.level_sn[l] = used ? d.level_sn[l] : 0;
    a.level_w[l] = used ? d.level_w[l] : 0;
    a.level_h[l] = used ? d.level_h[l] : 0;
    a.key_off[l] = texels;
    texels += a.level_w[l] * a.level_h[l];
  }
  a.grid = static_cast<const T*>(grid);
  a.jac = static_cast<const T*>(jac);
  a.grad = static_cast<const T*>(grad);
  a.out = static_cast<T*>(out);
  a.grad_levels = static_cast<T*>(grad_levels);
  a.counts = static_cast<unsigned long long*>(counts);
  for (int k = 0; k < 4; ++k) {
    a.grid_s[k] = d.grid_s[k];
    a.grad_s[k] = d.grad_s[k];
  }
  a.n_batch = d.n_batch;
  a.n_levels = d.n_levels;
  a.c_dim = d.c_dim;
  a.h = d.h;
  a.w = d.w;
  a.max_aniso = d.max_aniso;
  a.padding = d.padding;
  a.tiles_x = (d.w + kTileW - 1) / kTileW;
  a.clip_grad = d.clip_grad != 0;
  a.force_max_aniso = d.force_max_aniso != 0;
  const dim3 blocks(static_cast<unsigned int>(a.tiles_x * ((d.h + kTileH - 1) / kTileH)),
                    static_cast<unsigned int>(d.n_batch));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad == nullptr) {
    mipmap_forward_kernel<T><<<blocks, kThreads, 0, s>>>(a);
  } else {
    mipmap_backward_kernel<T><<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// grid [N, H, W, 2] of any strides and jac [N, H, W, 2, 2] contiguous; the
// levels and the grid's strides in `shape`; out [N, C, H, W] contiguous. All
// on the device of `stream`; N <= 65535; offsets within a batch below 2^31.
// Returns cudaGetLastError() after the launch.
int drtk_mipmap_sample_fwd_f32(const void* grid, const void* jac, void* out, const void* shape, void* stream) {
  return launch<float>(grid, jac, nullptr, out, nullptr, nullptr, *static_cast<const Shape*>(shape), stream);
}

int drtk_mipmap_sample_fwd_f64(const void* grid, const void* jac, void* out, const void* shape, void* stream) {
  return launch<double>(grid, jac, nullptr, out, nullptr, nullptr, *static_cast<const Shape*>(shape), stream);
}

// As the forward, with the cotangent grad [N, C, H, W] (strides in `shape`);
// grad_grid [N, H, W, 2] contiguous, written; grad_levels (null: not asked
// for) the levels' gradients, level l [N, C, H_l, W_l] after the levels
// before it, zeroed by the caller and added to; counts (or null) two
// zeroed uint64, added to.
int drtk_mipmap_sample_bwd_f32(const void* grid, const void* jac, const void* grad, void* grad_grid,
                               void* grad_levels, void* counts, const void* shape, void* stream) {
  return launch<float>(grid, jac, grad, grad_grid, grad_levels, counts, *static_cast<const Shape*>(shape), stream);
}

int drtk_mipmap_sample_bwd_f64(const void* grid, const void* jac, const void* grad, void* grad_grid,
                               void* grad_levels, void* counts, const void* shape, void* stream) {
  return launch<double>(grid, jac, grad, grad_grid, grad_levels, counts, *static_cast<const Shape*>(shape), stream);
}

const char* drtk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
