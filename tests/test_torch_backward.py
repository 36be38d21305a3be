"""drtk_tpu_torch's backward passes against drtk_tpu's on the same numpy
inputs (CPU).

Every input, upstream cotangents included, is made with numpy from a seed
and reaches both packages as numpy arrays; both sides use the same index
image. The JAX side runs as its own tests run it on the CPU: its Pallas
kernels in interpret mode. Tolerances, and why:

* pixel-to-face accumulation (kernel B3's function) and the 2-D tap
  accumulation (kernel B4's): rtol 1e-5, and an atol of 1e-6 times the sum
  of the magnitudes that went into each output. The JAX kernels sum with
  bf16x3 one-hot matrix products (within 4 ulp of an f32 sum) or, for
  scenes of large triangles, a plain f32 scatter; the port sums in another
  order, and two orders of an f32 sum differ by up to a few ulp of the sum
  of magnitudes (hundreds of rows per face in the soups).
* VJPs of render, interpolate, edge_grad_estimator and grid_sample (f32):
  1e-4 of the largest gradient magnitude, the repo's gradient contract
  (ROADMAP.md). XLA contracts products into FMAs on the CPU and the port
  does not, so single roundings differ. The edge_grad scenes are random
  soups, in general position, so that no pixel sits on a coverage boundary
  where that rounding could flip edge_grad's discrete classification.
* The float64 oracles agree to 1e-10.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import drtk_tpu as dt  # noqa: E402
from drtk_tpu.ops.edge_grad import edge_grad_image as jax_edge_grad_image  # noqa: E402
from drtk_tpu.ops.grid_sample import grid_sample as jax_grid_sample  # noqa: E402
from drtk_tpu.ops.segment_rows import scatter_rows_to_faces as jax_scatter_rows  # noqa: E402
from drtk_tpu.ops.window_accum import window_accumulate as jax_window_accumulate  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from drtk_tpu_torch.ops.grid_sample import grid_sample  # noqa: E402
from drtk_tpu_torch.ops.row_gather import _row_scatter, row_gather  # noqa: E402
from drtk_tpu_torch.ops.segment_rows import scatter_rows_to_faces  # noqa: E402
from drtk_tpu_torch.ops.window_accum import window_accumulate  # noqa: E402
from drtk_tpu_torch.scenes import make_scene_arrays  # noqa: E402
from tests.test_torch_ops import _soup  # noqa: E402
from tests.torch_oracle import edge_grad_oracle  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_vjp(fn, primals, cotangent):
    """The JAX package's VJP of ``fn`` at numpy ``primals``, jitted (its
    eager dispatch of interpret-mode kernels is several times slower)."""
    cot = jax.tree_util.tree_map(jnp.asarray, cotangent)

    def pull(*args):
        return jax.vjp(fn, *args)[1](cot)

    return [np.asarray(g) for g in jax.jit(pull)(*(jnp.asarray(p) for p in primals))]


def _assert_grad_close(got, want, rel=1e-4):
    """|got - want| <= rel * max|want| everywhere."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max error {err} > {rel} x {scale}"


def _soup_fallback():
    """1500 large overlapping triangles on two thirds of the canvas: each
    of JAX's 32x128 tiles sees more scattered face ids than its bins cover,
    so its scatter takes the plain fallback rather than the Pallas kernel."""
    s = _soup(1, 200, 1500, 64, 128, 3)
    s["v"][..., :2] *= np.float32(0.7)
    return s


# name -> (numpy scene, height, width)
SCENES = {
    "grid": (lambda: make_scene_arrays(64, 128, 9), 64, 128),
    "soup_batch2": (lambda: _soup(2, 24, 20, 64, 128, 1), 64, 128),  # few large triangles, batch 2
    "soup_fallback": (_soup_fallback, 64, 128),
    "nonaligned": (lambda: _soup(1, 48, 64, 70, 130, 2), 70, 130),
}


def _indexed(scene):
    """A scene with the JAX package's index image of it."""
    make, h, w = SCENES[scene]
    s = make()
    idx = np.array(jax.jit(dt.rasterize, static_argnums=(2, 3))(jnp.asarray(s["v"]), jnp.asarray(s["vi"]), h, w))
    assert (idx >= 0).any() and (idx < 0).any()
    return s, idx


# ---------------------------------------------------------------------------
# (a) the two accumulations (kernels B3 and B4) against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k_dim", [6, 9, 16])
@pytest.mark.parametrize("scene", ["grid", "soup_fallback", "nonaligned"])
def test_scatter_rows_matches_jax(scene, k_dim):
    s, idx = _indexed(scene)
    n, f_cnt = idx.shape[0], s["vi"].shape[0]
    rows = np.random.RandomState(k_dim).randn(*idx.shape, k_dim).astype(np.float32)
    rows[idx < 0] = 0  # the JAX function's precondition: background rows zeroed
    vi_b = jnp.broadcast_to(jnp.asarray(s["vi"])[None], (n, f_cnt, 3))
    want = np.asarray(jax_scatter_rows(jnp.asarray(rows), jnp.asarray(idx), None, vi_b, interpret=True))
    magnitude = np.zeros((n, f_cnt, k_dim))
    for b, y, x in zip(*np.nonzero(idx >= 0)):
        magnitude[b, idx[b, y, x]] += np.abs(rows[b, y, x])
    rows[idx < 0] = 1e3  # the port drops background rows whatever they hold
    got = scatter_rows_to_faces(_t(rows), _t(idx), f_cnt)
    assert got.dtype == torch.float32 and got.shape == (n, f_cnt, k_dim)
    assert (np.abs(to_numpy(got) - want) <= 1e-5 * np.abs(want) + 1e-6 * magnitude).all()


def test_scatter_rows_keeps_f64_and_clamps_like_the_gather():
    rng = np.random.RandomState(0)
    rows = rng.randn(2, 5, 6, 3)
    idx = rng.randint(-1, 12, (2, 5, 6)).astype(np.int32)
    got = to_numpy(scatter_rows_to_faces(_t(rows), _t(idx), 10))
    want = np.zeros((2, 10, 3))
    for b, y, x in zip(*np.nonzero(idx >= 0)):
        want[b, min(idx[b, y, x], 9)] += rows[b, y, x]
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _coherent_taps(seed, n, k_dim, out_h, out_w, p=4096, block=1024):
    """Taps in blocks of nearby texels, as the JAX window design needs."""
    rng = np.random.RandomState(seed)
    iy = np.zeros((n, p), np.int32)
    ix = np.zeros((n, p), np.int32)
    for b in range(p // block):
        y0, x0 = rng.randint(0, out_h - 40), rng.randint(0, out_w - 100)
        iy[:, b * block:(b + 1) * block] = y0 + rng.randint(0, 40, (n, block))
        ix[:, b * block:(b + 1) * block] = x0 + rng.randint(0, 100, (n, block))
    iy[:, ::13] = -1  # inert taps; their rows are not zeroed
    return rng.randn(n, k_dim, p).astype(np.float32), iy, ix


@pytest.mark.parametrize("k_dim, out_h, out_w", [(12, 48, 256), (5, 64, 384)])
def test_window_accumulate_matches_jax(k_dim, out_h, out_w):
    rows, iy, ix = _coherent_taps(k_dim, 2, k_dim, out_h, out_w)
    want = np.asarray(jax_window_accumulate(
        jnp.asarray(rows), jnp.asarray(iy), jnp.asarray(ix), out_h, out_w, block=1024, win_h=48,
        interpret=True))
    magnitude = np.zeros((2, k_dim, out_h, out_w))
    for b, p in zip(*np.nonzero(iy >= 0)):
        magnitude[b, :, iy[b, p], ix[b, p]] += np.abs(rows[b, :, p])
    got = window_accumulate(_t(rows), _t(iy), _t(ix), out_h, out_w)
    assert got.shape == (2, k_dim, out_h, out_w)
    assert (np.abs(to_numpy(got) - want) <= 1e-5 * np.abs(want) + 1e-6 * magnitude).all()
    # any strides, and a table of any size: the transposed view of a
    # [N, P, K] array on a 37 x 50 table (taps outside it are dropped)
    rows_pk = np.ascontiguousarray(rows.transpose(0, 2, 1))
    got = window_accumulate(_t(rows_pk).transpose(1, 2), _t(iy), _t(ix), 37, 50)
    keep = (iy < 37) & (ix < 50)
    want = np.zeros((2, k_dim, 37, 50), np.float64)
    for b, p in zip(*np.nonzero((iy >= 0) & keep)):
        want[b, :, iy[b, p], ix[b, p]] += rows[b, :, p]
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (b) the VJPs, f32, same inputs, same index image
# ---------------------------------------------------------------------------


def _degenerate_scene():
    """A soup plus one zero-area face (three coincident vertices) painted
    over a block of pixels and one vertex at z = 0, so that render's ``den``
    and ``z`` clamps fire."""
    s = _soup(1, 40, 50, 48, 96, 6)
    v = np.concatenate([s["v"], np.float32([[[30.0, 20.0, 4.0]] * 3])], axis=1)
    v[0, 0, 2] = 0.0
    vi = np.concatenate([s["vi"], np.int32([[40, 41, 42]])])
    idx = np.array(dt.rasterize(jnp.asarray(v), jnp.asarray(vi), 48, 96))
    idx[0, 10:20, 20:40] = 50
    return {"v": v, "vi": vi}, idx


@pytest.mark.parametrize("scene", ["grid", "soup_batch2", "nonaligned", "degenerate"])
def test_render_vjp_matches_jax(scene):
    s, idx = _degenerate_scene() if scene == "degenerate" else _indexed(scene)
    rng = np.random.RandomState(1)
    g_depth = rng.randn(*idx.shape).astype(np.float32)
    g_bary = rng.randn(idx.shape[0], 3, *idx.shape[1:]).astype(np.float32)
    (want,) = _jax_vjp(lambda v: dt.render(v, jnp.asarray(s["vi"]), jnp.asarray(idx)), (s["v"],),
                       (g_depth, g_bary))
    v = _t(s["v"]).requires_grad_()
    depth, bary = tt.render(v, _t(s["vi"]), _t(idx))
    (got,) = torch.autograd.grad((depth, bary), v, (_t(g_depth), _t(g_bary)))
    want = np.asarray(want)
    if scene == "degenerate":
        # The zero-area face's own vertices take gradients ~1e8 larger than
        # the rest (its barycentrics divide by the clamped den): hold the two
        # groups each to their own scale.
        _assert_grad_close(to_numpy(got)[:, 40:], want[:, 40:])
        got, want = got[:, :40], want[:, :40]
    _assert_grad_close(to_numpy(got), want)


@pytest.mark.parametrize("channels", [2, 3])
@pytest.mark.parametrize("scene", ["grid", "nonaligned"])
def test_interpolate_vjp_matches_jax(scene, channels):
    s, idx = _indexed(scene)
    rng = np.random.RandomState(channels)
    attrs = rng.randn(idx.shape[0], s["v"].shape[1], channels).astype(np.float32)
    bary = rng.rand(idx.shape[0], 3, *idx.shape[1:]).astype(np.float32)
    g = rng.randn(idx.shape[0], channels, *idx.shape[1:]).astype(np.float32)
    want_attr, want_bary = _jax_vjp(
        lambda a, b: dt.interpolate(a, jnp.asarray(s["vi"]), jnp.asarray(idx), b), (attrs, bary), g)
    a, b = _t(attrs).requires_grad_(), _t(bary).requires_grad_()
    vp = _t(s["v"]).requires_grad_()
    out = tt.interpolate(a, _t(s["vi"]), _t(idx), b, v_pix=vp)  # v_pix changes nothing
    got_attr, got_bary, got_vp = torch.autograd.grad(out, (a, b, vp), _t(g), allow_unused=True)
    _assert_grad_close(to_numpy(got_attr), want_attr)
    _assert_grad_close(to_numpy(got_bary), want_bary)
    assert got_vp is None  # a zero gradient, as JAX's zeros_like(geom)


def _edge_case(scene, seed=4):
    """A scene in general position, its JAX index image and bary, an image
    and an upstream cotangent."""
    s, idx = _indexed(scene)
    _, bary = jax.jit(dt.render)(jnp.asarray(s["v"]), jnp.asarray(s["vi"]), jnp.asarray(idx))
    rng = np.random.RandomState(seed)
    img = rng.rand(idx.shape[0], 3, *idx.shape[1:]).astype(np.float32)
    g = rng.randn(*img.shape).astype(np.float32)
    return s, idx, np.array(bary), img, g


@pytest.mark.parametrize("max_dp_dr", [1e4, 0.0])
@pytest.mark.parametrize("scene", ["soup_batch2", "nonaligned"])
def test_edge_grad_vjp_matches_jax(scene, max_dp_dr):
    s, idx, bary, img, g = _edge_case(scene)
    vi, jidx = jnp.asarray(s["vi"]), jnp.asarray(idx)

    def jax_side(v, im, gg):  # one compile for the VJP and the image-space gradient
        _, pull = jax.vjp(
            lambda v, im: dt.edge_grad_estimator(v, vi, jnp.asarray(bary), im, jidx, max_dp_dr=max_dp_dr), v, im)
        return pull(gg), jax_edge_grad_image(v, vi, im, jidx, gg, max_dp_dr)

    (want_v, want_img), want_gi = jax.jit(jax_side)(jnp.asarray(s["v"]), jnp.asarray(img), jnp.asarray(g))
    v, im = _t(s["v"]).requires_grad_(), _t(img).requires_grad_()
    out = tt.edge_grad_estimator(v, _t(s["vi"]), _t(bary), im, _t(idx), max_dp_dr=max_dp_dr)
    assert torch.equal(out, im)
    got_v, got_img = torch.autograd.grad(out, (v, im), _t(g))
    assert np.abs(np.asarray(want_v)).max() > 0
    _assert_grad_close(to_numpy(got_v), want_v)
    np.testing.assert_array_equal(to_numpy(got_img), np.asarray(want_img))

    got_gi = tt.edge_grad_image(_t(s["v"]), _t(s["vi"]), _t(img), _t(idx), _t(g), max_dp_dr)
    assert got_gi.shape == (idx.shape[0], 3) + idx.shape[1:]
    _assert_grad_close(to_numpy(got_gi), np.asarray(want_gi))


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_grid_sample_vjp_matches_jax(padding_mode):
    rng = np.random.RandomState(5)
    tex = rng.rand(2, 3, 13, 17).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 9, 11, 2)).astype(np.float32)
    g = rng.randn(2, 3, 9, 11).astype(np.float32)
    want_tex, want_grid = _jax_vjp(
        lambda t, gr: jax_grid_sample(t, gr, mode="bilinear", padding_mode=padding_mode), (tex, grid), g)
    t, gr = _t(tex).requires_grad_(), _t(grid).requires_grad_()
    out = grid_sample(t, gr, mode="bilinear", padding_mode=padding_mode)
    got_tex, got_grid = torch.autograd.grad(out, (t, gr), _t(g))
    _assert_grad_close(to_numpy(got_tex), want_tex)
    _assert_grad_close(to_numpy(got_grid), want_grid)


# ---------------------------------------------------------------------------
# (c) the float64 oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_dp_dr", [1e4, 0.0])
def test_edge_grad_ref_matches_jax_ref_f64(max_dp_dr):
    s, idx, bary, img, g = _edge_case("nonaligned")
    v64, bary64, img64, g64 = (x.astype(np.float64) for x in (s["v"], bary, img, g))
    vi = jnp.asarray(s["vi"])
    (want,) = _jax_vjp(
        lambda v: dt.edge_grad_estimator_ref(v, vi, jnp.asarray(bary64), jnp.asarray(img64), jnp.asarray(idx),
                                             max_dp_dr=max_dp_dr), (v64,), g64)
    v = _t(v64).requires_grad_()
    out = tt.edge_grad_estimator_ref(v, _t(s["vi"]), _t(bary64), _t(img64), _t(idx), max_dp_dr=max_dp_dr)
    (got,) = torch.autograd.grad(out, v, _t(g64))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("scene", ["soup_batch2", "nonaligned"])
def test_edge_grad_matches_torch_oracle(scene):
    """The f32 op against the test suite's f64 torch oracle
    (tests/torch_oracle.py, classifying in f32 as the op does), and the
    port's own f64 oracle against the op."""
    s, idx, bary, img, g = _edge_case(scene, seed=9)
    n = idx.shape[0]
    vi_b = _t(np.broadcast_to(s["vi"][None], (n,) + s["vi"].shape))
    v = _t(s["v"]).requires_grad_()
    out = tt.edge_grad_estimator(v, _t(s["vi"]), _t(bary), _t(img), _t(idx))
    (got,) = torch.autograd.grad(out, v, _t(g))
    v64 = _t(s["v"]).double().requires_grad_()
    out = edge_grad_oracle(v64, vi_b, _t(bary).double(), _t(img).double(), _t(idx), classify_dtype=torch.float32)
    (want,) = torch.autograd.grad(out, v64, _t(g).double())
    _assert_grad_close(to_numpy(got), to_numpy(want))
    v64 = _t(s["v"]).double().requires_grad_()
    out = tt.edge_grad_estimator_ref(v64, _t(s["vi"]), _t(bary).double(), _t(img).double(), _t(idx))
    (ref,) = torch.autograd.grad(out, v64, _t(g).double())
    _assert_grad_close(to_numpy(got), to_numpy(ref))


# ---------------------------------------------------------------------------
# (d) row_gather: the gather and the scatter are each other's transpose
# ---------------------------------------------------------------------------


def test_row_gather_gradcheck_and_gradgradcheck():
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(2, 12, 3, dtype=torch.float64, generator=gen).requires_grad_()
    idx = torch.randint(0, 12, (2, 7), generator=gen)
    rows = torch.randn(2, 7, 3, dtype=torch.float64, generator=gen).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: row_gather(t, idx, (3, 4)), (table,))
    assert torch.autograd.gradgradcheck(lambda t: row_gather(t, idx, (3, 4)), (table,))
    assert torch.autograd.gradcheck(lambda r: _row_scatter(r, idx, (3, 4)), (rows,))
    assert torch.autograd.gradgradcheck(lambda r: _row_scatter(r, idx, (3, 4)), (rows,))


def test_row_scatter_drops_zero_rows_exactly():
    rng = np.random.RandomState(1)
    rows = rng.randn(1, 50, 4).astype(np.float32)
    rows[0, ::3] = 0.0
    idx = rng.randint(0, 20, (1, 50))
    got = to_numpy(_row_scatter(_t(rows), _t(idx), (4, 5)))
    want = np.zeros((1, 20, 4), np.float32)
    np.add.at(want[0], idx[0], rows[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
