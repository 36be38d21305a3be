"""Row-tile viewports of render, interpolate and the edge_grad backward in
drtk_tpu_torch (CPU), against the port's own full frame and against
drtk_tpu under the same viewports.

A tile holds rows ``[y0, y0 + hb)`` of an ``H``-row frame. Tolerances, and
why:

* a tile against the port's full frame, forward: bit for bit
  (``torch.equal``). The tile runs the same per-pixel operations on the
  same values, its pixel grid and sweep being the global rows. The edge_grad
  backward's tiles, each with its one-row halo, summed into the frame in
  band order, equal the full frame's image gradient bit for bit too.
* a tile against drtk_tpu's tile, on the same index image: render and
  interpolate, forward and VJP, in float64, to rtol 1e-10 / atol 1e-10 (the
  background sweep exactly). In float32 XLA contracts products into FMAs on
  the CPU and the port does not, and the large overlapping triangles of the
  soup magnify one rounding through 1/den past 1e-5 relative at a pixel;
  float64 leaves only the viewport logic to compare. The edge_grad tiles
  (f32) to 1e-4 of the largest magnitude, the repo's gradient contract, as
  in tests/test_torch_backward.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import drtk_tpu as dt  # noqa: E402
from drtk_tpu.ops.edge_grad import _edge_grad_backward as jax_edge_grad_backward  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from drtk_tpu_torch.ops import interpolate as interp_mod  # noqa: E402
from drtk_tpu_torch.ops.edge_grad import _edge_grad_backward  # noqa: E402
from drtk_tpu_torch.ops.rasterize import broadcast_vi  # noqa: E402
from drtk_tpu_torch.scenes import make_scene_arrays  # noqa: E402
from tests.test_torch_backward import _assert_grad_close, _jax_vjp, _t  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401
from tests.test_torch_ops import _soup  # noqa: E402

H, W = 64, 96
TILES = ((0, 16), (16, 16), (40, 24), (48, 16))  # (y0, rows): first, inner, odd-sized, last
SCENES = {
    "grid": lambda: make_scene_arrays(H, W, 9),
    "soup": lambda: _soup(2, 24, 30, H, W, 1),  # batch 2, large overlapping triangles
}


def _case(scene):
    """The scene, the JAX package's index image of it, and seeded vertex
    attributes (3 channels) and an image and cotangent for edge_grad."""
    s = SCENES[scene]()
    idx = np.array(jax.jit(dt.rasterize, static_argnums=(2, 3))(jnp.asarray(s["v"]), jnp.asarray(s["vi"]), H, W))
    assert (idx >= 0).any() and (idx < 0).any()
    rng = np.random.RandomState(7)
    n, num_v = s["v"].shape[:2]
    attrs = rng.rand(n, num_v, 3).astype(np.float32)
    img = rng.rand(n, 3, H, W).astype(np.float32)
    g = rng.randn(n, 3, H, W).astype(np.float32)
    return s, idx, attrs, img, g


@pytest.mark.parametrize("scene", list(SCENES))
def test_render_and_interpolate_tiles_equal_full_frame_rows(scene):
    s, idx, attrs, _, _ = _case(scene)
    v, vi, ti = _t(s["v"]), _t(s["vi"]), _t(idx)
    depth, bary = tt.render(v, vi, ti)
    for channels in (2, 3):  # the sweep's x/y channel pair, and an odd count
        a = _t(attrs[..., :channels])
        full = tt.interpolate(a, vi, ti, bary)
        for y0, hb in TILES:
            rows = slice(y0, y0 + hb)
            d_t, b_t = tt.render(v, vi, ti[:, rows], y_offset=y0)
            assert torch.equal(d_t, depth[:, rows]) and torch.equal(b_t, bary[:, :, rows])
            out = tt.interpolate(a, vi, ti[:, rows], b_t, y_offset=y0, full_height=H)
            assert torch.equal(out, full[:, :, rows])
    # Without full_height the block is its own frame: the sweep takes local rows.
    own = tt.interpolate(_t(attrs), vi, ti[:, 16:32], bary[:, :, 16:32], y_offset=16)
    assert torch.equal(own, tt.interpolate(_t(attrs), vi, ti[:, 16:32], bary[:, :, 16:32]))


@pytest.mark.parametrize("y0,hb", TILES)
def test_tiles_match_jax_under_the_same_viewport(y0, hb):
    s, idx, attrs, _, _ = _case("soup")
    rows = slice(y0, y0 + hb)
    vi, jidx = jnp.asarray(s["vi"]), jnp.asarray(idx[:, rows])
    rng = np.random.RandomState(y0)
    v64, attrs64 = s["v"].astype(np.float64), attrs.astype(np.float64)
    g_bary = rng.randn(idx.shape[0], 3, hb, W)
    g_out = rng.randn(idx.shape[0], 3, hb, W)

    def jax_side(v, a):
        _, bary = dt.render(v, vi, jidx, y_offset=y0)
        return bary, dt.interpolate(a, vi, jidx, bary, y_offset=y0, full_height=H)

    want_bary, want_out = jax.jit(jax_side)(jnp.asarray(v64), jnp.asarray(attrs64))
    want_gv, want_ga = _jax_vjp(jax_side, (v64, attrs64), (g_bary, g_out))

    v, a = _t(v64).requires_grad_(), _t(attrs64).requires_grad_()
    _, bary = tt.render(v, _t(s["vi"]), _t(idx[:, rows]), y_offset=y0)
    out = tt.interpolate(a, _t(s["vi"]), _t(idx[:, rows]), bary, y_offset=y0, full_height=H)
    np.testing.assert_allclose(to_numpy(bary), np.asarray(want_bary), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(to_numpy(out), np.asarray(want_out), rtol=1e-10, atol=1e-10)
    bg = idx[:, rows] < 0
    np.testing.assert_array_equal(to_numpy(out).transpose(0, 2, 3, 1)[bg],
                                  np.asarray(want_out).transpose(0, 2, 3, 1)[bg])
    got_gv, got_ga = torch.autograd.grad((bary, out), (v, a), (_t(g_bary), _t(g_out)))
    np.testing.assert_allclose(to_numpy(got_gv), want_gv, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(to_numpy(got_ga), want_ga, rtol=1e-10, atol=1e-10)


def _halo_tiles(img, g, idx):
    """(y0, (img, g, idx) rows [y0, y0 + hb + 1)) of 4 bands of hb = H/4
    rows, each with its halo row, one background row appended to the frame
    (zeros, index -1) so the last band's halo is inert."""
    pad = ((0, 0), (0, 0), (0, 1), (0, 0))
    img_p, g_p = np.pad(img, pad), np.pad(g, pad)
    idx_p = np.pad(idx, ((0, 0), (0, 1), (0, 0)), constant_values=-1)
    hb = H // 4
    return [(y0, (img_p[:, :, y0 : y0 + hb + 1], g_p[:, :, y0 : y0 + hb + 1], idx_p[:, y0 : y0 + hb + 1]))
            for y0 in range(0, H, hb)]


@pytest.mark.parametrize("scene", list(SCENES))
def test_edge_grad_backward_tiles_sum_to_the_full_frame(scene):
    """Stencil centres on the frame's last row are dropped; added into the
    frame band by band, the tiles give the full frame's image gradient bit
    for bit."""
    s, idx, _, img, g = _case(scene)
    n = idx.shape[0]
    v, vi = _t(s["v"]), broadcast_vi(_t(s["vi"]), n)
    full = _edge_grad_backward(v, vi, _t(img), _t(idx), _t(g), 1e4)
    total = torch.zeros((n, 3, H + 1, W))
    for y0, (img_b, g_b, idx_b) in _halo_tiles(img, g, idx):
        tile = _edge_grad_backward(v, vi, _t(img_b), _t(idx_b), _t(g_b), 1e4, y_offset=y0, full_height=H)
        total[:, :, y0 : y0 + idx_b.shape[1]] += tile
    assert not total[:, :, H].any()
    assert torch.equal(total[:, :, :H], full)


def test_edge_grad_backward_tiles_match_jax():
    """Each tile against drtk_tpu's ``_edge_grad_backward`` with the same
    ``y_offset`` and ``full_height``, on the soup: in general position, as
    in tests/test_torch_backward.py. On the grid scene pixel centres lie on
    its diagonals (x = 69, y = 18 on the 64 x 96 frame), where rounding
    decides the coverage test, in the full frame as in a tile."""
    s, idx, _, img, g = _case("soup")
    vi = broadcast_vi(_t(s["vi"]), idx.shape[0])
    jax_tile = jax.jit(jax_edge_grad_backward, static_argnums=(5, 7))
    for y0, (img_b, g_b, idx_b) in _halo_tiles(img, g, idx):
        tile = _edge_grad_backward(_t(s["v"]), vi, _t(img_b), _t(idx_b), _t(g_b), 1e4, y_offset=y0, full_height=H)
        want = jax_tile(jnp.asarray(s["v"]), jnp.asarray(to_numpy(vi)), jnp.asarray(img_b), jnp.asarray(idx_b),
                        jnp.asarray(g_b), 1e4, y0, H)
        assert np.abs(np.asarray(want)).max() > 0
        _assert_grad_close(to_numpy(tile), np.asarray(want))


def test_sweep_vectors_are_cached():
    a = interp_mod._sweep_pattern(16, 24, 3, torch.float32, "cpu", y_offset=8, full_height=64)
    b = interp_mod._sweep_pattern(16, 24, 3, torch.float32, "cpu", y_offset=8, full_height=64)
    assert torch.equal(a, b)
    assert interp_mod._sweep_vector(64, torch.float32, torch.device("cpu")) is interp_mod._sweep_vector(
        64, torch.float32, torch.device("cpu"))
    full = interp_mod._sweep_pattern(64, 24, 3, torch.float32, "cpu")
    assert torch.equal(a, full[:, 8:24])
