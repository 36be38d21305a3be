"""drtk_tpu_torch's wireframe rasterization and row-tile viewports against
drtk_tpu's on the same numpy inputs (CPU).

The JAX side runs as its own CPU tests run it: ``dt.rasterize(...,
wireframe=True)`` resolves to ``_rasterize_lines_impl``, and one scene also
runs through ``rasterize_lines_pallas(..., interpret=True)``.

Tolerances, and why: in float32 the repository's rasterizer rule, index
flips only at pixels whose two depths agree to 1e-4 relative, on fewer than
1e-3 of the pixels, depth to rtol 1e-4 / atol 1e-6. XLA contracts products
and sums into FMAs on the CPU and the port does not, so the last bits of
the edge values and crossings differ. Two scenes hold a face with two equal
corners: there XLA's contracted ``a*b - b*a`` leaves a nonzero area, JAX
keeps the face and draws its edges, and the port, which rounds each product,
culls it. Those scenes, and every scene once more, run in float64, where the
port matches exactly but at depth ties (two depths within 1e-10 relative),
depth to 1e-12. Viewport tiles equal the full frame bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import drtk_tpu as dt  # noqa: E402
from drtk_tpu.ops.rasterize_pallas import rasterize_lines_pallas  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from drtk_tpu_torch.scenes import with_edge_flags  # noqa: E402
from tests.utils import random_mesh, two_triangles_scene  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401


def _two_triangles():
    v, vi, _ = two_triangles_scene(h=128, w=256)
    return np.array(v), with_edge_flags(np.array(vi)), 128, 256


def _random_n2():
    v, vi = random_mesh(jax.random.PRNGKey(7), n=2, num_v=48, num_f=72, h=96, w=160)
    return np.array(v), with_edge_flags(np.array(vi)), 96, 160


def _random_mesh_8():
    v, vi = random_mesh(jax.random.PRNGKey(8), n=1, num_v=32, num_f=48, h=64, w=128)
    return np.array(v), np.array(vi), 64, 128


def _partial_flags():
    v, vi, h, w = _random_mesh_8()
    return v, with_edge_flags(vi, np.arange(vi.shape[0]) % 7 + 1), h, w


def _nibble_f():
    v, vi, h, w = _random_mesh_8()
    vi = with_edge_flags(vi, 0xF)
    assert (vi[:, 0] < 0).all()
    return v, vi, h, w


def _canvas_sized():
    """Triangles larger than the canvas, overhanging it on every side."""
    rng = np.random.RandomState(9)
    h = w = 128
    xy = rng.uniform(-0.5, 1.5, (1, 24, 2)).astype(np.float32) * np.float32([w, h])
    z = rng.uniform(2.0, 8.0, (1, 24, 1)).astype(np.float32)
    vi = rng.randint(0, 24, (30, 3)).astype(np.int32)
    return np.concatenate([xy, z], -1), with_edge_flags(vi), h, w


def _basic():
    """tests/test_rasterize.py::test_wireframe_basic's triangle, all edges
    visible."""
    v = np.array([[[8.0, 8.0, 5.0], [56.0, 8.0, 5.0], [30.0, 56.0, 5.0]]], np.float32)
    return v, with_edge_flags(np.array([[0, 1, 2]], np.int32)), 64, 64


SCENES = {
    "two_triangles": _two_triangles,
    "random_n2": _random_n2,
    "partial_flags": _partial_flags,
    "nibble_f": _nibble_f,
    "canvas_sized": _canvas_sized,
    "basic": _basic,
}
# Scenes with a face of two equal corners (see the module docstring).
FMA_AREA_SCENES = ("partial_flags", "nibble_f")


def _jax_raster(v, vi, h, w, **kw):
    d, i = dt.rasterize_with_depth(jnp.asarray(v), jnp.asarray(vi), h, w, **kw)
    return np.asarray(d), np.asarray(i)


def _port_raster(v, vi, h, w, **kw):
    d, i = tt.rasterize_with_depth(torch.from_numpy(np.array(v)), torch.from_numpy(np.array(vi)), h, w, **kw)
    return to_numpy(d), to_numpy(i)


def _assert_raster_match(d_ref, i_ref, d, i, tie_rtol=1e-4, share=1e-3, rtol=1e-4, atol=1e-6):
    assert i.dtype == np.int32 and i.shape == i_ref.shape and d.dtype == d_ref.dtype
    mism = i_ref != i
    if mism.any():
        assert mism.mean() < share, f"{mism.sum()} index mismatches"
        near_tie = np.abs(d_ref - d) <= tie_rtol * np.abs(d_ref) + atol
        assert near_tie[mism].all(), "index mismatch at non-tied depth"
    np.testing.assert_allclose(d, d_ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("scene", [s for s in SCENES if s not in FMA_AREA_SCENES])
def test_wireframe_matches_jax_f32(scene):
    v, vi, h, w = SCENES[scene]()
    d_ref, i_ref = _jax_raster(v, vi, h, w, wireframe=True)
    d, i = _port_raster(v, vi, h, w, wireframe=True)
    assert (i >= 0).any() and ((i < 0) & (d > 0)).any()  # crossings, and interiors with depth only
    _assert_raster_match(d_ref, i_ref, d, i)


@pytest.mark.parametrize("scene", list(SCENES))
def test_wireframe_matches_jax_f64(scene):
    v, vi, h, w = SCENES[scene]()
    v = v.astype(np.float64)
    d_ref, i_ref = _jax_raster(v, vi, h, w, wireframe=True)
    d, i = _port_raster(v, vi, h, w, wireframe=True)
    assert d.dtype == np.float64 and (i >= 0).any()
    _assert_raster_match(d_ref, i_ref, d, i, tie_rtol=1e-10, share=1.0, rtol=1e-12, atol=1e-12)


def test_wireframe_matches_pallas_interpret():
    v, vi, h, w = _random_n2()
    vib = np.broadcast_to(vi[None], (v.shape[0],) + vi.shape)
    d_ref, i_ref = rasterize_lines_pallas(jnp.asarray(v), jnp.asarray(vib), h, w, interpret=True)
    _assert_raster_match(np.asarray(d_ref), np.asarray(i_ref), *_port_raster(v, vi, h, w, wireframe=True))


def test_wireframe_is_thin_and_follows_the_flags():
    """tests/test_rasterize.py::test_wireframe_basic: wireframe coverage is
    a thin subset of the filled triangle's, nothing is indexed with no edge
    visible, and the frame border is never written."""
    v, vi, h, w = _basic()
    t_v = torch.from_numpy(v)
    idx_wf = tt.rasterize(t_v, torch.from_numpy(vi), h, w, wireframe=True)
    idx_tri = tt.rasterize(t_v, torch.from_numpy(vi & 0x0FFFFFFF), h, w)
    n_wf, n_tri = int((idx_wf == 0).sum()), int((idx_tri == 0).sum())
    assert 0 < n_wf < n_tri
    assert not bool((tt.rasterize(t_v, torch.from_numpy(vi & 0x0FFFFFFF), h, w, wireframe=True) == 0).any())
    big = np.array([[[-50.0, -50.0, 5.0], [300.0, -50.0, 5.0], [-50.0, 300.0, 5.0]]], np.float32)
    d, _ = tt.rasterize_with_depth(torch.from_numpy(big), torch.from_numpy(vi), h, w, wireframe=True)
    inner = np.zeros((1, h, w), bool)
    inner[:, 1:-1, 1:-1] = True
    assert (to_numpy(d)[~inner] == 0).all() and (to_numpy(d)[inner] > 0).all()


# ---------------------------------------------------------------------------
# Row-tile viewports
# ---------------------------------------------------------------------------


def _viewport_scene():
    v, vi = random_mesh(jax.random.PRNGKey(11), num_v=64, num_f=96, h=128, w=256)
    return np.array(v, np.float32), with_edge_flags(np.array(vi)), 128, 256


@pytest.mark.parametrize("wireframe", [False, True])
def test_viewport_tiles_equal_the_full_frame(wireframe):
    v, vi, h, w = _viewport_scene()
    d_full, i_full = _port_raster(v, vi, h, w, wireframe=wireframe)
    assert (i_full >= 0).any()
    for y0, hb in [(0, 32), (32, 32), (64, 32), (96, 32), (12, 84), (127, 1)]:
        d_t, i_t = _port_raster(v, vi, hb, w, wireframe=wireframe, y_offset=y0, full_height=h)
        np.testing.assert_array_equal(i_t, i_full[:, y0 : y0 + hb])
        np.testing.assert_array_equal(d_t, d_full[:, y0 : y0 + hb])


@pytest.mark.parametrize("wireframe", [False, True])
def test_viewport_tiles_match_jax(wireframe):
    """The pattern of tests/test_spmd.py::test_wireframe_tile_viewport, on a
    scene with crossings and overlaps, in float32 and float64."""
    v, vi, h, w = _viewport_scene()
    for dtype in (np.float32, np.float64):
        vv = v.astype(dtype)
        for y0, hb in [(16, 32), (96, 32)]:
            kw = dict(wireframe=wireframe, y_offset=y0, full_height=h)
            d_ref, i_ref = _jax_raster(vv, vi, hb, w, impl="xla", **kw)
            d, i = _port_raster(vv, vi, hb, w, **kw)
            if dtype == np.float32:
                _assert_raster_match(d_ref, i_ref, d, i)
            else:
                _assert_raster_match(d_ref, i_ref, d, i, tie_rtol=1e-10, share=1.0, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"y_offset": 4},  # no full_height: rows 4..19 of a 16-row frame
        {"y_offset": 8, "full_height": 20},
        {"y_offset": -1, "full_height": 32},
        {"y_offset": 1.5, "full_height": 32},
    ],
)
def test_viewport_validation(kwargs):
    v = torch.zeros((1, 3, 3))
    vi = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    for wireframe in (False, True):
        with pytest.raises(ValueError):
            tt.rasterize(v, vi, 16, 16, wireframe=wireframe, **kwargs)
