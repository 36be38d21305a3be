"""drtk_tpu_torch's ops against drtk_tpu's on the same numpy inputs (CPU).

Every input is made with numpy (seeded) and reaches both packages as numpy
arrays, through ``scene_from_numpy`` on the port's side. Tolerances, and why:

* rasterize: the JAX package's own parity rule between its two lowerings
  (tests/test_rasterize_pallas.py): index images agree except at pixels
  whose two depths agree to 1e-4 relative (two triangles tie, and rounding
  decides), fewer than 1e-3 of the pixels; depth to rtol 1e-4 / atol 1e-6.
  XLA contracts products and sums into FMAs on the CPU, the port does not,
  so the last bits of the edge values differ.
* gather_rows_by_index: it copies rows, so bit-exact (assert_array_equal).
* render, interpolate (f32, fed the same index image): rtol 1e-5 / atol
  1e-5, for the same FMA reason; the interpolate background sweep is
  bit-exact. The float64 oracles agree to 1e-12.
* grid_sample: 1e-5 against both the JAX package and
  torch.nn.functional.grid_sample (f32 weights in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import __graft_entry__ as graft  # noqa: E402
import drtk_tpu as dt  # noqa: E402
from drtk_tpu.ops.grid_sample import grid_sample as jax_grid_sample  # noqa: E402
from drtk_tpu.ops.rasterize import _rasterize_xla  # noqa: E402
from drtk_tpu.ops.rasterize_pallas import rasterize_pallas  # noqa: E402
from drtk_tpu.ops.segment_rows import gather_rows_by_index as jax_gather_rows  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import scene_from_numpy, to_numpy  # noqa: E402
from drtk_tpu_torch.ops.grid_sample import grid_sample  # noqa: E402
from drtk_tpu_torch.ops.segment_rows import gather_rows_by_index  # noqa: E402
from drtk_tpu_torch.scenes import entry_scene_arrays, make_scene_arrays  # noqa: E402
from tests.utils import grid_mesh, two_triangles_scene  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread, _soup  # noqa: E402,F401


def _two_triangles():
    v, vi, _ = two_triangles_scene(h=128, w=256)
    return {"v": np.array(v), "vi": np.array(vi)}


def _grid():
    v, vi = grid_mesh(h=128, w=256, gn=10)
    return {"v": np.array(v), "vi": np.array(vi)}


# name -> (scene builder, height, width)
SCENES = {
    "two_triangles": (_two_triangles, 128, 256),
    "grid": (_grid, 128, 256),
    "soup_batch3": (lambda: _soup(3, 64, 96, 64, 128, 1), 64, 128),
    "nonaligned": (lambda: _soup(1, 48, 64, 70, 130, 2), 70, 130),
    "entry": (lambda: entry_scene_arrays(num_f=180, h=96, w=128, seed=1), 96, 128),
}


def _jax_vi(v, vi):
    return jnp.broadcast_to(jnp.asarray(vi)[None], (v.shape[0],) + vi.shape)


def _port_raster(s, h, w):
    t = scene_from_numpy({"v": s["v"], "vi": s["vi"]}, device="cpu")
    d, i = tt.rasterize_with_depth(t["v"], t["vi"], h, w)
    return to_numpy(d), to_numpy(i)


def _assert_raster_match(d_ref, i_ref, d, i):
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    assert i.dtype == np.int32 and i.shape == i_ref.shape
    mism = i_ref != i
    if mism.any():
        assert mism.mean() < 1e-3, f"{mism.sum()} index mismatches"
        near_tie = np.abs(d_ref - d) <= 1e-4 * np.abs(d_ref) + 1e-6
        assert near_tie[mism].all(), "index mismatch at non-tied depth"
    np.testing.assert_allclose(d_ref, d, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# (a) rasterize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene", list(SCENES))
def test_rasterize_matches_xla(scene):
    make, h, w = SCENES[scene]
    s = make()
    d_ref, i_ref = jax.jit(lambda v, vi: _rasterize_xla(v, vi, h, w))(
        jnp.asarray(s["v"]), _jax_vi(s["v"], s["vi"]))
    d, i = _port_raster(s, h, w)
    assert (i >= 0).any()
    _assert_raster_match(d_ref, i_ref, d, i)


@pytest.mark.parametrize("scene", ["two_triangles", "soup_batch3", "nonaligned"])
def test_rasterize_matches_pallas_interpret(scene):
    make, h, w = SCENES[scene]
    s = make()
    d_ref, i_ref = rasterize_pallas(jnp.asarray(s["v"]), _jax_vi(s["v"], s["vi"]), h, w, interpret=True)
    _assert_raster_match(d_ref, i_ref, *_port_raster(s, h, w))


def test_rasterize_public_entry_matches_jax():
    """The public entry points, with [F, 3] vi broadcast over a batch of 2.

    The jitted JAX entry fuses and contracts FMAs, so wherever depths tie
    (along the intersection curve of two triangles, or at pixel centres
    exactly on a shared edge) rounding flips winners over whole runs of
    pixels, more than 1e-3 of a small canvas. Hence grid meshes, which do
    not interpenetrate, on a 47x83 canvas, where no pixel centre falls on a
    grid edge."""
    h, w = 47, 83
    grids = [grid_mesh(h=h, w=w, gn=7, seed=seed) for seed in (0, 1)]
    s = {"v": np.concatenate([np.asarray(g[0]) for g in grids]), "vi": np.asarray(grids[0][1])}
    d_ref, i_ref = dt.rasterize_with_depth(jnp.asarray(s["v"]), jnp.asarray(s["vi"]), h, w)
    t = scene_from_numpy(s, device="cpu")
    idx = tt.rasterize(t["v"], t["vi"], h, w)
    d, i = tt.rasterize_with_depth(t["v"], t["vi"], h, w)
    assert torch.equal(idx, i) and not d.requires_grad
    _assert_raster_match(d_ref, i_ref, to_numpy(d), to_numpy(i))


def test_rasterize_half_precision_computes_in_f32():
    s = _soup(1, 40, 60, 48, 80, 8)
    t = scene_from_numpy(s, device="cpu")
    d16, i16 = tt.rasterize_with_depth(t["v"].to(torch.float16), t["vi"], 48, 80)
    d32, i32 = tt.rasterize_with_depth(t["v"].to(torch.float16).float(), t["vi"], 48, 80)
    assert d16.dtype == torch.float32
    assert torch.equal(d16, d32) and torch.equal(i16, i32)


# ---------------------------------------------------------------------------
# (b) the face-row gather (kernel B2's function): bit-exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k_dim", [6, 9, 16])
def test_gather_rows_bit_exact(k_dim):
    make, h, w = SCENES["soup_batch3"]
    s = make()
    _, idx = _port_raster(s, h, w)
    assert (idx < 0).any() and (idx >= 0).any()  # background pixels included
    rng = np.random.RandomState(k_dim)
    table = rng.randn(idx.shape[0], s["vi"].shape[0], k_dim).astype(np.float32)
    want = jax_gather_rows(jnp.asarray(table), jnp.asarray(idx), interpret=True)
    got = gather_rows_by_index(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    assert (to_numpy(got)[idx < 0] == 0).all()


def test_gather_rows_f64_keeps_dtype():
    rng = np.random.RandomState(0)
    table = rng.randn(2, 50, 9)
    idx = rng.randint(-1, 50, (2, 20, 30)).astype(np.int32)
    want = jax_gather_rows(jnp.asarray(table), jnp.asarray(idx), interpret=True)
    got = gather_rows_by_index(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


# ---------------------------------------------------------------------------
# (c) render and interpolate, fed the same index image
# ---------------------------------------------------------------------------


def _shared_index(scene):
    make, h, w = SCENES[scene]
    s = make()
    rng = np.random.RandomState(11)
    s["vt"] = rng.uniform(0, 1, s["v"].shape[:2] + (2,)).astype(np.float32)
    idx = np.array(dt.rasterize(jnp.asarray(s["v"]), jnp.asarray(s["vi"]), h, w))  # writable copy
    return s, idx


@pytest.mark.parametrize("scene", ["grid", "soup_batch3", "nonaligned"])
def test_render_matches_jax(scene):
    s, idx = _shared_index(scene)
    d_ref, b_ref = jax.jit(dt.render)(jnp.asarray(s["v"]), jnp.asarray(s["vi"]), jnp.asarray(idx))
    t = scene_from_numpy({"v": s["v"], "vi": s["vi"]}, device="cpu")
    d, b = tt.render(t["v"], t["vi"], torch.from_numpy(idx))
    assert b.shape == (idx.shape[0], 3) + idx.shape[1:]
    np.testing.assert_allclose(to_numpy(d), np.asarray(d_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_numpy(b), np.asarray(b_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scene", ["grid", "soup_batch3", "nonaligned"])
def test_interpolate_matches_jax(scene):
    s, idx = _shared_index(scene)
    _, b_ref = jax.jit(dt.render)(jnp.asarray(s["v"]), jnp.asarray(s["vi"]), jnp.asarray(idx))
    want = np.asarray(jax.jit(dt.interpolate)(jnp.asarray(s["vt"]), jnp.asarray(s["vi"]), jnp.asarray(idx), b_ref))
    t = scene_from_numpy({"vt": s["vt"], "vi": s["vi"]}, device="cpu")
    got = to_numpy(tt.interpolate(t["vt"], t["vi"], torch.from_numpy(idx), torch.from_numpy(np.array(b_ref))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    bg = np.broadcast_to((idx < 0)[:, None], got.shape)
    assert bg.any()
    np.testing.assert_array_equal(got[bg], want[bg])  # the sweep is bit-exact


@pytest.mark.parametrize("channels", [1, 2, 5])
def test_interpolate_sweep_bit_exact_f64(channels):
    rng = np.random.RandomState(channels)
    attrs = rng.randn(1, 10, channels)
    vi = np.array([[0, 1, 2]], np.int32)
    idx = np.full((1, 37, 53), -1, np.int32)
    idx[0, 3:9, 4:20] = 0
    bary = rng.rand(1, 3, 37, 53)
    want = np.asarray(dt.interpolate(jnp.asarray(attrs), jnp.asarray(vi), jnp.asarray(idx), jnp.asarray(bary)))
    got = to_numpy(tt.interpolate(torch.from_numpy(attrs), torch.from_numpy(vi), torch.from_numpy(idx),
                                  torch.from_numpy(bary)))
    assert got.dtype == np.float64
    bg = np.broadcast_to((idx < 0)[:, None], got.shape)
    np.testing.assert_array_equal(got[bg], want[bg])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("scene", ["grid", "soup_batch3"])
def test_refs_match_jax_refs_f64(scene):
    s, idx = _shared_index(scene)
    v64, vt64 = s["v"].astype(np.float64), s["vt"].astype(np.float64)
    d_ref, b_ref = jax.jit(dt.render_ref)(jnp.asarray(v64), jnp.asarray(s["vi"]), jnp.asarray(idx))
    d, b = tt.render_ref(torch.from_numpy(v64), torch.from_numpy(s["vi"]), torch.from_numpy(idx))
    assert d.dtype == torch.float64
    np.testing.assert_allclose(to_numpy(d), np.asarray(d_ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(to_numpy(b), np.asarray(b_ref), rtol=1e-12, atol=1e-12)
    i_ref = jax.jit(dt.interpolate_ref)(jnp.asarray(vt64), jnp.asarray(s["vi"]), jnp.asarray(idx), b_ref)
    i = tt.interpolate_ref(torch.from_numpy(vt64), torch.from_numpy(s["vi"]), torch.from_numpy(idx), b)
    np.testing.assert_allclose(to_numpy(i), np.asarray(i_ref), rtol=1e-12, atol=1e-12)
    # The f32 ops agree with the f64 oracles to f32 precision.
    d32, b32 = tt.render(torch.from_numpy(s["v"]), torch.from_numpy(s["vi"]), torch.from_numpy(idx))
    np.testing.assert_allclose(to_numpy(d32), to_numpy(d), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_numpy(b32), to_numpy(b), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# (d) grid_sample: 3 modes x 3 paddings x align_corners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bicubic"])
def test_grid_sample_matches_jax_and_torch(mode, padding_mode, align_corners):
    rng = np.random.RandomState(3)
    tex = rng.rand(2, 3, 13, 17).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 9, 11, 2)).astype(np.float32)
    kw = dict(mode=mode, padding_mode=padding_mode, align_corners=align_corners)
    got = to_numpy(grid_sample(torch.from_numpy(tex), torch.from_numpy(grid), **kw))
    want_jax = np.asarray(jax_grid_sample(jnp.asarray(tex), jnp.asarray(grid), **kw))
    want_torch = to_numpy(torch.nn.functional.grid_sample(torch.from_numpy(tex), torch.from_numpy(grid), **kw))
    assert got.shape == (2, 3, 9, 11)
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_torch, rtol=1e-5, atol=1e-5)


def test_grid_sample_is_differentiable_and_exported():
    assert tt.grid_sample is grid_sample
    tex = torch.rand(1, 2, 6, 7, dtype=torch.float64, requires_grad=True)
    grid = (torch.rand(1, 4, 5, 2, dtype=torch.float64) * 1.8 - 0.9).requires_grad_()
    assert torch.autograd.gradcheck(lambda t, g: grid_sample(t, g, padding_mode="border"), (tex, grid))


def test_grid_sample_validation():
    tex, grid = torch.zeros(1, 1, 4, 4), torch.zeros(1, 2, 2, 2)
    with pytest.raises(ValueError, match="mode"):
        grid_sample(tex, grid, mode="area")
    with pytest.raises(ValueError, match="padding_mode"):
        grid_sample(tex, grid, padding_mode="wrap")
    with pytest.raises(ValueError, match="input"):
        grid_sample(tex[0], grid)
    with pytest.raises(ValueError, match="grid"):
        grid_sample(tex, torch.zeros(1, 2, 2, 3))


# ---------------------------------------------------------------------------
# (e) edge_grad_estimator, and the backward passes run
# ---------------------------------------------------------------------------


def _small_frame():
    s, idx = _shared_index("soup_batch3")
    v = torch.from_numpy(s["v"]).requires_grad_()
    vi = torch.from_numpy(s["vi"])
    index_img = torch.from_numpy(idx)
    return v, vi, index_img, s


def test_edge_grad_forward_is_identity_and_backward_raises():
    """The forward is the identity; the backward runs and is finite (its
    values are held against the JAX package in test_torch_backward.py).
    Only the unsupported ``v_pix_img_hook`` raises."""
    v, vi, index_img, _ = _small_frame()
    _, bary = tt.render(v.detach(), vi, index_img)
    img = torch.rand((v.shape[0], 3) + tuple(index_img.shape[1:]), generator=torch.Generator().manual_seed(0),
                     requires_grad=True)
    out = tt.edge_grad_estimator(v_pix=v, vi=vi, bary_img=bary, img=img, index_img=index_img)
    assert torch.equal(out, img)
    out.sum().backward()
    assert torch.equal(img.grad, torch.ones_like(img))
    assert v.grad is not None and bool(torch.isfinite(v.grad).all()) and bool((v.grad != 0).any())
    with pytest.raises(NotImplementedError):
        tt.edge_grad_estimator(v, vi, bary, img, index_img, v_pix_img_hook=print)


def test_render_and_interpolate_backward_raise():
    """render and interpolate differentiate (they raised before the
    backward was ported): the backward runs and is finite."""
    v, vi, index_img, s = _small_frame()
    depth, bary = tt.render(v, vi, index_img)
    depth.sum().backward()
    assert v.grad is not None and bool(torch.isfinite(v.grad).all()) and bool((v.grad != 0).any())
    vt = torch.from_numpy(s["vt"]).requires_grad_()
    b = bary.detach().requires_grad_()
    out = tt.interpolate(vt, vi, index_img, b)
    out.sum().backward()
    assert bool(torch.isfinite(vt.grad).all()) and bool((vt.grad != 0).any())
    assert bool(torch.isfinite(b.grad).all())


# ---------------------------------------------------------------------------
# (g) validation
# ---------------------------------------------------------------------------


def _raster_args():
    s = _soup(1, 20, 10, 16, 16, 0)
    return torch.from_numpy(s["v"]), torch.from_numpy(s["vi"])


@pytest.mark.parametrize(
    "case, exc",
    [
        ("int64_vi", ValueError),
        ("bad_v_shape", ValueError),
        ("zero_height", ValueError),
        ("batch_mismatch", ValueError),
        ("wireframe", ValueError),
        ("y_offset", ValueError),
        ("full_height", ValueError),
        ("distortion_mode", NotImplementedError),
    ],
)
def test_rasterize_validation(case, exc):
    v, vi = _raster_args()
    kwargs = {}
    h = 16
    if case == "int64_vi":
        vi = vi.long()
    elif case == "bad_v_shape":
        v = v[..., :2]
    elif case == "zero_height":
        h = 0
    elif case == "batch_mismatch":
        vi = vi[None].expand(2, -1, -1).contiguous()
    elif case == "wireframe":  # wireframe=True validates like the filled mode
        vi = vi.long()
        kwargs = {"wireframe": True}
    elif case == "y_offset":  # rows [4, 20) of a 16-row frame
        kwargs = {"y_offset": 4}
    elif case == "full_height":
        kwargs = {"y_offset": 4, "full_height": 19}
    else:  # the transform in front of the rasterizer takes a lens; its Jacobian-vector product is pinhole only
        cam = dict(campos=torch.zeros(1, 3), camrot=torch.eye(3)[None], focal=torch.eye(2)[None],
                   princpt=torch.zeros(1, 2))
        v_pix = tt.transform(v, **cam, distortion_mode="fisheye", distortion_coeff=torch.zeros(1, 4))
        assert v_pix.shape == v.shape and bool(torch.isfinite(v_pix).all())
        with pytest.raises(exc, match="not implemented"):
            tt.utils.project_points_grad(v, v, cam["campos"], cam["camrot"], cam["focal"], "fisheye",
                                         torch.zeros(1, 4))
        return
    with pytest.raises(exc):
        tt.rasterize(v, vi, h, 16, **kwargs)


def test_scene_from_numpy_validation():
    s = _soup(1, 20, 10, 16, 16, 0)
    with pytest.raises(ValueError, match="int32"):
        scene_from_numpy({"v": s["v"], "vi": s["vi"].astype(np.int64)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        scene_from_numpy({"v": s["v"][0]}, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        scene_from_numpy({"faces": s["vi"]}, device="cpu")
    t = scene_from_numpy(s, device="cpu")
    assert t["vi"].dtype == torch.int32 and t["v"].dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(t["v"]), s["v"])


def test_op_validation():
    v, vi = _raster_args()
    idx = torch.zeros((1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tt.render(v[0], vi, idx)
    with pytest.raises(ValueError):
        tt.render(v, vi, idx[0])
    with pytest.raises(ValueError):
        tt.interpolate(v[0], vi, idx, torch.zeros(1, 3, 4, 4))
    with pytest.raises(ValueError):
        tt.interpolate(v, vi, idx, torch.zeros(1, 2, 4, 4))


# ---------------------------------------------------------------------------
# (h) the scene builders reproduce the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_scene_builders_match(seed):
    got = make_scene_arrays(48, 64, 7, seed)
    want = bench.make_scene(48, 64, 7, seed)
    for key, arr in zip(("v", "vi", "vt", "tex"), want):
        assert got[key].dtype == np.asarray(arr).dtype
        np.testing.assert_array_equal(got[key], np.asarray(arr))
    got = entry_scene_arrays(batch=2, num_v=30, num_f=40, h=32, w=48, seed=seed)
    want = graft._scene(batch=2, num_v=30, num_f=40, h=32, w=48, seed=seed)
    for key, arr in zip(("v", "vi", "vt", "tex"), want):
        assert got[key].dtype == np.asarray(arr).dtype
        np.testing.assert_array_equal(got[key], np.asarray(arr))
