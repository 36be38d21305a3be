"""The two multi-view paths of the full-size chip phases, at 2 views of
64x64 (a 9x9-vertex world grid of 128 triangles, a 3x32x32 texture), against
the same composition of drtk_tpu's public functions (CPU):

* the inverse8 training step through a lens: Fisheye62 with ``fov`` given
  (computed once with the estimator, as the chip path does), and a per-view
  list of radial-tangential and fisheye;
* ``render_mipmap_multiview``: the analytic uv Jacobian
  (``screen_space_uv_derivative``) driving ``mipmap_grid_sample`` from a
  4-level box pyramid, as ``examples/04_rendering_meshes.py`` shades.

Both sides take JAX's index image (the ``idx_fixed`` reasoning of
tests/test_torch_inverse8.py). Tolerances: the lens step in float32, image
to 1e-5, loss to 1e-5 relative, gradients to the world vertices and the
texture to 1e-4 of their largest magnitude, as the pinhole step is held. The
mipmap path in float64, image and gradients to the world vertices and the
levels to 1e-10 of their largest magnitude: its tap count and mip level are
floors of the Jacobian's norms, which one float32 rounding can move across a
step on a grid scene, in JAX as in the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import drtk_tpu as dt  # noqa: E402
from drtk_tpu.ops.grid_sample import grid_sample as jax_grid_sample  # noqa: E402
from drtk_tpu.utils import projection as jproj  # noqa: E402
from drtk_tpu_torch.interop import scene_from_numpy, to_numpy  # noqa: E402
from drtk_tpu_torch.pipeline import inverse8_step, render_mipmap_multiview, render_multiview  # noqa: E402
from drtk_tpu_torch.scenes import box_pyramid, inverse8_lens_arrays, inverse8_scene_arrays  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401

H = W = 64
GN, VIEWS, TEX = 9, 2, 32
CAMS = ("campos", "camrot", "focal", "princpt")
MIXED = ["radial-tangential", "fisheye"]


def _lens(name):
    """The lens keyword arguments of transform, as numpy: mode,
    coefficients and the fov each row's estimator gives."""
    if name == "fisheye62":
        coeff = inverse8_lens_arrays("fisheye62", VIEWS)
        return {"distortion_mode": "fisheye62", "distortion_coeff": coeff,
                "fov": np.asarray(jproj.estimate_fisheye62_fov(coeff))}
    coeff = inverse8_lens_arrays(MIXED, VIEWS)
    fov = np.concatenate([np.asarray(jproj.estimate_rt_fov(coeff[:1])),
                          np.asarray(jproj.estimate_fisheye_fov(coeff[1:]))])
    return {"distortion_mode": MIXED, "distortion_coeff": coeff, "fov": fov}


def _jax_views(v1, views):
    return jnp.broadcast_to(v1, (views,) + v1.shape[1:])


def _jax_lens_forward(s, lens, v1, tex, idx=None):
    """``bench.bench_inverse8``'s forward with the cameras' lens."""
    v_pix = dt.transform(_jax_views(v1, VIEWS), *(s[k] for k in CAMS), **lens)
    index_img = dt.rasterize(v_pix, s["vi"], H, W) if idx is None else idx
    _, bary = dt.render(v_pix, s["vi"], index_img)
    vt_img = dt.interpolate(_jax_views(s["vt"], VIEWS), s["vi"], index_img, bary)
    uv = jnp.moveaxis(vt_img, 1, -1) * 2.0 - 1.0
    rgb = jax_grid_sample(jnp.broadcast_to(tex, (VIEWS,) + tex.shape[1:]), uv, mode="bilinear", padding_mode="border")
    maskf = (index_img != -1)[:, None].astype(rgb.dtype)
    img = jnp.concatenate([rgb * maskf, maskf], axis=1)
    return dt.edge_grad_estimator(v_pix=v_pix, vi=s["vi"], bary_img=bary, img=img, index_img=index_img), index_img


@pytest.fixture(scope="module", params=["fisheye62", "mixed"])
def lens_case(request):
    arrays = inverse8_scene_arrays(H, GN, VIEWS, seed=0, tex_size=TEX)
    lens = _lens(request.param)
    s = {k: jnp.asarray(a) for k, a in arrays.items()}
    jlens = {k: (v if k == "distortion_mode" else jnp.asarray(v)) for k, v in lens.items()}
    forward = jax.jit(lambda v, t, idx=None: _jax_lens_forward(s, jlens, v, t, idx))
    img_gt, _ = forward(s["v_world"], s["tex_gt"])
    v0, tex0 = s["v_world"] + 0.02, jnp.full_like(s["tex_gt"], 0.5)
    img0, idx0 = forward(v0, tex0)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jnp.mean((forward(*p, idx0)[0] - img_gt) ** 2)))((v0, tex0))
    return {
        "arrays": arrays, "lens": lens, "img_gt": np.array(img_gt), "v0": np.array(v0), "tex0": np.array(tex0),
        "img0": np.array(img0), "idx0": np.array(idx0), "loss": float(loss), "grads": [np.array(g) for g in grads],
    }


def _port_cams(case):
    t = scene_from_numpy({**case["arrays"], "distortion_coeff": case["lens"]["distortion_coeff"],
                          "fov": case["lens"]["fov"]}, device="cpu")
    cams = {k: t[k] for k in CAMS}
    cams.update(distortion_mode=case["lens"]["distortion_mode"], distortion_coeff=t["distortion_coeff"],
                fov=t["fov"])
    return t, cams


def test_lens_render_matches_jax(lens_case):
    t, cams = _port_cams(lens_case)
    assert 0.3 < (lens_case["idx0"] >= 0).mean() < 1.0
    v0, tex0 = (torch.from_numpy(lens_case[k].copy()) for k in ("v0", "tex0"))
    img, _ = render_multiview(v0, t["vi"], t["vt"], tex0, cams, H, W, device="cpu",
                              index_img=torch.from_numpy(lens_case["idx0"]))
    np.testing.assert_allclose(to_numpy(img), lens_case["img0"], rtol=0, atol=1e-5)
    _, idx_own = render_multiview(v0, t["vi"], t["vt"], tex0, cams, H, W, device="cpu")
    assert (to_numpy(idx_own) == lens_case["idx0"]).mean() >= 0.999


def test_lens_step_gradients_match_jax(lens_case):
    t, cams = _port_cams(lens_case)
    params = tuple(torch.from_numpy(lens_case[k].copy()).requires_grad_() for k in ("v0", "tex0"))
    loss, grads = inverse8_step(params, torch.optim.Adam(params, lr=1e-3), t["vi"], t["vt"], cams,
                                torch.from_numpy(lens_case["img_gt"]), H, W, device="cpu",
                                index_img=torch.from_numpy(lens_case["idx0"]))
    assert abs(float(loss) - lens_case["loss"]) <= 1e-5 * lens_case["loss"]
    for name, want in zip(("v_world", "tex"), lens_case["grads"]):
        got = to_numpy(grads[name])
        assert np.abs(want).max() > 0
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


def _mipmap_inputs():
    a = inverse8_scene_arrays(H, GN, VIEWS, seed=0, tex_size=TEX)
    a = {k: (x.astype(np.float64) if x.dtype.kind == "f" else x) for k, x in a.items()}
    return a, box_pyramid(a["tex_gt"], 4)


def _jax_mipmap_views(a, v1, levels, idx=None):
    """``examples/04_rendering_meshes.py``'s shading per view, ended as the
    multi-view forward ends."""
    s = {k: jnp.asarray(x) for k, x in a.items()}
    v = _jax_views(v1, VIEWS)
    vt = _jax_views(s["vt"], VIEWS)
    v_pix = dt.transform(v, *(s[k] for k in CAMS))
    index_img = dt.rasterize(v_pix, s["vi"], H, W) if idx is None else idx
    _, bary = dt.render(v_pix, s["vi"], index_img)
    mask = index_img != -1
    uv = jnp.moveaxis(dt.interpolate(vt, s["vi"], index_img, bary), 1, -1) * 2.0 - 1.0
    jac = dt.screen_space_uv_derivative(v, vt, s["vi"], s["vi"], index_img, bary, mask, s["campos"], s["camrot"],
                                        s["focal"])
    rgb = dt.mipmap_grid_sample([jnp.broadcast_to(x, (VIEWS,) + x.shape[1:]) for x in levels], uv, jac, max_aniso=4,
                                padding_mode="border")
    maskf = mask[:, None].astype(rgb.dtype)
    img = jnp.concatenate([rgb * maskf, maskf], axis=1)
    return dt.edge_grad_estimator(v_pix=v_pix, vi=s["vi"], bary_img=bary, img=img, index_img=index_img), index_img


def test_render_mipmap_multiview_matches_jax():
    a, levels = _mipmap_inputs()
    v1 = jnp.asarray(a["v_world"])
    jlevels = [jnp.asarray(x) for x in levels]
    img_j, idx = jax.jit(lambda v, lv: _jax_mipmap_views(a, v, lv))(v1, jlevels)
    w = np.random.RandomState(1).randn(*img_j.shape)
    grads_j = jax.jit(jax.grad(lambda v, lv: jnp.sum(_jax_mipmap_views(a, v, lv, idx)[0] * w), (0, 1)))(v1, jlevels)

    t = scene_from_numpy(a, device="cpu")
    v_world = t["v_world"].requires_grad_()
    tlevels = [torch.from_numpy(x.copy()).requires_grad_() for x in levels]
    img, idx_out = render_mipmap_multiview(v_world, t["vi"], t["vt"], tlevels, {k: t[k] for k in CAMS}, H, W,
                                           device="cpu", index_img=torch.from_numpy(np.array(idx)))
    assert img.shape == (VIEWS, 4, H, W) and img.dtype == torch.float64
    img_j = np.asarray(img_j)
    assert np.abs(to_numpy(img) - img_j).max() <= 1e-10 * np.abs(img_j).max()
    got = torch.autograd.grad((img * torch.from_numpy(w)).sum(), [v_world, *tlevels])
    want = [grads_j[0], *grads_j[1]]
    for i, (g, wg) in enumerate(zip(got, want)):
        wg = np.asarray(wg)
        scale = np.abs(wg).max()
        assert np.abs(to_numpy(g) - wg).max() <= 1e-10 * max(scale, 1e-30), i
    assert np.abs(np.asarray(want[0])).max() > 0 and np.abs(np.asarray(want[1])).max() > 0
    # Its own rasterization gives JAX's index image here.
    _, idx_own = render_mipmap_multiview(v_world, t["vi"], t["vt"], tlevels, {k: t[k] for k in CAMS}, H, W,
                                         device="cpu")
    assert (to_numpy(idx_own) == np.asarray(idx)).mean() >= 0.999


def test_render_mipmap_multiview_validation():
    a, levels = _mipmap_inputs()
    t = scene_from_numpy(a, device="cpu")
    cams = {k: t[k] for k in CAMS}
    tlevels = [torch.from_numpy(x) for x in levels]
    with pytest.raises(ValueError, match="batch 1"):
        render_mipmap_multiview(t["v_world"].expand(2, -1, -1), t["vi"], t["vt"], tlevels, cams, H, W, device="cpu")
    with pytest.raises(ValueError, match="index_img"):
        render_mipmap_multiview(t["v_world"], t["vi"], t["vt"], tlevels, cams, H, W, device="cpu",
                                index_img=torch.zeros((VIEWS, H, W), dtype=torch.int64))


@pytest.mark.parametrize("mode", ["radial-tangential", "fisheye", "fisheye62"])
def test_render_mipmap_multiview_raises_for_a_lens(mode):
    """The uv Jacobian through a lens: the port's project_points_grad takes
    Fisheye62 (its product held to autograd in test_torch_lens_jvp.py, the
    step to the benchmark's reference in test_torch_fisheye62_views.py) and
    raises NotImplementedError for the other lenses, instead of pairing
    lens-projected positions with a pinhole Jacobian; JAX's raises for
    every lens."""
    a, levels = _mipmap_inputs()
    t = scene_from_numpy(a, device="cpu")
    coeff = inverse8_lens_arrays(mode, VIEWS).astype(a["campos"].dtype)
    cams = {**{k: t[k] for k in CAMS}, "distortion_mode": mode, "distortion_coeff": torch.from_numpy(coeff)}
    tlevels = [torch.from_numpy(x) for x in levels]
    if mode == "fisheye62":
        img, idx = render_mipmap_multiview(t["v_world"], t["vi"], t["vt"], tlevels, cams, H, W, device="cpu")
        assert img.shape == (VIEWS, 4, H, W) and bool(torch.isfinite(img).all()) and bool((idx != -1).any())
    else:
        with pytest.raises(NotImplementedError, match="distortion mode"):
            render_mipmap_multiview(t["v_world"], t["vi"], t["vt"], tlevels, cams, H, W, device="cpu")
    v = np.broadcast_to(a["v_world"], (VIEWS,) + a["v_world"].shape[1:])
    with pytest.raises(NotImplementedError, match="distortion mode"):
        jproj.project_points_grad(jnp.asarray(v), jnp.asarray(v), jnp.asarray(a["campos"]), jnp.asarray(a["camrot"]),
                                  jnp.asarray(a["focal"]), mode, jnp.asarray(coeff))


def test_render_mipmap_multiview_needs_pinhole_camera_parameters():
    a, levels = _mipmap_inputs()
    t = scene_from_numpy(a, device="cpu")
    k = torch.zeros((VIEWS, 3, 3), dtype=t["focal"].dtype)
    rt = torch.zeros((VIEWS, 3, 4), dtype=t["focal"].dtype)
    with pytest.raises(ValueError, match="campos, camrot and focal"):
        render_mipmap_multiview(t["v_world"], t["vi"], t["vt"], [torch.from_numpy(x) for x in levels],
                                {"K": k, "Rt": rt}, H, W, device="cpu")
