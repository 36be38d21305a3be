"""The port's 4K avatar-fit step (``drtk_tpu_torch.avatar4k_step``) against
``bench.py:bench_avatar4k``'s step (CPU), at a small size: a 128x128 frame
of a 17x17-vertex grid (512 triangles) in 4 bands, a pyramid of 3 x 64^2 to
3 x 8^2, an MSI texture of 8 x 4 x 64 x 128 on a 32x32 ray grid.

The bench's ``loss_fn`` is rebuilt here from ``drtk_tpu``'s public
functions, op for op, each band taking its rows of the JAX package's index
image, which the port's step takes too (``index_img``): a tie flipped by
rounding would move gradient between faces, a difference the rasterizer's
contract allows. The reference runs in float64. Tolerances:

* the port in float64: the loss to 1e-10 relative, the gradients to the
  vertices, the levels and the MSI texture to 1e-10 of their largest
  magnitude (they agree to ~1e-14);
* the port in float32, the step as it runs on the card: the loss to 1e-5
  relative, the gradients to the levels and the MSI texture to 1e-4 of
  their largest magnitude. Its gradient to the vertices is not held to the
  reference: on this grid, pixel centres lie on triangle edges and taps on
  texel edges to within a float32 rounding, where edge_grad's coverage test
  and the bilinear weights' derivative jump, so one rounding moves it by
  several percent (jitted JAX in float32, which contracts FMAs, against the
  same in float64: the same size of difference).

Adam is compared on its own, as in
tests/test_torch_inverse8.py: both optimizers get the same gradients and
state, and one update agrees to 1e-6. ``F.interpolate``'s bilinear
upsample, which stands in for ``jax.image.resize``, agrees with it to 1e-6
at the step's 16x ratio.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

import drtk_tpu as dt  # noqa: E402
from drtk_tpu.ops.mipmap_grid_sample import mipmap_grid_sample as jax_mipmap  # noqa: E402
from drtk_tpu.ops.msi import msi as jax_msi  # noqa: E402
from drtk_tpu.parallel.banded import edge_grad_estimator_banded as jax_edge_grad_banded  # noqa: E402
from drtk_tpu.parallel.banded import map_row_bands as jax_map_row_bands  # noqa: E402
from drtk_tpu_torch.interop import adam_state_from_optax, scene_from_numpy, to_numpy  # noqa: E402
from drtk_tpu_torch.pipeline import AVATAR4K_STAGES, avatar4k_loss, avatar4k_step  # noqa: E402
from drtk_tpu_torch.scenes import avatar4k_scene_arrays  # noqa: E402
from tests.test_torch_backward import _assert_grad_close  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401

H, GN, BH, N_BANDS = 128, 17, 32, 4


def _arrays():
    """avatar4k_scene_arrays at the small size, its levels cut to 64^2 ..
    8^2 (the top-left corner of each drawn level)."""
    a = avatar4k_scene_arrays(H, GN, BH)
    a["levels"] = [lvl[:, :, : 64 >> i, : 64 >> i].copy() for i, lvl in enumerate(a["levels"])]
    return a


def _jax_loss(a, h, n_bands, index_img):
    """``bench.bench_avatar4k``'s ``loss_fn`` (``bench.py:401-432``), each
    band taking its rows of ``index_img`` in place of its rasterization."""
    w = h
    hb = h // n_bands
    vi, vt = jnp.asarray(a["vi"]), jnp.asarray(a["vt"])
    ray_o, ray_d = jnp.asarray(a["ray_o"]), jnp.asarray(a["ray_d"])
    bh = bw = BH

    def loss_fn(params):
        v, levels, msi_tex = params

        def band(y0):
            idx = jax.lax.dynamic_slice_in_dim(index_img, y0, hb, axis=1)
            _, bary = dt.render(v, vi, idx, y_offset=y0)
            vt_img = dt.interpolate(vt, vi, idx, bary, y_offset=y0, full_height=h)
            uv = jnp.moveaxis(vt_img, 1, -1) * 2.0 - 1.0
            uv_sg = jax.lax.stop_gradient(uv)
            dx = jnp.pad(uv_sg[:, :, 1:] - uv_sg[:, :, :-1], ((0, 0), (0, 0), (0, 1), (0, 0)))
            dy = jnp.pad(uv_sg[:, 1:] - uv_sg[:, :-1], ((0, 0), (0, 1), (0, 0), (0, 0)))
            vt_dxdy = jnp.stack([dx, dy], axis=-2) * 0.5
            rgb = jax_mipmap(levels, uv, vt_dxdy, max_aniso=2, mode="bilinear", padding_mode="border", clip_grad=True)
            maskf = (idx != -1)[:, None].astype(jnp.float32)
            return rgb * maskf, maskf, bary, idx

        fg, maskf, bary, idx = jax_map_row_bands(band, h, n_bands)
        fg = jax_edge_grad_banded(v_pix=v, vi=vi, bary_img=bary, img=fg, index_img=idx, n_bands=n_bands)
        bg = jax_msi(ray_o, ray_d, msi_tex, sub_step_count=2)
        bg_img = jnp.moveaxis(bg[:, :3].reshape(1, bh, bw, 3), -1, 1)
        bg_img = jax.image.resize(bg_img, (1, 3, h, w), "bilinear")
        img = fg + bg_img * (1.0 - maskf)
        return jnp.mean(img**2)

    return loss_fn


def _as(a, dtype):
    """The scene arrays with every float array in ``dtype``."""
    out = {k: (x.astype(dtype) if k != "vi" and k != "levels" else x) for k, x in a.items()}
    out["levels"] = [lvl.astype(dtype) for lvl in a["levels"]]
    return out


@pytest.fixture(scope="module")
def case():
    a = _arrays()
    a64 = _as(a, np.float64)
    idx = jax.jit(dt.rasterize, static_argnums=(2, 3))(jnp.asarray(a["v"]), jnp.asarray(a["vi"]), H, H)
    params = (jnp.asarray(a64["v"]), [jnp.asarray(x) for x in a64["levels"]], jnp.asarray(a64["msi_tex"]))
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss(a64, H, N_BANDS, idx)))(params)
    assert grads[0].dtype == jnp.float64
    return {"arrays": a, "loss": float(loss), "grads": jax.tree_util.tree_map(np.array, grads), "idx": np.array(idx)}


def _port_params(a):
    s = scene_from_numpy(a, device="cpu")
    params = (s["v"].requires_grad_(), [x.requires_grad_() for x in s["levels"]], s["msi_tex"].requires_grad_())
    return s, params


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_avatar4k_step_matches_the_bench(case, dtype):
    s, params = _port_params(_as(case["arrays"], dtype))
    v0 = params[0].detach().clone()
    opt = torch.optim.Adam([params[0], *params[1], params[2]], lr=1e-3)
    loss, grads = avatar4k_step(params, opt, s["vi"], s["vt"], s["ray_o"], s["ray_d"], H, N_BANDS, device="cpu",
                                index_img=torch.from_numpy(case["idx"]))
    f64 = dtype == np.float64
    assert loss.dtype == (torch.float64 if f64 else torch.float32)
    assert abs(loss.item() - case["loss"]) <= (1e-10 if f64 else 1e-5) * abs(case["loss"])
    want_v, want_levels, want_msi = case["grads"]
    assert np.abs(want_v).max() > 0 and np.abs(want_msi).max() > 0
    rel = 1e-10 if f64 else 1e-4
    if f64:
        _assert_grad_close(to_numpy(grads["v"]), want_v, rel)
    for got, want in zip(grads["levels"], want_levels):
        assert np.abs(want).max() > 0
        _assert_grad_close(to_numpy(got), want, rel)
    _assert_grad_close(to_numpy(grads["msi_tex"]), want_msi, rel)
    assert not torch.equal(params[0].detach(), v0)  # the update was applied


def test_avatar4k_remat_changes_no_result(case):
    """Without the band recompute the loss is the same and the gradients
    agree to 1e-4. (Another band count is another function: the finite
    differences of the uv image are zero on each band's last row.)"""
    a = case["arrays"]
    results = []
    for remat in (True, False):
        s, params = _port_params(a)
        loss = avatar4k_loss(params, s["vi"], s["vt"], s["ray_o"], s["ray_d"], H, N_BANDS, remat, device="cpu")
        results.append((loss, torch.autograd.grad(loss, [params[0], *params[1], params[2]])))
    (loss0, grads0), (loss1, grads1) = results
    assert loss1.item() == loss0.item()
    for got, want in zip(grads1, grads0):
        _assert_grad_close(to_numpy(got), to_numpy(want))


def test_avatar4k_adam_matches_optax(case):
    """One update of torch.optim.Adam(lr=1e-3) against optax.adam(1e-3) from
    the same state (two optax steps in) with the same gradients."""
    a = case["arrays"]
    grads = jax.tree_util.tree_map(lambda g: g.astype(np.float32), case["grads"])
    params = (a["v"], a["levels"], a["msi_tex"])
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt = optax.adam(1e-3)
    state = opt.init(jparams)
    for _ in range(2):
        _, state = opt.update(jax.tree_util.tree_map(jnp.asarray, grads), state)
    updates, _ = opt.update(jax.tree_util.tree_map(jnp.asarray, grads), state)
    want = jax.tree_util.tree_leaves(optax.apply_updates(jparams, updates))

    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in jax.tree_util.tree_leaves(params)]
    t_opt = torch.optim.Adam(leaves, lr=1e-3)
    mu, nu = (jax.tree_util.tree_leaves(x) for x in (state[0].mu, state[0].nu))
    adam_state_from_optax(t_opt, mu, nu, state[0].count)
    for p, g in zip(leaves, jax.tree_util.tree_leaves(grads)):
        p.grad = torch.from_numpy(np.array(g))
    t_opt.step()
    for p, w in zip(leaves, want):
        np.testing.assert_allclose(to_numpy(p), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_avatar4k_step_validates_and_marks_once():
    a = _arrays()
    s, params = _port_params(a)
    opt = torch.optim.Adam([params[0], *params[1], params[2]], lr=1e-3)
    args = (s["vi"], s["vt"], s["ray_o"], s["ray_d"], H)
    with pytest.raises(ValueError, match="stage_times needs a CUDA device"):
        avatar4k_step(params, opt, *args, device="cpu", stage_times=[])
    with pytest.raises(ValueError, match="stage_times needs a CUDA device"):
        avatar4k_loss(params, *args, device="cpu", stage_times=[])
    with pytest.raises(ValueError, match="square grid"):
        avatar4k_loss(params, s["vi"], s["vt"], s["ray_o"][:-1], s["ray_d"][:-1], H, device="cpu")
    frozen = (params[0].detach(), params[1], params[2])
    with pytest.raises(ValueError, match="require gradients"):
        avatar4k_step(frozen, opt, *args, device="cpu")
    assert AVATAR4K_STAGES == ("forward", "backward", "adam")


def test_bilinear_upsample_matches_jax_resize():
    """``F.interpolate(bilinear, align_corners=False, antialias=False)``
    against ``jax.image.resize(..., "bilinear")`` at the step's 16x ratio
    (256 -> 4096 there; 8 -> 128 here) and at 4x on a non-square image:
    JAX renormalises its weights at the border, which equals the clamp."""
    rng = np.random.RandomState(3)
    for shape, size in (((1, 3, 8, 8), (128, 128)), ((2, 2, 5, 7), (20, 28))):
        x = rng.rand(*shape).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), shape[:2] + size, "bilinear"))
        got = torch.nn.functional.interpolate(torch.from_numpy(x), size=size, mode="bilinear", align_corners=False,
                                              antialias=False)
        np.testing.assert_allclose(to_numpy(got), want, rtol=1e-6, atol=1e-6)
