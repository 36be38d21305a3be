"""The port's multi-view inverse-rendering step against ``bench.py``'s
``bench_inverse8`` (CPU), at a small size: 2 views of 64x64, a 9x9-vertex
world grid (128 triangles), a 3x32x32 texture.

The bench's forward is rebuilt here from ``drtk_tpu`` calls, op for op, and
both sides run on JAX's own index image (the ``idx_fixed`` reasoning of
``bench._grad_case_textured``): a tie flipped by FMA rounding would move
gradient mass between faces, a difference the rasterizer's contract allows.
Image to 1e-5, loss to 1e-5 relative, gradients to the world vertices and
the texture to 1e-4 of their largest magnitude (XLA contracts FMAs on the
CPU, the port does not). Adam is compared on its own: its first update is
``lr * sign(g)``, so a 1e-12 gradient with opposite signs in the two
frameworks would move a parameter by a whole ``lr``. Both optimizers get
the same gradients, the port's state carried from optax's after two steps,
and one update agrees to 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

import drtk_tpu as dt  # noqa: E402
from drtk_tpu.ops.grid_sample import grid_sample as jax_grid_sample  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import adam_state_from_optax, scene_from_numpy, to_numpy  # noqa: E402
from drtk_tpu_torch.pipeline import INVERSE8_STAGES, inverse8_step, render_multiview  # noqa: E402
from drtk_tpu_torch.scenes import inverse8_scene_arrays, with_edge_flags  # noqa: E402
from tests.test_rasterize_pallas import _with_wire_flags  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401


H = W = 64
GN, VIEWS, TEX = 9, 2, 32
CAMS = ("campos", "camrot", "focal", "princpt")


def _jax_forward(s, v1, tex, idx=None):
    """``bench.bench_inverse8``'s ``forward``, with an optional fixed index
    image; returns (img, index_img)."""
    views = s["campos"].shape[0]
    v8 = jnp.broadcast_to(v1, (views,) + v1.shape[1:])
    v_pix = dt.transform(v8, *(s[k] for k in CAMS))
    index_img = dt.rasterize(v_pix, s["vi"], H, W) if idx is None else idx
    _, bary = dt.render(v_pix, s["vi"], index_img)
    vt_img = dt.interpolate(jnp.broadcast_to(s["vt"], (views,) + s["vt"].shape[1:]), s["vi"], index_img, bary)
    uv = jnp.moveaxis(vt_img, 1, -1) * 2.0 - 1.0
    rgb = jax_grid_sample(jnp.broadcast_to(tex, (views,) + tex.shape[1:]), uv, mode="bilinear", padding_mode="border")
    maskf = (index_img != -1)[:, None].astype(jnp.float32)
    img = jnp.concatenate([rgb * maskf, maskf], axis=1)
    return dt.edge_grad_estimator(v_pix=v_pix, vi=s["vi"], bary_img=bary, img=img, index_img=index_img), index_img


@pytest.fixture(scope="module")
def case():
    arrays = inverse8_scene_arrays(H, GN, VIEWS, seed=0, tex_size=TEX)
    s = {k: jnp.asarray(a) for k, a in arrays.items()}
    forward = jax.jit(lambda v, t, idx=None: _jax_forward(s, v, t, idx))
    img_gt, _ = forward(s["v_world"], s["tex_gt"])
    v0 = s["v_world"] + 0.02
    tex0 = jnp.full_like(s["tex_gt"], 0.5)
    img0, idx0 = forward(v0, tex0)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jnp.mean((forward(*p, idx0)[0] - img_gt) ** 2)))((v0, tex0))
    return {  # writable numpy copies
        "arrays": arrays, "img_gt": np.array(img_gt), "v0": np.array(v0), "tex0": np.array(tex0),
        "img0": np.array(img0), "idx0": np.array(idx0), "loss": float(loss),
        "grads": [np.array(g) for g in grads],
    }


def _port(case):
    t = scene_from_numpy(case["arrays"], device="cpu")
    cams = {k: t[k] for k in CAMS}
    params = tuple(torch.from_numpy(case[k].copy()).requires_grad_() for k in ("v0", "tex0"))
    return t, cams, params


def test_render_multiview_matches_bench_forward(case):
    t, cams, (v0, tex0) = _port(case)
    idx = torch.from_numpy(case["idx0"])
    assert 0.3 < (case["idx0"] >= 0).mean() < 1.0  # background and foreground in every run
    img, idx_out = render_multiview(v0, t["vi"], t["vt"], tex0, cams, H, W, device="cpu", index_img=idx)
    assert idx_out is idx and img.shape == (VIEWS, 4, H, W)
    np.testing.assert_allclose(to_numpy(img), case["img0"], rtol=0, atol=1e-5)
    # The port's own rasterization gives JAX's index image here.
    img_own, idx_own = render_multiview(v0, t["vi"], t["vt"], tex0, cams, H, W, device="cpu")
    np.testing.assert_array_equal(to_numpy(idx_own), case["idx0"])
    assert torch.equal(img_own, img)


def test_inverse8_step_gradients_match_bench(case):
    t, cams, params = _port(case)
    before = [p.detach().clone() for p in params]
    opt = torch.optim.Adam(params, lr=1e-3)
    loss, grads = inverse8_step(params, opt, t["vi"], t["vt"], cams, torch.from_numpy(case["img_gt"]), H, W,
                                device="cpu", index_img=torch.from_numpy(case["idx0"]))
    assert abs(float(loss) - case["loss"]) <= 1e-5 * case["loss"]
    for name, want in zip(("v_world", "tex"), case["grads"]):
        got = to_numpy(grads[name])
        assert got.shape == want.shape and np.abs(want).max() > 0
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
    # The update moved every parameter by at most lr (Adam's first step).
    for p, b in zip(params, before):
        step = (p.detach() - b).abs()
        assert bool((step <= 1e-3 * (1 + 1e-5)).all()) and bool((step > 0).any())


def test_adam_update_matches_optax_from_carried_state(case):
    rng = np.random.RandomState(3)
    p0 = (case["v0"], case["tex0"])
    opt = optax.adam(1e-3)
    params = tuple(jnp.asarray(p) for p in p0)
    state = opt.init(params)
    for _ in range(2):
        g = tuple(jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 1e-2) for p in p0)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
    adam_state = state[0]
    g3 = tuple(jnp.asarray(a) for a in case["grads"])
    updates, _ = opt.update(g3, state)
    want = optax.apply_updates(params, updates)

    tp = [torch.from_numpy(np.array(p)).requires_grad_() for p in params]
    topt = torch.optim.Adam(tp, lr=1e-3)
    adam_state_from_optax(topt, [np.asarray(m) for m in adam_state.mu], [np.asarray(m) for m in adam_state.nu],
                          np.asarray(adam_state.count))
    for p, g in zip(tp, g3):
        p.grad = torch.from_numpy(np.array(g))
    topt.step()
    for p, w in zip(tp, want):
        np.testing.assert_allclose(to_numpy(p), np.asarray(w), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="moments"):
        adam_state_from_optax(topt, [np.zeros(3), np.zeros(3)], [np.zeros(3), np.zeros(3)], 2)


def test_inverse8_steps_lower_the_loss(case):
    """A few steps of the fit on the port's own index images (rasterized
    every step): the loss falls, and the step returns its stage names."""
    t, cams, params = _port(case)
    opt = torch.optim.Adam(params, lr=1e-2)
    losses = [
        float(inverse8_step(params, opt, t["vi"], t["vt"], cams, torch.from_numpy(case["img_gt"]), H, W,
                            device="cpu")[0])
        for _ in range(4)
    ]
    assert losses[-1] < losses[0]
    assert INVERSE8_STAGES[0] == "transform" and INVERSE8_STAGES[-2:] == ("transform_bwd", "adam")
    with pytest.raises(ValueError, match="require gradients"):
        inverse8_step(tuple(p.detach() for p in params), opt, t["vi"], t["vt"], cams,
                      torch.from_numpy(case["img_gt"]), H, W, device="cpu")


def test_inverse8_scene_matches_bench_draws():
    s = inverse8_scene_arrays()
    assert s["v_world"].shape == (1, 81 * 81, 3) and s["vi"].shape == (12_800, 3)
    assert s["vt"].shape == (1, 81 * 81, 2) and s["tex_gt"].shape == (1, 3, 256, 256)
    assert s["campos"].shape == (8, 3) and s["focal"].shape == (8, 2, 2) and s["princpt"].shape == (8, 2)
    assert all(a.dtype == np.float32 for k, a in s.items() if k != "vi") and s["vi"].dtype == np.int32
    rng = np.random.RandomState(0)  # bench_inverse8's order: the z noise, then the texture
    z = 4.0 + 0.3 * rng.randn(81, 81)
    tex = rng.rand(1, 3, 256, 256).astype(np.float32)
    np.testing.assert_array_equal(s["v_world"][0, :, 2], z.reshape(-1).astype(np.float32))
    np.testing.assert_array_equal(s["tex_gt"], tex)
    np.testing.assert_array_equal(s["focal"][:, 0, 0], np.float32(1.9 * 512))
    np.testing.assert_array_equal(s["princpt"], np.tile(np.float32([256, 256]), (8, 1)))
    np.testing.assert_allclose(np.linalg.norm(s["campos"][:, :2], axis=-1), 0.25, rtol=1e-6)


@pytest.mark.parametrize("flags", [0x7, 0xF, 0x1])
def test_with_edge_flags_matches_the_jax_tests_helper(flags):
    vi = inverse8_scene_arrays(16, 5, 1)["vi"]
    np.testing.assert_array_equal(with_edge_flags(vi, flags), np.asarray(_with_wire_flags(vi, flags)))
    assert not np.shares_memory(with_edge_flags(vi, flags), vi)


def test_scene_from_numpy_takes_cameras():
    s = inverse8_scene_arrays(16, 5, 2)
    t = scene_from_numpy(s, device="cpu")
    assert set(t) == set(s) and t["camrot"].shape == (2, 3, 3)
    K = np.eye(3, dtype=np.float32)[None].repeat(2, 0)
    Rt = np.zeros((2, 3, 4), np.float32)
    assert scene_from_numpy({"K": K, "Rt": Rt}, device="cpu")["Rt"].shape == (2, 3, 4)
    with pytest.raises(ValueError, match="shape"):
        scene_from_numpy({"campos": s["campos"][0]}, device="cpu")
