"""drtk_tpu_torch's camera transform and pinhole projection against
drtk_tpu's on the same numpy inputs (CPU).

Tolerances, and why: values in float32 to rtol 1e-6 / atol 1e-4 px (pixel
coordinates up to ~1e3; the two frameworks sum the 3x3 and 2x2 products in
another order, XLA with FMAs), in float64 to 1e-12. Gradients to the
vertices and every camera parameter against ``jax.vjp`` to 1e-5 of each
gradient's largest magnitude in float32 (1e-12 in float64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import drtk_tpu as dt  # noqa: E402
from drtk_tpu.utils.indexing import index as jax_index  # noqa: E402
from drtk_tpu.utils.projection import project_points as jax_project_points  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import scene_from_numpy, to_numpy  # noqa: E402
from drtk_tpu_torch.utils import index, project_points  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401


TOL = {np.float32: dict(rtol=1e-6, atol=1e-4), np.float64: dict(rtol=1e-12, atol=1e-12)}
GRAD_TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.randn(n, 3, 3))
    return q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]


def _cameras(n=3, num_v=40, seed=0, dtype=np.float32):
    """Random cameras around the origin and points mostly in front of them,
    some behind (z_cam < 0)."""
    rng = np.random.RandomState(seed)
    camrot = _rotations(rng, n)
    campos = rng.uniform(-1, 1, (n, 3))
    focal = np.zeros((n, 2, 2))
    focal[:, 0, 0] = rng.uniform(300, 600, n)
    focal[:, 1, 1] = rng.uniform(300, 600, n)
    focal[:, 0, 1] = rng.uniform(-5, 5, n)  # skew
    princpt = rng.uniform(100, 300, (n, 2))
    # Camera-space points, z in [-1, 6] away from 0, back to world space.
    v_cam = np.concatenate([rng.uniform(-1.5, 1.5, (n, num_v, 2)), rng.uniform(0.5, 6, (n, num_v, 1))], -1)
    v_cam[:, ::7, 2] *= -0.3
    v = np.einsum("nji,nvj->nvi", camrot, v_cam) + campos[:, None]
    cams = {"campos": campos, "camrot": camrot, "focal": focal, "princpt": princpt}
    return v.astype(dtype), {k: a.astype(dtype) for k, a in cams.items()}


def _k_rt(cams):
    n = cams["campos"].shape[0]
    K = np.zeros((n, 3, 3), cams["focal"].dtype)
    K[:, :2, :2] = cams["focal"]
    K[:, :2, 2] = cams["princpt"]
    K[:, 2, 2] = 1
    t = -np.einsum("nij,nj->ni", cams["camrot"], cams["campos"])
    Rt = np.concatenate([cams["camrot"], t[..., None]], -1).astype(K.dtype)
    return {"K": K, "Rt": Rt}


def _both(form, dtype):
    v, cams = _cameras(dtype=dtype)
    return v, (cams if form == "parts" else _k_rt(cams))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("form", ["parts", "K_Rt"])
def test_transform_matches_jax(form, dtype):
    v, cams = _both(form, dtype)
    want_pix, want_cam = dt.transform_with_v_cam(jnp.asarray(v), **{k: jnp.asarray(a) for k, a in cams.items()})
    t = scene_from_numpy({"v": v, **cams}, device="cpu")
    got_pix, got_cam = tt.transform_with_v_cam(t["v"], **{k: t[k] for k in cams})
    assert got_pix.dtype == t["v"].dtype and got_pix.shape == v.shape
    assert (to_numpy(got_cam)[..., 2] < 0).any()  # points behind the camera are projected too
    np.testing.assert_allclose(to_numpy(got_pix), np.asarray(want_pix), **TOL[dtype])
    np.testing.assert_allclose(to_numpy(got_cam), np.asarray(want_cam), **TOL[dtype])
    np.testing.assert_array_equal(to_numpy(tt.transform(t["v"], **{k: t[k] for k in cams})), to_numpy(got_pix))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("form", ["parts", "K_Rt"])
def test_transform_gradients_match_jax_vjp(form, dtype):
    v, cams = _both(form, dtype)
    names = ["v"] + list(cams)
    arrays = [v] + [cams[k] for k in cams]
    cot = np.random.RandomState(1).randn(*v.shape).astype(dtype)

    def jax_fn(*xs):
        return dt.transform(xs[0], **dict(zip(names[1:], xs[1:])))

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = tt.transform(ts[0], **dict(zip(names[1:], ts[1:])))
    got = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        assert np.abs(to_numpy(g) - w).max() <= GRAD_TOL[dtype] * scale, name


def test_points_at_z_zero_and_behind_the_camera():
    """_signclamp: z = 0 projects as z = +1e-8 and passes no gradient to z;
    a point behind the camera keeps its sign."""
    campos = np.zeros((1, 3), np.float32)
    camrot = np.eye(3, dtype=np.float32)[None]
    focal = np.diag([100.0, 120.0]).astype(np.float32)[None]
    princpt = np.array([[32.0, 24.0]], np.float32)
    v = np.array([[[0.5, -0.25, 0.0], [0.5, -0.25, -2.0], [0.5, -0.25, 2.0], [0.0, 0.0, 1e-9]]], np.float32)
    want = np.asarray(dt.transform(jnp.asarray(v), jnp.asarray(campos), jnp.asarray(camrot), jnp.asarray(focal),
                                   jnp.asarray(princpt)))
    tv = torch.from_numpy(v).requires_grad_()
    got = tt.transform(tv, torch.from_numpy(campos), torch.from_numpy(camrot), torch.from_numpy(focal),
                       torch.from_numpy(princpt))
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-6, atol=1e-4)
    assert to_numpy(got)[0, 1, 0] == pytest.approx(32.0 - 25.0) and to_numpy(got)[0, 0, 0] > 1e9
    got[..., :2].sum().backward()
    assert tv.grad[0, 0, 2] == 0 and tv.grad[0, 3, 2] == 0 and tv.grad[0, 1, 2] != 0


def test_per_batch_pinhole_modes():
    v, cams = _cameras(n=3)
    coeff = np.zeros((3, 4), np.float32)
    modes = ["pinhole", None, "pinhole"]
    jcams = {k: jnp.asarray(a) for k, a in cams.items()}
    want, _ = jax_project_points(jnp.asarray(v), **jcams, distortion_mode=modes, distortion_coeff=jnp.asarray(coeff))
    t = scene_from_numpy({"v": v, **cams}, device="cpu")
    got, _ = project_points(t["v"], **{k: t[k] for k in cams}, distortion_mode=modes,
                            distortion_coeff=torch.from_numpy(coeff))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6, atol=1e-4)
    plain, _ = project_points(t["v"], **{k: t[k] for k in cams})
    assert torch.equal(got, plain)


@pytest.mark.parametrize(
    "mode, exc",
    [
        ("orthographic", ValueError),
        (["pinhole", "fisheye62"], ValueError),  # a per-view list may not name Fisheye62, as in the JAX package
    ],
)
def test_distortion_modes_raise(mode, exc):
    """Unknown modes raise; each ported mode is held to the JAX package in
    tests/test_torch_projection.py."""
    v, cams = _cameras(n=3)
    t = scene_from_numpy({"v": v, **cams}, device="cpu")
    with pytest.raises(exc, match="invalid"):
        tt.transform(t["v"], **{k: t[k] for k in cams}, distortion_mode=mode, distortion_coeff=torch.zeros(3, 8))
    jcams = {k: jnp.asarray(a) for k, a in cams.items()}
    with pytest.raises(exc):
        dt.transform(jnp.asarray(v), **jcams, distortion_mode=mode, distortion_coeff=jnp.zeros((3, 8)))


def test_transform_requires_exactly_one_parametrization():
    v, cams = _cameras(n=1)
    t = scene_from_numpy({"v": v, **cams, **_k_rt(cams)}, device="cpu")
    with pytest.raises(ValueError, match="Rt or"):
        tt.transform(t["v"], t["campos"], t["camrot"], t["focal"], t["princpt"], Rt=t["Rt"])
    with pytest.raises(ValueError, match="K or"):
        tt.transform(t["v"], t["campos"], t["camrot"], t["focal"], t["princpt"], K=t["K"])
    with pytest.raises(ValueError, match="Rt or"):
        tt.transform(t["v"], campos=t["campos"], focal=t["focal"], princpt=t["princpt"])
    with pytest.raises(ValueError, match="coefficients"):
        tt.transform(t["v"], t["campos"], t["camrot"], t["focal"], t["princpt"], distortion_mode="pinhole")


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_index_matches_jax(dim):
    rng = np.random.RandomState(dim)
    x = rng.randn(4, 5, 6)
    idxs = rng.randint(0, x.shape[dim], (7, 3)).astype(np.int32)
    want = np.asarray(jax_index(jnp.asarray(x), jnp.asarray(idxs), dim))
    got = to_numpy(index(torch.from_numpy(x), torch.from_numpy(idxs), dim))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
