"""drtk_tpu_torch's lens distortion models, FOV estimators and projection
Jacobian against drtk_tpu's on the same numpy inputs (CPU).

Tolerances, and why: projected values to 1e-5 of their largest magnitude
(pixel coordinates up to ~1e3; the two frameworks order the sums of the
camera products differently, XLA with FMAs); gradients to the vertices, the
cameras, the coefficients (and the LUT) to 1e-4 of each gradient's largest
magnitude, the distortion polynomials' high powers amplifying the rounding;
in float64 1e-12 and 1e-10. The FOV estimators run the same numpy root
finding on the same coefficients: to 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import drtk_tpu as dt  # noqa: E402
from drtk_tpu.utils import projection as jproj  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from drtk_tpu_torch.scenes import INVERSE8_LENSES, inverse8_lens_arrays  # noqa: E402
from drtk_tpu_torch.utils import projection as tproj  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401
from tests.test_torch_transform import _cameras  # noqa: E402

CAMS = ("campos", "camrot", "focal", "princpt")
VAL_TOL = {np.float32: 1e-5, np.float64: 1e-12}
GRAD_TOL = {np.float32: 1e-4, np.float64: 1e-10}

# (mode, number of coefficients, base coefficients)
MODELS = {
    "rt4": ("radial-tangential", (-0.30, 0.02, 1e-3, -1e-3)),
    "rt5": ("radial-tangential", INVERSE8_LENSES["radial-tangential"]),
    "rt8": ("radial-tangential", (-0.30, 0.02, 1e-3, -1e-3, 0.0, 0.05, -0.01, 0.002)),
    "fisheye": ("fisheye", INVERSE8_LENSES["fisheye"]),
    "fisheye62": ("fisheye62", INVERSE8_LENSES["fisheye62"]),
}


def _coeff(base, n, seed, dtype):
    rng = np.random.RandomState(seed)
    base = np.asarray(base, np.float64)
    return (base + 0.01 * rng.randn(n, base.size)).astype(dtype)


def _lut(n, dtype):
    """A 2 x 8 x 10 offset field and a spacing that puts some of the test
    points outside it."""
    rng = np.random.RandomState(7)
    return rng.uniform(-2, 2, (n, 2, 8, 10)).astype(dtype), np.tile(np.array([[90.0, 70.0]], dtype), (n, 1))


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, what
    assert np.abs(to_numpy(got) - want).max() <= tol * scale, what


def _case(model, fov, dtype, n=3):
    """Inputs of one projection: vertices, cameras, the mode, coefficients,
    fov (computed with the JAX package's estimator when asked for) and, for
    fisheye62_lut, the LUT."""
    v, cams = _cameras(n=n, dtype=dtype)
    kw = {}
    if model == "mixed":
        mode = ["pinhole", "radial-tangential", "fisheye"]
        coeff = inverse8_lens_arrays(mode, n).astype(dtype)
        if fov == "given":
            kw["fov"] = np.concatenate([
                np.full((1, 1), 3.0), np.asarray(jproj.estimate_rt_fov(coeff[1:2])),
                np.asarray(jproj.estimate_fisheye_fov(coeff[2:3]))]).astype(dtype)
    else:
        lut = model == "fisheye62_lut"
        mode, base = MODELS["fisheye62" if lut else model]
        mode = "fisheye62_lut" if lut else mode
        coeff = _coeff(base, n, 1, dtype)
        if fov == "given":
            est = {"radial-tangential": jproj.estimate_rt_fov, "fisheye": jproj.estimate_fisheye_fov}
            kw["fov"] = np.asarray(est.get(mode, jproj.estimate_fisheye62_fov)(coeff)).astype(dtype)
            kw["fov"][0] = 1.2  # inside the points' reach: the clamps and the outside-FOV rule act
        if lut:
            kw["lut_vector_field"], kw["lut_spacing"] = _lut(n, dtype)
    return v, cams, mode, coeff, kw


def _fov_as_estimated(mode, coeff):
    """The fov that the JAX package's models estimate when none is given:
    per model (per row of a list), and for Fisheye62 with the 4-coefficient
    fisheye estimator, as there."""
    if isinstance(mode, list):
        return np.concatenate([_fov_as_estimated(m, coeff[i : i + 1]) for i, m in enumerate(mode)])
    if mode == "pinhole":
        return np.ones((coeff.shape[0], 1), np.float32)
    est = jproj.estimate_rt_fov if mode == "radial-tangential" else jproj.estimate_fisheye_fov
    return np.asarray(est(coeff))


def _jax_project(v, cams, mode, coeff, kw):
    j = {k: jnp.asarray(a) for k, a in {**cams, **kw}.items()}
    return jproj.project_points(jnp.asarray(v), distortion_mode=mode, distortion_coeff=jnp.asarray(coeff), **j)


def _torch_project(v, cams, mode, coeff, kw):
    t = {k: torch.from_numpy(np.array(a)) for k, a in {**cams, **kw}.items()}
    return tproj.project_points(torch.from_numpy(v), distortion_mode=mode, distortion_coeff=torch.from_numpy(coeff),
                                **t)


@pytest.mark.parametrize("fov, dtype", [("given", np.float32), ("estimated", np.float32), ("given", np.float64)])
@pytest.mark.parametrize("model", ["rt4", "rt5", "rt8", "fisheye", "fisheye62", "fisheye62_lut", "mixed"])
def test_project_points_matches_jax(model, fov, dtype):
    case = _case(model, fov, dtype)
    want_pix, want_cam = _jax_project(*case)
    got_pix, got_cam = _torch_project(*case)
    assert got_pix.dtype == torch.from_numpy(case[0]).dtype and tuple(got_pix.shape) == case[0].shape
    _close(got_pix, want_pix, VAL_TOL[dtype], "v_pix")
    _close(got_cam, want_cam, VAL_TOL[dtype], "v_cam")
    culled = (to_numpy(got_pix)[..., 2] == -1) & (to_numpy(got_cam)[..., 2] != -1)
    assert culled.any() == (fov == "given" and model.startswith("fisheye62"))


@pytest.mark.parametrize("fov", ["given", "estimated"])
@pytest.mark.parametrize("model", ["rt5", "rt8", "fisheye", "fisheye62", "fisheye62_lut", "mixed"])
def test_projection_gradients_match_jax_vjp(model, fov):
    """The VJP of transform to the vertices, every camera parameter and the
    coefficients (and fisheye62's LUT), against ``jax.vjp``."""
    dtype = np.float32
    v, cams, mode, coeff, kw = _case(model, fov, dtype)
    lut = kw.pop("lut_vector_field", None)
    spacing = kw.pop("lut_spacing", None)
    names = ["v", *CAMS, "distortion_coeff"] + (["lut_vector_field"] if lut is not None else [])
    arrays = [v, *(cams[k] for k in CAMS), coeff] + ([lut] if lut is not None else [])
    extra = {} if lut is None else {"lut_spacing": spacing}
    cot = np.random.RandomState(3).randn(*v.shape).astype(dtype)
    jax_kw = dict(kw)
    if fov == "estimated":
        # JAX cannot differentiate its models in D when they estimate fov
        # themselves (the estimator reads D on the host): it gets the same
        # estimate as a constant, which is what fov=None means there. The
        # outside-FOV rule then applies on its side only; it sets z, so z
        # takes no cotangent.
        jax_kw["fov"] = _fov_as_estimated(mode, coeff)
        cot[..., 2] = 0.0

    def jax_fn(*xs):
        return dt.transform_with_v_cam(xs[0], **dict(zip(names[1:], xs[1:])), distortion_mode=mode,
                                       **{k: jnp.asarray(a) for k, a in {**jax_kw, **extra}.items()})[0]

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = tt.transform_with_v_cam(ts[0], **dict(zip(names[1:], ts[1:])), distortion_mode=mode,
                                  **{k: torch.from_numpy(a) for k, a in {**kw, **extra}.items()})[0]
    got = torch.autograd.grad(out, ts, torch.from_numpy(cot), allow_unused=True)
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if not np.abs(w).max() > 0:  # the pinhole row of a list takes no coefficient
            assert g is None or not bool(g.any()), name
            continue
        _close(g, w, GRAD_TOL[dtype], name)


@pytest.mark.parametrize(
    "mode", ["radial-tangential", "fisheye", "fisheye62", ["pinhole", "fisheye", "pinhole"]],
)
def test_transform_takes_every_distortion_mode(mode):
    """transform with each mode that raised NotImplementedError before the
    distortion models were ported, the coefficients from the inverse8 lens
    set, against drtk_tpu.transform."""
    v, cams = _cameras(n=3)
    coeff = inverse8_lens_arrays(mode, 3)
    want = dt.transform(jnp.asarray(v), **{k: jnp.asarray(a) for k, a in cams.items()}, distortion_mode=mode,
                        distortion_coeff=jnp.asarray(coeff))
    got = tt.transform(torch.from_numpy(v), **{k: torch.from_numpy(a) for k, a in cams.items()},
                       distortion_mode=mode, distortion_coeff=torch.from_numpy(coeff))
    _close(got, want, VAL_TOL[np.float32], str(mode))


def test_outside_fov_rule():
    """Fisheye62 with fov given: exactly the vertices whose undistorted
    radius exceeds the fov get z = -1; not without fov, nor for fisheye."""
    n = 2
    cams = {"campos": np.zeros((n, 3), np.float32), "camrot": np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
            "focal": np.tile(np.diag([100.0, 100.0]).astype(np.float32), (n, 1, 1)),
            "princpt": np.full((n, 2), 50.0, np.float32)}
    r = np.array([0.1, 0.5, 0.9, 1.1, 1.5, 3.0], np.float32)
    ang = np.linspace(0, 2 * np.pi, r.size, endpoint=False)
    z = np.array([2.0, 1.0, 3.0, 0.5, 2.0, 1.0], np.float32)
    v = np.stack([r * np.cos(ang) * z, r * np.sin(ang) * z, z], -1)[None].repeat(n, 0).astype(np.float32)
    coeff = inverse8_lens_arrays("fisheye62", n)
    fov = np.array([[1.0], [2.0]], np.float32)
    outside = r[None] > fov
    for mode, f, expect in (("fisheye62", fov, outside), ("fisheye62", None, np.zeros_like(outside)),
                            ("fisheye", fov, np.zeros_like(outside))):
        kw = {} if f is None else {"fov": f}
        c = coeff if mode == "fisheye62" else coeff[:, :4]
        got, _ = _torch_project(v, cams, mode, c, kw)
        want, _ = _jax_project(v, cams, mode, c, kw)
        z_got = to_numpy(got)[..., 2]
        np.testing.assert_array_equal(z_got == -1, expect)
        np.testing.assert_array_equal(z_got, np.asarray(want)[..., 2])


@pytest.mark.parametrize("estimator", ["estimate_rt_fov", "estimate_fisheye_fov", "estimate_fisheye62_fov"])
def test_fov_estimators_match_jax(estimator):
    """Coefficient rows with and without a turning point in reach (inf, or
    the pi/2 cap, where there is none); numpy and torch inputs."""
    rng = np.random.RandomState(0)
    coeff = rng.uniform(-0.5, 0.5, (12, 8)).astype(np.float32)
    coeff[0] = 0.0
    coeff[1, :6] = np.abs(coeff[1, :6])  # monotonic everywhere
    want = np.asarray(getattr(jproj, estimator)(coeff))
    for arg in (coeff, torch.from_numpy(coeff)):
        got = getattr(tproj, estimator)(arg)
        assert got.dtype == torch.float32 and tuple(got.shape) == (12, 1) and not got.requires_grad
        np.testing.assert_allclose(to_numpy(got), want, rtol=1e-6)
    assert np.isinf(want).any() if estimator == "estimate_rt_fov" else (want > 1e15).any()
    assert (np.isfinite(want) & (want < 1e15)).any()


def test_inverse8_lenses_are_monotonic_over_the_view():
    """The chip path passes fov: each lens's estimate lies well beyond the
    inverse8 view's corner radius (~0.37) and the mesh's reach (~0.45), so
    no vertex is clamped or culled."""
    for mode, est in (("fisheye62", tproj.estimate_fisheye62_fov), ("fisheye", tproj.estimate_fisheye_fov),
                      ("radial-tangential", tproj.estimate_rt_fov)):
        fov = to_numpy(est(inverse8_lens_arrays(mode, 8)))
        assert (fov > (1.5 if "fisheye" in mode else 1.1)).all(), mode


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_project_points_grad_matches_jax(dtype):
    v, cams = _cameras(n=2, dtype=dtype)
    v_grad = np.random.RandomState(2).randn(*v.shape).astype(dtype)
    args = (v_grad, v, cams["campos"], cams["camrot"], cams["focal"])
    want = jproj.project_points_grad(*(jnp.asarray(a) for a in args))
    got = tproj.project_points_grad(*(torch.from_numpy(a) for a in args))
    _close(got, want, VAL_TOL[dtype], "jvp")
    # ...and it is the Jacobian-vector product of project_points.
    t = {k: torch.from_numpy(a) for k, a in cams.items()}
    _, jvp = torch.func.jvp(lambda x: tproj.project_points(x, **t)[0][..., :2], (torch.from_numpy(v),),
                            (torch.from_numpy(v_grad),))
    _close(got, to_numpy(jvp), 1e-4 if dtype == np.float32 else 1e-10, "autograd jvp")
    with pytest.raises(NotImplementedError):
        tproj.project_points_grad(*(torch.from_numpy(a) for a in args), "fisheye", torch.zeros(2, 4))


def test_distortion_modes_and_validation():
    assert tproj.DISTORTION_MODES == jproj.DISTORTION_MODES
    v, cams = _cameras(n=2)
    t = {k: torch.from_numpy(a) for k, a in cams.items()}
    with pytest.raises(ValueError, match="8 distortion params"):
        tproj.project_points(torch.from_numpy(v), **t, distortion_mode="fisheye62", distortion_coeff=torch.zeros(2, 4))
    with pytest.raises(ValueError, match="4, 5 or 8"):
        tproj.project_points(torch.from_numpy(v), **t, distortion_mode="radial-tangential",
                             distortion_coeff=torch.zeros(2, 6))
    with pytest.raises(ValueError, match="spacing"):
        tproj.project_points(torch.from_numpy(v), **t, distortion_mode="fisheye62_lut",
                             distortion_coeff=torch.zeros(2, 8), lut_vector_field=torch.zeros(2, 2, 4, 4))
