"""``project_points_grad`` through a Fisheye62 lens (CPU): the analytic
Jacobian-vector product against ``torch.func.jvp`` of the port's own
``project_points`` (which ``test_torch_projection.py`` holds to the JAX
package; the JAX package has no lens Jacobian to compare with).

The points: random cameras (view 0 the identity at the origin, so that
camera-space points reach it unrounded), and per view points in front of
the lens, near its axis (the radius below the 1e-8 clip), beyond ``fov``,
behind the camera and within 1e-8 of its plane; a lens with growing
coefficients and a small ``fov`` sends distorted points past ``fov`` (that
clip). Tolerances: each point's product to 1e-10 of its own magnitude in
float64 (the two sides evaluate the same polynomials in another order), to
1e-4 in float32 (its high powers of theta amplify the rounding, as the
projection gradients of ``test_torch_projection.py`` are held).
"""

import numpy as np
import pytest
import torch

from drtk_tpu_torch import tracing
from drtk_tpu_torch.scenes import INVERSE8_LENSES, inverse8_lens_arrays
from drtk_tpu_torch.utils import projection as tproj
from tests.test_torch_kernels import _one_torch_thread  # noqa: F401

TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# Growing coefficients: theta_d passes tan(theta) below FAST_FOV.
FAST_LENS, FAST_FOV = (0.5, 0.2, 0.0, 0.0, 0.0, 0.0, 1e-3, -1e-3), 0.6


def _points(seed, dtype, n=3, per=400):
    """World points [n, 5 * per, 3], tangents, cameras: view 0 the identity
    at the origin, the others random; per view, points drawn in camera space
    in front of the lens, near the axis, beyond tan 1.4, behind the camera
    and at |z| below 1e-8, each group ``per`` points. The near-axis and
    near-plane groups only in view 0: through a rotation their coordinates
    of ~1e-8 are rounding residues, and at a radius of ~1e8 the product's
    two radial terms cancel to float32's last digits, on both sides."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=torch.float64)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    z = rand(n, per, 1) * 2.5 + 0.5
    groups = [
        torch.cat([(rand(n, per, 2) * 3 - 1.5) * z, z], -1),
        torch.cat([randn(n, per, 2) * 1e-10 * z, z], -1),
        torch.cat([(rand(n, per, 2) * 2 + 1.4) * z * torch.sign(randn(n, per, 2)), z], -1),
        torch.cat([randn(n, per, 2), -z], -1),
        torch.cat([randn(n, per, 2), (rand(n, per, 1) * 2 - 1) * 1e-8], -1),
    ]
    v_cam = torch.cat(groups, 1)
    v_cam[1:, per:2 * per], v_cam[1:, 4 * per:] = groups[0][1:], groups[0][1:]
    camrot = torch.linalg.qr(randn(n, 3, 3))[0]
    camrot[0] = torch.eye(3, dtype=torch.float64)
    campos = randn(n, 3) * 0.3
    campos[0] = 0
    v = campos[:, None] + torch.einsum("nji,nvj->nvi", camrot, v_cam)
    focal = torch.diag_embed(rand(n, 2) * 1000 + 500) + torch.tensor([[0.0, 3.0], [0.0, 0.0]], dtype=torch.float64)
    princpt = rand(n, 2) * 100
    cams = {"campos": campos, "camrot": camrot, "focal": focal, "princpt": princpt}
    return v.to(dtype), randn(*v.shape).to(dtype), {k: c.to(dtype) for k, c in cams.items()}


def _autograd(v, v_grad, cams, coeff, fov):
    def xy(x):
        return tproj.project_points(x, **cams, distortion_mode="fisheye62", distortion_coeff=coeff, fov=fov)[0][..., :2]

    return torch.func.jvp(xy, (v,), (v_grad,))[1]


def _regimes(v, cams, coeff, fov):
    """Per point, which clip holds in the forward: the depth's, the radius's
    at 1e-8 and at ``fov``, the distorted point's (any coordinate)."""
    _, v_cam = tproj.project_points(v, **cams)
    z = v_cam[..., 2:3]
    v_proj = v_cam[..., :2] / tproj._signclamp(z)
    r_raw = torch.sqrt((v_proj**2).sum(-1))
    r = r_raw.clamp(min=1e-8).minimum(fov)
    theta = torch.atan(r)
    thetad = theta + sum(coeff[:, i:i + 1] * theta ** (2 * i + 3) for i in range(6))
    v_dist = v_proj * (thetad / r)[..., None]
    return {"depth": z[..., 0].abs() < 1e-8, "axis": r_raw < 1e-8, "fov": r_raw > fov,
            "distorted": (v_dist.abs() > fov[..., None]).any(-1)}


def _gap(got, want):
    """Each point's largest gap over its own magnitude."""
    got, want = got.double(), want.double()
    scale = torch.maximum(got.abs().amax(-1), want.abs().amax(-1)).clamp(min=1e-300)
    return float(((got - want).abs().amax(-1) / scale).max())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fisheye62_jvp_matches_autograd(dtype, seed):
    """The repo's lens with the estimator's fov: every clip of the radius
    and the depth occurs, the products agree."""
    v, v_grad, cams = _points(seed, dtype)
    coeff = torch.from_numpy(inverse8_lens_arrays("fisheye62", 3, seed)).to(dtype)
    fov = tproj.estimate_fisheye62_fov(coeff).to(dtype)
    regimes = _regimes(v, cams, coeff, fov)
    for name in ("depth", "axis", "fov"):
        assert bool(regimes[name].any()), name
    assert bool((v[..., 2] < 0).any())
    got = tproj.project_points_grad(v_grad, v, cams["campos"], cams["camrot"], cams["focal"], "fisheye62", coeff, fov)
    want = _autograd(v, v_grad, cams, coeff, fov)
    assert torch.isfinite(want).all()
    assert _gap(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fisheye62_jvp_at_the_distorted_points_clip(dtype):
    """A lens whose theta_d outgrows a small fov: distorted points clipped at
    +-fov, their product zero along the clipped coordinate."""
    v, v_grad, cams = _points(2, dtype)
    coeff = torch.tensor([FAST_LENS] * 3, dtype=dtype)
    fov = torch.full((3, 1), FAST_FOV, dtype=dtype)
    regimes = _regimes(v, cams, coeff, fov)
    assert bool((regimes["distorted"] & ~regimes["fov"] & ~regimes["depth"]).any())
    got = tproj.project_points_grad(v_grad, v, cams["campos"], cams["camrot"], cams["focal"], "fisheye62", coeff, fov)
    assert _gap(got, _autograd(v, v_grad, cams, coeff, fov)) <= TOL[dtype]


def test_clip_slopes_are_autograds_at_the_bounds():
    """The derivative of a clip that the product takes, at points inside,
    outside and exactly at each bound: autograd's through ``maximum`` and
    ``minimum`` (1/2 at a bound)."""
    x = torch.tensor([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], dtype=torch.float64, requires_grad=True)
    (want,) = torch.autograd.grad(tproj._clip(x, -1.0, torch.tensor(1.0, dtype=torch.float64)).sum(), [x])
    assert torch.equal(tproj._slope(x.detach(), -1.0, 1.0), want)
    (want,) = torch.autograd.grad(torch.maximum(x, x.new_full((), 0.5)).sum(), [x])
    assert torch.equal(tproj._slope(x.detach(), 0.5), want)


def test_clipped_points_are_flagged():
    """The points the counter ``lens_jvp_clipped`` reads: those where a clip
    holds, and no others."""
    v, v_grad, cams = _points(3, torch.float64)
    coeff = torch.tensor([FAST_LENS] * 3, dtype=torch.float64)
    fov = torch.full((3, 1), FAST_FOV, dtype=torch.float64)
    regimes = _regimes(v, cams, coeff, fov)
    got, cut = tproj._project_points_grad(v_grad, v, cams["campos"], cams["camrot"], cams["focal"], "fisheye62", coeff,
                                          fov, cut=True)
    assert torch.equal(got, tproj.project_points_grad(v_grad, v, cams["campos"], cams["camrot"], cams["focal"],
                                                      "fisheye62", coeff, fov))
    want = regimes["depth"] | regimes["axis"] | regimes["fov"] | regimes["distorted"]
    assert torch.equal(cut, want) and bool(want.any()) and bool((~want).any())


def test_fov_none_is_the_forwards_estimate():
    """Without ``fov`` the product takes what the forward takes: the
    4-coefficient fisheye estimator (the reference's quirk)."""
    v, v_grad, cams = _points(4, torch.float32)
    coeff = torch.from_numpy(inverse8_lens_arrays("fisheye62", 3, 4))
    args = (v_grad, v, cams["campos"], cams["camrot"], cams["focal"], "fisheye62", coeff)
    fov = tproj.estimate_fisheye_fov(coeff)
    got = tproj.project_points_grad(*args)
    assert torch.equal(got, tproj.project_points_grad(*args, fov))
    assert not torch.equal(fov, tproj.estimate_fisheye62_fov(coeff))
    assert _gap(got, _autograd(v, v_grad, cams, coeff, fov)) <= TOL[torch.float32]


@pytest.mark.parametrize("mode", ["radial-tangential", "fisheye", "fisheye62_lut", "list"])
def test_other_lenses_raise(mode):
    v, v_grad, cams = _points(5, torch.float32, n=2, per=4)
    coeff = torch.zeros(2, 8)
    if mode == "list":
        mode = ["fisheye62", "fisheye62"]
    with pytest.raises(NotImplementedError, match="distortion mode"):
        tproj.project_points_grad(v_grad, v, cams["campos"], cams["camrot"], cams["focal"], mode, coeff)


def test_fisheye62_validation():
    v, v_grad, cams = _points(6, torch.float32, n=2, per=4)
    args = (v_grad, v, cams["campos"], cams["camrot"], cams["focal"], "fisheye62")
    with pytest.raises(ValueError, match="missing distortion coefficients"):
        tproj.project_points_grad(*args)
    with pytest.raises(ValueError, match="8 distortion params"):
        tproj.project_points_grad(*args, torch.zeros(2, 6))


def test_lens_jvp_span_only_with_a_lens():
    """With a tracer on, the Fisheye62 product is the span ``lens_jvp``; the
    pinhole product records none."""
    v, v_grad, cams = _points(7, torch.float32, n=2, per=4)
    coeff = torch.tensor([INVERSE8_LENSES["fisheye62"]] * 2)
    pin = (v_grad, v, cams["campos"], cams["camrot"], cams["focal"])
    with tracing.Tracer() as tracer:
        tproj.project_points_grad(*pin)
        tproj.project_points_grad(*pin, "fisheye62", coeff)
    assert [sp["name"] for sp in tracer.snapshot()["spans"]] == ["lens_jvp"]
