"""Camera projection and lens distortion models (counterpart of
``drtk_tpu/utils/projection.py``).

Pinhole, OpenCV radial-tangential (4, 5 or 8 coefficients), OpenCV fisheye
and Fisheye62 (six radial and two tangential coefficients, with an optional
pixel-space lookup-table correction), the host-side numpy FOV estimators,
and the analytic Jacobian-vector product ``project_points_grad`` of the
pinhole and the Fisheye62 projections (the JAX package's has the pinhole
one only).
Differentiable through autograd, as the JAX package's are through its
autodiff. Clamps use ``torch.maximum``/``torch.minimum``, whose gradient
splits at a tie as JAX's ``clip`` does.

When ``fov`` is None, a distortion model estimates it from the coefficients
with ``np.roots`` on the host: the coefficients are copied to the host, which
waits for the device, as in the JAX package. Pass ``fov`` (computed once
with an estimator) to keep a training step off the host.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Set, Tuple, Union

import numpy as np
import torch

from drtk_tpu_torch import tracing

__all__ = [
    "DISTORTION_MODES",
    "estimate_fisheye62_fov",
    "estimate_fisheye_fov",
    "estimate_rt_fov",
    "project_fisheye_distort",
    "project_fisheye_distort_62",
    "project_pinhole",
    "project_pinhole_distort_rt",
    "project_points",
    "project_points_grad",
]

# The modes a per-batch list may name; a single mode may also be a Fisheye62 one.
DISTORTION_MODES: Set[Optional[str]] = {None, "pinhole", "radial-tangential", "fisheye"}
_FISHEYE62_MODES = {"fisheye62", "fisheye62_lut"}


def _invalid(mode) -> ValueError:
    return ValueError(f"project_points: invalid distortion mode {mode!r}; valid options: {DISTORTION_MODES}")


def _signclamp(z: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """z away from zero, keeping its sign (0 goes to +eps). ``maximum`` and
    ``minimum`` split the gradient at a tie, as JAX's do."""
    return torch.where(z < 0, torch.minimum(z, z.new_full((), -eps)), torch.maximum(z, z.new_full((), eps)))


def _clip(x: torch.Tensor, low, high) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, low), high)``, tensor or float bounds."""
    low = low if torch.is_tensor(low) else x.new_full((), low)
    return torch.minimum(torch.maximum(x, low), high)


def _normalized(v_cam: torch.Tensor) -> torch.Tensor:
    """Camera-space points over their sign-clamped depth: [N, V, 2]."""
    return v_cam[:, :, :2] / _signclamp(v_cam[:, :, 2:3])


def _to_pixels(v: torch.Tensor, focal: torch.Tensor, princpt: torch.Tensor) -> torch.Tensor:
    return torch.einsum("nij,nvj->nvi", focal, v) + princpt[:, None]


def project_pinhole(v_cam: torch.Tensor, focal: torch.Tensor, princpt: torch.Tensor) -> torch.Tensor:
    """Undistorted pinhole projection.

    v_cam: [N, V, 3]; focal: [N, 2, 2]; princpt: [N, 2] -> [N, V, 2].
    """
    return _to_pixels(_normalized(v_cam), focal, princpt)


def project_pinhole_distort_rt(
    v_cam: torch.Tensor,
    focal: torch.Tensor,
    princpt: torch.Tensor,
    D: torch.Tensor,
    fov: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """OpenCV radial-tangential distortion with 4, 5 or 8 coefficients
    ``D`` [N, K]; ``fov`` [N, 1] bounds the normalized radius (estimated
    with :func:`estimate_rt_fov` when None)."""
    if D.shape[1] not in (4, 5, 8):
        raise ValueError(f"project_pinhole_distort_rt: expected 4, 5 or 8 coefficients, got {D.shape[1]}")
    if fov is None:
        fov = estimate_rt_fov(D)
    v_proj = _normalized(v_cam)
    r2 = torch.minimum((v_proj**2).sum(-1), fov**2)
    v_clamped = _clip(v_proj, -fov[..., None], fov[..., None])

    R = 1 + D[:, 0:1] * r2 + D[:, 1:2] * r2**2
    if D.shape[1] == 5:
        R = R + D[:, 4:5] * r2**3
    if D.shape[1] == 8:
        R = R + D[:, 4:5] * r2**3
        R = R / (1 + D[:, 5:6] * r2 + D[:, 6:7] * r2**2 + D[:, 7:8] * r2**3)

    v_dist = v_proj * R[..., None]
    v_dist = v_dist + 2 * v_clamped[..., 0:1] * v_clamped[..., 1:2] * torch.stack((D[:, 2:3], D[:, 3:4]), dim=-1)
    v_dist = v_dist + r2[..., None] * torch.stack((D[:, 3:4], D[:, 2:3]), dim=-1)
    v_dist = v_dist + torch.stack(
        (2 * D[:, 3:4] * v_clamped[..., 0] ** 2, 2 * D[:, 2:3] * v_clamped[..., 1] ** 2), dim=-1
    )
    return _to_pixels(v_dist, focal, princpt)


def project_fisheye_distort(
    v_cam: torch.Tensor,
    focal: torch.Tensor,
    princpt: torch.Tensor,
    D: torch.Tensor,
    fov: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """OpenCV fisheye distortion, coefficients ``D`` [N, 4]; ``fov``
    [N, 1] as for :func:`project_pinhole_distort_rt` (estimated with
    :func:`estimate_fisheye_fov` when None)."""
    if fov is None:
        fov = estimate_fisheye_fov(D)
    v_proj = _normalized(v_cam)
    r = _clip(torch.sqrt((v_proj**2).sum(-1)), 1e-8, fov)
    theta = torch.atan(r)
    theta_d = theta * (
        1 + D[:, 0:1] * theta**2 + D[:, 1:2] * theta**4 + D[:, 2:3] * theta**6 + D[:, 3:4] * theta**8
    )
    v_dist = v_proj * (theta_d / _signclamp(r))[..., None]
    return _to_pixels(v_dist, focal, princpt)


def project_fisheye_distort_62(
    v_cam: torch.Tensor,
    focal: torch.Tensor,
    princpt: torch.Tensor,
    D: torch.Tensor,
    fov: Optional[torch.Tensor] = None,
    lut_vector_field: Optional[torch.Tensor] = None,
    lut_spacing: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fisheye62: six radial and two tangential coefficients ``D`` [N, 8],
    with an optional pixel-space correction ``lut_vector_field``
    [N, 2, Hl, Wl] sampled (bilinear, ``align_corners=True``, zero outside)
    at the pixel position over ``lut_spacing`` [N, 2]."""
    if D.shape[1] != 8:
        raise ValueError(f"project_fisheye_distort_62: Fisheye62 requires 8 distortion params, got {D.shape[1]}")
    if fov is None:
        # The 4-coefficient estimator, as in the JAX package, not estimate_fisheye62_fov.
        fov = estimate_fisheye_fov(D)
    v_proj = _normalized(v_cam)
    r = _clip(torch.sqrt((v_proj**2).sum(-1)), 1e-8, fov)
    theta = torch.atan(r)
    t2 = theta * theta
    k = [D[:, i : i + 1] for i in range(6)]
    p0, p1 = D[:, 6:7], D[:, 7:8]
    t3 = t2 * theta
    t5 = t2 * t3
    t7 = t2 * t5
    t9 = t2 * t7
    t11 = t2 * t9
    t13 = t2 * t11
    thetad = theta + k[0] * t3 + k[1] * t5 + k[2] * t7 + k[3] * t9 + k[4] * t11 + k[5] * t13

    v_dist = v_proj * (thetad / _signclamp(r))[..., None]
    v_dist = _clip(v_dist, -fov[..., None], fov[..., None])
    x_r = v_dist[:, :, 0]
    y_r = v_dist[:, :, 1]
    r_rad2 = x_r * x_r + y_r * y_r
    x_t = (2 * x_r * x_r + r_rad2) * p0 + (2 * x_r * y_r) * p1
    y_t = (2 * x_r * y_r) * p0 + (2 * y_r * y_r + r_rad2) * p1
    v_pix = _to_pixels(v_dist + torch.stack([x_t, y_t], dim=-1), focal, princpt)

    if lut_vector_field is not None:
        if lut_spacing is None:
            raise ValueError("project_fisheye_distort_62: lookup table spacing must be given with the vector field")
        from drtk_tpu_torch.ops.grid_sample import grid_sample

        npos = v_pix / lut_spacing[:, None, :]
        lut_h, lut_w = lut_vector_field.shape[2:4]
        # x over shape[2] and y over shape[3], as in the JAX package and the reference.
        nx = npos[..., 0] / (lut_h - 1) * 2.0 - 1.0
        ny = npos[..., 1] / (lut_w - 1) * 2.0 - 1.0
        grid = torch.stack([nx, ny], dim=-1)[:, None]  # [N, 1, V, 2]
        offset = grid_sample(lut_vector_field, grid, align_corners=True)[:, :, 0].movedim(1, -1)  # [N, V, 2]
        oob = (nx < -1) | (nx > 1) | (ny < -1) | (ny > 1)
        v_pix = v_pix + torch.where(oob[..., None], offset.new_zeros(()), offset)
    return v_pix


# ---------------------------------------------------------------------------
# FOV estimators: host-side numpy root finding, as in the JAX package.
# ---------------------------------------------------------------------------


def _coefs(D) -> Tuple[np.ndarray, torch.device]:
    """``D`` as a float64 host array, and the device its estimate goes to."""
    if torch.is_tensor(D):
        return D.detach().cpu().numpy().astype(np.float64), D.device
    return np.asarray(D, dtype=np.float64), torch.device("cpu")


def _odd_poly_derivative(coefs: np.ndarray, n_terms: int) -> np.ndarray:
    """Per row, the coefficients (highest power first) of the derivative of
    ``t + c0 t^3 + c1 t^5 + ...`` over its first ``n_terms`` coefficients."""
    zeros = np.zeros_like(coefs[:, 0])
    cols = []
    for i in reversed(range(n_terms)):
        cols += [(2 * i + 3) * coefs[:, i], zeros]
    return np.stack(cols + [np.ones_like(coefs[:, 0])], axis=-1)


def _smallest_positive_root(coef: np.ndarray) -> Optional[float]:
    roots = np.roots(coef)
    real = roots.real[abs(roots.imag) < 1e-5]
    pos = real[real > 0]
    return None if len(pos) == 0 else pos.min()


def estimate_rt_fov(D: torch.Tensor) -> torch.Tensor:
    """The smallest positive radius where the radial polynomial of
    radial-tangential ``D`` [N, K] may stop being monotonic (inf where it
    never does): [N, 1] float32 on ``D``'s device. Not differentiable."""
    coefs, dev = _coefs(D)
    fov = [_smallest_positive_root(coef) for coef in _odd_poly_derivative(coefs, 2)]
    fov = np.asarray([np.inf if f is None else f for f in fov], np.float32)
    return torch.from_numpy(fov[..., None]).to(dev)


def _solve_monotonic_fisheye_fov(poly: np.ndarray, dev: torch.device) -> torch.Tensor:
    fov = []
    for coef in poly:
        root = _smallest_positive_root(coef)
        fov.append(np.pi / 2 if root is None else min(root, np.pi / 2))
    return torch.from_numpy(np.tan(np.asarray(fov)).astype(np.float32)[..., None]).to(dev)


def estimate_fisheye_fov(D: torch.Tensor) -> torch.Tensor:
    """tan(theta) at the first point where the fisheye polynomial of ``D``
    (its first 4 coefficients) stops being monotonic, theta capped at pi/2:
    [N, 1] float32 on ``D``'s device. Not differentiable."""
    coefs, dev = _coefs(D)
    return _solve_monotonic_fisheye_fov(_odd_poly_derivative(coefs, 4), dev)


def estimate_fisheye62_fov(D: torch.Tensor) -> torch.Tensor:
    """As :func:`estimate_fisheye_fov`, over the six radial coefficients of
    Fisheye62."""
    coefs, dev = _coefs(D)
    if coefs.shape[-1] < 6:
        raise ValueError(f"estimate_fisheye62_fov: expected at least 6 coefficients, got {coefs.shape[-1]}")
    return _solve_monotonic_fisheye_fov(_odd_poly_derivative(coefs, 6), dev)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _project_one_mode(mode, v_cam, focal, princpt, coeff, fov, lut_vector_field=None, lut_spacing=None):
    if mode is None or mode == "pinhole":
        return project_pinhole(v_cam, focal, princpt)
    if mode == "radial-tangential":
        return project_pinhole_distort_rt(v_cam, focal, princpt, coeff, fov)
    if mode == "fisheye":
        return project_fisheye_distort(v_cam, focal, princpt, coeff, fov)
    if mode in _FISHEYE62_MODES:
        return project_fisheye_distort_62(v_cam, focal, princpt, coeff, fov, lut_vector_field, lut_spacing)
    raise _invalid(mode)


@functools.lru_cache(maxsize=64)
def _mode_rows(modes: tuple, device: torch.device) -> tuple:
    """Each distinct mode of a per-batch list (None read as "pinhole") with
    its batch rows as an index on ``device``: built once per list and
    device, so that a step copies nothing from the host."""
    names = tuple("pinhole" if m is None else m for m in modes)
    return tuple(
        (mode, torch.tensor([i for i, m in enumerate(names) if m == mode], dtype=torch.int64, device=device))
        for mode in dict.fromkeys(names)
    )


def project_points(
    v: torch.Tensor,
    campos: torch.Tensor,
    camrot: torch.Tensor,
    focal: torch.Tensor,
    princpt: torch.Tensor,
    distortion_mode: Optional[Union[List[str], str]] = None,
    distortion_coeff: Optional[torch.Tensor] = None,
    fov: Optional[torch.Tensor] = None,
    lut_vector_field: Optional[torch.Tensor] = None,
    lut_spacing: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project world-space vertices to pixel coordinates.

    Args:
        v: [N, V, 3] world-space vertices.
        campos: [N, 3] camera positions; camrot: [N, 3, 3] world-to-camera
            rotations; focal: [N, 2, 2]; princpt: [N, 2].
        distortion_mode: None, "pinhole", "radial-tangential", "fisheye",
            "fisheye62" or "fisheye62_lut"; or a per-batch list of modes
            from :data:`DISTORTION_MODES` (a list of one distinct mode is
            that mode). Other modes raise ValueError.
        distortion_coeff: [N, K] coefficients, required whenever
            ``distortion_mode`` is given.
        fov: optional [N, 1] bound on the normalized radius; estimated on
            the host from the coefficients when None. With a Fisheye62
            mode and ``fov`` given, vertices outside the FOV get
            ``z = -1``, so the rasterizer culls the triangles touching them.
        lut_vector_field, lut_spacing: Fisheye62's pixel-space correction.

    Returns:
        ``(v_pix, v_cam)``, each [N, V, 3]: ``v_pix`` holds (x_pix, y_pix,
        z_cam), ``v_cam`` the camera-space positions.
    """
    if distortion_mode is not None and distortion_coeff is None:
        raise ValueError("project_points: missing distortion coefficients")
    v_cam = torch.einsum("nij,nvj->nvi", camrot, v - campos[:, None])

    if isinstance(distortion_mode, (list, tuple)):
        modes = set(distortion_mode)
        if len(modes) <= 1:
            distortion_mode = next(iter(modes), None)
    if isinstance(distortion_mode, (list, tuple)):
        if not set(distortion_mode) <= DISTORTION_MODES:
            raise _invalid(distortion_mode)
        # Each mode on its batch rows, chosen on the host from the list.
        v_pix = v_cam.new_zeros(v_cam.shape[:2] + (2,))
        for mode, rows in _mode_rows(tuple(distortion_mode), v_cam.device):
            v_pix = v_pix.index_copy(0, rows, _project_one_mode(
                mode, v_cam[rows], focal[rows], princpt[rows], distortion_coeff[rows],
                None if fov is None else fov[rows],
            ))
    else:
        v_pix = _project_one_mode(
            distortion_mode, v_cam, focal, princpt, distortion_coeff, fov, lut_vector_field, lut_spacing
        )

    z_cam = v_cam[:, :, 2:3]
    # A list naming Fisheye62 has raised above, so the rule meets a single mode only.
    if fov is not None and isinstance(distortion_mode, str) and distortion_mode in _FISHEYE62_MODES:
        z_safe = torch.where(z_cam.abs() < 1e-8, _signclamp(z_cam), z_cam)
        r_raw = torch.sqrt(((v_cam[:, :, :2] / z_safe) ** 2).sum(-1, keepdim=True))
        z_cam = torch.where(r_raw > fov.reshape(-1, 1, 1), z_cam.new_full((), -1.0), z_cam)
    return torch.cat([v_pix[:, :, 0:2], z_cam], dim=-1), v_cam


def project_points_grad(
    v_grad: torch.Tensor,
    v: torch.Tensor,
    campos: torch.Tensor,
    camrot: torch.Tensor,
    focal: torch.Tensor,
    distortion_mode: Optional[Union[List[str], str]] = None,
    distortion_coeff: Optional[torch.Tensor] = None,
    fov: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The projection's Jacobian-vector product ``d project_points(v)[..., :2]
    / dv @ v_grad`` [N, V, 2], analytically, for the undistorted path
    (``distortion_mode`` None, as in the JAX package) and for "fisheye62"
    (coefficients ``distortion_coeff`` [N, 8]; ``fov`` [N, 1] as for
    :func:`project_points`, estimated as its forward estimates it when None).
    The Fisheye62 product is that of autograd wherever the projection is
    differentiable; where a clip of the depth (1e-8), of the normalized
    radius (1e-8 and ``fov``) or of the distorted point (``fov``) holds, the
    clipped quantity's derivative is 0, and 1/2 at the bound itself, as
    autograd takes it. Other modes, per-view lists and "fisheye62_lut"
    raise NotImplementedError. With a tracer on, the Fisheye62 product is
    the span ``lens_jvp``."""
    return _project_points_grad(v_grad, v, campos, camrot, focal, distortion_mode, distortion_coeff, fov)[0]


def _project_points_grad(v_grad, v, campos, camrot, focal, distortion_mode, distortion_coeff, fov, cut=False):
    """:func:`project_points_grad`, and with ``cut`` (Fisheye62 only) the
    points [N, V] whose product a clip changed; None otherwise."""
    if distortion_mode is not None and distortion_coeff is None:
        raise ValueError("project_points_grad: missing distortion coefficients")
    if distortion_mode == "fisheye62":
        with tracing.span("lens_jvp"):
            return _fisheye62_grad(v_grad, v, campos, camrot, focal, distortion_coeff, fov, cut)
    if distortion_mode is not None:
        raise NotImplementedError(f"project_points_grad: distortion mode {distortion_mode} not implemented")
    v_cam_grad = torch.einsum("nij,nvj->nvi", camrot, v_grad)
    v_cam = torch.einsum("nij,nvj->nvi", camrot, v - campos[:, None])
    z = _signclamp(v_cam[:, :, 2:3])
    z_grad = v_cam_grad[:, :, 2:3]
    v_proj_grad = (v_cam_grad[:, :, 0:2] * z - v_cam[:, :, 0:2] * z_grad) / z**2
    return torch.einsum("nij,nvj->nvi", focal, v_proj_grad), None


def _slope(x: torch.Tensor, low, high=None) -> torch.Tensor:
    """``d clip(x, low, high) / dx`` as autograd takes it through ``maximum``
    and ``minimum``: 1 inside, 0 outside, 1/2 at a bound (no upper bound
    when ``high`` is None)."""
    out = torch.sign(x - low) + 1
    return out * 0.5 if high is None else out * (torch.sign(high - x) + 1) * 0.25


def _fisheye62_grad(v_grad, v, campos, camrot, focal, D, fov, cut):
    """The Fisheye62 branch of :func:`_project_points_grad`: the forward of
    :func:`project_fisheye_distort_62` (no lookup table) differentiated by
    hand, each clip's derivative from :func:`_slope`."""
    if D.shape[1] != 8:
        raise ValueError(f"project_points_grad: Fisheye62 requires 8 distortion params, got {D.shape[1]}")
    if fov is None:
        # The 4-coefficient estimator, as the forward takes it.
        fov = estimate_fisheye_fov(D)
    v_cam_grad = torch.einsum("nij,nvj->nvi", camrot, v_grad)
    v_cam = torch.einsum("nij,nvj->nvi", camrot, v - campos[:, None])
    z_cam = v_cam[:, :, 2:3]
    z = _signclamp(z_cam)
    # _signclamp is a clip of |z| at 1e-8 from below.
    z_slope = _slope(z_cam.abs(), 1e-8)
    v_proj = v_cam[:, :, :2] / z
    v_proj_grad = (v_cam_grad[:, :, :2] - v_proj * (v_cam_grad[:, :, 2:3] * z_slope)) / z

    r_raw = torch.sqrt((v_proj**2).sum(-1))
    r = _clip(r_raw, 1e-8, fov)
    r_slope = _slope(r_raw, 1e-8, fov)
    r_grad = (v_proj * v_proj_grad).sum(-1) / r * r_slope
    theta = torch.atan(r)
    t2 = theta * theta
    k = [D[:, i : i + 1] for i in range(6)]
    # theta_d = theta (1 + k0 t^2 + ... + k5 t^12) and d theta_d / d theta, by Horner.
    poly = k[5]
    dpoly = 13 * k[5]
    for i in range(4, -1, -1):
        poly = k[i] + t2 * poly
        dpoly = (2 * i + 3) * k[i] + t2 * dpoly
    scale = theta * (1 + t2 * poly) / r
    scale_grad = ((1 + t2 * dpoly) / (1 + r * r) - scale) * r_grad / r
    v_dist = v_proj * scale[..., None]
    v_dist_grad = v_proj_grad * scale[..., None] + v_proj * scale_grad[..., None]
    bound = fov[..., None]
    d_slope = _slope(v_dist, -bound, bound)
    v_dist = _clip(v_dist, -bound, bound)
    v_dist_grad = v_dist_grad * d_slope

    # The tangential terms: x_t = (3x^2 + y^2) p0 + 2xy p1, y_t = 2xy p0 + (x^2 + 3y^2) p1.
    x, y = v_dist[..., 0], v_dist[..., 1]
    dx, dy = v_dist_grad[..., 0], v_dist_grad[..., 1]
    xdx, ydy, cross = x * dx, y * dy, x * dy + y * dx
    p0, p1 = D[:, 6:7], D[:, 7:8]
    t_grad = torch.stack([p0 * (3 * xdx + ydy) + p1 * cross, p0 * cross + p1 * (xdx + 3 * ydy)], dim=-1)
    out = torch.einsum("nij,nvj->nvi", focal, v_dist_grad + 2 * t_grad)
    if not cut:
        return out, None
    return out, (z_slope[..., 0] < 1) | (r_slope < 1) | (d_slope < 1).any(-1)
