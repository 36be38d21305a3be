"""The reference of the mipmapped multi-view fitting step through a Fisheye62
lens (entry ``fisheye62``): the world vertices projected into every view by
DRTK's Fisheye62 model (six radial and two tangential coefficients, the
normalized radius clipped to [1e-8, fov] and the distorted point to
+-fov; a vertex beyond ``fov`` gets z = -1, so the rasterizer culls its
triangles), then per view rasterize, render, interpolate the uvs, and the
mipmapped shading of :mod:`reference.mipviews` with the uv Jacobian taken
through the lens: ``torch.func.jvp`` of the plain projection at each
pixel's interpolated surface point, in its two dp/dt directions (autograd,
not a second hand formula), inverted (zero where singular), zero outside
the mask; then ``cat([rgb * mask, mask])``, the edge-gradient estimator,
and ``mean((img - img_gt)**2)`` against the frame of the true mesh and
texture, made at set-up (:func:`prepare`). ``fov`` is the lens's own,
worked out here from its coefficients (:func:`fisheye62_fov`)."""

from __future__ import annotations

import numpy as np
import torch

from reference import exact
from reference.edge_grad import edge_grad_estimator
from reference.mipviews import _inv_2x2, _inv_2x2_or_zero, pyramid
from reference.raster import rasterize
from reference.shade import interpolate, mipmap, render

_F64 = torch.float64


def fisheye62_fov(coeff: np.ndarray) -> np.ndarray:
    """Per row of ``coeff`` [N, 8]: tan of the first angle theta > 0 at which
    theta_d = theta (1 + k0 theta^2 + ... + k5 theta^12) stops growing
    (pi/2 if it never does before), float32 [N, 1]."""
    out = []
    for k in np.asarray(coeff, np.float64)[:, :6]:
        # d theta_d / d theta = 1 + 3 k0 t^2 + 5 k1 t^4 + ... + 13 k5 t^12, lowest power first.
        deriv = np.zeros(13)
        deriv[0] = 1.0
        deriv[2::2] = (2 * np.arange(6) + 3) * k
        roots = np.polynomial.polynomial.polyroots(np.trim_zeros(deriv, "b"))
        real = roots.real[(np.abs(roots.imag) < 1e-5) & (roots.real > 0)]
        out.append(min(real.min(), np.pi / 2) if real.size else np.pi / 2)
    return np.tan(np.asarray(out)).astype(np.float32)[:, None]


def _signclamp(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z < 0, torch.minimum(z, z.new_full((), -1e-8)), torch.maximum(z, z.new_full((), 1e-8)))


def _camera(v, campos, camrot) -> torch.Tensor:
    return torch.einsum("nij,nvj->nvi", camrot, v - campos[:, None])


def project(v_cam, focal, princpt, coeff, fov) -> torch.Tensor:
    """DRTK's Fisheye62 projection (no lookup table) of camera-space points
    [N, V, 3] to pixels [N, V, 2]."""
    v_proj = v_cam[:, :, :2] / _signclamp(v_cam[:, :, 2:3])
    r = torch.minimum(torch.maximum(torch.sqrt((v_proj**2).sum(-1)), fov.new_full((), 1e-8)), fov)
    theta = torch.atan(r)
    # theta_d = theta + k0 theta^3 + ... + k5 theta^13, the powers and the sum in DRTK's order.
    t2 = theta * theta
    powers = [t2 * theta]
    for _ in range(5):
        powers.append(t2 * powers[-1])
    thetad = theta
    for i, t in enumerate(powers):
        thetad = thetad + coeff[:, i:i + 1] * t
    v_dist = v_proj * (thetad / _signclamp(r))[..., None]
    v_dist = torch.minimum(torch.maximum(v_dist, -fov[..., None]), fov[..., None])
    x, y = v_dist[..., 0], v_dist[..., 1]
    p0, p1 = coeff[:, 6:7], coeff[:, 7:8]
    r2 = x * x + y * y
    x_t = (2 * x * x + r2) * p0 + (2 * x * y) * p1
    y_t = (2 * x * y) * p0 + (2 * y * y + r2) * p1
    v_dist = v_dist + torch.stack([x_t, y_t], dim=-1)
    return torch.einsum("nij,nvj->nvi", focal, v_dist) + princpt[:, None]


def transform(v, campos, camrot, focal, princpt, coeff, fov) -> torch.Tensor:
    """World [N, V, 3] -> (x_pix, y_pix, z_cam), z_cam = -1 where the point's
    normalized radius exceeds ``fov``."""
    v_cam = _camera(v, campos, camrot)
    z = v_cam[:, :, 2:3]
    r = torch.sqrt(((v_cam[:, :, :2] / torch.where(z.abs() < 1e-8, _signclamp(z), z)) ** 2).sum(-1, keepdim=True))
    z = torch.where(r > fov[:, :, None], z.new_full((), -1.0), z)
    return torch.cat([project(v_cam, focal, princpt, coeff, fov), z], dim=-1)


def uv_jacobian(v_world, vt, vi, idx, bary, campos, camrot, focal, princpt, coeff, fov) -> torch.Tensor:
    """The screen-space uv Jacobian [N, H, W, 2, 2] through the lens in
    float64, returned in ``bary``'s dtype, not differentiated: each pixel's
    face's (dp/dt)^T, interpolated without blending across faces (as
    ``reference.mipviews.uv_jacobian``), pushed through ``torch.func.jvp``
    of :func:`project` at the pixel's interpolated world position."""
    with torch.no_grad():
        n = idx.shape[0]
        v = v_world.to(_F64).expand(n, -1, -1)
        t = vt.to(_F64).expand(n, -1, -1)
        bidx = torch.arange(n, device=idx.device)[:, None, None, None]
        corners = vi.long()[idx.long().clamp(min=0)]  # [N, H, W, 3]
        p, uv = v[bidx, corners], t[bidx, corners]  # [N, H, W, 3, 3], [N, H, W, 3, 2]
        dpdt_t = _inv_2x2(uv[..., 1:, :] - uv[..., :1, :]) @ (p[..., 1:, :] - p[..., :1, :])  # [.., 2, 3]
        b = bary.to(_F64).movedim(1, -1)  # [N, H, W, 3]
        dpdt_t = dpdt_t * b.sum(-1)[..., None, None]
        pos = (p * b[..., None]).sum(-2)  # [N, H, W, 3]
        h, w = idx.shape[1:]
        cams = [x.to(_F64) for x in (campos, camrot, focal, princpt, coeff, fov)]

        def pixels(points):
            return project(_camera(points, *cams[:2]), *cams[2:])

        pts = pos[..., None, :].expand(n, h, w, 2, 3).reshape(n, -1, 3)
        _, dp_pix = torch.func.jvp(pixels, (pts,), (dpdt_t.reshape(n, -1, 3),))
        jac = _inv_2x2_or_zero(dp_pix.reshape(n, h, w, 2, 2))
        return torch.where((idx != -1)[..., None, None], jac, torch.zeros_like(jac)).to(bary.dtype)


def image(s: dict, cfg: dict, q, v_key: str = "v_world", tex_key: str = "tex", probe: dict | None = None):
    """The views [views, 4, H, W] of the mesh ``s[v_key]`` through the lens,
    with the pyramid of ``s[tex_key]``, every float input, the levels, the
    Jacobian and the frames passed through ``q``. ``probe`` as for
    ``reference.mipviews.image``."""
    h, w = cfg["height"], cfg["width"]
    views = s["campos"].shape[0]
    coeff = q(s["distortion_coeff"])
    fov = q(torch.as_tensor(fisheye62_fov(s["distortion_coeff"].cpu().numpy()), device=coeff.device)
            .to(coeff.dtype))
    cams = [q(s[k]) for k in ("campos", "camrot", "focal", "princpt")] + [coeff, fov]
    vi = s["vi"]
    v_pix = transform(q(s[v_key]).expand(views, -1, -1), *cams)
    idx = rasterize(v_pix, vi, h, w)
    bary = render(v_pix, vi, idx)
    vt = q(s["vt"])
    uv = interpolate(vt.expand(views, -1, -1), vi, idx, bary).movedim(1, -1) * 2.0 - 1.0
    jac = q(uv_jacobian(q(s[v_key]), vt, vi, idx, bary, *cams))
    levels = [q(t).expand(views, -1, -1, -1) for t in pyramid(q(s[tex_key]), cfg["levels"])]
    rgb = mipmap(levels, uv, jac, cfg["max_aniso"], clip_grad=False)
    if probe is not None:
        probe.update(m1_uv=uv.detach(), m1_jac=jac, m1_levels=[tuple(t.shape[1:]) for t in levels])
        if rgb.requires_grad:
            rgb.register_hook(lambda g: probe.update(m1_cot=g.detach()))
    maskf = (idx != -1)[:, None].to(rgb.dtype)
    img = torch.cat([rgb * maskf, maskf], dim=1)
    return q(edge_grad_estimator(v_pix, vi, bary, img, idx, probe))


def prepare(arrays: dict, cfg: dict, device) -> dict:
    """The scene with its target: the views of the true mesh and texture."""
    s = {k: torch.as_tensor(a, device=device) for k, a in arrays.items()}
    with torch.no_grad():
        img_gt = image(s, cfg, exact, v_key="v_gt", tex_key="tex_gt")
    return {**arrays, "img_gt": img_gt}


def loss(s: dict, cfg: dict, q, probe: dict | None = None) -> torch.Tensor:
    return ((image(s, cfg, q, probe=probe) - s["img_gt"]) ** 2).mean()
