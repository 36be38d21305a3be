"""The reference of the mipmapped multi-view fitting step (entry
``mipviews``): inverse8's views (the pinhole projection of the world
vertices, then per view rasterize, render, interpolate the uvs), shaded as
DRTK's rendering tutorial shades: a pyramid of 2x2 means rebuilt from the
texture, the analytic screen-space uv Jacobian (:func:`uv_jacobian`,
written out here from DRTK's definition) driving mipmapped anisotropic
bilinear sampling with border padding; then ``cat([rgb * mask, mask])``,
the edge-gradient estimator, and ``mean((img - img_gt)**2)`` against the
frame of the true mesh and texture, made at set-up (:func:`prepare`)."""

from __future__ import annotations

import torch

from reference import exact
from reference.edge_grad import edge_grad_estimator
from reference.inverse8 import transform
from reference.raster import rasterize
from reference.shade import interpolate, mipmap, render

_F64 = torch.float64


def pyramid(tex: torch.Tensor, count: int) -> list:
    """``count`` levels of ``tex`` [N, C, H, W], each the 2x2 mean of the one
    before, as ``examples/04_rendering_meshes.py`` builds them."""
    levels = [tex]
    for _ in range(count - 1):
        t = levels[-1]
        levels.append((t[..., ::2, ::2] + t[..., 1::2, ::2] + t[..., ::2, 1::2] + t[..., 1::2, 1::2]) / 4.0)
    return levels


def _inv_2x2(m: torch.Tensor) -> torch.Tensor:
    """Batched 2x2 inverse: the adjugate over the determinant."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj / (a * d - b * c)[..., None, None]


def _inv_2x2_or_zero(m: torch.Tensor) -> torch.Tensor:
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    return torch.where((det == 0)[..., None, None], torch.zeros_like(m), _inv_2x2(m))


def uv_jacobian(v_world, vt, vi, idx, bary, campos, camrot, focal) -> torch.Tensor:
    """DRTK's screen-space uv Jacobian [N, H, W, 2, 2] (rows d/dx, d/dy of
    (u, v)) in float64, returned in ``bary``'s dtype, not differentiated:
    each pixel's face's (dp/dt)^T, interpolated without blending across
    faces (the face's value times the pixel's barycentric sum), pushed
    through the pinhole projection's Jacobian at the pixel's interpolated
    world position, inverted (zero where singular), zero outside the
    mask."""
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
        rot = camrot.to(_F64)[:, None, None]  # [N, 1, 1, 3, 3]
        v_cam = (rot @ (pos - campos.to(_F64)[:, None, None])[..., None])[..., 0]  # [N, H, W, 3]
        d_cam = dpdt_t @ rot.transpose(-1, -2)  # [N, H, W, 2, 3]: each row turned into the camera
        z = v_cam[..., 2:3]
        z = torch.where(z < 0, torch.clamp(z, max=-1e-8), torch.clamp(z, min=1e-8))[..., None, :]
        d_proj = (d_cam[..., :2] * z - v_cam[..., None, :2] * d_cam[..., 2:3]) / z**2  # [N, H, W, 2, 2]
        dp_pix_dt_t = d_proj @ focal.to(_F64)[:, None, None].transpose(-1, -2)
        jac = _inv_2x2_or_zero(dp_pix_dt_t)
        return torch.where((idx != -1)[..., None, None], jac, torch.zeros_like(jac)).to(bary.dtype)


def image(s: dict, cfg: dict, q, v_key: str = "v_world", tex_key: str = "tex", probe: dict | None = None):
    """The views [views, 4, H, W] of the mesh ``s[v_key]`` with the pyramid
    of ``s[tex_key]``, every float input, the levels, the Jacobian and the
    frames passed through ``q``. ``probe``, if a dict, receives M1's inputs
    (``m1_uv``, ``m1_jac``, ``m1_levels``: the levels' shapes) and, in the
    backward, its cotangent (``m1_cot``)."""
    h, w = cfg["height"], cfg["width"]
    views = s["campos"].shape[0]
    cams = [q(s[k]) for k in ("campos", "camrot", "focal", "princpt")]
    vi = s["vi"]
    v_pix = transform(q(s[v_key]).expand(views, -1, -1), *cams)
    idx = rasterize(v_pix, vi, h, w)
    bary = render(v_pix, vi, idx)
    vt = q(s["vt"])
    uv = interpolate(vt.expand(views, -1, -1), vi, idx, bary).movedim(1, -1) * 2.0 - 1.0
    jac = q(uv_jacobian(q(s[v_key]), vt, vi, idx, bary, *cams[:3]))
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
