"""The reference of the multi-view fitting step (entry ``inverse8``): the
pinhole projection of the world vertices into every view, then per view
rasterize, render, interpolate the uvs, bilinear border sampling of the
texture, ``cat([rgb * mask, mask])``, the edge-gradient estimator, and
``mean((img - img_gt)**2)``; the target ``img_gt`` is the frame of the
true mesh and texture, made at set-up (:func:`prepare`)."""

from __future__ import annotations

import torch

from reference import exact
from reference.edge_grad import edge_grad_estimator
from reference.raster import rasterize
from reference.shade import bilinear, interpolate, render


def transform(v, campos, camrot, focal, princpt) -> torch.Tensor:
    """World [N, V, 3] -> (x_pix, y_pix, z_cam): the camera's rotation about
    its position, the depth clamped away from 0 by 1e-8 (keeping its sign)
    for the division, the focal matrix and the principal point."""
    v_cam = torch.einsum("nij,nvj->nvi", camrot, v - campos[:, None])
    z = v_cam[:, :, 2:3]
    z_safe = torch.where(z < 0, torch.minimum(z, z.new_full((), -1e-8)), torch.maximum(z, z.new_full((), 1e-8)))
    xy = torch.einsum("nij,nvj->nvi", focal, v_cam[:, :, :2] / z_safe) + princpt[:, None]
    return torch.cat([xy, z], dim=-1)


def image(s: dict, cfg: dict, q, v_key: str = "v_world", tex_key: str = "tex", probe: dict | None = None):
    """The views [views, 4, H, W] of the mesh ``s[v_key]`` with texture
    ``s[tex_key]``, every float input and the frames passed through ``q``."""
    h, w = cfg["height"], cfg["width"]
    views = s["campos"].shape[0]
    cams = [q(s[k]) for k in ("campos", "camrot", "focal", "princpt")]
    vi = s["vi"]
    v_pix = transform(q(s[v_key]).expand(views, -1, -1), *cams)
    idx = rasterize(v_pix, vi, h, w)
    bary = render(v_pix, vi, idx)
    uv = interpolate(q(s["vt"]).expand(views, -1, -1), vi, idx, bary).movedim(1, -1) * 2.0 - 1.0
    tex = q(s[tex_key])
    maskf = (idx != -1)[:, None].to(tex.dtype)
    rgb = bilinear(tex.expand(views, -1, -1, -1), uv)
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
