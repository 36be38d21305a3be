"""The reference of the 4K avatar step (entry ``avatar4k``): the frame in
the configuration's row bands (each band rasterized, rendered and its uvs
interpolated as rows of the frame, the uv Jacobian by finite differences
within the band, mipmapped shading), the edge-gradient estimator over the
frame, the MSI background upsampled under the uncovered pixels,
``mean(img**2)``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.edge_grad import edge_grad_estimator
from reference.raster import rasterize
from reference.shade import interpolate, mipmap, msi, render


def background(ray_o, ray_d, msi_tex, h: int) -> torch.Tensor:
    bh = math.isqrt(ray_o.shape[0])
    bg = msi(ray_o, ray_d, msi_tex, sub_step_count=2)
    bg_img = bg[:, :3].reshape(1, bh, bh, 3).movedim(-1, 1)
    return F.interpolate(bg_img, size=(h, h), mode="bilinear", align_corners=False, antialias=False)


def band(v, vi, vt, levels, y0: int, hb: int, h: int, cfg: dict):
    idx = rasterize(v, vi, hb, h, y_offset=y0, full_height=h)
    bary = render(v, vi, idx, y_offset=y0)
    uv = interpolate(vt, vi, idx, bary, y_offset=y0, full_height=h).movedim(1, -1) * 2.0 - 1.0
    uv_sg = uv.detach()
    dx = F.pad(uv_sg[:, :, 1:] - uv_sg[:, :, :-1], (0, 0, 0, 1))
    dy = F.pad(uv_sg[:, 1:] - uv_sg[:, :-1], (0, 0, 0, 0, 0, 1))
    rgb = mipmap(levels, uv, torch.stack([dx, dy], dim=-2) * 0.5, cfg["max_aniso"], clip_grad=True)
    maskf = (idx != -1)[:, None].to(torch.float32)
    return rgb * maskf, maskf, bary, idx


def loss(s: dict, cfg: dict, q, probe: dict | None = None) -> torch.Tensor:
    h, n_bands = cfg["height"], cfg["bands"]
    hb = h // n_bands
    v, vt, vi = q(s["v"]), q(s["vt"]), s["vi"]
    levels = [q(s[f"level{i}"]) for i in range(cfg["levels"])]
    bg = background(s["ray_o"], s["ray_d"], q(s["msi_tex"]), h)
    parts = [band(v, vi, vt, levels, y0, hb, h, cfg) for y0 in range(0, h, hb)]
    fg, maskf, bary, idx = (torch.cat(x, dim=-2) for x in zip(*parts))
    del parts
    fg = edge_grad_estimator(v, vi, bary, fg, idx, probe)
    img = q(fg + bg * (1.0 - maskf))
    return (img**2).mean()
