"""Plain render, interpolate, texture sampling, mipmapped sampling and the
MSI background of the reference, differentiable through torch autograd.

``render`` and ``interpolate`` are frozen copies of ``render_ref`` and
``interpolate_ref`` (``drtk_tpu_torch/ops/render.py``,
``drtk_tpu_torch/ops/interpolate.py``): per-corner element gathers in
float64. Bilinear sampling is ``torch.nn.functional.grid_sample``
(``align_corners=False``), the op DRTK itself shades with. The mipmapped
sampling follows the conventions of ``drtk_tpu_torch/ops/
mipmap_grid_sample.py`` (its module docstring) with one ``grid_sample`` per
level and tap; the MSI ray marcher follows ``drtk_tpu_torch/ops/msi.py``
with direct texel gathers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.raster import broadcast_vi

_F64 = torch.float64


def _eps64(x):
    return torch.where(x < 0, torch.clamp(x, max=-1e-16), torch.clamp(x, min=1e-16))


def _corners(table, vi, index_img):
    """[N, V, C] per-vertex values -> three [N, H, W, C], the corners of each
    pixel's face (face 0's at background)."""
    n = table.shape[0]
    bidx = torch.arange(n, device=table.device)[:, None, None]
    vi_img = vi.long()[bidx, index_img.long().clamp(min=0)]
    return [table[bidx, vi_img[..., k]] for k in range(3)]


def render(v: torch.Tensor, vi: torch.Tensor, index_img: torch.Tensor, y_offset: int = 0) -> torch.Tensor:
    """Perspective-correct barycentrics [N, 3, H, W] (zero at background) of
    rows ``[y_offset, y_offset + H)``, computed in float64, returned in
    ``v``'s dtype."""
    dtype = v.dtype
    v = v.to(_F64)
    vi = broadcast_vi(vi, v.shape[0])
    n, h, w = index_img.shape
    mask = (index_img != -1).to(_F64)
    p0, p1, p2 = _corners(v, vi, index_img)
    e01, e02, e12 = p1 - p0, p2 - p0, p2 - p1
    den = _eps64(e01[..., 0] * e02[..., 1] - e01[..., 1] * e02[..., 0])
    xs = torch.arange(w, dtype=_F64, device=v.device)[None, None, :]
    ys = torch.arange(y_offset, y_offset + h, dtype=_F64, device=v.device)[None, :, None]
    d0x, d0y = xs - p0[..., 0], ys - p0[..., 1]
    d1x, d1y = xs - p1[..., 0], ys - p1[..., 1]
    lam0 = (d1y * e12[..., 0] - d1x * e12[..., 1]) / den
    lam1 = (d0x * e02[..., 1] - d0y * e02[..., 0]) / den
    lam2 = (d0y * e01[..., 0] - d0x * e01[..., 1]) / den
    w0, w1, w2 = lam0 / _eps64(p0[..., 2]), lam1 / _eps64(p1[..., 2]), lam2 / _eps64(p2[..., 2])
    depth = 1.0 / _eps64(w0 + w1 + w2)
    return (torch.stack([w0, w1, w2], dim=1) * depth[:, None] * mask[:, None]).to(dtype)


def interpolate(attr: torch.Tensor, vi: torch.Tensor, index_img: torch.Tensor, bary: torch.Tensor,
                y_offset: int = 0, full_height: int | None = None) -> torch.Tensor:
    """Per-pixel attributes [N, C, H, W]: the barycentric blend of the face's
    corners, and at background the pixel's own normalized position (x, y,
    x, y, ...) of a ``full_height``-row frame; float64 inside."""
    dtype = attr.dtype
    va = attr.to(_F64)
    b = bary.to(_F64).movedim(1, -1)
    vi = broadcast_vi(vi, va.shape[0])
    n, h, w = index_img.shape
    full_height = h if full_height is None else full_height
    c = va.shape[-1]
    dev = va.device
    out = torch.zeros((n, h, w, c), dtype=_F64, device=dev)
    for k, corner in enumerate(_corners(va, vi, index_img)):
        out = out + corner * b[..., k: k + 1]
    sx = (torch.arange(w, dtype=_F64, device=dev) * 2.0 + 1.0) / w - 1.0
    sy = (torch.arange(y_offset, y_offset + h, dtype=_F64, device=dev) * 2.0 + 1.0) / full_height - 1.0
    pair = torch.stack([sx[None, :].expand(h, w), sy[:, None].expand(h, w)], dim=-1)
    sweep = pair.repeat(1, 1, (c + 1) // 2)[..., :c]
    out = torch.where((index_img != -1)[..., None], out, sweep[None])
    return out.movedim(-1, 1).to(dtype)


def bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """``tex`` [N, C, Ht, Wt] sampled bilinearly at ``uv`` [N, H, W, 2] in
    [-1, 1], border padding, ``align_corners=False``."""
    return F.grid_sample(tex, uv, mode="bilinear", padding_mode="border", align_corners=False)


def mipmap(levels, uv: torch.Tensor, vt_dxdy: torch.Tensor, max_aniso: int, clip_grad: bool) -> torch.Tensor:
    """Mipmapped anisotropic bilinear sampling with border padding: per pixel
    ``N = min(ceil(p_max / p_min), max_aniso)`` taps along the dominant
    screen axis at ``(i + 1) / (N + 1) * 2 - 1`` uv steps, level
    ``lambda = log2(p_max / N)`` clamped to the pyramid, the two nearest
    levels blended; with ``clip_grad`` the uv steps are rescaled where the
    pyramid is truncated. Everything derived from ``vt_dxdy`` is detached."""
    q = len(levels)
    base_h, base_w = levels[0].shape[2:]
    d = vt_dxdy.detach()
    dudx, dvdx, dudy, dvdy = d[..., 0, 0], d[..., 0, 1], d[..., 1, 0], d[..., 1, 1]
    px = torch.sqrt((dudx * base_w) ** 2 + (dvdx * base_h) ** 2 + 1e-12)
    py = torch.sqrt((dudy * base_w) ** 2 + (dvdy * base_h) ** 2 + 1e-12)
    p_max, p_min = torch.maximum(px, py), torch.minimum(px, py)
    n_taps = torch.clamp(torch.ceil(p_max / p_min), max=float(max_aniso))
    n_taps = torch.where((p_min == 0.0) | (n_taps == 0), torch.ones_like(n_taps), n_taps)
    lam = torch.log2(p_max / n_taps)
    lam = torch.where(torch.isnan(lam) | torch.isinf(lam), torch.zeros_like(lam), lam)
    lvl = torch.clamp(lam, max=q - 1 - 1e-6)
    if clip_grad:
        scale = torch.where(lam > q - 1, torch.exp2(lvl) * n_taps / p_max, torch.ones_like(lam))
        dudx, dvdx, dudy, dvdy = dudx * scale, dvdx * scale, dudy * scale, dvdy * scale
    lvl = torch.clamp(lvl, min=0.0)
    d1 = torch.floor(lvl)
    a = lvl - d1
    d2 = torch.clamp(d1 + 1, max=q - 1)
    n_f = torch.nan_to_num(n_taps, nan=0.0).to(torch.int32).to(uv.dtype)
    x_dom = px > py
    du = torch.where(x_dom, dudx, dudy)
    dv = torch.where(x_dom, dvdx, dvdy)
    out = None
    for i in range(max_aniso):
        frac = (i + 1.0) / (n_f + 1.0) * 2.0 - 1.0
        on = (i < n_f).to(uv.dtype) / n_f
        g = torch.stack([uv[..., 0] + du * frac, uv[..., 1] + dv * frac], dim=-1)
        for k, level in enumerate(levels):
            wt = on * (torch.where(d1 == k, 1.0 - a, 0.0) + torch.where(d2 == k, a, 0.0))
            if not bool((wt != 0).any()):
                continue
            s = bilinear(level, g) * wt[:, None]
            out = s if out is None else out + s
    return out


def _cubic_weights(t, a=-0.75):
    t2, t3 = t * t, t * t * t
    return (a * (t3 - 2 * t2 + t), (a + 2) * t3 - (a + 3) * t2 + 1,
            -(a + 2) * t3 + (2 * a + 3) * t2 - a * t, a * (t2 - t3))


def msi(ray_o, ray_d, texture, sub_step_count=2, min_inv_r=1.0, max_inv_r=0.0, stop_thresh=1e-7):
    """The MSI background [R, 4] (rgb, log-transmittance) of rays ``ray_o``,
    ``ray_d`` [R, 3] through ``texture`` [L, 4, H, W]: concentric spheres
    linear in 1/r, ``L * sub_step_count`` steps front to back, bilinear in
    (u, v) and cubic (A = -0.75) across layers, border-clamped, log-space
    compositing that stops at the first step whose transmittance falls
    below ``stop_thresh`` (its log-transmittance then -1e3). Gradients
    reach ``texture`` only."""
    n_layers, _, th, tw = texture.shape
    n_steps = n_layers * sub_step_count
    dt, dev = texture.dtype, texture.device
    r_o = ray_o.detach().to(dt)
    r_d = ray_d.detach().to(dt)
    r_d = r_d / torch.linalg.vector_norm(r_d, dim=-1, keepdim=True)
    tc = (-r_o * r_d).sum(-1)
    h2 = (r_o * r_o).sum(-1) - tc * tc
    i_arr = torch.arange(n_steps, device=dev).to(dt)
    a_arr = ((n_steps - 1 - i_arr) + 0.5) / n_steps
    r = 1.0 / ((1.0 - a_arr) * max_inv_r + a_arr * min_inv_r)
    det = (r * r)[None, :] - h2[:, None]
    hit = det >= 0.0
    t = tc[:, None] + torch.sqrt(torch.clamp(det, min=0.0))
    pos = r_o[:, None, :] + t[..., None] * r_d[:, None, :]
    u = torch.atan2(pos[..., 2], pos[..., 0]) / torch.pi
    v = 2.0 * torch.atan2(pos[..., 1], torch.hypot(pos[..., 0], pos[..., 2])) / torch.pi
    w = (1.0 - 2.0 * a_arr)[None, :].expand(u.shape)

    def unnorm_clip(coord, size):
        return torch.clamp(((coord + 1.0) * size - 1.0) / 2.0, 0.0, size - 1.0)

    x, y, z = unnorm_clip(u, tw), unnorm_clip(v, th), unnorm_clip(w, n_layers)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    tx, ty, tz = x - x0, y - y0, z - z0
    ix, iy, iz = x0.long(), y0.long(), z0.long()
    ix1, iy1 = torch.clamp(ix + 1, max=tw - 1), torch.clamp(iy + 1, max=th - 1)
    tex = texture.movedim(1, -1)  # [L, H, W, 4]
    sample = 0.0
    for i, cw in enumerate(_cubic_weights(tz)):
        lz = torch.clamp(iz - 1 + i, 0, n_layers - 1)
        plane = (tex[lz, iy, ix] * ((1 - tx) * (1 - ty))[..., None] + tex[lz, iy, ix1] * (tx * (1 - ty))[..., None]
                 + tex[lz, iy1, ix] * ((1 - tx) * ty)[..., None] + tex[lz, iy1, ix1] * (tx * ty)[..., None])
        sample = sample + plane * cw[..., None]
    rgb, alpha = sample[..., :3], sample[..., 3]
    act = hit & (alpha > 0.0)
    zero = torch.zeros((), dtype=dt, device=dev)
    pcnt = torch.where(act, alpha / n_steps, zero)
    incl = torch.cumsum(pcnt, dim=1)
    excl = incl - pcnt
    stop_flag = act & (torch.exp(-incl) < stop_thresh)
    any_stop = stop_flag.any(dim=1)
    first_stop = torch.where(any_stop, torch.argmax(stop_flag.to(torch.uint8), dim=1), n_steps - 1)
    contrib = act & (torch.arange(n_steps, device=dev)[None, :] <= first_stop[:, None])
    weight = torch.exp(-excl) * (1.0 - torch.exp(-pcnt))
    out_v = torch.where(contrib[..., None], weight[..., None] * torch.maximum(rgb, zero), zero).sum(1)
    final_log_t = -torch.gather(incl, 1, first_stop[:, None])[:, 0]
    log_t = torch.where(any_stop, torch.full_like(final_log_t, -1e3), final_log_t)
    return torch.cat([out_v, log_t[:, None]], dim=-1)
