"""M1's bytes bound: the least bytes the two launches of bilinear
``mipmap_grid_sample`` must move on the first traced step's data. Per
pixel, once each: the grid (2 values), the Jacobian (4), the output (C),
its cotangent (C) and the grid's gradient (2). Per level, once: each texel
that a pixel reads (read) and each that a pixel with a nonzero cotangent
sends a gradient to (written), counting only each live tap's floor corner,
whose bilinear weight is never zero; the tap counts, levels and weights are
the reference's (``reference.shade.mipmap``). The levels are read once for
every view, though M1 reads them per view and writes a gradient per view."""

import torch


def _selection(uv, jac, base_hw, n_levels, max_aniso):
    """Per pixel: the tap count N, the uv step of the dominant axis, the two
    levels and the second's blend weight, as ``reference.shade.mipmap``."""
    base_h, base_w = base_hw
    dudx, dvdx, dudy, dvdy = jac[..., 0, 0], jac[..., 0, 1], jac[..., 1, 0], jac[..., 1, 1]
    px = torch.sqrt((dudx * base_w) ** 2 + (dvdx * base_h) ** 2 + 1e-12)
    py = torch.sqrt((dudy * base_w) ** 2 + (dvdy * base_h) ** 2 + 1e-12)
    p_max, p_min = torch.maximum(px, py), torch.minimum(px, py)
    n_taps = torch.clamp(torch.ceil(p_max / p_min), max=float(max_aniso))
    n_taps = torch.where((p_min == 0.0) | (n_taps == 0), torch.ones_like(n_taps), n_taps)
    lam = torch.log2(p_max / n_taps)
    lam = torch.where(torch.isnan(lam) | torch.isinf(lam), torch.zeros_like(lam), lam)
    lvl = torch.clamp(torch.clamp(lam, max=n_levels - 1 - 1e-6), min=0.0)
    d1 = torch.floor(lvl)
    x_dom = px > py
    du, dv = torch.where(x_dom, dudx, dudy), torch.where(x_dom, dvdx, dvdy)
    n_f = torch.nan_to_num(n_taps, nan=0.0).to(torch.int32).to(uv.dtype)
    return n_f, du, dv, d1.long(), torch.clamp(d1 + 1, max=n_levels - 1).long(), lvl - d1


def _texels(uv, jac, sizes, max_aniso, pixels):
    """Per level, the texels whose floor corner a live tap of ``pixels``
    (a [N, H, W] mask) reads with a nonzero weight."""
    n_f, du, dv, d1, d2, a = _selection(uv, jac, sizes[0], len(sizes), max_aniso)
    counts = []
    for k, (h, w) in enumerate(sizes):
        seen = torch.zeros(h * w, dtype=torch.bool, device=uv.device)
        for level, weight in ((d1, 1.0 - a), (d2, a)):
            for i in range(max_aniso):
                frac = (i + 1.0) / (n_f + 1.0) * 2.0 - 1.0
                live = pixels & (level == k) & (weight != 0) & (i < n_f)
                x = torch.clamp(((uv[..., 0] + du * frac + 1.0) * w - 1.0) / 2.0, 0.0, w - 1.0)
                y = torch.clamp(((uv[..., 1] + dv * frac + 1.0) * h - 1.0) / 2.0, 0.0, h - 1.0)
                texel = torch.floor(y).long() * w + torch.floor(x).long()
                seen[texel[live]] = True
        counts.append(int(seen.sum()))
    return counts


def bytes_per_step(cfg: dict, probe: dict) -> int:
    uv, jac, cot = probe["m1_uv"], probe["m1_jac"], probe["m1_cot"]
    c = cot.shape[1]
    es = uv.element_size()
    sizes = [shape[-2:] for shape in probe["m1_levels"]]
    n, h, w = uv.shape[:3]
    with torch.no_grad():
        everywhere = torch.ones((n, h, w), dtype=torch.bool, device=uv.device)
        read = _texels(uv, jac, sizes, cfg["max_aniso"], everywhere)
        written = _texels(uv, jac, sizes, cfg["max_aniso"], (cot != 0).any(1))
    return n * h * w * (2 + 4 + c + c + 2) * es + (sum(read) + sum(written)) * c * es
