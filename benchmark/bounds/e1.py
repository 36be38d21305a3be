"""E1's bytes bound (copy of ``chip_smoke.py``'s ``e1_bound``): per launch
of the edge_grad backward (one per row band of the configuration, each
band with the next band's first row), the index of its rows once, the
[N, V, 3] vertex gradient once, img and the cotangent (C values each) and
bary (3) at the pixels that receive a nonzero part, and the vertex ids and
corners of those pixels' faces; which pixels receive a part comes from the
reference's own backward (``reference.edge_grad.image_grad``) on this
step's data."""

import torch

from reference.edge_grad import image_grad


def bytes_per_step(cfg: dict, probe: dict) -> int:
    v, vi, idx, img, cot = (probe[k] for k in ("v_pix", "vi", "index", "img", "cotangent"))
    n, c, h, w = img.shape
    es = v.element_size()
    f_cnt = vi.shape[-2]
    hb = h // cfg.get("bands", 1)
    total = 0
    for y0 in range(0, h, hb):
        rows = slice(y0, min(y0 + hb + 1, h))
        band_idx = idx[:, rows]
        with torch.no_grad():
            g = image_grad(v, vi, img[:, :, rows], band_idx, cot[:, :, rows], y_offset=y0)
        parts = (g != 0).any(1) & (band_idx >= 0)
        n_parts = int(parts.sum())
        batch = torch.nonzero(parts)[:, 0]
        faces = int(torch.unique(band_idx[parts].long() + batch * f_cnt).numel())
        total += (n * band_idx.shape[1] * w * 4 + v.shape[0] * v.shape[1] * 3 * es + n_parts * (2 * c + 3) * es
                  + faces * (12 + 9 * es))
    return total
