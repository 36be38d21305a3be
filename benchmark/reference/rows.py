"""The reference of the row-sharded fitting step (entry ``rows``), one
camera at a time: its whole frame rasterized, rendered, its uvs
interpolated, its texture sampled bilinearly with border padding, the mask,
the edge-gradient estimator; the loss, ``mean(img**2)`` over every
camera's frame, by the configuration's blocks of rows. Each camera has
leaves of its own and Adam updates each value alone, so the cameras'
steps are independent pieces (:func:`pieces`)."""

from __future__ import annotations

import torch

from reference.edge_grad import edge_grad_estimator
from reference.raster import rasterize
from reference.shade import bilinear, interpolate, render


def pieces(arrays: dict, cfg: dict) -> list:
    """The scene camera by camera."""
    return [{k: a if k == "vi" else a[c:c + 1] for k, a in arrays.items()} for c in range(cfg["cameras"])]


def image(s: dict, cfg: dict, q, probe: dict | None = None) -> torch.Tensor:
    """The frames [N, 3, H, W] of scene ``s`` (``v``, ``vi``, ``vt``,
    ``tex``), every float input and the frames passed through ``q``."""
    h, w = cfg["height"], cfg["width"]
    v, vt, tex, vi = q(s["v"]), q(s["vt"]), q(s["tex"]), s["vi"]
    idx = rasterize(v, vi, h, w)
    bary = render(v, vi, idx)
    uv = interpolate(vt, vi, idx, bary).movedim(1, -1) * 2.0 - 1.0
    img = bilinear(tex, uv) * (idx != -1)[:, None].to(tex.dtype)
    return q(edge_grad_estimator(v, vi, bary, img, idx, probe))


def loss(s: dict, cfg: dict, q, probe: dict | None = None) -> torch.Tensor:
    """The parts of ``mean(img**2)`` over all the configuration's cameras
    that fall in each block of rows, [blocks]."""
    h, w = cfg["height"], cfg["width"]
    blocks = cfg["mesh"][1]
    img = image(s, cfg, q, probe)
    sq = (img**2).reshape(img.shape[0], img.shape[1], blocks, h // blocks, w).sum(dim=(0, 1, 3, 4))
    return sq / (cfg["cameras"] * 3 * h * w)
