"""Row banding on one device (counterpart of
``drtk_tpu/parallel/banded.py``): run the pipeline over horizontal bands of
a frame so that a step holds one band's intermediates at a time.

* :func:`map_row_bands` runs a band function (rasterize -> render ->
  interpolate -> shading as a row-tile viewport, bit-exact with the full
  frame's rows) over ``n_bands`` bands, each under
  ``torch.utils.checkpoint`` so the backward recomputes one band at a time,
  and concatenates the outputs along the row axis.
* :func:`edge_grad_estimator_banded` is ``edge_grad_estimator`` whose
  backward runs the CRD stencil band by band, each band with a one-row
  halo (the next band's first row, the stencil's D leg) sliced from the
  full arrays, and reduces each band's ``bary x g`` rows to faces with
  kernel B3 on the card, one launch per band.

Banded output equals the full frame's when the band function is per pixel;
gradients then differ only by summation order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from drtk_tpu_torch.ops.edge_grad import _edge_grad_block_rows
from drtk_tpu_torch.ops.math import autocast_f32
from drtk_tpu_torch.ops.rasterize import broadcast_vi
from drtk_tpu_torch.ops.render import _pixels_to_verts

__all__ = ["edge_grad_estimator_banded", "map_row_bands"]


def _band_height(height: int, n_bands: int) -> int:
    if n_bands < 1 or height % n_bands != 0:
        raise ValueError(f"height {height} not divisible by n_bands {n_bands}")
    return height // n_bands


def map_row_bands(band_fn: Callable, height: int, n_bands: int, remat: bool = True) -> Any:
    """Map ``band_fn`` over ``n_bands`` row bands and merge to full height.

    Args:
        band_fn: ``band_fn(y0) -> pytree of tensors``, each a row block
            ``[..., hb, W]`` (rows on axis -2, ``hb = height // n_bands``)
            covering global rows ``[y0, y0 + hb)``; ``y0`` is an int, to
            pass to the viewport ops (``rasterize(..., y_offset=y0,
            full_height=height)`` and so on). Close over everything else;
            gradients to it accumulate over the bands.
        height: the frame's height; must divide by ``n_bands``.
        n_bands: the number of bands.
        remat: run each band under ``torch.utils.checkpoint`` (default), so
            the backward recomputes one band's intermediates at a time.

    Returns:
        The band outputs concatenated along axis -2: each leaf
        ``[..., height, W]``.
    """
    hb = _band_height(height, n_bands)
    outs = []
    for b in range(n_bands):
        y0 = b * hb
        outs.append(checkpoint(band_fn, y0, use_reentrant=False) if remat else band_fn(y0))
    flat = [pytree.tree_flatten(o) for o in outs]
    spec = flat[0][1]
    return pytree.tree_unflatten([torch.cat(leaves, dim=-2) for leaves in zip(*(f[0] for f in flat))], spec)


def _pad_rows(x: torch.Tensor, value=0) -> torch.Tensor:
    """One row appended on axis -2."""
    return F.pad(x, (0, 0, 0, 1), value=value)


def _edge_grad_band_rows(v_pix, vi, padded, y0: int, hb: int, height: int, max_dp_dr: float, impl="auto"):
    """The per-pixel ``bary x g`` rows [N, hb+1, W, 9] of the band owning
    stencil centres in rows ``[y0, y0 + hb)``, and its index block
    [N, hb+1, W]: the band and one halo row sliced from ``padded`` = (img,
    g, bary, index) with one background row appended."""
    rows = slice(y0, y0 + hb + 1)
    img_p, g_p, bary_p, idx_p = padded
    block = (img_p[:, :, rows], g_p[:, :, rows], bary_p[:, :, rows], idx_p[:, rows])
    return _edge_grad_block_rows(v_pix, vi, block, y0, height, max_dp_dr, impl)


def _pad_frame(img, g, bary_img, index_img):
    """(img, g, bary, index) with one background row (zeros, index -1)
    appended, so every band's halo slice has the same shape."""
    return _pad_rows(img), _pad_rows(g), _pad_rows(bary_img), _pad_rows(index_img, -1)


class _EdgeGradBanded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_pix, vi, bary_img, img, index_img, max_dp_dr, n_bands, impl):
        ctx.save_for_backward(v_pix, vi, bary_img, img, index_img)
        ctx.max_dp_dr, ctx.n_bands, ctx.impl = max_dp_dr, n_bands, impl
        return img.view_as(img)

    @staticmethod
    def backward(ctx, grad_output):
        """``drtk_tpu/parallel/banded.py:109-173``: the full-frame backward,
        one band at a time; each band's halo-row contributions reduce to
        vertices with the band, and the bands' vertex gradients are summed."""
        v_pix, vi, bary_img, img, index_img = ctx.saved_tensors
        grad_v_pix = None
        if ctx.needs_input_grad[0]:
            h = img.shape[2]
            hb = _band_height(h, ctx.n_bands)
            padded = _pad_frame(img, grad_output, bary_img, index_img)
            grad_v_pix = torch.zeros_like(v_pix)
            for b in range(ctx.n_bands):
                rows, idx_b = _edge_grad_band_rows(v_pix, vi, padded, b * hb, hb, h, ctx.max_dp_dr, ctx.impl)
                grad_v_pix += _pixels_to_verts(rows, idx_b, vi, v_pix.shape[1], ctx.impl)
        grad_img = grad_output if ctx.needs_input_grad[3] else None
        return grad_v_pix, None, None, grad_img, None, None, None, None


def edge_grad_estimator_banded(
    v_pix: torch.Tensor,
    vi: torch.Tensor,
    bary_img: torch.Tensor,
    img: torch.Tensor,
    index_img: torch.Tensor,
    n_bands: int,
    max_dp_dr: float = 1e4,
    impl: str = "auto",
) -> torch.Tensor:
    """:func:`~drtk_tpu_torch.ops.edge_grad.edge_grad_estimator` with a
    row-banded backward: the same arguments and gradient, the CRD stencil
    run over ``n_bands`` bands (the height must divide by it), each band's
    ``bary x g`` rows reduced to faces by kernel B3 on the card.

    Returns ``img`` (float32 if it was f16/bf16).
    """
    v_pix = autocast_f32(v_pix)
    bary_img = autocast_f32(bary_img)
    img = autocast_f32(img)
    vi = broadcast_vi(vi, v_pix.shape[0])
    _band_height(img.shape[2], n_bands)
    return _EdgeGradBanded.apply(v_pix, vi, bary_img.detach(), img, index_img, float(max_dp_dr), int(n_bands), impl)
