"""Row banding on one device (counterpart of
``drtk_tpu/parallel/banded.py``): run the pipeline over horizontal bands of
a frame so that a step holds one band's intermediates at a time.

* :func:`map_row_bands` runs a band function (rasterize -> render ->
  interpolate -> shading as a row-tile viewport, bit-exact with the full
  frame's rows) over ``n_bands`` bands, each under
  ``torch.utils.checkpoint`` so the backward recomputes one band at a time,
  and concatenates the outputs along the row axis.
* :func:`edge_grad_estimator_banded` is ``edge_grad_estimator`` whose
  backward runs band by band, each band with a one-row halo (the next
  band's first row, the stencil's D leg) sliced from the full arrays, and
  adds each band's vertex gradient into one accumulator: one launch of
  kernel E1 per band on the card.

Banded output equals the full frame's when the band function is per pixel;
gradients then differ only by summation order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from drtk_tpu_torch.ops.edge_grad import edge_grad_to_verts
from drtk_tpu_torch.ops.math import autocast_f32
from drtk_tpu_torch.ops.rasterize import broadcast_vi

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


class _EdgeGradBanded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_pix, vi, bary_img, img, index_img, max_dp_dr, n_bands, impl):
        ctx.save_for_backward(v_pix, vi, bary_img, img, index_img)
        ctx.max_dp_dr, ctx.n_bands, ctx.impl = max_dp_dr, n_bands, impl
        return img.view_as(img)

    @staticmethod
    def backward(ctx, grad_output):
        """``drtk_tpu/parallel/banded.py:109-173``: the full-frame backward,
        one band at a time, each band's halo-row contributions reduced to
        vertices with the band, into one accumulator. The last band needs
        no halo row: its stencil centres on the frame's last row are
        dropped."""
        v_pix, vi, bary_img, img, index_img = ctx.saved_tensors
        grad_v_pix = None
        if ctx.needs_input_grad[0]:
            h = img.shape[2]
            hb = _band_height(h, ctx.n_bands)
            for y0 in range(0, h, hb):
                rows = slice(y0, y0 + hb + 1)  # the band and the next band's first row
                grad_v_pix = edge_grad_to_verts(
                    v_pix, vi, index_img[:, rows], img[:, :, rows], grad_output[:, :, rows], bary_img[:, :, rows],
                    ctx.max_dp_dr, y0, h, out=grad_v_pix, impl=ctx.impl,
                )
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
    row-banded backward: the same arguments and gradient, the backward run
    over ``n_bands`` bands (the height must divide by it), one launch of
    kernel E1 per band on the card, all into one accumulator.

    Returns ``img`` (float32 if it was f16/bf16).
    """
    v_pix = autocast_f32(v_pix)
    bary_img = autocast_f32(bary_img)
    img = autocast_f32(img)
    vi = broadcast_vi(vi, v_pix.shape[0])
    _band_height(img.shape[2], n_bands)
    return _EdgeGradBanded.apply(v_pix, vi, bary_img.detach(), img, index_img, float(max_dp_dr), int(n_bands), impl)
