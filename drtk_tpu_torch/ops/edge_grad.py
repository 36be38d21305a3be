"""Edge-gradient estimator (counterpart of
:func:`drtk_tpu.ops.edge_grad.edge_grad_estimator`).

The forward pass is the identity on ``img``. The backward pass (the CRD
stencil that gives vertex gradients at visibility discontinuities) belongs
to the next slice; until then the estimator raises when differentiated
rather than return gradients without the edge term.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from drtk_tpu_torch.ops.math import autocast_f32
from drtk_tpu_torch.ops.rasterize import broadcast_vi
from drtk_tpu_torch.ops.render import BACKWARD_NOT_PORTED

__all__ = ["edge_grad_estimator"]


class _EdgeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_pix, vi, bary_img, img, index_img, max_dp_dr):
        return img.view_as(img)

    @staticmethod
    def backward(ctx, grad_img):
        raise NotImplementedError("edge_grad_estimator " + BACKWARD_NOT_PORTED)


def edge_grad_estimator(
    v_pix: torch.Tensor,
    vi: torch.Tensor,
    bary_img: torch.Tensor,
    img: torch.Tensor,
    index_img: torch.Tensor,
    v_pix_img_hook: Optional[Callable[[torch.Tensor], None]] = None,
    max_dp_dr: float = 1e4,
) -> torch.Tensor:
    """Make the rasterized image differentiable at visibility discontinuities.

    Returns ``img`` unchanged in the forward pass.

    Args:
        v_pix: [N, V, 3] pixel-space positions (x_pix, y_pix, z_cam).
        vi: [N, F, 3] or [F, 3] int32 face indices.
        bary_img: [N, 3, H, W] barycentrics (detached).
        img: [N, C, H, W] rendered image, corresponding exactly to
            index_img/bary_img.
        index_img: [N, H, W] int32 index image.
        v_pix_img_hook: unsupported, as in the JAX package.
        max_dp_dr: magnitude clamp for dp/dr used by the backward pass.

    Returns:
        ``img`` (float32 if it was f16/bf16).
    """
    if v_pix_img_hook is not None:
        raise NotImplementedError("edge_grad_estimator: v_pix_img_hook is not supported")
    v_pix = autocast_f32(v_pix)
    bary_img = autocast_f32(bary_img)
    img = autocast_f32(img)
    vi = broadcast_vi(vi, v_pix.shape[0])
    return _EdgeGrad.apply(v_pix, vi, bary_img.detach(), img, index_img, float(max_dp_dr))
