"""Barycentric interpolation of vertex attributes (counterpart of
:func:`drtk_tpu.ops.interpolate.interpolate` and ``interpolate_ref``).

Per pixel, the three attribute rows of the rasterized triangle arrive as
one 3*C-float row through :func:`gather_rows_by_index` (kernel B2 on the
card) and are weighted by the barycentric image. Background pixels get the
deterministic -1..1 x/y sweep pattern rather than zeros.

The backward is the JAX package's VJP (``_interpolate_core_bwd``; its
``_geom`` twin differs only in the TPU reduction it selects): the
barycentric gradient is ``sum_c g_c * attr_c`` over the attribute rows,
gathered again through kernel B2, and the attribute gradient is ``bary x g``
summed to face rows through kernel B3, then to vertices with ``index_add_``.
Background pixels contribute nothing: the sweep is a constant.
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from drtk_tpu_torch.ops.math import autocast_f32
from drtk_tpu_torch.ops.rasterize import broadcast_vi
from drtk_tpu_torch.ops.render import _face_table, _pixels_to_verts
from drtk_tpu_torch.ops.segment_rows import gather_rows_by_index

__all__ = ["interpolate", "interpolate_ref"]

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@functools.lru_cache(maxsize=64)
def _sweep_vector(size: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``(arange(size) * 2 + 1) / size - 1`` on ``device``, cached per
    (size, dtype, device), so a forward copies nothing from the host after
    its first call. Callers only read it.

    Built in numpy, in the dtype and op order of the JAX package's sweep,
    and then copied to the device. The JAX package builds it in numpy
    because its compiler may turn the division into a reciprocal-multiply
    (1 ulp off); building it the same way keeps the two bit-exact."""
    if dtype not in _NP_DTYPE:
        raise TypeError(f"interpolate: no background sweep for {dtype}")
    t = _NP_DTYPE[dtype]
    return torch.from_numpy((np.arange(size, dtype=t) * t(2) + t(1)) / t(size) - t(1)).to(device)


def _sweep_pattern(
    height: int, width: int, channels: int, dtype, device, y_offset: int = 0, full_height: int | None = None
) -> torch.Tensor:
    """Background sweep [C, H, W]: channel c holds ``(x*2+1)/W - 1`` when c
    is even and ``(y*2+1)/F - 1`` when c is odd, F the frame's height
    (``full_height``, default ``height``) and y the global row: rows
    ``[y_offset, y_offset + height)`` of the full frame's sweep, bit for
    bit (``drtk_tpu/ops/interpolate.py:81-105``)."""
    device = torch.device(device)
    frame_h = height if full_height is None else full_height
    img_x = _sweep_vector(width, dtype, device)[None, :].expand(height, width)
    img_y = _sweep_vector(frame_h, dtype, device)[y_offset : y_offset + height, None].expand(height, width)
    return torch.stack([img_x if c % 2 == 0 else img_y for c in range(channels)], dim=0)


def _interpolate_fwd_math(vert_attributes, vi, index_img, bary_img, impl="auto", y_offset=0, full_height=None):
    n, h, w = index_img.shape
    c = vert_attributes.shape[-1]
    mask = index_img >= 0
    rows = gather_rows_by_index(_face_table(vert_attributes, vi), index_img, impl)
    attrs = rows.reshape(n, h, w, 3, c)
    bary = bary_img.movedim(1, -1)[..., None]  # [N, H, W, 3, 1]
    ab = attrs * bary
    out = (ab[..., 0, :] + ab[..., 1, :]) + ab[..., 2, :]  # [N, H, W, C]
    out = out.movedim(-1, 1)  # [N, C, H, W]
    sweep = _sweep_pattern(h, w, c, vert_attributes.dtype, vert_attributes.device, y_offset, full_height)[None]
    return torch.where(mask[:, None], out, sweep)


class _Interpolate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vert_attributes, vi, index_img, bary_img, impl, y_offset, full_height):
        ctx.save_for_backward(vert_attributes, vi, index_img, bary_img)
        ctx.impl = impl
        return _interpolate_fwd_math(vert_attributes, vi, index_img, bary_img, impl, y_offset, full_height)

    @staticmethod
    def backward(ctx, grad_out):
        """Mirrors ``drtk_tpu/ops/interpolate.py:164-210``."""
        vert_attributes, vi, index_img, bary_img = ctx.saved_tensors
        n, h, w = index_img.shape
        c = vert_attributes.shape[-1]
        mask = (index_img >= 0).to(grad_out.dtype)
        g = grad_out.movedim(1, -1) * mask[..., None]  # [N, H, W, C]
        grad_attr = grad_bary = None
        if ctx.needs_input_grad[3]:
            rows = gather_rows_by_index(_face_table(vert_attributes, vi), index_img, ctx.impl)
            attrs = rows.reshape(n, h, w, 3, c)
            grad_bary = (g[..., None, :] * attrs).sum(-1).movedim(-1, 1).to(bary_img.dtype)
        if ctx.needs_input_grad[0]:
            bary = bary_img.movedim(1, -1)  # [N, H, W, 3]
            contrib = (bary[..., None] * g[..., None, :]).reshape(n, h, w, 3 * c)
            grad_attr = _pixels_to_verts(contrib, index_img, vi, vert_attributes.shape[1], ctx.impl)
            grad_attr = grad_attr.to(vert_attributes.dtype)
        return grad_attr, None, None, grad_bary, None, None, None


def interpolate(
    vert_attributes: torch.Tensor,
    vi: torch.Tensor,
    index_img: torch.Tensor,
    bary_img: torch.Tensor,
    v_pix: torch.Tensor | None = None,
    impl: str = "auto",
    y_offset: int = 0,
    full_height: int | None = None,
) -> torch.Tensor:
    """Linearly interpolate vertex attributes over rasterized pixels.

    Args:
        vert_attributes: [N, V, C] vertex attributes.
        vi: [N, F, 3] or [F, 3] int32 face indices.
        index_img: [N, H, W] int32 triangle index image (-1 = background).
        bary_img: [N, 3, H, W] barycentric image.
        v_pix: optional [N, V, 3] geometry that produced ``index_img``,
            accepted for parity with the JAX package, which uses it only to
            pick a TPU reduction route for the backward. It has no effect
            here, and its gradient is zero (none is returned), as in JAX.
        impl: "auto" gathers the face rows with kernel B2 on CUDA tensors;
            "plain" uses the plain gather on any device.
        y_offset, full_height: a row-tile viewport, as for
            :func:`~drtk_tpu_torch.ops.rasterize.rasterize`: when the block
            holds rows ``[y_offset, y_offset + H)`` of a
            ``full_height``-row frame, the background sweep takes the global
            rows, so the block equals those rows of the full-frame call bit
            for bit. Without ``full_height`` the block is its own frame and
            ``y_offset`` is ignored, as in the JAX package.

    Returns:
        [N, C, H, W] interpolated image. Background pixels hold the -1..1
        sweep pattern and must be ignored by the caller.
    """
    del v_pix
    vert_attributes = autocast_f32(vert_attributes)
    bary_img = autocast_f32(bary_img)
    if vert_attributes.ndim != 3:
        raise ValueError(
            f"interpolate: expected [N, V, C] attributes, got {tuple(vert_attributes.shape)}"
        )
    vi = broadcast_vi(vi, vert_attributes.shape[0])
    if bary_img.ndim != 4 or bary_img.shape[1] != 3:
        raise ValueError(f"interpolate: expected bary_img [N, 3, H, W], got {tuple(bary_img.shape)}")
    if full_height is None:
        y_offset = 0
    else:
        y_offset, full_height = operator.index(y_offset), operator.index(full_height)
        if y_offset < 0 or y_offset + index_img.shape[1] > full_height:
            raise ValueError(
                f"interpolate: rows [{y_offset}, {y_offset + index_img.shape[1]}) do not lie in a frame of "
                f"{full_height} rows"
            )
    return _Interpolate.apply(vert_attributes, vi, index_img, bary_img, impl, y_offset, full_height)


def interpolate_ref(
    vert_attributes: torch.Tensor,
    vi: torch.Tensor,
    index_img: torch.Tensor,
    bary_img: torch.Tensor,
) -> torch.Tensor:
    """Float64 reference of :func:`interpolate`.

    Shares no code with the op's forward: per-corner element gathers (not
    the packed face-row gather), the sum formed corner by corner, and the
    sweep assembled by tiling the (x, y) channel pair out to C channels.
    """
    orig_dtype = vert_attributes.dtype
    f64 = torch.float64
    va = vert_attributes.to(f64)
    bary = bary_img.to(f64).movedim(1, -1)  # [N, H, W, 3]
    vi = broadcast_vi(vi, va.shape[0])
    n, h, w = index_img.shape
    c = va.shape[-1]
    dev = va.device

    bidx = torch.arange(n, device=dev)[:, None, None]
    safe = index_img.long().clamp(min=0)
    vi_img = vi.long()[bidx, safe]  # [N, H, W, 3]
    out = torch.zeros((n, h, w, c), dtype=f64, device=dev)
    for k in range(3):
        out = out + va[bidx, vi_img[..., k]] * bary[..., k : k + 1]

    sx = (torch.arange(w, dtype=f64, device=dev) * 2.0 + 1.0) / w - 1.0
    sy = (torch.arange(h, dtype=f64, device=dev) * 2.0 + 1.0) / h - 1.0
    pair = torch.stack([sx[None, :].expand(h, w), sy[:, None].expand(h, w)], dim=-1)
    sweep = pair.repeat(1, 1, (c + 1) // 2)[..., :c]
    out = torch.where((index_img != -1)[..., None], out, sweep[None])
    return out.movedim(-1, 1).to(orig_dtype)
