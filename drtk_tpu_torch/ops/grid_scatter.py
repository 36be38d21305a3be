"""Grid scatter, the splatting counterpart of ``grid_sample`` (counterpart
of ``drtk_tpu/ops/grid_scatter.py``).

Each input pixel adds its value, weighted by the sampler's interpolation
weights, to the texels ``grid`` names; contributions accumulate. For a fixed
grid, ``grid_sample(tex, grid)`` is linear in ``tex`` and grid_scatter is its
transpose. The forward builds the sampler's tap set explicitly, with
:mod:`~drtk_tpu_torch.ops.grid_sample`'s own coordinate helpers (so the
splat targets are the sampler's gather sources by construction, bicubic's
per-tap border and reflection folds included), and adds the weighted rows
with :func:`~drtk_tpu_torch.ops.window_accum.window_accumulate`: kernel B4
on a CUDA tensor, in one launch over the [T*H, W] tap grid (T = 4 taps for
bilinear, 16 for bicubic), so that a warp of B4 takes neighbouring taps of
one tap plane. Taps whose source pixel is zero in every channel are inert
(exact: they add nothing), which keeps B4 off a masked render's background,
whose uvs sweep the whole texture. float64 inputs take the plain version
(``index_add_``), the exact path that stands in for the JAX package's
linear transpose of the sampler.

The backward is the JAX package's: the input's gradient is the sampler
applied to the output's gradient (a gather), the grid's the sampler's
derivative contracted with ``input``.
"""

from __future__ import annotations

from typing import Optional

import torch

from drtk_tpu_torch.ops.grid_sample import (
    _compute_source_index,
    _cubic_weights,
    _grid_sample_impl,
    _reflect,
    _unnormalize,
)
from drtk_tpu_torch.ops.math import autocast_f32
from drtk_tpu_torch.ops.window_accum import window_accumulate

__all__ = ["grid_scatter", "grid_scatter_ref"]


def _scatter_taps(grid, out_h: int, out_w: int, mode: str, padding_mode: str, align_corners: bool, dtype):
    """The taps of each input pixel, (iy, ix, weight), each [N, T, H, W]
    (T = 4 bilinear, 16 bicubic), weights in ``dtype``, taps outside the
    table marked iy = -1: the adjoint tap set of the sampler
    (``drtk_tpu/ops/grid_scatter.py:82-145``)."""
    gx = grid[..., 0]
    gy = grid[..., 1]
    iys, ixs, wts = [], [], []
    if mode == "bilinear":
        x = _compute_source_index(gx, out_w, padding_mode, align_corners)
        y = _compute_source_index(gy, out_h, padding_mode, align_corners)
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        tx = (x - x0).to(dtype)
        ty = (y - y0).to(dtype)
        ix0 = x0.to(torch.int32)
        iy0 = y0.to(torch.int32)
        for dy, wy in ((0, 1.0 - ty), (1, ty)):
            for dx, wx in ((0, 1.0 - tx), (1, tx)):
                iys.append(iy0 + dy)
                ixs.append(ix0 + dx)
                wts.append(wx * wy)
    else:  # bicubic: unnormalized without the fold, then each tap bounded, as the sampler does
        x = _unnormalize(gx, out_w, align_corners)
        y = _unnormalize(gy, out_h, align_corners)
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx = _cubic_weights((x - x0).to(dtype))
        wy = _cubic_weights((y - y0).to(dtype))
        ix0 = x0.to(torch.int32)
        iy0 = y0.to(torch.int32)

        def bound(i, size):
            if padding_mode == "zeros":
                return i
            vf = i.to(x.dtype)
            if padding_mode == "reflection":
                vf = _reflect(vf, 0.0, float(size - 1)) if align_corners else _reflect(vf, -0.5, size - 0.5)
            return torch.clamp(vf, 0, size - 1).to(torch.int32)

        for j in range(4):
            iy = bound(iy0 + (j - 1), out_h)
            for i in range(4):
                iys.append(iy)
                ixs.append(bound(ix0 + (i - 1), out_w))
                wts.append(wx[i] * wy[j])

    iy_t = torch.stack(iys, dim=1)
    ix_t = torch.stack(ixs, dim=1)
    inb = (iy_t >= 0) & (iy_t < out_h) & (ix_t >= 0) & (ix_t < out_w)
    return torch.where(inb, iy_t, -1), torch.where(inb, ix_t, 0), torch.stack(wts, dim=1)


def _scatter(input, grid, out_h: int, out_w: int, mode: str, padding_mode: str, align_corners: bool):
    """The forward: the taps' weighted rows accumulated into the table,
    [N, C, out_h, out_w] of ``input``'s dtype. float64 accumulates with the
    plain version in float64, everything else in float32 (kernel B4 on a
    CUDA tensor)."""
    n, c, h, w = input.shape
    exact = input.dtype == torch.float64
    dtype = torch.float64 if exact else torch.float32
    iy, ix, wt = _scatter_taps(grid, out_h, out_w, mode, padding_mode, align_corners, dtype)
    t = iy.shape[1]
    rows = input.to(dtype)[:, :, None] * wt[:, None]  # [N, C, T, H, W]
    # Inert taps: those of pixels that are zero in every channel.
    live = (input != 0).any(dim=1)[:, None]  # [N, 1, H, W]
    iy = torch.where(live, iy, -1)
    out = window_accumulate(
        rows.reshape(n, c, t * h * w), iy.reshape(n, -1), ix.reshape(n, -1), out_h, out_w,
        "plain" if exact else "auto", rows_hw=(t * h, w),
    )
    return out.to(input.dtype)


class _GridScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, grid, out_h, out_w, mode, padding_mode, align_corners):
        ctx.save_for_backward(input, grid)
        ctx.args = (mode, padding_mode, align_corners)
        return _scatter(input, grid, out_h, out_w, mode, padding_mode, align_corners)

    @staticmethod
    def backward(ctx, grad_output):
        """``drtk_tpu/ops/grid_scatter.py:241-259``: one sample of the
        output's gradient at the grid gives the input's gradient; its
        derivative with respect to the grid, contracted with ``input``, the
        grid's. Only the grid requires a gradient there, so no texture
        scatter runs."""
        input, grid = ctx.saved_tensors
        mode, padding_mode, align_corners = ctx.args
        need_input, need_grid = ctx.needs_input_grad[:2]
        grad_input = grad_grid = None
        grad_output = grad_output.detach()
        if need_grid:
            with torch.enable_grad():
                g = grid.detach().requires_grad_()
                sampled = _grid_sample_impl(grad_output, g, mode, padding_mode, align_corners, "auto")
                (grad_grid,) = torch.autograd.grad((sampled * input.detach()).sum(), g)
            grad_input = sampled.detach()
        elif need_input:
            grad_input = _grid_sample_impl(grad_output, grid, mode, padding_mode, align_corners, "auto")
        if not need_input:
            grad_input = None
        return grad_input, grad_grid, None, None, None, None, None


def _check(name: str, input, grid, mode, padding_mode):
    if mode not in ("bilinear", "bicubic"):
        raise ValueError(f"{name}(): only 'bilinear' and 'bicubic' modes are supported but got: '{mode}'")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(
            f"{name}(): expected padding_mode to be 'zeros', 'border', or 'reflection', but got: '{padding_mode}'"
        )
    if input.ndim != 4:
        raise ValueError(f"{name}(): expected [N, C, H, W] input, got {tuple(input.shape)}")
    if grid.ndim != 4 or grid.shape[-1] != 2:
        raise ValueError(f"{name}(): expected [N, H, W, 2] grid, got {tuple(grid.shape)}")
    if grid.shape[0] != input.shape[0] or grid.shape[1:3] != input.shape[2:4]:
        raise ValueError(
            f"{name}(): grid spatial shape must match input, got {tuple(grid.shape)} vs {tuple(input.shape)}"
        )


def grid_scatter(
    input: torch.Tensor,
    grid: torch.Tensor,
    output_height: int,
    output_width: int,
    mode: str = "bilinear",
    padding_mode: str = "border",
    align_corners: Optional[bool] = None,
) -> torch.Tensor:
    """Scatter an image through a normalized sampling grid: each input pixel
    adds its value to the destination ``grid`` names, with the weights
    ``grid_sample`` would read it with; contributions accumulate.

    Args:
        input: [N, C, H, W] source values.
        grid: [N, H, W, 2] normalized destinations (x, y) in [-1, 1], with
            ``grid_sample``'s conventions.
        output_height / output_width: the output's size.
        mode: "bilinear" | "bicubic".
        padding_mode: "zeros" | "border" | "reflection".
        align_corners: as for ``grid_sample``; None is False.

    Returns:
        [N, C, output_height, output_width]. f16/bf16 inputs compute, and
        return, float32. Differentiable in ``input`` and ``grid``.
    """
    input = autocast_f32(input)
    grid = autocast_f32(grid)
    _check("grid_scatter", input, grid, mode, padding_mode)
    return _GridScatter.apply(
        input, grid, int(output_height), int(output_width), mode, padding_mode, bool(align_corners)
    )


def grid_scatter_ref(
    input: torch.Tensor,
    grid: torch.Tensor,
    output_height: int,
    output_width: int,
    mode: str = "bilinear",
    padding_mode: str = "border",
    align_corners: Optional[bool] = None,
) -> torch.Tensor:
    """Float64 reference of :func:`grid_scatter`: the transpose of the plain
    sampler, taken by autograd (the gradient of ``grid_sample`` with respect
    to a zero texture, with ``input`` as the cotangent), as the reference's
    ``grid_scatter_ref`` does. Shares no tap construction with the op, and
    is differentiable in ``input`` and ``grid`` by plain autograd. Returns
    ``input``'s dtype."""
    _check("grid_scatter_ref", input, grid, mode, padding_mode)
    n, c = input.shape[:2]
    f64 = torch.float64
    differentiable = torch.is_grad_enabled() and (input.requires_grad or grid.requires_grad)
    with torch.enable_grad():
        tex = torch.zeros((n, c, output_height, output_width), dtype=f64, device=input.device, requires_grad=True)
        sampled = _grid_sample_impl(tex, grid.to(f64), mode, padding_mode, bool(align_corners), "plain")
        (out,) = torch.autograd.grad(sampled, tex, input.to(f64), create_graph=differentiable)
    return out.to(input.dtype)
