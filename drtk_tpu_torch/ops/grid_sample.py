"""2-D grid sampling with ``torch.nn.functional.grid_sample`` semantics
(counterpart of ``drtk_tpu/ops/grid_sample.py``).

Written as gathers and elementwise math, as in the JAX package: bilinear
fetches its four taps as one row of a "quad table" (the texture beside its
x-, y- and xy-shifted copies), nearest rounds half to even, bicubic uses
cubic convolution with A = -0.75. No library grid sampler is called; the
sums are elementwise products and adds, so no matrix unit or TF32 enters.

Every texel fetch goes through :func:`~drtk_tpu_torch.ops.row_gather.row_gather`,
so the texture gradient is its transpose, the row scatter (kernel B4 on the
card, 12-float quad rows for a 3-channel bilinear texture), built only when
the texture is differentiated. Each fetch passes the sampling grid's
(Hg, Wg) shape as ``rows_hw``, so B4 groups neighbouring pixels' taps.
Autograd carries the rest: the grid gradient through the interpolation
weights, and the quad table's shifted copies back onto the texture. At an
exact clamp bound (a folded coordinate equal to 0 or size - 1)
``torch.clamp`` passes the whole gradient where JAX's clip splits it
0.5/0.5; the parity tests keep their grids off those bounds.
"""

from __future__ import annotations

import torch

from drtk_tpu_torch import tracing
from drtk_tpu_torch.ops.math import autocast_f32
from drtk_tpu_torch.ops.row_gather import row_gather

__all__ = ["grid_sample"]


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """[-1, 1] -> pixel index space."""
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _reflect(coord: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """Reflect ``coord`` into [low, high]."""
    if low == high:
        return torch.zeros_like(coord)
    span = high - low
    c = torch.abs(coord - low)
    extra = torch.remainder(c, span)
    flips = torch.floor(c / span)
    return torch.where(torch.remainder(flips, 2.0) == 0.0, extra + low, span - extra + low)


def _compute_source_index(
    coord: torch.Tensor, size: int, padding_mode: str, align_corners: bool
) -> torch.Tensor:
    """Unnormalize, then fold by the padding mode."""
    x = _unnormalize(coord, size, align_corners)
    if padding_mode == "border":
        x = torch.clamp(x, 0.0, size - 1)
    elif padding_mode == "reflection":
        if align_corners:
            x = _reflect(x, 0.0, float(size - 1))
        else:
            x = _reflect(x, -0.5, size - 0.5)
        x = torch.clamp(x, 0.0, size - 1)
    return x


def _tap_grid(coord: torch.Tensor):
    """The (Hg, Wg) sampling grid that an [N, Hg, Wg] coordinate flattens to
    its taps (``row_gather``'s ``rows_hw``); None, the flat order, for a grid
    of another rank."""
    return tuple(coord.shape[1:]) if coord.ndim == 3 else None


def _gather_2d(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, zero_fill: bool, impl: str) -> torch.Tensor:
    """img[n, :, iy, ix] -> [N, C, *S]. With ``zero_fill``, out-of-bounds
    taps give 0; otherwise the indices are assumed in range."""
    n, c, h, w = img.shape
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    ixc = torch.clamp(ix, 0, w - 1)
    iyc = torch.clamp(iy, 0, h - 1)
    rows_img = img.movedim(1, -1).reshape(n, h * w, c)
    out = row_gather(rows_img, (iyc * w + ixc).reshape(n, -1), (h, w), impl, _tap_grid(ix))  # [N, S, C]
    out = out.movedim(-1, 1).reshape((n, c) + tuple(ix.shape[1:]))
    if zero_fill:
        out = torch.where(inb[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def _quad_table(t: torch.Tensor) -> torch.Tensor:
    """A channels-last texture [..., H, W, C] beside its x-, y- and
    xy-shifted copies, zero past the last column and row: [..., H, W, 4C],
    so that one row holds a bilinear tap's 2x2 texels."""
    tx1 = torch.cat([t[..., 1:, :], torch.zeros_like(t[..., :1, :])], -2)
    ty1 = torch.cat([t[..., 1:, :, :], torch.zeros_like(t[..., :1, :, :])], -3)
    txy = torch.cat([ty1[..., 1:, :], torch.zeros_like(t[..., :1, :])], -2)
    return torch.cat([t, tx1, ty1, txy], -1)


def _cubic_weights(t: torch.Tensor, a: float = -0.75):
    """Cubic convolution weights for the taps at offsets -1, 0, 1, 2."""
    t2 = t * t
    t3 = t2 * t
    w0 = a * (t3 - 2 * t2 + t)
    w1 = (a + 2) * t3 - (a + 3) * t2 + 1
    w2 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w3 = a * (t2 - t3)
    return w0, w1, w2, w3


def _grid_sample_impl(input, grid, mode, padding_mode, align_corners, impl):
    n, c, h, w = input.shape
    gx = grid[..., 0]
    gy = grid[..., 1]
    zeros = padding_mode == "zeros"

    if mode == "nearest":
        x = _compute_source_index(gx, w, padding_mode, align_corners)
        y = _compute_source_index(gy, h, padding_mode, align_corners)
        ix = torch.round(x).to(torch.int32)  # round half to even, as nearbyint
        iy = torch.round(y).to(torch.int32)
        return _gather_2d(input, ix, iy, zeros, impl)

    if mode == "bilinear":
        x = _compute_source_index(gx, w, padding_mode, align_corners)
        y = _compute_source_index(gy, h, padding_mode, align_corners)
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        tx = x - x0
        ty = y - y0
        ix0 = x0.to(torch.int32)
        iy0 = y0.to(torch.int32)

        t = input.movedim(1, -1)  # [N, H, W, C]
        if zeros:
            # One zero ring, so an in-range base at the border reads true
            # zeros; taps fully out of range are masked below.
            t = torch.nn.functional.pad(t, (0, 0, 1, 1, 1, 1))
            bx = torch.clamp(ix0 + 1, 0, w)
            by = torch.clamp(iy0 + 1, 0, h)
        else:
            # Folded coordinates lie in [0, size-1]; the +1 taps get nonzero
            # weight only strictly inside, so zero-filled shifts suffice.
            bx = torch.clamp(ix0, 0, w - 1)
            by = torch.clamp(iy0, 0, h - 1)
        hq, wq = t.shape[1], t.shape[2]
        quad = _quad_table(t).reshape(n, hq * wq, 4 * c)

        rows = row_gather(quad, (by * wq + bx).reshape(n, -1), (hq, wq), impl, _tap_grid(by))
        rows = rows.reshape(tuple(ix0.shape) + (4, c))

        wts = [(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty]
        if zeros:
            inb_x0 = (ix0 >= 0) & (ix0 < w)
            inb_x1 = (ix0 + 1 >= 0) & (ix0 + 1 < w)
            inb_y0 = (iy0 >= 0) & (iy0 < h)
            inb_y1 = (iy0 + 1 >= 0) & (iy0 + 1 < h)
            masks = [inb_x0 & inb_y0, inb_x1 & inb_y0, inb_x0 & inb_y1, inb_x1 & inb_y1]
            wts = [wt * m for wt, m in zip(wts, masks)]
        wts = [wt.to(rows.dtype)[..., None] for wt in wts]
        out = ((rows[..., 0, :] * wts[0] + rows[..., 1, :] * wts[1]) + rows[..., 2, :] * wts[2]) + rows[
            ..., 3, :
        ] * wts[3]
        return out.movedim(-1, 1)

    # bicubic: unnormalize without the padding fold, then bound each tap.
    x = _unnormalize(gx, w, align_corners)
    y = _unnormalize(gy, h, align_corners)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = _cubic_weights(x - x0)
    wy = _cubic_weights(y - y0)
    ix0 = x0.to(torch.int32)
    iy0 = y0.to(torch.int32)

    def bound(v, size):
        vf = v.to(x.dtype)
        if padding_mode == "border":
            vf = torch.clamp(vf, 0, size - 1)
        elif padding_mode == "reflection":
            if align_corners:
                vf = _reflect(vf, 0.0, float(size - 1))
            else:
                vf = _reflect(vf, -0.5, size - 0.5)
            vf = torch.clamp(vf, 0, size - 1)
        return vf.to(torch.int32)

    out = 0.0
    for j in range(4):
        raw_iy = iy0 + (j - 1)
        row = 0.0
        for i in range(4):
            raw_ix = ix0 + (i - 1)
            if zeros:
                tap = _gather_2d(input, raw_ix, raw_iy, True, impl)
            else:
                tap = _gather_2d(input, bound(raw_ix, w), bound(raw_iy, h), False, impl)
            row = row + tap * wx[i][:, None]
        out = out + row * wy[j][:, None]
    return out


def grid_sample(
    input: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Sample ``input`` at normalized ``grid`` locations, with the semantics
    of ``torch.nn.functional.grid_sample`` (2-D).

    Args:
        input: [N, C, H, W] texture.
        grid: [N, Hg, Wg, 2] normalized coordinates in [-1, 1];
            ``grid[..., 0]`` is x (width), ``grid[..., 1]`` is y (height).
        mode: "bilinear" | "nearest" | "bicubic".
        padding_mode: "zeros" | "border" | "reflection".
        align_corners: corner-alignment convention.
        impl: "auto" scatters the texture gradient with kernel B4 on CUDA
            tensors; "plain" uses the plain scatter on any device.

    Returns:
        [N, C, Hg, Wg] samples. f16/bf16 inputs compute in float32.
    """
    input = autocast_f32(input)
    grid = autocast_f32(grid)
    if input.ndim != 4:
        raise ValueError(f"grid_sample: expected [N, C, H, W] input, got {tuple(input.shape)}")
    if grid.shape[-1] != 2:
        raise ValueError(f"grid_sample: expected grid[..., 2], got {tuple(grid.shape)}")
    if mode not in ("bilinear", "nearest", "bicubic"):
        raise ValueError(f"grid_sample: unknown mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample: unknown padding_mode {padding_mode!r}")
    with tracing.span("grid_sample") as sp:
        input, grid = sp.grad_in(input, grid)
        return sp.grad_out(_grid_sample_impl(input, grid, mode, padding_mode, bool(align_corners), impl))
