"""Mipmapped, anisotropic grid sampling (counterpart of
``drtk_tpu/ops/mipmap_grid_sample.py``).

``grid_sample`` plus OpenGL-spec mip selection and anisotropic filtering
with up to ``max_aniso`` taps along the dominant screen-space axis, with the
JAX package's conventions:

* The pyramid is packed into one texture atlas, the levels side by side
  along the width, so a pixel's mip level is coordinate arithmetic: its
  level's (width, height, x-offset) and one gather into the atlas.
* Every pixel evaluates all ``max_aniso`` taps at both of its levels and
  masks the taps past its count ``N``; the two levels' taps go through ONE
  merged gather (taps ``0..T-1`` at level ``d1``, ``T..2T-1`` at ``d1+1``),
  with the ``(1-a)/N`` and ``a/N`` blend weights folded into the tap sum.
* Bilinear taps (and bicubic with zeros padding) fetch their 2x2 texels as
  one row of a quad table: the atlas, padded with a zero ring at its top
  and left, beside its x-, y- and xy-shifted copies. The fetch is
  :func:`~drtk_tpu_torch.ops.row_gather.row_gather`, so the texture
  gradient is its transpose, kernel B4 on a CUDA tensor: one launch per
  backward, with the taps in their [2T*H, W] shape (``rows_hw``) so that a
  warp of B4 takes neighbouring pixels of one tap plane. The JAX backward's
  split by mip level and its fixed 48 x 512 windows exist for the TPU's
  windowed kernel and do not apply; its rule that taps whose cotangent is
  zero in every channel are dropped holds, as ``row_gather`` drops such
  rows.
* Everything derived from ``vt_dxdy_img`` (level, tap count, offsets and
  weights) is detached: gradients reach the levels and the grid only.

Conventions (``drtk_tpu/ops/mipmap_grid_sample.py:35-46``):
``align_corners`` is False; ``px = sqrt((dudx*W)^2 + (dvdx*H)^2 + 1e-12)``
with W, H of the base level; ``N = min(ceil(p_max/p_min), max_aniso)``,
1 if ``p_min == 0``; ``lambda = log2(p_max / N)``, NaN/Inf to 0, clamped
to ``[0, levels - 1 - 1e-6]``; ``clip_grad`` rescales the uv steps by
``exp2(l) * N / p_max`` where the pyramid is truncated; tap ``i``'s offset
is ``(i+1)/(N+1)*2 - 1`` times the uv step.

Clamps use ``torch.maximum``/``torch.minimum``, whose gradient splits at a
tie as JAX's ``clip`` does, so the grid gradient agrees with the JAX
package's at an exact bound too.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from drtk_tpu_torch import tracing
from drtk_tpu_torch.ops.grid_sample import _cubic_weights, _quad_table, grid_sample
from drtk_tpu_torch.ops.math import autocast_f32
from drtk_tpu_torch.ops.row_gather import row_gather

__all__ = ["mipmap_grid_sample", "mipmap_grid_sample_ref"]

_MAX_MIPMAP_COUNT = 11


def _build_atlas(levels: Sequence[torch.Tensor]):
    """The levels side by side: (atlas [N, C, Ha, Wa], widths, heights,
    x-offsets), the last three lists of ints; y-offsets are 0."""
    hs = [lvl.shape[2] for lvl in levels]
    ws = [lvl.shape[3] for lvl in levels]
    ha = max(hs)
    xoffs = [sum(ws[:i]) for i in range(len(ws))]
    atlas = torch.cat([torch.nn.functional.pad(lvl, (0, 0, 0, ha - lvl.shape[2])) for lvl in levels], dim=3)
    return atlas, ws, hs, xoffs


def _clip(x: torch.Tensor, low, high) -> torch.Tensor:
    """``jnp.clip``: ``minimum(high, maximum(low, x))``, the gradient split
    at a tie."""
    low, high = (b if isinstance(b, torch.Tensor) else x.new_full((), b) for b in (low, high))
    return torch.minimum(high, torch.maximum(low, x))


def _unnormalize_dyn(coord: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> pixel space with a per-pixel size (align_corners=False)."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def _reflect_dyn(x: torch.Tensor, low, high) -> torch.Tensor:
    span = high - low
    span = torch.where(span == 0, torch.ones_like(span), span)
    cc = torch.abs(x - low)
    extra = torch.remainder(cc, span)
    flips = torch.floor(cc / span)
    return torch.where(torch.remainder(flips, 2.0) == 0.0, extra + low, span - extra + low)


def _fold_dyn(x: torch.Tensor, size: torch.Tensor, padding_mode: str) -> torch.Tensor:
    """The padding fold with per-pixel sizes (align_corners=False)."""
    if padding_mode == "border":
        return _clip(x, 0.0, size - 1.0)
    if padding_mode == "reflection":
        return _clip(_reflect_dyn(x, -0.5, size - 0.5), 0.0, size - 1.0)
    return x  # zeros: raw coords, taps bounds-checked at gather time


def _tap_rows_hw(idx: torch.Tensor) -> Tuple[int, int]:
    """``row_gather``'s ``rows_hw`` for an [N, T, H, W] tap index: the
    [T*H, W] grid, so a warp of B4 takes neighbouring pixels of one tap
    plane."""
    return idx.shape[1] * idx.shape[2], idx.shape[3]


def _gather_atlas(atlas, ix, iy, wp, hp, xoff, impl) -> torch.Tensor:
    """``atlas[n, :, iy, xoff + ix]`` for [N, T, H, W] level-local taps,
    0 outside the tap's level. Returns [N, C, T, H, W]."""
    n, c, ha, wa = atlas.shape
    inb = (ix >= 0) & (ix < wp) & (iy >= 0) & (iy < hp)
    ixc = torch.minimum(ix.clamp(min=0), wp - 1) + xoff
    iyc = torch.minimum(iy.clamp(min=0), hp - 1)
    table = atlas.movedim(1, -1).reshape(n, ha * wa, c)
    rows = row_gather(table, (iyc * wa + ixc).reshape(n, -1), (ha, wa), impl, _tap_rows_hw(ix))
    out = rows.reshape(tuple(ix.shape) + (c,)).movedim(-1, 1)
    return torch.where(inb[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def _build_quad_atlas(atlas: torch.Tensor):
    """The quad table: the atlas with a zero ring at its top and left (a
    base one texel outside a level then reads true zeros or the correct
    neighbour), beside its x-, y- and xy-shifted copies. Returns (quad
    [N, (Ha+1)*(Wa+1), 4C], Ha+1, Wa+1)."""
    n, c, ha, wa = atlas.shape
    t = torch.nn.functional.pad(atlas.movedim(1, -1), (0, 0, 1, 0, 1, 0))  # [N, Ha+1, Wa+1, C]
    return _quad_table(t).reshape(n, (ha + 1) * (wa + 1), 4 * c), ha + 1, wa + 1


def _quad_rows(quad_info, by, bx, impl) -> torch.Tensor:
    """Quad rows at [N, T, H, W] bases (always in range): [N, T, H, W, 4C]."""
    quad, hq, wq = quad_info
    rows = row_gather(quad, (by * wq + bx).reshape(by.shape[0], -1), (hq, wq), impl, _tap_rows_hw(by))
    return rows.reshape(tuple(by.shape) + (quad.shape[-1],))


def _sample_level_bilinear(quad_info, u, v, wp, hp, xoff, padding_mode, impl):
    """Bilinear sample at normalized (u, v) of each tap's level (wp, hp,
    xoff): one quad-row gather per tap. All [N, T, H, W]; returns
    [N, C, T, H, W]."""
    quad, hq, wq = quad_info
    c = quad.shape[-1] // 4
    wpf, hpf = wp.to(u.dtype), hp.to(u.dtype)
    x = _fold_dyn(_unnormalize_dyn(u, wpf), wpf, padding_mode)
    y = _fold_dyn(_unnormalize_dyn(v, hpf), hpf, padding_mode)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    tx = x - x0f
    ty = y - y0f
    ix = x0f.to(torch.int32)
    iy = y0f.to(torch.int32)

    bx = torch.clamp(xoff + ix + 1, 0, wq - 1)
    by = torch.clamp(iy + 1, 0, hq - 1)
    rows = _quad_rows(quad_info, by, bx, impl)  # [N, T, H, W, 4C]

    wts = [(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty]
    if padding_mode == "zeros":
        inx0 = (ix >= 0) & (ix < wp)
        inx1 = (ix + 1 >= 0) & (ix + 1 < wp)
        iny0 = (iy >= 0) & (iy < hp)
        iny1 = (iy + 1 >= 0) & (iy + 1 < hp)
        masks = [inx0 & iny0, inx1 & iny0, inx0 & iny1, inx1 & iny1]
        wts = [w * m for w, m in zip(wts, masks)]
    # border/reflection: coords pre-folded into the level, and the +1 taps
    # carry zero weight exactly at the level's edge.
    out = 0.0
    for corner in range(4):
        out = out + rows[..., corner * c : (corner + 1) * c] * wts[corner][..., None].to(rows.dtype)
    return out.movedim(-1, 1)


def _sample_level_bicubic_quad(quad_info, u, v, wp, hp, xoff, padding_mode, impl):
    """Bicubic with zeros padding through the quad table: the 4x4 stencil
    is a 2x2 grid of 2x2 texel blocks, four quad-row gathers; texels outside
    the level get zero weight."""
    quad, hq, wq = quad_info
    c = quad.shape[-1] // 4
    wpf, hpf = wp.to(u.dtype), hp.to(u.dtype)
    x = _unnormalize_dyn(u, wpf)
    y = _unnormalize_dyn(v, hpf)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = _cubic_weights(x - x0f)
    wy = _cubic_weights(y - y0f)
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)

    out = 0.0
    for bj in range(2):
        for bi in range(2):
            ix = x0 + (2 * bi - 1)  # level-local x of the block's corner
            iy = y0 + (2 * bj - 1)
            bx = torch.clamp(xoff + ix + 1, 0, wq - 1)
            by = torch.clamp(iy + 1, 0, hq - 1)
            rows = _quad_rows(quad_info, by, bx, impl)
            for corner, (dx_, dy_) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
                tx = ix + dx_
                ty = iy + dy_
                inb = (tx >= 0) & (tx < wp) & (ty >= 0) & (ty < hp)
                w_c = (wx[2 * bi + dx_] * wy[2 * bj + dy_] * inb)[..., None].to(rows.dtype)
                out = out + rows[..., corner * c : (corner + 1) * c] * w_c
    return out.movedim(-1, 1)


def _sample_level_bicubic(atlas, u, v, wp, hp, xoff, padding_mode, impl):
    """Bicubic (A = -0.75) with border or reflection padding: 16 atlas
    gathers, each tap's coordinate folded on its own."""
    dt = u.dtype
    wpf, hpf = wp.to(dt), hp.to(dt)
    x = _unnormalize_dyn(u, wpf)
    y = _unnormalize_dyn(v, hpf)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = _cubic_weights(x - x0f)
    wy = _cubic_weights(y - y0f)
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)

    def bound(idx, sizef):
        vf = idx.to(dt)
        if padding_mode == "border":
            vf = _clip(vf, 0, sizef - 1)
        elif padding_mode == "reflection":
            vf = _clip(_reflect_dyn(vf, -0.5, sizef - 0.5), 0, sizef - 1)
        return vf.to(torch.int32)

    out = 0.0
    for j in range(4):
        raw_iy = y0 + (j - 1)
        iy = raw_iy if padding_mode == "zeros" else bound(raw_iy, hpf)
        for i in range(4):
            raw_ix = x0 + (i - 1)
            ix = raw_ix if padding_mode == "zeros" else bound(raw_ix, wpf)
            tap = _gather_atlas(atlas, ix, iy, wp, hp, xoff, impl)  # [N, C, T, H, W]
            out = out + tap * (wx[i] * wy[j])[:, None].to(tap.dtype)
    return out


@functools.lru_cache(maxsize=64)
def _level_table(ws: Tuple[int, ...], hs: Tuple[int, ...], xoffs: Tuple[int, ...], device: torch.device):
    """[3, Q] int32 (widths, heights, atlas x-offsets) on ``device``, cached
    so a call copies nothing from the host after the first."""
    return torch.tensor([ws, hs, xoffs], dtype=torch.int32).to(device)


def _level_params(table: torch.Tensor, lvl: torch.Tensor):
    """(width, height, x-offset) of each tap's int64 level ``lvl``."""
    wp, hp, xoff = table[:, lvl]
    return wp, hp, xoff


def _mipmap_grid_sample_impl(levels, grid, vt_dxdy_img, max_aniso, mode, padding_mode, force_max_aniso,
                             clip_grad, impl):
    """``drtk_tpu/ops/mipmap_grid_sample.py:441-585``."""
    q = len(levels)
    n = grid.shape[0]
    dt = grid.dtype
    base_h, base_w = levels[0].shape[2:]
    atlas, ws, hs, xoffs = _build_atlas(levels)
    table = _level_table(tuple(ws), tuple(hs), tuple(xoffs), grid.device)

    # ---- mip selection, not differentiated ----------------------------------
    d = vt_dxdy_img.detach()  # [N, H, W, 2, 2]
    dudx, dvdx = d[..., 0, 0], d[..., 0, 1]
    dudy, dvdy = d[..., 1, 0], d[..., 1, 1]

    px = torch.sqrt((dudx * base_w) ** 2 + (dvdx * base_h) ** 2 + 1e-12)
    py = torch.sqrt((dudy * base_w) ** 2 + (dvdy * base_h) ** 2 + 1e-12)
    p_max = torch.maximum(px, py)
    p_min = torch.minimum(px, py)

    n_taps = torch.clamp(torch.ceil(p_max / p_min), max=float(max_aniso))
    n_taps = torch.where((p_min == 0.0) | (n_taps == 0), torch.ones_like(n_taps), n_taps)

    lam = torch.log2(p_max / n_taps)
    lam = torch.where(torch.isnan(lam) | torch.isinf(lam), torch.zeros_like(lam), lam)

    l = torch.clamp(lam, max=q - 1 - 1e-6)  # noqa: E741
    if clip_grad:
        # Truncated pyramid: rescale the uv steps so the taps stay texel-spaced.
        scaling = torch.where(lam > q - 1, torch.exp2(l) * n_taps / p_max, torch.ones_like(lam))
        dudx, dvdx, dudy, dvdy = dudx * scaling, dvdx * scaling, dudy * scaling, dvdy * scaling

    l = torch.clamp(l, min=0.0)  # noqa: E741
    d1 = torch.floor(l).to(torch.int64)
    a = (l - torch.floor(l)).to(dt)

    # XLA converts NaN to 0, where torch's conversion is undefined.
    n_int = torch.nan_to_num(n_taps, nan=0.0).to(torch.int32)
    if force_max_aniso:
        n_int = torch.full_like(n_int, max_aniso)
    n_f = n_int.to(dt)

    # ---- tap coordinates, taps on axis 1 -------------------------------------
    u = grid[..., 0]
    v = grid[..., 1]
    x_dom = px > py
    du = torch.where(x_dom, dudx, dudy).to(dt)
    dv = torch.where(x_dom, dvdx, dvdy).to(dt)

    i_arr = torch.arange(max_aniso, device=grid.device).to(dt)[None, :, None, None]
    frac = (i_arr + 1.0) / (n_f[:, None] + 1.0) * 2.0 - 1.0  # [N, T, H, W]
    tap_mask = (i_arr < n_f[:, None]).to(dt)
    u_t = u[:, None] + du[:, None] * frac
    v_t = v[:, None] + dv[:, None] * frac

    if mode == "bilinear" or padding_mode == "zeros":
        quad_info = _build_quad_atlas(atlas)
        sampler = _sample_level_bilinear if mode == "bilinear" else _sample_level_bicubic_quad

        def sample(*args):
            return sampler(quad_info, *args, padding_mode, impl)
    else:
        # bicubic border/reflection: per-tap folds break the 2x2 blocks.
        def sample(*args):
            return _sample_level_bicubic(atlas, *args, padding_mode, impl)

    inv_n = 1.0 / n_f
    if q == 1:
        out = sample(u_t, v_t, *_level_params(table, d1[:, None]))
        w_tap = tap_mask * ((1.0 - a) * inv_n)[:, None]
        return (out * w_tap[:, None]).sum(2)

    # One merged gather over both levels: taps 0..T-1 at d1, T..2T-1 at d1+1.
    d2 = torch.clamp(d1 + 1, max=q - 1)
    t = max_aniso
    lvl2 = torch.cat([d1[:, None].expand(n, t, *d1.shape[1:]), d2[:, None].expand(n, t, *d2.shape[1:])], dim=1)
    w_tap = torch.cat([tap_mask * ((1.0 - a) * inv_n)[:, None], tap_mask * (a * inv_n)[:, None]], dim=1)
    out = sample(torch.cat([u_t, u_t], dim=1), torch.cat([v_t, v_t], dim=1), *_level_params(table, lvl2))
    return (out * w_tap[:, None]).sum(2)


def mipmap_grid_sample(
    input: List[torch.Tensor],
    grid: torch.Tensor,
    vt_dxdy_img: torch.Tensor,
    max_aniso: int,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: Optional[bool] = None,
    force_max_aniso: Optional[bool] = False,
    clip_grad: Optional[bool] = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Mipmapped, anisotropic texture sampling.

    Args:
        input: the mip pyramid, a list of [N, C, H_i, W_i] textures, highest
            resolution first; up to 11 levels, which need not halve exactly.
        grid: [N, H_out, W_out, 2] normalized uv field.
        vt_dxdy_img: [N, H_out, W_out, 2, 2] Jacobian of uv with respect to
            the pixel position (rows: d/dx, d/dy), in 0..1 uv units.
        max_aniso: the largest anisotropic tap count.
        mode: "bilinear" | "bicubic".
        padding_mode: "zeros" | "border" | "reflection".
        align_corners: accepted and ignored; the sampling is always
            align_corners=False, as in the JAX package.
        force_max_aniso: always take ``max_aniso`` taps.
        clip_grad: rescale the uv steps where the pyramid is truncated.
        impl: "auto" scatters the texture gradient with kernel B4 on CUDA
            tensors; "plain" uses the plain scatter on any device.

    Returns:
        [N, C, H_out, W_out] filtered samples. Gradients flow to the levels
        and the grid, not to ``vt_dxdy_img``. f16/bf16 inputs compute in
        float32.
    """
    if mode not in ("bilinear", "bicubic"):
        raise ValueError(
            f"mipmap_grid_sample(): only 'bilinear' and 'bicubic' modes are supported but got: '{mode}'"
        )
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(
            "mipmap_grid_sample(): expected padding_mode to be 'zeros', 'border', or 'reflection', "
            f"but got: '{padding_mode}'"
        )
    if not input:
        raise ValueError("mipmap_grid_sample(): empty mip pyramid")
    input = [autocast_f32(lvl) for lvl in input]
    grid = autocast_f32(grid)
    vt_dxdy_img = autocast_f32(vt_dxdy_img)
    if len(input) > _MAX_MIPMAP_COUNT:
        raise ValueError(
            f"mipmap_grid_sample(): at most {_MAX_MIPMAP_COUNT} mip levels are supported, got {len(input)}"
        )
    for lvl in input:
        if lvl.ndim != 4:
            raise ValueError(f"mipmap_grid_sample(): levels must be [N, C, H, W], got {tuple(lvl.shape)}")
    if grid.ndim != 4 or grid.shape[-1] != 2:
        raise ValueError(f"mipmap_grid_sample(): grid must be [N, H, W, 2], got {tuple(grid.shape)}")
    if vt_dxdy_img.ndim != 5 or tuple(vt_dxdy_img.shape[-2:]) != (2, 2):
        raise ValueError(
            f"mipmap_grid_sample(): vt_dxdy_img must be [N, H, W, 2, 2], got {tuple(vt_dxdy_img.shape)}"
        )
    if max_aniso < 1:
        raise ValueError("mipmap_grid_sample(): max_aniso must be >= 1")
    with tracing.span("mipmap_grid_sample") as sp:
        grid, *input = sp.grad_in(grid, *input)
        return sp.grad_out(_mipmap_grid_sample_impl(
            tuple(input), grid, vt_dxdy_img, int(max_aniso), mode, padding_mode, bool(force_max_aniso),
            bool(clip_grad), impl,
        ))


def _mipmap_selection_ref(q, p_max, p_min, max_aniso):
    if max_aniso != 1:
        n_taps = torch.clamp(torch.ceil(p_max / p_min), max=float(max_aniso))
        n_taps = torch.where(torch.isnan(n_taps), torch.ones_like(n_taps), n_taps)
        lam = torch.log2(p_max / n_taps)
    else:
        lam = torch.log2(p_max)
    lam = torch.where(torch.isinf(lam), torch.zeros_like(lam), lam)
    lam = torch.clamp(lam, 0.0, q - 1 - 1e-6)
    d1 = torch.floor(lam).to(torch.int64)
    a = lam - torch.floor(lam)
    return d1, a


def mipmap_grid_sample_ref(
    input: List[torch.Tensor],
    grid: torch.Tensor,
    vt_dxdy_img: torch.Tensor,
    max_aniso: int,
    mode: str = "bilinear",
    padding_mode: str = "border",
    align_corners: Optional[bool] = False,
    high_quality: bool = False,
) -> torch.Tensor:
    """The reference oracle (``drtk_tpu/ops/mipmap_grid_sample.py:692``):
    every level sampled with :func:`grid_sample` at the ``max_aniso`` taps,
    then the two selected levels blended. :func:`mipmap_grid_sample` with
    ``force_max_aniso=True`` and ``clip_grad=False`` matches it with
    ``high_quality=False``."""
    q = len(input)
    base_h, base_w = input[0].shape[2:]
    size = torch.tensor([base_h, base_w], dtype=grid.dtype, device=grid.device)

    d = vt_dxdy_img.detach()
    d_pix = d * size
    px = torch.linalg.vector_norm(d_pix[..., 0, :], dim=-1)
    py = torch.linalg.vector_norm(d_pix[..., 1, :], dim=-1)
    if not high_quality:
        p_max = torch.maximum(px, py)
        p_min = torch.minimum(px, py) if max_aniso != 1 else None
    else:
        s = torch.linalg.svdvals(d_pix)
        p_max, p_min = s[..., 0], s[..., 1]

    d1, a = _mipmap_selection_ref(q, p_max, p_min, max_aniso)

    if max_aniso != 1:
        fracs = [(j + 1.0) / (max_aniso + 1.0) * 2.0 - 1.0 for j in range(max_aniso)]
        if not high_quality:
            step_x, step_y = d[..., 0, :], d[..., 1, :]
            x_dom = (px > py)[..., None]
            uv_ext = [torch.where(x_dom, grid + step_x * f, grid + step_y * f) for f in fracs]
        else:
            _, s_, vh = torch.linalg.svd(d_pix)
            uv_step = (vh[..., 0, :] * s_[..., 0:1]) / size
            uv_ext = [grid + uv_step * f for f in fracs]

    result = []
    for level in input:
        if max_aniso == 1:
            r = grid_sample(level, grid, mode=mode, padding_mode=padding_mode, align_corners=bool(align_corners))
        else:
            taps = [
                grid_sample(level, g, mode=mode, padding_mode=padding_mode, align_corners=bool(align_corners))
                for g in uv_ext
            ]
            r = sum(taps) / max_aniso
        result.append(r)

    if q == 1:
        return result[0]
    stacked = torch.stack(result, dim=-1)  # [N, C, H, W, Q]

    def gather_level(idx):  # [N, H, W] -> [N, C, H, W]
        index = idx[:, None, :, :, None].expand(stacked.shape[:4] + (1,))
        return torch.gather(stacked, -1, index)[..., 0]

    s0 = gather_level(d1)
    s1 = gather_level(torch.clamp(d1 + 1, max=q - 1))
    return s0 + (s1 - s0) * a[:, None].to(s0.dtype)
