"""Edge-gradient estimator (counterpart of
:func:`drtk_tpu.ops.edge_grad.edge_grad_estimator`).

The forward pass is the identity on ``img``. The backward pass examines the
Center/Right/Down (CRD) stencil at every pixel with ``x < W-1`` and
``y < H-1``: index discontinuities are classified as overlap, intersection
or adjacent; the image-difference dot ``sum_c (img[nbr] - img[center]) *
0.5 * (g[nbr] + g[center])`` goes to the moving side's x (or y) and, for
intersections, into x/y and z through ``dp_dr`` from projected face normals
(with the ``max_dp_dr`` clamp). The negated contributions form an
[N, 3, H, W] image-space gradient (:func:`edge_grad_image`), which reaches
the vertices through interpolate's VJP with ``bary_img`` detached:
``bary x g`` summed to face rows by kernel B3, then to vertices with
``index_add_``.

The stencil's per-pixel triangle corners and face normals arrive as one
16-float row through kernel B2; the stencil's elementwise math is torch ops,
as it is plain XLA in the JAX package. The backward takes a row tile
(``y_offset``, ``full_height``), as the JAX backward does: the pixel grid
is the global rows, and stencil centres on the frame's last row are
dropped. :func:`~drtk_tpu_torch.parallel.banded.edge_grad_estimator_banded`
runs it band by band. With a process ``group``, the inputs are one rank's
row block of a frame sharded by rows (``drtk_tpu/ops/edge_grad.py:
330-410``): the backward fetches the next rank's first row of ``img``, the
cotangent, ``index_img`` and ``bary_img`` (:func:`~drtk_tpu_torch.ops.math.
next_rank_rows`; the last rank takes a background row) and reduces the
block and that halo row to the rank's part of the vertex gradient.
"""

from __future__ import annotations

import operator
from typing import Callable, Optional

import torch

from drtk_tpu_torch.ops.math import autocast_f32, epsclamp, next_rank_rows
from drtk_tpu_torch.ops.rasterize import broadcast_vi
from drtk_tpu_torch.ops.render import _face_table, _pixel_grid, _pixels_to_verts
from drtk_tpu_torch.ops.segment_rows import gather_rows_by_index

__all__ = ["edge_grad_estimator", "edge_grad_image"]


def _safe_normalize(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(n == 0, torch.ones_like(n), n)


def _pix_in_tri(p0, p1, p2, px, py):
    """Coverage of point (px, py) under the top-left fill rule
    (``drtk_tpu/ops/edge_grad.py:49-81``). p* are [..., 2] tensors
    broadcastable against px/py."""
    v01 = p1 - p0
    v02 = p2 - p0
    v12 = p2 - p1
    den = v01[..., 0] * v02[..., 1] - v01[..., 1] * v02[..., 0]
    sgn = torch.sign(den)

    vp0p_x = px - p0[..., 0]
    vp0p_y = py - p0[..., 1]
    vp1p_x = px - p1[..., 0]
    vp1p_y = py - p1[..., 1]

    b0 = (vp1p_y * v12[..., 0] - vp1p_x * v12[..., 1]) * sgn
    b1 = (vp0p_x * v02[..., 1] - vp0p_y * v02[..., 0]) * sgn
    b2 = (vp0p_y * v01[..., 0] - vp0p_x * v01[..., 1]) * sgn

    def topleft(e, invert):
        pos = (e[..., 1] < 0) | ((e[..., 1] == 0) & (e[..., 0] > 0))
        neg = (e[..., 1] > 0) | ((e[..., 1] == 0) & (e[..., 0] < 0))
        if invert:
            pos, neg = neg, pos
        return torch.where(den > 0, pos, neg)

    tl0 = topleft(v12, False)
    tl1 = topleft(v02, True)
    tl2 = topleft(v01, False)

    inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
    reject = ((b0 == 0) & ~tl0) | ((b1 == 0) & ~tl1) | ((b2 == 0) & ~tl2)
    return inside & ~reject & (den != 0)


def _get_dp_dr(n_varying, n_fixed, max_dp_dr: float):
    """``get_dp_dr`` (``drtk_tpu/ops/edge_grad.py:84-103``): n_varying /
    n_fixed are [..., 2] projected face normals (XZ or YZ plane); returns
    [..., 2], the factors that spread grad_dot."""
    nv = _safe_normalize(n_varying)
    nf = _safe_normalize(n_fixed)
    b_x = -nf[..., 1]
    b_y = nf[..., 0]
    d = b_x * nv[..., 0] + b_y * nv[..., 1]
    if max_dp_dr > 0:
        abs_bx_over_m = torch.abs(b_x) / max_dp_dr
        sign_d = torch.where(d >= 0, 1.0, -1.0).to(d.dtype)
        safe_d = sign_d * epsclamp(torch.maximum(torch.abs(d), abs_bx_over_m))
        scale = b_x / safe_d
    else:
        scale = b_x / epsclamp(d)
    return scale[..., None] * nv


def _face_normals(v_pix: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
    """Per-face normals ``normalize(cross(p0 - p2, p1 - p0))``, [N, F, 3]."""
    n = v_pix.shape[0]
    f = _face_table(v_pix, vi).reshape(n, -1, 3, 3)
    p0, p1, p2 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    return _safe_normalize(torch.linalg.cross(p0 - p2, p1 - p0, dim=-1))


def _stencil_table(v_pix: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
    """[N, F, 16] face rows of the CRD stencil: the corners (9), the normal
    (3) and 4 zeros."""
    n = v_pix.shape[0]
    return torch.cat(
        [_face_table(v_pix, vi), _face_normals(v_pix, vi), v_pix.new_zeros((n, vi.shape[1], 4))], dim=-1
    )


def _edge_grad_backward(
    v_pix, vi, img, index_img, grad_output, max_dp_dr: float, impl="auto", y_offset: int = 0,
    full_height: int | None = None,
):
    """The image-space gradient [N, 3, H, W] (``drtk_tpu/ops/edge_grad.py:
    114-276``). With ``full_height``, the block holds rows
    ``[y_offset, y_offset + H)`` of a ``full_height``-row frame: the pixel
    grid takes the global rows and stencil centres on global row
    ``full_height - 1`` are dropped (``:259-264``)."""
    dtype = v_pix.dtype
    n, c, h, w = img.shape
    sh, sw = h - 1, w - 1

    idx = index_img
    c_idx = idx[:, :sh, :sw]
    r_idx = idx[:, :sh, 1:]
    d_idx = idx[:, 1:, :sw]
    c_valid = c_idx >= 0
    r_valid = r_idx >= 0
    d_valid = d_idx >= 0
    lr_diff = c_idx != r_idx
    ud_diff = c_idx != d_idx
    x_both = c_valid & r_valid
    y_both = c_valid & d_valid

    # One packed 16-float row per pixel (corners, normal, 4 zeros) through
    # kernel B2; background pixels read zero rows, i.e. degenerate
    # triangles that cover nothing. The R and D rows are shifted slices.
    rows_full = gather_rows_by_index(_stencil_table(v_pix, vi), idx, impl)  # [N, H, W, 16]
    rows_c = rows_full[:, :sh, :sw]
    rows_r = rows_full[:, :sh, 1:]
    rows_d = rows_full[:, 1:, :sw]
    pts_c = rows_c[..., :9].reshape(rows_c.shape[:-1] + (3, 3))
    pts_r = rows_r[..., :9].reshape(rows_r.shape[:-1] + (3, 3))
    pts_d = rows_d[..., :9].reshape(rows_d.shape[:-1] + (3, 3))

    px, py = _pixel_grid(sh, sw, y_offset, dtype, v_pix.device)

    def in_tri(pts, ox, oy):
        return _pix_in_tri(pts[..., 0, :2], pts[..., 1, :2], pts[..., 2, :2], px + ox, py + oy)

    center_in_right = lr_diff & x_both & in_tri(pts_r, 0.0, 0.0)
    right_in_center = lr_diff & x_both & in_tri(pts_c, 1.0, 0.0)
    center_in_down = ud_diff & y_both & in_tri(pts_d, 0.0, 0.0)
    down_in_center = ud_diff & y_both & in_tri(pts_c, 0.0, 1.0)

    l_over_r = center_in_right & ~right_in_center
    r_over_l = right_in_center & ~center_in_right
    u_over_d = center_in_down & ~down_in_center
    d_over_u = down_in_center & ~center_in_down
    horiz_int = center_in_right & right_in_center
    vert_int = center_in_down & down_in_center
    horiz_adj = lr_diff & x_both & ~center_in_right & ~right_in_center
    vert_adj = ud_diff & y_both & ~center_in_down & ~down_in_center

    g = grad_output
    gdx = ((img[:, :, :sh, 1:] - img[:, :, :sh, :sw]) * (0.5 * (g[:, :, :sh, 1:] + g[:, :, :sh, :sw]))).sum(1)
    gdy = ((img[:, :, 1:, :sw] - img[:, :, :sh, :sw]) * (0.5 * (g[:, :, 1:, :sw] + g[:, :, :sh, :sw]))).sum(1)
    gdx = torch.where(lr_diff, gdx, 0.0)
    gdy = torch.where(ud_diff, gdy, 0.0)

    n_c = rows_c[..., 9:12]
    n_r = rows_r[..., 9:12]
    n_d = rows_d[..., 9:12]
    xz = [0, 2]
    yz = [1, 2]
    dpx_c = _get_dp_dr(n_c[..., xz], n_r[..., xz], max_dp_dr)  # center moves, right fixed
    dpx_r = _get_dp_dr(n_r[..., xz], n_c[..., xz], max_dp_dr)
    dpy_c = _get_dp_dr(n_c[..., yz], n_d[..., yz], max_dp_dr)
    dpy_d = _get_dp_dr(n_d[..., yz], n_c[..., yz], max_dp_dr)

    zero = torch.zeros_like(gdx)
    # horizontal: non-intersection, then intersection
    gvc_x = torch.where(~horiz_int & ~(~c_valid | r_over_l | horiz_adj), gdx, zero)
    gvr_x = torch.where(~horiz_int & ~(~r_valid | l_over_r | horiz_adj), gdx, zero)
    gvc_x = gvc_x + torch.where(horiz_int, gdx * dpx_c[..., 0], zero)
    gvc_zx = torch.where(horiz_int, gdx * dpx_c[..., 1], zero)
    gvr_x = gvr_x + torch.where(horiz_int, gdx * dpx_r[..., 0], zero)
    gvr_z = torch.where(horiz_int, gdx * dpx_r[..., 1], zero)
    # vertical: non-intersection, then intersection
    gvc_y = torch.where(~vert_int & ~(~c_valid | d_over_u | vert_adj), gdy, zero)
    gvd_y = torch.where(~vert_int & ~(~d_valid | u_over_d | vert_adj), gdy, zero)
    gvc_y = gvc_y + torch.where(vert_int, gdy * dpy_c[..., 0], zero)
    gvc_zy = torch.where(vert_int, gdy * dpy_c[..., 1], zero)
    gvd_y = gvd_y + torch.where(vert_int, gdy * dpy_d[..., 0], zero)
    gvd_z = torch.where(vert_int, gdy * dpy_d[..., 1], zero)

    gvc = torch.stack([gvc_x, gvc_y, gvc_zx + gvc_zy], dim=1).to(dtype)  # [N, 3, sh, sw]
    gvr = torch.stack([gvr_x, zero, gvr_z], dim=1).to(dtype)
    gvd = torch.stack([zero, gvd_y, gvd_z], dim=1).to(dtype)
    if full_height is not None:
        row_ok = ((torch.arange(sh, device=v_pix.device) + y_offset) < (full_height - 1)).to(dtype)[None, None, :, None]
        gvc, gvr, gvd = gvc * row_ok, gvr * row_ok, gvd * row_ok

    # Negated adds into the three stencil positions.
    out = torch.zeros((n, 3, h, w), dtype=dtype, device=v_pix.device)
    out[:, :, :sh, :sw] -= gvc
    out[:, :, :sh, 1:] -= gvr
    out[:, :, 1:, :sw] -= gvd
    return out


def _edge_grad_block_rows(v_pix, vi, block, y0: int, height: int, max_dp_dr: float, impl="auto"):
    """The per-pixel ``bary x g`` rows [N, hb+1, W, 9] of a block that
    owns the stencil centres of rows ``[y0, y0 + hb)`` of a ``height``-row
    frame, with its index [N, hb+1, W]. ``block`` = (img, g, bary, index)
    holds those rows and one halo row below them (the stencil's D leg):
    the next rows of the frame, or a background row (zeros, index -1)."""
    img_b, g_b, bary_b, idx_b = block
    gv_img = _edge_grad_backward(
        v_pix, vi, img_b, idx_b, g_b, max_dp_dr, impl, y_offset=y0, full_height=height
    )  # [N, 3, hb+1, W]
    g = gv_img.movedim(1, -1)  # [N, hb+1, W, 3(coord)]
    bary = bary_b.movedim(1, -1).to(g.dtype)  # [N, hb+1, W, 3(corner)]
    n, rows, w, _ = g.shape
    return (bary[..., :, None] * g[..., None, :]).reshape(n, rows, w, 9), idx_b


class _EdgeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_pix, vi, bary_img, img, index_img, max_dp_dr, impl):
        ctx.save_for_backward(v_pix, vi, bary_img, img, index_img)
        ctx.max_dp_dr, ctx.impl = max_dp_dr, impl
        return img.view_as(img)

    @staticmethod
    def backward(ctx, grad_output):
        """Mirrors ``drtk_tpu/ops/edge_grad.py:288-318``."""
        v_pix, vi, bary_img, img, index_img = ctx.saved_tensors
        grad_v_pix = None
        if ctx.needs_input_grad[0]:
            n, h, w = index_img.shape
            g_img = _edge_grad_backward(v_pix, vi, img, index_img, grad_output, ctx.max_dp_dr, ctx.impl)
            # interpolate's VJP with bary detached: bary x g per pixel, then
            # pixels -> faces (B3, background dropped) -> vertices.
            g = g_img.movedim(1, -1)  # [N, H, W, 3(coord)]
            bary = bary_img.movedim(1, -1).to(g.dtype)  # [N, H, W, 3(corner)]
            contrib = (bary[..., :, None] * g[..., None, :]).reshape(n, h, w, 9)
            grad_v_pix = _pixels_to_verts(contrib, index_img, vi, v_pix.shape[1], ctx.impl)
        grad_img = grad_output if ctx.needs_input_grad[3] else None
        return grad_v_pix, None, None, grad_img, None, None, None


class _EdgeGradSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_pix, vi, bary_img, img, index_img, max_dp_dr, impl, group, y_offset, full_height):
        ctx.save_for_backward(v_pix, vi, bary_img, img, index_img)
        ctx.max_dp_dr, ctx.impl, ctx.group = max_dp_dr, impl, group
        ctx.y_offset, ctx.full_height = y_offset, full_height
        return img.view_as(img)

    @staticmethod
    def backward(ctx, grad_output):
        """``drtk_tpu/ops/edge_grad.py:343-410``: the block and the next
        rank's first row, reduced to this rank's part of the vertex
        gradient; the sum over the group is the replicated input's (see
        :func:`~drtk_tpu_torch.ops.math.psum_cotangent`)."""
        v_pix, vi, bary_img, img, index_img = ctx.saved_tensors
        grad_v_pix = None
        if ctx.needs_input_grad[0]:
            grad_output = grad_output.contiguous()
            block = (img, grad_output, bary_img, index_img)
            firsts = [img[:, :, :1], grad_output[:, :, :1], bary_img[:, :, :1], index_img[:, :1]]
            halo = next_rank_rows(firsts, (0, 0, 0, -1), ctx.group)
            ext = [torch.cat([b, h], dim=2 if b.ndim == 4 else 1) for b, h in zip(block, halo)]
            rows, idx_ext = _edge_grad_block_rows(
                v_pix, vi, ext, ctx.y_offset, ctx.full_height, ctx.max_dp_dr, ctx.impl
            )
            grad_v_pix = _pixels_to_verts(rows, idx_ext, vi, v_pix.shape[1], ctx.impl)
        grad_img = grad_output if ctx.needs_input_grad[3] else None
        return grad_v_pix, None, None, grad_img, None, None, None, None, None, None


def edge_grad_estimator(
    v_pix: torch.Tensor,
    vi: torch.Tensor,
    bary_img: torch.Tensor,
    img: torch.Tensor,
    index_img: torch.Tensor,
    v_pix_img_hook: Optional[Callable[[torch.Tensor], None]] = None,
    max_dp_dr: float = 1e4,
    impl: str = "auto",
    group=None,
    y_offset: int = 0,
    full_height: int | None = None,
) -> torch.Tensor:
    """Make the rasterized image differentiable at visibility discontinuities.

    Returns ``img`` unchanged in the forward pass; the backward adds the
    discontinuity gradient to ``v_pix`` (see the module docstring).

    Args:
        v_pix: [N, V, 3] pixel-space positions (x_pix, y_pix, z_cam).
        vi: [N, F, 3] or [F, 3] int32 face indices.
        bary_img: [N, 3, H, W] barycentrics (detached).
        img: [N, C, H, W] rendered image, corresponding exactly to
            index_img/bary_img.
        index_img: [N, H, W] int32 index image.
        v_pix_img_hook: unsupported, as in the JAX package; call
            :func:`edge_grad_image` for the image-space gradient instead.
        max_dp_dr: magnitude clamp for dp/dr (0.0 disables it).
        impl: "auto" runs kernels B2 and B3 on CUDA tensors; "plain" runs
            their plain versions on any device.
        group: a ``torch.distributed`` process group whose ranks hold
            consecutive row blocks of one frame, in rank order (the "pix"
            group of :func:`~drtk_tpu_torch.parallel.sharding.make_mesh`);
            the inputs are this rank's block. The backward exchanges one
            halo row with the next rank and returns this rank's part of
            the vertex gradient: enter ``v_pix`` through
            :func:`~drtk_tpu_torch.ops.math.psum_cotangent` over ``group``
            (as :func:`~drtk_tpu_torch.parallel.spmd.
            make_row_sharded_forward` does) to sum the parts. Requires
            ``full_height``.
        y_offset: the global row of the block's first row (with ``group``).
        full_height: the frame's height (with ``group``).

    Returns:
        ``img`` (float32 if it was f16/bf16).
    """
    if v_pix_img_hook is not None:
        raise NotImplementedError("edge_grad_estimator: v_pix_img_hook is not supported")
    v_pix = autocast_f32(v_pix)
    bary_img = autocast_f32(bary_img)
    img = autocast_f32(img)
    vi = broadcast_vi(vi, v_pix.shape[0])
    if group is None:
        return _EdgeGrad.apply(v_pix, vi, bary_img.detach(), img, index_img, float(max_dp_dr), impl)
    if full_height is None:
        raise ValueError("edge_grad_estimator: full_height is required with group")
    y_offset, full_height = operator.index(y_offset), operator.index(full_height)
    if y_offset < 0 or y_offset + index_img.shape[1] > full_height:
        raise ValueError(
            f"edge_grad_estimator: rows [{y_offset}, {y_offset + index_img.shape[1]}) do not lie in a frame of "
            f"{full_height} rows"
        )
    return _EdgeGradSharded.apply(
        v_pix, vi, bary_img.detach(), img, index_img, float(max_dp_dr), impl, group, y_offset, full_height
    )


def edge_grad_image(
    v_pix: torch.Tensor,
    vi: torch.Tensor,
    img: torch.Tensor,
    index_img: torch.Tensor,
    d_img: torch.Tensor,
    max_dp_dr: float = 1e4,
    impl: str = "auto",
) -> torch.Tensor:
    """The image-space edge gradient [N, 3, H, W] of the upstream image
    cotangent ``d_img``, before the pixel-to-vertex reduction: the value the
    reference DRTK's ``v_pix_img_hook`` observes as ``v_pix_img.grad``
    (``drtk_tpu/ops/edge_grad.py:496-515``). Not differentiable."""
    vi = broadcast_vi(vi, v_pix.shape[0])
    with torch.no_grad():
        return _edge_grad_backward(
            autocast_f32(v_pix), vi, autocast_f32(img), index_img, autocast_f32(d_img), float(max_dp_dr), impl
        )
