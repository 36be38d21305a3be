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

The stencil, with its gather of each pixel's 16-float face row (corners,
normal) by index and, in the backward, the ``bary x g`` rows, is kernel E1
(``csrc/edge_grad.cu``) on a CUDA tensor and :func:`_stencil_plain`, B2's
plain gather and elementwise torch ops, on a CPU tensor
(:func:`edge_grad_stencil`). In the JAX package it is B2's Pallas gather
and XLA that ``jax.jit`` fuses. The backward takes a row tile
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

import ctypes
import operator
from typing import Callable, Optional

import torch
import torch.distributed as dist

from drtk_tpu_torch import _build
from drtk_tpu_torch.ops.math import autocast_f32, epsclamp, next_rank_rows
from drtk_tpu_torch.ops.rasterize import broadcast_vi
from drtk_tpu_torch.ops.render import _face_table, _pixel_grid, _pixels_to_verts
from drtk_tpu_torch.ops.segment_rows import _gather_rows_plain

__all__ = ["edge_grad_estimator", "edge_grad_image"]

# Launches of kernel E1 since the last reset (see
# drtk_tpu_torch.kernel_launch_counts).
launches = 0


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


_C_ENTRY = {torch.float32: "drtk_edge_grad_f32", torch.float64: "drtk_edge_grad_f64"}
_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int32] * 5 + [ctypes.c_int64] * 7 + [ctypes.c_double]
    + [ctypes.c_int32] * 2 + [ctypes.c_void_p]
)
_MAX_BATCH = 65535  # E1 takes the batch from blockIdx.y


def _stencil_plain(
    table, index_img, img, grad_output, bary_img, max_dp_dr: float, y_offset: int = 0, full_height: int = -1
):
    """Plain PyTorch version of kernel E1 (``drtk_tpu/ops/edge_grad.py:
    114-276``): the CRD stencil of the [N, F, 16] ``table`` rows (B2's
    gather, then elementwise ops), the image gradient [N, 3, H, W]; with
    ``bary_img`` the rows ``bary[k] * out[j]`` [N, H, W, 9] instead. With
    ``full_height >= 0`` the block holds rows ``[y_offset, y_offset + H)``
    of a ``full_height``-row frame: the pixel grid takes the global rows and
    stencil centres on global row ``full_height - 1`` are dropped
    (``:259-264``)."""
    dtype = table.dtype
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

    # One packed 16-float row per pixel (corners, normal, 4 zeros);
    # background pixels read zero rows, i.e. degenerate triangles that cover
    # nothing. The R and D rows are shifted slices.
    rows_full = _gather_rows_plain(table, idx)  # [N, H, W, 16]
    rows_c = rows_full[:, :sh, :sw]
    rows_r = rows_full[:, :sh, 1:]
    rows_d = rows_full[:, 1:, :sw]
    pts_c = rows_c[..., :9].reshape(rows_c.shape[:-1] + (3, 3))
    pts_r = rows_r[..., :9].reshape(rows_r.shape[:-1] + (3, 3))
    pts_d = rows_d[..., :9].reshape(rows_d.shape[:-1] + (3, 3))

    px, py = _pixel_grid(sh, sw, y_offset, dtype, table.device)

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

    gvc = torch.stack([gvc_x, gvc_y, gvc_zx + gvc_zy], dim=1)  # [N, 3, sh, sw]
    gvr = torch.stack([gvr_x, zero, gvr_z], dim=1)
    gvd = torch.stack([zero, gvd_y, gvd_z], dim=1)
    if full_height >= 0:
        row_ok = ((torch.arange(sh, device=table.device) + y_offset) < (full_height - 1)).to(dtype)
        row_ok = row_ok[None, None, :, None]
        gvc, gvr, gvd = gvc * row_ok, gvr * row_ok, gvd * row_ok

    # Negated adds into the three stencil positions.
    out = torch.zeros((n, 3, h, w), dtype=dtype, device=table.device)
    out[:, :, :sh, :sw] -= gvc
    out[:, :, :sh, 1:] -= gvr
    out[:, :, 1:, :sw] -= gvd
    if bary_img is None:
        return out
    # interpolate's VJP with bary detached, per pixel: bary x g.
    g_rows = out.movedim(1, -1)  # [N, H, W, 3(coord)]
    bary = bary_img.movedim(1, -1)  # [N, H, W, 3(corner)]
    return (bary[..., :, None] * g_rows[..., None, :]).reshape(n, h, w, 9)


def _rows_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` [N, C, H, W] (or [N, H, W]) itself where its rows are
    contiguous, which E1 reads through its batch and channel strides (a
    band's slice of a frame is), else a contiguous copy."""
    if x.stride(-1) == 1 and (x.shape[-2] <= 1 or x.stride(-2) == x.shape[-1]):
        return x
    return x.contiguous()


def _stencil_cuda(
    table, index_img, img, grad_output, bary_img, max_dp_dr: float, y_offset: int = 0, full_height: int = -1
):
    """Launch kernel E1 on the tensors' device and current stream."""
    if table.dtype not in _C_ENTRY:
        raise TypeError(f"edge_grad stencil: no kernel for {table.dtype} tables")
    if index_img.dtype != torch.int32:
        raise TypeError(f"edge_grad stencil: expected int32 index, got {index_img.dtype}")
    tensors = [table, index_img, img, grad_output] + ([] if bary_img is None else [bary_img])
    if table.device.type != "cuda" or any(t.device != table.device for t in tensors):
        raise ValueError("edge_grad stencil: every tensor must lie on one CUDA device")
    return _launch(
        lambda: _build.entry("edge_grad", _C_ENTRY[table.dtype], _ARGTYPES),
        torch.cuda.current_stream(table.device).cuda_stream,
        table, index_img, img, grad_output, bary_img, max_dp_dr, y_offset, full_height,
    )


def _launch(entry, stream, table, index_img, img, grad_output, bary_img, max_dp_dr, y_offset, full_height):
    """Call E1's C entry (``entry()``, looked up once the limits pass) on
    ``stream`` for tensors of one device whose types
    :func:`_stencil_cuda` checked: the limits, the layouts E1 reads, the
    output and the launch count."""
    global launches
    n, c, h, w = img.shape
    f_cnt = table.shape[1]

    def check_limits(extents):
        if n > _MAX_BATCH or max(extents) >= 2**31:
            raise ValueError(
                f"edge_grad stencil: the kernel takes at most {_MAX_BATCH} batches and 32-bit offsets within a "
                f"batch, got N={n}, C={c}, H={h}, W={w}, F={f_cnt}"
            )

    check_limits([h * w * (9 if bary_img is not None else 3), f_cnt * 16, c * h * w])  # before any copy
    table = table.contiguous()
    if table.data_ptr() % 16:  # E1 reads the rows as 16-byte vectors
        table = table.clone()
    index_img, img, grad_output = _rows_layout(index_img), _rows_layout(img), _rows_layout(grad_output)
    bary_img = None if bary_img is None else _rows_layout(bary_img)
    check_limits([(c - 1) * t.stride(1) + h * w for t in (img, grad_output)]
                 + ([] if bary_img is None else [2 * bary_img.stride(1) + h * w]))
    if bary_img is None:
        out = torch.empty((n, 3, h, w), dtype=table.dtype, device=table.device)
        bary_ptr, bary_sn, bary_sc = None, 0, 0
    else:
        out = torch.empty((n, h, w, 9), dtype=table.dtype, device=table.device)
        bary_ptr, bary_sn, bary_sc = bary_img.data_ptr(), bary_img.stride(0), bary_img.stride(1)
    y_end = h - 1 if full_height < 0 else max(0, min(h - 1, full_height - 1 - y_offset))
    err = entry()(
        table.data_ptr(), index_img.data_ptr(), img.data_ptr(), grad_output.data_ptr(), bary_ptr, out.data_ptr(),
        n, c, h, w, f_cnt, index_img.stride(0), img.stride(0), img.stride(1), grad_output.stride(0),
        grad_output.stride(1), bary_sn, bary_sc, float(max_dp_dr), y_offset, y_end, stream,
    )
    _build.check("edge_grad", err, "edge_grad kernel")
    launches += 1
    return out


def edge_grad_stencil(
    table: torch.Tensor,
    index_img: torch.Tensor,
    img: torch.Tensor,
    grad_output: torch.Tensor,
    bary_img: Optional[torch.Tensor],
    max_dp_dr: float,
    y_offset: int = 0,
    full_height: int = -1,
    impl: str = "auto",
) -> torch.Tensor:
    """The backward's CRD stencil: kernel E1 on CUDA tensors, its plain
    version on CPU tensors or with ``impl="plain"``.

    Args:
        table: [N, F, 16] float32 or float64 stencil rows
            (:func:`_stencil_table`).
        index_img: [N, H, W] int32 index image.
        img, grad_output: [N, C, H, W] image and its cotangent.
        bary_img: [N, 3, H, W] barycentrics for rows mode, or None for
            image mode.
        max_dp_dr: magnitude clamp for dp/dr (0.0 disables it).
        y_offset, full_height: the block's first global row and the frame's
            height on a row tile; ``full_height`` -1 means no row tile.
        impl: "auto" or "plain", as for the other kernels.

    Returns:
        Image mode: the image gradient [N, 3, H, W]. Rows mode: the rows
        ``bary[k] * out[j]`` at ``3k + j``, [N, H, W, 9]. Of the table's
        dtype; ``img``, ``grad_output`` and ``bary_img`` are cast to it.
    """
    dtype = table.dtype
    img, grad_output = img.to(dtype), grad_output.to(dtype)
    bary_img = None if bary_img is None else bary_img.to(dtype)
    if impl == "plain" or (impl == "auto" and table.device.type == "cpu"):
        return _stencil_plain(table, index_img, img, grad_output, bary_img, max_dp_dr, y_offset, full_height)
    if impl == "auto" and table.device.type == "cuda":
        return _stencil_cuda(table, index_img, img, grad_output, bary_img, max_dp_dr, y_offset, full_height)
    raise ValueError(f"edge_grad stencil: impl {impl!r} on device {table.device}")


def _edge_grad_backward(
    v_pix, vi, img, index_img, grad_output, max_dp_dr: float, impl="auto", y_offset: int = 0,
    full_height: int | None = None,
):
    """The image-space gradient [N, 3, H, W] (``drtk_tpu/ops/edge_grad.py:
    114-276``); ``y_offset`` and ``full_height`` as for
    :func:`edge_grad_stencil` (None: no row tile)."""
    return edge_grad_stencil(
        _stencil_table(v_pix, vi), index_img, img, grad_output, None, max_dp_dr, y_offset,
        -1 if full_height is None else full_height, impl,
    )


def _edge_grad_block_rows(v_pix, vi, block, y0: int, height: int, max_dp_dr: float, impl="auto"):
    """The per-pixel ``bary x g`` rows [N, hb+1, W, 9] of a block that
    owns the stencil centres of rows ``[y0, y0 + hb)`` of a ``height``-row
    frame, with its index [N, hb+1, W]. ``block`` = (img, g, bary, index)
    holds those rows and one halo row below them (the stencil's D leg):
    the next rows of the frame, or a background row (zeros, index -1)."""
    img_b, g_b, bary_b, idx_b = block
    rows = edge_grad_stencil(_stencil_table(v_pix, vi), idx_b, img_b, g_b, bary_b, max_dp_dr, y0, height, impl)
    return rows, idx_b


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
            # interpolate's VJP with bary detached: bary x g per pixel (E1's
            # rows), then pixels -> faces (B3, background dropped) -> vertices.
            rows = edge_grad_stencil(
                _stencil_table(v_pix, vi), index_img, img, grad_output, bary_img, ctx.max_dp_dr, impl=ctx.impl
            )
            grad_v_pix = _pixels_to_verts(rows, index_img, vi, v_pix.shape[1], ctx.impl)
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
    group: Optional[dist.ProcessGroup] = None,
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
        impl: "auto" runs kernels E1 and B3 on CUDA tensors; "plain" runs
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
