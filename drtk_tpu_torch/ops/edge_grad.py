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
the vertices through interpolate's VJP with ``bary_img`` detached: ``bary x
g`` summed to each pixel's face, then to its three vertices.

The whole backward, from index image to vertex gradient, is kernel E1
(``csrc/edge_grad.cu``) on a CUDA tensor, one launch
(:func:`edge_grad_to_verts`): each stencil centre sends its nonzero parts
through its pixels' faces to the vertices with atomics, reading the corners
through ``vi``. On a CPU tensor it is the plain version: the [N, F, 16]
stencil table (corners, normal), :func:`_stencil_plain` (B2's plain gather
and elementwise torch ops) for the per-pixel ``bary x g`` rows, then B3's
plain scatter to faces and ``index_add_`` to vertices. In the JAX package it
is B2's Pallas gather and XLA that ``jax.jit`` fuses, then B3's Pallas
accumulate and a scatter. The backward takes a row tile (``y_offset``,
``full_height``), as the JAX backward does: the pixel grid is the global
rows, and stencil centres on the frame's last row are dropped.
:func:`~drtk_tpu_torch.parallel.banded.edge_grad_estimator_banded` runs it
band by band into one accumulator. With a process ``group``, the inputs are
one rank's row block of a frame sharded by rows (``drtk_tpu/ops/
edge_grad.py:330-410``): the backward fetches the next rank's first row of
``img``, the cotangent, ``index_img`` and ``bary_img``
(:func:`~drtk_tpu_torch.ops.math.next_rank_rows`; the last rank takes a
background row) and reduces the block and that halo row to the rank's part
of the vertex gradient.
"""

from __future__ import annotations

import ctypes
import operator
from typing import Callable, Optional

import torch
import torch.distributed as dist

from drtk_tpu_torch import _build, tracing
from drtk_tpu_torch.ops.math import autocast_f32, epsclamp, next_rank_rows
from drtk_tpu_torch.ops.rasterize import broadcast_vi
from drtk_tpu_torch.ops.render import _face_table, _pixel_grid, _pixels_to_verts
from drtk_tpu_torch.ops.segment_rows import _gather_rows_plain

__all__ = ["edge_grad_estimator", "edge_grad_image", "edge_grad_to_verts"]


def _safe_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / |x|`` over the last axis (``x`` where ``|x|`` is 0). The norm is
    the square root of the squares summed in axis order, each op rounded on
    its own, as kernel E1 computes it (``torch.linalg.vector_norm`` sums in
    another order, or in float64 on the CPU)."""
    sq = x * x
    total = sq[..., 0]
    for i in range(1, x.shape[-1]):
        total = total + sq[..., i]
    n = torch.sqrt(total)[..., None]
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
    """Per-face normals ``normalize(cross(p0 - p2, p1 - p0))``, [N, F, 3].
    The cross product's products and differences are rounded each on its
    own, as kernel E1 computes them (``torch.linalg.cross`` may contract
    them into FMAs)."""
    n = v_pix.shape[0]
    f = _face_table(v_pix, vi).reshape(n, -1, 3, 3)
    a, b = f[..., 0, :] - f[..., 2, :], f[..., 1, :] - f[..., 0, :]
    cross = torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1], a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)
    return _safe_normalize(cross)


def _stencil_table(v_pix: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
    """[N, F, 16] face rows of the CRD stencil: the corners (9), the normal
    (3) and 4 zeros."""
    n = v_pix.shape[0]
    return torch.cat(
        [_face_table(v_pix, vi), _face_normals(v_pix, vi), v_pix.new_zeros((n, vi.shape[1], 4))], dim=-1
    )


class _Shape(ctypes.Structure):
    """E1's launch scalars (``struct Shape`` of ``csrc/edge_grad.cu``):
    extents, batch strides, the channel, row and column strides of img,
    the cotangent and bary (in elements), max_dp_dr, y_offset, y_end."""

    _fields_ = (
        [(k, ctypes.c_int32) for k in ("n_batch", "c_dim", "h", "w", "n_verts", "n_faces")]
        + [(k, ctypes.c_int64) for k in ("v_sn", "vi_sn", "idx_sn", "img_sn", "grad_sn", "bary_sn")]
        + [(f"{t}_{k}", ctypes.c_int32) for t in ("img", "grad", "bary") for k in ("sc", "sh", "sw")]
        + [("max_dp_dr", ctypes.c_double), ("y_offset", ctypes.c_int32), ("y_end", ctypes.c_int32)]
    )


_C_ENTRY = {torch.float32: "drtk_edge_grad_f32", torch.float64: "drtk_edge_grad_f64"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.POINTER(_Shape), ctypes.c_void_p]
_MAX_BATCH = 65535  # E1 takes the batch from blockIdx.y


def _stencil_plain(
    table, index_img, img, grad_output, bary_img, max_dp_dr: float, y_offset: int = 0, full_height: int = -1
):
    """The CRD stencil in plain PyTorch (``drtk_tpu/ops/edge_grad.py:
    114-276``) of the [N, F, 16] ``table`` rows (B2's gather, then
    elementwise ops): the image gradient [N, 3, H, W], which is E1's image
    mode; with ``bary_img`` the per-pixel rows ``bary[k] * out[j]``
    [N, H, W, 9] instead, which :func:`_verts_plain` reduces to vertices.
    With ``full_height >= 0`` the block holds rows ``[y_offset, y_offset +
    H)`` of a ``full_height``-row frame: the pixel grid takes the global
    rows and stencil centres on global row ``full_height - 1`` are dropped
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


def _verts_plain(
    v_pix, vi, index_img, img, grad_output, bary_img, max_dp_dr: float, y_offset: int = 0, full_height: int = -1
):
    """Plain PyTorch version of E1's verts mode (``drtk_tpu/ops/
    edge_grad.py:288-318``): the stencil table, :func:`_stencil_plain`'s
    per-pixel rows, then B3's plain scatter to face rows (background
    dropped, index clamped to F - 1) and ``index_add_`` to the vertices
    (ids clamped to V - 1). [N, V, 3]."""
    rows = _stencil_plain(
        _stencil_table(v_pix, vi), index_img, img, grad_output, bary_img, max_dp_dr, y_offset, full_height
    )
    return _pixels_to_verts(rows, index_img, vi, v_pix.shape[1], "plain")


def _rows_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where its last two axes are contiguous (E1 reads the
    leading axis through its stride: an expanded ``vi``, a band's slice of
    an index image), else a contiguous copy."""
    if x.stride(-1) == 1 and (x.shape[-2] <= 1 or x.stride(-2) == x.shape[-1]):
        return x
    return x.contiguous()


def _strides(x: torch.Tensor) -> list[int]:
    """``x``'s strides in elements, 0 along axes of extent 1 (never
    stepped along)."""
    return [st if size > 1 else 0 for st, size in zip(x.stride(), x.shape)]


def _e1_cuda(
    v_pix, vi, index_img, img, grad_output, bary_img, max_dp_dr: float, y_offset: int = 0, full_height: int = -1,
    out=None,
):
    """Launch kernel E1 on the tensors' device and current stream: verts
    mode with ``bary_img`` (adding into ``out``, zeros if None), image mode
    without."""
    if v_pix.dtype not in _C_ENTRY:
        raise TypeError(f"edge_grad kernel: no kernel for {v_pix.dtype} vertices")
    if index_img.dtype != torch.int32 or vi.dtype != torch.int32:
        raise TypeError(f"edge_grad kernel: expected int32 index and vi, got {index_img.dtype} and {vi.dtype}")
    if any(t.dtype != v_pix.dtype for t in (img, grad_output, bary_img) if t is not None):
        raise TypeError(f"edge_grad kernel: img, the cotangent and bary must be {v_pix.dtype}")
    tensors = [v_pix, vi, index_img, img, grad_output] + [t for t in (bary_img, out) if t is not None]
    if v_pix.device.type != "cuda" or any(t.device != v_pix.device for t in tensors):
        raise ValueError("edge_grad kernel: every tensor must lie on one CUDA device")
    return _launch(
        lambda: _build.entry("edge_grad", _C_ENTRY[v_pix.dtype], _ARGTYPES),
        torch.cuda.current_stream(v_pix.device).cuda_stream,
        v_pix, vi, index_img, img, grad_output, bary_img, max_dp_dr, y_offset, full_height, out,
    )


def _launch(entry, stream, v_pix, vi, index_img, img, grad_output, bary_img, max_dp_dr, y_offset, full_height, out):
    """Call E1's C entry (``entry()``, looked up once the limits pass) on
    ``stream`` for tensors of one device whose types :func:`_e1_cuda`
    checked: the limits, the layouts E1 reads, the output and the launch
    count."""
    n, c, h, w = img.shape
    n_verts, f_cnt = v_pix.shape[1], vi.shape[1]

    def check_limits(extents):
        if n > _MAX_BATCH or max(extents) >= 2**31:
            raise ValueError(
                f"edge_grad kernel: at most {_MAX_BATCH} batches and 32-bit offsets within a batch, got N={n}, "
                f"C={c}, H={h}, W={w}, V={n_verts}, F={f_cnt}"
            )

    images = [img, grad_output] + ([] if bary_img is None else [bary_img])  # read through their strides
    check_limits([h * w, n_verts * 3, f_cnt * 3] + [sum((k - 1) * st for k, st in zip(t.shape[1:], _strides(t)[1:]))
                                                     for t in images])  # before any copy
    v_pix, vi, index_img = _rows_layout(v_pix), _rows_layout(vi), _rows_layout(index_img)
    if bary_img is None:
        out = torch.empty((n, 3, h, w), dtype=v_pix.dtype, device=v_pix.device)
        bary_strides, bary_ptr = [0, 0, 0, 0], None
    else:
        if out is None:
            out = torch.zeros((n, n_verts, 3), dtype=v_pix.dtype, device=v_pix.device)
        elif out.shape != (n, n_verts, 3) or out.dtype != v_pix.dtype or not out.is_contiguous():
            raise ValueError(
                f"edge_grad kernel: out must be a contiguous {v_pix.dtype} tensor of shape {(n, n_verts, 3)}, got "
                f"{out.dtype} {tuple(out.shape)}"
            )
        bary_strides, bary_ptr = _strides(bary_img), bary_img.data_ptr()
    img_s, grad_s = _strides(img), _strides(grad_output)
    y_end = h - 1 if full_height < 0 else max(0, min(h - 1, full_height - 1 - y_offset))
    shape = _Shape(
        n, c, h, w, n_verts, f_cnt, v_pix.stride(0), vi.stride(0), index_img.stride(0), img_s[0], grad_s[0],
        bary_strides[0], *img_s[1:], *grad_s[1:], *bary_strides[1:], float(max_dp_dr), y_offset, y_end,
    )
    err = entry()(
        v_pix.data_ptr(), vi.data_ptr(), index_img.data_ptr(), img.data_ptr(), grad_output.data_ptr(), bary_ptr,
        out.data_ptr(), ctypes.byref(shape), stream,
    )
    _build.check("edge_grad", err, "edge_grad kernel")
    tracing.launched("E1 edge_grad")
    return out


def _takes_plain(impl: str, device: torch.device) -> bool:
    """E1's dispatch, as every kernel of the port dispatches: the plain
    version for impl="plain" or a CPU tensor, the kernel for a CUDA
    tensor."""
    if impl == "plain" or (impl == "auto" and device.type == "cpu"):
        return True
    if impl == "auto" and device.type == "cuda":
        return False
    raise ValueError(f"edge_grad: impl {impl!r} on device {device}")


def edge_grad_to_verts(
    v_pix: torch.Tensor,
    vi: torch.Tensor,
    index_img: torch.Tensor,
    img: torch.Tensor,
    grad_output: torch.Tensor,
    bary_img: torch.Tensor,
    max_dp_dr: float,
    y_offset: int = 0,
    full_height: int = -1,
    out: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """The edge_grad backward from index image to vertex gradient
    (``drtk_tpu/ops/edge_grad.py:288-318``): kernel E1 in verts mode on
    CUDA tensors, one launch; :func:`_verts_plain` on CPU tensors or with
    ``impl="plain"``.

    Args:
        v_pix: [N, V, 3] float32 or float64 pixel-space vertices.
        vi: [N, F, 3] int32 faces.
        index_img: [N, H, W] int32 index image.
        img, grad_output: [N, C, H, W] image and its cotangent.
        bary_img: [N, 3, H, W] barycentrics (detached).
        max_dp_dr: magnitude clamp for dp/dr (0.0 disables it).
        y_offset, full_height: the block's first global row and the frame's
            height on a row tile; ``full_height`` -1 means no row tile.
        out: a [N, V, 3] accumulator of ``v_pix``'s dtype to add into (the
            bands of a frame share one); None for a new one of zeros.
        impl: "auto" or "plain", as for the other kernels.

    Returns:
        The vertex gradient [N, V, 3]: ``out`` when given. ``img``,
        ``grad_output`` and ``bary_img`` are cast to ``v_pix``'s dtype.
    """
    dtype = v_pix.dtype
    img, grad_output, bary_img = img.to(dtype), grad_output.to(dtype), bary_img.to(dtype)
    args = (v_pix, vi, index_img, img, grad_output, bary_img, max_dp_dr, y_offset, full_height)
    if not _takes_plain(impl, v_pix.device):
        return _e1_cuda(*args, out=out)
    grad = _verts_plain(*args)
    return grad if out is None else out.add_(grad)


def _edge_grad_backward(
    v_pix, vi, img, index_img, grad_output, max_dp_dr: float, impl="auto", y_offset: int = 0,
    full_height: int | None = None,
):
    """The image-space gradient [N, 3, H, W] (``drtk_tpu/ops/edge_grad.py:
    114-276``): kernel E1 in image mode on CUDA tensors, ``_stencil_plain``
    on CPU tensors or with ``impl="plain"``; ``y_offset`` and
    ``full_height`` as for :func:`edge_grad_to_verts` (None: no row
    tile). ``img`` and ``grad_output`` are cast to ``v_pix``'s dtype."""
    img, grad_output = img.to(v_pix.dtype), grad_output.to(v_pix.dtype)
    args = (index_img, img, grad_output, None, max_dp_dr, y_offset, -1 if full_height is None else full_height)
    if _takes_plain(impl, v_pix.device):
        return _stencil_plain(_stencil_table(v_pix, vi), *args)
    return _e1_cuda(v_pix, vi, *args)


class _EdgeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_pix, vi, bary_img, img, index_img, max_dp_dr, impl):
        ctx.save_for_backward(v_pix, vi, bary_img, img, index_img)
        ctx.max_dp_dr, ctx.impl = max_dp_dr, impl
        return img.view_as(img)

    @staticmethod
    def backward(ctx, grad_output):
        """Mirrors ``drtk_tpu/ops/edge_grad.py:288-318``."""
        with tracing.span("edge_grad_bwd"):
            v_pix, vi, bary_img, img, index_img = ctx.saved_tensors
            grad_v_pix = None
            if ctx.needs_input_grad[0]:
                grad_v_pix = edge_grad_to_verts(v_pix, vi, index_img, img, grad_output, bary_img, ctx.max_dp_dr,
                                                impl=ctx.impl)
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
        rank's first row (the stencil's D leg; the last rank takes a
        background row), reduced to this rank's part of the vertex
        gradient; the sum over the group is the replicated input's (see
        :func:`~drtk_tpu_torch.ops.math.psum_cotangent`)."""
        with tracing.span("edge_grad_bwd"):
            v_pix, vi, bary_img, img, index_img = ctx.saved_tensors
            grad_v_pix = None
            if ctx.needs_input_grad[0]:
                grad_output = grad_output.contiguous()
                block = (img, grad_output, bary_img, index_img)
                firsts = [img[:, :, :1], grad_output[:, :, :1], bary_img[:, :, :1], index_img[:, :1]]
                halo = next_rank_rows(firsts, (0, 0, 0, -1), ctx.group)
                img_e, g_e, bary_e, idx_e = (torch.cat([b, h], dim=2 if b.ndim == 4 else 1)
                                             for b, h in zip(block, halo))
                grad_v_pix = edge_grad_to_verts(v_pix, vi, idx_e, img_e, g_e, bary_e, ctx.max_dp_dr, ctx.y_offset,
                                                ctx.full_height, impl=ctx.impl)
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
        impl: "auto" runs kernel E1 on CUDA tensors; "plain" runs its
            plain version on any device.
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
        with tracing.span("edge_grad"):
            return _EdgeGrad.apply(v_pix, vi, bary_img.detach(), img, index_img, float(max_dp_dr), impl)
    if full_height is None:
        raise ValueError("edge_grad_estimator: full_height is required with group")
    y_offset, full_height = operator.index(y_offset), operator.index(full_height)
    if y_offset < 0 or y_offset + index_img.shape[1] > full_height:
        raise ValueError(
            f"edge_grad_estimator: rows [{y_offset}, {y_offset + index_img.shape[1]}) do not lie in a frame of "
            f"{full_height} rows"
        )
    with tracing.span("edge_grad"):
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
