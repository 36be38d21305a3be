"""Depth and perspective-correct barycentric rendering (counterpart of
``drtk_tpu/ops/render.py``).

2-D barycentrics come from edge cross products of each pixel's triangle
(the one in ``index_img``) and become perspective-correct 3-D barycentrics
``bary_3D_i = (1/z_i) * lambda_i * depth`` with ``depth = 1 /
epsclamp(sum_i lambda_i / z_i)``. Background pixels (index -1) output
zeros.

The backward is the clamp-aware VJP of the JAX package
(``_render_core_bwd``): every ``epsclamp`` site that clamped (``den``, ``z``,
``depth_inv``) kills its gradient path.

On CUDA tensors both directions are kernel R1 (``csrc/render.cu``), one
launch each: a thread per pixel computes the function (forward) or
recomputes it and applies its VJP (backward) in registers and adds the
pixel's nine values to its face's row, which a second, small pass of the
same launch folds into the vertices; no per-pixel row reaches device
memory. On CPU tensors and with ``impl="plain"`` the plain version runs:
the three vertices of each pixel's triangle arrive as one 9-float row
through :func:`gather_rows_by_index` (B2's plain gather), eager ops compute
the function, and the backward gathers the rows again (rather than saving
them from the forward), forms the per-pixel [N, H, W, 9] gradient, sums it
to face rows (B3's plain scatter) and from there to vertices with
``index_add_``.
"""

from __future__ import annotations

import ctypes
import operator
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from drtk_tpu_torch import _build, tracing
from drtk_tpu_torch.ops.math import autocast_f32, epsclamp
from drtk_tpu_torch.ops.rasterize import broadcast_vi
from drtk_tpu_torch.ops.segment_rows import gather_rows_by_index, scatter_rows_to_faces

__all__ = ["render", "render_ref"]


def _face_table(v: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
    """[N, V, C] per-vertex rows, [N, F, 3] faces -> [N, F, 3*C] per-face rows
    (indices clamped into range, as JAX's gathers clamp them)."""
    n, num_v, c = v.shape
    idx = vi.long().clamp(0, max(num_v - 1, 0))
    rows = v[torch.arange(n, device=v.device)[:, None, None], idx]  # [N, F, 3, C]
    return rows.reshape(n, -1, 3 * c)


def _pixels_to_verts(rows, index_img, vi, num_v, impl="auto"):
    """The transpose of ``gather_rows_by_index(_face_table(v, vi), index_img)``:
    per-pixel [N, H, W, 3*C] rows summed into [N, V, C] vertex rows. Pixels
    to faces with kernel B3 (background pixels dropped), then faces to
    vertices with ``index_add_`` (the JAX package also leaves this small
    step to a plain scatter)."""
    n, f_cnt = vi.shape[:2]
    c = rows.shape[-1] // 3
    grad_face = scatter_rows_to_faces(rows, index_img, f_cnt, impl)  # [N, F, 3C]
    ids = vi.long().clamp(0, max(num_v - 1, 0)) + torch.arange(n, device=vi.device)[:, None, None] * num_v
    out = grad_face.new_zeros((n * num_v, c))
    out.index_add_(0, ids.reshape(-1), grad_face.reshape(-1, c))
    return out.reshape(n, num_v, c)


def _pixel_grid(h: int, w: int, y_offset: int, dtype, device):
    """Pixel centres (x [1, 1, W], y [1, H, 1]) of rows
    ``[y_offset, y_offset + h)``: the global rows of a row-tile viewport."""
    px = torch.arange(w, device=device).to(dtype)[None, None, :]
    py = (torch.arange(h, device=device) + y_offset).to(dtype)[None, :, None]
    return px, py


def _render_fwd_math(v, vi, index_img, impl="auto", y_offset=0):
    dtype = v.dtype
    n, h, w = index_img.shape
    mask = index_img >= 0
    rows = gather_rows_by_index(_face_table(v, vi), index_img, impl)  # [N, H, W, 9]
    pix_verts = rows.reshape(n, h, w, 3, 3)

    p0 = pix_verts[..., 0, :2]
    p1 = pix_verts[..., 1, :2]
    p2 = pix_verts[..., 2, :2]
    z = pix_verts[..., 2]  # [N, H, W, 3]

    v01 = p1 - p0
    v02 = p2 - p0
    den_raw = v01[..., 0] * v02[..., 1] - v01[..., 1] * v02[..., 0]
    den = epsclamp(den_raw)

    px, py = _pixel_grid(h, w, y_offset, dtype, v.device)
    vp0p_x = px - p0[..., 0]
    vp0p_y = py - p0[..., 1]

    b1 = (vp0p_x * v02[..., 1] - vp0p_y * v02[..., 0]) / den
    b2 = (vp0p_y * v01[..., 0] - vp0p_x * v01[..., 1]) / den
    b0 = 1.0 - b1 - b2
    bary = torch.stack([b0, b1, b2], dim=-1)  # [N, H, W, 3]

    d_inv = 1.0 / epsclamp(z)
    db = d_inv * bary
    depth_inv = epsclamp((db[..., 0] + db[..., 1]) + db[..., 2])
    depth = 1.0 / depth_inv

    bary_3d = db * depth[..., None]

    maskf = mask.to(dtype)
    depth_img = depth * maskf
    bary_img = (bary_3d * maskf[..., None]).movedim(-1, 1)  # [N, 3, H, W]
    return depth_img, bary_img.contiguous()


def _render_bwd_math(v, vi, index_img, grad_depth_img, grad_bary_img, impl="auto", y_offset=0):
    """The clamp-aware VJP to ``v`` (``drtk_tpu/ops/render.py:118-241``)."""
    dtype = v.dtype
    n, h, w = index_img.shape
    rows = gather_rows_by_index(_face_table(v, vi), index_img, impl)  # [N, H, W, 9]
    pix_verts = rows.reshape(n, h, w, 3, 3)
    p0 = pix_verts[..., 0, :2]
    p1 = pix_verts[..., 1, :2]
    p2 = pix_verts[..., 2, :2]
    z = pix_verts[..., 2]

    v01 = p1 - p0
    v02 = p2 - p0
    den_raw = v01[..., 0] * v02[..., 1] - v01[..., 1] * v02[..., 0]
    den = epsclamp(den_raw)
    den_clamped = den != den_raw

    px, py = _pixel_grid(h, w, y_offset, dtype, v.device)
    vp0p_x = px - p0[..., 0]
    vp0p_y = py - p0[..., 1]

    b12_pre = torch.stack(
        [vp0p_x * v02[..., 1] - vp0p_y * v02[..., 0], vp0p_y * v01[..., 0] - vp0p_x * v01[..., 1]], dim=-1
    )
    b12 = b12_pre / den[..., None]
    bary = torch.stack([1.0 - b12[..., 0] - b12[..., 1], b12[..., 0], b12[..., 1]], dim=-1)

    z_eps = epsclamp(z)
    z_clamped = z_eps != z
    d_inv = 1.0 / z_eps

    depth_inv_raw = (d_inv * bary).sum(-1)
    depth_inv = epsclamp(depth_inv_raw)
    depth_inv_clamped = depth_inv != depth_inv_raw
    depth = 1.0 / depth_inv

    dl_bary3d = grad_bary_img.movedim(1, -1)  # [N, H, W, 3]
    # dL_depth includes the path through bary_3d = d_inv * bary * depth.
    dl_depth = grad_depth_img + (dl_bary3d * d_inv * bary).sum(-1)
    dl_depth_inv = torch.where(depth_inv_clamped, 0.0, -dl_depth / (depth_inv_raw * depth_inv_raw))
    dl_d_inv = dl_bary3d * bary * depth[..., None] + dl_depth_inv[..., None] * bary
    dl_z = torch.where(z_clamped, 0.0, -dl_d_inv / (z_eps * z_eps))

    dl_bary = dl_bary3d * d_inv * depth[..., None] + dl_depth_inv[..., None] * d_inv
    dl_b12 = torch.stack([-dl_bary[..., 0] + dl_bary[..., 1], -dl_bary[..., 0] + dl_bary[..., 2]], dim=-1)
    dl_b_pre = dl_b12 / den[..., None]
    dl_den = torch.where(den_clamped, 0.0, -(dl_b_pre * b12).sum(-1))

    dl_vp0p_x = dl_b_pre[..., 0] * v02[..., 1] - dl_b_pre[..., 1] * v01[..., 1]
    dl_vp0p_y = -dl_b_pre[..., 0] * v02[..., 0] + dl_b_pre[..., 1] * v01[..., 0]
    dl_v02 = torch.stack(
        [-dl_b_pre[..., 0] * vp0p_y - dl_den * v01[..., 1], dl_b_pre[..., 0] * vp0p_x + dl_den * v01[..., 0]],
        dim=-1,
    )
    dl_v01 = torch.stack(
        [dl_b_pre[..., 1] * vp0p_y + dl_den * v02[..., 1], -dl_b_pre[..., 1] * vp0p_x - dl_den * v02[..., 0]],
        dim=-1,
    )
    dl_p0 = -dl_v02 - dl_v01 - torch.stack([dl_vp0p_x, dl_vp0p_y], dim=-1)

    # [N, H, W, corner, xyz]; background rows are dropped by the scatter.
    grad_pix = torch.cat(
        [dl_p0, dl_z[..., 0:1], dl_v01, dl_z[..., 1:2], dl_v02, dl_z[..., 2:3]], dim=-1
    )
    return _pixels_to_verts(grad_pix, index_img, vi, v.shape[1], impl)


class _Shape(ctypes.Structure):
    """R1's launch scalars (``struct Shape`` of ``csrc/render.cu``):
    extents, y_offset, the batch strides of v and vi and the strides of the
    cotangents (in elements)."""

    _fields_ = (
        [(k, ctypes.c_int32) for k in ("n_batch", "h", "w", "n_verts", "n_faces", "y_offset")]
        + [(k, ctypes.c_int64) for k in ("v_sn", "vi_sn", "gd_sn", "gd_sh", "gd_sw", "gb_sn", "gb_sc", "gb_sh",
                                         "gb_sw")]
    )


_C_ENTRY = {
    torch.float32: ("drtk_render_fwd_f32", "drtk_render_bwd_f32"),
    torch.float64: ("drtk_render_fwd_f64", "drtk_render_bwd_f64"),
}
_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.POINTER(_Shape), ctypes.c_void_p],
    [ctypes.c_void_p] * 7 + [ctypes.POINTER(_Shape), ctypes.c_void_p],
)
_MAX_BATCH = 65535  # R1 takes the batch from blockIdx.y


def _takes_r1(impl: str, device: torch.device) -> bool:
    """R1's dispatch, as every kernel of the port dispatches: the kernel for
    a CUDA tensor under impl="auto", the plain version for impl="plain" or
    a CPU tensor."""
    if impl == "auto" and device.type == "cuda":
        return True
    if impl == "plain" or (impl == "auto" and device.type == "cpu"):
        return False
    raise ValueError(f"render: impl {impl!r} on device {device}")


def _batch_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [N, K, 3] itself where each batch's rows are contiguous (R1
    reads the batch axis through its stride: an expanded ``vi``), else a
    contiguous copy."""
    return x if x.stride(2) == 1 and (x.shape[1] <= 1 or x.stride(1) == 3) else x.contiguous()


def _r1_launch(entry, stream, v, vi, index_img, y_offset: int, cotangents=None):
    """Call R1's forward (``cotangents`` None) or backward C entry
    (``entry(direction)``, looked up once the checks pass) on ``stream``
    for tensors of one device and dtype. Returns (depth [N, H, W], bary
    [N, 3, H, W]), or the vertex gradient [N, V, 3] from ``cotangents`` =
    (grad_depth [N, H, W], grad_bary [N, 3, H, W]), either None for
    zeros."""
    n, h, w = index_img.shape
    n_verts, f_cnt = v.shape[1], vi.shape[1]
    if v.shape != (n, n_verts, 3) or vi.shape != (n, f_cnt, 3):
        raise ValueError(f"render kernel: v [N, V, 3] and vi [N, F, 3] with the index's N = {n}, got "
                         f"{tuple(v.shape)} and {tuple(vi.shape)}")
    if not index_img.is_contiguous():
        raise ValueError("render kernel: the index image must be contiguous")
    if n > _MAX_BATCH or max(h * w, n_verts * 3, f_cnt * 3) >= 2**31:
        raise ValueError(f"render kernel: at most {_MAX_BATCH} batches and 32-bit offsets within a batch, got "
                         f"N={n}, H={h}, W={w}, V={n_verts}, F={f_cnt}")
    grad_depth, grad_bary = (None, None) if cotangents is None else cotangents
    for name, t, want in (("grad_depth", grad_depth, (n, h, w)), ("grad_bary", grad_bary, (n, 3, h, w))):
        if t is not None and t.shape != want:
            raise ValueError(f"render kernel: {name} must be {want}, got {tuple(t.shape)}")
    v, vi = _batch_rows(v), _batch_rows(vi)
    gd_s = [0] * 3 if grad_depth is None else list(grad_depth.stride())
    gb_s = [0] * 4 if grad_bary is None else list(grad_bary.stride())
    shape = _Shape(n, h, w, n_verts, f_cnt, y_offset, v.stride(0), vi.stride(0), *gd_s, *gb_s)
    inputs = (v.data_ptr(), vi.data_ptr(), index_img.data_ptr())
    if cotangents is None:
        depth = torch.empty((n, h, w), dtype=v.dtype, device=v.device)
        bary = torch.empty((n, 3, h, w), dtype=v.dtype, device=v.device)
        err = entry(0)(*inputs, depth.data_ptr(), bary.data_ptr(), ctypes.byref(shape), stream)
        out = depth, bary
    else:  # the face rows R1 adds to and the vertex gradient it folds them into, zeroed by one fill
        scratch = torch.zeros(n * f_cnt * 9 + n * n_verts * 3, dtype=v.dtype, device=v.device)
        face_rows, out = scratch[: n * f_cnt * 9], scratch[n * f_cnt * 9:].view(n, n_verts, 3)
        err = entry(1)(*inputs, *(None if t is None else t.data_ptr() for t in (grad_depth, grad_bary)),
                       face_rows.data_ptr(), out.data_ptr(), ctypes.byref(shape), stream)
    _build.check("render", err, "render kernel")
    tracing.launched("R1 render")
    return out


def _r1_cuda(v, vi, index_img, y_offset: int, cotangents=None):
    """Launch R1 on the tensors' device and current stream (the forward, or
    with ``cotangents`` the backward; see :func:`_r1_launch`)."""
    if v.dtype not in _C_ENTRY:
        raise TypeError(f"render kernel: no kernel for {v.dtype} vertices")
    if index_img.dtype != torch.int32 or vi.dtype != torch.int32:
        raise TypeError(f"render kernel: expected int32 index and vi, got {index_img.dtype} and {vi.dtype}")
    grads = [t for t in cotangents or () if t is not None]
    if any(t.dtype != v.dtype for t in grads):
        raise TypeError(f"render kernel: the cotangents must be {v.dtype}")
    if v.device.type != "cuda" or any(t.device != v.device for t in (vi, index_img, *grads)):
        raise ValueError("render kernel: every tensor must lie on one CUDA device")
    return _r1_launch(
        lambda direction: _build.entry("render", _C_ENTRY[v.dtype][direction], _ARGTYPES[direction]),
        torch.cuda.current_stream(v.device).cuda_stream, v, vi, index_img, y_offset, cotangents,
    )


class _Render(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, vi, index_img, impl, y_offset):
        ctx.save_for_backward(v, vi, index_img)
        ctx.impl, ctx.y_offset = impl, y_offset
        return _render_fwd_math(v, vi, index_img, impl, y_offset)

    @staticmethod
    def backward(ctx, grad_depth, grad_bary):
        with tracing.span("render_bwd"):
            v, vi, index_img = ctx.saved_tensors
            grad_v = None
            if ctx.needs_input_grad[0]:
                grad_v = _render_bwd_math(v, vi, index_img, grad_depth, grad_bary, ctx.impl, ctx.y_offset)
            return grad_v, None, None, None, None


class _RenderKernel(torch.autograd.Function):
    """render through R1, one launch each way; the backward recomputes the
    function from the saved v, vi and index (once differentiable)."""

    @staticmethod
    def forward(ctx, v, vi, index_img, y_offset):
        ctx.save_for_backward(v, vi, index_img)
        ctx.y_offset = y_offset
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None: R1 reads zeros
        return _r1_cuda(v, vi, index_img, y_offset)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_depth, grad_bary):
        with tracing.span("render_bwd"):
            v, vi, index_img = ctx.saved_tensors
            grad_v = None
            if ctx.needs_input_grad[0] and (grad_depth is not None or grad_bary is not None):
                grad_v = _r1_cuda(v, vi, index_img, ctx.y_offset, (grad_depth, grad_bary))
            return grad_v, None, None, None


def render(
    v: torch.Tensor, vi: torch.Tensor, index_img: torch.Tensor, impl: str = "auto", y_offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render depth and 3-D barycentric images from a rasterized index image.

    Args:
        v: [N, V, 3] pixel-space vertex positions (x_pix, y_pix, z_cam).
        vi: [N, F, 3] or [F, 3] int32 triangle indices.
        index_img: [N, H, W] int32 triangle index image (-1 = background).
        impl: "auto" runs kernel R1 on CUDA tensors, one launch forward and
            one backward (that backward is once differentiable); "plain"
            runs the plain version on any device, which CPU tensors take
            under "auto" too.
        y_offset: global row of ``index_img``'s first row, for row-tile
            rendering: the pixel grid is rows ``[y_offset, y_offset + H)``,
            forward and backward, so a tile equals those rows of the
            full-frame render bit for bit.

    Returns:
        (depth_img [N, H, W], bary_img [N, 3, H, W]); zeros at background.
        f16/bf16 ``v`` computes in float32.
    """
    v = autocast_f32(v)
    if v.ndim != 3 or v.shape[-1] != 3:
        raise ValueError(f"render: expected v of shape [N, V, 3], got {tuple(v.shape)}")
    vi = broadcast_vi(vi, v.shape[0])
    if index_img.ndim != 3:
        raise ValueError(f"render: expected index_img of shape [N, H, W], got {tuple(index_img.shape)}")
    y_offset = operator.index(y_offset)
    with tracing.span("render"):
        if _takes_r1(impl, v.device):
            return _RenderKernel.apply(v, vi, index_img.contiguous(), y_offset)
        return _Render.apply(v, vi, index_img, impl, y_offset)


def render_ref(
    v: torch.Tensor, vi: torch.Tensor, index_img: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float64 reference of :func:`render`.

    Shares no code with the op's forward: per-corner element gathers (not
    the packed row gather), ``lambda_0`` computed from its own edge function
    (the op derives ``b0 = 1 - b1 - b2``), and a local epsclamp, so a bug in
    ``_render_fwd_math`` makes the oracle tests fail rather than cancel out.
    """
    orig_dtype = v.dtype
    f64 = torch.float64
    v = v.to(f64)
    vi = broadcast_vi(vi, v.shape[0])
    n, h, w = index_img.shape
    mask = (index_img != -1).to(f64)
    dev = v.device

    def eps(x):
        return torch.where(x < 0, torch.clamp(x, max=-1e-16), torch.clamp(x, min=1e-16))

    bidx = torch.arange(n, device=dev)[:, None, None]
    safe = index_img.long().clamp(min=0)
    vi_img = vi.long()[bidx, safe]  # [N, H, W, 3]
    p0, p1, p2 = (v[bidx, vi_img[..., k]] for k in range(3))  # each [N, H, W, 3]

    e01 = p1 - p0
    e02 = p2 - p0
    e12 = p2 - p1
    den = eps(e01[..., 0] * e02[..., 1] - e01[..., 1] * e02[..., 0])

    xs = torch.arange(w, dtype=f64, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=f64, device=dev)[None, :, None]
    d0x, d0y = xs - p0[..., 0], ys - p0[..., 1]
    d1x, d1y = xs - p1[..., 0], ys - p1[..., 1]

    lam0 = (d1y * e12[..., 0] - d1x * e12[..., 1]) / den
    lam1 = (d0x * e02[..., 1] - d0y * e02[..., 0]) / den
    lam2 = (d0y * e01[..., 0] - d0x * e01[..., 1]) / den

    w0 = lam0 / eps(p0[..., 2])
    w1 = lam1 / eps(p1[..., 2])
    w2 = lam2 / eps(p2[..., 2])
    depth = 1.0 / eps(w0 + w1 + w2)

    bary = torch.stack([w0, w1, w2], dim=1) * depth[:, None] * mask[:, None]
    return (depth * mask).to(orig_dtype), bary.to(orig_dtype)
