"""Depth and perspective-correct barycentric rendering (counterpart of
``drtk_tpu/ops/render.py``).

Per pixel, the three vertices of the triangle in ``index_img`` arrive as one
9-float row through :func:`gather_rows_by_index` (kernel B2 on the card);
2-D barycentrics come from edge cross products and become
perspective-correct 3-D barycentrics ``bary_3D_i = (1/z_i) * lambda_i *
depth`` with ``depth = 1 / epsclamp(sum_i lambda_i / z_i)``. Background
pixels (index -1) output zeros.

The backward is the clamp-aware VJP of the JAX package
(``_render_core_bwd``): every ``epsclamp`` site that clamped (``den``, ``z``,
``depth_inv``) kills its gradient path. The per-pixel vertex rows are
gathered again through kernel B2 rather than saved from the forward (one
more launch, 38 MB less memory at 1024^2); the per-pixel [N, H, W, 9]
gradient goes to face rows through kernel B3 and from there to vertices
with ``index_add_``.
"""

from __future__ import annotations

from typing import Tuple

import torch

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


def _render_fwd_math(v, vi, index_img, impl="auto"):
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

    px = torch.arange(w, device=v.device).to(dtype)[None, None, :]
    py = torch.arange(h, device=v.device).to(dtype)[None, :, None]
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


def _render_bwd_math(v, vi, index_img, grad_depth_img, grad_bary_img, impl="auto"):
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

    px = torch.arange(w, device=v.device).to(dtype)[None, None, :]
    py = torch.arange(h, device=v.device).to(dtype)[None, :, None]
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


class _Render(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, vi, index_img, impl):
        ctx.save_for_backward(v, vi, index_img)
        ctx.impl = impl
        return _render_fwd_math(v, vi, index_img, impl)

    @staticmethod
    def backward(ctx, grad_depth, grad_bary):
        v, vi, index_img = ctx.saved_tensors
        grad_v = None
        if ctx.needs_input_grad[0]:
            grad_v = _render_bwd_math(v, vi, index_img, grad_depth, grad_bary, ctx.impl)
        return grad_v, None, None, None


def render(
    v: torch.Tensor, vi: torch.Tensor, index_img: torch.Tensor, impl: str = "auto"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render depth and 3-D barycentric images from a rasterized index image.

    Args:
        v: [N, V, 3] pixel-space vertex positions (x_pix, y_pix, z_cam).
        vi: [N, F, 3] or [F, 3] int32 triangle indices.
        index_img: [N, H, W] int32 triangle index image (-1 = background).
        impl: "auto" gathers the face rows with kernel B2 on CUDA tensors;
            "plain" uses the plain gather on any device.

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
    return _Render.apply(v, vi, index_img, impl)


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
