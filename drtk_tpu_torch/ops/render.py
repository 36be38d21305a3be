"""Depth and perspective-correct barycentric rendering (counterpart of
``drtk_tpu/ops/render.py``).

Per pixel, the three vertices of the triangle in ``index_img`` arrive as one
9-float row through :func:`gather_rows_by_index` (kernel B2 on the card);
2-D barycentrics come from edge cross products and become
perspective-correct 3-D barycentrics ``bary_3D_i = (1/z_i) * lambda_i *
depth`` with ``depth = 1 / epsclamp(sum_i lambda_i / z_i)``. Background
pixels (index -1) output zeros.

Only the forward pass is ported: the backward (the clamp-aware VJP) belongs
to the next slice, and until then :func:`render` raises when differentiated.
"""

from __future__ import annotations

from typing import Tuple

import torch

from drtk_tpu_torch.ops.math import autocast_f32, epsclamp
from drtk_tpu_torch.ops.rasterize import broadcast_vi
from drtk_tpu_torch.ops.segment_rows import gather_rows_by_index

__all__ = ["render", "render_ref"]

BACKWARD_NOT_PORTED = (
    "is not differentiable in drtk_tpu_torch yet: its backward belongs to the "
    "training-path slice (ROADMAP.md, queue A, 'Next slice')"
)


def _face_table(v: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
    """[N, V, C] per-vertex rows, [N, F, 3] faces -> [N, F, 3*C] per-face rows
    (indices clamped into range, as JAX's gathers clamp them)."""
    n, num_v, c = v.shape
    idx = vi.long().clamp(0, max(num_v - 1, 0))
    rows = v[torch.arange(n, device=v.device)[:, None, None], idx]  # [N, F, 3, C]
    return rows.reshape(n, -1, 3 * c)


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


class _Render(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, vi, index_img, impl):
        return _render_fwd_math(v, vi, index_img, impl)

    @staticmethod
    def backward(ctx, grad_depth, grad_bary):
        raise NotImplementedError("render " + BACKWARD_NOT_PORTED)


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
