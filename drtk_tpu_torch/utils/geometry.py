"""Mesh geometry helpers (counterpart of ``drtk_tpu/utils/geometry.py``):
per-face Jacobians of position with respect to uv, face normals, edges and
areas, and per-vertex normals and binormals accumulated from the faces.
Differentiable through autograd.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

__all__ = ["face_attribute_to_vert", "face_dpdt", "face_info", "vert_binormals", "vert_normals"]

eps = 1e-8


def _safe_normalize(x: torch.Tensor, dim: int = -1, eps_: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||, eps)``, as ``torch.nn.functional.normalize``."""
    return x / torch.maximum(torch.linalg.vector_norm(x, dim=dim, keepdim=True), x.new_full((), eps_))


def _inv_2x2(m: torch.Tensor) -> torch.Tensor:
    """Batched 2x2 inverse from the adjugate; inf or NaN where singular, as
    the JAX package's ``jnp.linalg.inv`` gives (``torch.linalg.inv``
    raises there instead)."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    adj = torch.stack([torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2)
    return adj / (a * d - b * c)[..., None, None]


def _inv_2x2_or_zero(m: torch.Tensor) -> torch.Tensor:
    """Batched 2x2 inverse; singular matrices give zeros (the JAX package's
    ``screen_space_uv_derivative._inv_2x2``)."""
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    return torch.where((det == 0)[..., None, None], m.new_zeros(()), _inv_2x2(m))


def face_dpdt(
    v: torch.Tensor, vt: torch.Tensor, vi: torch.Tensor, vti: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transposed per-face Jacobian (dp/dt)^T of position with respect
    to uv.

    Args:
        v: [N, V, 3] positions; vt: [N, Vt, 2] uvs; vi / vti: [F, 3] int
            position and uv faces.

    Returns:
        dpdt_t [N, F, 2, 3] with ``dpdt_t[..., i, j] = dp[j] / dt[i]``, and
        v012 [N, F, 3, 3], the faces' corner positions.
    """
    if v.ndim != 3:
        raise ValueError(f"Expected v to be 3D, got {v.ndim}D")
    if vt.ndim != 3:
        raise ValueError(f"Expected vt to be 3D, got {vt.ndim}D")
    if vt.shape[0] != v.shape[0]:
        raise ValueError(f"Expected vt to have the same batch size as v, got {vt.shape[0]} and {v.shape[0]}")
    v012 = v[:, vi.long()]  # [N, F, 3, 3]
    vt012 = vt[:, vti.long()]  # [N, F, 3, 2]
    dpdb_t = v012[:, :, 1:3] - v012[:, :, 0:1]  # [N, F, 2, 3]
    dtdb_t = vt012[:, :, 1:3] - vt012[:, :, 0:1]  # [N, F, 2, 2]
    return _inv_2x2(dtdb_t) @ dpdb_t, v012


def face_attribute_to_vert(v: torch.Tensor, vi: torch.Tensor, attr: torch.Tensor) -> torch.Tensor:
    """Sum face attributes onto their three vertices.

    v: [N, V, *] (its batch, vertex count and dtype are read); vi: [F, 3]
    or [B, F, 3] with B in {1, N}; attr: [N, F, A] -> [N, V, A]. One
    ``index_add`` over the flattened N * V vertex index.
    """
    n, num_v = v.shape[:2]
    a = attr.shape[-1]
    if vi.ndim == 2:
        vi_flat = vi.reshape(1, -1)
    elif vi.ndim == 3:
        vi_flat = vi.reshape(vi.shape[0], -1)
    else:
        raise ValueError(f"Expected vi to be 2D [F, 3] or 3D [B, F, 3], got {vi.ndim}D")
    ids = (vi_flat.long() + torch.arange(n, device=v.device)[:, None] * num_v).reshape(-1)  # [N * 3F]
    attr3 = attr.to(v.dtype)[:, :, None].expand(n, attr.shape[1], 3, a).reshape(-1, a)
    return v.new_zeros((n * num_v, a)).index_add(0, ids, attr3).reshape(n, num_v, a)


def face_info(
    v: torch.Tensor, vi: torch.Tensor, to_compute: Optional[List[str]] = None
) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-face unit normals [N, F, 3], edges [N, F, 3, 3] (p1 - p0,
    p0 - p2, p2 - p1) and areas [N, F, 1], any of them by name in
    ``to_compute`` (default all three). One name returns its tensor, more
    a dict. vi: [F, 3] or [B, F, 3]."""
    if to_compute is None:
        to_compute = ["normals", "edges", "areas"]
    b = v.shape[0]
    vi = vi.long().expand((b,) + tuple(vi.shape[-2:]))
    rows = torch.arange(b, device=v.device)[:, None]
    p0, p1, p2 = (v[rows, vi[:, :, k]] for k in range(3))
    v0 = p1 - p0
    v1 = p0 - p2

    output: Dict[str, torch.Tensor] = {}
    if "normals" in to_compute or "areas" in to_compute:
        normals = torch.linalg.cross(v1, v0, dim=-1)
        norm = torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
        if "areas" in to_compute:
            output["areas"] = 0.5 * norm
        if "normals" in to_compute:
            output["normals"] = normals / torch.maximum(norm, norm.new_full((), eps))
    if "edges" in to_compute:
        output["edges"] = torch.stack([v0, v1, p2 - p1], dim=2)
    if len(to_compute) == 1:
        return output[to_compute[0]]
    return output


def vert_binormals(v: torch.Tensor, vt: torch.Tensor, vi: torch.Tensor, vti: torch.Tensor) -> torch.Tensor:
    """Unit per-vertex binormals [N, V, 3]: the faces' u-direction of
    (dp/dt)^T summed onto their vertices."""
    dpdt_t, _ = face_dpdt(v, vt, vi, vti)
    return _safe_normalize(face_attribute_to_vert(v, vi, dpdt_t[:, :, 0, :]))


def vert_normals(v: torch.Tensor, vi: torch.Tensor, fnorms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unit per-vertex normals [N, V, 3]: the face normals (``fnorms``
    [N, F, 3], by default those of :func:`face_info`) summed onto their
    vertices."""
    if fnorms is None:
        fnorms = face_info(v, vi, ["normals"])
    return _safe_normalize(face_attribute_to_vert(v, vi, fnorms))
