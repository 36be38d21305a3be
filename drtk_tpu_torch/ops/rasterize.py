"""Triangle rasterizer (counterpart of ``drtk_tpu/ops/rasterize.py``).

Same contract as the JAX package: pixel centres at integer coordinates,
canonical edge functions ordered by vertex index (shared edges are
watertight), the top-left fill rule, the z > 1e-8 near-plane cull, the
canvas cull, degenerate (all-equal) faces skipped, perspective depth from
linearly interpolated 1/z, and for each pixel the largest inverse depth
with ties going to the smaller triangle id. Outputs are an int32 index
image with -1 at background and a float depth image with 0 at background.

Triangle setup runs as torch ops; the per-pixel resolve is kernel B1
(``csrc/rasterize.cu``) on a CUDA tensor and :func:`_rasterize_plain` on a
CPU tensor. Rasterization is not differentiable: gradients at visibility
edges come from :func:`drtk_tpu_torch.edge_grad_estimator`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from drtk_tpu_torch.ops.math import epsclamp

__all__ = ["rasterize", "rasterize_with_depth"]

_INT32_MAX = torch.iinfo(torch.int32).max
# Near-plane epsilon: all three camera-space z must exceed this.
_Z_CULL_EPS = 1e-8


def broadcast_vi(vi: torch.Tensor, batch: int) -> torch.Tensor:
    """[F, 3] -> [N, F, 3] broadcast; [N, F, 3] passes through."""
    if vi.ndim == 2:
        vi = vi[None].expand((batch,) + tuple(vi.shape))
    return vi


class TriangleSetup(NamedTuple):
    """Per-triangle screen-space setup, all shapes [N, F, ...].

    Edge i's signed value at pixel (x, y) is ``ea[i]*x + eb[i]*y + ec[i]``.
    The inverse depth at a covered pixel is ``sum_i e_i * q[i]`` with
    ``q[i] = (1/epsclamp(z_i)) / |den|``.
    """

    ea: torch.Tensor  # [N, F, 3] edge x-coefficients
    eb: torch.Tensor  # [N, F, 3] edge y-coefficients
    ec: torch.Tensor  # [N, F, 3] edge constants
    topleft: torch.Tensor  # [N, F, 3] bool, top-left fill-rule flag per edge
    q: torch.Tensor  # [N, F, 3] inverse-depth coefficients
    valid: torch.Tensor  # [N, F] bool, triangle participates at all
    bbox: torch.Tensor  # [N, F, 4]: min_x, min_y, max_x, max_y (pixels)


def _gather_faces(v: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
    """v [N, V, C], vi [N, F, 3] -> [N, F, 3, C]. Out-of-range indices are
    clamped into [0, V), as JAX's gathers clamp them."""
    n, num_v = v.shape[:2]
    idx = vi.long().clamp(0, max(num_v - 1, 0))
    return v[torch.arange(n, device=v.device)[:, None, None], idx]


def triangle_setup(v: torch.Tensor, vi: torch.Tensor) -> TriangleSetup:
    """Screen-space triangle setup: edge functions, top-left flags,
    inverse-depth coefficients, validity and bounding boxes."""
    # Mask the wireframe nibble off vi_0 (bits 28-31).
    vi0 = vi[..., 0] & 0x0FFFFFFF
    vi1 = vi[..., 1]
    vi2 = vi[..., 2]
    vi_m = torch.stack([vi0, vi1, vi2], dim=-1)

    degenerate = (vi0 == vi1) & (vi1 == vi2)

    f = _gather_faces(v, vi_m)  # [N, F, 3, 3]
    p = f[..., :2]
    z = f[..., 2]

    p0, p1, p2 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    v01 = p1 - p0
    v02 = p2 - p0
    v12 = p2 - p1

    den = v01[..., 0] * v02[..., 1] - v01[..., 1] * v02[..., 0]  # [N, F]
    sgn = torch.sign(den)

    min_p = torch.minimum(torch.minimum(p0, p1), p2)
    max_p = torch.maximum(torch.maximum(p0, p1), p2)
    bbox = torch.cat([min_p, max_p], dim=-1)

    all_z_pos = (z > _Z_CULL_EPS).all(dim=-1)
    valid = all_z_pos & (den != 0) & ~degenerate

    # edge(pa, pb, p) = vab.x*(p.y - pa.y) - vab.y*(p.x - pa.x)
    #   -> a = -vab.y, b = vab.x, c = vab.y*anchor.x - vab.x*anchor.y,
    # anchored at pa when via <= vib and at pb otherwise, so both triangles
    # sharing an edge evaluate it identically.
    def edge_coeffs(via, vib, pa, pb):
        vab = pb - pa
        a = -vab[..., 1]
        b = vab[..., 0]
        anchor = torch.where((via > vib)[..., None], pb, pa)
        c = vab[..., 1] * anchor[..., 0] - vab[..., 0] * anchor[..., 1]
        return a, b, c

    # bary.x <- edge(vi1, vi2), bary.y <- edge(vi2, vi0), bary.z <- edge(vi0, vi1)
    a0, b0, c0 = edge_coeffs(vi1, vi2, p1, p2)
    a1, b1, c1 = edge_coeffs(vi2, vi0, p2, p0)
    a2, b2, c2 = edge_coeffs(vi0, vi1, p0, p1)

    s = sgn[..., None]
    ea = torch.stack([a0, a1, a2], dim=-1) * s
    eb = torch.stack([b0, b1, b2], dim=-1) * s
    ec = torch.stack([c0, c1, c2], dim=-1) * s

    def topleft(e):
        pos = (e[..., 1] < 0) | ((e[..., 1] == 0) & (e[..., 0] > 0))
        neg = (e[..., 1] > 0) | ((e[..., 1] == 0) & (e[..., 0] < 0))
        return torch.where(den > 0, pos, neg)

    def topleft_inv(e):
        # edge 1 is stored as v02, the opposite orientation of edge(vi2, vi0).
        pos = (e[..., 1] > 0) | ((e[..., 1] == 0) & (e[..., 0] < 0))
        neg = (e[..., 1] < 0) | ((e[..., 1] == 0) & (e[..., 0] > 0))
        return torch.where(den > 0, pos, neg)

    tl = torch.stack([topleft(v12), topleft_inv(v02), topleft(v01)], dim=-1)

    d_inv = 1.0 / epsclamp(z)
    q = d_inv / torch.abs(torch.where(den == 0, torch.ones_like(den), den))[..., None]

    return TriangleSetup(ea, eb, ec, tl, q, valid, bbox)


def _canvas_cull(setup: TriangleSetup, height: int, width: int) -> torch.Tensor:
    """``valid`` and the bbox reaches the canvas (the bbox test of the
    reference kernel, kept exactly for parity at boundary cases)."""
    min_x, min_y = setup.bbox[..., 0], setup.bbox[..., 1]
    max_x, max_y = setup.bbox[..., 2], setup.bbox[..., 3]
    in_canvas = (min_x <= (width - 1)) & (min_y <= (height - 1)) & (max_x > 0) & (max_y > 0)
    return setup.valid & in_canvas


def _chunk_windows(bbox, valid, height, width, chunk):
    """Per chunk of ``chunk`` triangles, the pixel window (x0, x1, y0, y1),
    inclusive, from the floor of the smallest to the ceiling of the largest
    bbox coordinate of its valid triangles, clipped to the canvas; None for
    a chunk with no valid triangle."""
    n, f_cnt = valid.shape
    n_chunks = -(-f_cnt // chunk)
    pad = n_chunks * chunk - f_cnt
    big = float(max(height, width) + 2)
    b = torch.nan_to_num(bbox, nan=0.0, posinf=big, neginf=-big).clamp(-big, big)
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ok = torch.nn.functional.pad(valid, (0, pad))
    b = b.reshape(n, n_chunks, chunk, 4).transpose(0, 1).reshape(n_chunks, -1, 4)
    ok = ok.reshape(n, n_chunks, chunk).transpose(0, 1).reshape(n_chunks, -1)
    lo = torch.where(ok[..., None], b[..., :2], torch.full_like(b[..., :2], big)).amin(1)
    hi = torch.where(ok[..., None], b[..., 2:], torch.full_like(b[..., 2:], -big)).amax(1)
    x0 = torch.floor(lo[:, 0]).clamp(min=0)
    y0 = torch.floor(lo[:, 1]).clamp(min=0)
    x1 = torch.ceil(hi[:, 0]).clamp(max=width - 1)
    y1 = torch.ceil(hi[:, 1]).clamp(max=height - 1)
    windows = torch.stack([x0, x1, y0, y1], dim=-1).to(torch.int64).tolist()
    has = ok.any(dim=1).tolist()
    return [
        tuple(wnd) if h and wnd[0] <= wnd[1] and wnd[2] <= wnd[3] else None
        for wnd, h in zip(windows, has)
    ]


def _rasterize_plain(
    setup: TriangleSetup, valid: torch.Tensor, height: int, width: int, chunk: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B1, a copy of the JAX package's
    portable resolve: loop over chunks of triangles, vectorize over pixels,
    merge each chunk into a (max inverse depth, min id) z-buffer.

    Each chunk is evaluated only on the pixel window around its
    triangles' bboxes (see :func:`_chunk_windows`): the window holds every
    pixel centre less than a pixel outside a bbox, and a centre further out
    fails one of the triangle's edge tests, so the result is that of
    evaluating every pixel.
    """
    ea, eb, ec, tl, q = setup.ea, setup.eb, setup.ec, setup.topleft, setup.q
    n, f_cnt = valid.shape
    dtype = ea.dtype
    dev = ea.device
    best_di = torch.full((n, height, width), float("-inf"), dtype=dtype, device=dev)
    best_id = torch.full((n, height, width), _INT32_MAX, dtype=torch.int32, device=dev)
    tri_ids = torch.arange(f_cnt, dtype=torch.int32, device=dev)

    windows = _chunk_windows(setup.bbox, valid, height, width, chunk)
    for c, wnd in enumerate(windows):
        if wnd is None:
            continue
        x0, x1, y0, y1 = wnd
        sl = slice(c * chunk, min((c + 1) * chunk, f_cnt))
        px = torch.arange(x0, x1 + 1, device=dev).to(dtype)[None, :]
        py = torch.arange(y0, y1 + 1, device=dev).to(dtype)[:, None]

        def cf(x):  # [N, K, 3] -> [N, K, 3, 1, 1]
            return x[:, sl, :, None, None]

        e = (cf(ea) * px + cf(eb) * py) + cf(ec)  # [N, K, 3, h, w]
        keep_edge = (e > 0) | ((e == 0) & cf(tl))
        keep = keep_edge.all(dim=2) & valid[:, sl, None, None]
        eq = e * cf(q)
        di = (eq[:, :, 0] + eq[:, :, 1]) + eq[:, :, 2]  # [N, K, h, w]
        di = torch.where(keep, di, torch.full_like(di, float("-inf")))
        ids = torch.where(keep, tri_ids[sl, None, None], _INT32_MAX)

        # Within-chunk: max inverse depth, ties to the smaller id.
        di_c = di.amax(dim=1)
        id_c = torch.where(di == di_c[:, None], ids, _INT32_MAX).amin(dim=1)

        bd = best_di[:, y0 : y1 + 1, x0 : x1 + 1]
        bi = best_id[:, y0 : y1 + 1, x0 : x1 + 1]
        take = (di_c > bd) | ((di_c == bd) & (id_c < bi))
        bd.copy_(torch.where(take, di_c, bd))
        bi.copy_(torch.where(take, id_c, bi))

    covered = best_id != _INT32_MAX
    index_img = torch.where(covered, best_id, -1)
    depth_img = torch.where(covered, 1.0 / epsclamp(best_di), torch.zeros((), dtype=dtype, device=dev))
    return depth_img, index_img


def rasterize_with_depth(
    v: torch.Tensor,
    vi: torch.Tensor,
    height: int,
    width: int,
    wireframe: bool = False,
    impl: str = "auto",
    y_offset: int = 0,
    full_height: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize and also return the (non-differentiable) depth image.

    Args:
        v: [N, V, 3] pixel-space vertices (x_pix, y_pix, z_cam).
        vi: [F, 3] or [N, F, 3] int32 face indices. The top nibble of
            ``vi[..., 0]`` is reserved, so at most 2**28 vertices.
        height, width: canvas size.
        wireframe, y_offset, full_height: not available in this package
            yet; passing them raises NotImplementedError.
        impl: "auto" runs kernel B1 for CUDA tensors and the plain version
            for CPU tensors; "plain" runs the plain version on any device.

    Returns:
        (depth_img [N, H, W] float, index_img [N, H, W] int32). Background
        pixels have depth 0 and index -1. The depth carries no gradient.
    """
    if wireframe:
        raise NotImplementedError("rasterize: wireframe=True is not ported yet")
    if y_offset != 0 or full_height is not None:
        raise NotImplementedError("rasterize: row-tile viewports (y_offset/full_height) are not ported yet")
    if v.ndim != 3 or v.shape[-1] != 3:
        raise ValueError(f"rasterize: expected v of shape [N, V, 3], got {tuple(v.shape)}")
    if vi.shape[-1] != 3 or vi.ndim not in (2, 3):
        raise ValueError(f"rasterize: expected vi of shape [F, 3] or [N, F, 3], got {tuple(vi.shape)}")
    if vi.dtype != torch.int32:
        raise ValueError(f"rasterize: expected int32 vi, got {vi.dtype}")
    if v.shape[1] >= 0x10000000:
        # The top nibble of vi[..., 0] is reserved for wireframe flags.
        raise ValueError("rasterize: at most 2**28 vertices are supported")
    if height <= 0 or width <= 0:
        raise ValueError("rasterize: height and width must be positive")
    vi = broadcast_vi(vi, v.shape[0])
    if vi.shape[0] != v.shape[0]:
        raise ValueError("rasterize: batch size of v and vi must match")
    if vi.device != v.device:
        raise ValueError(f"rasterize: v is on {v.device} but vi is on {vi.device}")
    if v.dtype in (torch.float16, torch.bfloat16):
        v = v.to(torch.float32)

    with torch.no_grad():
        v = v.detach()
        if impl == "plain" or (impl == "auto" and v.device.type == "cpu"):
            setup = triangle_setup(v, vi)
            return _rasterize_plain(setup, _canvas_cull(setup, height, width), height, width)
        if impl == "auto" and v.device.type == "cuda":
            from drtk_tpu_torch.ops.rasterize_cuda import rasterize_cuda

            return rasterize_cuda(v, vi, height, width)
    raise ValueError(f"rasterize: impl {impl!r} on device {v.device}")


def rasterize(
    v: torch.Tensor,
    vi: torch.Tensor,
    height: int,
    width: int,
    wireframe: bool = False,
    impl: str = "auto",
    y_offset: int = 0,
    full_height: int | None = None,
) -> torch.Tensor:
    """Rasterize a mesh; returns the int32 triangle-index image [N, H, W]
    (-1 at background). Not differentiable. See :func:`rasterize_with_depth`
    for the arguments."""
    _, index_img = rasterize_with_depth(v, vi, height, width, wireframe, impl, y_offset, full_height)
    return index_img
