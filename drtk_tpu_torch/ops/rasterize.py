"""Triangle rasterizer (counterpart of ``drtk_tpu/ops/rasterize.py``).

Same contract as the JAX package: pixel centres at integer coordinates,
canonical edge functions ordered by vertex index (shared edges are
watertight), the top-left fill rule, the z > 1e-8 near-plane cull, the
canvas cull, degenerate (all-equal) faces skipped, perspective depth from
linearly interpolated 1/z, and for each pixel the largest inverse depth
with ties going to the smaller triangle id. Outputs are an int32 index
image with -1 at background and a float depth image with 0 at background.

Wireframe mode is the diamond-exit line rasterizer: triangle interiors
occlude by depth, the index is written only where a visible edge (bits
28-30 of ``vi[..., 0]``) crosses the pixel's unit diamond, and pixels on
the frame border are never written.

Row-tile viewports (``y_offset``, ``full_height``) return rows
``[y_offset, y_offset + height)`` of the ``full_height``-row frame bit for
bit: the pixel grid moves, the edge functions do not, and the canvas cull
and the wireframe border test stay against the whole frame.

Triangle setup runs as torch ops; the per-pixel resolve is kernel B1
(``csrc/rasterize.cu``) or, in wireframe mode, kernel B5
(``csrc/rasterize_lines.cu``) on a CUDA tensor, and :func:`_rasterize_plain`
or :func:`_rasterize_lines_plain` on a CPU tensor. Rasterization is not
differentiable: gradients at visibility edges come from
:func:`drtk_tpu_torch.edge_grad_estimator`.
"""

from __future__ import annotations

import operator
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


class LineSetup(NamedTuple):
    """What wireframe mode needs beyond :class:`TriangleSetup`, [N, F, ...]."""

    p: torch.Tensor  # [N, F, 3, 2] the corners' pixel positions
    d_inv: torch.Tensor  # [N, F, 3] 1 / epsclamp(z) per corner
    inv_den: torch.Tensor  # [N, F] 1 / |twice the signed area| (1 where it is 0)
    vis: torch.Tensor  # [N, F, 3] bool: edges (0,1), (1,2), (0,2) visible


def _mask_vi(vi: torch.Tensor) -> torch.Tensor:
    """vi with the wireframe nibble (bits 28-31 of ``vi[..., 0]``) cleared."""
    return torch.stack([vi[..., 0] & 0x0FFFFFFF, vi[..., 1], vi[..., 2]], dim=-1)


def _gather_faces(v: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
    """v [N, V, C], vi [N, F, 3] -> [N, F, 3, C]. Out-of-range indices are
    clamped into [0, V), as JAX's gathers clamp them."""
    n, num_v = v.shape[:2]
    idx = vi.long().clamp(0, max(num_v - 1, 0))
    return v[torch.arange(n, device=v.device)[:, None, None], idx]


def triangle_setup(v: torch.Tensor, vi: torch.Tensor) -> TriangleSetup:
    """Screen-space triangle setup: edge functions, top-left flags,
    inverse-depth coefficients, validity and bounding boxes."""
    vi_m = _mask_vi(vi)
    vi0, vi1, vi2 = vi_m.unbind(-1)

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


def line_setup(v: torch.Tensor, vi: torch.Tensor) -> LineSetup:
    """The corners, inverse depths, inverse area and edge-visibility bits of
    wireframe mode. ``>>`` on int32 is arithmetic, so a nibble >= 8 makes
    ``vi[..., 0]`` negative; ``& 7`` keeps the three visibility bits."""
    flags = (vi[..., 0] >> 28) & 7
    vis = torch.stack([(flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0], dim=-1)
    f = _gather_faces(v, _mask_vi(vi))  # [N, F, 3, 3]
    p = f[..., :2]
    d_inv = 1.0 / epsclamp(f[..., 2])
    v01 = p[..., 1, :] - p[..., 0, :]
    v02 = p[..., 2, :] - p[..., 0, :]
    den_abs = torch.abs(v01[..., 0] * v02[..., 1] - v01[..., 1] * v02[..., 0])
    inv_den = 1.0 / torch.where(den_abs == 0, torch.ones_like(den_abs), den_abs)
    return LineSetup(p, d_inv, inv_den, vis)


def _canvas_cull(setup: TriangleSetup, height: int, width: int) -> torch.Tensor:
    """``valid`` and the bbox reaches the canvas (the bbox test of the
    reference kernel, kept exactly for parity at boundary cases)."""
    min_x, min_y = setup.bbox[..., 0], setup.bbox[..., 1]
    max_x, max_y = setup.bbox[..., 2], setup.bbox[..., 3]
    in_canvas = (min_x <= (width - 1)) & (min_y <= (height - 1)) & (max_x > 0) & (max_y > 0)
    return setup.valid & in_canvas


def pixel_windows(bbox, x_range, y_range, grow: int = 0):
    """Per bbox ``[..., 4]``, the inclusive pixel window (x0, x1, y0, y1),
    each ``[...]`` float: from the floor of the bbox minimum to the ceiling
    of its maximum, grown by ``grow`` pixels on every side and clipped to
    the inclusive ranges ``x_range`` and ``y_range``. The window holds every
    pixel centre less than ``grow + 1`` pixels outside the bbox; an empty
    window has x0 > x1 or y0 > y1."""
    (xa, xb), (ya, yb) = x_range, y_range
    # Clamp before rounding so huge or infinite coordinates convert safely;
    # NaN coordinates only occur on triangles whose edge tests all fail.
    lim = float(max(abs(xa), abs(xb), abs(ya), abs(yb)) + grow + 2)
    b = torch.nan_to_num(bbox, nan=0.0, posinf=lim, neginf=-lim).clamp(-lim, lim)
    x0 = (torch.floor(b[..., 0]) - grow).clamp(min=xa)
    y0 = (torch.floor(b[..., 1]) - grow).clamp(min=ya)
    x1 = (torch.ceil(b[..., 2]) + grow).clamp(max=xb)
    y1 = (torch.ceil(b[..., 3]) + grow).clamp(max=yb)
    return x0, x1, y0, y1


def _chunk_windows(bbox, valid, x_range, y_range, chunk, grow=0):
    """Per chunk of ``chunk`` triangles, the union over the chunk's valid
    triangles (and the batch) of their :func:`pixel_windows`, as an
    inclusive (x0, x1, y0, y1); None for a chunk with nothing to do."""
    n, f_cnt = valid.shape
    n_chunks = -(-f_cnt // chunk)
    pad = n_chunks * chunk - f_cnt
    x0, x1, y0, y1 = pixel_windows(bbox, x_range, y_range, grow)
    wnd = torch.nn.functional.pad(torch.stack([x0, x1, y0, y1], dim=-1), (0, 0, 0, pad))
    ok = torch.nn.functional.pad(valid, (0, pad))
    wnd = wnd.reshape(n, n_chunks, chunk, 4).transpose(0, 1).reshape(n_chunks, -1, 4)
    ok = ok.reshape(n, n_chunks, chunk).transpose(0, 1).reshape(n_chunks, -1)
    big = float("inf")
    lo = torch.where(ok[..., None], wnd[..., 0::2], big).amin(1)
    hi = torch.where(ok[..., None], wnd[..., 1::2], -big).amax(1)
    bounds = torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], dim=-1)
    windows = torch.nan_to_num(bounds, posinf=0.0, neginf=-1.0).to(torch.int64).tolist()
    has = ok.any(dim=1).tolist()
    return [
        tuple(w) if h and w[0] <= w[1] and w[2] <= w[3] else None
        for w, h in zip(windows, has)
    ]


def _merge_chunk(best_di, best_id, wnd, y_offset, di, ids):
    """Fold one chunk's per-triangle inverse depths ``di`` [N, K, h, w]
    (-inf where a triangle writes nothing) and ids into the z-buffer over
    window ``wnd``: the largest inverse depth wins, ties to the smaller id."""
    x0, x1, y0, y1 = wnd
    di_c = di.amax(dim=1)
    id_c = torch.where(di == di_c[:, None], ids, _INT32_MAX).amin(dim=1)
    rows = slice(y0 - y_offset, y1 - y_offset + 1)
    bd = best_di[:, rows, x0 : x1 + 1]
    bi = best_id[:, rows, x0 : x1 + 1]
    take = (di_c > bd) | ((di_c == bd) & (id_c < bi))
    bd.copy_(torch.where(take, di_c, bd))
    bi.copy_(torch.where(take, id_c, bi))


def _edge_values(setup: TriangleSetup, sl: slice, px, py):
    """Edge values ``(ea*x + eb*y) + ec`` of triangles ``sl`` at pixel
    centres ``px`` [1, w], ``py`` [h, 1]: three [N, K, h, w] tensors, and the
    fill-rule coverage test (every edge > 0, or == 0 on a top-left edge)."""
    e, keep = [], None
    for k in range(3):
        ek = (setup.ea[:, sl, k, None, None] * px + setup.eb[:, sl, k, None, None] * py) + setup.ec[
            :, sl, k, None, None
        ]
        kk = (ek > 0) | ((ek == 0) & setup.topleft[:, sl, k, None, None])
        e.append(ek)
        keep = kk if keep is None else keep & kk
    return e, keep


def _rasterize_plain(
    setup: TriangleSetup,
    valid: torch.Tensor,
    height: int,
    width: int,
    chunk: int = 32,
    y_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B1, a copy of the JAX package's
    portable resolve: loop over chunks of triangles, vectorize over pixels,
    merge each chunk into a (max inverse depth, min id) z-buffer. Returns
    rows [y_offset, y_offset + height) of the frame.

    Each chunk is evaluated only on the pixel window around its
    triangles' bboxes (see :func:`_chunk_windows`): the window holds every
    pixel centre less than a pixel outside a bbox, and a centre further out
    fails one of the triangle's edge tests, so the result is that of
    evaluating every pixel.
    """
    q = setup.q
    n, f_cnt = valid.shape
    dtype = q.dtype
    dev = q.device
    best_di = torch.full((n, height, width), float("-inf"), dtype=dtype, device=dev)
    best_id = torch.full((n, height, width), _INT32_MAX, dtype=torch.int32, device=dev)
    tri_ids = torch.arange(f_cnt, dtype=torch.int32, device=dev)

    y_range = (y_offset, y_offset + height - 1)
    for c, wnd in enumerate(_chunk_windows(setup.bbox, valid, (0, width - 1), y_range, chunk)):
        if wnd is None:
            continue
        x0, x1, y0, y1 = wnd
        sl = slice(c * chunk, min((c + 1) * chunk, f_cnt))
        px = torch.arange(x0, x1 + 1, device=dev).to(dtype)[None, :]
        py = torch.arange(y0, y1 + 1, device=dev).to(dtype)[:, None]
        e, keep = _edge_values(setup, sl, px, py)
        keep = keep & valid[:, sl, None, None]
        di = (e[0] * q[:, sl, 0, None, None] + e[1] * q[:, sl, 1, None, None]) + e[2] * q[:, sl, 2, None, None]
        di = torch.where(keep, di, float("-inf"))
        ids = torch.where(keep, tri_ids[sl, None, None], _INT32_MAX)
        _merge_chunk(best_di, best_id, wnd, y_offset, di, ids)

    covered = best_id != _INT32_MAX
    index_img = torch.where(covered, best_id, -1)
    depth_img = torch.where(covered, 1.0 / epsclamp(best_di), torch.zeros((), dtype=dtype, device=dev))
    return depth_img, index_img


def _diamond_crossing(p1x, p1y, p2x, p2y, px, py):
    """True where segment (p1, p2) crosses the unit diamond centred at pixel
    (px, py): the segment's line meets one of the diamond's four sides at a
    point inside both. Each product, sum and quotient is its own torch op,
    in the order kernel B5 rounds them."""
    a0 = p1y - p2y
    b0 = p2x - p1x
    c0 = p1x * p2y - p2x * p1y
    big = torch.finfo(px.dtype).max

    def in_seg(ax, ay, bx, by, cx, cy):
        return (((bx >= cx) & (cx >= ax)) | ((bx <= cx) & (cx <= ax))) & (
            ((by >= cy) & (cy >= ay)) | ((by <= cy) & (cy <= ay))
        )

    def seg_cross(s0x, s0y, s1x, s1y):
        a2 = s0y - s1y
        b2 = s1x - s0x
        c2 = s0x * s1y - s1x * s0y
        d = a0 * b2 - a2 * b0
        flat = d == 0
        safe_d = torch.where(flat, 1.0, d)
        cx = torch.where(flat, big, (b0 * c2 - b2 * c0) / safe_d)
        cy = torch.where(flat, big, (a2 * c0 - a0 * c2) / safe_d)
        return in_seg(s0x, s0y, s1x, s1y, cx, cy) & in_seg(p1x, p1y, p2x, p2y, cx, cy)

    hit = seg_cross(px, py - 0.5, px + 0.5, py)
    hit |= seg_cross(px + 0.5, py, px, py + 0.5)
    hit |= seg_cross(px, py + 0.5, px - 0.5, py)
    hit |= seg_cross(px - 0.5, py, px, py - 0.5)
    return hit


def line_ranges(height: int, width: int, y_offset: int, full_height: int):
    """The inclusive x and y ranges wireframe mode may write in a viewport:
    the frame border (x in [1, W-2], y in [1, full_height-2]) is never
    written."""
    return (1, width - 2), (max(1, y_offset), min(full_height - 2, y_offset + height - 1))


def _rasterize_lines_plain(
    setup: TriangleSetup,
    lines: LineSetup,
    valid: torch.Tensor,
    height: int,
    width: int,
    y_offset: int,
    full_height: int,
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B5, after the JAX package's
    ``_rasterize_lines_impl``: per chunk of triangles, a pixel writes where
    it is inside the triangle (fill rule) or a visible edge crosses its
    diamond, and not on the frame border; its inverse depth interpolates
    ``d_inv`` with the clipped, renormalised barycentrics ``b = clip(e *
    inv_den, 0, 1) / sum(b)``. The id is the triangle's where an edge
    crosses and INT32_MAX on interior pixels, so those occlude by depth,
    lose id ties and end as index -1 with their depth written.

    Each chunk is evaluated on the window of its bboxes grown by one pixel
    on every side (a diamond reaches half a pixel beyond a segment's bbox),
    clipped to the writable rows and columns (:func:`line_ranges`).
    """
    n, f_cnt = valid.shape
    dtype = setup.q.dtype
    dev = setup.q.device
    best_di = torch.full((n, height, width), float("-inf"), dtype=dtype, device=dev)
    best_id = torch.full((n, height, width), _INT32_MAX, dtype=torch.int32, device=dev)
    tri_ids = torch.arange(f_cnt, dtype=torch.int32, device=dev)
    p, d_inv, inv_den, vis = lines

    x_range, y_range = line_ranges(height, width, y_offset, full_height)
    for c, wnd in enumerate(_chunk_windows(setup.bbox, valid, x_range, y_range, chunk, grow=1)):
        if wnd is None:
            continue
        x0, x1, y0, y1 = wnd
        sl = slice(c * chunk, min((c + 1) * chunk, f_cnt))
        px = torch.arange(x0, x1 + 1, device=dev).to(dtype)[None, :]
        py = torch.arange(y0, y1 + 1, device=dev).to(dtype)[:, None]
        e, inside = _edge_values(setup, sl, px, py)

        def corner(i):
            return p[:, sl, i, 0, None, None], p[:, sl, i, 1, None, None]

        crossing = None
        for k, (i, j) in enumerate(((0, 1), (1, 2), (0, 2))):
            hit = _diamond_crossing(*corner(i), *corner(j), px, py) & vis[:, sl, k, None, None]
            crossing = hit if crossing is None else crossing | hit
        write = (inside | crossing) & valid[:, sl, None, None]

        b = [torch.clamp(ek * inv_den[:, sl, None, None], 0.0, 1.0) for ek in e]
        bs = (b[0] + b[1]) + b[2]
        di = ((b[0] / bs) * d_inv[:, sl, 0, None, None] + (b[1] / bs) * d_inv[:, sl, 1, None, None]) + (
            b[2] / bs
        ) * d_inv[:, sl, 2, None, None]
        di = torch.where(write, di, float("-inf"))
        ids = torch.where(write & crossing, tri_ids[sl, None, None], _INT32_MAX)
        _merge_chunk(best_di, best_id, wnd, y_offset, di, ids)

    covered = torch.isfinite(best_di)
    index_img = torch.where(covered & (best_id != _INT32_MAX), best_id, -1)
    depth_img = torch.where(covered, 1.0 / epsclamp(best_di), torch.zeros((), dtype=dtype, device=dev))
    return depth_img, index_img


def _frame_height(height: int, y_offset, full_height) -> Tuple[int, int]:
    """Validated (y_offset, frame height) of a row-tile viewport."""
    try:
        y_offset = operator.index(y_offset)
    except TypeError:
        raise ValueError(f"rasterize: y_offset must be an int, got {y_offset!r}") from None
    full_height = height if full_height is None else operator.index(full_height)
    if y_offset < 0 or full_height < y_offset + height:
        raise ValueError(
            f"rasterize: rows [{y_offset}, {y_offset + height}) do not lie in a frame of "
            f"{full_height} rows (pass full_height >= y_offset + height)"
        )
    return y_offset, full_height


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
            ``vi[..., 0]`` is reserved, so at most 2**28 vertices; in
            wireframe mode its bits 28, 29 and 30 mark the edges (0, 1),
            (1, 2) and (0, 2) visible.
        height, width: canvas size (of the viewport, with ``y_offset``).
        wireframe: diamond-exit line rasterization: interiors occlude by
            depth, the index is written only where a visible edge crosses a
            pixel, and the frame's border pixels are never written.
        impl: "auto" runs kernel B1 (B5 in wireframe mode) for CUDA tensors
            and the plain version for CPU tensors; "plain" runs the plain
            version on any device.
        y_offset, full_height: a row-tile viewport, rows
            ``[y_offset, y_offset + height)`` of a ``full_height``-row frame
            (default ``height``), bit-exact with the full frame. Raises
            ValueError unless ``0 <= y_offset`` and
            ``y_offset + height <= full_height``.

    Returns:
        (depth_img [N, H, W] float, index_img [N, H, W] int32). Background
        pixels have depth 0 and index -1. The depth carries no gradient.
    """
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
    y_offset, frame_h = _frame_height(height, y_offset, full_height)
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
            valid = _canvas_cull(setup, frame_h, width)
            if wireframe:
                return _rasterize_lines_plain(setup, line_setup(v, vi), valid, height, width, y_offset, frame_h)
            return _rasterize_plain(setup, valid, height, width, y_offset=y_offset)
        if impl == "auto" and v.device.type == "cuda":
            from drtk_tpu_torch.ops import rasterize_cuda

            if wireframe:
                return rasterize_cuda.rasterize_lines_cuda(v, vi, height, width, y_offset, frame_h)
            return rasterize_cuda.rasterize_cuda(v, vi, height, width, y_offset, frame_h)
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
