"""Plain triangle rasterizer of the reference: the index image of a frame or
of a row band, in float32.

Frozen copy of ``drtk_tpu_torch/ops/rasterize.py`` (``triangle_setup``,
``_canvas_cull``, ``pixel_windows``, ``_chunk_windows``, ``_merge_chunk``,
``_edge_values``, ``_rasterize_plain``) without the wireframe path: pixel
centres at integer coordinates, canonical edge functions ordered by vertex
index, the top-left fill rule, the z > 1e-8 near-plane cull, the canvas
cull, and per pixel the largest inverse depth with ties to the smaller
triangle id. Not differentiable.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_INT32_MAX = torch.iinfo(torch.int32).max
_Z_CULL_EPS = 1e-8


def epsclamp(x: torch.Tensor) -> torch.Tensor:
    """Clamp away from zero, keeping the sign (-0.0 and 0.0 go to +eps)."""
    eps = 1e-16 if x.dtype == torch.float64 else 1e-8
    return torch.where(x < 0, torch.clamp(x, max=-eps), torch.clamp(x, min=eps))


def broadcast_vi(vi: torch.Tensor, batch: int) -> torch.Tensor:
    """[F, 3] -> [N, F, 3]; [N, F, 3] passes through."""
    return vi[None].expand((batch,) + tuple(vi.shape)) if vi.ndim == 2 else vi


class TriangleSetup(NamedTuple):
    ea: torch.Tensor
    eb: torch.Tensor
    ec: torch.Tensor
    topleft: torch.Tensor
    q: torch.Tensor
    valid: torch.Tensor
    bbox: torch.Tensor


def _gather_faces(v: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
    n, num_v = v.shape[:2]
    idx = vi.long().clamp(0, max(num_v - 1, 0))
    return v[torch.arange(n, device=v.device)[:, None, None], idx]


def triangle_setup(v: torch.Tensor, vi: torch.Tensor) -> TriangleSetup:
    vi_m = torch.stack([vi[..., 0] & 0x0FFFFFFF, vi[..., 1], vi[..., 2]], dim=-1)
    vi0, vi1, vi2 = vi_m.unbind(-1)
    degenerate = (vi0 == vi1) & (vi1 == vi2)
    f = _gather_faces(v, vi_m)
    p, z = f[..., :2], f[..., 2]
    p0, p1, p2 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    v01, v02, v12 = p1 - p0, p2 - p0, p2 - p1
    den = v01[..., 0] * v02[..., 1] - v01[..., 1] * v02[..., 0]
    sgn = torch.sign(den)
    bbox = torch.cat([torch.minimum(torch.minimum(p0, p1), p2), torch.maximum(torch.maximum(p0, p1), p2)], dim=-1)
    valid = (z > _Z_CULL_EPS).all(dim=-1) & (den != 0) & ~degenerate

    def edge_coeffs(via, vib, pa, pb):
        vab = pb - pa
        anchor = torch.where((via > vib)[..., None], pb, pa)
        return -vab[..., 1], vab[..., 0], vab[..., 1] * anchor[..., 0] - vab[..., 0] * anchor[..., 1]

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
        pos = (e[..., 1] > 0) | ((e[..., 1] == 0) & (e[..., 0] < 0))
        neg = (e[..., 1] < 0) | ((e[..., 1] == 0) & (e[..., 0] > 0))
        return torch.where(den > 0, pos, neg)

    tl = torch.stack([topleft(v12), topleft_inv(v02), topleft(v01)], dim=-1)
    q = (1.0 / epsclamp(z)) / torch.abs(torch.where(den == 0, torch.ones_like(den), den))[..., None]
    return TriangleSetup(ea, eb, ec, tl, q, valid, bbox)


def _canvas_cull(setup: TriangleSetup, height: int, width: int) -> torch.Tensor:
    min_x, min_y, max_x, max_y = setup.bbox.unbind(-1)
    return setup.valid & (min_x <= (width - 1)) & (min_y <= (height - 1)) & (max_x > 0) & (max_y > 0)


def _pixel_windows(bbox, x_range, y_range):
    (xa, xb), (ya, yb) = x_range, y_range
    lim = float(max(abs(xa), abs(xb), abs(ya), abs(yb)) + 2)
    b = torch.nan_to_num(bbox, nan=0.0, posinf=lim, neginf=-lim).clamp(-lim, lim)
    return (torch.floor(b[..., 0]).clamp(min=xa), torch.ceil(b[..., 2]).clamp(max=xb),
            torch.floor(b[..., 1]).clamp(min=ya), torch.ceil(b[..., 3]).clamp(max=yb))


def _chunk_windows(bbox, valid, x_range, y_range, chunk):
    n, f_cnt = valid.shape
    n_chunks = -(-f_cnt // chunk)
    pad = n_chunks * chunk - f_cnt
    wnd = torch.nn.functional.pad(torch.stack(_pixel_windows(bbox, x_range, y_range), dim=-1), (0, 0, 0, pad))
    ok = torch.nn.functional.pad(valid, (0, pad))
    wnd = wnd.reshape(n, n_chunks, chunk, 4).transpose(0, 1).reshape(n_chunks, -1, 4)
    ok = ok.reshape(n, n_chunks, chunk).transpose(0, 1).reshape(n_chunks, -1)
    big = float("inf")
    lo = torch.where(ok[..., None], wnd[..., 0::2], big).amin(1)
    hi = torch.where(ok[..., None], wnd[..., 1::2], -big).amax(1)
    bounds = torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], dim=-1)
    windows = torch.nan_to_num(bounds, posinf=0.0, neginf=-1.0).to(torch.int64).tolist()
    has = ok.any(dim=1).tolist()
    return [tuple(w) if h and w[0] <= w[1] and w[2] <= w[3] else None for w, h in zip(windows, has)]


def rasterize(v: torch.Tensor, vi: torch.Tensor, height: int, width: int, y_offset: int = 0,
              full_height: int | None = None, chunk: int = 32) -> torch.Tensor:
    """The int32 index image [N, height, W] (-1 at background) of rows
    ``[y_offset, y_offset + height)`` of a ``full_height``-row frame, from
    pixel-space vertices ``v`` [N, V, 3] (float32) and faces ``vi``."""
    full_height = height if full_height is None else full_height
    with torch.no_grad():
        v = v.detach().to(torch.float32)
        vi = broadcast_vi(vi, v.shape[0])
        setup = triangle_setup(v, vi)
        valid = _canvas_cull(setup, full_height, width)
        n, f_cnt = valid.shape
        dev = v.device
        best_di = torch.full((n, height, width), float("-inf"), dtype=torch.float32, device=dev)
        best_id = torch.full((n, height, width), _INT32_MAX, dtype=torch.int32, device=dev)
        tri_ids = torch.arange(f_cnt, dtype=torch.int32, device=dev)
        q = setup.q
        y_range = (y_offset, y_offset + height - 1)
        for c, wnd in enumerate(_chunk_windows(setup.bbox, valid, (0, width - 1), y_range, chunk)):
            if wnd is None:
                continue
            x0, x1, y0, y1 = wnd
            sl = slice(c * chunk, min((c + 1) * chunk, f_cnt))
            px = torch.arange(x0, x1 + 1, device=dev).to(torch.float32)[None, :]
            py = torch.arange(y0, y1 + 1, device=dev).to(torch.float32)[:, None]
            e, keep = [], None
            for k in range(3):
                ek = (setup.ea[:, sl, k, None, None] * px + setup.eb[:, sl, k, None, None] * py) + setup.ec[
                    :, sl, k, None, None]
                kk = (ek > 0) | ((ek == 0) & setup.topleft[:, sl, k, None, None])
                e.append(ek)
                keep = kk if keep is None else keep & kk
            keep = keep & valid[:, sl, None, None]
            di = (e[0] * q[:, sl, 0, None, None] + e[1] * q[:, sl, 1, None, None]) + e[2] * q[:, sl, 2, None, None]
            di = torch.where(keep, di, float("-inf"))
            ids = torch.where(keep, tri_ids[sl, None, None], _INT32_MAX)
            di_c = di.amax(dim=1)
            id_c = torch.where(di == di_c[:, None], ids, _INT32_MAX).amin(dim=1)
            rows = slice(y0 - y_offset, y1 - y_offset + 1)
            bd = best_di[:, rows, x0: x1 + 1]
            bi = best_id[:, rows, x0: x1 + 1]
            take = (di_c > bd) | ((di_c == bd) & (id_c < bi))
            bd.copy_(torch.where(take, di_c, bd))
            bi.copy_(torch.where(take, id_c, bi))
        return torch.where(best_id != _INT32_MAX, best_id, -1)
