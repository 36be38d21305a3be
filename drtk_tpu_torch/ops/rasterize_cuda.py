"""Wrappers of kernels B1 and B5, the rasterizer's per-pixel resolves on
the card (counterparts of ``drtk_tpu/ops/rasterize_pallas.py``).

The triangle setup (``triangle_setup``, ``line_setup`` and the canvas cull)
stays in torch. :func:`pack_setup` packs it into one row per triangle for
``csrc/rasterize.cu`` (B1, filled triangles), which bins the triangles
into screen tiles on the device and resolves each tile's z-buffer in
registers; :func:`pack_lines` into one row per triangle plus the running
count of window pixels for ``csrc/rasterize_lines.cu`` (B5, wireframe),
which resolves into a 64-bit key per pixel and unpacks it to (depth,
index).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from drtk_tpu_torch import _build, tracing
from drtk_tpu_torch.ops.rasterize import (
    LineSetup,
    TriangleSetup,
    _canvas_cull,
    line_ranges,
    line_setup,
    pixel_windows,
    triangle_setup,
)

__all__ = ["pack_lines", "pack_setup", "rasterize_cuda", "rasterize_lines_cuda"]

SETUP_FLOATS = 12  # ea[3], eb[3], ec[3], q[3]
SETUP_INTS = 5  # top-left bits, x_lo, x_hi, y_lo, y_hi
LINE_FLOATS = 19  # ea[3], eb[3], ec[3], p0 p1 p2 (x, y), d_inv[3], inv_den
LINE_INTS = 5  # top-left bits | visibility bits << 3, x_lo, x_hi, y_lo, y_hi
TILE = 16  # B1's screen tiles are TILE x TILE pixels (kTile in csrc/rasterize.cu)
MAX_TILES = 16  # a triangle whose pixel range touches more tiles goes to its batch's big list (kMaxTiles)
_MAX_BATCH = 65535  # B1 takes the batch from blockIdx.y
_B1_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int32] * 5 + [ctypes.c_void_p]
_B5_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int32] * 5 + [ctypes.c_void_p]


class TileBins(NamedTuple):
    """Kernel B1's device-built bins of one call, all int32. The tiles of
    batch n are ``n*T .. n*T + T - 1``, row-major, with ``T =
    ceil(H/TILE) * ceil(W/TILE)``."""

    starts: torch.Tensor  # [N*T + 1] segment starts in ``pairs``; starts[-1] = pairs in use
    big_count: torch.Tensor  # [N] triangles in each batch's big list
    pairs: torch.Tensor  # [N*F*MAX_TILES] triangle ids by tile segment (capacity)
    big: torch.Tensor  # [N*F] each batch's big list, from n*F (capacity)


def _window_meta(bits, x0, x1, y0, y1, valid):
    """[N, F, 5] int32 rows (bits, x_lo, x_hi, y_lo, y_hi); culled
    triangles get an empty x range."""
    x1 = torch.where(valid, x1, x0 - 1)
    meta = torch.stack([x0, x1, y0, y1], dim=-1).to(torch.int32)
    return torch.cat([bits[..., None], meta], dim=-1).contiguous()


def _topleft_bits(setup: TriangleSetup) -> torch.Tensor:
    tl = setup.topleft.to(torch.int32)
    return tl[..., 0] | (tl[..., 1] << 1) | (tl[..., 2] << 2)


def _check_rows(name, rows, meta, n_floats, n_ints):
    if rows.device.type != "cuda" or meta.device != rows.device:
        raise ValueError(f"{name}: setup rows must lie on one CUDA device")
    if rows.dtype != torch.float32 or meta.dtype != torch.int32:
        raise TypeError(f"{name}: expected f32 rows and int32 meta")
    n, f_cnt, width_r = rows.shape
    if width_r != n_floats or meta.shape != (n, f_cnt, n_ints):
        raise ValueError(f"{name}: bad setup shapes {tuple(rows.shape)}, {tuple(meta.shape)}")
    if not (rows.is_contiguous() and meta.is_contiguous()):
        raise ValueError(f"{name}: setup rows must be contiguous")
    if n * f_cnt >= 2**31:
        raise ValueError(f"{name}: at most 2**31 - 1 triangles per launch")
    return n, f_cnt


def pack_setup(
    setup: TriangleSetup, valid: torch.Tensor, height: int, width: int, y_offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack the setup into ``coef [N, F, 12] f32`` and ``meta [N, F, 5]
    int32``. A triangle's pixel range runs, inclusive, from the floor of its
    bbox minimum to the ceiling of its maximum, clipped to the viewport's
    rows ``[y_offset, y_offset + height)`` and columns: every pixel centre
    less than a pixel outside the bbox is tested, as in the plain version.
    Culled triangles get an empty range."""
    coef = torch.cat([setup.ea, setup.eb, setup.ec, setup.q], dim=-1).to(torch.float32)
    windows = pixel_windows(setup.bbox, (0, width - 1), (y_offset, y_offset + height - 1))
    return coef.contiguous(), _window_meta(_topleft_bits(setup), *windows, valid)


def resolve_packed(
    coef: torch.Tensor, meta: torch.Tensor, height: int, width: int, y_offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B1 on packed setup rows; returns (depth f32, index i32),
    each [N, H, W], rows [y_offset, y_offset + height) of the frame."""
    depth, index, _ = _launch_b1(coef, meta, height, width, y_offset)
    return depth, index


def _bin_sizes(n: int, f_cnt: int, height: int, width: int) -> Tuple[int, int, int, int, int]:
    """Words of B1's int32 scratch, in its order: tile counts, big-list
    counts, segment starts, pairs, big lists."""
    n_tiles = n * -(-height // TILE) * -(-width // TILE)
    return n_tiles, n, n_tiles + 1, n * f_cnt * MAX_TILES, n * f_cnt


def _launch_b1(coef, meta, height: int, width: int, y_offset: int):
    """Launch kernel B1; returns (depth, index, the int32 scratch that holds
    its bins)."""
    n, f_cnt = _check_rows("rasterize_cuda", coef, meta, SETUP_FLOATS, SETUP_INTS)
    sizes = _bin_sizes(n, f_cnt, height, width)
    if n > _MAX_BATCH or sizes[3] >= 2**31 or sizes[0] >= 2**31:
        raise ValueError(
            f"rasterize_cuda: the kernel takes at most {_MAX_BATCH} batches and 32-bit bin offsets, "
            f"got N={n}, F={f_cnt}, {sizes[0]} tiles"
        )
    dev = coef.device
    depth = torch.empty((n, height, width), dtype=torch.float32, device=dev)
    index = torch.empty((n, height, width), dtype=torch.int32, device=dev)
    scratch = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    fn = _build.entry("rasterize", "drtk_rasterize_f32", _B1_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        coef.data_ptr(), meta.data_ptr(), depth.data_ptr(), index.data_ptr(), scratch.data_ptr(),
        n, f_cnt, height, width, y_offset, stream,
    )
    _build.check("rasterize", err, "rasterize kernel")
    tracing.launched("B1 rasterize")
    return depth, index, scratch


def _resolve_binned(coef, meta, height: int, width: int, y_offset: int = 0):
    """:func:`resolve_packed`, also returning the call's :class:`TileBins`."""
    depth, index, scratch = _launch_b1(coef, meta, height, width, y_offset)
    _, big_count, starts, pairs, big = scratch.split(_bin_sizes(*coef.shape[:2], height, width))
    return depth, index, TileBins(starts, big_count, pairs, big)


def rasterize_cuda(
    v: torch.Tensor, vi: torch.Tensor, height: int, width: int, y_offset: int, full_height: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize validated ``v [N, V, 3]``, ``vi [N, F, 3]`` int32 with
    kernel B1. The setup is computed in float32 whatever the dtype of
    ``v``, as the TPU kernel does; the depth comes back in that dtype.
    Returns (depth [N, H, W], index [N, H, W] int32), 0 / -1 at background,
    rows [y_offset, y_offset + height) of a ``full_height``-row frame."""
    setup = triangle_setup(v.to(torch.float32), vi)
    valid = _canvas_cull(setup, full_height, width)
    coef, meta = pack_setup(setup, valid, height, width, y_offset)
    depth, index = resolve_packed(coef, meta, height, width, y_offset)
    return depth.to(v.dtype), index


def pack_lines(
    setup: TriangleSetup,
    lines: LineSetup,
    valid: torch.Tensor,
    height: int,
    width: int,
    y_offset: int,
    full_height: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the wireframe setup into ``rows [N, F, 19] f32``, ``meta
    [N, F, 5] int32`` and ``ends [N*F] int64``. A triangle's window is its
    bbox grown by one pixel on every side (a diamond reaches half a pixel
    beyond a segment's bbox), clipped to the pixels the viewport may write
    (:func:`~drtk_tpu_torch.ops.rasterize.line_ranges`); ``ends`` is the
    inclusive running sum of the window areas, from which each thread of
    kernel B5 finds its (triangle, pixel)."""
    p, d_inv, inv_den, vis = lines
    n, f_cnt = valid.shape
    rows = torch.cat(
        [setup.ea, setup.eb, setup.ec, p.reshape(n, f_cnt, 6), d_inv, inv_den[..., None]], dim=-1
    ).to(torch.float32)
    vis_i = vis.to(torch.int32)
    bits = _topleft_bits(setup) | (vis_i[..., 0] << 3) | (vis_i[..., 1] << 4) | (vis_i[..., 2] << 5)
    x_range, y_range = line_ranges(height, width, y_offset, full_height)
    meta = _window_meta(bits, *pixel_windows(setup.bbox, x_range, y_range, grow=1), valid)
    m = meta.long()
    area = (m[..., 2] - m[..., 1] + 1).clamp(min=0) * (m[..., 4] - m[..., 3] + 1).clamp(min=0)
    return rows.contiguous(), meta, torch.cumsum(area.reshape(-1), 0)


def resolve_lines_packed(
    rows: torch.Tensor, meta: torch.Tensor, ends: torch.Tensor, height: int, width: int, y_offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B5 on packed wireframe rows; returns (depth f32, index
    i32), each [N, H, W], rows [y_offset, y_offset + height) of the frame.
    Raises ``ValueError`` before it allocates when H*W >= 2**31."""
    n, f_cnt = _check_rows("rasterize_lines_cuda", rows, meta, LINE_FLOATS, LINE_INTS)
    if ends.dtype != torch.int64 or ends.shape != (n * f_cnt,) or ends.device != rows.device:
        raise ValueError("rasterize_lines_cuda: ends must be int64 [N*F] beside the rows")
    if height * width >= 2**31:
        raise ValueError(
            f"rasterize_lines_cuda: the kernel's in-window offsets are 32-bit, so H*W must stay below 2**31, "
            f"got {height}x{width}"
        )
    dev = rows.device
    keys = torch.empty((n, height, width), dtype=torch.int64, device=dev)
    depth = torch.empty((n, height, width), dtype=torch.float32, device=dev)
    index = torch.empty((n, height, width), dtype=torch.int32, device=dev)
    fn = _build.entry("rasterize_lines", "drtk_rasterize_lines_f32", _B5_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        rows.data_ptr(), meta.data_ptr(), ends.data_ptr(), keys.data_ptr(), depth.data_ptr(),
        index.data_ptr(), n, f_cnt, height, width, y_offset, stream,
    )
    _build.check("rasterize_lines", err, "rasterize_lines kernel")
    tracing.launched("B5 rasterize_lines")
    return depth, index


def rasterize_lines_cuda(
    v: torch.Tensor, vi: torch.Tensor, height: int, width: int, y_offset: int, full_height: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wireframe-rasterize validated ``v [N, V, 3]``, ``vi [N, F, 3]``
    int32 (edge-visibility bits in ``vi[..., 0]``) with kernel B5, the setup
    in float32 as for :func:`rasterize_cuda`. Returns (depth [N, H, W],
    index [N, H, W] int32), rows [y_offset, y_offset + height) of a
    ``full_height``-row frame."""
    v32 = v.to(torch.float32)
    setup = triangle_setup(v32, vi)
    valid = _canvas_cull(setup, full_height, width)
    rows, meta, ends = pack_lines(setup, line_setup(v32, vi), valid, height, width, y_offset, full_height)
    depth, index = resolve_lines_packed(rows, meta, ends, height, width, y_offset)
    return depth.to(v.dtype), index
