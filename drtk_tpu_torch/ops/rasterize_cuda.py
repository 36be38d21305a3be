"""Kernel B1's wrapper: the per-pixel z-buffer resolve on the card
(counterpart of ``drtk_tpu/ops/rasterize_pallas.py``).

The triangle setup (``triangle_setup`` and the canvas cull) stays in torch;
:func:`pack_setup` packs it into one row per triangle and
``csrc/rasterize.cu`` resolves and unpacks it to (depth, index).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from drtk_tpu_torch import _build
from drtk_tpu_torch.ops.rasterize import TriangleSetup, _canvas_cull, triangle_setup

__all__ = ["pack_setup", "rasterize_cuda"]

# Launches of kernel B1 since the last reset (see drtk_tpu_torch.kernel_launch_counts).
launches = 0

SETUP_FLOATS = 12  # ea[3], eb[3], ec[3], q[3]
SETUP_INTS = 5  # top-left bits, x_lo, x_hi, y_lo, y_hi


def pack_setup(
    setup: TriangleSetup, valid: torch.Tensor, height: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack the setup into ``coef [N, F, 12] f32`` and ``meta [N, F, 5]
    int32``. The pixel range of a triangle runs, inclusive, from the floor
    of its bbox minimum to the ceiling of its maximum, clipped to the
    canvas: every pixel centre less than a pixel outside the bbox is
    tested, as in the plain version. Culled triangles get an empty range."""
    coef = torch.cat([setup.ea, setup.eb, setup.ec, setup.q], dim=-1).to(torch.float32)
    tl = setup.topleft.to(torch.int32)
    tl_bits = tl[..., 0] | (tl[..., 1] << 1) | (tl[..., 2] << 2)
    # Clamp before rounding so huge or infinite coordinates convert safely;
    # NaN coordinates only occur on triangles whose edge tests all fail.
    lim = float(max(height, width) + 2)
    b = torch.nan_to_num(setup.bbox, nan=0.0, posinf=lim, neginf=-lim).clamp(-lim, lim)
    x_lo = torch.floor(b[..., 0]).clamp(min=0)
    y_lo = torch.floor(b[..., 1]).clamp(min=0)
    x_hi = torch.ceil(b[..., 2]).clamp(max=width - 1)
    y_hi = torch.ceil(b[..., 3]).clamp(max=height - 1)
    x_hi = torch.where(valid, x_hi, torch.full_like(x_hi, -1.0))
    meta = torch.stack([x_lo, x_hi, y_lo, y_hi], dim=-1).to(torch.int32)
    meta = torch.cat([tl_bits[..., None], meta], dim=-1)
    return coef.contiguous(), meta.contiguous()


def resolve_packed(
    coef: torch.Tensor, meta: torch.Tensor, height: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B1 on packed setup rows; returns (depth f32, index i32),
    each [N, H, W]."""
    global launches
    if coef.device.type != "cuda" or meta.device != coef.device:
        raise ValueError("rasterize_cuda: setup rows must lie on one CUDA device")
    if coef.dtype != torch.float32 or meta.dtype != torch.int32:
        raise TypeError("rasterize_cuda: expected f32 coef and int32 meta")
    n, f_cnt, width_c = coef.shape
    if width_c != SETUP_FLOATS or meta.shape != (n, f_cnt, SETUP_INTS):
        raise ValueError(f"rasterize_cuda: bad setup shapes {tuple(coef.shape)}, {tuple(meta.shape)}")
    if not (coef.is_contiguous() and meta.is_contiguous()):
        raise ValueError("rasterize_cuda: setup rows must be contiguous")
    if n * f_cnt >= 2**31:
        raise ValueError("rasterize_cuda: at most 2**31 - 1 triangles per launch")
    dev = coef.device
    keys = torch.empty((n, height, width), dtype=torch.int64, device=dev)
    depth = torch.empty((n, height, width), dtype=torch.float32, device=dev)
    index = torch.empty((n, height, width), dtype=torch.int32, device=dev)
    lib = _build.load("rasterize")
    fn = lib.drtk_rasterize_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int32] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        coef.data_ptr(), meta.data_ptr(), keys.data_ptr(), depth.data_ptr(),
        index.data_ptr(), n, f_cnt, height, width, stream,
    )
    _build.check(lib, err, "rasterize kernel")
    launches += 1
    return depth, index


def rasterize_cuda(
    v: torch.Tensor, vi: torch.Tensor, height: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize validated ``v [N, V, 3]``, ``vi [N, F, 3]`` int32 with
    kernel B1. The setup is computed in float32 whatever the dtype of
    ``v``, as the TPU kernel does; the depth comes back in that dtype.
    Returns (depth [N, H, W], index [N, H, W] int32), 0 / -1 at background."""
    setup = triangle_setup(v.to(torch.float32), vi)
    valid = _canvas_cull(setup, height, width)
    coef, meta = pack_setup(setup, valid, height, width)
    depth, index = resolve_packed(coef, meta, height, width)
    return depth.to(v.dtype), index
