"""2-D tap accumulation, the texture-gradient scatter (counterpart of
``drtk_tpu/ops/window_accum.py``).

:func:`window_accumulate` adds per-tap rows into a 2-D table at each tap's
(iy, ix). On a CUDA tensor it launches kernel B4 (``csrc/window_accum.cu``);
on a CPU tensor it runs :func:`_window_accumulate_plain`. As in the JAX
package, the caller may give the taps their 2-D shape (``rows_hw``, the
sampling grid that P flattens): a warp of B4 then takes an 8 x 4 patch of
neighbouring taps, sums the taps that share a texel and adds each sum to the
table once. The JAX package's layout limits (an output of 8-row and
128-column multiples, padded tap blocks) come from its TPU design and do not
apply: any table size and any tap order is taken. B4 adds with atomics,
whose order changes from run to run: its sums are not bit-reproducible (the
JAX package's are) and agree with the plain version to float rounding, not
bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from drtk_tpu_torch import _build, tracing

__all__ = ["window_accumulate"]

_C_ENTRY = {torch.float32: "drtk_window_accum_f32", torch.float64: "drtk_window_accum_f64"}
_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int32] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_int32] * 2 + [ctypes.c_void_p]
)
_MAX_BATCH = 65535  # B4 takes the batch from blockIdx.y


def _rows_hw(rows_hw: Optional[Tuple[int, int]], n_taps: int) -> Tuple[int, int]:
    """The (H, W) tap grid, (1, P) by default; raises unless H * W == P."""
    if rows_hw is None:
        return 1, n_taps
    t_h, t_w = (int(s) for s in rows_hw)
    if t_h < 0 or t_w < 0 or t_h * t_w != n_taps:
        raise ValueError(f"rows_hw {tuple(rows_hw)} does not flatten to {n_taps} taps")
    return t_h, t_w


def _window_accumulate_plain(rows, iy, ix, out_h: int, out_w: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: a per-channel ``index_add_`` of
    the live taps (``iy >= 0`` and inside the table). Keeps the rows'
    dtype."""
    n, k_dim, p = rows.shape
    plane = out_h * out_w
    live = (iy >= 0) & (iy < out_h) & (ix >= 0) & (ix < out_w)
    flat = iy.long() * out_w + ix.long() + torch.arange(n, device=iy.device)[:, None] * plane
    out = rows.new_zeros((k_dim, n * plane))
    out.index_add_(1, flat[live], rows.movedim(1, 0)[:, live])
    return out.reshape(k_dim, n, out_h, out_w).movedim(0, 1).contiguous()


def _window_accumulate_cuda(rows, iy, ix, out_h: int, out_w: int, rows_hw=None) -> torch.Tensor:
    """Launch kernel B4 on the tensors' device and current stream. ``rows``
    is read through its strides, so a transposed view costs no copy."""
    if rows.dtype not in _C_ENTRY:
        raise TypeError(f"window_accumulate: no kernel for {rows.dtype} rows")
    if iy.dtype != torch.int32 or ix.dtype != torch.int32:
        raise TypeError(f"window_accumulate: expected int32 iy/ix, got {iy.dtype}, {ix.dtype}")
    if not (rows.device == iy.device == ix.device):
        raise ValueError("window_accumulate: rows, iy and ix are on different devices")
    n, k_dim, p = rows.shape
    r_h, r_w = _rows_hw(rows_hw, p)
    if n > _MAX_BATCH or out_h * out_w >= 2**31 or p >= 2**31:
        raise ValueError(
            f"window_accumulate: the kernel takes at most {_MAX_BATCH} batches, tables of fewer than 2**31 "
            f"texels and fewer than 2**31 taps per batch (32-bit tap offsets), got N={n}, table {out_h}x{out_w}, "
            f"P={p}"
        )
    iy = iy.contiguous()
    ix = ix.contiguous()
    out = torch.zeros((n, k_dim, out_h, out_w), dtype=rows.dtype, device=rows.device)
    fn = _build.entry("window_accum", _C_ENTRY[rows.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    s_n, s_k, s_p = rows.stride()
    err = fn(
        rows.data_ptr(), iy.data_ptr(), ix.data_ptr(), out.data_ptr(), n, r_h, r_w, k_dim, s_n, s_k, s_p,
        out_h, out_w, stream,
    )
    _build.check("window_accum", err, "window_accum kernel")
    tracing.launched("B4 window_accum")
    return out


def window_accumulate(
    rows: torch.Tensor,
    iy: torch.Tensor,
    ix: torch.Tensor,
    out_h: int,
    out_w: int,
    impl: str = "auto",
    rows_hw: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Accumulate ``rows`` at 2-D targets: ``out[n, k, iy[n, p], ix[n, p]]
    += rows[n, k, p]``.

    Args:
        rows: [N, K, P] float32 or float64 per-tap rows, any strides.
        iy / ix: [N, P] int32 target coordinates. A negative ``iy`` marks an
            inert tap, whose rows are ignored; taps outside the
            ``out_h x out_w`` table are dropped as well.
        out_h / out_w: table size.
        impl: "auto" launches kernel B4 for CUDA tensors and runs the plain
            version for CPU tensors; "plain" runs the plain version on any
            device (the kernel's yardstick on the card).
        rows_hw: the (H, W) grid that P flattens, row-major (default
            (1, P), the flat order). It only groups neighbouring taps into
            B4's warps; the result does not depend on it, and the plain
            version ignores it.

    Returns:
        [N, K, out_h, out_w] of the rows' dtype. On the card the sums' order
        changes from run to run (atomics). Not differentiable: it is used
        inside autograd Functions only.
    """
    if rows.ndim != 3 or iy.shape != (rows.shape[0], rows.shape[2]) or ix.shape != iy.shape:
        raise ValueError(
            f"window_accumulate: expected rows [N, K, P] and iy/ix [N, P], got "
            f"{tuple(rows.shape)}, {tuple(iy.shape)}, {tuple(ix.shape)}"
        )
    if out_h < 0 or out_w < 0:
        raise ValueError(f"window_accumulate: bad table size {out_h}x{out_w}")
    _rows_hw(rows_hw, rows.shape[2])
    if impl == "plain" or (impl == "auto" and rows.device.type == "cpu"):
        return _window_accumulate_plain(rows, iy, ix, out_h, out_w)
    if impl == "auto" and rows.device.type == "cuda":
        return _window_accumulate_cuda(rows, iy, ix, out_h, out_w, rows_hw)
    raise ValueError(f"window_accumulate: impl {impl!r} on device {rows.device}")
