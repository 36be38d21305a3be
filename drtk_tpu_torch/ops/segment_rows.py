"""Per-pixel face-row gather (counterpart of the forward half of
``drtk_tpu/ops/segment_rows.py``).

:func:`gather_rows_by_index` fetches ``table[n, index_img[n, y, x], :]``
for every pixel. On a CUDA tensor it launches kernel B2
(``csrc/gather_rows.cu``); on a CPU tensor it runs :func:`_gather_rows_plain`.
Both are exact copies of the table rows, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from drtk_tpu_torch import _build

__all__ = ["gather_rows_by_index"]

# Launches of kernel B2 since the last reset (see drtk_tpu_torch.kernel_launch_counts).
launches = 0

_C_ENTRY = {torch.float32: "drtk_gather_rows_f32", torch.float64: "drtk_gather_rows_f64"}


def _gather_rows_plain(table: torch.Tensor, index_img: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B2: ``[N, F, K]`` rows gathered by an
    ``[N, H, W]`` index, zero rows where the index is negative, indices
    above ``F - 1`` clamped to it. Keeps the table's dtype."""
    n, f_cnt, k_dim = table.shape
    _, h, w = index_img.shape
    if f_cnt == 0:
        return table.new_zeros((n, h, w, k_dim))
    idx = index_img.reshape(n, -1).long()
    safe = idx.clamp(0, f_cnt - 1)
    rows = table[torch.arange(n, device=table.device)[:, None], safe]  # [N, P, K]
    rows = torch.where((idx >= 0)[..., None], rows, torch.zeros((), dtype=table.dtype, device=table.device))
    return rows.reshape(n, h, w, k_dim)


def _gather_rows_cuda(table: torch.Tensor, index_img: torch.Tensor) -> torch.Tensor:
    """Launch kernel B2 on the tensors' device and current stream."""
    global launches
    if table.dtype not in _C_ENTRY:
        raise TypeError(f"gather_rows_by_index: no kernel for {table.dtype} tables")
    if index_img.dtype != torch.int32:
        raise TypeError(f"gather_rows_by_index: expected int32 index, got {index_img.dtype}")
    if table.device != index_img.device:
        raise ValueError("gather_rows_by_index: table and index_img are on different devices")
    n, f_cnt, k_dim = table.shape
    _, h, w = index_img.shape
    table = table.contiguous()
    index_img = index_img.contiguous()
    out = torch.empty((n, h, w, k_dim), dtype=table.dtype, device=table.device)
    lib = _build.load("gather_rows")
    fn = getattr(lib, _C_ENTRY[table.dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int32] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), index_img.data_ptr(), out.data_ptr(), n, h * w, f_cnt, k_dim, stream)
    _build.check(lib, err, "gather_rows kernel")
    launches += 1
    return out


def gather_rows_by_index(
    table: torch.Tensor, index_img: torch.Tensor, impl: str = "auto"
) -> torch.Tensor:
    """Per-pixel row fetch ``table[n, index_img[n, y, x], :]``.

    Args:
        table: [N, F, K] float32 or float64 rows.
        index_img: [N, H, W] int32; negative entries (background) yield
            all-zero rows.
        impl: "auto" launches kernel B2 for CUDA tensors and runs the plain
            version for CPU tensors; "plain" runs the plain version on any
            device (the kernel's yardstick on the card).

    Returns:
        [N, H, W, K] rows of the table's dtype. Not differentiable: it is
        used inside autograd Functions only.
    """
    if table.ndim != 3 or index_img.ndim != 3 or table.shape[0] != index_img.shape[0]:
        raise ValueError(
            f"gather_rows_by_index: expected table [N, F, K] and index [N, H, W], "
            f"got {tuple(table.shape)} and {tuple(index_img.shape)}"
        )
    if impl == "plain" or (impl == "auto" and table.device.type == "cpu"):
        return _gather_rows_plain(table, index_img)
    if impl == "auto" and table.device.type == "cuda":
        return _gather_rows_cuda(table, index_img)
    raise ValueError(f"gather_rows_by_index: impl {impl!r} on device {table.device}")
