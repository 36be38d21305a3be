"""Per-pixel face-row gather and its transpose, the pixel-to-face row
accumulation (counterpart of ``drtk_tpu/ops/segment_rows.py``).

:func:`gather_rows_by_index` fetches ``table[n, index_img[n, y, x], :]``
for every pixel. On a CUDA tensor it launches kernel B2
(``csrc/gather_rows.cu``); on a CPU tensor it runs :func:`_gather_rows_plain`.
Both are exact copies of the table rows, so the two agree bit for bit.

:func:`scatter_rows_to_faces` sums per-pixel rows into per-face rows by the
same index, the reduction at the end of the VJPs of render and interpolate
(edge_grad's backward, kernel E1, reduces to vertices itself; its plain
version takes the plain scatter). On a CUDA tensor it launches kernel B3
(``csrc/scatter_rows.cu``); on a CPU tensor it runs
:func:`_scatter_rows_plain`. B3 sums each 32 x 8 pixel tile's rows per
distinct face on chip and adds the partials with atomics, whose order
changes from run to run: its sums are not bit-reproducible (the JAX
package's are) and agree with the plain version to float rounding, not bit
for bit.
"""

from __future__ import annotations

import ctypes

import torch

from drtk_tpu_torch import _build

__all__ = ["gather_rows_by_index", "scatter_rows_to_faces"]

# Launches of kernels B2 and B3 since the last reset (see
# drtk_tpu_torch.kernel_launch_counts).
launches = 0
scatter_launches = 0

_C_ENTRY = {torch.float32: "drtk_gather_rows_f32", torch.float64: "drtk_gather_rows_f64"}
_C_SCATTER = {torch.float32: "drtk_scatter_rows_f32", torch.float64: "drtk_scatter_rows_f64"}
_GATHER_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 4 + [ctypes.c_void_p]
_SCATTER_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 5 + [ctypes.c_void_p]
_MAX_BATCH = 65535  # B2 and B3 take the batch from blockIdx.y


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
    if table.device.type != "cuda" or table.device != index_img.device:
        raise ValueError("gather_rows_by_index: table and index_img must lie on one CUDA device")
    n, f_cnt, k_dim = table.shape
    _, h, w = index_img.shape
    if n > _MAX_BATCH or max(h * w, f_cnt) * k_dim >= 2**31:
        raise ValueError(
            f"gather_rows_by_index: the kernel takes at most {_MAX_BATCH} batches and 32-bit offsets "
            f"(P*K, F*K < 2**31), got N={n}, P={h * w}, F={f_cnt}, K={k_dim}"
        )
    table = table.contiguous()
    index_img = index_img.contiguous()
    out = torch.empty((n, h, w, k_dim), dtype=table.dtype, device=table.device)
    fn = _build.entry("gather_rows", _C_ENTRY[table.dtype], _GATHER_ARGTYPES)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), index_img.data_ptr(), out.data_ptr(), n, h * w, f_cnt, k_dim, stream)
    _build.check("gather_rows", err, "gather_rows kernel")
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


def _scatter_rows_plain(rows: torch.Tensor, index_img: torch.Tensor, num_faces: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B3: ``[N, H, W, K]`` rows summed into
    ``[N, F, K]`` face rows by an ``[N, H, W]`` index with ``index_add_``,
    background rows (negative index) dropped, indices above ``F - 1``
    clamped to it (the adjoint of :func:`_gather_rows_plain`). Keeps the
    rows' dtype."""
    n, h, w, k_dim = rows.shape
    out = rows.new_zeros((n * num_faces, k_dim))
    if num_faces == 0:
        return out.reshape(n, 0, k_dim)
    idx = index_img.reshape(n, -1).long()
    fg = idx >= 0
    target = idx.clamp(max=num_faces - 1) + torch.arange(n, device=idx.device)[:, None] * num_faces
    out.index_add_(0, target[fg], rows.reshape(n, -1, k_dim)[fg])
    return out.reshape(n, num_faces, k_dim)


def _scatter_rows_cuda(rows: torch.Tensor, index_img: torch.Tensor, num_faces: int) -> torch.Tensor:
    """Launch kernel B3 on the tensors' device and current stream."""
    global scatter_launches
    if rows.dtype not in _C_SCATTER:
        raise TypeError(f"scatter_rows_to_faces: no kernel for {rows.dtype} rows")
    if index_img.dtype != torch.int32:
        raise TypeError(f"scatter_rows_to_faces: expected int32 index, got {index_img.dtype}")
    if rows.device != index_img.device:
        raise ValueError("scatter_rows_to_faces: rows and index_img are on different devices")
    n, h, w, k_dim = rows.shape
    if n > _MAX_BATCH or num_faces >= 2**31:
        raise ValueError(
            f"scatter_rows_to_faces: the kernel takes at most {_MAX_BATCH} batches and F < 2**31, "
            f"got N={n}, F={num_faces}"
        )
    rows = rows.contiguous()
    index_img = index_img.contiguous()
    out = torch.zeros((n, num_faces, k_dim), dtype=rows.dtype, device=rows.device)
    fn = _build.entry("scatter_rows", _C_SCATTER[rows.dtype], _SCATTER_ARGTYPES)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = fn(rows.data_ptr(), index_img.data_ptr(), out.data_ptr(), n, h, w, num_faces, k_dim, stream)
    _build.check("scatter_rows", err, "scatter_rows kernel")
    scatter_launches += 1
    return out


def scatter_rows_to_faces(
    rows: torch.Tensor, index_img: torch.Tensor, num_faces: int, impl: str = "auto"
) -> torch.Tensor:
    """Accumulate per-pixel rows into per-face rows by ``index_img``:
    ``out[n, f, :] = sum of rows[n, y, x, :] over pixels with
    index_img[n, y, x] == f``.

    Args:
        rows: [N, H, W, K] float32 or float64 per-pixel rows.
        index_img: [N, H, W] int32; background pixels (negative index) are
            dropped, whatever their rows hold.
        num_faces: F, the number of face rows.
        impl: "auto" launches kernel B3 for CUDA tensors and runs the plain
            version for CPU tensors; "plain" runs the plain version on any
            device (the kernel's yardstick on the card).

    Returns:
        [N, F, K] rows of the rows' dtype. On the card the sums' order
        changes from run to run (atomics). Not differentiable: it is used
        inside autograd Functions only.
    """
    if rows.ndim != 4 or rows.shape[:3] != index_img.shape:
        raise ValueError(
            f"scatter_rows_to_faces: expected rows [N, H, W, K] and index [N, H, W], "
            f"got {tuple(rows.shape)} and {tuple(index_img.shape)}"
        )
    if impl == "plain" or (impl == "auto" and rows.device.type == "cpu"):
        return _scatter_rows_plain(rows, index_img, num_faces)
    if impl == "auto" and rows.device.type == "cuda":
        return _scatter_rows_cuda(rows, index_img, num_faces)
    raise ValueError(f"scatter_rows_to_faces: impl {impl!r} on device {rows.device}")
