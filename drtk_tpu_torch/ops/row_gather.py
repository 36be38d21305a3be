"""Mutually transposed row gather and row scatter (counterpart of
``drtk_tpu/ops/row_gather.py``).

:func:`row_gather` fetches ``table[n, idx[n, p], :]``: grid_sample's
quad-table rows and its per-tap texel rows. Its backward is
:func:`_row_scatter`, the texture-gradient splat, and the scatter's backward
is the gather again, so second derivatives work as the JAX package's
transpose-of-transpose does. The scatter runs only when the table's gradient
is asked for (``ctx.needs_input_grad``), as the JAX primitive builds it only
when the table is differentiated.

The scatter drops rows that are zero in every channel, as the JAX package's
``live`` mask does (exact: they add nothing), then adds the rest at
``(iy, ix) = divmod(idx, table_w)`` with
:func:`~drtk_tpu_torch.ops.window_accum.window_accumulate`, which is kernel
B4 on a CUDA tensor. ``rows_hw``, the image shape that the rows flatten,
rides along to it as in the JAX package, so that B4's warps take
neighbouring pixels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from drtk_tpu_torch.ops.window_accum import _rows_hw, window_accumulate

__all__ = ["row_gather"]


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n = table.shape[0]
    return table[torch.arange(n, device=table.device)[:, None], idx.long()]


def _scatter(rows: torch.Tensor, idx: torch.Tensor, table_hw, rows_hw, impl: str) -> torch.Tensor:
    """[N, P, K] rows summed into an [N, R, K] table (R = Ht * Wt) at
    ``idx``; all-zero rows are skipped."""
    n, p, k_dim = rows.shape
    t_h, t_w = table_hw
    live = (rows != 0).any(dim=-1)
    iy = torch.where(live, torch.div(idx, t_w, rounding_mode="floor"), -1).to(torch.int32)
    ix = torch.remainder(idx, t_w).to(torch.int32)
    acc = window_accumulate(rows.transpose(1, 2), iy, ix, t_h, t_w, impl, rows_hw)  # [N, K, Ht, Wt]
    return acc.reshape(n, k_dim, t_h * t_w).transpose(1, 2)


class _RowGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, table_hw, rows_hw, impl):
        ctx.save_for_backward(idx)
        ctx.table_hw, ctx.rows_hw, ctx.impl = table_hw, rows_hw, impl
        return _gather(table, idx)

    @staticmethod
    def backward(ctx, grad_rows):
        (idx,) = ctx.saved_tensors
        grad_table = None
        if ctx.needs_input_grad[0]:
            grad_table = _RowScatter.apply(grad_rows, idx, ctx.table_hw, ctx.rows_hw, ctx.impl)
        return grad_table, None, None, None, None


class _RowScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, idx, table_hw, rows_hw, impl):
        ctx.save_for_backward(idx)
        ctx.table_hw, ctx.rows_hw, ctx.impl = table_hw, rows_hw, impl
        return _scatter(rows, idx, table_hw, rows_hw, impl)

    @staticmethod
    def backward(ctx, grad_table):
        (idx,) = ctx.saved_tensors
        grad_rows = None
        if ctx.needs_input_grad[0]:
            grad_rows = _RowGather.apply(grad_table, idx, ctx.table_hw, ctx.rows_hw, ctx.impl)
        return grad_rows, None, None, None, None


def row_gather(
    table: torch.Tensor,
    idx: torch.Tensor,
    table_hw: Tuple[int, int],
    impl: str = "auto",
    rows_hw: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Gather ``table[n, idx[n, p], :]`` -> [N, P, K], differentiable in
    ``table`` (to any order).

    Args:
        table: [N, R, K] float rows of a 2-D table, R = Ht * Wt.
        idx: [N, P] integer row indices in [0, R).
        table_hw: (Ht, Wt), the table's 2-D shape: the backward scatters
            into it at ``(idx // Wt, idx % Wt)``.
        impl: "auto" runs the backward scatter with kernel B4 on CUDA
            tensors; "plain" runs its plain version on any device.
        rows_hw: the (H, W) image shape that P flattens (default (1, P)):
            it gives the backward scatter its spatially coherent tap groups.
            The result does not depend on it.
    """
    t_h, t_w = (int(s) for s in table_hw)
    if table.ndim != 3 or idx.ndim != 2 or idx.shape[0] != table.shape[0] or table.shape[1] != t_h * t_w:
        raise ValueError(
            f"row_gather: expected table [N, Ht*Wt, K] and idx [N, P] with (Ht, Wt) = {table_hw}, "
            f"got {tuple(table.shape)} and {tuple(idx.shape)}"
        )
    return _RowGather.apply(table, idx, (t_h, t_w), _rows_hw(rows_hw, idx.shape[1]), impl)


def _row_scatter(
    rows: torch.Tensor,
    idx: torch.Tensor,
    table_hw: Tuple[int, int],
    impl: str = "auto",
    rows_hw: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """The transpose of :func:`row_gather`: [N, P, K] rows summed into an
    [N, Ht*Wt, K] table at ``idx``, differentiable in ``rows``."""
    return _RowScatter.apply(rows, idx, tuple(int(s) for s in table_hw), _rows_hw(rows_hw, idx.shape[1]), impl)
