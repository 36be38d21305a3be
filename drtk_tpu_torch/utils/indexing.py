"""Gather helper (counterpart of ``drtk_tpu/utils/indexing.py``)."""

from __future__ import annotations

import torch

__all__ = ["index"]


def index(x: torch.Tensor, idxs: torch.Tensor, dim: int) -> torch.Tensor:
    """Index ``x`` along ``dim`` with an arbitrary-shape index tensor,
    replacing that axis with the index tensor's shape.

    Example: x [8, 7306, 3], idxs [11000, 3], dim=1 -> [8, 11000, 3, 3].
    Indices must lie in ``[0, x.shape[dim])`` (``index_select`` raises on
    others, where the JAX package's ``take`` fills them).
    """
    target_shape = list(x.shape)
    del target_shape[dim]
    target_shape[dim:dim] = list(idxs.shape)
    return x.index_select(dim, idxs.reshape(-1).long()).reshape(target_shape)
