"""Core numeric helpers shared by every op (counterpart of
``drtk_tpu/ops/math.py``).

``epsclamp`` is the library-wide singularity guard: it keeps values away
from zero while preserving sign, with a dtype-dependent epsilon (1e-8 for
float32 and below, 1e-16 for float64).
"""

from __future__ import annotations

import torch

__all__ = ["autocast_f32", "epsclamp", "eps_for_dtype"]


def eps_for_dtype(dtype: torch.dtype) -> float:
    """Epsilon used by :func:`epsclamp`: 1e-16 for float64, else 1e-8."""
    if dtype == torch.float64:
        return 1e-16
    return 1e-8


def epsclamp(x: torch.Tensor) -> torch.Tensor:
    """Clamp ``x`` away from zero, preserving sign.

    ``epsclamp(v) = v < 0 ? min(v, -eps) : max(v, eps)``

    The branch tests ``v < 0``, which is false for negative zero, so both
    ``0.0`` and ``-0.0`` map to ``+eps``. Gradient parity at degenerate
    configurations depends on this asymmetry.
    """
    eps = eps_for_dtype(x.dtype)
    return torch.where(x < 0, torch.clamp(x, max=-eps), torch.clamp(x, min=eps))


def autocast_f32(x):
    """Cast float16/bfloat16 tensors to float32; pass anything else
    (ints, f32/f64, ``None``) through untouched. Half-precision inputs to
    an op therefore compute, and return, float32."""
    if x is not None and x.dtype in (torch.float16, torch.bfloat16):
        return x.to(torch.float32)
    return x
