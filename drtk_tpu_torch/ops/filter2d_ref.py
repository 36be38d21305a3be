"""Reference implementations of filter2d (counterpart of
``drtk_tpu/ops/filter2d_ref.py``), an oracle for
:mod:`drtk_tpu_torch.ops.filter2d`.

The explicit pipeline, each step materialized: pad (in input space for
reflection and border), insert zeros, crop, then a strided correlation
along W and then H written as a weighted sum of shifted slices, with no
convolution call. Unlike the op it supports "border" padding, applies the
filter as a correlation (no flip; the same for the symmetric Kaiser and
Lanczos filters), and is differentiated by plain autograd, which gives the
exact adjoint where the op gives the swap construction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from drtk_tpu_torch.ops.filter2d import (  # noqa: F401  (re-exported, as in the JAX package)
    FilterOptions,
    FilterType,
    _calc_pad_0,
    _calc_pad_1,
    make_resampling_kernel,
)

__all__ = [
    "FilterOptions",
    "FilterType",
    "downsample",
    "filter",
    "low_pass_filter",
    "make_resampling_kernel",
    "resample_filter",
    "upsample",
]

_PAD_MODE = {"zeros": "constant", "border": "replicate", "reflection": "reflect"}


def check_padding_mode(padding_mode: str) -> None:
    if padding_mode not in _PAD_MODE:
        raise ValueError(
            "filter2d.resample_filter(): expected padding_mode to be "
            f"'zeros', 'border', or 'reflection', but got: '{padding_mode}'"
        )


def ceildiv(a: int, b: int) -> int:
    return -(a // -b)


def insert_zeros(x: torch.Tensor, up: int) -> torch.Tensor:
    """``up - 1`` zeros after each sample along H and W."""
    if up == 1:
        return x
    n, c, h, w = x.shape
    x = F.pad(x.reshape(n, c, h, 1, w, 1), (0, up - 1, 0, 0, 0, up - 1))
    return x.reshape(n, c, h * up, w * up)


def _correlate_1d(x: torch.Tensor, f: torch.Tensor, dim: int, down: int) -> torch.Tensor:
    """Valid correlation along ``dim`` at stride ``down``, as a weighted sum
    of shifted slices."""
    k = f.shape[0]
    out_len = (x.shape[dim] - k) // down + 1
    acc = 0.0
    for i in range(k):
        acc = acc + x.narrow(dim, i, (out_len - 1) * down + 1).unfold(dim, 1, down).squeeze(-1) * f[i]
    return acc


def resample_filter(
    x: torch.Tensor, f: torch.Tensor, up: int = 1, down: int = 1, padding_mode: str = "reflection"
) -> torch.Tensor:
    """Reference ``resample_filter``, in ``x``'s dtype."""
    if x.ndim != 4 or f.ndim != 1:
        raise ValueError("filter2d_ref.resample_filter(): expected x [N, C, H, W] and f [K]")
    check_padding_mode(padding_mode)
    k = f.shape[0]
    pad0 = _calc_pad_0(k, down, up)
    pad1 = _calc_pad_1(k, down, up)
    if padding_mode == "zeros":
        x = F.pad(insert_zeros(x, up), (pad0, pad1, pad0, pad1))
    else:
        ip0, ip1 = ceildiv(pad0, up), ceildiv(pad1, up)
        x = insert_zeros(F.pad(x, (ip0, ip1, ip0, ip1), mode=_PAD_MODE[padding_mode]), up)
        c0, c1 = ip0 * up - pad0, ip1 * up - pad1
        x = x[:, :, c0 : x.shape[2] - c1, c0 : x.shape[3] - c1]
    f = f.to(x.dtype)
    return _correlate_1d(_correlate_1d(x, f, 3, down), f, 2, down)


def filter(x: torch.Tensor, f: torch.Tensor, padding_mode: str = "reflection") -> torch.Tensor:
    return resample_filter(x, f, 1, 1, padding_mode)


def upsample(x, filter_options: FilterOptions, upsample_factor: int = 2, padding_mode: str = "reflection"):
    f = make_resampling_kernel(filter_options, upsample_factor, 1.0, float(upsample_factor), device=x.device)
    return resample_filter(x, f, upsample_factor, 1, padding_mode)


def downsample(x, filter_options: FilterOptions, downsample_factor: int = 2, padding_mode: str = "reflection"):
    f = make_resampling_kernel(filter_options, downsample_factor, 1.0, 1.0, device=x.device)
    return resample_filter(x, f, 1, downsample_factor, padding_mode)


def low_pass_filter(x, filter_options: FilterOptions, freq_div: float = 1.0, padding_mode: str = "reflection"):
    f = make_resampling_kernel(filter_options, 1, freq_div, 1.0, device=x.device)
    return resample_filter(x, f, 1, 1, padding_mode)
