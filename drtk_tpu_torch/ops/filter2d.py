"""Alias-free separable resampling filters (counterpart of
``drtk_tpu/ops/filter2d.py``).

Windowed-sinc Kaiser and Lanczos filter design, and a resampler that
inserts zeros to upsample, convolves along W and then H with the 1-D
filter, and keeps every ``down``-th sample, with reflection or zero
padding. The design runs in float64 numpy on the host, as in the JAX
package, and gives the same arrays; each filter is cached per parameter
tuple and device, so a call copies nothing to the device after the first.

Semantics (``drtk_tpu/ops/filter2d.py:20-44``):

* output size ``(in*up + pad0 + pad1 - k + down) // down`` with
  ``pad0 = _calc_pad_0(k, down, up)``, ``pad1 = _calc_pad_1(k, down, up)``;
* the forward convolves with the flipped filter (a true convolution); the
  backward op uses the unflipped filter and the mirrored pad origin
  ``k - _calc_pad_0(k, up, down) - 1``;
* reflection pads the input by ``ceil(pad / up)`` pixels before the zeros
  are inserted, and the excess is cropped after;
* the gradient is the same op with ``up`` and ``down`` swapped and the
  backward flag toggled, for reflection padding too, where this is the
  reference's deliberate approximation of the adjoint (it reflects again
  instead of folding the border back); there is no filter gradient.

The two passes are ``torch.nn.functional.conv2d`` calls with the channels
folded into the batch, run with TF32 off: cuDNN may otherwise round
float32 operands to 10 mantissa bits (PyTorch's default lets it), ~1e-3
relative, where the JAX package asks XLA for full precision
(``Precision.HIGHEST``).
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from drtk_tpu_torch.interop import resolve_device

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


class FilterType(Enum):
    """Filter families of :func:`make_resampling_kernel`."""

    Kaiser = 0
    Lanczos = 1


class FilterOptions:
    """Options of a resampling filter: ``n_taps`` input pixels reach each
    output pixel; ``alias_guard_band`` in [0, 1] moves the cutoff from the
    band limit (0.0, the least blur) to one transition half-width below it
    (1.0). ``alias_suppression_level`` is its older name."""

    __slots__ = ("n_taps", "filter_type", "alias_guard_band")

    def __init__(
        self,
        n_taps: int = 6,
        filter_type: FilterType = FilterType.Kaiser,
        alias_guard_band: Optional[float] = None,
        alias_suppression_level: Optional[float] = None,
    ) -> None:
        if alias_guard_band is None:
            value = 0.0 if alias_suppression_level is None else alias_suppression_level
        else:
            if alias_suppression_level is not None and alias_guard_band != alias_suppression_level:
                raise ValueError("FilterOptions: specify only one of alias_guard_band and alias_suppression_level")
            value = alias_guard_band
        if not isinstance(filter_type, FilterType):
            raise TypeError(f"filter2d: filter_type must be a FilterType value, but got {filter_type!r}")
        self.n_taps = n_taps
        self.filter_type = filter_type
        self.alias_guard_band = value

    @property
    def alias_suppression_level(self) -> float:
        return self.alias_guard_band

    @alias_suppression_level.setter
    def alias_suppression_level(self, value: float) -> None:
        self.alias_guard_band = value


# ---------------------------------------------------------------------------
# Filter design (host numpy, float64, cached)
# ---------------------------------------------------------------------------

_KERNELS: Dict[Tuple, torch.Tensor] = {}


def _make_kernel_kaiser(n: int, fh_s: float, fc_s: float, m: int, gain: float) -> np.ndarray:
    n = n * m
    length = float(n - 1) / float(m)
    df = (2.0 * fh_s) / (float(m) / 2.0)
    attenuation = 2.285 * (n - 1) * np.pi * df + 7.95
    if attenuation > 50.0:
        beta = 0.1102 * (attenuation - 8.7)
    elif attenuation < 21.0:
        beta = 0.0
    else:
        beta = 0.5842 * (attenuation - 21) ** 0.4 + 0.07886 * (attenuation - 21)
    i = np.arange(n, dtype=np.float64)
    x = (i - (n - 1) / 2.0) / float(m)
    arg = 1.0 - (2.0 * x / length) ** 2 if n > 1 else np.ones_like(x)
    window = np.i0(beta * np.sqrt(np.maximum(arg, 0.0))) / np.i0(beta)
    v = window * 2.0 * fc_s * np.sinc(2.0 * fc_s * x)
    return (v * (gain / v.sum())).astype(np.float32)


def _make_kernel_lanczos(n: int, fc_s: float, m: int, gain: float) -> np.ndarray:
    n = n * m
    a = np.ceil(2.0 * fc_s * (float(n) - 1.0) / 2.0 / float(m))
    i = np.arange(n, dtype=np.float64)
    x = (i - (n - 1) / 2.0) / float(m)
    v = (
        2.0 * fc_s * np.sinc(2.0 * fc_s * x)
        * np.sinc(2.0 * fc_s * x / a)
        * (np.abs(2.0 * fc_s * x) < a).astype(np.float64)
    )
    return (v * (gain / v.sum())).astype(np.float32)


def make_resampling_kernel(
    filter_options: FilterOptions,
    m: int = 1,
    freq_div: float = 1.0,
    gain: float = 1.0,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """A 1-D low-pass resampling filter of ``n_taps * m`` float32 taps on
    ``device`` ("cuda" raises when CUDA is absent). The tensor is cached per
    parameters and device and shared: read it, do not write it."""
    n = int(filter_options.n_taps)
    if n < 1:
        raise ValueError("n must be at least 1")
    if m < 1:
        raise ValueError("m must be at least 1")
    if not (np.isfinite(freq_div) and freq_div > 0.0):
        raise ValueError("freq_div must be finite and greater than 0")
    if not np.isfinite(gain):
        raise ValueError("gain must be finite")
    if not (np.isfinite(filter_options.alias_guard_band) and filter_options.alias_guard_band >= 0.0):
        raise ValueError("alias_guard_band must be finite and non-negative")
    # The cutoff; exp2 of a float32, as the reference's exp2f.
    fh_s = float(np.exp2(np.float32(0.5)) - 1) / 2.0 / freq_div
    fc_s = 1.0 / 2.0 / freq_div - fh_s * filter_options.alias_guard_band
    dev = resolve_device(device)
    key = (filter_options.filter_type, n, int(m), float(fh_s), float(fc_s), float(gain), dev)
    w = _KERNELS.get(key)
    if w is None:
        if filter_options.filter_type == FilterType.Kaiser:
            w = _make_kernel_kaiser(n, fh_s, fc_s, int(m), gain)
        else:
            w = _make_kernel_lanczos(n, fc_s, int(m), gain)
        w = _KERNELS[key] = torch.from_numpy(w).to(dev)
    return w


# ---------------------------------------------------------------------------
# Pad arithmetic
# ---------------------------------------------------------------------------


def _calc_pad_0(k_size: int, down: int, up: int) -> int:
    if down == 1 and up == 1:
        return k_size // 2
    if down != 1:
        return (k_size - down + 1) // 2
    return (k_size + up - 1) // 2


def _calc_pad_1(k_size: int, down: int, up: int) -> int:
    if down == 1 and up == 1:
        return (k_size - 1) // 2
    if down != 1:
        return (k_size - down) // 2
    return (k_size - up) // 2


def _output_size(in_size: int, k: int, up: int, down: int) -> int:
    pad = _calc_pad_0(k, down, up) + _calc_pad_1(k, down, up)
    return (in_size * up + pad - k + down) // down


# ---------------------------------------------------------------------------
# The resampler
# ---------------------------------------------------------------------------


def _sep_conv(x: torch.Tensor, f: torch.Tensor, dim: int, up: int, down: int, pad: Tuple[int, int]) -> torch.Tensor:
    """One pass along H (``dim`` 2) or W (3) of an NCHW tensor: ``up - 1``
    zeros after each sample, ``pad`` zeros before and after (negative
    crops), then correlation with ``f`` at stride ``down``; the channels
    folded into the batch. ``pad`` counts the zeros of a dilation without
    the trailing ones (``lax.conv_general_dilated``'s ``lhs_dilation``), so
    the trailing ``up - 1`` come off its end."""
    n, c, h, w = x.shape
    x = x.reshape(n * c, 1, h, w)
    if up > 1:
        size = list(x.shape)
        size[dim] *= up
        xz = x.new_zeros(size)
        index = [slice(None)] * 4
        index[dim] = slice(None, None, up)
        xz[tuple(index)] = x
        x = xz
    lo, hi = pad[0], pad[1] - (up - 1)
    x = F.pad(x, (lo, hi, 0, 0) if dim == 3 else (0, 0, lo, hi))
    k = f.shape[0]
    weight = f.to(x.dtype).reshape((1, 1, 1, k) if dim == 3 else (1, 1, k, 1))
    stride = (1, down) if dim == 3 else (down, 1)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(x, weight, stride=stride)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return out.reshape(n, c, out.shape[2], out.shape[3])


def _filter2d_fused(x: torch.Tensor, f: torch.Tensor, up: int, down: int, backward: bool, reflect: bool):
    """``drtk_tpu/ops/filter2d.py:_filter2d_fused``."""
    k = f.shape[0]
    # The forward convolves (the filter flipped); the backward correlates.
    fk = f if backward else f.flip(0)
    total_pad = _calc_pad_0(k, down, up) + _calc_pad_1(k, down, up)
    pad0 = k - _calc_pad_0(k, up, down) - 1 if backward else _calc_pad_0(k, down, up)
    pad1 = total_pad - pad0
    if pad0 < 0 or pad1 < 0:
        raise ValueError(
            "filter2d padding must be non-negative; filter length is too small for the sampling factors"
        )
    out_h = _output_size(x.shape[2], k, up, down)
    out_w = _output_size(x.shape[3], k, up, down)
    if out_h < 1 or out_w < 1:
        raise ValueError("output must be at least 1x1")
    if reflect:
        # Reflect in input space; the excess is cropped after the zeros go in.
        ipad0 = -(-pad0 // up)
        ipad1 = -(-pad1 // up)
        x = F.pad(x, (ipad0, ipad1, ipad0, ipad1), mode="reflect")
        conv_pad = (pad0 - ipad0 * up, pad1 + (up - 1) - ipad1 * up)
    else:
        # The trailing zeros of the last sample, which a dilation drops.
        conv_pad = (pad0, pad1 + (up - 1))
    x = _sep_conv(x, fk, 3, up, down, conv_pad)
    return _sep_conv(x, fk, 2, up, down, conv_pad)


class _ResampleCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, f, up, down, backward, reflect):
        ctx.save_for_backward(f)
        ctx.args = (up, down, backward, reflect)
        return _filter2d_fused(x, f, up, down, backward, reflect)

    @staticmethod
    def backward(ctx, g):
        # The swap construction: up and down swapped, the backward flag
        # toggled; no filter gradient.
        (f,) = ctx.saved_tensors
        up, down, backward, reflect = ctx.args
        return _ResampleCore.apply(g, f, down, up, not backward, reflect), None, None, None, None, None


def _check_args(x, f, up, down, padding_mode) -> bool:
    if padding_mode == "reflection":
        reflect = True
    elif padding_mode == "zeros":
        reflect = False
    else:
        raise NotImplementedError(
            f"filter2d: expected padding_mode to be 'zeros' or 'reflection', but got: {padding_mode!r}"
        )
    if x.ndim != 4:
        raise ValueError("x must be rank 4")
    if f.ndim != 1:
        raise ValueError("f must be rank 1")
    if f.shape[0] < 1:
        raise ValueError("f must be at least 1x1")
    if up < 1:
        raise ValueError("upsampling factor must be at least 1")
    if down < 1:
        raise ValueError("downsampling factor must be at least 1")
    return reflect


def resample_filter(
    x: torch.Tensor, f: torch.Tensor, up: int = 1, down: int = 1, padding_mode: str = "reflection"
) -> torch.Tensor:
    """Resample an NCHW tensor with the separable 1-D filter ``f``: insert
    ``up - 1`` zeros after each sample, convolve along both spatial axes,
    keep every ``down``-th sample. Differentiable in ``x`` (the swap
    construction above)."""
    reflect = _check_args(x, f, up, down, padding_mode)
    return _ResampleCore.apply(x, f, int(up), int(down), False, reflect)


def filter(x: torch.Tensor, f: torch.Tensor, padding_mode: str = "reflection") -> torch.Tensor:
    """Filter an NCHW tensor with ``f`` without changing its size."""
    return resample_filter(x, f, 1, 1, padding_mode)


def upsample(
    x: torch.Tensor, filter_options: FilterOptions, upsample_factor: int = 2, padding_mode: str = "reflection"
) -> torch.Tensor:
    """Upsample an NCHW tensor by ``upsample_factor`` (gain
    ``upsample_factor`` keeps the magnitude)."""
    f = make_resampling_kernel(filter_options, upsample_factor, 1.0, float(upsample_factor), device=x.device)
    return resample_filter(x, f, upsample_factor, 1, padding_mode)


def downsample(
    x: torch.Tensor, filter_options: FilterOptions, downsample_factor: int = 2, padding_mode: str = "reflection"
) -> torch.Tensor:
    """Downsample an NCHW tensor by ``downsample_factor``."""
    f = make_resampling_kernel(filter_options, downsample_factor, 1.0, 1.0, device=x.device)
    return resample_filter(x, f, 1, downsample_factor, padding_mode)


def low_pass_filter(
    x: torch.Tensor, filter_options: FilterOptions, freq_div: float = 1.0, padding_mode: str = "reflection"
) -> torch.Tensor:
    """Low-pass filter an NCHW tensor at ``1 / freq_div`` of the band limit
    without changing its size."""
    f = make_resampling_kernel(filter_options, 1, freq_div, 1.0, device=x.device)
    return resample_filter(x, f, 1, 1, padding_mode)
