"""Carry a scene between numpy (and so the JAX package) and this package.

A rasterizer has no weights: its state is the scene. The JAX package's
inputs come over as ``np.asarray(jax_array)`` and go through
:func:`scene_from_numpy`; :func:`to_numpy` brings results back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["resolve_device", "scene_from_numpy", "to_numpy"]

# Expected rank and, for the index buffer, dtype of each scene array.
_RANKS = {"v": (3,), "vi": (2, 3), "vt": (3,), "tex": (4,), "weight": (4,)}


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and there is none
    (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "drtk_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev


def scene_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> dict[str, torch.Tensor]:
    """Turn numpy scene arrays into tensors on ``device``.

    Args:
        arrays: any of ``v`` [N, V, 3] float, ``vi`` [F, 3] or [N, F, 3]
            int32, ``vt`` [N, V, 2] float, ``tex`` [N, C, Ht, Wt] float,
            ``weight`` [N, C, H, W] float (the weight image of a fitting
            loss, see :func:`drtk_tpu_torch.pipeline.textured_loss`).
            Float arrays keep their dtype; ``vi`` must be int32, as the
            JAX package requires.
        device: target device; "cuda" raises when CUDA is absent.

    Returns:
        A dict with the same keys holding tensors.
    """
    dev = resolve_device(device)
    out = {}
    for key, arr in arrays.items():
        if key not in _RANKS:
            raise ValueError(f"scene_from_numpy: unknown scene array {key!r}")
        arr = np.asarray(arr)
        if arr.ndim not in _RANKS[key]:
            raise ValueError(f"scene_from_numpy: {key} has shape {arr.shape}")
        if key == "vi":
            if arr.dtype != np.int32:
                raise ValueError(f"scene_from_numpy: expected int32 vi, got {arr.dtype}")
        elif arr.dtype.kind != "f":
            raise ValueError(f"scene_from_numpy: expected float {key}, got {arr.dtype}")
        out[key] = torch.from_numpy(np.array(arr, order="C")).to(dev)  # a copy: jax arrays are read-only
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array on the host."""
    return t.detach().cpu().numpy()
