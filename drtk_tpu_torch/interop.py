"""Carry a scene between numpy (and so the JAX package) and this package.

A rasterizer has no weights: its state is the scene (geometry, textures,
cameras) and, in a fit, the optimizer's moments. The JAX package's inputs
come over as ``np.asarray(jax_array)`` and go through
:func:`scene_from_numpy`; an optax Adam state goes into a
``torch.optim.Adam`` through :func:`adam_state_from_optax`;
:func:`to_numpy` brings results back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["adam_state_from_optax", "resolve_device", "scene_from_numpy", "to_numpy"]

# Expected rank and, for the index buffer, dtype of each scene array.
_RANKS = {
    "v": (3,), "vi": (2, 3), "vt": (3,), "tex": (4,), "weight": (4,), "v_world": (3,), "tex_gt": (4,),
    "campos": (2,), "camrot": (3,), "focal": (3,), "princpt": (2,), "K": (3,), "Rt": (3,),
    "levels": (4,), "msi_tex": (4,), "ray_o": (2,), "ray_d": (2,), "distortion_coeff": (2,), "fov": (2,),
}


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
            loss, see :func:`drtk_tpu_torch.pipeline.textured_loss`),
            ``v_world`` [N, V, 3] and ``tex_gt`` [N, C, Ht, Wt] float (a
            multi-view fit's world-space vertices and target texture), and
            the cameras, float: ``campos`` [N, 3], ``camrot`` [N, 3, 3],
            ``focal`` [N, 2, 2], ``princpt`` [N, 2], ``K`` [N, 3, 3],
            ``Rt`` [N, 3, 4]; ``levels``, a list of [N, C, H_i, W_i] float
            mip levels, ``msi_tex`` [L, 4, H, W] float (an MSI
            background's texture) and ``ray_o``, ``ray_d`` [R, 3] float
            (its rays); ``distortion_coeff`` [N, K] and ``fov`` [N, 1]
            float, a lens (see :func:`drtk_tpu_torch.transform.transform`).
            Float arrays keep their dtype; ``vi`` must be int32, as the
            JAX package requires.
        device: target device; "cuda" raises when CUDA is absent.

    Returns:
        A dict with the same keys holding tensors (``levels``: a list).
    """
    dev = resolve_device(device)
    out = {}
    for key, arr in arrays.items():
        if key not in _RANKS:
            raise ValueError(f"scene_from_numpy: unknown scene array {key!r}")
        if key == "levels":
            out[key] = [_tensor(key, lvl, dev) for lvl in arr]
        else:
            out[key] = _tensor(key, arr, dev)
    return out


def _tensor(key: str, arr, dev: torch.device) -> torch.Tensor:
    """One scene array, checked against its rank and dtype, as a tensor."""
    arr = np.asarray(arr)
    if arr.ndim not in _RANKS[key]:
        raise ValueError(f"scene_from_numpy: {key} has shape {arr.shape}")
    if key == "vi":
        if arr.dtype != np.int32:
            raise ValueError(f"scene_from_numpy: expected int32 vi, got {arr.dtype}")
    elif arr.dtype.kind != "f":
        raise ValueError(f"scene_from_numpy: expected float {key}, got {arr.dtype}")
    return torch.from_numpy(np.array(arr, order="C")).to(dev)  # a copy: jax arrays are read-only


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array on the host."""
    return t.detach().cpu().numpy()


def adam_state_from_optax(optimizer: torch.optim.Adam, mu, nu, count) -> None:
    """Fill ``optimizer``'s state from optax's ``ScaleByAdamState``, so a fit
    started with ``optax.adam`` continues with the same moments.

    Args:
        optimizer: a ``torch.optim.Adam`` with one parameter group, whose
            parameters are in the order of optax's parameter pytree leaves.
        mu, nu: the first and second moments, sequences of numpy arrays, one
            per parameter and of its shape.
        count: optax's step count (the updates taken so far).
    """
    params = [p for group in optimizer.param_groups for p in group["params"]]
    mu, nu = [np.asarray(m) for m in mu], [np.asarray(m) for m in nu]
    if not len(params) == len(mu) == len(nu):
        raise ValueError(f"adam_state_from_optax: {len(params)} parameters, {len(mu)} mu, {len(nu)} nu")
    for p, m, v in zip(params, mu, nu):
        if m.shape != tuple(p.shape) or v.shape != tuple(p.shape):
            raise ValueError(f"adam_state_from_optax: moments of shape {m.shape}, {v.shape} for {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(m)).to(p),
            "exp_avg_sq": torch.from_numpy(np.array(v)).to(p),
        }
