"""The repository's benchmark scenes, built with numpy alone.

Copies of ``bench.make_scene`` (the textured grid mesh behind every
throughput figure) and ``__graft_entry__._scene`` (a soup of large,
overlapping random triangles), seeded with ``np.random.RandomState(seed)``
exactly as there, so the two packages build identical scenes.
"""

from __future__ import annotations

import numpy as np

from drtk_tpu_torch.interop import scene_from_numpy

__all__ = ["entry_scene", "entry_scene_arrays", "make_scene", "make_scene_arrays"]


def make_scene_arrays(h: int, w: int, gn: int, seed: int = 0) -> dict[str, np.ndarray]:
    """Connected grid mesh with 2*(gn-1)^2 triangles covering the canvas,
    plus per-vertex uvs and a 3x512x512 texture, as numpy arrays."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(
        np.linspace(0.02 * h, 0.98 * h, gn),
        np.linspace(0.02 * w, 0.98 * w, gn),
        indexing="ij",
    )
    z = 5.0 + rng.uniform(-1.0, 1.0, xs.shape)
    v = np.stack([xs, ys, z], -1).reshape(1, -1, 3).astype(np.float32)
    idx = np.arange(gn * gn).reshape(gn, gn)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    vi = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], axis=0).astype(np.int32)
    vt = np.stack([xs / w, ys / h], -1).reshape(1, -1, 2).astype(np.float32)
    tex = rng.rand(1, 3, 512, 512).astype(np.float32)
    return {"v": v, "vi": vi, "vt": vt, "tex": tex}


def entry_scene_arrays(
    batch: int = 1, num_v: int = 96, num_f: int = 128, h: int = 256, w: int = 256, seed: int = 0
) -> dict[str, np.ndarray]:
    """Random textured soup of large overlapping triangles, as numpy arrays."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.1, 1.1, size=(batch, num_v, 2)).astype(np.float32)
    xy *= np.asarray([w, h], np.float32)
    z = rng.uniform(3.0, 9.0, size=(batch, num_v, 1)).astype(np.float32)
    v = np.concatenate([xy, z], axis=-1)
    vi = rng.randint(0, num_v, size=(num_f, 3)).astype(np.int32)
    vt = rng.uniform(0, 1, size=(batch, num_v, 2)).astype(np.float32)
    tex = rng.rand(batch, 3, 64, 64).astype(np.float32)
    return {"v": v, "vi": vi, "vt": vt, "tex": tex}


def make_scene(h: int, w: int, gn: int, seed: int = 0, device="cuda"):
    """:func:`make_scene_arrays` as tensors ``(v, vi, vt, tex)`` on ``device``
    ("cuda" raises when CUDA is absent)."""
    s = scene_from_numpy(make_scene_arrays(h, w, gn, seed), device)
    return s["v"], s["vi"], s["vt"], s["tex"]


def entry_scene(batch=1, num_v=96, num_f=128, h=256, w=256, seed=0, device="cuda"):
    """:func:`entry_scene_arrays` as tensors ``(v, vi, vt, tex)`` on
    ``device`` ("cuda" raises when CUDA is absent)."""
    s = scene_from_numpy(entry_scene_arrays(batch, num_v, num_f, h, w, seed), device)
    return s["v"], s["vi"], s["vt"], s["tex"]
