"""The benchmark's scenes, built on the host with numpy from a seed.

Frozen copies of ``drtk_tpu_torch/scenes.py`` (``make_scene_arrays``,
``inverse8_scene_arrays`` and ``avatar4k_scene_arrays``), which copy
``bench.py``'s ``make_scene`` and its ``bench_inverse8`` and
``bench_avatar4k`` scenes: drawn in the same order, so at the port's seeds
they build the port's scenes. ``avatar4k_scene_arrays`` takes a seed here:
the grid's from ``seed``, the pyramid's and the MSI texture's from
``seed + 1`` (the port's fixed 0 and 1). :func:`multiview_scene_arrays`
(after ``chip_smoke.py``'s ``sharded_scene``) gives each camera of the grid
its own offset and texture. Every seed gives the same sizes.
"""

from __future__ import annotations

import numpy as np


def rng_seed(seed: int) -> int:
    """A benchmark seed (any whole number) as a numpy RandomState seed."""
    return int(seed) % 2**32


def make_scene_arrays(h: int, w: int, gn: int, seed: int = 0, tex_size: int = 512) -> dict[str, np.ndarray]:
    """A connected grid mesh of 2*(gn-1)^2 triangles covering the canvas,
    z jittered in [4, 6], per-vertex uvs and a 3 x tex_size^2 texture."""
    rng = np.random.RandomState(rng_seed(seed))
    ys, xs = np.meshgrid(np.linspace(0.02 * h, 0.98 * h, gn), np.linspace(0.02 * w, 0.98 * w, gn), indexing="ij")
    z = 5.0 + rng.uniform(-1.0, 1.0, xs.shape)
    v = np.stack([xs, ys, z], -1).reshape(1, -1, 3).astype(np.float32)
    idx = np.arange(gn * gn).reshape(gn, gn)
    a, b, c, d = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(), idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    vi = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], axis=0).astype(np.int32)
    vt = np.stack([xs / w, ys / h], -1).reshape(1, -1, 2).astype(np.float32)
    tex = rng.rand(1, 3, tex_size, tex_size).astype(np.float32)
    return {"v": v, "vi": vi, "vt": vt, "tex": tex}


def inverse8_scene_arrays(h: int = 512, gn: int = 81, views: int = 8, seed: int = 0,
                          tex_size: int = 256) -> dict[str, np.ndarray]:
    """A world-space grid mesh of 2*(gn-1)^2 triangles at z ~ 4, per-vertex
    uvs, a ground-truth texture of 3 x tex_size^2, and ``views`` pinhole
    cameras on a small ring, all looking +z and framed to fill an h x h
    canvas: ``v_world`` [1, V, 3], ``vi`` [F, 3] int32, ``vt`` [1, V, 2],
    ``tex_gt`` [1, 3, tex_size, tex_size], ``campos`` [views, 3], ``camrot``
    [views, 3, 3], ``focal`` [views, 2, 2], ``princpt`` [views, 2]."""
    w = h
    rng = np.random.RandomState(rng_seed(seed))
    ys, xs = np.meshgrid(np.linspace(-0.9, 0.9, gn), np.linspace(-0.9, 0.9, gn), indexing="ij")
    z = 4.0 + 0.3 * rng.randn(gn, gn)
    v_world = np.stack([xs, ys, z], -1).reshape(1, -1, 3).astype(np.float32)
    idx = np.arange(gn * gn).reshape(gn, gn)
    vi = np.concatenate([
        np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1]], -1).reshape(-1, 3),
        np.stack([idx[:-1, 1:], idx[1:, 1:], idx[1:, :-1]], -1).reshape(-1, 3),
    ]).astype(np.int32)
    vt = np.stack([(xs + 1) / 2, (ys + 1) / 2], -1).reshape(1, -1, 2).astype(np.float32)
    tex_gt = rng.rand(1, 3, tex_size, tex_size).astype(np.float32)
    th = np.linspace(0, 2 * np.pi, views, endpoint=False)
    campos = np.stack([0.25 * np.cos(th), 0.25 * np.sin(th), np.zeros(views)], -1).astype(np.float32)
    camrot = np.tile(np.eye(3, dtype=np.float32), (views, 1, 1))
    focal = np.tile(np.diag([1.9 * h, 1.9 * h]).astype(np.float32), (views, 1, 1))
    princpt = np.tile(np.array([w / 2, h / 2], np.float32), (views, 1))
    return {"v_world": v_world, "vi": vi, "vt": vt, "tex_gt": tex_gt,
            "campos": campos, "camrot": camrot, "focal": focal, "princpt": princpt}


def multiview_scene_arrays(h: int, gn: int, cameras: int, seed: int = 0, tex_size: int = 512,
                           jitter: float = 3.0) -> dict[str, np.ndarray]:
    """:func:`make_scene_arrays` at h x h from ``seed``, seen by ``cameras``
    cameras: camera c's vertices are the grid's moved by its own offset,
    uniform in +-``jitter`` pixels (and depth) per axis, and it has its own
    3 x tex_size^2 texture (both from ``seed + 1``); ``v`` [cameras, V, 3],
    ``vt`` [cameras, V, 2], ``tex`` [cameras, 3, tex_size, tex_size]."""
    s = make_scene_arrays(h, h, gn, seed, tex_size)
    rng = np.random.RandomState(rng_seed(seed + 1))
    offsets = rng.uniform(-jitter, jitter, size=(cameras, 1, 3))
    tex = rng.rand(cameras, 3, tex_size, tex_size).astype(np.float32)
    return {"v": (s["v"] + offsets).astype(np.float32), "vi": s["vi"], "vt": np.repeat(s["vt"], cameras, 0),
            "tex": tex}


def avatar4k_scene_arrays(h: int = 4096, gn: int = 226, bh: int = 256, seed: int = 0, n_levels: int = 4,
                          tex_size: int = 512, msi_shape=(8, 4, 64, 128)) -> dict:
    """:func:`make_scene_arrays` at h x h, then the mip ``levels`` (3 x
    tex_size^2 halving, [1, 3, s, s] each) and ``msi_tex``, and the MSI
    background's bh x bh unit rays from the origin (``ray_o``, ``ray_d``
    [bh*bh, 3]); float32 but ``vi``."""
    arrays = make_scene_arrays(h, h, gn, seed)
    rng = np.random.RandomState(rng_seed(seed + 1))
    levels = [rng.rand(1, 3, tex_size >> i, tex_size >> i).astype(np.float32) for i in range(n_levels)]
    msi_tex = rng.rand(*msi_shape).astype(np.float32)
    ys, xs = np.meshgrid(np.linspace(-1, 1, bh), np.linspace(-1, 1, bh), indexing="ij")
    ray_d = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    ray_d = ray_d.astype(np.float32)
    return {**arrays, "levels": levels, "msi_tex": msi_tex, "ray_o": np.zeros_like(ray_d), "ray_d": ray_d}
