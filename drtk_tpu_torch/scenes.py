"""The repository's benchmark scenes, built with numpy alone.

Copies of ``bench.make_scene`` (the textured grid mesh behind every
throughput figure), ``__graft_entry__._scene`` (a soup of large,
overlapping random triangles), the scene of ``bench.bench_inverse8``
(a world-space grid seen by a ring of pinhole cameras) and that of
``bench.bench_avatar4k`` (the grid at 4096^2 with a mip pyramid and an MSI
background), seeded with
``np.random.RandomState(seed)`` and drawn in the same order as there, so
the two packages build identical scenes.
"""

from __future__ import annotations

import numpy as np

from drtk_tpu_torch.interop import scene_from_numpy

__all__ = [
    "INVERSE8_LENSES", "avatar4k_scene_arrays", "box_pyramid", "entry_scene", "entry_scene_arrays",
    "inverse8_lens_arrays", "inverse8_scene_arrays", "make_scene", "make_scene_arrays", "with_edge_flags",
]


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


def inverse8_scene_arrays(
    h: int = 512, gn: int = 81, views: int = 8, seed: int = 0, tex_size: int = 256
) -> dict[str, np.ndarray]:
    """The multi-view inverse-rendering scene of ``bench.bench_inverse8``
    as numpy arrays: a world-space grid mesh of 2*(gn-1)^2 triangles (12,800
    at gn=81) at z ~ 4, per-vertex uvs, a ground-truth texture of
    3 x tex_size x tex_size, and ``views`` pinhole cameras on a small ring,
    all looking +z and framed to fill an h x h canvas.

    Returns ``v_world`` [1, V, 3], ``vi`` [F, 3] int32, ``vt`` [1, V, 2],
    ``tex_gt`` [1, 3, tex_size, tex_size], ``campos`` [views, 3],
    ``camrot`` [views, 3, 3], ``focal`` [views, 2, 2], ``princpt``
    [views, 2], all float32 but ``vi``."""
    w = h
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.linspace(-0.9, 0.9, gn), np.linspace(-0.9, 0.9, gn), indexing="ij")
    z = 4.0 + 0.3 * rng.randn(gn, gn)
    v_world = np.stack([xs, ys, z], -1).reshape(1, -1, 3).astype(np.float32)
    idx = np.arange(gn * gn).reshape(gn, gn)
    vi = np.concatenate(
        [
            np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1]], -1).reshape(-1, 3),
            np.stack([idx[:-1, 1:], idx[1:, 1:], idx[1:, :-1]], -1).reshape(-1, 3),
        ]
    ).astype(np.int32)
    vt = np.stack([(xs + 1) / 2, (ys + 1) / 2], -1).reshape(1, -1, 2).astype(np.float32)
    tex_gt = rng.rand(1, 3, tex_size, tex_size).astype(np.float32)
    th = np.linspace(0, 2 * np.pi, views, endpoint=False)
    campos = np.stack([0.25 * np.cos(th), 0.25 * np.sin(th), np.zeros(views)], -1).astype(np.float32)
    camrot = np.tile(np.eye(3, dtype=np.float32), (views, 1, 1))
    focal = np.tile(np.diag([1.9 * h, 1.9 * h]).astype(np.float32), (views, 1, 1))
    princpt = np.tile(np.array([w / 2, h / 2], np.float32), (views, 1))
    return {
        "v_world": v_world, "vi": vi, "vt": vt, "tex_gt": tex_gt,
        "campos": campos, "camrot": camrot, "focal": focal, "princpt": princpt,
    }


# Lenses for the inverse8 cameras (their view spans a normalized radius of ~0.37
# at the corners; the mesh reaches ~0.45): each model's coefficients, in its own
# order, before a seeded per-view jitter. The radial polynomials stay monotonic
# well past the view: with the jitter of seed 0, the FOV estimators find the
# first turning point beyond tan(theta) = 1.5 for the fisheye models (or none,
# and cap theta at pi/2), and beyond r = 1.1 for radial-tangential.
INVERSE8_LENSES = {
    # k0..k5, p0, p1
    "fisheye62": (-0.30, 0.05, -0.01, 0.0, 0.0, 0.0, 1e-3, -1e-3),
    # k1, k2, p1, p2, k3
    "radial-tangential": (-0.30, 0.02, 1e-3, -1e-3, 0.0),
    # k1..k4
    "fisheye": (-0.30, 0.05, -0.01, 0.0),
}


def inverse8_lens_arrays(mode, views: int = 8, seed: int = 0) -> np.ndarray:
    """Distortion coefficients for the ``views`` cameras of
    :func:`inverse8_scene_arrays`, float32 [views, K]: for a model of
    :data:`INVERSE8_LENSES`, its coefficients with each radial one moved by
    ``0.01 * randn`` and each tangential one by ``2e-4 * randn`` per view
    (``RandomState(seed)``); for a per-view list of modes, each row the
    coefficients of its mode (K = 5, radial-tangential's count; fisheye reads
    the first 4, a pinhole row none)."""
    rng = np.random.RandomState(seed)
    if isinstance(mode, str):
        base = np.asarray(INVERSE8_LENSES[mode], np.float64)
        tangential = {"fisheye62": (6, 7), "radial-tangential": (2, 3), "fisheye": ()}[mode]
        scale = np.full(base.shape, 0.01)
        scale[list(tangential)] = 2e-4
        return (base + scale * rng.randn(views, base.size)).astype(np.float32)
    if len(mode) != views:
        raise ValueError(f"inverse8_lens_arrays: {len(mode)} modes for {views} views")
    rows = [inverse8_lens_arrays(m, 1, seed + i)[0] if m in ("radial-tangential", "fisheye") else np.zeros(0)
            for i, m in enumerate(mode)]
    return np.stack([np.pad(r, (0, 5 - r.size)) for r in rows]).astype(np.float32)


def box_pyramid(tex: np.ndarray, count: int) -> list[np.ndarray]:
    """``count`` mip levels of ``tex`` [N, C, H, W] (H and W divisible by
    2**(count-1)), each the 2x2 box average of the one before, as
    ``examples/04_rendering_meshes.py`` builds its pyramid."""
    levels = [np.asarray(tex)]
    for _ in range(count - 1):
        t = levels[-1]
        levels.append((t[..., ::2, ::2] + t[..., 1::2, ::2] + t[..., ::2, 1::2] + t[..., 1::2, 1::2]) / 4.0)
    return levels


def avatar4k_scene_arrays(h: int = 4096, gn: int = 226, bh: int = 256) -> dict:
    """The scene of ``bench.bench_avatar4k`` (``bench.py:376-396``) as numpy
    arrays: :func:`make_scene_arrays` at ``h x h`` (``v``, ``vi``, ``vt``,
    ``tex``; 2*(gn-1)^2 = 101,250 triangles at gn=226), then from
    ``RandomState(1)`` the mip ``levels`` (four of 3 x 512^2 down to
    3 x 64^2, [1, 3, s, s] each) and ``msi_tex`` [8, 4, 64, 128], and the
    MSI background's ``bh x bh`` unit rays from the origin, ``ray_o`` and
    ``ray_d`` [bh*bh, 3]; float32 but ``vi``."""
    arrays = make_scene_arrays(h, h, gn)
    rng = np.random.RandomState(1)
    levels = [rng.rand(1, 3, 512 >> i, 512 >> i).astype(np.float32) for i in range(4)]
    msi_tex = rng.rand(8, 4, 64, 128).astype(np.float32)
    ys, xs = np.meshgrid(np.linspace(-1, 1, bh), np.linspace(-1, 1, bh), indexing="ij")
    ray_d = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    ray_d = ray_d.astype(np.float32)
    return {**arrays, "levels": levels, "msi_tex": msi_tex, "ray_o": np.zeros_like(ray_d), "ray_d": ray_d}


def with_edge_flags(vi: np.ndarray, flags=0x7) -> np.ndarray:
    """A copy of int32 ``vi`` with ``flags`` (an int, or one per face) set
    in the top nibble of ``vi[..., 0]``: bits 28, 29 and 30 mark edges
    (0, 1), (1, 2) and (0, 2) visible to wireframe rasterization."""
    vi = np.array(vi, dtype=np.int32)
    nibble = np.asarray(flags, dtype=np.uint32) << np.uint32(28)
    vi[..., 0] = (vi[..., 0].astype(np.uint32) | nibble).view(np.int32)
    return vi


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
