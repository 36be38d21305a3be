"""Entry ``fisheye62``: ``drtk_tpu_torch.pipeline.mipviews_step`` in a user's
fit loop, as entry ``mipviews`` drives it, with every camera a wide-angle
Fisheye62 lens: inverse8's mesh brought to depth ``depth`` (its relief
scaled with it) before the ring of cameras at focal ``focal`` px, each
view's coefficients the configuration's ``lens`` moved by the seed, and
``fov`` estimated once at set-up (``estimate_fisheye62_fov``). The views
are projected through the lens, and the uv Jacobian that drives
``mipmap_grid_sample`` is taken through it."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from drtk_tpu_torch import pipeline
from drtk_tpu_torch.utils.projection import estimate_fisheye62_fov
from drtkbench.harness import load_module
from drtkbench.scenes import inverse8_scene_arrays, rng_seed

mipviews = load_module("entries", "mipviews")
pixels = mipviews.pixels
# inverse8's grid stands at z = 4 + 0.3 randn.
INVERSE8_DEPTH = 4.0
# Each view's lens: the radial coefficients (k0..k5) moved by 0.01 randn, the
# tangential ones (p0, p1) by 2e-4 randn, as drtk_tpu_torch.scenes.inverse8_lens_arrays.
LENS_JITTER = np.array([0.01] * 6 + [2e-4] * 2)


def scene(cfg: dict, traffic: dict, seed: int) -> dict:
    """Entry ``mipviews``' scene with the grid's depths scaled by ``depth`` /
    4, focal ``focal`` px, and the lenses (``distortion_coeff`` [views, 8],
    from ``seed + 1``)."""
    s = mipviews.scene(cfg, traffic, seed)
    s["v_gt"] = s["v_gt"] * np.array([1, 1, cfg["depth"] / INVERSE8_DEPTH], np.float32)
    s["v_world"] = s["v_gt"] + np.float32(cfg["offset"])
    s["focal"] = np.tile(np.diag([cfg["focal"], cfg["focal"]]).astype(np.float32), (cfg["views"], 1, 1))
    rng = np.random.RandomState(rng_seed(seed + 1))
    lens = np.asarray(cfg["lens"], np.float64) + LENS_JITTER * rng.randn(cfg["views"], len(cfg["lens"]))
    return {**s, "distortion_coeff": lens.astype(np.float32)}


class Program(mipviews.Program):
    """Entry ``mipviews``' program with the lens in its cameras."""

    def __init__(self, cfg: dict, traffic: dict, arrays: dict, device):
        super().__init__(cfg, traffic, arrays, device)
        coeff = torch.as_tensor(arrays["distortion_coeff"], device=device)
        self.cams.update(distortion_mode="fisheye62", distortion_coeff=coeff, fov=estimate_fisheye62_fov(coeff))


@contextlib.contextmanager
def _patched(name: str, make):
    orig = getattr(pipeline, name)
    setattr(pipeline, name, make(orig))
    try:
        yield
    finally:
        setattr(pipeline, name, orig)


def _half():
    """The first half of the views rendered, the loss's mean over them."""

    def make(orig):
        def half(params, optimizer, vi, vt, cams, img_gt, *args, **kwargs):
            n = img_gt.shape[0] // 2
            cams = {k: t[:n] if torch.is_tensor(t) else t for k, t in cams.items()}
            return orig(params, optimizer, vi, vt, cams, img_gt[:n], *args, **kwargs)
        return half

    return _patched("mipviews_step", make)


def _pinhole_jacobian():
    """The views projected through the lens but shaded with the pinhole uv
    Jacobian: the lens left out of ``screen_space_uv_derivative``."""

    def make(orig):
        def pinhole(v, vt, vi, vti, index_img, bary_img, mask, campos, camrot, focal, *lens, impl="auto", fov=None):
            return orig(v, vt, vi, vti, index_img, bary_img, mask, campos, camrot, focal, impl=impl)
        return pinhole

    return _patched("screen_space_uv_derivative", make)


# Faults planted in the program, for the tests and the readings of the
# checks' limits; no run of the benchmark plants one.
FAULTS = {"unchanged": mipviews._unchanged, "half": _half, "pinhole_jacobian": _pinhole_jacobian}
