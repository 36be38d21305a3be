"""Entry ``mipviews``: ``drtk_tpu_torch.pipeline.mipviews_step`` in a user's
fit loop: inverse8's mesh and cameras, the texture's mip pyramid rebuilt
every step, every view rendered through ``render_mipmap_multiview`` (the
analytic screen-space uv Jacobian driving ``mipmap_grid_sample``, bilinear,
border, max_aniso 4), the silhouette, the edge-gradient estimator,
``mean((img - img_gt)**2)`` against the target the reference rendered at
set-up, one backward to the world vertices and the base texture, and a
``torch.optim.Adam`` update of both."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from drtk_tpu_torch import pipeline
from drtkbench.scenes import inverse8_scene_arrays

CAMERAS = ("campos", "camrot", "focal", "princpt")


def scene(cfg: dict, traffic: dict, seed: int) -> dict:
    """The true mesh and texture (``v_gt``, ``tex_gt``), the cameras, and
    the fit's start: the vertices moved by ``offset``, the texture grey."""
    a = inverse8_scene_arrays(cfg["height"], cfg["grid"], cfg["views"], seed, cfg["texture"])
    v_gt, tex_gt = a.pop("v_world"), a.pop("tex_gt")
    return {**a, "v_gt": v_gt, "tex_gt": tex_gt, "v_world": v_gt + np.float32(cfg["offset"]),
            "tex": np.full_like(tex_gt, 0.5)}


def pixels(cfg: dict, traffic: dict) -> int:
    return cfg["views"] * cfg["height"] * cfg["width"]


class Program:
    """The program's side of one cell: the scene's tensors on ``device``, the
    leaves it fits, their Adam; :meth:`step` runs one step."""

    def __init__(self, cfg: dict, traffic: dict, arrays: dict, device):
        if traffic["wrt"] != "all" or traffic["frozen_index"] or traffic["batch"] != 1:
            raise ValueError("mipviews: the step fits the vertices and the texture of one mesh, rasterized each step")
        if (cfg["max_aniso"], cfg["padding"]) != (4, "border"):
            raise ValueError("mipviews: the mipmapped views sample at max_aniso 4 with border padding")
        self.device = device
        self.h, self.w, self.levels = cfg["height"], cfg["width"], cfg["levels"]
        self.vi, self.vt, self.img_gt = (torch.as_tensor(arrays[k], device=device) for k in ("vi", "vt", "img_gt"))
        self.cams = {k: torch.as_tensor(arrays[k], device=device) for k in CAMERAS}
        self.names = ["v_world", "tex"]
        self.leaves = [torch.tensor(arrays[k], device=device).requires_grad_() for k in self.names]
        self.opt = torch.optim.Adam(self.leaves, lr=traffic["lr"])

    def step(self, stage_times: list | None = None) -> torch.Tensor:
        loss, _ = pipeline.mipviews_step(tuple(self.leaves), self.opt, self.vi, self.vt, self.cams, self.img_gt,
                                         self.h, self.w, self.levels, device=self.device, stage_times=stage_times)
        return loss


@contextlib.contextmanager
def _patched(step):
    orig = pipeline.mipviews_step
    pipeline.mipviews_step = step(orig)
    try:
        yield
    finally:
        pipeline.mipviews_step = orig


def _unchanged():
    """The step's loss and backward without the optimizer's update."""

    class Idle:
        def step(self):
            pass

    return _patched(lambda orig: lambda params, optimizer, *args, **kwargs: orig(params, Idle(), *args, **kwargs))


def _half():
    """The first half of the views rendered, the loss's mean over them."""

    def step(orig):
        def half(params, optimizer, vi, vt, cams, img_gt, *args, **kwargs):
            n = img_gt.shape[0] // 2
            return orig(params, optimizer, vi, vt, {k: t[:n] for k, t in cams.items()}, img_gt[:n], *args,
                        **kwargs)
        return half

    return _patched(step)


# Faults planted in the program, for the tests and the readings of the
# checks' limits; no run of the benchmark plants one.
FAULTS = {"unchanged": _unchanged, "half": _half}
