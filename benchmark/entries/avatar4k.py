"""Entry ``avatar4k``: ``drtk_tpu_torch.pipeline.avatar4k_step`` in a
user's fit loop: the frame in row bands (recomputed in the backward when
``remat``), mipmapped shading, the banded edge gradient, an MSI background,
``mean(img**2)`` and a ``torch.optim.Adam`` update of the vertices, the mip
levels and the MSI texture."""

from __future__ import annotations

import contextlib

import torch

from drtk_tpu_torch import pipeline
from drtkbench.scenes import avatar4k_scene_arrays


def scene(cfg: dict, traffic: dict, seed: int) -> dict:
    arrays = avatar4k_scene_arrays(cfg["height"], cfg["grid"], cfg["rays"], seed, cfg["levels"], cfg["texture"],
                                   tuple(cfg["msi"]))
    levels = arrays.pop("levels")
    arrays.pop("tex")
    return {**arrays, **{f"level{i}": lvl for i, lvl in enumerate(levels)}}


def pixels(cfg: dict, traffic: dict) -> int:
    return cfg["cameras"] * cfg["height"] * cfg["width"]


class Program:
    def __init__(self, cfg: dict, traffic: dict, arrays: dict, device):
        if traffic["wrt"] != "all" or traffic["frozen_index"] or traffic["batch"] != 1:
            raise ValueError("avatar4k: the step fits every leaf of one frame and rasterizes every step")
        self.device = device
        self.cfg = cfg
        self.s = {k: torch.tensor(a, device=device) for k, a in arrays.items()}
        self.names = ["v", *(f"level{i}" for i in range(cfg["levels"])), "msi_tex"]
        self.leaves = [self.s[k].requires_grad_() for k in self.names]
        self.opt = torch.optim.Adam(self.leaves, lr=traffic["lr"])

    def step(self, stage_times: list | None = None) -> torch.Tensor:
        s, cfg = self.s, self.cfg
        params = (s["v"], [s[f"level{i}"] for i in range(cfg["levels"])], s["msi_tex"])
        loss, _ = pipeline.avatar4k_step(params, self.opt, s["vi"], s["vt"], s["ray_o"], s["ray_d"], cfg["height"],
                                         n_bands=cfg["bands"], remat=cfg["remat"], device=self.device,
                                         stage_times=stage_times)
        return loss


@contextlib.contextmanager
def _unchanged():
    """The step's loss and backward without the optimizer's update."""
    orig = pipeline.avatar4k_step

    def step(params, optimizer, *args, **kwargs):
        class Idle:
            def step(self):
                pass
        return orig(params, Idle(), *args, **kwargs)

    pipeline.avatar4k_step = step
    try:
        yield
    finally:
        pipeline.avatar4k_step = orig


@contextlib.contextmanager
def _half():
    """Only the upper half of the bands rendered, each twice: the loss's
    mean is taken over half the frame's rows."""
    orig = pipeline.map_row_bands

    def bands(band_fn, height, n_bands, remat=True):
        out = orig(band_fn, height // 2, n_bands // 2, remat)
        return tuple(torch.cat([t, t], dim=-2) for t in out)

    pipeline.map_row_bands = bands
    try:
        yield
    finally:
        pipeline.map_row_bands = orig


# Faults planted in the program, for the tests and the readings of the
# checks' limits; no run of the benchmark plants one.
FAULTS = {"unchanged": _unchanged, "half": _half}
