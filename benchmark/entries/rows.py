"""Entry ``rows``: the row-sharded pipeline of ``drtk_tpu_torch``
(``parallel.spmd.make_row_sharded_forward``) in a user's fit loop, one
process per card: every rank holds every camera's vertices, uvs and
texture, renders its block of rows of every camera's frame (rasterize,
render, interpolate, bilinear border sampling, the mask, the edge-gradient
estimator, whose backward fetches a halo row from the next rank), takes its
part of ``mean(img**2)`` over the whole frames, and runs one backward, in
which each input's gradient is summed over the ranks by an all-reduce;
then a ``torch.optim.Adam`` update, the same on every rank."""

from __future__ import annotations

import contextlib
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from drtk_tpu_torch.parallel import spmd
from drtkbench.scenes import multiview_scene_arrays

LEAVES = ("v", "vt", "tex")
_MESHES: dict = {}


def scene(cfg: dict, traffic: dict, seed: int) -> dict:
    return multiview_scene_arrays(cfg["height"], cfg["grid"], cfg["cameras"], seed, cfg["texture"], cfg["jitter"])


def pixels(cfg: dict, traffic: dict) -> int:
    return cfg["cameras"] * cfg["height"] * cfg["width"]


def mesh(cfg: dict, device) -> DeviceMesh:
    """The configuration's ("data", "pix") mesh over the group's ranks, built
    once per process (building it is collective)."""
    data, pix = cfg["mesh"]
    if data != 1 or pix != dist.get_world_size():
        raise ValueError(f"rows: a (1, ranks) mesh of the group's {dist.get_world_size()} ranks, got {cfg['mesh']}")
    key = (torch.device(device).type, data, pix)
    if key not in _MESHES:
        _MESHES[key] = DeviceMesh(key[0], torch.arange(data * pix).reshape(data, pix),
                                  mesh_dim_names=("data", "pix"))
    return _MESHES[key]


def _loss(block: torch.Tensor, count: int) -> torch.Tensor:
    """This rank's part of ``mean(img**2)``: its block's squares over every
    value of the frames."""
    return (block**2).sum() / count


class Program:
    """This rank's side of one cell: every camera's leaves on ``device``,
    the row-sharded forward, Adam; :meth:`step` runs one step and returns
    this rank's part of the loss."""

    def __init__(self, cfg: dict, traffic: dict, arrays: dict, device):
        if traffic["wrt"] != "all":
            raise ValueError("rows: the step fits every camera's vertices, uvs and texture")
        h, w = cfg["height"], cfg["width"]
        self.names = list(LEAVES)
        self.leaves = [torch.tensor(arrays[k], device=device).requires_grad_() for k in self.names]
        vi = torch.as_tensor(arrays["vi"], device=device)
        self.forward = spmd.make_row_sharded_forward(mesh(cfg, device), vi, h, w)
        self.count = cfg["cameras"] * 3 * h * w
        self.opt = torch.optim.Adam(self.leaves, lr=traffic["lr"])

    def step(self, stage_times: list | None = None) -> torch.Tensor:
        loss = _loss(self.forward(*self.leaves), self.count)
        for p, g in zip(self.leaves, torch.autograd.grad(loss, self.leaves)):
            p.grad = g
        self.opt.step()
        return loss.detach()


@contextlib.contextmanager
def _setattr(obj, name: str, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _unchanged():
    """The step's loss and backward without the optimizer's update."""
    return _setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half():
    """The loss's mean over the first half of the cameras."""
    return _setattr(sys.modules[__name__], "_loss",
                    lambda block, count: (block[: block.shape[0] // 2] ** 2).sum() / (count / 2))


def _exchange():
    """The gradients' all-reduce between the cards left out: each rank
    updates its copy with its own rows' part of the gradient."""
    return _setattr(spmd, "psum_cotangent", lambda x, group: x)


# Faults planted in the program, for the tests and the readings of the
# checks' limits; no run of the benchmark plants one.
FAULTS = {"unchanged": _unchanged, "half": _half, "exchange": _exchange}
