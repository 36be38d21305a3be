"""The textured pipeline end to end: rasterize -> render -> interpolate uvs
-> texture with grid_sample -> mask -> edge_grad_estimator, op for op as the
JAX package's single-chip step (``__graft_entry__._forward``), and the
fitting step on it: the loss of ``bench.py`` (``bench_textured``,
``_grad_case_textured``) and one backward to ``v``, ``vt`` and ``tex``.
"""

from __future__ import annotations

import torch

from drtk_tpu_torch.interop import resolve_device
from drtk_tpu_torch.ops.edge_grad import edge_grad_estimator
from drtk_tpu_torch.ops.grid_sample import grid_sample
from drtk_tpu_torch.ops.interpolate import interpolate
from drtk_tpu_torch.ops.rasterize import rasterize
from drtk_tpu_torch.ops.render import render

__all__ = [
    "BACKWARD_STAGES", "FIT_STAGES", "STAGES", "fit_step", "render_textured", "stage_ms", "textured_loss",
]

STAGES = ("rasterize", "render", "interpolate", "grid_sample", "mask", "edge_grad")
# In the order autograd runs them: each ends when the gradient of that op's
# input is ready (grid_sample_bwd includes the mask's and the texture
# scatter's; render_bwd ends when the backward returns).
BACKWARD_STAGES = ("edge_grad_bwd", "grid_sample_bwd", "interpolate_bwd", "render_bwd")
FIT_STAGES = STAGES + ("loss",) + BACKWARD_STAGES
FIT_LEAVES = ("v", "vt", "tex")


def _marker(stage_times: list | None):
    """``mark(name)`` appends (name, CUDA event recorded now) to
    ``stage_times``; ``mark(name, t)`` does so when the gradient of ``t``
    is computed in a backward pass (if ``t`` requires one)."""

    def record(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        stage_times.append((name, ev))

    def mark(name, grad_of=None):
        if stage_times is None:
            return
        if grad_of is None:
            record(name)
        elif grad_of.requires_grad:
            grad_of.register_hook(lambda _grad: record(name))

    return mark


def render_textured(
    v: torch.Tensor,
    vi: torch.Tensor,
    vt: torch.Tensor,
    tex: torch.Tensor,
    h: int,
    w: int,
    device="cuda",
    impl: str = "auto",
    stage_times: list | None = None,
    index_img: torch.Tensor | None = None,
):
    """Render a textured mesh.

    Args:
        v: [N, V, 3] pixel-space vertices; vi: [F, 3] int32 faces;
        vt: [N, V, 2] uvs in [0, 1]; tex: [N, C, Ht, Wt] texture.
        h, w: canvas size.
        device: where the inputs lie and the work runs; "cuda" raises when
            CUDA is absent, and inputs on another device raise.
        impl: "auto" runs the kernels on CUDA tensors; "plain" runs the
            plain PyTorch versions of the kernels (their yardstick).
        stage_times: if a list is given (CUDA only), a CUDA event is
            recorded before the first stage and after each, appended as
            (stage name, event); read them with :func:`stage_ms`. A
            backward pass through the result appends the marks of
            :data:`BACKWARD_STAGES` but the last.
        index_img: optional [N, H, W] int32 index image to use instead of
            rasterizing (so two implementations can be compared on the same
            discrete structure, as ``bench._grad_case_textured`` does).

    Returns:
        (img [N, C, H, W], index_img [N, H, W] int32).
    """
    dev = resolve_device(device)
    for name, t in (("v", v), ("vi", vi), ("vt", vt), ("tex", tex), ("index_img", index_img)):
        if t is not None and (t.device.type != dev.type or dev.index not in (None, t.device.index)):
            raise ValueError(f"render_textured: {name} is on {t.device}, expected {dev}")
    if stage_times is not None and dev.type != "cuda":
        raise ValueError("render_textured: stage_times needs a CUDA device")
    mark = _marker(stage_times)

    mark("start")
    if index_img is None:
        index_img = rasterize(v, vi, h, w, impl=impl)
    elif tuple(index_img.shape) != (v.shape[0], h, w) or index_img.dtype != torch.int32:
        raise ValueError(f"render_textured: expected an int32 index_img of shape {(v.shape[0], h, w)}")
    mark("rasterize")
    _, bary_img = render(v, vi, index_img, impl=impl)
    mark("render")
    mark("interpolate_bwd", bary_img)
    vt_img = interpolate(vt, vi, index_img, bary_img, impl=impl)  # [N, 2, H, W]
    mark("interpolate")
    uv = vt_img.movedim(1, -1) * 2.0 - 1.0
    mark("grid_sample_bwd", uv)
    img = grid_sample(tex, uv, mode="bilinear", padding_mode="border", impl=impl)
    mark("grid_sample")
    img = img * (index_img != -1)[:, None]
    mark("mask")
    mark("edge_grad_bwd", img)
    img = edge_grad_estimator(v_pix=v, vi=vi, bary_img=bary_img, img=img, index_img=index_img, impl=impl)
    mark("edge_grad")
    return img, index_img


def textured_loss(img: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
    """``mean(img**2)``, the loss of ``bench.py:bench_textured``; with a
    ``weight`` image, ``sum(img * weight)``, the loss of
    ``bench.py:_grad_case_textured``."""
    if weight is None:
        return (img**2).mean()
    return (img * weight).sum()


def fit_step(
    v: torch.Tensor,
    vi: torch.Tensor,
    vt: torch.Tensor,
    tex: torch.Tensor,
    h: int,
    w: int,
    wrt=FIT_LEAVES,
    index_img: torch.Tensor | None = None,
    weight: torch.Tensor | None = None,
    device="cuda",
    impl: str = "auto",
    stage_times: list | None = None,
):
    """One fitting step: render the textured mesh, take
    :func:`textured_loss`, and run one backward.

    Args:
        v, vi, vt, tex, h, w, device, impl, index_img: as for
            :func:`render_textured`.
        wrt: the leaves to differentiate, a subset of ("v", "vt", "tex");
            ``("v",)`` is the gradient of ``bench.py:bench_textured``. No
            work is done for a gradient that is not asked for (the texture
            scatter, kernel B4, runs only for "tex").
        weight: optional [N, C, H, W] weight image of the loss.
        stage_times: as for :func:`render_textured`, with marks "loss"
            (after the loss) and the backward's :data:`BACKWARD_STAGES`
            added; with all three gradients (or v's alone) the stage names
            are :data:`FIT_STAGES`. Marks of gradients not computed are
            left out.

    Returns:
        (loss, grads): the detached scalar loss and a dict of gradients,
        one per name in ``wrt``.
    """
    leaves = {"v": v, "vt": vt, "tex": tex}
    wrt = tuple(wrt)
    if not wrt or any(k not in leaves for k in wrt):
        raise ValueError(f"fit_step: wrt must name some of {FIT_LEAVES}, got {wrt}")
    if weight is not None and weight.device != v.device:
        raise ValueError(f"fit_step: weight is on {weight.device}, expected {v.device}")
    inputs = {k: t.detach().requires_grad_(k in wrt) for k, t in leaves.items()}
    img, _ = render_textured(
        inputs["v"], vi, inputs["vt"], inputs["tex"], h, w,
        device=device, impl=impl, stage_times=stage_times, index_img=index_img,
    )
    mark = _marker(stage_times)
    loss = textured_loss(img, weight)
    mark("loss")
    grads = torch.autograd.grad(loss, [inputs[k] for k in wrt])
    mark("render_bwd")
    return loss.detach(), dict(zip(wrt, grads))


def stage_ms(stage_times: list) -> dict[str, float]:
    """Milliseconds between consecutive marks of ``stage_times`` (waits for
    the last event)."""
    stage_times[-1][1].synchronize()
    return {
        name: start.elapsed_time(end)
        for (_, start), (name, end) in zip(stage_times[:-1], stage_times[1:])
    }
