"""The forward render path end to end: rasterize -> render -> interpolate
uvs -> texture with grid_sample -> mask -> edge_grad_estimator, op for op
as the JAX package's single-chip forward step (``__graft_entry__._forward``).
"""

from __future__ import annotations

import torch

from drtk_tpu_torch.interop import resolve_device
from drtk_tpu_torch.ops.edge_grad import edge_grad_estimator
from drtk_tpu_torch.ops.grid_sample import grid_sample
from drtk_tpu_torch.ops.interpolate import interpolate
from drtk_tpu_torch.ops.rasterize import rasterize
from drtk_tpu_torch.ops.render import render

__all__ = ["STAGES", "render_textured", "stage_ms"]

STAGES = ("rasterize", "render", "interpolate", "grid_sample", "mask", "edge_grad")


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
            (stage name, event); read them with :func:`stage_ms`.

    Returns:
        (img [N, C, H, W], index_img [N, H, W] int32).
    """
    dev = resolve_device(device)
    for name, t in (("v", v), ("vi", vi), ("vt", vt), ("tex", tex)):
        if t.device.type != dev.type or dev.index not in (None, t.device.index):
            raise ValueError(f"render_textured: {name} is on {t.device}, expected {dev}")
    if stage_times is not None and dev.type != "cuda":
        raise ValueError("render_textured: stage_times needs a CUDA device")

    def mark(name):
        if stage_times is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stage_times.append((name, ev))

    mark("start")
    index_img = rasterize(v, vi, h, w, impl=impl)
    mark("rasterize")
    _, bary_img = render(v, vi, index_img, impl=impl)
    mark("render")
    vt_img = interpolate(vt, vi, index_img, bary_img, impl=impl)  # [N, 2, H, W]
    mark("interpolate")
    uv = vt_img.movedim(1, -1) * 2.0 - 1.0
    img = grid_sample(tex, uv, mode="bilinear", padding_mode="border")
    mark("grid_sample")
    img = img * (index_img != -1)[:, None]
    mark("mask")
    img = edge_grad_estimator(v_pix=v, vi=vi, bary_img=bary_img, img=img, index_img=index_img)
    mark("edge_grad")
    return img, index_img


def stage_ms(stage_times: list) -> dict[str, float]:
    """Milliseconds between consecutive marks of ``stage_times`` (waits for
    the last event)."""
    stage_times[-1][1].synchronize()
    return {
        name: start.elapsed_time(end)
        for (_, start), (name, end) in zip(stage_times[:-1], stage_times[1:])
    }
