"""The textured pipeline end to end: rasterize -> render -> interpolate uvs
-> texture with grid_sample -> mask -> edge_grad_estimator, op for op as the
JAX package's single-chip step (``__graft_entry__._forward``), and the
fitting step on it: the loss of ``bench.py`` (``bench_textured``,
``_grad_case_textured``) and one backward to ``v``, ``vt`` and ``tex``.

The multi-view path of ``bench.py:bench_inverse8``: one world-space mesh
broadcast to every camera, ``transform`` to pixel space, the same pipeline
with an rgb-plus-silhouette image, and the training step on it (squared
error to a target image, one backward to the world vertices and the
texture through the cameras, an Adam update).

The multi-view path's cameras may carry a lens (``distortion_mode``,
``distortion_coeff``, ``fov``), which ``transform`` applies.
:func:`render_mipmap_multiview` shades the views with mipmaps as
``examples/04_rendering_meshes.py`` does: the analytic screen-space uv
Jacobian (pinhole, or through a Fisheye62 lens) drives
``mipmap_grid_sample``. :func:`mipviews_step` fits one
texture through it, its pyramid rebuilt every step (:func:`mip_pyramid`).

The 4K avatar fit of ``bench.py:bench_avatar4k``: a 4096^2 frame of the
grid mesh rendered in row bands (``map_row_bands``, each band a bit-exact
viewport recomputed in the backward), shaded with ``mipmap_grid_sample``
from a mip pyramid at screen-space uv derivatives from finite differences,
``edge_grad_estimator_banded``, an MSI background rendered at low
resolution and upsampled, ``mean(img**2)``, and an Adam step over the
vertices, the pyramid and the MSI texture. On the card its loss and
gradients replay as one CUDA graph (:mod:`drtk_tpu_torch.step_graph`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from drtk_tpu_torch import tracing
from drtk_tpu_torch.interop import resolve_device
from drtk_tpu_torch.ops.edge_grad import edge_grad_estimator
from drtk_tpu_torch.ops.grid_sample import grid_sample
from drtk_tpu_torch.ops.interpolate import interpolate
from drtk_tpu_torch.ops.mipmap_grid_sample import mipmap_grid_sample
from drtk_tpu_torch.ops.msi import msi
from drtk_tpu_torch.ops.rasterize import rasterize
from drtk_tpu_torch.ops.render import render
from drtk_tpu_torch.parallel.banded import edge_grad_estimator_banded, map_row_bands
from drtk_tpu_torch.screen_space_uv_derivative import screen_space_uv_derivative
from drtk_tpu_torch.step_graph import StepGraph, StepKey, eager_reason
from drtk_tpu_torch.transform import transform

__all__ = [
    "AVATAR4K_STAGES", "BACKWARD_STAGES", "FIT_STAGES", "INVERSE8_STAGES", "MIPVIEWS_STAGES", "MULTIVIEW_STAGES",
    "STAGES", "avatar4k_background", "avatar4k_band", "avatar4k_loss", "avatar4k_step", "fit_step", "inverse8_step",
    "mip_pyramid", "mipviews_step", "render_mipmap_multiview", "render_multiview", "render_textured", "stage_ms",
    "textured_loss",
]

STAGES = ("rasterize", "render", "interpolate", "grid_sample", "mask", "edge_grad")
# In the order autograd runs them: each ends when the gradient of that op's
# input is ready (grid_sample_bwd includes the mask's and the texture
# scatter's; render_bwd ends when the backward returns).
BACKWARD_STAGES = ("edge_grad_bwd", "grid_sample_bwd", "interpolate_bwd", "render_bwd")
FIT_STAGES = STAGES + ("loss",) + BACKWARD_STAGES
FIT_LEAVES = ("v", "vt", "tex")
MULTIVIEW_STAGES = ("transform",) + STAGES
# render_bwd ends when the gradient of the pixel-space vertices is ready,
# transform_bwd when the world vertices' is; adam is the optimizer update.
INVERSE8_STAGES = MULTIVIEW_STAGES + ("loss",) + BACKWARD_STAGES + ("transform_bwd", "adam")
# The mipmapped step's: uv_derivative once the uv Jacobian is ready, so that
# grid_sample is the mipmapped sampling alone.
MIPVIEWS_STAGES = INVERSE8_STAGES[:4] + ("uv_derivative",) + INVERSE8_STAGES[4:]
# The avatar4k step's marks: the forward to the loss, the backward (the band
# recomputes included), the Adam update; one each per step.
AVATAR4K_STAGES = ("forward", "backward", "adam")


def _check_devices(fn: str, device, tensors) -> torch.device:
    """``device``, resolved; raises if a tensor among ``tensors`` (other
    values, such as a distortion mode, are skipped) lies elsewhere."""
    dev = resolve_device(device)
    for name, t in tensors.items():
        if torch.is_tensor(t) and (t.device.type != dev.type or dev.index not in (None, t.device.index)):
            raise ValueError(f"{fn}: {name} is on {t.device}, expected {dev}")
    return dev


def _bilinear(tex, uv, impl: str):
    """The shading of :func:`render_textured` and :func:`render_multiview`:
    bilinear border ``grid_sample`` of ``tex`` at ``uv``."""
    return grid_sample(tex, uv, mode="bilinear", padding_mode="border", impl=impl)


def _shade(fn: str, v, vi, vt, sample, h: int, w: int, impl: str, stage_times, index_img):
    """The stages every renderer shares, each marked in ``stage_times``:
    rasterize (unless ``index_img`` is given), render, interpolate the uvs,
    and shade with ``sample(uv [N, H, W, 2] in [-1, 1], index_img,
    bary_img)``. Returns (rgb [N, C, H, W], mask [N, 1, H, W] of rgb's
    dtype, bary_img, index_img)."""
    if index_img is None:
        index_img = rasterize(v, vi, h, w, impl=impl)
    elif tuple(index_img.shape) != (v.shape[0], h, w) or index_img.dtype != torch.int32:
        raise ValueError(f"{fn}: expected an int32 index_img of shape {(v.shape[0], h, w)}")
    tracing.mark(stage_times, "rasterize")
    _, bary_img = render(v, vi, index_img, impl=impl)
    tracing.mark(stage_times, "render")
    tracing.mark(stage_times, "interpolate_bwd", bary_img)
    vt_img = interpolate(vt, vi, index_img, bary_img, impl=impl)  # [N, 2, H, W]
    tracing.mark(stage_times, "interpolate")
    uv = vt_img.movedim(1, -1) * 2.0 - 1.0
    tracing.mark(stage_times, "grid_sample_bwd", uv)
    rgb = sample(uv, index_img, bary_img)
    tracing.mark(stage_times, "grid_sample")
    return rgb, (index_img != -1)[:, None].to(rgb.dtype), bary_img, index_img


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
    dev = _check_devices("render_textured", device, {"v": v, "vi": vi, "vt": vt, "tex": tex, "index_img": index_img})
    if stage_times is not None and dev.type != "cuda":
        raise ValueError("render_textured: stage_times needs a CUDA device")

    tracing.mark(stage_times, "start")
    rgb, maskf, bary_img, index_img = _shade(
        "render_textured", v, vi, vt, lambda uv, *_: _bilinear(tex, uv, impl), h, w, impl, stage_times, index_img
    )
    img = rgb * maskf
    tracing.mark(stage_times, "mask")
    tracing.mark(stage_times, "edge_grad_bwd", img)
    img = edge_grad_estimator(v_pix=v, vi=vi, bary_img=bary_img, img=img, index_img=index_img, impl=impl)
    tracing.mark(stage_times, "edge_grad")
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
    wrt: Sequence[str] = FIT_LEAVES,
    index_img: torch.Tensor | None = None,
    weight: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
    impl: str = "auto",
    stage_times: list | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
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
    loss = textured_loss(img, weight)
    tracing.mark(stage_times, "loss")
    grads = torch.autograd.grad(loss, [inputs[k] for k in wrt])
    tracing.mark(stage_times, "render_bwd")
    return loss.detach(), dict(zip(wrt, grads))


def render_multiview(
    v_world: torch.Tensor,
    vi: torch.Tensor,
    vt: torch.Tensor,
    tex: torch.Tensor,
    cams: dict,
    h: int,
    w: int,
    device: str | torch.device = "cuda",
    impl: str = "auto",
    stage_times: list | None = None,
    index_img: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render one mesh from every camera, op for op as the forward of
    ``bench.py:bench_inverse8``: broadcast to the views, ``transform``,
    rasterize, render, interpolate the uvs, bilinear border ``grid_sample``
    of the texture, ``cat([rgb * mask, mask])``, ``edge_grad_estimator``.

    Args:
        v_world: [1, V, 3] world-space vertices; vi: [F, 3] int32 faces;
        vt: [1, V, 2] uvs in [0, 1]; tex: [1, C, Ht, Wt] texture.
        cams: the cameras, keyword arguments of
            :func:`~drtk_tpu_torch.transform.transform`: tensors with one
            row per view (``campos``, ``camrot``, ``focal``, ``princpt``,
            or ``K``, ``Rt``) and, for a lens, ``distortion_mode`` (a mode
            or a per-view list), ``distortion_coeff`` and ``fov``.
        h, w: canvas size of every view.
        device, impl, index_img: as for :func:`render_textured`
            (``index_img`` is [views, H, W]).
        stage_times: as for :func:`render_textured`, with the marks of
            :data:`MULTIVIEW_STAGES`; a backward pass through the result
            appends those of :data:`BACKWARD_STAGES` (``render_bwd`` when
            the gradient of the pixel-space vertices is complete).

    Returns:
        (img [views, C + 1, H, W], index_img [views, H, W] int32): the
        masked rgb and the silhouette.
    """
    return _render_views(
        "render_multiview", v_world, vi, vt, {"tex": tex}, cams, h, w, device, impl, stage_times, index_img,
        lambda uv, *_: _bilinear(tex.expand(uv.shape[0], -1, -1, -1), uv, impl),
    )


def _views(cams: dict) -> int:
    """The number of views: the rows of the first camera tensor."""
    return next(t for t in cams.values() if torch.is_tensor(t)).shape[0]


def _render_views(fn: str, v_world, vi, vt, textures: dict, cams: dict, h: int, w: int, device, impl: str,
                  stage_times, index_img, sample):
    """The multi-view renderers' steps, each marked: the inputs checked
    (``textures`` names the texture tensors, each of batch 1), the mesh
    broadcast to the views and ``transform``-ed, :func:`_shade` with
    ``sample``, ``cat([rgb * mask, mask])``, ``edge_grad_estimator``.
    Returns (img [views, C + 1, H, W], index_img [views, H, W])."""
    dev = _check_devices(
        fn, device, {"v_world": v_world, "vi": vi, "vt": vt, "index_img": index_img, **textures, **cams}
    )
    if stage_times is not None and dev.type != "cuda":
        raise ValueError(f"{fn}: stage_times needs a CUDA device")
    if v_world.ndim != 3 or v_world.shape[0] != 1 or vt.shape[0] != 1 or any(
        t.shape[0] != 1 for t in textures.values()
    ):
        raise ValueError(f"{fn}: expected one mesh, uv set and texture (batch 1)")
    views = _views(cams)

    tracing.mark(stage_times, "start")
    v_pix = transform(v_world.expand(views, -1, -1), **cams)
    tracing.mark(stage_times, "transform")
    tracing.mark(stage_times, "render_bwd", v_pix)
    rgb, maskf, bary, index_img = _shade(
        fn, v_pix, vi, vt.expand(views, -1, -1), sample, h, w, impl, stage_times, index_img
    )
    img = torch.cat([rgb * maskf, maskf], dim=1)
    tracing.mark(stage_times, "mask")
    tracing.mark(stage_times, "edge_grad_bwd", img)
    img = edge_grad_estimator(v_pix=v_pix, vi=vi, bary_img=bary, img=img, index_img=index_img, impl=impl)
    tracing.mark(stage_times, "edge_grad")
    return img, index_img


def render_mipmap_multiview(
    v_world: torch.Tensor,
    vi: torch.Tensor,
    vt: torch.Tensor,
    levels: Sequence[torch.Tensor],
    cams: dict,
    h: int,
    w: int,
    device: str | torch.device = "cuda",
    impl: str = "auto",
    index_img: torch.Tensor | None = None,
    stage_times: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render one mesh from every camera with mipmapped anisotropic
    shading, op for op as ``examples/04_rendering_meshes.py`` (its lines
    38-62) per view: ``transform``, rasterize, render, interpolate the uvs,
    :func:`~drtk_tpu_torch.screen_space_uv_derivative.screen_space_uv_derivative`
    for the analytic uv Jacobian, ``mipmap_grid_sample`` (bilinear, border,
    ``max_aniso=4``); then, as :func:`render_multiview` ends, ``cat([rgb *
    mask, mask])`` and ``edge_grad_estimator``.

    Args:
        v_world: [1, V, 3] world-space vertices; vi: [F, 3] int32 faces (of
            positions and uvs alike); vt: [1, V, 2] uvs in [0, 1].
        levels: the mip pyramid, a list of [1, C, H_i, W_i], highest
            resolution first.
        cams: the cameras, one row per view: ``campos``, ``camrot``,
            ``focal``, ``princpt`` and, for a Fisheye62 lens,
            ``distortion_mode`` "fisheye62", ``distortion_coeff`` and
            ``fov`` (optional; pass it, computed once). The uv Jacobian goes
            through the lens (:func:`~drtk_tpu_torch.utils.projection.project_points_grad`),
            where the JAX package's is pinhole only; any other
            ``distortion_mode`` raises NotImplementedError, and cameras
            without ``campos``, ``camrot`` and ``focal`` raise ValueError.
        h, w: canvas size of every view.
        device, impl, index_img: as for :func:`render_multiview`.
        stage_times: as for :func:`render_multiview`, with "uv_derivative"
            once the uv Jacobian is ready (before "grid_sample"): the marks
            of :data:`MIPVIEWS_STAGES` up to "edge_grad".

    Returns:
        (img [views, C + 1, H, W], index_img [views, H, W] int32).
        Differentiable in ``v_world`` and the levels (the uv Jacobian, as in
        the JAX package, steers the mip selection only, and is computed
        without a graph).
    """
    missing = {"campos", "camrot", "focal"} - cams.keys()
    if missing:
        raise ValueError(f"render_mipmap_multiview: cams needs campos, camrot and focal, missing {sorted(missing)}")

    def sample(uv, index_img, bary):
        views = uv.shape[0]
        # The lens goes on to project_points_grad, which takes Fisheye62 and
        # raises for any other distortion mode.
        with torch.no_grad():
            jac = screen_space_uv_derivative(
                v_world.expand(views, -1, -1), vt.expand(views, -1, -1), vi, vi, index_img, bary, index_img != -1,
                cams["campos"], cams["camrot"], cams["focal"], cams.get("distortion_mode"),
                cams.get("distortion_coeff"), impl=impl, fov=cams.get("fov"),
            )
        tracing.mark(stage_times, "uv_derivative")
        lvls = [t.expand(views, -1, -1, -1) for t in levels]
        return mipmap_grid_sample(lvls, uv, jac, max_aniso=4, padding_mode="border", impl=impl)

    return _render_views(
        "render_mipmap_multiview", v_world, vi, vt, {f"levels[{i}]": t for i, t in enumerate(levels)}, cams, h, w,
        device, impl, stage_times, index_img, sample,
    )


def mip_pyramid(tex: torch.Tensor, count: int) -> list[torch.Tensor]:
    """``count`` mip levels of ``tex`` [N, C, H, W], highest resolution
    first, each the 2x2 mean of the one before (``F.avg_pool2d``), as
    ``examples/04_rendering_meshes.py`` builds its pyramid; differentiable,
    so the gradient of every level reaches ``tex``. H and W must be
    divisible by ``2**(count - 1)``. Spans ``mip_pyramid`` and
    ``mip_pyramid_bwd``."""
    if count < 1 or tex.ndim != 4 or tex.shape[-2] % 2 ** (count - 1) or tex.shape[-1] % 2 ** (count - 1):
        raise ValueError(f"mip_pyramid: [N, C, H, W] with H and W divisible by 2**(count - 1), got "
                         f"{tuple(tex.shape)} and count {count}")
    with tracing.span("mip_pyramid") as sp:
        (tex,) = sp.grad_in(tex)
        levels = [tex]
        for _ in range(count - 1):
            levels.append(F.avg_pool2d(levels[-1], 2))
        return sp.grad_out(levels)


def _fit_views(fn: str, render, params, optimizer, img_gt, stage_times):
    """The multi-view steps' loss, backward and update: ``render()`` (the
    views [views, C + 1, H, W]) and ``mean((img - img_gt)**2)`` in the span
    ``forward`` (mark "loss"), one backward to ``params = (v_world, tex)`` in
    ``backward`` (mark "transform_bwd"), ``optimizer.step()`` in ``adam``
    (mark "adam"). Returns (the detached loss, ``{"v_world": ..., "tex":
    ...}``)."""
    v_world, tex = params
    if not (v_world.requires_grad and tex.requires_grad):
        raise ValueError(f"{fn}: v_world and tex must require gradients")
    with tracing.span("forward"):
        img = render()
        if img_gt.shape != img.shape:
            raise ValueError(f"{fn}: img_gt has shape {tuple(img_gt.shape)}, expected {tuple(img.shape)}")
        loss = ((img - img_gt) ** 2).mean()
        tracing.mark(stage_times, "loss")
    with tracing.span("backward"):
        grads = torch.autograd.grad(loss, [v_world, tex])
    tracing.mark(stage_times, "transform_bwd")
    for p, g in zip((v_world, tex), grads):
        p.grad = g
    with tracing.span("adam"):
        optimizer.step()
    tracing.mark(stage_times, "adam")
    return loss.detach(), {"v_world": grads[0], "tex": grads[1]}


def inverse8_step(
    params: tuple[torch.Tensor, torch.Tensor],
    optimizer: torch.optim.Optimizer,
    vi: torch.Tensor,
    vt: torch.Tensor,
    cams: dict,
    img_gt: torch.Tensor,
    h: int,
    w: int,
    device: str | torch.device = "cuda",
    impl: str = "auto",
    stage_times: list | None = None,
    index_img: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One training step of ``bench.py:bench_inverse8``: render every view
    (:func:`render_multiview`), take ``mean((img - img_gt)**2)``, run one
    backward to the world vertices and the texture, and update them with
    ``optimizer`` (``torch.optim.Adam(params, lr=1e-3)`` is the
    counterpart of the bench's ``optax.adam(1e-3)``).

    Args:
        params: ``(v_world [1, V, 3], tex [1, C, Ht, Wt])``, tensors that
            require gradients; updated in place by ``optimizer``.
        optimizer: an optimizer over ``params``.
        vi, vt, cams, h, w, device, impl, index_img: as for
            :func:`render_multiview`.
        img_gt: [views, C + 1, H, W] target image.
        stage_times: as for :func:`render_multiview`, with "loss" after the
            loss, the backward's marks, "transform_bwd" when the gradients
            are ready and "adam" after the update: :data:`INVERSE8_STAGES`.

    Returns:
        (loss, grads): the detached scalar loss before the update, and the
        gradients ``{"v_world": ..., "tex": ...}`` it applied.
    """
    v_world, tex = params
    return _fit_views("inverse8_step", lambda: render_multiview(
        v_world, vi, vt, tex, cams, h, w, device=device, impl=impl, stage_times=stage_times, index_img=index_img
    )[0], params, optimizer, img_gt, stage_times)


def mipviews_step(
    params: tuple[torch.Tensor, torch.Tensor],
    optimizer: torch.optim.Optimizer,
    vi: torch.Tensor,
    vt: torch.Tensor,
    cams: dict,
    img_gt: torch.Tensor,
    h: int,
    w: int,
    n_levels: int,
    device: str | torch.device = "cuda",
    impl: str = "auto",
    stage_times: list | None = None,
    index_img: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One training step of the mipmapped multi-view fit: the pyramid of
    ``tex`` rebuilt (:func:`mip_pyramid`, ``n_levels`` levels), every view
    rendered by :func:`render_mipmap_multiview`, then the loss, backward
    and update of :func:`inverse8_step`: one texture is fitted, and the
    gradient of every level reaches it.

    Args:
        params: ``(v_world [1, V, 3], tex [1, C, T, T])``, tensors that
            require gradients; updated in place by ``optimizer``.
        optimizer, vi, vt, cams, img_gt, h, w, device, impl, index_img: as
            for :func:`inverse8_step` (pinhole or Fisheye62 cameras, as
            for :func:`render_mipmap_multiview`).
        n_levels: the pyramid's levels (T divisible by ``2**(n_levels -
            1)``; at most 11).
        stage_times: as for :func:`inverse8_step`, with "uv_derivative":
            :data:`MIPVIEWS_STAGES` (the pyramid is built before the first
            mark, and its backward ends before "transform_bwd").

    Returns:
        (loss, grads): as for :func:`inverse8_step`.
    """
    v_world, tex = params
    return _fit_views("mipviews_step", lambda: render_mipmap_multiview(
        v_world, vi, vt, mip_pyramid(tex, n_levels), cams, h, w, device=device, impl=impl, index_img=index_img,
        stage_times=stage_times,
    )[0], params, optimizer, img_gt, stage_times)


def avatar4k_band(v, vi, vt, levels, y0: int, hb: int, h: int, impl: str = "auto", index_img=None):
    """One row band of ``bench.bench_avatar4k``'s frame (``bench.py:
    404-425``): rows ``[y0, y0 + hb)`` of the ``h x h`` frame rasterized,
    rendered and the uvs interpolated as a viewport, the screen-space uv
    Jacobian by finite differences of the detached uv image (the last
    column's and row's differences zero, as ``jnp.pad`` pads), and
    ``mipmap_grid_sample`` of the pyramid (bilinear, border, max_aniso 2,
    clip_grad). With ``index_img`` [N, h, h], its rows stand in for the
    rasterized ones. Returns (rgb * mask [N, 3, hb, h], mask [N, 1, hb, h],
    bary [N, 3, hb, h], index [N, hb, h])."""
    w = h
    if index_img is None:
        idx = rasterize(v, vi, hb, w, impl=impl, y_offset=y0, full_height=h)
    else:
        idx = index_img[:, y0 : y0 + hb]
    _, bary = render(v, vi, idx, impl=impl, y_offset=y0)
    vt_img = interpolate(vt, vi, idx, bary, impl=impl, y_offset=y0, full_height=h)
    uv = vt_img.movedim(1, -1) * 2.0 - 1.0  # [N, hb, W, 2]
    uv_sg = uv.detach()
    dx = F.pad(uv_sg[:, :, 1:] - uv_sg[:, :, :-1], (0, 0, 0, 1))
    dy = F.pad(uv_sg[:, 1:] - uv_sg[:, :-1], (0, 0, 0, 0, 0, 1))
    vt_dxdy = torch.stack([dx, dy], dim=-2) * 0.5  # to 0..1 uv units
    rgb = mipmap_grid_sample(
        levels, uv, vt_dxdy, max_aniso=2, mode="bilinear", padding_mode="border", clip_grad=True, impl=impl
    )
    maskf = (idx != -1)[:, None].to(torch.float32)
    return rgb * maskf, maskf, bary, idx


def avatar4k_loss(params, vi, vt, ray_o, ray_d, h: int, n_bands: int = 4, remat: bool = True, device="cuda",
                  impl: str = "auto", index_img: torch.Tensor | None = None,
                  stage_times: list | None = None) -> torch.Tensor:
    """The loss of ``bench.bench_avatar4k`` (``bench.py:401-432``), op for op.

    Args:
        params: ``(v [1, V, 3], levels, msi_tex [L, 4, Hm, Wm])``: the
            pixel-space vertices, the mip pyramid (a list of [1, 3, s, s]),
            the MSI texture.
        vi: [F, 3] int32 faces; vt: [1, V, 2] uvs in [0, 1].
        ray_o, ray_d: [bh*bh, 3] rays of the square MSI background.
        h: the frame is h x h, rendered in ``n_bands`` bands of
            :func:`avatar4k_band` through
            :func:`~drtk_tpu_torch.parallel.banded.map_row_bands` (each
            recomputed in the backward when ``remat``), then
            :func:`~drtk_tpu_torch.parallel.banded.edge_grad_estimator_banded`.
            The background, ``msi(..., sub_step_count=2)``, is upsampled
            bilinearly to h x h (``F.interpolate``, ``align_corners=False``,
            for ``jax.image.resize``) and fills the pixels no triangle
            covers.
        device, impl: as for :func:`render_textured`.
        index_img: optional [N, h, h] int32 index image to use instead of
            rasterizing, so that two implementations can be compared on the
            same discrete structure.
        stage_times: if a list is given (CUDA only), CUDA events are
            appended at the start and after the loss ("forward"); read them
            with :func:`stage_ms`.

    Returns:
        ``mean(img**2)``, a scalar.
    """
    v, levels, msi_tex = params
    _check_devices("avatar4k_loss", device, {"v": v, "vi": vi, "vt": vt, "msi_tex": msi_tex, "ray_o": ray_o,
                                             "ray_d": ray_d, "index_img": index_img,
                                             **{f"levels[{i}]": t for i, t in enumerate(levels)}})
    if index_img is not None and (tuple(index_img.shape) != (v.shape[0], h, h) or index_img.dtype != torch.int32):
        raise ValueError(f"avatar4k_loss: expected an int32 index_img of shape {(v.shape[0], h, h)}")
    if stage_times is not None and resolve_device(device).type != "cuda":
        raise ValueError("avatar4k_loss: stage_times needs a CUDA device")
    tracing.mark(stage_times, "start")
    bg_img = avatar4k_background(ray_o, ray_d, msi_tex, h)
    hb = h // n_bands
    fg, maskf, bary, idx = map_row_bands(lambda y0: avatar4k_band(v, vi, vt, levels, y0, hb, h, impl, index_img), h,
                                         n_bands, remat)
    fg = edge_grad_estimator_banded(v_pix=v, vi=vi, bary_img=bary, img=fg, index_img=idx, n_bands=n_bands,
                                    impl=impl)
    img = fg + bg_img * (1.0 - maskf)
    loss = (img**2).mean()
    tracing.mark(stage_times, "forward")
    return loss


def avatar4k_background(ray_o, ray_d, msi_tex, h: int) -> torch.Tensor:
    """The avatar4k step's background [1, 3, h, h]: ``msi(..., sub_step_count
    =2)`` on a square grid of rays, upsampled bilinearly (``F.interpolate``,
    ``align_corners=False``, for ``jax.image.resize``)."""
    bh = math.isqrt(ray_o.shape[0])
    if bh * bh != ray_o.shape[0]:
        raise ValueError(f"avatar4k_loss: expected a square grid of rays, got {ray_o.shape[0]}")
    with tracing.span("background") as sp:
        ray_o, ray_d, msi_tex = sp.grad_in(ray_o, ray_d, msi_tex)
        bg = msi(ray_o, ray_d, msi_tex, sub_step_count=2)
        bg_img = bg[:, :3].reshape(1, bh, bh, 3).movedim(-1, 1)
        return sp.grad_out(F.interpolate(bg_img, size=(h, h), mode="bilinear", align_corners=False, antialias=False))


# The avatar4k step's graph, and the module-level functions its loss
# resolves when it runs: a patched one (a fault planted by the benchmark)
# makes a new key, so a graph never replays code that has been replaced.
_AVATAR4K_GRAPH = StepGraph()
_AVATAR4K_CALLS = ("avatar4k_loss", "avatar4k_background", "avatar4k_band", "map_row_bands",
                   "edge_grad_estimator_banded", "rasterize", "render", "interpolate", "mipmap_grid_sample", "msi")


def _avatar4k_key(tensors, h: int, n_bands: int, remat: bool, device) -> StepKey:
    """The :class:`~drtk_tpu_torch.step_graph.StepKey` of an avatar4k step
    over ``tensors`` (the leaves, vi, vt, the rays and any index image)."""
    calls = globals()
    return StepKey(tensors, (h, n_bands, remat, device, *(calls[name] for name in _AVATAR4K_CALLS)))


def avatar4k_step(params: tuple[torch.Tensor, Sequence[torch.Tensor], torch.Tensor],
                  optimizer: torch.optim.Optimizer, vi: torch.Tensor, vt: torch.Tensor, ray_o: torch.Tensor,
                  ray_d: torch.Tensor, h: int, n_bands: int = 4, remat: bool = True,
                  device: str | torch.device = "cuda", impl: str = "auto", stage_times: list | None = None,
                  index_img: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """One training step of ``bench.bench_avatar4k`` (``bench.py:401-453``):
    :func:`avatar4k_loss`, one backward to the vertices, the mip levels and
    the MSI texture, and an update with ``optimizer``
    (``torch.optim.Adam(params, lr=1e-3)`` for the bench's
    ``optax.adam(1e-3)``).

    The loss and the backward replay as one CUDA graph when
    :func:`~drtk_tpu_torch.step_graph.eager_reason` allows (CUDA tensors,
    ``impl="auto"``, no ``stage_times``, no tracer, grad mode on): the first
    step with new tensors runs eagerly, the second captures, the later ones
    replay; the update stays eager.

    Args:
        params: ``(v, levels, msi_tex)`` as for :func:`avatar4k_loss`,
            tensors that require gradients, updated in place.
        optimizer: an optimizer over ``(v, *levels, msi_tex)``.
        vi, vt, ray_o, ray_d, h, n_bands, remat, device, impl, index_img:
            as for :func:`avatar4k_loss`.
        stage_times: as for :func:`avatar4k_loss`, with "backward" and
            "adam" added: :data:`AVATAR4K_STAGES`, once per step (the band
            recomputes mark nothing).

    Returns:
        (loss, grads): the detached loss before the update, and the
        gradients ``{"v": ..., "levels": [...], "msi_tex": ...}`` it applied
        (new tensors every step, graphed or not).
    """
    v, levels, msi_tex = params
    leaves = [v, *levels, msi_tex]
    if not all(t.requires_grad for t in leaves):
        raise ValueError("avatar4k_step: v, the levels and msi_tex must require gradients")

    def loss_and_grads():
        with tracing.span("forward"):
            loss = avatar4k_loss(params, vi, vt, ray_o, ray_d, h, n_bands, remat, device, impl, index_img,
                                 stage_times)
        with tracing.span("backward"):
            grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), *grads)

    inputs = [*leaves, vi, vt, ray_o, ray_d, *([] if index_img is None else [index_img])]
    key = None if eager_reason(inputs, impl, stage_times) else _avatar4k_key(inputs, h, n_bands, remat, device)
    loss, *grads = _AVATAR4K_GRAPH.run(loss_and_grads, key)
    tracing.mark(stage_times, "backward")
    for p, g in zip(leaves, grads):
        p.grad = g
    with tracing.span("adam"):
        optimizer.step()
    tracing.mark(stage_times, "adam")
    return loss, {"v": grads[0], "levels": grads[1:-1], "msi_tex": grads[-1]}


def stage_ms(stage_times: list) -> dict[str, float]:
    """Milliseconds between consecutive marks of ``stage_times`` (waits for
    the last event)."""
    stage_times[-1][1].synchronize()
    return {
        name: start.elapsed_time(end)
        for (_, start), (name, end) in zip(stage_times[:-1], stage_times[1:])
    }
