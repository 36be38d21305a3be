"""Multi-Sphere Image (MSI) ray marcher (counterpart of
``drtk_tpu/ops/msi.py``).

One ray per row; concentric spheres with radius interpolated linearly in
1/r between ``min_inv_r`` (nearest) and ``max_inv_r`` (farthest);
``L * sub_step_count`` steps front to back. A step's sphere hit becomes an
equirectangular (u, v) and a layer coordinate w, sampled bilinearly within
a layer and with cubic (A = -0.75) weights across layers, border-clamped.
Transmittance composites in log space, and a ray stops at the first step
whose transmittance falls below ``stop_thresh``; its log-transmittance is
then -1e3.

As in the JAX package, the march is a prefix scan over all steps at once:
``exp(-cumsum)`` gives the transmittance, and the prefix is exact up to and
including the first step that crosses the threshold, so masking every later
step reproduces the sequential loop with its early exit. The texture's four
spatial taps per layer come from one row of a quad table (the texture
beside its x-, y- and xy-shifted copies). This work is plain XLA in the
JAX package, and plain PyTorch here. Gradients reach the texture only; the
rays are detached.
"""

from __future__ import annotations

import torch

from drtk_tpu_torch.ops.grid_sample import _cubic_weights, _quad_table
from drtk_tpu_torch.ops.math import autocast_f32

__all__ = ["msi"]


def _sample_bilinear_cubic(texture: torch.Tensor, u, v, w) -> torch.Tensor:
    """Bilinear in (u, v), cubic in w, sampling of an [L, C, H, W] texture
    at normalized coordinates in [-1, 1], border-clamped. u, v, w: [R];
    returns [R, C]."""
    l_cnt, c_cnt, h, w_size = texture.shape

    def unnorm_clip(coord, size):
        return torch.clamp(((coord + 1.0) * size - 1.0) / 2.0, 0.0, size - 1.0)

    x = unnorm_clip(u, w_size)
    y = unnorm_clip(v, h)
    z = unnorm_clip(w, l_cnt)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    z0 = torch.floor(z)
    tx = x - x0
    ty = y - y0
    tz = z - z0
    ix = x0.to(torch.int64)
    iy = y0.to(torch.int64)
    iz = z0.to(torch.int64)

    quad = _quad_table(texture.movedim(1, -1)).reshape(l_cnt * h * w_size, 4 * c_cnt)

    wts = torch.stack([(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty], dim=-1)  # [R, 4]
    cz = _cubic_weights(tz)
    out = torch.zeros((u.shape[0], c_cnt), dtype=u.dtype, device=u.device)
    base = iy * w_size + ix
    for i in range(4):
        lz = torch.clamp(iz - 1 + i, 0, l_cnt - 1)
        rows = quad[lz * (h * w_size) + base].reshape(-1, 4, c_cnt)
        plane = (rows * wts.to(rows.dtype)[..., None]).sum(1)
        out = out + plane * cz[i][:, None]
    return out


def _msi_impl(ray_o, ray_d, texture, sub_step_count: int, min_inv_r: float, max_inv_r: float,
              stop_thresh: float) -> torch.Tensor:
    """``drtk_tpu/ops/msi.py:117-179``."""
    n_layers = texture.shape[0]
    n_steps = n_layers * sub_step_count
    dt = texture.dtype

    r_o = ray_o.to(dt)
    r_d = ray_d.to(dt)
    r_d = r_d / torch.linalg.vector_norm(r_d, dim=-1, keepdim=True)

    tc = (-r_o * r_d).sum(-1)  # [R]
    h2 = (r_o * r_o).sum(-1) - tc * tc

    step_size = 1.0 / n_steps
    i_arr = torch.arange(n_steps, device=texture.device).to(dt)
    a_arr = ((n_steps - 1 - i_arr) + 0.5) / n_steps  # near -> far, [S]

    # ---- every step's geometry at once: [R, S] -------------------------------
    inv_r = (1.0 - a_arr) * max_inv_r + a_arr * min_inv_r
    r = 1.0 / inv_r
    det = (r * r)[None, :] - h2[:, None]
    hit = det >= 0.0
    t = tc[:, None] + torch.sqrt(torch.clamp(det, min=0.0))
    pos = r_o[:, None, :] + t[..., None] * r_d[:, None, :]  # [R, S, 3]

    lon = torch.atan2(pos[..., 2], pos[..., 0])
    lat = torch.atan2(pos[..., 1], torch.hypot(pos[..., 0], pos[..., 2]))
    u = lon / torch.pi
    v = 2.0 * lat / torch.pi
    w = (1.0 - 2.0 * a_arr)[None, :].expand(u.shape)

    num_rays = ray_o.shape[0]
    sample = _sample_bilinear_cubic(texture, u.reshape(-1), v.reshape(-1), w.reshape(-1)).reshape(
        num_rays, n_steps, 4
    )
    rgb = sample[..., :3]
    alpha = sample[..., 3]

    # ---- prefix-scan compositing ---------------------------------------------
    act = hit & (alpha > 0.0)
    zero = torch.zeros((), dtype=dt, device=texture.device)
    pcnt = torch.where(act, alpha * step_size, zero)  # [R, S]
    incl = torch.cumsum(pcnt, dim=1)  # -log T after step i
    excl = incl - pcnt  # -log T before step i

    # Early termination: the first step whose transmittance after it falls
    # below stop_thresh; the prefix is exact up to and including it.
    stop_flag = act & (torch.exp(-incl) < stop_thresh)
    any_stop = stop_flag.any(dim=1)  # [R]
    first_stop = torch.argmax(stop_flag.to(torch.uint8), dim=1)  # the first True; 0 when none
    first_stop = torch.where(any_stop, first_stop, n_steps - 1)

    contrib_mask = act & (torch.arange(n_steps, device=texture.device)[None, :] <= first_stop[:, None])
    weight = torch.exp(-excl) * (1.0 - torch.exp(-pcnt))
    out_v = torch.where(contrib_mask[..., None], weight[..., None] * torch.maximum(rgb, zero), zero).sum(1)

    final_log_t = -torch.gather(incl, 1, first_stop[:, None])[:, 0]
    log_t = torch.where(any_stop, torch.full_like(final_log_t, -1e3), final_log_t)
    return torch.cat([out_v, log_t[:, None]], dim=-1)


def msi(
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    texture: torch.Tensor,
    sub_step_count: int = 2,
    min_inv_r: float = 1.0,
    max_inv_r: float = 0.0,
    stop_thresh: float = 1e-7,
) -> torch.Tensor:
    """Render a Multi-Sphere Image.

    Args:
        ray_o: [N, 3] ray origins.
        ray_d: [N, 3] ray directions (normalized here).
        texture: [L, 4, H, W] MSI texture: rgb and sigma (negative log
            alpha) channels, equirectangular.
        sub_step_count: steps per layer (steps = L * sub_step_count).
        min_inv_r: inverse of the smallest sphere's radius (1: unit sphere).
        max_inv_r: inverse of the largest radius (0: infinity).
        stop_thresh: the transmittance at which a ray stops.

    Returns:
        [N, 4]: rgb, then the log-transmittance. Gradients flow to
        ``texture`` only. f16/bf16 inputs compute in float32.
    """
    ray_o = autocast_f32(ray_o)
    ray_d = autocast_f32(ray_d)
    texture = autocast_f32(texture)
    if ray_o.ndim != 2 or ray_o.shape[-1] != 3:
        raise ValueError(f"msi: expected ray_o [N, 3], got {tuple(ray_o.shape)}")
    if ray_d.shape != ray_o.shape:
        raise ValueError(f"msi: ray_d shape {tuple(ray_d.shape)} must match ray_o {tuple(ray_o.shape)}")
    if texture.ndim != 4 or texture.shape[1] != 4:
        raise ValueError(f"msi: expected texture [L, 4, H, W], got {tuple(texture.shape)}")
    if sub_step_count < 1:
        raise ValueError("msi: sub_step_count must be >= 1")
    return _msi_impl(
        ray_o.detach(), ray_d.detach(), texture, int(sub_step_count), float(min_inv_r), float(max_inv_r),
        float(stop_thresh),
    )
