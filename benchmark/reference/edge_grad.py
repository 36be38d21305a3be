"""The edge-gradient estimator of the reference, in float64.

Frozen copy of ``drtk_tpu_torch/ops/edge_grad_ref.py``, the port's
independent oracle of DRTK's shipped backward: coverage, classification and
dp_dr written out, per-corner element gathers, and the pixel-to-vertex step
as torch autograd of the barycentric gather expression. The forward is the
identity on ``img``; the backward gives ``v_pix`` the discontinuity
gradient over the whole frame.
"""

from __future__ import annotations

import torch

from reference.raster import broadcast_vi

_F64 = torch.float64


def _eps(x, eps=1e-8):
    return torch.where(x < 0, torch.clamp(x, max=-eps), torch.clamp(x, min=eps))


def _normalize(x):
    n = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / torch.where(n == 0, torch.ones_like(n), n)


def _gather_img(table, vi, index_img):
    """[N, V, C] -> [N, H, W, 3, C], the corners of each pixel's face."""
    n = table.shape[0]
    bidx = torch.arange(n, device=table.device)[:, None, None]
    vi_img = vi.long()[bidx, index_img.long().clamp(min=0)]
    return table[bidx[..., None], vi_img]


def _covered(pts2, px, py):
    p0, p1, p2 = pts2[..., 0, :], pts2[..., 1, :], pts2[..., 2, :]
    e01, e02, e12 = p1 - p0, p2 - p0, p2 - p1
    den = e01[..., 0] * e02[..., 1] - e01[..., 1] * e02[..., 0]
    s = torch.sign(den)
    w0 = ((py - p1[..., 1]) * e12[..., 0] - (px - p1[..., 0]) * e12[..., 1]) * s
    w1 = ((px - p0[..., 0]) * e02[..., 1] - (py - p0[..., 1]) * e02[..., 0]) * s
    w2 = ((py - p0[..., 1]) * e01[..., 0] - (px - p0[..., 0]) * e01[..., 1]) * s

    def top_left(e, flip):
        a = (e[..., 1] < 0) | ((e[..., 1] == 0) & (e[..., 0] > 0))
        b = (e[..., 1] > 0) | ((e[..., 1] == 0) & (e[..., 0] < 0))
        if flip:
            a, b = b, a
        return torch.where(den > 0, a, b)

    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    reject = (((w0 == 0) & ~top_left(e12, False)) | ((w1 == 0) & ~top_left(e02, True))
              | ((w2 == 0) & ~top_left(e01, False)))
    return inside & ~reject & (den != 0)


def _dp_dr(n_var, n_fix, max_dp_dr):
    n_var = _normalize(n_var)
    n_fix = _normalize(n_fix)
    bx, by = -n_fix[..., 1], n_fix[..., 0]
    d = bx * n_var[..., 0] + by * n_var[..., 1]
    if max_dp_dr > 0:
        sgn = torch.where(d >= 0, torch.ones_like(d), -torch.ones_like(d))
        d = sgn * torch.maximum(d.abs(), bx.abs() / max_dp_dr)
    return (bx / _eps(d))[..., None] * n_var


def image_grad(v_pix, vi, img, index_img, grad_output, max_dp_dr=1e4, y_offset=0):
    """The gradient with respect to each pixel's interpolated position,
    [N, 3, H, W] float64: DRTK's backward kernel over the rows given. The
    stencil centres are the rows but the last, whose pixels serve as the
    down neighbours; ``y_offset`` is the first row's place in the frame."""
    img = img.to(_F64)
    g = grad_output.to(_F64)
    vi = broadcast_vi(vi, v_pix.shape[0])
    n, _, h, w = img.shape
    sh, sw = h - 1, w - 1
    dev = img.device
    ci, ri, di = index_img[:, :sh, :sw], index_img[:, :sh, 1:], index_img[:, 1:, :sw]
    c_ok, r_ok, d_ok = ci >= 0, ri >= 0, di >= 0
    lr, ud = ci != ri, ci != di
    pts = _gather_img(v_pix.detach().to(_F64), vi, index_img)
    pts = torch.where((index_img >= 0)[..., None, None], pts, torch.zeros((), dtype=_F64, device=dev))
    nrm = _normalize(torch.linalg.cross(pts[..., 0, :] - pts[..., 2, :], pts[..., 1, :] - pts[..., 0, :], dim=-1))
    pts_c, nrm_c = pts[:, :sh, :sw], nrm[:, :sh, :sw]
    pts_r, nrm_r = pts[:, :sh, 1:], nrm[:, :sh, 1:]
    pts_d, nrm_d = pts[:, 1:, :sw], nrm[:, 1:, :sw]
    ys = torch.arange(y_offset, y_offset + sh, dtype=_F64, device=dev)[None, :, None]
    xs = torch.arange(sw, dtype=_F64, device=dev)[None, None, :]
    c_in_r = lr & c_ok & r_ok & _covered(pts_r[..., :2], xs, ys)
    r_in_c = lr & c_ok & r_ok & _covered(pts_c[..., :2], xs + 1, ys)
    c_in_d = ud & c_ok & d_ok & _covered(pts_d[..., :2], xs, ys)
    d_in_c = ud & c_ok & d_ok & _covered(pts_c[..., :2], xs, ys + 1)
    h_int, v_int = c_in_r & r_in_c, c_in_d & d_in_c
    h_adj = lr & c_ok & r_ok & ~c_in_r & ~r_in_c
    v_adj = ud & c_ok & d_ok & ~c_in_d & ~d_in_c
    gx = ((img[:, :, :sh, 1:] - img[:, :, :sh, :sw]) * 0.5 * (g[:, :, :sh, 1:] + g[:, :, :sh, :sw])).sum(1) * lr
    gy = ((img[:, :, 1:, :sw] - img[:, :, :sh, :sw]) * 0.5 * (g[:, :, 1:, :sw] + g[:, :, :sh, :sw])).sum(1) * ud
    zero = torch.zeros_like(gx)
    keep_c = ~h_int & ~(~c_ok | (r_in_c & ~c_in_r) | h_adj)
    keep_r = ~h_int & ~(~r_ok | (c_in_r & ~r_in_c) | h_adj)
    gc_x, gr_x = torch.where(keep_c, gx, zero), torch.where(keep_r, gx, zero)
    xz = [0, 2]
    dp = _dp_dr(nrm_c[..., xz], nrm_r[..., xz], max_dp_dr)
    gc_x = gc_x + torch.where(h_int, gx * dp[..., 0], zero)
    gc_z = torch.where(h_int, gx * dp[..., 1], zero)
    dp = _dp_dr(nrm_r[..., xz], nrm_c[..., xz], max_dp_dr)
    gr_x = gr_x + torch.where(h_int, gx * dp[..., 0], zero)
    gr_z = torch.where(h_int, gx * dp[..., 1], zero)
    keep_c = ~v_int & ~(~c_ok | (d_in_c & ~c_in_d) | v_adj)
    keep_d = ~v_int & ~(~d_ok | (c_in_d & ~d_in_c) | v_adj)
    gc_y, gd_y = torch.where(keep_c, gy, zero), torch.where(keep_d, gy, zero)
    yz = [1, 2]
    dp = _dp_dr(nrm_c[..., yz], nrm_d[..., yz], max_dp_dr)
    gc_y = gc_y + torch.where(v_int, gy * dp[..., 0], zero)
    gc_z = gc_z + torch.where(v_int, gy * dp[..., 1], zero)
    dp = _dp_dr(nrm_d[..., yz], nrm_c[..., yz], max_dp_dr)
    gd_y = gd_y + torch.where(v_int, gy * dp[..., 0], zero)
    gd_z = torch.where(v_int, gy * dp[..., 1], zero)
    out = torch.zeros((n, h, w, 3), dtype=_F64, device=dev)
    out[:, :sh, :sw] -= torch.stack([gc_x, gc_y, gc_z], dim=-1)
    out[:, :sh, 1:] -= torch.stack([gr_x, zero, gr_z], dim=-1)
    out[:, 1:, :sw] -= torch.stack([zero, gd_y, gd_z], dim=-1)
    return out.movedim(-1, 1) * (index_img >= 0)[:, None]


class _Core(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_pix, vi, bary_img, img, index_img, probe):
        ctx.save_for_backward(v_pix, vi, bary_img, img, index_img)
        ctx.probe = probe
        return img.view_as(img)

    @staticmethod
    def backward(ctx, grad_output):
        v_pix, vi, bary_img, img, index_img = ctx.saved_tensors
        if ctx.probe is not None:
            ctx.probe.update(v_pix=v_pix.detach(), vi=vi, img=img.detach(), index=index_img,
                             cotangent=grad_output.detach(), bary=bary_img)
        g_img = image_grad(v_pix, vi, img, index_img, grad_output)
        bary = bary_img.movedim(1, -1).to(_F64)
        with torch.enable_grad():
            vp = v_pix.detach().to(_F64).requires_grad_()
            v_pix_img = (_gather_img(vp, vi, index_img) * bary[..., None]).sum(-2).movedim(-1, 1)
            (grad_v_pix,) = torch.autograd.grad(v_pix_img, vp, g_img)
        return grad_v_pix.to(v_pix.dtype), None, None, grad_output, None, None


def edge_grad_estimator(v_pix, vi, bary_img, img, index_img, probe: dict | None = None):
    """The identity on ``img`` whose backward adds DRTK's discontinuity
    gradient (max_dp_dr 1e4) to ``v_pix``; ``probe``, if a dict, receives
    the backward's inputs (for the bound arithmetic)."""
    vi = broadcast_vi(vi, v_pix.shape[0])
    return _Core.apply(v_pix, vi, bary_img.detach(), img, index_img, probe)
