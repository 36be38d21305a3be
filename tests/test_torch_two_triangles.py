"""The reference's two-triangles inverse-rendering fits through
drtk_tpu_torch (CPU): tests/test_two_triangles.py with the same scenes,
step counts and assertions, ``torch.optim.Adam`` in place of
``optax.adam``. The whole differentiable pipeline runs, edge_grad_estimator
included: rasterize, render, interpolate, ``grid_sample`` of the raw 0..1
uvs (border), the mask, the edge gradients.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import drtk_tpu_torch as tt  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401
from tests.utils import two_triangles_scene  # noqa: E402


def _scene(h, w):
    return [torch.from_numpy(np.array(a)) for a in two_triangles_scene(h=h, w=w)]


def build_forward(vi, vt, tex, h, w):
    def forward(v):
        index_img = tt.rasterize(v, vi, h, w)
        _, bary_img = tt.render(v, vi, index_img)
        uv = tt.interpolate(vt, vi, index_img, bary_img).movedim(1, -1)
        img = tt.grid_sample(tex, uv, padding_mode="border", align_corners=False)
        img = img * (index_img != -1)[:, None]
        return tt.edge_grad_estimator(v_pix=v, vi=vi, bary_img=bary_img, img=img, index_img=index_img)

    return forward


def _fit(forward, img_gt, v0, lr, steps, keep):
    """Adam on ``mean((forward(v) - img_gt)**2)``, the gradient zeroed but
    for the coordinates in ``keep``; returns (v, first loss, last loss)."""
    v = v0.clone().requires_grad_()
    opt = torch.optim.Adam([v], lr=lr)
    mask = torch.zeros(3)
    mask[list(keep)] = 1.0
    losses = []
    for _ in range(steps):
        loss = ((forward(v) - img_gt) ** 2).mean()
        (g,) = torch.autograd.grad(loss, v)
        v.grad = g * mask
        opt.step()
        losses.append(float(loss))
    return v.detach(), losses[0], losses[-1]


def test_two_triangles_fit_xy():
    h = w = 128
    v_gt, vi, vt = _scene(h, w)
    tex = torch.ones((1, 3, 16, 16))
    tex[:, :, :, 8:] = 0.5
    forward = build_forward(vi, vt, tex, h, w)
    with torch.no_grad():
        img_gt = forward(v_gt)
    rng = np.random.RandomState(10)
    noise = rng.randn(*v_gt.shape).astype(np.float32) * 5.0
    noise[..., 2] = 0.0
    v0 = v_gt + torch.from_numpy(noise)

    v, loss0, loss = _fit(forward, img_gt, v0, 1e-1, 300, keep=(0, 1))  # xy only
    err0 = float((v0 - v_gt)[..., :2].abs().max())
    err1 = float((v - v_gt)[..., :2].abs().max())
    assert loss < loss0 / 5.0, f"loss did not decrease: {loss0:.3e} -> {loss:.3e}"
    assert err1 < err0 / 2.0, f"vertices did not converge: {err0} -> {err1}"
    assert torch.equal(v[..., 2], v0[..., 2])


def test_edge_grad_moves_silhouette():
    """With a constant white texture only the edge gradients move the
    vertices: the gradient is non-zero and a 2-pixel step along it lowers
    the loss."""
    h = w = 96
    v_gt, vi, vt = _scene(h, w)
    forward = build_forward(vi, vt, torch.ones((1, 3, 4, 4)), h, w)
    with torch.no_grad():
        img_gt = forward(v_gt)
    v0 = (v_gt + torch.tensor([[3.0, -2.0, 0.0]])).requires_grad_()
    loss = ((forward(v0) - img_gt) ** 2).mean()
    (g,) = torch.autograd.grad(loss, v0)
    assert float(g.norm()) > 0.0, "edge gradients are zero"
    with torch.no_grad():
        v1 = v0 - g / g.norm() * 2.0
        loss1 = ((forward(v1) - img_gt) ** 2).mean()
    assert float(loss1) < float(loss), "gradient step increased the loss"


def test_intersection_fit_z_only():
    """Interpenetrating triangles: depth gradients from edge_grad's
    intersection branch move the visibility boundary; convergence is the
    agreement of the index images (where each triangle wins the z-test)."""
    h = w = 96
    v_gt = torch.tensor([[[8, 15, 100], [88, 15, 100], [48, 88, 100], [8, 75, 60], [88, 75, 140], [48, 12, 100]]],
                        dtype=torch.float32)
    vi = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    vt = torch.zeros((1, 6, 2))
    vt[:, 3:, 0] = 1.0
    tex = torch.ones((1, 3, 8, 8))
    tex[:, :, :, 4:] = 0.25
    forward = build_forward(vi, vt, tex, h, w)
    with torch.no_grad():
        img_gt = forward(v_gt)
    v0 = v_gt.clone()
    v0[0, 3:, 2] += torch.tensor([12.0, -10.0, 8.0])
    idx_gt = tt.rasterize(v_gt, vi, h, w)

    def agreement(v):
        idx = tt.rasterize(v, vi, h, w)
        return float(((idx == idx_gt) & (idx_gt >= 0)).sum() / max(int((idx_gt >= 0).sum()), 1))

    agree0 = agreement(v0)
    v, _, _ = _fit(forward, img_gt, v0, 5e-1, 400, keep=(2,))  # z only
    agree1 = agreement(v)
    assert agree1 > agree0 + 0.05, f"z-only fit did not improve index agreement: {agree0:.3f} -> {agree1:.3f}"
    assert agree1 > 0.97, f"final agreement only {agree1:.3f}"
