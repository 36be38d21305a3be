"""The mipmapped fitting step through a Fisheye62 lens on the card
(``-m cuda``; this file imports no JAX, so it runs there with
``--noconftest``): ``mipviews_step`` at 8 views of 256^2 framed as the
benchmark's ``fisheye62`` configuration (the grid at depth ~1.3, focal 1.0
x the canvas, the repo's lens moved by the seed), a 3 x 512^2 texture in 8
levels, through the kernels (``impl="auto"``) against ``impl="plain"`` on
the kernel's index image: the loss within 1e-5 and the gradients within
1e-4 of their largest magnitude, as the pinhole mipmapped step is held in
``test_torch_kernels.py``. One step launches M1 once each way; with the
tracer on it records the lens's span inside the uv Jacobian's, M1's corner
adds, and no mask pixel whose lens product a clip cut."""

import numpy as np
import pytest
import torch

import drtk_tpu_torch as tt
from drtk_tpu_torch.pipeline import MIPVIEWS_STAGES, mip_pyramid, mipviews_step
from drtk_tpu_torch.scenes import inverse8_lens_arrays, inverse8_scene_arrays
from drtk_tpu_torch.utils.projection import estimate_fisheye62_fov
from tests.test_torch_kernels import NO_LAUNCHES, cuda_device  # noqa: F401

H, GN, VIEWS, TEX, LEVELS = 256, 41, 8, 512, 8


@pytest.mark.cuda
def test_fisheye62_step_kernels_match_plain(cuda_device):  # noqa: F811
    a = inverse8_scene_arrays(H, GN, VIEWS, tex_size=TEX)
    a["v_world"] = a["v_world"] * np.array([1, 1, 1.3 / 4.0], np.float32)
    a["focal"] = np.tile(np.diag([float(H), float(H)]).astype(np.float32), (VIEWS, 1, 1))
    s = {k: torch.from_numpy(x).to(cuda_device) for k, x in a.items()}
    coeff = torch.from_numpy(inverse8_lens_arrays("fisheye62", VIEWS)).to(cuda_device)
    cams = {**{k: s[k] for k in ("campos", "camrot", "focal", "princpt")}, "distortion_mode": "fisheye62",
            "distortion_coeff": coeff, "fov": estimate_fisheye62_fov(coeff)}
    with torch.no_grad():
        img_gt, _ = tt.render_mipmap_multiview(s["v_world"], s["vi"], s["vt"], mip_pyramid(s["tex_gt"], LEVELS), cams,
                                               H, H)

    def step(p, **kw):
        return mipviews_step(p, torch.optim.Adam(p, lr=1e-3), s["vi"], s["vt"], cams, img_gt, H, H, LEVELS, **kw)

    def params():
        return (s["v_world"] + 0.0065).requires_grad_(), torch.full_like(s["tex_gt"], 0.5).requires_grad_()

    marks = []
    step(params(), stage_times=marks)
    tt.reset_kernel_launch_counts()
    with tt.tracing.Tracer() as tracer:
        step(params())
    torch.cuda.synchronize()
    assert [name for name, _ in marks] == ["start", *MIPVIEWS_STAGES]
    assert tt.kernel_launch_counts() == {
        **NO_LAUNCHES, "B1 rasterize": 1, "B2 gather_rows": 4, "E1 edge_grad": 1, "M1 mipmap_sample": 2,
        "R1 render": 2,
    }
    snap = tracer.snapshot()
    spans = snap["spans"]
    lens = [sp for sp in spans if sp["name"] == "lens_jvp"]
    assert len(lens) == 1 and spans[lens[0]["parent"]]["name"] == "uv_derivative"
    assert lens[0]["device_end_ms"] > lens[0]["device_start_ms"]
    assert snap["counts"]["lens_jvp_clipped"] == 0
    assert snap["counts"]["M1 window_adds"] > 0 and "M1 fallback_adds" in snap["counts"]
    p_k, p_p = params(), params()
    idx = tt.rasterize(tt.transform(p_k[0].detach().expand(VIEWS, -1, -1), **cams), s["vi"], H, H)
    assert float((idx != -1).float().mean()) > 0.8
    loss, grads = step(p_k, index_img=idx)
    loss_p, grads_p = step(p_p, index_img=idx, impl="plain")
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    for name in ("v_world", "tex"):
        err = (grads[name] - grads_p[name]).abs().max()
        assert err <= 1e-4 * grads_p[name].abs().max(), name
