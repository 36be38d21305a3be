"""The mipmapped multi-view fitting step through a Fisheye62 lens
(``pipeline.mipviews_step`` with lens cameras) against the benchmark's
plain reference of it (``benchmark/reference/fisheye62.py``: plain
PyTorch, the uv Jacobian by ``torch.func.jvp`` of its own projection, no
port and no JAX) on the CPU, at 2 views of 64x64, a 9x9-vertex world grid
(128 triangles) and a 3x32x32 texture in 4 levels, on seeded scenes framed
as the benchmark's ``fisheye62`` configuration frames its own: the grid at
depth ~1.3, focal 1.0 x the canvas, the repo's Fisheye62 lens moved by the
seed, ``fov`` estimated once.

Both sides take the reference's index image (the port's and the
reference's float32 projections may round a vertex differently). In
float64 the loss and the first gradients to the world vertices and the
texture agree within 1e-10 of their largest magnitude: the two sides
differ in the order of their sums and in how they differentiate the lens
(by hand against autograd). In float32 the loss within 1e-5 relative (a
mean of 32 K values: float32 rounding, and a pixel's tap count or level, a
floor of the Jacobian's norms, moved across a step by one rounding) and the
gradients within 1e-4 of their largest magnitude (as the inverse8 and
mipviews steps are held). The reference computed in bfloat16, and the
lens-projected views shaded with the pinhole Jacobian, fail them.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from drtk_tpu_torch import pipeline, tracing
from drtk_tpu_torch.pipeline import MIPVIEWS_STAGES, mipviews_step
from drtk_tpu_torch.scenes import inverse8_lens_arrays, inverse8_scene_arrays
from drtk_tpu_torch.screen_space_uv_derivative import screen_space_uv_derivative
from drtk_tpu_torch.utils.projection import estimate_fisheye62_fov
from tests.test_torch_kernels import _one_torch_thread  # noqa: F401

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import bfloat16, exact  # noqa: E402
from reference import fisheye62 as ref  # noqa: E402
from reference.raster import rasterize as ref_rasterize  # noqa: E402
from reference.shade import render as ref_render  # noqa: E402

H = W = 64
GN, VIEWS, TEX, LEVELS = 9, 2, 32, 4
CFG = {"height": H, "width": W, "levels": LEVELS, "max_aniso": 4}
CAMS = ("campos", "camrot", "focal", "princpt")
SEEDS = [0, 1, 2**31 + 11]
DEPTH, OFFSET = 1.3, 0.0065


def _scene(seed, dtype):
    """The scene as tensors of ``dtype``: inverse8's grid at depth ~1.3
    (its z scaled by 1.3 / 4), focal 64 px, the lenses; its target (the
    reference's views of the true mesh and texture) and the fit's start:
    vertices moved by 0.0065, a grey texture."""
    a = inverse8_scene_arrays(H, GN, VIEWS, seed=seed % 2**32, tex_size=TEX)
    a["v_world"] = a["v_world"] * np.array([1, 1, DEPTH / 4.0], np.float32)
    a["focal"] = np.tile(np.diag([float(H), float(H)]).astype(np.float32), (VIEWS, 1, 1))
    a["distortion_coeff"] = inverse8_lens_arrays("fisheye62", VIEWS, seed=seed % 2**32)
    s = {k: torch.from_numpy(x).to(dtype) if x.dtype.kind == "f" else torch.from_numpy(x) for k, x in a.items()}
    s["img_gt"] = ref.prepare({**s, "v_gt": s["v_world"]}, CFG, "cpu")["img_gt"]
    s["v0"] = s["v_world"] + OFFSET
    s["tex0"] = torch.full_like(s["tex_gt"], 0.5)
    return s


def _cams(s):
    coeff = s["distortion_coeff"]
    return {**{k: s[k] for k in CAMS}, "distortion_mode": "fisheye62", "distortion_coeff": coeff,
            "fov": estimate_fisheye62_fov(coeff).to(coeff.dtype)}


def _ref_cams(s):
    fov = torch.from_numpy(ref.fisheye62_fov(s["distortion_coeff"].numpy())).to(s["focal"].dtype)
    return [s[k] for k in CAMS] + [s["distortion_coeff"], fov]


def _index(s):
    v_pix = ref.transform(s["v0"].expand(VIEWS, -1, -1), *_ref_cams(s))
    return ref_rasterize(v_pix, s["vi"], H, W)


def _reference(s, q=exact):
    leaves = {"v_world": s["v0"].clone().requires_grad_(), "tex": s["tex0"].clone().requires_grad_()}
    loss = ref.loss({**s, **leaves}, CFG, q)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _port(s):
    params = (s["v0"].clone().requires_grad_(), s["tex0"].clone().requires_grad_())
    return mipviews_step(params, torch.optim.Adam(params, lr=1e-3), s["vi"], s["vt"], _cams(s), s["img_gt"], H, W,
                         LEVELS, device="cpu", index_img=_index(s))


def _gaps(got, want):
    (loss, grads), (loss_w, grads_w) = got, want
    out = {"loss": abs(float(loss) - float(loss_w)) / abs(float(loss_w))}
    for k, g in grads_w.items():
        assert float(g.abs().max()) > 0, k
        out[k] = float((grads[k].double() - g.double()).abs().max() / g.double().abs().max())
    return out


def _fails_float32(gaps):
    return gaps["loss"] > 1e-5 or max(gaps["v_world"], gaps["tex"]) > 1e-4


@pytest.mark.parametrize("seed", SEEDS)
def test_step_matches_the_reference_in_float64(seed):
    s = _scene(seed, torch.float64)
    gaps = _gaps(_port(s), _reference(s))
    assert max(gaps.values()) <= 1e-10, gaps


@pytest.mark.parametrize("seed", SEEDS)
def test_step_matches_the_reference_in_float32(seed):
    s = _scene(seed, torch.float32)
    gaps = _gaps(_port(s), _reference(s))
    assert not _fails_float32(gaps), gaps


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_in_bfloat16_fails_a_tolerance(seed):
    s = _scene(seed, torch.float32)
    assert _fails_float32(_gaps(_reference(s, bfloat16), _reference(s)))


@pytest.mark.parametrize("seed", SEEDS)
def test_pinhole_jacobian_fails_a_tolerance(seed, monkeypatch):
    """The fault the benchmark plants: the views projected through the lens,
    shaded with the pinhole uv Jacobian (the lens left out of
    ``screen_space_uv_derivative``)."""
    orig = pipeline.screen_space_uv_derivative

    def pinhole(*args, impl="auto", fov=None):
        return orig(*args[:10], impl=impl)

    s = _scene(seed, torch.float32)
    want = _reference(s)
    monkeypatch.setattr(pipeline, "screen_space_uv_derivative", pinhole)
    assert _fails_float32(_gaps(_port(s), want))


@pytest.mark.parametrize("seed", SEEDS)
def test_uv_jacobian_matches_the_references_autograd(seed):
    """``screen_space_uv_derivative`` through the lens against the
    reference's ``torch.func.jvp`` of its projection, float64, every mask
    pixel."""
    s = _scene(seed, torch.float64)
    v = s["v0"].expand(VIEWS, -1, -1)
    idx = _index(s)
    bary = ref_render(ref.transform(v, *_ref_cams(s)), s["vi"], idx)
    want = ref.uv_jacobian(s["v0"], s["vt"], s["vi"], idx, bary, *_ref_cams(s))
    c = _cams(s)
    got = screen_space_uv_derivative(v, s["vt"].expand(VIEWS, -1, -1), s["vi"], s["vi"], idx, bary, idx != -1,
                                     c["campos"], c["camrot"], c["focal"], "fisheye62", c["distortion_coeff"],
                                     fov=c["fov"])
    assert float((idx >= 0).double().mean()) > 0.5
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())


def test_lens_step_marks_spans_and_counter():
    """The lens step sets mipviews' marks; its Fisheye62 product is the span
    ``lens_jvp`` inside ``uv_derivative``, and on this framing no mask
    pixel's product is cut by a clip (``lens_jvp_clipped`` reads 0)."""
    s = _scene(0, torch.float32)
    names = []

    def mark(sink, name, grad_of=None):
        if grad_of is None:
            names.append(name)
        elif grad_of.requires_grad:
            grad_of.register_hook(lambda _g: names.append(name))

    orig = pipeline.tracing.mark
    pipeline.tracing.mark = mark
    try:
        with tracing.Tracer() as tracer:
            _port(s)
    finally:
        pipeline.tracing.mark = orig
    snap = tracer.snapshot()
    spans = [(sp["name"], sp["parent"]) for sp in snap["spans"]]
    assert names == ["start", *MIPVIEWS_STAGES]
    by_name = {name: i for i, (name, _) in enumerate(spans)}
    assert spans[spans[by_name["lens_jvp"]][1]][0] == "uv_derivative"
    assert [name for name, _ in spans].count("lens_jvp") == 1
    assert snap["counts"]["lens_jvp_clipped"] == 0


def test_clipped_mask_pixels_are_counted():
    """A ``fov`` inside the mesh's reach: mask pixels whose surface point
    lies beyond it have their product cut, and the counter adds them."""
    s = _scene(1, torch.float64)
    v = s["v0"].expand(VIEWS, -1, -1)
    idx = _index(s)
    bary = ref_render(ref.transform(v, *_ref_cams(s)), s["vi"], idx)
    c = _cams(s)
    with tracing.Tracer() as tracer:
        screen_space_uv_derivative(v, s["vt"].expand(VIEWS, -1, -1), s["vi"], s["vi"], idx, bary, idx != -1,
                                   c["campos"], c["camrot"], c["focal"], "fisheye62", c["distortion_coeff"],
                                   fov=torch.full((VIEWS, 1), 0.5, dtype=torch.float64))
    clipped = tracer.snapshot()["counts"]["lens_jvp_clipped"]
    assert 0 < clipped < int((idx != -1).sum())
