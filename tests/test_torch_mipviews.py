"""The mipmapped multi-view fitting step (``pipeline.mipviews_step``)
against the benchmark's plain reference of it
(``benchmark/reference/mipviews.py``, plain PyTorch, no port and no JAX)
on the CPU, at 2 views of 64x64, a 9x9-vertex world grid (128 triangles)
and a 3x32x32 texture in 4 levels, on seeded scenes.

Both sides take the reference's index image (the port's float64 rasterizer
and the reference's float32 one may resolve a depth tie differently). The
step in float64: loss and first-step gradients to the world vertices and
the texture within 1e-10 of their largest magnitude. The mipmapped
sampling's tap count and level are floors of the uv Jacobian's norms, so
one float32 rounding can move a pixel across a step (the reason
``test_torch_mipmap_views.py`` holds the mipmap path in float64); in
float32 the loss is held to 1e-5 relative and the gradients to 1e-4 of
their largest magnitude, the tolerances of the inverse8 step. The
reference computed in bfloat16 fails them.
"""

import sys
from pathlib import Path

import pytest
import torch

from drtk_tpu_torch import pipeline, tracing
from drtk_tpu_torch.pipeline import INVERSE8_STAGES, MIPVIEWS_STAGES, inverse8_step, mip_pyramid, mipviews_step
from drtk_tpu_torch.scenes import inverse8_scene_arrays
from drtk_tpu_torch.screen_space_uv_derivative import screen_space_uv_derivative

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import bfloat16, exact  # noqa: E402
from reference import mipviews as ref  # noqa: E402
from reference.inverse8 import transform as ref_transform  # noqa: E402
from reference.raster import rasterize as ref_rasterize  # noqa: E402
from reference.shade import render as ref_render  # noqa: E402

H = W = 64
GN, VIEWS, TEX, LEVELS = 9, 2, 32, 4
CFG = {"height": H, "width": W, "levels": LEVELS, "max_aniso": 4}
CAMS = ("campos", "camrot", "focal", "princpt")
SEEDS = [0, 1, 2**31 + 11]


def _scene(seed, dtype):
    """The scene as tensors of ``dtype``, its target (the reference's views
    of the true mesh and texture) and the fit's start: vertices moved by
    0.02, a grey texture."""
    a = inverse8_scene_arrays(H, GN, VIEWS, seed=seed % 2**32, tex_size=TEX)
    s = {k: torch.from_numpy(x).to(dtype) if x.dtype.kind == "f" else torch.from_numpy(x) for k, x in a.items()}
    s["img_gt"] = ref.prepare({**s, "v_gt": s["v_world"]}, CFG, "cpu")["img_gt"]
    s["v0"] = s["v_world"] + 0.02
    s["tex0"] = torch.full_like(s["tex_gt"], 0.5)
    return s


def _index(s):
    v_pix = ref_transform(s["v0"].expand(VIEWS, -1, -1), *(s[k] for k in CAMS))
    return ref_rasterize(v_pix, s["vi"], H, W)


def _reference(s, q=exact):
    leaves = {"v_world": s["v0"].clone().requires_grad_(), "tex": s["tex0"].clone().requires_grad_()}
    loss = ref.loss({**s, **leaves}, CFG, q)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _port(s):
    params = (s["v0"].clone().requires_grad_(), s["tex0"].clone().requires_grad_())
    return mipviews_step(params, torch.optim.Adam(params, lr=1e-3), s["vi"], s["vt"], {k: s[k] for k in CAMS},
                         s["img_gt"], H, W, LEVELS, device="cpu", index_img=_index(s))


def _gaps(got, want):
    (loss, grads), (loss_w, grads_w) = got, want
    out = {"loss": abs(float(loss) - float(loss_w)) / abs(float(loss_w))}
    for k, g in grads_w.items():
        assert float(g.abs().max()) > 0, k
        out[k] = float((grads[k].double() - g.double()).abs().max() / g.double().abs().max())
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_step_matches_the_reference_in_float64(seed):
    s = _scene(seed, torch.float64)
    gaps = _gaps(_port(s), _reference(s))
    assert max(gaps.values()) <= 1e-10, gaps


@pytest.mark.parametrize("seed", SEEDS)
def test_step_matches_the_reference_in_float32(seed):
    s = _scene(seed, torch.float32)
    gaps = _gaps(_port(s), _reference(s))
    assert gaps["loss"] <= 1e-5, gaps  # a mean of 32 K values: float32 rounding, a pixel's tap count or level
    assert max(gaps["v_world"], gaps["tex"]) <= 1e-4, gaps  # as the inverse8 step's gradients are held


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_in_bfloat16_fails_a_tolerance(seed):
    s = _scene(seed, torch.float32)
    gaps = _gaps(_reference(s, bfloat16), _reference(s))
    assert gaps["loss"] > 1e-5 or max(gaps["v_world"], gaps["tex"]) > 1e-4, gaps


@pytest.mark.parametrize("seed", SEEDS)
def test_uv_jacobian_matches_the_reference(seed):
    s = _scene(seed, torch.float64)
    v = s["v0"].expand(VIEWS, -1, -1)
    cams = [s[k] for k in CAMS]
    idx = _index(s)
    bary = ref_render(ref_transform(v, *cams), s["vi"], idx)
    want = ref.uv_jacobian(s["v0"], s["vt"], s["vi"], idx, bary, *cams[:3])
    got = screen_space_uv_derivative(v, s["vt"].expand(VIEWS, -1, -1), s["vi"], s["vi"], idx, bary, idx != -1,
                                     *cams[:3])
    assert float((idx >= 0).double().mean()) > 0.3
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pyramid_and_its_gradient_match_plain_means(dtype):
    gen = torch.Generator().manual_seed(3)
    tex = torch.rand((1, 3, TEX, TEX), generator=gen, dtype=dtype)
    cots = [torch.randn((1, 3, TEX >> i, TEX >> i), generator=gen, dtype=dtype) for i in range(LEVELS)]
    sides = []
    for build in (lambda t: mip_pyramid(t, LEVELS), lambda t: ref.pyramid(t, LEVELS)):
        t = tex.clone().requires_grad_()
        levels = build(t)
        (g,) = torch.autograd.grad(levels, [t], cots)
        sides.append(([x.detach() for x in levels], g))
    (got, g_got), (want, g_want) = sides
    tol = 1e-6 if dtype == torch.float32 else 1e-14  # the 2x2 sums in another order
    assert [x.shape for x in got] == [x.shape for x in want]
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= tol
    assert float((g_got - g_want).abs().max()) <= tol * float(g_want.abs().max())


def test_pyramid_refuses_sizes_it_cannot_halve():
    with pytest.raises(ValueError, match="divisible"):
        mip_pyramid(torch.zeros((1, 3, 24, 24)), 5)


def _recorded(step):
    """The marks (names, in the order they are set) and the spans (name,
    parent) of ``step()``, with no CUDA: ``tracing.mark`` replaced by a
    recorder of names, a tracer entered."""
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
            out = step()
    finally:
        pipeline.tracing.mark = orig
    return out, names, [(sp["name"], sp["parent"]) for sp in tracer.snapshot()["spans"]]


def _inverse8_scene():
    a = inverse8_scene_arrays(H, GN, VIEWS, seed=0, tex_size=TEX)
    t = {k: torch.from_numpy(x) for k, x in a.items()}
    cams = {k: t[k] for k in CAMS}
    with torch.no_grad():
        img_gt, _ = pipeline.render_multiview(t["v_world"], t["vi"], t["vt"], t["tex_gt"], cams, H, W, device="cpu")
    return t, cams, img_gt


def test_inverse8_step_is_unchanged():
    """The step against its body before the loss, backward and update were
    shared with the mipmapped step, spelled out: the same loss, gradients
    and update to the bit, the same marks and spans."""
    t, cams, img_gt = _inverse8_scene()

    def params():
        return (t["v_world"] + 0.02).requires_grad_(), torch.full_like(t["tex_gt"], 0.5).requires_grad_()

    p = params()
    (loss, grads), names, spans = _recorded(
        lambda: inverse8_step(p, torch.optim.Adam(p, lr=1e-3), t["vi"], t["vt"], cams, img_gt, H, W, device="cpu"))

    q = params()
    opt = torch.optim.Adam(q, lr=1e-3)
    img, _ = pipeline.render_multiview(q[0], t["vi"], t["vt"], q[1], cams, H, W, device="cpu")
    loss_q = ((img - img_gt) ** 2).mean()
    grads_q = torch.autograd.grad(loss_q, list(q))
    for x, g in zip(q, grads_q):
        x.grad = g
    opt.step()
    assert torch.equal(loss, loss_q.detach())
    assert torch.equal(grads["v_world"], grads_q[0]) and torch.equal(grads["tex"], grads_q[1])
    assert torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
    assert names == ["start", *INVERSE8_STAGES]
    assert spans == [
        ("forward", None), ("transform", 0), ("rasterize", 0), ("render", 0), ("interpolate", 0), ("grid_sample", 0),
        ("row_gather", 5), ("edge_grad", 0), ("backward", None), ("edge_grad_bwd", 8), ("grid_sample_bwd", 8),
        ("row_gather_bwd", 10), ("interpolate_bwd", 8), ("render_bwd", 8), ("transform_bwd", 8), ("adam", None),
    ]


def test_mipviews_step_marks_and_spans():
    """The step's marks are inverse8's with ``uv_derivative`` before
    ``grid_sample``; the pyramid, the uv Jacobian (forward only) and the
    sampler have spans, and the pyramid's backward ends inside the step's
    backward."""
    s = _scene(0, torch.float32)
    _, names, spans = _recorded(lambda: _port(s))
    assert names == ["start", *MIPVIEWS_STAGES]
    by_name = {name: parent for name, parent in spans}
    top = [name for name, parent in spans if parent is None]
    assert top == ["forward", "backward", "adam"]
    for name in ("mip_pyramid", "uv_derivative", "mipmap_grid_sample"):
        assert spans[by_name[name]][0] == "forward", name
    assert "uv_derivative_bwd" not in by_name
    for name in ("mip_pyramid_bwd", "mipmap_grid_sample_bwd"):
        assert spans[by_name[name]][0] == "backward", name


def test_mipviews_step_validation():
    s = _scene(0, torch.float32)
    params = (s["v0"].clone().requires_grad_(), s["tex0"].clone())
    with pytest.raises(ValueError, match="must require gradients"):
        mipviews_step(params, torch.optim.Adam(params, lr=1e-3), s["vi"], s["vt"], {k: s[k] for k in CAMS},
                      s["img_gt"], H, W, LEVELS, device="cpu")
    params = (s["v0"].clone().requires_grad_(), s["tex0"].clone().requires_grad_())
    with pytest.raises(ValueError, match="img_gt"):
        mipviews_step(params, torch.optim.Adam(params, lr=1e-3), s["vi"], s["vt"], {k: s[k] for k in CAMS},
                      s["img_gt"][:1], H, W, LEVELS, device="cpu")
    with pytest.raises(ValueError, match="stage_times"):
        mipviews_step(params, torch.optim.Adam(params, lr=1e-3), s["vi"], s["vt"], {k: s[k] for k in CAMS},
                      s["img_gt"], H, W, LEVELS, device="cpu", stage_times=[])
