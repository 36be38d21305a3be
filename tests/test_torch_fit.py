"""The port's fitting step against the JAX package's (CPU).

``bench._grad_case_textured`` is the JAX package's cross-compiler gradient
probe: the textured pipeline on a jittered grid mesh, loss
``sum(img * weight)``, gradients to ``v``, ``vt`` and ``tex``. Its inputs
are rebuilt here in numpy with the same seeds, and the port's
:func:`~drtk_tpu_torch.pipeline.fit_step` runs on the JAX side's own index
image, so both differentiate the same discrete structure. Gradients agree
to 1e-4 of the largest magnitude (the repo's gradient contract), the loss
to 1e-5 relative: XLA contracts products into FMAs on the CPU and the port
does not, and the 32x32 texture magnifies uv roundings.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import bench  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import scene_from_numpy, to_numpy  # noqa: E402
from drtk_tpu_torch.ops import segment_rows, window_accum  # noqa: E402
from drtk_tpu_torch.pipeline import FIT_STAGES, fit_step, textured_loss  # noqa: E402
from drtk_tpu_torch.scenes import make_scene  # noqa: E402
from tests.utils import grid_mesh  # noqa: E402


def _grad_case_inputs():
    """``bench._grad_case_textured``'s inputs, rebuilt in numpy."""
    h = w = 128
    v, vi = grid_mesh(h, w, gn=7, z0=5.0, z_amp=2.0, seed=5)
    v, vi = np.array(v), np.array(vi)
    rng = np.random.RandomState(7)
    v = v + rng.uniform(-0.4, 0.4, v.shape).astype(np.float32)
    vt = rng.rand(1, v.shape[1], 2).astype(np.float32)
    tex = rng.rand(1, 3, 32, 32).astype(np.float32)
    weight = rng.randn(1, 3, h, w).astype(np.float32)
    return {"v": v, "vi": vi, "vt": vt, "tex": tex, "weight": weight}, h, w


@pytest.fixture(scope="module")
def grad_case():
    return bench._grad_case_textured()


def test_fit_step_matches_jax_grad_case(grad_case):
    s, h, w = _grad_case_inputs()
    t = scene_from_numpy(s, device="cpu")
    idx = torch.from_numpy(np.array(grad_case["idx"]))
    loss, grads = fit_step(t["v"], t["vi"], t["vt"], t["tex"], h, w, index_img=idx, weight=t["weight"], device="cpu")
    np.testing.assert_allclose(float(loss), float(grad_case["loss"]), rtol=1e-5)
    for name in ("v", "vt", "tex"):
        want = np.asarray(grad_case[f"grad_{name}"])
        got = to_numpy(grads[name])
        assert got.shape == want.shape and np.abs(want).max() > 0
        err = np.abs(got - want).max()
        assert err <= 1e-4 * np.abs(want).max(), f"grad_{name}: {err} vs max {np.abs(want).max()}"


def test_fit_step_subsets_match_the_full_step(grad_case):
    """Each gradient alone equals its value in the full step: leaving a
    leaf out changes no other gradient."""
    s, h, w = _grad_case_inputs()
    t = scene_from_numpy(s, device="cpu")
    idx = torch.from_numpy(np.array(grad_case["idx"]))
    kw = dict(index_img=idx, weight=t["weight"], device="cpu")
    _, full = fit_step(t["v"], t["vi"], t["vt"], t["tex"], h, w, **kw)
    for name in ("v", "vt", "tex"):
        _, one = fit_step(t["v"], t["vi"], t["vt"], t["tex"], h, w, wrt=(name,), **kw)
        assert set(one) == {name}
        assert torch.equal(one[name], full[name])


def _count_calls(monkeypatch, module, name):
    calls = []
    inner = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("wrt, scatters, texture_scatters", [
    (("v", "vt", "tex"), 3, 1),
    (("v",), 2, 0),  # bench_textured's gradient: no texture scatter is built
    (("vt",), 1, 0),
    (("tex",), 0, 1),
])
def test_fit_step_runs_only_the_scatters_it_needs(monkeypatch, wrt, scatters, texture_scatters):
    """On the CPU the plain versions run, and no kernel launches; the
    pixel-to-face and texture scatters run once per gradient that needs
    them (``ctx.needs_input_grad``)."""
    rows = _count_calls(monkeypatch, segment_rows, "_scatter_rows_plain")
    taps = _count_calls(monkeypatch, window_accum, "_window_accumulate_plain")
    v, vi, vt, tex = make_scene(32, 48, 5, device="cpu")
    tt.reset_kernel_launch_counts()
    loss, grads = fit_step(v, vi, vt, tex, 32, 48, wrt=wrt, device="cpu")
    assert set(grads) == set(wrt) and all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert (len(rows), len(taps)) == (scatters, texture_scatters)
    assert set(tt.kernel_launch_counts().values()) == {0}


def test_fit_step_plain_and_auto_agree_on_the_cpu():
    v, vi, vt, tex = make_scene(48, 64, 6, device="cpu")
    loss_a, grads_a = fit_step(v, vi, vt, tex, 48, 64, device="cpu")
    loss_p, grads_p = fit_step(v, vi, vt, tex, 48, 64, device="cpu", impl="plain")
    assert torch.equal(loss_a, loss_p)
    assert all(torch.equal(grads_a[k], grads_p[k]) for k in ("v", "vt", "tex"))
    # bench_textured's loss, and the inputs are left untouched
    assert not v.requires_grad and v.grad is None
    img, _ = tt.pipeline.render_textured(v, vi, vt, tex, 48, 64, device="cpu")
    assert torch.equal(loss_a, textured_loss(img)) and torch.equal(loss_a, (img**2).mean())


def test_fit_step_validation():
    v, vi, vt, tex = make_scene(16, 16, 3, device="cpu")
    with pytest.raises(ValueError, match="wrt"):
        fit_step(v, vi, vt, tex, 16, 16, wrt=("vi",), device="cpu")
    with pytest.raises(ValueError, match="wrt"):
        fit_step(v, vi, vt, tex, 16, 16, wrt=(), device="cpu")
    with pytest.raises(ValueError, match="index_img"):
        fit_step(v, vi, vt, tex, 16, 16, index_img=torch.zeros((1, 8, 8), dtype=torch.int32), device="cpu")
    with pytest.raises(ValueError, match="stage_times"):
        fit_step(v, vi, vt, tex, 16, 16, device="cpu", stage_times=[])
    assert FIT_STAGES[-5:] == ("loss", "edge_grad_bwd", "grid_sample_bwd", "interpolate_bwd", "render_bwd")
