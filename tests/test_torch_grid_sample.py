"""drtk_tpu_torch.grid_sample's forward and VJP in every mode, padding and
corner convention (3 x 3 x 2) against drtk_tpu's and against
``torch.nn.functional.grid_sample`` (CPU).

The port runs in float32, the JAX package in float64: its float32 texture
gradient takes its TPU windowed scatter, which runs in interpret mode here
(~20 s a bicubic call), its float64 one the plain scatter. Tolerances: the
forward to 1e-5 and both gradients to 1e-4 of their largest magnitude (the
float32 rounding of the port against an exact reference); the grid points
reach past the texture and none lies on a clamp bound, where ``torch.clamp``
passes the whole gradient and JAX's ``clip`` half.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from drtk_tpu.ops.grid_sample import grid_sample as jax_grid_sample  # noqa: E402
from drtk_tpu_torch import grid_sample  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from tests.test_torch_backward import _assert_grad_close  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401


def _grads(out, inputs, g):
    """Gradients of ``out`` against the cotangent ``g``; zeros for an input
    out of the graph (nearest sampling's grid)."""
    got = torch.autograd.grad(out, inputs, g, allow_unused=True)
    return [torch.zeros_like(x) if d is None else d for x, d in zip(inputs, got)]


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bicubic"])
def test_grid_sample_vjp_every_mode_matches_jax(mode, padding_mode, align_corners):
    rng = np.random.RandomState(6)
    tex = rng.rand(2, 3, 11, 14)
    grid = rng.uniform(-1.3, 1.3, (2, 7, 9, 2))
    g = rng.randn(2, 3, 7, 9)
    kw = dict(mode=mode, padding_mode=padding_mode, align_corners=align_corners)
    want_out, vjp = jax.vjp(lambda t, gr: jax_grid_sample(t, gr, **kw), jnp.asarray(tex), jnp.asarray(grid))
    want_tex, want_grid = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    f32 = [torch.from_numpy(a.astype(np.float32)) for a in (tex, grid, g)]
    t, gr = f32[0].clone().requires_grad_(), f32[1].clone().requires_grad_()
    out = grid_sample(t, gr, **kw)
    got_tex, got_grid = _grads(out, (t, gr), f32[2])
    _assert_grad_close(to_numpy(out), np.asarray(want_out), rel=1e-5)
    _assert_grad_close(to_numpy(got_tex), want_tex)
    if mode == "nearest":
        assert not want_grid.any() and not got_grid.any()
    else:
        _assert_grad_close(to_numpy(got_grid), want_grid)

    t2, gr2 = f32[0].clone().requires_grad_(), f32[1].clone().requires_grad_()
    lib = torch.nn.functional.grid_sample(t2, gr2, **kw)
    lib_tex, lib_grid = _grads(lib, (t2, gr2), f32[2])
    _assert_grad_close(to_numpy(out), to_numpy(lib), rel=1e-5)
    _assert_grad_close(to_numpy(got_tex), to_numpy(lib_tex))
    if mode != "nearest":
        _assert_grad_close(to_numpy(got_grid), to_numpy(lib_grid))
