"""drtk_tpu_torch's mipmap_grid_sample against drtk_tpu's (CPU), on the same
numpy inputs made from a seed.

The JAX side runs as its own tests run it on the CPU: its texture gradient
through the windowed accumulation in interpret mode, one pass per mip level
and quad gather, each pass a few seconds; so the pyramids have two or three
levels, enough for the merged two-level gather. Tolerances: the
forward and the gradients to the levels and the grid (f32) to 1e-4 of the
largest magnitude, the repo's gradient contract (XLA contracts products
into FMAs on the CPU and the port does not; the port's texture gradient
also sums in another order). The float64 oracles, ``mipmap_grid_sample_ref``
of both packages, to 1e-10. Nothing reaches ``vt_dxdy_img``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from drtk_tpu.ops.mipmap_grid_sample import mipmap_grid_sample as jax_mipmap  # noqa: E402
from drtk_tpu.ops.mipmap_grid_sample import mipmap_grid_sample_ref as jax_mipmap_ref  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from tests.test_torch_backward import _assert_grad_close, _t  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401

GH, GW = 12, 16  # the sampling grid


def _inputs(sizes=((32, 32), (16, 16)), scale=0.06, seed=0, dtype=np.float32):
    """Mip levels [1, 3, h, w], a grid [1, GH, GW, 2] inside [-0.9, 0.9]
    with jitter, a uv Jacobian [1, GH, GW, 2, 2] of N(0, scale) and the
    output's cotangent, all from one seed."""
    rng = np.random.RandomState(seed)
    levels = [rng.rand(1, 3, h, w).astype(dtype) for h, w in sizes]
    gy, gx = np.meshgrid(np.linspace(-0.9, 0.9, GH), np.linspace(-0.9, 0.9, GW), indexing="ij")
    grid = (np.stack([gx, gy], -1)[None] + 0.02 * rng.randn(1, GH, GW, 2)).astype(dtype)
    jac = (scale * rng.randn(1, GH, GW, 2, 2)).astype(dtype)
    cot = rng.randn(1, 3, GH, GW).astype(dtype)
    return levels, grid, jac, cot


def _compare(levels, grid, jac, cot, **kw):
    """Forward and the gradients to the levels and the grid, port against
    JAX; returns the port's output."""
    q = len(levels)

    @jax.jit
    def jax_side(lv, gr, j, ct):  # one compile for the forward and the VJP
        want, pull = jax.vjp(lambda lv, gr: jax_mipmap(list(lv), gr, j, **kw), lv, gr)
        return want, pull(ct)

    want, (want_lv, want_gr) = jax_side(tuple(jnp.asarray(x) for x in levels), jnp.asarray(grid), jnp.asarray(jac),
                                        jnp.asarray(cot))

    lv = [_t(x).requires_grad_() for x in levels]
    gr = _t(grid).requires_grad_()
    out = tt.mipmap_grid_sample(lv, gr, _t(jac), **kw)
    _assert_grad_close(to_numpy(out), np.asarray(want))
    grads = torch.autograd.grad(out, (*lv, gr), _t(cot))
    for i in range(q):
        _assert_grad_close(to_numpy(grads[i]), np.asarray(want_lv[i]))
    _assert_grad_close(to_numpy(grads[q]), np.asarray(want_gr))
    return out


@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_mipmap_matches_jax(mode, padding_mode):
    # Bicubic with zeros padding takes four quad gathers, so four JAX passes
    # per level: one level here (the options test covers the merged gather).
    sizes = ((32, 32),) if (mode, padding_mode) == ("bicubic", "zeros") else ((32, 32), (16, 16))
    _compare(*_inputs(sizes), max_aniso=3, mode=mode, padding_mode=padding_mode)


@pytest.mark.parametrize(
    "case",
    ["force_max_aniso", "clip_grad_truncated", "one_level", "non_square", "avatar4k_call"],
)
def test_mipmap_options_match_jax(case):
    """``force_max_aniso``; ``clip_grad`` on a two-level pyramid whose
    footprints need deeper levels (so lambda > levels - 1); one level;
    non-square levels that do not halve exactly; and the avatar4k step's
    call (bilinear, border, max_aniso 2, clip_grad)."""
    if case == "force_max_aniso":
        _compare(*_inputs(), max_aniso=3, mode="bilinear", padding_mode="zeros", force_max_aniso=True)
    elif case == "clip_grad_truncated":
        levels, grid, jac, cot = _inputs(scale=0.3)
        _compare(levels, grid, jac, cot, max_aniso=2, mode="bilinear", padding_mode="border", clip_grad=True)
    elif case == "one_level":
        _compare(*_inputs(sizes=((24, 20),)), max_aniso=2, mode="bilinear", padding_mode="reflection")
    elif case == "non_square":
        _compare(*_inputs(sizes=((24, 40), (13, 19), (6, 10))), max_aniso=2, mode="bilinear", padding_mode="zeros")
    else:
        _compare(*_inputs(sizes=((32, 32), (16, 16), (8, 8)), scale=0.1), max_aniso=2, mode="bilinear",
                 padding_mode="border", clip_grad=True)


@pytest.mark.parametrize("mode,padding_mode", [("bilinear", "border"), ("bicubic", "zeros"), ("bilinear", "zeros")])
def test_mipmap_ref_matches_jax_ref_f64(mode, padding_mode):
    levels, grid, jac, _ = _inputs(sizes=((32, 32), (16, 16), (8, 8), (4, 4)), dtype=np.float64)
    want = jax_mipmap_ref([jnp.asarray(x) for x in levels], jnp.asarray(grid), jnp.asarray(jac), 2, mode=mode,
                          padding_mode=padding_mode)
    got = tt.mipmap_grid_sample_ref([_t(x) for x in levels], _t(grid), _t(jac), 2, mode=mode,
                                    padding_mode=padding_mode)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-10, atol=1e-10)
    # The documented equivalence: force_max_aniso, no clip_grad.
    main = tt.mipmap_grid_sample([_t(x) for x in levels], _t(grid), _t(jac), 2, mode=mode, padding_mode=padding_mode,
                                 force_max_aniso=True)
    np.testing.assert_allclose(to_numpy(main), to_numpy(got), rtol=1e-10, atol=1e-10)


def test_no_gradient_reaches_vt_dxdy():
    levels, grid, jac, _ = _inputs()
    j = _t(jac).requires_grad_()
    out = tt.mipmap_grid_sample([_t(x) for x in levels], _t(grid).requires_grad_(), j, 2, padding_mode="border")
    out.sum().backward()
    assert j.grad is None


def test_mipmap_validation():
    levels, grid, jac, _ = _inputs()
    lv = [_t(x) for x in levels]
    for kw, match in (
        ({"mode": "nearest"}, "only 'bilinear' and 'bicubic'"),
        ({"padding_mode": "wrap"}, "padding_mode"),
        ({"max_aniso": 0}, "max_aniso"),
    ):
        args = {"max_aniso": 2, **kw}
        with pytest.raises(ValueError, match=match):
            tt.mipmap_grid_sample(lv, _t(grid), _t(jac), **args)
    with pytest.raises(ValueError, match="empty"):
        tt.mipmap_grid_sample([], _t(grid), _t(jac), 2)
    with pytest.raises(ValueError, match="at most 11"):
        tt.mipmap_grid_sample(lv * 6, _t(grid), _t(jac), 2)
    with pytest.raises(ValueError, match="grid must be"):
        tt.mipmap_grid_sample(lv, _t(grid)[..., :1], _t(jac), 2)
    with pytest.raises(ValueError, match="vt_dxdy_img must be"):
        tt.mipmap_grid_sample(lv, _t(grid), _t(jac)[..., 0], 2)
    half = tt.mipmap_grid_sample([x.half() for x in lv], _t(grid).half(), _t(jac).half(), 2)
    assert half.dtype == torch.float32
