"""drtk_tpu_torch.grid_scatter against drtk_tpu's on the same numpy inputs
(CPU).

Most cases hold the port's float32 op to the JAX package's float64 oracle
(``grid_scatter_ref``, the transpose of its sampler by autodiff); two cases
hold it to the JAX package's float32 op itself, whose windowed path runs its
Pallas window kernel in interpret mode here. Tolerances as in
tests/test_grid_scatter.py: forward rtol 1e-5 / atol 1e-6; the input's and
the grid's gradients rtol 1e-4 / atol 5e-5 (grid-gradient entries are
O(10-100) and near-zero ones are float32 cancellation residue of the weight
derivatives). float64 against float64: 1e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from drtk_tpu.ops import grid_scatter as jgs  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from drtk_tpu_torch.ops import grid_scatter as tgs  # noqa: E402
from drtk_tpu_torch.ops import window_accum  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401

MODES = ["bilinear", "bicubic"]
PADS = ["zeros", "border", "reflection"]


def _case(seed=0, n=2, c=3, h=9, w=11, oh=7, ow=8, dtype=np.float32):
    """Input (a few pixels zero in every channel), grid in [-1.3, 1.3], and
    the loss's weight image."""
    rng = np.random.RandomState(seed)
    inp = rng.randn(n, c, h, w)
    inp[:, :, ::4, ::3] = 0.0
    grid = rng.uniform(-1.3, 1.3, (n, h, w, 2))
    tgt = rng.randn(n, c, oh, ow)
    return inp.astype(dtype), grid.astype(dtype), tgt.astype(dtype), oh, ow


def _jax_out_and_grads(fn, inp, grid, tgt, oh, ow, *args):
    def loss(i, g):
        return jnp.sum(fn(i, g, oh, ow, *args) * tgt)

    out = fn(jnp.asarray(inp), jnp.asarray(grid), oh, ow, *args)
    grads = jax.grad(loss, (0, 1))(jnp.asarray(inp), jnp.asarray(grid))
    return [np.asarray(x) for x in (out, *grads)]


def _torch_out_and_grads(fn, inp, grid, tgt, oh, ow, *args):
    ti, tg = (torch.from_numpy(a.copy()).requires_grad_() for a in (inp, grid))
    out = fn(ti, tg, oh, ow, *args)
    grads = torch.autograd.grad((out * torch.from_numpy(tgt)).sum(), (ti, tg))
    return [to_numpy(x) for x in (out, *grads)]


def _assert_matches(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("mode", MODES)
def test_grid_scatter_matches_jax_ref(mode, pad, align):
    """The port's float32 op, forward and both gradients, against the JAX
    package's float64 oracle on the same inputs."""
    inp, grid, tgt, oh, ow = _case()
    want = _jax_out_and_grads(jgs.grid_scatter_ref, *(a.astype(np.float64) for a in (inp, grid, tgt)), oh, ow,
                              mode, pad, align)
    got = _torch_out_and_grads(tt.grid_scatter, inp, grid, tgt, oh, ow, mode, pad, align)
    assert got[0].dtype == np.float32 and got[0].shape == (2, 3, oh, ow)
    _assert_matches(got, want)


@pytest.mark.parametrize("mode, pad", [("bilinear", "border"), ("bicubic", "zeros")])
def test_grid_scatter_matches_jax_windowed_path(mode, pad):
    """Against the JAX package's float32 op, its windowed path (the Pallas
    window kernel in interpret mode): the two configurations of the chip
    phase."""
    inp, grid, tgt, oh, ow = _case(seed=1)
    want = _jax_out_and_grads(jgs.grid_scatter, inp, grid, tgt, oh, ow, mode, pad)
    got = _torch_out_and_grads(tt.grid_scatter, inp, grid, tgt, oh, ow, mode, pad)
    _assert_matches(got, want)


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("mode", MODES)
def test_float64_exact_path_and_ref_match_jax_ref(mode, pad):
    """float64 takes the plain accumulation; it and the port's own oracle
    (and the oracle's gradients, by plain autograd) against the JAX
    package's oracle."""
    inp, grid, tgt, oh, ow = _case(seed=2, dtype=np.float64)
    want = _jax_out_and_grads(jgs.grid_scatter_ref, inp, grid, tgt, oh, ow, mode, pad, True)
    for fn in (tt.grid_scatter, tt.grid_scatter_ref):
        got = _torch_out_and_grads(fn, inp, grid, tgt, oh, ow, mode, pad, True)
        assert got[0].dtype == np.float64
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_grid_scatter_is_the_samplers_transpose(mode):
    inp, grid, _, oh, ow = _case(seed=3)
    out = tt.grid_scatter(torch.from_numpy(inp), torch.from_numpy(grid), oh, ow, mode, "reflection")
    y = torch.from_numpy(np.random.RandomState(4).randn(*out.shape).astype(np.float32))
    lhs = (out * y).sum().item()
    rhs = (torch.from_numpy(inp) * tt.grid_sample(y, torch.from_numpy(grid), mode, "reflection")).sum().item()
    assert lhs == pytest.approx(rhs, rel=1e-5)


@pytest.mark.parametrize("mode, taps", [("bilinear", 4), ("bicubic", 16)])
def test_one_accumulation_on_the_tap_grid(mode, taps, monkeypatch):
    """The forward makes one window_accumulate call on the [T*H, W] tap grid,
    with the taps of pixels that are zero in every channel inert (iy = -1);
    the backward makes none (no texture scatter)."""
    inp, grid, tgt, oh, ow = _case(seed=5)
    calls, accumulate = [], window_accum.window_accumulate

    def spy(rows, iy, ix, out_h, out_w, impl="auto", rows_hw=None):
        calls.append((rows, iy, rows_hw, impl))
        return accumulate(rows, iy, ix, out_h, out_w, impl, rows_hw)

    monkeypatch.setattr(tgs, "window_accumulate", spy)
    _torch_out_and_grads(tt.grid_scatter, inp, grid, tgt, oh, ow, mode, "border")
    assert len(calls) == 1
    rows, iy, rows_hw, impl = calls[0]
    assert rows.shape == (2, 3, taps * 9 * 11) and rows_hw == (taps * 9, 11) and impl == "auto"
    zero = torch.from_numpy((inp == 0).all(1))  # [N, H, W]
    iy = iy.reshape(2, taps, 9, 11)
    assert bool((iy[zero[:, None].expand_as(iy)] == -1).all()) and bool((iy >= 0).any())
    calls.clear()
    tt.grid_scatter(torch.from_numpy(inp).double(), torch.from_numpy(grid).double(), oh, ow, mode)
    assert calls[0][3] == "plain"


def test_half_inputs_compute_in_float32_and_validation():
    inp, grid, _, oh, ow = _case(seed=6)
    out = tt.grid_scatter(torch.from_numpy(inp).half(), torch.from_numpy(grid).half(), oh, ow)
    want = tt.grid_scatter(torch.from_numpy(inp).half().float(), torch.from_numpy(grid).half().float(), oh, ow)
    assert out.dtype == torch.float32 and torch.equal(out, want)
    x, g = torch.zeros(1, 1, 4, 4), torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="modes"):
        tt.grid_scatter(x, g, 4, 4, mode="nearest")
    with pytest.raises(ValueError, match="padding_mode"):
        tt.grid_scatter(x, g, 4, 4, padding_mode="wrap")
    with pytest.raises(ValueError, match="spatial shape"):
        tt.grid_scatter(x, torch.zeros(1, 5, 4, 2), 4, 4)
    with pytest.raises(ValueError, match="input"):
        tt.grid_scatter(torch.zeros(4, 4), g, 4, 4)
