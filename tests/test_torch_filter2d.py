"""drtk_tpu_torch's filter2d and filter2d_ref against drtk_tpu's on the same
numpy inputs (CPU).

Tolerances: the designed filters bit for bit (the same float64 numpy on the
same parameters, then float32); the resampler's forward and its
swap-construction gradient against the JAX package's at rtol 1e-4 /
atol 1e-5 (tests/test_filter2d.py:84: both convolve in float32, in other
orders); the port's reference against the JAX package's reference in
float64 to 1e-12, and the port's op against its own reference in float64
to 1e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import drtk_tpu.ops.filter2d as jf  # noqa: E402
import drtk_tpu.ops.filter2d_ref as jf_ref  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
import drtk_tpu_torch.ops.filter2d as tf  # noqa: E402
import drtk_tpu_torch.ops.filter2d_ref as tf_ref  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401

PADS = ["zeros", "reflection"]


def _img(seed=0, n=2, c=3, h=16, w=18, dtype=np.float32):
    """Even sizes: the swap construction maps a gradient back to the input's
    size only where the sampling factors divide it, here as in JAX."""
    return np.random.RandomState(seed).randn(n, c, h, w).astype(dtype)


def _pair(filter_type, n_taps, guard, m, freq_div, gain):
    j = jf.make_resampling_kernel(jf.FilterOptions(n_taps, jf.FilterType[filter_type.name], guard), m, freq_div,
                                  gain)
    t = tf.make_resampling_kernel(tf.FilterOptions(n_taps, filter_type, guard), m, freq_div, gain, device="cpu")
    return np.asarray(j), t


@pytest.mark.parametrize("filter_type", [tf.FilterType.Kaiser, tf.FilterType.Lanczos])
@pytest.mark.parametrize("n_taps, guard, m, freq_div, gain",
                         [(6, 0.0, 1, 1.0, 1.0), (6, 0.5, 2, 1.0, 2.0), (4, 0.0, 1, 2.0, 1.0), (8, 1.0, 3, 1.5, 1.0),
                          (2, 0.25, 4, 1.0, 4.0)])
def test_designed_filters_are_bit_exact(filter_type, n_taps, guard, m, freq_div, gain):
    want, got = _pair(filter_type, n_taps, guard, m, freq_div, gain)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(to_numpy(got), want)
    # cached per parameters and device: the same tensor again
    assert tf.make_resampling_kernel(tf.FilterOptions(n_taps, filter_type, guard), m, freq_div, gain,
                                     device="cpu") is got


@pytest.mark.parametrize("up, down", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("pad", PADS)
def test_resample_filter_and_its_gradient_match_jax(up, down, pad):
    """Forward and the swap-construction gradient of a weighted sum, with an
    asymmetric filter (so a missing flip or a wrong pad origin shows)."""
    x = _img()
    f = np.random.RandomState(1).randn(7).astype(np.float32)
    jx = jnp.asarray(x)
    out_j = jf.resample_filter(jx, jnp.asarray(f), up, down, pad)
    w = np.random.RandomState(2).randn(*out_j.shape).astype(np.float32)
    grad_j = jax.grad(lambda a: jnp.sum(jf.resample_filter(a, jnp.asarray(f), up, down, pad) * w))(jx)
    tx = torch.from_numpy(x).requires_grad_()
    out_t = tt.resample_filter(tx, torch.from_numpy(f), up, down, pad)
    (grad_t,) = torch.autograd.grad((out_t * torch.from_numpy(w)).sum(), tx)
    assert tuple(out_t.shape) == out_j.shape
    np.testing.assert_allclose(to_numpy(out_t), np.asarray(out_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_numpy(grad_t), np.asarray(grad_j), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("op", ["downsample", "upsample", "low_pass_filter"])
@pytest.mark.parametrize("pad", PADS)
def test_public_ops_match_jax(op, pad):
    """The bench's filters (``bench.py:763-767``): Kaiser n_taps=6 with a
    0.5 guard band down and up by 2, Lanczos n_taps=4 low-pass at
    freq_div=2; forward and gradient."""
    x = _img(seed=3, n=1, c=3, h=24, w=20)
    kaiser = [m.FilterOptions(6, m.FilterType.Kaiser, 0.5) for m in (jf, tf)]
    lanczos = [m.FilterOptions(4, m.FilterType.Lanczos) for m in (jf, tf)]
    calls = {
        "downsample": lambda m, o, a: m.downsample(a, o[0], 2, pad),
        "upsample": lambda m, o, a: m.upsample(a, o[0], 2, pad),
        "low_pass_filter": lambda m, o, a: m.low_pass_filter(a, o[1], 2.0, pad),
    }[op]
    out_j = calls(jf, (kaiser[0], lanczos[0]), jnp.asarray(x))
    w = np.random.RandomState(4).randn(*out_j.shape).astype(np.float32)
    grad_j = jax.grad(lambda a: jnp.sum(calls(jf, (kaiser[0], lanczos[0]), a) * w))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out_t = calls(tt, (kaiser[1], lanczos[1]), tx)
    (grad_t,) = torch.autograd.grad((out_t * torch.from_numpy(w)).sum(), tx)
    np.testing.assert_allclose(to_numpy(out_t), np.asarray(out_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_numpy(grad_t), np.asarray(grad_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_numpy(tt.filter(tx, torch.from_numpy(np.ones(3, np.float32)), pad)),
                               np.asarray(jf.filter(jnp.asarray(x), jnp.ones(3, jnp.float32), pad)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("up, down", [(1, 1), (2, 1), (1, 2), (2, 3)])
@pytest.mark.parametrize("pad", ["zeros", "border", "reflection"])
def test_ref_matches_jax_ref_in_float64(up, down, pad):
    """The oracles against each other, and the op against the port's oracle
    where the op is defined (no border padding): float64, 1e-12."""
    x = _img(seed=5, dtype=np.float64)
    f = tf.make_resampling_kernel(tf.FilterOptions(6), max(up, down), 1.0, float(up), device="cpu")
    want = np.asarray(jf_ref.resample_filter(jnp.asarray(x), jnp.asarray(to_numpy(f)), up, down, pad))
    got = tf_ref.resample_filter(torch.from_numpy(x), f, up, down, pad)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-12, atol=1e-12)
    if pad != "border":
        np.testing.assert_allclose(to_numpy(tt.resample_filter(torch.from_numpy(x), f, up, down, pad)), want,
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("up, down", [(1, 1), (2, 1), (1, 2)])
def test_gradient_is_the_swap_construction(up, down):
    """Under reflection the gradient is the op with up and down swapped and
    the backward flag set (not the adjoint); under zeros it is the adjoint,
    which the reference's plain autograd gives."""
    x = torch.from_numpy(_img(seed=6, n=1, c=1, h=8, w=8)).requires_grad_()
    f = tf.make_resampling_kernel(tf.FilterOptions(6), max(up, down), device="cpu")
    for pad in PADS:
        out = tt.resample_filter(x, f, up, down, pad)
        g = torch.from_numpy(np.random.RandomState(7).randn(*out.shape).astype(np.float32))
        (grad,) = torch.autograd.grad((out * g).sum(), x)
        expected = tf._ResampleCore.apply(g, f, down, up, True, pad == "reflection")
        torch.testing.assert_close(grad, expected, rtol=1e-6, atol=1e-7)
        (adjoint,) = torch.autograd.grad((tf_ref.resample_filter(x, f, up, down, pad) * g).sum(), x)
        if pad == "zeros":
            torch.testing.assert_close(grad, adjoint, rtol=1e-4, atol=1e-6)
        elif up == down == 1:
            assert not torch.allclose(grad, adjoint, rtol=1e-4, atol=1e-6)  # reflection: not the adjoint


def test_filter_options_and_validation():
    o = tf.FilterOptions(alias_suppression_level=0.25)
    assert o.alias_guard_band == 0.25 and o.alias_suppression_level == 0.25
    x = torch.from_numpy(_img(seed=8))
    f = torch.ones(3)
    with pytest.raises(NotImplementedError):
        tt.resample_filter(x, f, padding_mode="border")
    with pytest.raises(ValueError):
        tt.resample_filter(x, torch.ones(3, 3))
    with pytest.raises(ValueError):
        tt.resample_filter(x, f, up=0)
    with pytest.raises(ValueError):
        tt.make_resampling_kernel(tf.FilterOptions(6), m=0, device="cpu")
    with pytest.raises(TypeError):
        tf.FilterOptions(filter_type="kaiser")
    with pytest.raises(ValueError):
        tf.FilterOptions(alias_guard_band=0.5, alias_suppression_level=0.7)
    with pytest.raises(ValueError):
        tf_ref.resample_filter(x, f, padding_mode="wrap")
