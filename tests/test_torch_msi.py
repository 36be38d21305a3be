"""drtk_tpu_torch's msi against drtk_tpu's (CPU), on the same numpy rays and
textures made from a seed.

Tolerances: rgb and log-transmittance to rtol 1e-5 / atol 1e-5, and the
texture gradient to 1e-4 of its largest magnitude (f32; the two frameworks'
atan2, exp and sums round differently, and XLA contracts FMAs on the CPU).
Which rays stop early, and their log-transmittance of -1e3, must agree
exactly. The rays receive no gradient.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from drtk_tpu.ops.msi import msi as jax_msi  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from tests.test_torch_backward import _assert_grad_close, _t  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401


def _rays(n=300, seed=0, spread=0.0):
    """``n`` rays, unit-ish directions, origins within ``spread`` of the
    centre."""
    rng = np.random.RandomState(seed)
    ray_o = (spread * rng.uniform(-1, 1, (n, 3))).astype(np.float32)
    ray_d = rng.randn(n, 3).astype(np.float32)
    return ray_o, ray_d


def _texture(layers=6, h=16, w=32, seed=1, sigma=1.0):
    """rgb in [-0.2, 1) (negative values clamp in the composite) and sigma
    in [0, sigma), a few texels exactly 0."""
    rng = np.random.RandomState(seed)
    tex = rng.uniform(-0.2, 1.0, (layers, 4, h, w)).astype(np.float32)
    tex[:, 3] = rng.uniform(0.0, sigma, (layers, h, w)).astype(np.float32)
    tex[:, 3, ::5, ::7] = 0.0
    return tex


CASES = {  # name -> (rays kwargs, texture kwargs, msi kwargs)
    "default": ({}, {}, {"sub_step_count": 2}),
    "early_termination": ({}, {"sigma": 400.0}, {"sub_step_count": 3}),  # most rays stop
    "finite_shells": ({"spread": 0.8}, {}, {"sub_step_count": 2, "min_inv_r": 0.9, "max_inv_r": 0.3}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_msi_matches_jax(case):
    ray_kw, tex_kw, kw = CASES[case]
    ray_o, ray_d = _rays(**ray_kw)
    tex = _texture(**tex_kw)
    cot = np.random.RandomState(2).randn(ray_o.shape[0], 4).astype(np.float32)

    @jax.jit
    def jax_side(t, ct):
        out, pull = jax.vjp(lambda t: jax_msi(jnp.asarray(ray_o), jnp.asarray(ray_d), t, **kw), t)
        return out, pull(ct)[0]

    want, want_g = (np.asarray(x) for x in jax_side(jnp.asarray(tex), jnp.asarray(cot)))
    t = _t(tex).requires_grad_()
    out = tt.msi(_t(ray_o), _t(ray_d), t, **kw)
    got = to_numpy(out)
    stopped = want[:, 3] == -1e3
    np.testing.assert_array_equal(got[:, 3] == -1e3, stopped)
    if case == "early_termination":
        assert stopped.mean() > 0.5 and not stopped.all()
    else:
        assert not stopped.any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    (got_g,) = torch.autograd.grad(out, t, _t(cot))
    assert np.abs(want_g).max() > 0
    _assert_grad_close(to_numpy(got_g), want_g)


def test_msi_finite_shells_miss_and_hit():
    """Origins off centre with shells of radius 1/0.9 to 1/0.3: a ray from
    outside that misses every shell composites nothing."""
    ray_o = np.array([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0], [5.0, 0.0, 0.0]], np.float32)
    ray_d = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]], np.float32)
    tex = _texture()
    kw = {"min_inv_r": 0.9, "max_inv_r": 0.3}
    want = np.asarray(jax_msi(jnp.asarray(ray_o), jnp.asarray(ray_d), jnp.asarray(tex), **kw))
    got = to_numpy(tt.msi(_t(ray_o), _t(ray_d), _t(tex), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1], np.zeros(4, np.float32))  # misses every shell
    assert got[0, 3] < 0 and got[2, 3] < 0


def test_msi_rays_get_no_gradient():
    ray_o, ray_d = (_t(x).requires_grad_() for x in _rays(n=20, spread=0.3))
    t = _t(_texture()).requires_grad_()
    tt.msi(ray_o, ray_d, t).sum().backward()
    assert ray_o.grad is None and ray_d.grad is None
    assert t.grad is not None and bool(t.grad.abs().sum() > 0)


def test_msi_validation():
    ray_o, ray_d = (_t(x) for x in _rays(n=4))
    tex = _t(_texture())
    with pytest.raises(ValueError, match="ray_o"):
        tt.msi(ray_o[:, :2], ray_d, tex)
    with pytest.raises(ValueError, match="must match"):
        tt.msi(ray_o, ray_d[:3], tex)
    with pytest.raises(ValueError, match="texture"):
        tt.msi(ray_o, ray_d, tex[:, :3])
    with pytest.raises(ValueError, match="sub_step_count"):
        tt.msi(ray_o, ray_d, tex, sub_step_count=0)
    assert tt.msi(ray_o.half(), ray_d.half(), tex.half()).dtype == torch.float32
