"""drtk_tpu_torch.screen_space_uv_derivative against drtk_tpu's on the same
numpy inputs and the same index and barycentric images (CPU).

Tolerances: the Jacobian image to 1e-5 of its largest magnitude in float32
(an adjugate inverse of dp/dt per face here, an LU solve in JAX; then the
same interpolation, projection Jacobian and 2x2 inverse), 1e-12 in
float64; against finite differences of the rasterized uv image on a
fronto-parallel quad and central ones on a tilted quad, as
tests/test_screen_space_uv_derivative.py does (rtol 5e-3 / atol 5e-5, and
2e-2 / 2e-4 where the map is perspective).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import drtk_tpu as dt  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from drtk_tpu_torch.ops import segment_rows  # noqa: E402
from drtk_tpu_torch.scenes import inverse8_scene_arrays  # noqa: E402
from drtk_tpu_torch.utils.geometry import _inv_2x2_or_zero  # noqa: E402
from tests.test_screen_space_uv_derivative import _check_against_fd, make_scene  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401

# The module, which the package's function of the same name shadows as an attribute.
jsuv = importlib.import_module("drtk_tpu.screen_space_uv_derivative")
CAMS = ("campos", "camrot", "focal", "princpt")
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _inverse8_inputs(dtype, h=64, gn=9, views=2):
    """The inverse8 scene at 2 views of 64^2, with JAX's index and bary
    images."""
    a = {k: (x.astype(dtype) if x.dtype.kind == "f" else x) for k, x in inverse8_scene_arrays(h, gn, views).items()}
    j = {k: jnp.asarray(x) for k, x in a.items()}
    v = jnp.broadcast_to(j["v_world"], (views,) + j["v_world"].shape[1:])
    vt = jnp.broadcast_to(j["vt"], (views,) + j["vt"].shape[1:])
    v_pix = dt.transform(v, *(j[k] for k in CAMS))
    idx = dt.rasterize(v_pix, j["vi"], h, h)
    _, bary = dt.render(v_pix, j["vi"], idx)
    args = (v, vt, j["vi"], j["vi"], idx, bary, idx != -1, j["campos"], j["camrot"], j["focal"])
    return [np.array(x) for x in args]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_uv_derivative_matches_jax_on_inverse8_views(dtype):
    args = _inverse8_inputs(dtype)
    want = np.asarray(jsuv.screen_space_uv_derivative(*(jnp.asarray(a) for a in args)))
    got = tt.screen_space_uv_derivative(*(torch.from_numpy(a) for a in args))
    assert tuple(got.shape) == (2, 64, 64, 2, 2) and got.dtype == torch.from_numpy(args[0]).dtype
    mask = args[6]
    assert 0.3 < mask.mean() < 1.0 and not to_numpy(got)[~mask].any()
    assert np.abs(to_numpy(got) - want).max() <= TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("hw, tilt", [(64, 0.0), (96, 2.5)])
def test_uv_derivative_matches_finite_differences(hw, tilt):
    """The JAX tests' quads: fronto-parallel against one-pixel differences
    of the rasterized uv image, tilted in depth against central differences
    (rtol 2e-2, atol 2e-4, as there: the map is perspective); and both
    against JAX's Jacobian on the port's index and bary images."""
    v, vt, vi, vti, campos, camrot, focal, princpt = (np.asarray(x) for x in make_scene(hw, hw, tilt))
    tv, tvt, tvi, tcampos, tcamrot, tfocal, tprincpt = (
        torch.from_numpy(np.array(x)) for x in (v, vt, vi, campos, camrot, focal, princpt))
    v_pix = tt.transform(tv, tcampos, tcamrot, tfocal, tprincpt)
    idx = tt.rasterize(v_pix, tvi, hw, hw)
    _, bary = tt.render(v_pix, tvi, idx)
    uv = tt.interpolate(tvt, tvi, idx, bary)
    jac = tt.screen_space_uv_derivative(tv, tvt, tvi, tvi, idx, bary, idx != -1, tcampos, tcamrot, tfocal)
    if tilt == 0.0:
        _check_against_fd(to_numpy(idx), to_numpy(uv), to_numpy(jac))
    else:
        i, u, j = to_numpy(idx)[0], to_numpy(uv)[0], to_numpy(jac)[0]
        same = (i[:, 2:] == i[:, :-2]) & (i[:, 1:-1] == i[:, :-2]) & (i[:, :-2] >= 0)
        fd_x = (u[:, :, 2:] - u[:, :, :-2]) / 2.0
        an_x = np.moveaxis(j[:, 1:-1, 0, :], -1, 0)
        assert same.sum() > 1000
        np.testing.assert_allclose(an_x[:, same], fd_x[:, same], rtol=2e-2, atol=2e-4)
    want = jsuv.screen_space_uv_derivative(
        jnp.asarray(v), jnp.asarray(vt), jnp.asarray(vi), jnp.asarray(vti), jnp.asarray(to_numpy(idx)),
        jnp.asarray(to_numpy(bary)), jnp.asarray(to_numpy(idx) != -1), jnp.asarray(campos), jnp.asarray(camrot),
        jnp.asarray(focal))
    assert np.abs(to_numpy(jac) - np.asarray(want)).max() <= 1e-5 * np.abs(np.asarray(want)).max()


def test_inverse_2x2_zeros_at_a_singular_determinant():
    m = np.array([[[1.0, 2.0], [2.0, 4.0]], [[2.0, 1.0], [1.0, 3.0]], [[0.0, 0.0], [0.0, 0.0]]], np.float32)
    got = to_numpy(_inv_2x2_or_zero(torch.from_numpy(m)))
    np.testing.assert_array_equal(got, np.asarray(jsuv._inv_2x2(jnp.asarray(m))))
    assert not got[0].any() and not got[2].any()
    np.testing.assert_allclose(got[1] @ m[1], np.eye(2), atol=1e-6)


def test_uv_derivative_gathers_through_the_face_row_gather(monkeypatch):
    """Its two interpolations gather 3 x 6 and 3 x 3 floats per face of the
    3F-vertex table (kernel B2 on the card), with ``impl`` passed on."""
    args = _inverse8_inputs(np.float32, h=32, gn=5, views=1)
    calls, gather = [], segment_rows.gather_rows_by_index

    def spy(table, idx, impl="auto"):
        calls.append((tuple(table.shape), impl))
        return gather(table, idx, impl)

    import drtk_tpu_torch.ops.interpolate as interp

    monkeypatch.setattr(interp, "gather_rows_by_index", spy)
    tt.screen_space_uv_derivative(*(torch.from_numpy(a) for a in args), impl="plain")
    f = args[2].shape[0]
    assert calls == [((1, f, 18), "plain"), ((1, f, 9), "plain")]
