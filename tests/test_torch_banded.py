"""Row banding in drtk_tpu_torch (CPU): ``map_row_bands`` against the
port's full frame, and ``edge_grad_estimator_banded`` against the port's
full-frame ``edge_grad_estimator`` and against drtk_tpu's banded estimator.

Tolerances: banded forward outputs (index, bary, uv, shaded image) equal the
full frame's bit for bit, since each band is a viewport; gradients (f32) to
1e-4 of the largest magnitude, since bands sum their pixel-to-face and
face-to-vertex contributions in another order (and, against JAX, XLA
contracts FMAs). The JAX comparison uses the soup, in general position (see
tests/test_torch_viewports.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from drtk_tpu.parallel.banded import edge_grad_estimator_banded as jax_edge_grad_banded  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from drtk_tpu_torch.scenes import make_scene_arrays  # noqa: E402
from tests.test_torch_backward import _assert_grad_close, _jax_vjp, _t  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401
from tests.test_torch_viewports import _case  # noqa: E402

H, W = 64, 96


def _shade(v, vi, vt, tex, h, y0=None, hb=None):
    """rasterize -> render -> interpolate -> grid_sample, the full frame or
    rows [y0, y0 + hb) as a viewport; returns (rgb, bary, index, uv)."""
    if y0 is None:
        idx = tt.rasterize(v, vi, h, W)
        _, bary = tt.render(v, vi, idx)
        vt_img = tt.interpolate(vt, vi, idx, bary)
    else:
        idx = tt.rasterize(v, vi, hb, W, y_offset=y0, full_height=h)
        _, bary = tt.render(v, vi, idx, y_offset=y0)
        vt_img = tt.interpolate(vt, vi, idx, bary, y_offset=y0, full_height=h)
    uv = vt_img.movedim(1, -1) * 2.0 - 1.0
    rgb = tt.grid_sample(tex, uv, padding_mode="border")
    return {"rgb": rgb, "bary": bary, "idx": idx, "uv": vt_img}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("n_bands", [2, 4])
def test_map_row_bands_equals_the_full_frame(n_bands, remat):
    s = make_scene_arrays(H, W, 9)
    s["tex"] = s["tex"][:, :, :32, :32].copy()
    cot = np.random.RandomState(n_bands).randn(1, 3, H, W).astype(np.float32)
    out, grads = {}, {}
    for name in ("full", "banded"):
        v, tex = _t(s["v"]).requires_grad_(), _t(s["tex"]).requires_grad_()
        vi, vt = _t(s["vi"]), _t(s["vt"])
        if name == "full":
            out[name] = _shade(v, vi, vt, tex, H)
        else:
            hb = H // n_bands
            out[name] = tt.map_row_bands(lambda y0: _shade(v, vi, vt, tex, H, y0, hb), H, n_bands, remat=remat)
        grads[name] = torch.autograd.grad(out[name]["rgb"], (v, tex), _t(cot))
    for key in ("rgb", "bary", "idx", "uv"):
        assert torch.equal(out["banded"][key], out["full"][key]), key
    for got, want in zip(grads["banded"], grads["full"]):
        _assert_grad_close(to_numpy(got), to_numpy(want))


def test_map_row_bands_merges_any_pytree_and_checks_the_height():
    merged = tt.map_row_bands(
        lambda y0: (torch.full((2, 4, 5), float(y0)), {"rows": torch.arange(4.0)[:, None] + y0}), 12, 3)
    assert merged[0].shape == (2, 12, 5) and merged[1]["rows"].shape == (12, 1)
    assert torch.equal(merged[1]["rows"][:, 0], torch.arange(12.0))
    assert torch.equal(merged[0][0, :, 0], torch.tensor([0.0] * 4 + [4.0] * 4 + [8.0] * 4))
    with pytest.raises(ValueError, match="not divisible"):
        tt.map_row_bands(lambda y0: torch.zeros(1, 5, 2), 10, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tt.edge_grad_estimator_banded(torch.zeros(1, 3, 3), torch.zeros(1, 3, dtype=torch.int32),
                                      torch.zeros(1, 3, 10, 4), torch.zeros(1, 3, 10, 4),
                                      torch.zeros(1, 10, 4, dtype=torch.int32), 4)


@pytest.mark.parametrize("n_bands", [1, 2, 4])
def test_edge_grad_banded_equals_full_frame_and_jax(n_bands):
    s, idx, _, img, g = _case("soup")
    bary = np.array(to_numpy(tt.render(_t(s["v"]), _t(s["vi"]), _t(idx))[1]))

    def port(banded):
        v, im = _t(s["v"]).requires_grad_(), _t(img).requires_grad_()
        if banded:
            out = tt.edge_grad_estimator_banded(v, _t(s["vi"]), _t(bary), im, _t(idx), n_bands)
        else:
            out = tt.edge_grad_estimator(v, _t(s["vi"]), _t(bary), im, _t(idx))
        assert torch.equal(out, im)
        return torch.autograd.grad(out, (v, im), _t(g))

    got_v, got_img = port(True)
    full_v, _ = port(False)
    vi, jidx, jbary = jnp.asarray(s["vi"]), jnp.asarray(idx), jnp.asarray(bary)
    want_v, want_img = _jax_vjp(lambda v, im: jax_edge_grad_banded(v, vi, jbary, im, jidx, n_bands), (s["v"], img), g)
    assert np.abs(want_v).max() > 0
    _assert_grad_close(to_numpy(got_v), to_numpy(full_v))
    _assert_grad_close(to_numpy(got_v), want_v)
    np.testing.assert_array_equal(to_numpy(got_img), want_img)
