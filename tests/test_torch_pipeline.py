"""The port's forward render path end to end against the JAX package's
(``__graft_entry__._forward``), on the CPU.

Both sides render the same numpy scene, each with its own rasterizer. Index
images may differ only at depth ties: pixels whose two depths agree to 1e-4
relative (the tie rule of tests/test_rasterize_pallas.py), where the JAX
side's FMA contraction and the port's separate roundings decide the winner
differently. The share of such pixels is held below 1e-2 rather than that
test's 1e-3: at 64x128 the textured grid has pixel centres exactly on
shared grid diagonals (9 of 8192 pixels), where both triangles' depths are
equal. Wherever the index images agree, the images agree to 1e-5 (f32).
The JAX forward runs op by op, not jitted: jitted, XLA fuses and contracts
FMAs across ops, which moves the uvs by ulps that the 512-texel texture
magnifies to ~6e-5 in the image.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
import drtk_tpu as dt  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.interop import scene_from_numpy, to_numpy  # noqa: E402
from drtk_tpu_torch.pipeline import STAGES, render_textured  # noqa: E402
from drtk_tpu_torch.scenes import entry_scene, entry_scene_arrays, make_scene, make_scene_arrays  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401

# name -> (numpy scene, height, width)
CASES = {
    "textured_gn9": (lambda: make_scene_arrays(64, 128, 9), 64, 128),
    "entry": (lambda: entry_scene_arrays(h=64, w=96, num_f=128), 64, 96),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_textured_matches_jax_forward(case):
    make, h, w = CASES[case]
    s = make()
    want = np.asarray(graft._forward(*(jnp.asarray(s[k]) for k in ("v", "vi", "vt", "tex")), h, w))
    want_idx = np.asarray(dt.rasterize(jnp.asarray(s["v"]), jnp.asarray(s["vi"]), h, w))

    t = scene_from_numpy(s, device="cpu")
    img, idx = render_textured(t["v"], t["vi"], t["vt"], t["tex"], h, w, device="cpu")
    img, idx = to_numpy(img), to_numpy(idx)
    assert img.shape == want.shape and img.dtype == np.float32
    assert np.isfinite(img).all()

    depth_ref = np.asarray(dt.rasterize_with_depth(jnp.asarray(s["v"]), jnp.asarray(s["vi"]), h, w)[0])
    depth = to_numpy(tt.rasterize_with_depth(t["v"], t["vi"], h, w)[0])
    mism = want_idx != idx
    assert mism.mean() < 1e-2, f"{mism.sum()} index mismatches"
    assert (np.abs(depth_ref - depth) <= 1e-4 * np.abs(depth_ref) + 1e-6)[mism].all()

    agree = np.broadcast_to(~mism[:, None], img.shape)
    np.testing.assert_allclose(img[agree], want[agree], rtol=1e-5, atol=1e-5)
    assert (img[np.broadcast_to((idx < 0)[:, None], img.shape)] == 0).all()


def test_scene_builders_default_to_cuda():
    """Entry points run on the card unless asked for the CPU: without CUDA
    they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_scene(32, 32, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_scene(h=32, w=32)
    v, vi, vt, tex = make_scene(32, 32, 3, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        render_textured(v, vi, vt, tex, 32, 32)


def test_render_textured_checks_devices_and_counts_no_launches():
    v, vi, vt, tex = make_scene(32, 48, 4, device="cpu")
    tt.reset_kernel_launch_counts()
    img, idx = render_textured(v, vi, vt, tex, 32, 48, device="cpu")
    assert img.shape == (1, 3, 32, 48) and idx.dtype == torch.int32
    assert set(tt.kernel_launch_counts().values()) == {0}
    plain, _ = render_textured(v, vi, vt, tex, 32, 48, device="cpu", impl="plain")
    assert torch.equal(img, plain)
    with pytest.raises(ValueError, match="stage_times"):
        render_textured(v, vi, vt, tex, 32, 48, device="cpu", stage_times=[])
    with pytest.raises(ValueError, match="expected cpu"):
        render_textured(v.to("meta"), vi, vt, tex, 32, 48, device="cpu")
    assert STAGES[0] == "rasterize" and STAGES[-1] == "edge_grad"
