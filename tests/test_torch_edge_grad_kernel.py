"""Kernel E1's function, the edge_grad backward's CRD stencil, on the CPU.

E1 (``drtk_tpu_torch/csrc/edge_grad.cu``) runs only on the card; on a CPU
tensor :func:`~drtk_tpu_torch.ops.edge_grad.edge_grad_stencil` runs its
plain version, ``_stencil_plain``, which takes exactly E1's arguments and
has its two outputs: the image gradient (image mode) and the per-pixel
``bary x g`` rows (rows mode). Here the plain version is held to the JAX
package on the same numpy inputs, and the dispatch to it: a CPU tensor
never reaches the build. The card tests (``tests/test_torch_kernels.py``,
``-m cuda``) hold E1 to this plain version; here, E1's own source,
compiled for the host by g++ against a stand-in ``cuda_runtime.h``
(``tests/cuda_host/``), is held to it too: the kernel's arithmetic and
indexing, not the card's compiler.

Tolerances: float32, 1e-4 of the largest magnitude, the gradient contract
of ``tests/test_torch_backward.py`` (XLA contracts products into FMAs on
the CPU, the port does not; the scenes are in general position, so that no
pixel centre sits on a coverage boundary where that rounding decides the
class). float64: 1e-10. Rows mode is the product of bary and image mode,
bit for bit. The host build of E1 against the plain version: the same
nonzero pixels, values within 1e-6 of the largest magnitude (the channel
sum and the norms may round in another order than torch's), 1e-12 in
float64.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import drtk_tpu as dt  # noqa: E402
from drtk_tpu.ops.edge_grad import _edge_grad_backward as jax_edge_grad_backward  # noqa: E402
from drtk_tpu.ops.edge_grad import edge_grad_image as jax_edge_grad_image  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch import _build  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from drtk_tpu_torch.ops import edge_grad as eg  # noqa: E402
from drtk_tpu_torch.ops.rasterize import broadcast_vi  # noqa: E402
from drtk_tpu_torch.parallel import banded  # noqa: E402
from tests.test_torch_backward import _assert_grad_close, _t  # noqa: E402
from tests.test_torch_kernels import E1_SCENES, _e1_scene, _one_torch_thread  # noqa: E402,F401
from tests.test_torch_ops import _soup  # noqa: E402

SCENES = {
    "soup_batch2": (lambda: _soup(2, 24, 20, 64, 128, 1), 64, 128),
    "nonaligned": (lambda: _soup(1, 48, 64, 70, 130, 2), 70, 130),
    # edges at a pixel diamond's reach, to within ulps; the pixel centres
    # themselves stay off the edges
    "near_miss": (lambda: chip_smoke.near_miss_scene(64, 128), 64, 128),
}


def _case(scene, dtype=np.float32, channels=4):
    """The scene, JAX's index image and bary of it, and a seeded image and
    cotangent, all numpy, in ``dtype``."""
    make, h, w = SCENES[scene]
    s = make()
    v = s["v"].astype(dtype)
    idx = np.array(jax.jit(dt.rasterize, static_argnums=(2, 3))(jnp.asarray(s["v"]), jnp.asarray(s["vi"]), h, w))
    assert (idx >= 0).any() and (idx < 0).any()
    _, bary = jax.jit(dt.render)(jnp.asarray(v), jnp.asarray(s["vi"]), jnp.asarray(idx))
    rng = np.random.RandomState(11)
    img = rng.rand(idx.shape[0], channels, h, w).astype(dtype)
    g = rng.randn(idx.shape[0], channels, h, w).astype(dtype)
    return v, s["vi"], idx, np.array(bary), img, g


def _table(v, vi):
    v = _t(v)
    return eg._stencil_table(v, broadcast_vi(_t(vi), v.shape[0]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_dp_dr", [1e4, 0.0])
@pytest.mark.parametrize("scene", list(SCENES))
def test_plain_image_mode_matches_jax(scene, max_dp_dr, dtype):
    """Image mode against ``drtk_tpu.ops.edge_grad.edge_grad_image``."""
    v, vi, idx, _, img, g = _case(scene, dtype)
    got = eg.edge_grad_stencil(_table(v, vi), _t(idx), _t(img), _t(g), None, max_dp_dr)
    want = jax.jit(lambda *a: jax_edge_grad_image(*a, max_dp_dr))(
        jnp.asarray(v), jnp.asarray(vi), jnp.asarray(img), jnp.asarray(idx), jnp.asarray(g))
    want = np.asarray(want)
    assert got.dtype == _t(v).dtype and np.abs(want).max() > 0
    _assert_grad_close(to_numpy(got), want, rel=1e-4 if dtype == np.float32 else 1e-10)


def _halo_tiles(h):
    """(y0, rows) of 4 bands of h/4 rows, each with its halo row below."""
    hb = h // 4
    return [(y0, slice(y0, y0 + hb + 1)) for y0 in range(0, h, hb)]


@pytest.mark.parametrize("band", range(4))
def test_plain_rows_mode_on_a_row_tile_matches_jax(band):
    """Rows mode on a band and its halo row (``y_offset``, ``full_height``;
    the frame padded with one background row, as the banded path pads it)
    against bary times JAX's ``_edge_grad_backward`` of the same tile."""
    v, vi, idx, bary, img, g = _case("soup_batch2")
    h = idx.shape[1]
    pad = ((0, 0), (0, 0), (0, 1), (0, 0))
    img_p, g_p, bary_p = np.pad(img, pad), np.pad(g, pad), np.pad(bary, pad)
    idx_p = np.pad(idx, ((0, 0), (0, 1), (0, 0)), constant_values=-1)
    y0, rows = _halo_tiles(h)[band]
    img_b, g_b, bary_b, idx_b = img_p[:, :, rows], g_p[:, :, rows], bary_p[:, :, rows], idx_p[:, rows]
    got = eg.edge_grad_stencil(_table(v, vi), _t(idx_b), _t(img_b), _t(g_b), _t(bary_b), 1e4, y0, h)
    vib = to_numpy(broadcast_vi(_t(vi), v.shape[0]))
    gv = jax.jit(jax_edge_grad_backward, static_argnums=(5, 6, 7))(
        jnp.asarray(v), jnp.asarray(vib), jnp.asarray(img_b), jnp.asarray(idx_b), jnp.asarray(g_b), 1e4, y0, h)
    gv = np.moveaxis(np.asarray(gv), 1, -1)  # [N, hb+1, W, 3(coord)]
    want = (np.moveaxis(bary_b, 1, -1)[..., :, None] * gv[..., None, :]).reshape(got.shape)
    assert np.abs(want).max() > 0
    _assert_grad_close(to_numpy(got), want)


@pytest.mark.parametrize("tile", [False, True])
@pytest.mark.parametrize("max_dp_dr", [1e4, 0.0])
@pytest.mark.parametrize("scene", list(SCENES))
def test_rows_mode_is_bary_times_image_mode(scene, max_dp_dr, tile):
    """Rows mode equals bary[k] * image[j] at 3k + j, bit for bit, on the
    full frame and on the frame's last band of 24 rows with a background
    halo row, as the banded path pads it (the stencil centres on the frame's
    last row dropped, so the halo row gets nothing)."""
    v, vi, idx, bary, img, g = _case(scene)
    args = [_t(idx), _t(img), _t(g), _t(bary)]
    y0, frame_h = 0, -1
    if tile:
        h = idx.shape[1]
        y0, frame_h = h - 24, h
        args = [banded._pad_rows(a[:, y0:], -1) if a.ndim == 3 else banded._pad_rows(a[:, :, y0:]) for a in args]
    table = _table(v, vi)
    rows = eg.edge_grad_stencil(table, *args, max_dp_dr, y0, frame_h)
    image = eg.edge_grad_stencil(table, *args[:3], None, max_dp_dr, y0, frame_h)
    n, _, h, w = image.shape
    want = (args[3].movedim(1, -1)[..., :, None] * image.movedim(1, -1)[..., None, :]).reshape(n, h, w, 9)
    assert rows.shape == (n, h, w, 9) and bool((rows != 0).any())
    assert torch.equal(rows, want)
    if tile:
        assert not image[:, :, -1].any()


def test_cpu_tensors_never_reach_the_build(monkeypatch):
    """With CPU tensors and impl="auto", the backward (full frame, banded)
    and edge_grad_image run the plain version: nothing is built or looked
    up, and E1's count stays 0."""

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "entry", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    v, vi, idx, bary, img, g = (_t(a) for a in _case("soup_batch2"))
    tt.reset_kernel_launch_counts()
    for estimator, extra in ((tt.edge_grad_estimator, ()), (tt.edge_grad_estimator_banded, (4,))):
        vv = v.clone().requires_grad_()
        (grad_v,) = torch.autograd.grad(estimator(vv, vi, bary, img, idx, *extra), vv, g)
        assert bool((grad_v != 0).any())
    assert bool((tt.edge_grad_image(v, vi, img, idx, g) != 0).any())
    assert set(tt.kernel_launch_counts().values()) == {0}


def test_wrapper_refuses_what_e1_does_not_take():
    """Outside the card, the wrapper refuses before any build: a CPU
    tensor, an unknown impl, a dtype without a kernel, an int64 index."""
    table = torch.zeros((1, 4, 16))
    idx = torch.zeros((1, 3, 5), dtype=torch.int32)
    img = torch.zeros((1, 2, 3, 5))
    with pytest.raises(ValueError, match="CUDA device"):
        eg._stencil_cuda(table, idx, img, img, None, 1e4)
    with pytest.raises(ValueError, match="impl"):
        eg.edge_grad_stencil(table, idx, img, img, None, 1e4, impl="fast")
    with pytest.raises(TypeError, match="no kernel"):
        eg._stencil_cuda(table.half(), idx, img, img, None, 1e4)
    with pytest.raises(TypeError, match="int32"):
        eg._stencil_cuda(table, idx.long(), img, img, None, 1e4)


def test_build_lists_e1_and_binds_its_entries():
    """``_build.SOURCES`` names csrc/edge_grad.cu, which defines every C
    entry the wrapper binds (and the error string ``_build.check`` reads)."""
    assert "edge_grad" in _build.SOURCES
    src = (_build.CSRC / "edge_grad.cu").read_text()
    for name in [*eg._C_ENTRY.values(), "drtk_cuda_error_string"]:
        assert f" {name}(" in src, name
    assert set(eg._C_ENTRY) == {torch.float32, torch.float64}


@pytest.fixture(scope="module")
def e1_on_the_host(tmp_path_factory):
    """E1's C entries from csrc/edge_grad.cu compiled for the host, by dtype."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    src, launches = re.subn(
        r"(\w+<[^<>]*>)<<<([^,]+),\s*([^,]+),[^>]*>>>\((\w+)\);", r"drtk_host_launch(\2, \3, [&] { \1(\4); });",
        (_build.CSRC / "edge_grad.cu").read_text(),
    )
    assert launches == 2
    out = tmp_path_factory.mktemp("e1_host")
    (out / "edge_grad_host.cpp").write_text(src)
    include = Path(__file__).resolve().parent / "cuda_host"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", f"-I{include}",
         "-o", str(out / "libedge_grad_host.so"), str(out / "edge_grad_host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(out / "libedge_grad_host.so"))
    fns = {}
    for dtype, symbol in eg._C_ENTRY.items():
        fns[dtype] = getattr(lib, symbol)
        fns[dtype].argtypes, fns[dtype].restype = eg._ARGTYPES, ctypes.c_int
    return fns


@pytest.mark.parametrize("viewport", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scene", E1_SCENES)
def test_kernel_source_on_the_host_matches_plain(e1_on_the_host, scene, dtype, viewport):
    """E1's source, run on the host through the wrapper's own launch code,
    against the plain version on the card tests' scenes, in both modes and
    at max_dp_dr 1e4 and 0; the viewport is the frame's last 24 rows and a
    background halo row (strided slices of the padded frame)."""
    table, idx, img, g, bary = _e1_scene(scene)
    table, img, g, bary = (t.to(dtype) for t in (table, img, g, bary))
    y0, frame_h = 0, -1
    if viewport:
        y0, frame_h = idx.shape[1] - 24, idx.shape[1]
        img, g, bary, idx = banded._pad_frame(img, g, bary, idx)
        idx, img, g, bary = idx[:, y0:], img[:, :, y0:], g[:, :, y0:], bary[:, :, y0:]
    for max_dp_dr in (1e4, 0.0):
        for rows in (bary, None):
            args = (table, idx, img, g, rows, max_dp_dr, y0, frame_h)
            got = eg._launch(lambda: e1_on_the_host[dtype], None, *args)
            want = eg._stencil_plain(*args)
            nonzero = (lambda t: (t != 0).any(1)) if rows is None else (lambda t: (t != 0).any(-1))
            assert got.shape == want.shape
            assert torch.equal(nonzero(got), nonzero(want))
            limit = 1e-12 if dtype == torch.float64 else 1e-6
            assert (got - want).abs().max() <= limit * want.abs().max()
            assert scene == "background" or bool((want != 0).any())
