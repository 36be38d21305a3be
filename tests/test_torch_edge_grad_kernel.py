"""Kernel E1's function, the edge_grad backward, on the CPU.

E1 (``drtk_tpu_torch/csrc/edge_grad.cu``) runs only on the card. On CPU
tensors :func:`~drtk_tpu_torch.ops.edge_grad.edge_grad_to_verts` runs its
plain version, ``_verts_plain`` (the stencil table, ``_stencil_plain``'s
per-pixel ``bary x g`` rows, B3's plain scatter to faces, ``index_add_`` to
vertices), and ``edge_grad_image`` runs ``_stencil_plain``'s image
gradient. Here the plain versions are held to the JAX package on the same
numpy inputs: the vertex gradient to the VJP of ``drtk_tpu.
edge_grad_estimator`` (``_edge_grad_core_bwd``), a band with its halo row to
JAX's tile backward reduced to vertices, the image to ``edge_grad_image``;
and the dispatch: a CPU tensor never reaches the build. The card tests
(``tests/test_torch_kernels.py``, ``-m cuda``) hold E1 to its plain
version; here E1's own source, compiled for the host by g++ against a
stand-in ``cuda_runtime.h`` (``tests/cuda_host/``), is held to it too: the
kernel's arithmetic, indexing and atomics, not the card's compiler.

Tolerances: float32, 1e-4 of the largest magnitude, the gradient contract
of ``tests/test_torch_backward.py`` (XLA contracts products into FMAs on
the CPU, the port does not, and JAX's B3 sums float32 rows through a
three-term bf16 split; the scenes are in general position, so that no
pixel centre sits on a coverage boundary where that rounding decides the
class). float64: 1e-10. Out-of-range faces and indices are the port's own
rule (clamped, as every gather of the port clamps them; JAX's scatters drop
them), so they are held to the plain version, not to JAX. The host build
of E1 against the plain version: image mode, the same nonzero pixels and
values within 1e-6 of the largest magnitude (the channel sum may round in
another order than torch's); verts mode, values within 1e-6 of the largest
summed magnitude, the largest sum of the terms' magnitudes at a vertex
(the kernel's atomics, in the order the threads run, and the plain
version's two ``index_add_`` passes, each pixel's rows into a face row and
the face rows into vertices, add the same terms in different orders; on
the soup the vertex sums cancel 7-fold, and the float32 plain version is
itself 1.2e-6 of the largest magnitude from float64, where the kernel is
4.5e-7), not the nonzero vertices (a sum may cancel to exactly 0 in one
order). float64: 1e-12. Bands added into one accumulator against the full
frame: float64, 1e-12.
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
from tests.test_torch_backward import _assert_grad_close, _t  # noqa: E402
from tests.test_torch_kernels import (  # noqa: E402,F401
    E1_SCENES, E1_VIEWPORTS, _e1_image_plain, _e1_scene, _e1_viewport, _one_torch_thread,
)
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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_dp_dr", [1e4, 0.0])
@pytest.mark.parametrize("scene", list(SCENES))
def test_plain_image_mode_matches_jax(scene, max_dp_dr, dtype):
    """Image mode (``edge_grad_image`` on CPU tensors) against
    ``drtk_tpu.ops.edge_grad.edge_grad_image``."""
    v, vi, idx, _, img, g = _case(scene, dtype)
    got = tt.edge_grad_image(_t(v), _t(vi), _t(img), _t(idx), _t(g), max_dp_dr)
    want = jax.jit(lambda *a: jax_edge_grad_image(*a, max_dp_dr))(
        jnp.asarray(v), jnp.asarray(vi), jnp.asarray(img), jnp.asarray(idx), jnp.asarray(g))
    want = np.asarray(want)
    assert got.dtype == _t(v).dtype and np.abs(want).max() > 0
    _assert_grad_close(to_numpy(got), want, rel=1e-4 if dtype == np.float32 else 1e-10)


VERTS_SCENES = ["grid_offset", "intersecting", "near_miss", "batch2_vi"]


def _verts_case(scene, dtype):
    """A scene of ``_e1_scene`` (index, bary, image and cotangent from the
    port and a seed) as numpy arrays in ``dtype``, for both packages."""
    v, vi, idx, img, g, bary = (to_numpy(t) for t in _e1_scene(scene))
    return v.astype(dtype), vi, idx, img.astype(dtype), g.astype(dtype), bary.astype(dtype)


def _jax_verts(v, vi, idx, img, g, bary, max_dp_dr):
    """The JAX package's vertex gradient: the VJP of ``edge_grad_estimator``
    to ``v`` at the cotangent ``g``."""

    def pull(v, gg):
        _, vjp = jax.vjp(lambda v: dt.edge_grad_estimator(
            v, jnp.asarray(vi), jnp.asarray(bary), jnp.asarray(img), jnp.asarray(idx), max_dp_dr=max_dp_dr), v)
        return vjp(gg)[0]

    return np.asarray(jax.jit(pull)(jnp.asarray(v), jnp.asarray(g)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_dp_dr", [1e4, 0.0])
@pytest.mark.parametrize("scene", VERTS_SCENES)
def test_plain_verts_match_jax(scene, max_dp_dr, dtype):
    """``edge_grad_to_verts`` on CPU tensors against the JAX package's
    vertex gradient: a textured-like grid (moved off the pixel centres),
    two triangles whose depths cross (the intersection class),
    the near-miss scene and a batch of 2 with a face list each."""
    v, vi, idx, img, g, bary = _verts_case(scene, dtype)
    got = eg.edge_grad_to_verts(_t(v), _t(vi), _t(idx), _t(img), _t(g), _t(bary), max_dp_dr)
    want = _jax_verts(v, vi, idx, img, g, bary, max_dp_dr)
    assert got.dtype == _t(v).dtype and np.abs(want).max() > 0
    _assert_grad_close(to_numpy(got), want, rel=1e-4 if dtype == np.float32 else 1e-10)


def _bands(h, n_bands=4):
    """(y0, rows) of ``n_bands`` bands, each with the next band's first row
    (none below the last band), as the banded backward slices them."""
    hb = h // n_bands
    return [(y0, slice(y0, y0 + hb + 1)) for y0 in range(0, h, hb)]


def _image_grad_to_verts(gv, idx, bary, vi, num_v):
    """An image gradient [N, 3, H, W] reduced to [N, V, 3] in float64 as
    ``_edge_grad_core_bwd`` reduces it: bary x g at foreground pixels, to
    the pixel's face, to its vertices."""
    out = np.zeros((idx.shape[0], num_v, 3))
    for b in range(idx.shape[0]):
        fg = idx[b] >= 0
        f = np.minimum(idx[b][fg], vi.shape[1] - 1)
        g = np.moveaxis(gv[b], 0, -1)[fg].astype(np.float64)
        w = np.moveaxis(bary[b], 0, -1)[fg].astype(np.float64)
        for k in range(3):
            np.add.at(out[b], vi[b][f, k], w[:, k : k + 1] * g)
    return out


@pytest.mark.parametrize("band", range(4))
def test_plain_verts_on_a_band_match_jax(band):
    """A band and its halo row (``y_offset``, ``full_height``) through
    ``edge_grad_to_verts`` against JAX's tile backward
    (``_edge_grad_backward(..., y_offset, full_height)``) of the same rows,
    reduced to vertices."""
    v, vi, idx, bary, img, g = _case("soup_batch2")
    vib = np.broadcast_to(vi, (v.shape[0],) + vi.shape)
    h = idx.shape[1]
    y0, rows = _bands(h)[band]
    img_b, g_b, bary_b, idx_b = img[:, :, rows], g[:, :, rows], bary[:, :, rows], idx[:, rows]
    got = eg.edge_grad_to_verts(_t(v), _t(vib), _t(idx_b), _t(img_b), _t(g_b), _t(bary_b), 1e4, y0, h)
    gv = jax.jit(jax_edge_grad_backward, static_argnums=(5, 6, 7))(
        jnp.asarray(v), jnp.asarray(vib), jnp.asarray(img_b), jnp.asarray(idx_b), jnp.asarray(g_b), 1e4, y0, h)
    want = _image_grad_to_verts(np.asarray(gv), idx_b, bary_b, vib, v.shape[1])
    assert np.abs(want).max() > 0
    _assert_grad_close(to_numpy(got), want)


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


@pytest.mark.parametrize("impl", ["plain", "host kernel"])
@pytest.mark.parametrize("max_dp_dr", [1e4, 0.0])
@pytest.mark.parametrize("scene", list(SCENES))
def test_bands_add_into_one_accumulator(e1_on_the_host, scene, max_dp_dr, impl):
    """Four bands, each with its halo row, added into one accumulator (the
    plain version through ``edge_grad_to_verts(..., out=)``, or E1's source
    on the host through the wrapper's launch code): the full frame's vertex
    gradient, in float64 to 1e-12."""
    v, vi, idx, bary, img, g = (_t(a) for a in _case(scene, np.float64))
    vi = vi.expand(v.shape[0], -1, -1) if vi.ndim == 2 else vi
    h = idx.shape[1]
    acc = None
    for y0, rows in _bands(h):
        args = (v, vi, idx[:, rows], img[:, :, rows], g[:, :, rows], bary[:, :, rows], max_dp_dr, y0, h)
        if impl == "plain":
            out = eg.edge_grad_to_verts(*args, out=acc)
        else:
            out = eg._launch(lambda: e1_on_the_host[torch.float64], None, *args, acc)
        assert acc is None or out is acc
        acc = out
    want = eg.edge_grad_to_verts(v, vi, idx, img, g, bary, max_dp_dr)
    assert bool((want != 0).any())
    assert (acc - want).abs().max() <= 1e-12 * want.abs().max()


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
    """Outside the card, the wrappers refuse before any build: a CPU
    tensor, an unknown impl, a dtype without a kernel, an int64 index or
    vi."""
    v = torch.zeros((1, 3, 3))
    vi = torch.zeros((1, 1, 3), dtype=torch.int32)
    idx = torch.zeros((1, 3, 5), dtype=torch.int32)
    img = torch.zeros((1, 2, 3, 5))
    bary = torch.zeros((1, 3, 3, 5))
    with pytest.raises(ValueError, match="CUDA device"):
        eg._e1_cuda(v, vi, idx, img, img, bary, 1e4)
    with pytest.raises(ValueError, match="impl"):
        eg.edge_grad_to_verts(v, vi, idx, img, img, bary, 1e4, impl="fast")
    with pytest.raises(ValueError, match="impl"):
        tt.edge_grad_image(v, vi, img, idx, img, impl="fast")
    with pytest.raises(TypeError, match="no kernel"):
        eg._e1_cuda(v.half(), vi, idx, img, img, bary, 1e4)
    with pytest.raises(TypeError, match="int32"):
        eg._e1_cuda(v, vi, idx.long(), img, img, bary, 1e4)
    with pytest.raises(TypeError, match="int32"):
        eg._e1_cuda(v, vi.long(), idx, img, img, None, 1e4)


def test_build_lists_e1_and_binds_its_entries():
    """``_build.SOURCES`` names csrc/edge_grad.cu, which defines every C
    entry the wrapper binds (and the error string ``_build.check`` reads)."""
    assert "edge_grad" in _build.SOURCES
    src = (_build.CSRC / "edge_grad.cu").read_text()
    for name in [*eg._C_ENTRY.values(), "drtk_cuda_error_string"]:
        assert f" {name}(" in src, name
    assert set(eg._C_ENTRY) == {torch.float32, torch.float64}


@pytest.mark.parametrize("mode", ["verts", "image"])
@pytest.mark.parametrize("viewport", E1_VIEWPORTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scene", E1_SCENES)
def test_kernel_source_on_the_host_matches_plain(e1_on_the_host, scene, dtype, viewport, mode):
    """E1's source, run on the host through the wrapper's launch code,
    against the plain version on the card tests' scenes and viewports (the
    frame; a band and its halo row; the last band), at max_dp_dr 1e4 and 0.
    Verts mode adds into a fresh accumulator of zeros."""
    v, vi, idx, img, g, bary = _e1_scene(scene)
    v, img, g, bary = (t.to(dtype) for t in (v, img, g, bary))
    y0, frame_h, idx, img, g, bary = _e1_viewport(viewport, idx, img, g, bary)
    limit = 1e-12 if dtype == torch.float64 else 1e-6
    for max_dp_dr in (1e4, 0.0):
        if mode == "verts":
            args = (v, vi, idx, img, g, bary, max_dp_dr, y0, frame_h)
            got = eg._launch(lambda: e1_on_the_host[dtype], None, *args, None)
            want = eg._verts_plain(*args)
            summed = eg._pixels_to_verts(eg._stencil_plain(eg._stencil_table(v, vi), *args[2:]).abs(), idx, vi,
                                         v.shape[1], "plain")
            assert got.shape == want.shape and got.dtype == dtype
            assert (got - want).abs().max() <= limit * summed.max()
        else:
            got = eg._launch(lambda: e1_on_the_host[dtype], None, v, vi, idx, img, g, None, max_dp_dr, y0,
                             frame_h, None)
            want = _e1_image_plain(v, vi, idx, img, g, max_dp_dr, y0, frame_h)
            assert got.shape == want.shape
            assert torch.equal((got != 0).any(1), (want != 0).any(1))
            assert (got - want).abs().max() <= limit * want.abs().max()
        assert scene == "background" or bool((want != 0).any())
