"""Kernel M1, bilinear ``mipmap_grid_sample`` forward and backward, on the CPU.

M1 (``drtk_tpu_torch/csrc/mipmap_sample.cu``) runs only on the card; on CPU
tensors, and for bicubic or ``impl="plain"``, ``mipmap_grid_sample`` runs its
composite path (atlas, quad table, tap tensors; ``tests/test_torch_mipmap.py``
holds that to the JAX package). Here M1's own source, compiled for the host
by g++ against the stand-in ``cuda_runtime.h`` (``tests/cuda_host/``, as
``tests/test_torch_edge_grad_kernel.py`` compiles E1), is launched through
the wrapper's own launch code and held to the composite on the same inputs:
the kernel's arithmetic, indexing, windows and atomics, not the card's
compiler. The card tests (``tests/test_torch_kernels.py``, ``-m cuda``) hold
M1 on the card to the composite.

The cases cover every padding mode, ``clip_grad`` and ``force_max_aniso``
either way, ``max_aniso`` 1, 2 and 4, one level, four halving levels and a
pyramid that does not halve (a later level taller than the one before);
grids that leave the texture, pixels on exact clamp bounds of levels 0 and 1
(ties that halve the grid gradient; the reflection fold's centre), pixels
whose cotangent is 0 in every channel, and footprints too wide for a block's
shared-memory window (the global-atomic fallback).

Tolerances: float32, 1e-6 of the largest summed magnitude of each output
(the forward: the composite on the levels' magnitudes; a level's gradient:
the composite's on the cotangent's magnitudes, every weight being
non-negative; the grid's gradient: the largest sum over channels of the
cotangent's magnitude, times the largest texel magnitude, times the largest
level side, which bounds the sum of its terms' magnitudes). The kernel
computes every tap coordinate and weight in the composite's order with
separately rounded operations, so floors and ties agree; what differs is the
order of the sums over taps, channels and corners and of the atomics, which
add in the order the threads run. float64: 1e-12.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch import _build, tracing  # noqa: E402
from drtk_tpu_torch.ops import mipmap_grid_sample as mm  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401

H, W = 8, 32  # one 32 x 8 tile of M1
PYRAMIDS = {
    "one level": [(16, 24)],
    "four levels": [(32, 64), (16, 32), (8, 16), (4, 8)],  # power-of-two sides: exact clamp bounds at levels 0, 1
    "not halving": [(20, 28), (11, 13), (12, 6)],
}


@pytest.fixture(scope="module")
def m1_on_the_host(tmp_path_factory):
    """M1's C entries from csrc/mipmap_sample.cu compiled for the host, as
    the wrapper's ``entry(direction)`` by dtype."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    src, launches = re.subn(
        r"(\w+<[^<>]*>)<<<([^,]+),\s*([^,]+),[^>]*>>>\((\w+)\);", r"drtk_host_launch(\2, \3, [&] { \1(\4); });",
        (_build.CSRC / "mipmap_sample.cu").read_text(),
    )
    assert launches == 2
    out = tmp_path_factory.mktemp("m1_host")
    (out / "mipmap_sample_host.cpp").write_text(src)
    include = Path(__file__).resolve().parent / "cuda_host"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", f"-I{include}",
         "-o", str(out / "libmipmap_sample_host.so"), str(out / "mipmap_sample_host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(out / "libmipmap_sample_host.so"))
    entries = {}
    for dtype, symbols in mm._C_ENTRY.items():
        fns = [getattr(lib, symbol) for symbol in symbols]
        for fn, argtypes in zip(fns, mm._ARGTYPES):
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[dtype] = lambda direction, fns=fns: fns[direction]
    return entries


def _case(sizes, max_aniso, grid="smooth", n=1, h=H, w=W, dtype=torch.float64, seed=0):
    """Levels of ``sizes``, grid, Jacobian and cotangent from a seed. The grid: a ramp
    over [-1.3, 1.3] with jitter ("smooth": neighbouring pixels sample
    neighbouring texels) or uniform in [-1.2, 1.2] ("scattered"); the
    Jacobian log-uniform in scale (magnification to minification past the
    last level) and direction. Row 0 holds pixels on exact clamp bounds of
    level 0 (a zero Jacobian: one tap, level 0) and row 1 on those of level 1
    (u fixed, v stepping, lambda = log2(3)); pixels 0-4 of row 2 have a zero
    cotangent."""
    rng = np.random.RandomState(seed)
    levels = [rng.randn(n, 3, lh, lw) for lh, lw in sizes]
    if grid == "smooth":
        gy, gx = np.meshgrid(np.linspace(-1.3, 1.3, h), np.linspace(-1.3, 1.3, w), indexing="ij")
        uv = np.stack([gx, gy], -1)[None].repeat(n, 0) + 0.01 * rng.randn(n, h, w, 2)
    else:
        uv = rng.uniform(-1.2, 1.2, (n, h, w, 2))
    scale = np.exp(rng.uniform(np.log(1e-3), np.log(1.0), (n, h, w, 1, 1)))
    jac = rng.randn(n, h, w, 2, 2) * scale
    (h0, w0), (h1, w1) = sizes[0], sizes[min(1, len(sizes) - 1)]
    bounds = [(-1.0, 1.0 / h0 - 1.0), (1.0 / w0 - 1.0, -1.0), (1.0 - 1.0 / w0, 1.0 - 1.0 / h0),
              (1.0 / w0 - 1.0, 1.0 - 1.0 / h0), (1.0, 1.0), (1.0 - 1.0 / w0, 0.1)]
    for i, b in enumerate(bounds):
        uv[:, 0, i], jac[:, 0, i] = b, 0.0
    for i, u in enumerate([1.0 / w1 - 1.0, 1.0 - 1.0 / w1, -1.0]):
        uv[:, 1, i] = (u, 0.2 * i - 0.2)
        jac[:, 1, i] = [[0.0, 3.0 * max_aniso / h0], [1e-7, 0.0]]
    cot = rng.randn(n, 3, h, w)
    cot[:, :, 2, :5] = 0.0
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dtype) for x in (*levels, uv, jac, cot)]
    return t[: len(levels)], t[-3], t[-2], t[-1]


def _composite(levels, grid, jac, cot, opts):
    """The composite path's output and its gradients to the grid and the
    levels (impl="plain")."""
    max_aniso, padding_mode, force_max_aniso, clip_grad = opts
    lv = [x.clone().requires_grad_() for x in levels]
    gr = grid.clone().requires_grad_()
    out = tt.mipmap_grid_sample(lv, gr, jac, max_aniso, "bilinear", padding_mode, force_max_aniso=force_max_aniso,
                                clip_grad=clip_grad, impl="plain")
    return (out.detach(), *torch.autograd.grad(out, [gr, *lv], cot))


def _hold_to_composite(entry, levels, grid, jac, cot, opts):
    """M1 through the wrapper's launch code against the composite; returns
    its counts (corner adds to a window, to the fallback)."""
    limit = 1e-12 if grid.dtype == torch.float64 else 1e-6
    out, grad_grid, *grad_levels = _composite(levels, grid, jac, cot, opts)
    magnitude = _composite([x.abs() for x in levels], grid, jac, cot.abs(), opts)
    got = mm._m1_launch(entry, None, levels, grid, jac, opts)
    counts = torch.zeros(2, dtype=torch.int64)
    got_grid, got_levels = mm._m1_launch(entry, None, levels, grid, jac, opts, cot, True, counts)
    assert got.shape == out.shape and got.dtype == out.dtype
    assert bool(torch.isfinite(out).all()) and bool((out != 0).any())
    assert (got - out).abs().max() <= limit * magnitude[0].abs().max()
    grid_bound = cot.abs().sum(1).max() * max(x.abs().max() for x in levels) * max(max(x.shape[2:]) for x in levels)
    assert got_grid.shape == grad_grid.shape and bool((grad_grid != 0).any())
    assert (got_grid - grad_grid).abs().max() <= limit * grid_bound
    for i, (g, want, summed) in enumerate(zip(got_levels, grad_levels, magnitude[2:])):
        assert g.shape == want.shape, i
        assert (g - want).abs().max() <= limit * summed.max(), i
    assert bool((grad_levels[0] != 0).any())
    return counts.tolist()


@pytest.mark.parametrize("pyramid", list(PYRAMIDS))
@pytest.mark.parametrize("max_aniso", [1, 2, 4])
@pytest.mark.parametrize("force_max_aniso", [False, True])
@pytest.mark.parametrize("clip_grad", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_kernel_source_on_the_host_matches_composite(m1_on_the_host, padding_mode, clip_grad, force_max_aniso,
                                                     max_aniso, pyramid):
    """Float32, one tile: forward values, the grid's gradient and every
    level's gradient; the block's windows take the corner adds."""
    levels, grid, jac, cot = _case(PYRAMIDS[pyramid], max_aniso, dtype=torch.float32)
    opts = (max_aniso, padding_mode, force_max_aniso, clip_grad)
    to_window, _ = _hold_to_composite(m1_on_the_host[torch.float32], levels, grid, jac, cot, opts)
    assert to_window > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_wide_footprints_take_the_fallback(m1_on_the_host, padding_mode, dtype):
    """Scattered uvs on a 64 x 96 base level: a block's footprint outgrows
    its window, and its corners go to device memory with global atomics;
    the sums agree all the same."""
    levels, grid, jac, cot = _case([(64, 96), (32, 48)], 4, grid="scattered", dtype=dtype, seed=1)
    _, to_fallback = _hold_to_composite(m1_on_the_host[dtype], levels, grid, jac, cot, (4, padding_mode, False, True))
    assert to_fallback > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batches_partial_tiles_and_strided_inputs(m1_on_the_host, dtype):
    """Two batches of 20 x 40 pixels (partial tiles in both directions),
    expanded levels (batch stride 0, read in place), a grid and a cotangent
    read through their strides (a movedim view, as avatar4k_band's uv), and
    a pixel with an infinite Jacobian, which reads NaN as in the
    composite."""
    levels, grid, jac, cot = _case(PYRAMIDS["not halving"], 2, n=2, h=20, w=40, dtype=dtype, seed=2)
    levels = [x[:1].expand(2, -1, -1, -1) for x in levels]
    grid = grid.movedim(-1, 1).contiguous().movedim(1, -1)
    cot = cot.movedim(1, -1).contiguous().movedim(-1, 1)
    assert not grid.is_contiguous() and not cot.is_contiguous() and levels[0].stride(0) == 0
    _hold_to_composite(m1_on_the_host[dtype], levels, grid, jac, cot, (2, "border", False, True))
    jac = jac.clone()
    jac[1, 7, 9] = float("inf")
    opts = (2, "reflection", False, False)
    got = mm._m1_launch(m1_on_the_host[dtype], None, levels, grid, jac, opts)
    got_grid, _ = mm._m1_launch(m1_on_the_host[dtype], None, levels, grid, jac, opts, cot)
    want, want_grid, *_ = _composite(levels, grid, jac, cot, opts)
    assert bool(got[1, :, 7, 9].isnan().all()) and bool(want[1, :, 7, 9].isnan().all())
    assert bool(got_grid[1, 7, 9].isnan().all()) and bool(want_grid[1, 7, 9].isnan().all())
    assert int(got.isnan().sum()) == 3 and int(got_grid.isnan().sum()) == 2


def test_levels_not_asked_for_are_not_computed(m1_on_the_host):
    """``need_levels=False`` (no level requires a gradient): the grid's
    gradient alone, the same as with the levels."""
    levels, grid, jac, cot = _case(PYRAMIDS["four levels"], 2, dtype=torch.float32)
    opts = (2, "zeros", False, False)
    counts = torch.zeros(2, dtype=torch.int64)
    alone, none = mm._m1_launch(m1_on_the_host[torch.float32], None, levels, grid, jac, opts, cot, False, counts)
    both, _ = mm._m1_launch(m1_on_the_host[torch.float32], None, levels, grid, jac, opts, cot)
    assert none == [None] * 4 and counts.tolist() == [0, 0]
    assert torch.equal(alone, both)


def test_cpu_tensors_never_reach_the_build(monkeypatch):
    """With CPU tensors, bicubic or impl="plain", mipmap_grid_sample runs the
    composite: nothing is built or looked up, and M1's count stays 0."""

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "entry", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    levels, grid, jac, cot = _case(PYRAMIDS["four levels"], 2, dtype=torch.float32)
    tt.reset_kernel_launch_counts()
    for mode, impl in (("bilinear", "auto"), ("bicubic", "auto"), ("bilinear", "plain")):
        lv = [x.clone().requires_grad_() for x in levels]
        gr = grid.clone().requires_grad_()
        out = tt.mipmap_grid_sample(lv, gr, jac, 2, mode, "border", impl=impl)
        grads = torch.autograd.grad(out, [gr, *lv], cot)
        assert all(bool((g != 0).any()) for g in grads[:2])
    assert set(tt.kernel_launch_counts().values()) == {0}


def _like(device, dtype):
    return SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("mode, impl, devices, dtypes, takes", [
    ("bilinear", "auto", "cuda", (torch.float32,) * 3, True),
    ("bilinear", "auto", "cuda", (torch.float64,) * 3, True),
    ("bicubic", "auto", "cuda", (torch.float32,) * 3, False),
    ("bilinear", "plain", "cuda", (torch.float32,) * 3, False),
    ("bilinear", "auto", "cpu", (torch.float32,) * 3, False),
    ("bilinear", "auto", "cuda", (torch.float32, torch.float32, torch.float64), False),
    ("bilinear", "auto", "cuda", (torch.bfloat16,) * 3, False),
])
def test_dispatch_rule(mode, impl, devices, dtypes, takes):
    """M1 takes bilinear, impl="auto", CUDA tensors of one dtype it has an
    entry for; everything else keeps the composite (the rule reads only the
    call's arguments and the tensors' device and dtype)."""
    grid, jac, level = (_like(devices, d) for d in dtypes)
    assert mm._takes_m1([level, level], grid, jac, mode, impl) is takes


def test_wrapper_refuses_what_m1_does_not_take():
    """Before any build or launch: shapes that do not agree, an empty level,
    more batches than the grid's y extent takes, and 32-bit offsets
    passed."""

    def entry(direction):
        raise AssertionError("reached the launch")

    levels, grid, jac, _ = _case(PYRAMIDS["one level"], 1, dtype=torch.float32)
    opts = (1, "zeros", False, False)
    with pytest.raises(ValueError, match="vt_dxdy_img"):
        mm._m1_launch(entry, None, levels, grid, jac[..., 0], opts)
    with pytest.raises(ValueError, match="levels"):
        mm._m1_launch(entry, None, [levels[0][:, :2], levels[0]], grid, jac, opts)
    with pytest.raises(ValueError, match="levels"):
        mm._m1_launch(entry, None, [levels[0][:, :, :0]], grid, jac, opts)
    with pytest.raises(ValueError, match="cotangent"):
        mm._m1_launch(entry, None, levels, grid, jac, opts, torch.zeros(1, 2, H, W))
    big = torch.zeros(()).expand(2**16, 8, 8, 2)
    with pytest.raises(ValueError, match="65535"):
        mm._m1_launch(entry, None, [torch.zeros(()).expand(2**16, 3, 4, 4)], big, big[..., None].expand(
            -1, -1, -1, -1, 2), opts)
    with pytest.raises(ValueError, match="32-bit"):
        mm._m1_launch(entry, None, [torch.zeros(()).expand(1, 3, 2**15, 2**15)], grid, jac, opts)


def test_build_lists_m1_and_binds_its_entries():
    """``_build.SOURCES`` names csrc/mipmap_sample.cu, which defines every C
    entry the wrapper binds (and the error string ``_build.check`` reads);
    M1 is among the traced kernels."""
    assert "mipmap_sample" in _build.SOURCES
    src = (_build.CSRC / "mipmap_sample.cu").read_text()
    for name in [*(s for pair in mm._C_ENTRY.values() for s in pair), "drtk_cuda_error_string"]:
        assert f" {name}(" in src, name
    assert "M1 mipmap_sample" in tracing.KERNELS
