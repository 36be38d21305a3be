"""Kernel R1, ``render`` forward and backward, on the CPU.

R1 (``drtk_tpu_torch/csrc/render.cu``) runs only on the card; on CPU tensors
and with ``impl="plain"``, ``render`` runs its plain version
(``tests/test_torch_ops.py`` and ``tests/test_torch_backward.py`` hold that
to the JAX package). Here R1's own source, compiled for the host by g++
against the stand-in ``cuda_runtime.h`` (``tests/cuda_host/``, as
``tests/test_torch_edge_grad_kernel.py`` compiles E1), is launched through
the wrapper's own launch code and held to the plain version on the same
inputs: the kernel's arithmetic, indexing, warp combine and atomics, not
the card's compiler. The card tests (``tests/test_torch_kernels.py``,
``-m cuda``) hold R1 on the card to the plain version.

The cases (``tests/test_torch_kernels.py: render_case``) cover ragged
32 x 8 tiles, batches with one shared and with per-view ``vi``, indices and
vertex ids past their ends (clamped), background pixels, a row band with
``y_offset``, faces on which each epsclamp fires (den, z, depth_inv), zero
cotangents, and a cotangent left out (None: zeros).

Tolerances: the forward equals the plain version (``torch.equal``): every
operation rounds on its own in the plain version's order. The backward
agrees to 1e-5 (float32) or 1e-12 (float64) of the largest magnitude of the
plain gradient: the warp's runs and the atomics sum a vertex's pixels in
another order than the plain scatter.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from drtk_tpu_torch import _build  # noqa: E402
from drtk_tpu_torch.ops import render as rd  # noqa: E402
from tests.test_torch_kernels import (  # noqa: E402,F401
    RENDER_CASES,
    _one_torch_thread,
    render_bwd_bound,
    render_case,
)

DTYPES = [torch.float32, torch.float64]


@pytest.fixture(scope="module")
def r1_on_the_host(tmp_path_factory):
    """R1's C entries from csrc/render.cu compiled for the host, as the
    wrapper's ``entry(direction)`` by dtype."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    src, launches = re.subn(
        r"(\w+<[^<>]*>)<<<([^,]+),\s*([^,]+),[^>]*>>>\((\w+)\);", r"drtk_host_launch(\2, \3, [&] { \1(\4); });",
        (_build.CSRC / "render.cu").read_text(),
    )
    assert launches == 3
    out = tmp_path_factory.mktemp("r1_host")
    (out / "render_host.cpp").write_text(src)
    include = Path(__file__).resolve().parent / "cuda_host"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", f"-I{include}",
         "-o", str(out / "librender_host.so"), str(out / "render_host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(out / "librender_host.so"))
    entries = {}
    for dtype, symbols in rd._C_ENTRY.items():
        fns = [getattr(lib, symbol) for symbol in symbols]
        for fn, argtypes in zip(fns, rd._ARGTYPES):
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[dtype] = lambda direction, fns=fns: fns[direction]
    return entries


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", RENDER_CASES)
def test_kernel_source_on_the_host_matches_plain(r1_on_the_host, case, dtype):
    c = render_case(case, dtype)
    v, vi, index, y0 = c["v"], c["vi"], c["index"], c["y_offset"]
    depth, bary = rd._r1_launch(r1_on_the_host[dtype], None, v, vi, index, y0)
    want_depth, want_bary = rd._render_fwd_math(v, vi, index, "plain", y0)
    assert torch.equal(depth, want_depth) and torch.equal(bary, want_bary)
    assert bool((depth != 0).any())
    got = rd._r1_launch(r1_on_the_host[dtype], None, v, vi, index, y0, (c["grad_depth"], c["grad_bary"]))
    want = rd._render_bwd_math(v, vi, index, c["grad_depth"], c["grad_bary"], "plain", y0)
    render_bwd_bound(got, want, dtype, case)


@pytest.mark.parametrize("left_out", ["grad_depth", "grad_bary"])
def test_a_cotangent_left_out_reads_as_zeros(r1_on_the_host, left_out):
    c = render_case("soup", torch.float64)
    grads = {"grad_depth": c["grad_depth"], "grad_bary": c["grad_bary"]}
    zeros = {**grads, left_out: torch.zeros_like(grads[left_out])}
    got = rd._r1_launch(r1_on_the_host[torch.float64], None, c["v"], c["vi"], c["index"], 0,
                        tuple(None if k == left_out else grads[k] for k in ("grad_depth", "grad_bary")))
    want = rd._render_bwd_math(c["v"], c["vi"], c["index"], zeros["grad_depth"], zeros["grad_bary"], "plain")
    render_bwd_bound(got, want, torch.float64)


def test_strided_cotangents_and_a_shared_v(r1_on_the_host):
    """Cotangents read through their strides (a channels-last bary
    gradient, an expanded depth gradient) and one v for every view (batch
    stride 0)."""
    c = render_case("soup", torch.float64)
    n, h, w = c["index"].shape
    v = c["v"][:1].expand(n, -1, -1)
    gd = torch.full((1, 1, 1), 0.5, dtype=torch.float64).expand(n, h, w)
    gb = c["grad_bary"].permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    depth, bary = rd._r1_launch(r1_on_the_host[torch.float64], None, v, c["vi"], c["index"], 0)
    want_depth, want_bary = rd._render_fwd_math(v, c["vi"], c["index"], "plain")
    assert torch.equal(depth, want_depth) and torch.equal(bary, want_bary)
    got = rd._r1_launch(r1_on_the_host[torch.float64], None, v, c["vi"], c["index"], 0, (gd, gb))
    want = rd._render_bwd_math(v, c["vi"], c["index"], gd, gb, "plain")
    render_bwd_bound(got, want, torch.float64)
