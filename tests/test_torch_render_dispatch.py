"""``render``'s dispatch between kernel R1 and the plain version, on the CPU.

CPU tensors, and ``impl="plain"`` on any device, take the plain version
(``ops/render.py``: ``_render_fwd_math``, ``_render_bwd_math``) and launch
no kernel; a CUDA tensor under ``impl="auto"`` launches R1 or raises. The
wrapper's checks refuse, before any build or launch, what R1 does not
take. No card is needed: R1's arithmetic is held to the plain version by
``tests/test_torch_render_kernel.py`` (its source compiled for the host)
and, on the card, by ``tests/test_torch_kernels.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch import _build, tracing  # noqa: E402
from drtk_tpu_torch.ops import render as rd  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread, render_case  # noqa: E402,F401


def _unreachable(*args, **kwargs):
    raise AssertionError("reached the kernel build or launch")


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors, impl "auto" and "plain" give the plain version's
    images and gradient, build and look up nothing, and launch no R1."""
    monkeypatch.setattr(_build, "entry", _unreachable)
    monkeypatch.setattr(_build, "load", _unreachable)
    c = render_case("band", torch.float64)
    want_depth, want_bary = rd._render_fwd_math(c["v"], c["vi"], c["index"], "plain", c["y_offset"])
    want_grad = rd._render_bwd_math(c["v"], c["vi"], c["index"], c["grad_depth"], c["grad_bary"], "plain",
                                    c["y_offset"])
    tt.reset_kernel_launch_counts()
    for impl in ("auto", "plain"):
        v = c["v"].clone().requires_grad_()
        depth, bary = tt.render(v, c["vi"], c["index"], impl=impl, y_offset=c["y_offset"])
        assert torch.equal(depth, want_depth) and torch.equal(bary, want_bary)
        (grad,) = torch.autograd.grad((depth, bary), v, (c["grad_depth"], c["grad_bary"]))
        assert torch.equal(grad, want_grad)
    assert tt.kernel_launch_counts()["R1 render"] == 0
    assert set(tt.kernel_launch_counts().values()) == {0}


@pytest.mark.parametrize("impl, device, takes", [
    ("auto", "cuda", True),
    ("auto", "cpu", False),
    ("plain", "cuda", False),
    ("plain", "cpu", False),
])
def test_dispatch_rule(impl, device, takes):
    """R1 takes CUDA tensors under impl="auto"; the rule reads only the
    impl and the device."""
    assert rd._takes_r1(impl, torch.device(device)) is takes


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_unknown_impl_raises(device):
    with pytest.raises(ValueError, match="impl"):
        rd._takes_r1("fast", torch.device(device))
    if device == "cpu":
        c = render_case("soup", torch.float32)
        with pytest.raises(ValueError, match="impl"):
            tt.render(c["v"], c["vi"], c["index"], impl="fast")


def _small():
    v = torch.zeros((2, 3, 3))
    vi = torch.zeros((2, 1, 3), dtype=torch.int32)
    idx = torch.zeros((2, 4, 5), dtype=torch.int32)
    return v, vi, idx


def test_wrapper_refuses_cpu_tensors_and_wrong_dtypes():
    """``_r1_cuda`` refuses, without a card: a CPU tensor, vertices of a
    dtype R1 has no entry for, an int64 index or vi, cotangents of another
    dtype than the vertices."""
    v, vi, idx = _small()
    with pytest.raises(ValueError, match="CUDA device"):
        rd._r1_cuda(v, vi, idx, 0)
    with pytest.raises(ValueError, match="CUDA device"):
        rd._r1_cuda(v, vi, idx, 0, (torch.zeros((2, 4, 5)), None))
    with pytest.raises(TypeError, match="no kernel"):
        rd._r1_cuda(v.half(), vi, idx, 0)
    with pytest.raises(TypeError, match="no kernel"):
        rd._r1_cuda(v.long(), vi, idx, 0)
    with pytest.raises(TypeError, match="int32"):
        rd._r1_cuda(v, vi, idx.long(), 0)
    with pytest.raises(TypeError, match="int32"):
        rd._r1_cuda(v, vi.long(), idx, 0)
    with pytest.raises(TypeError, match="cotangents"):
        rd._r1_cuda(v, vi, idx, 0, (None, torch.zeros((2, 3, 4, 5), dtype=torch.float64)))


def test_wrapper_refuses_shapes_and_layouts_r1_does_not_take():
    """``_r1_launch`` refuses, before the launch: a non-contiguous index,
    v and vi whose batch is not the index's, cotangents of other shapes,
    more batches than the grid's y extent takes and 32-bit offsets
    passed."""
    v, vi, idx = _small()
    with pytest.raises(ValueError, match="contiguous"):
        rd._r1_launch(_unreachable, None, v, vi, idx.transpose(1, 2), 0)
    with pytest.raises(ValueError, match="contiguous"):
        rd._r1_launch(_unreachable, None, v, vi, torch.zeros((2, 4, 10), dtype=torch.int32)[..., ::2], 0)
    with pytest.raises(ValueError, match="v \\[N, V, 3\\]"):
        rd._r1_launch(_unreachable, None, v[:1], vi, idx, 0)
    with pytest.raises(ValueError, match="v \\[N, V, 3\\]"):
        rd._r1_launch(_unreachable, None, v, vi[..., :2], idx, 0)
    with pytest.raises(ValueError, match="grad_depth"):
        rd._r1_launch(_unreachable, None, v, vi, idx, 0, (torch.zeros((2, 5, 4)), None))
    with pytest.raises(ValueError, match="grad_bary"):
        rd._r1_launch(_unreachable, None, v, vi, idx, 0, (None, torch.zeros((2, 1, 4, 5))))
    big_n = torch.zeros((), dtype=torch.int32).expand(2**16, 1, 1).contiguous()
    with pytest.raises(ValueError, match="65535"):
        rd._r1_launch(_unreachable, None, torch.zeros(()).expand(2**16, 3, 3), vi[:1].expand(2**16, -1, -1),
                      big_n, 0)
    with pytest.raises(ValueError, match="32-bit"):
        rd._r1_launch(_unreachable, None, torch.zeros(()).expand(2, 2**30, 3), vi, idx, 0)


def test_wrapper_reads_a_shared_vi_in_place_and_copies_strided_rows():
    """An expanded vi (batch stride 0) and v keep their storage; v whose
    rows are not contiguous is copied; the launch gets the batch strides."""
    v, vi, idx = _small()
    seen = {}

    def entry(direction):
        def fn(v_ptr, vi_ptr, idx_ptr, depth_ptr, bary_ptr, shape, stream):
            seen.update(v_ptr=v_ptr, vi_ptr=vi_ptr, v_sn=shape._obj.v_sn, vi_sn=shape._obj.vi_sn)
            return 0
        assert direction == 0
        return fn

    shared = vi[:1].expand(2, -1, -1)
    rd._r1_launch(entry, None, v, shared, idx, 0)
    assert seen == {"v_ptr": v.data_ptr(), "vi_ptr": shared.data_ptr(), "v_sn": 9, "vi_sn": 0}
    strided = torch.zeros((2, 3, 6))[..., ::2]
    rd._r1_launch(entry, None, strided, vi, idx, 0)
    assert seen["v_ptr"] != strided.data_ptr() and seen["v_sn"] == 9


def test_build_lists_r1_and_binds_its_entries():
    """``_build.SOURCES`` names csrc/render.cu, which defines every C entry
    the wrapper binds (and the error string ``_build.check`` reads); R1 is
    among the traced kernels."""
    assert "render" in _build.SOURCES
    src = (_build.CSRC / "render.cu").read_text()
    for name in [*(s for pair in rd._C_ENTRY.values() for s in pair), "drtk_cuda_error_string"]:
        assert f" {name}(" in src, name
    assert set(rd._C_ENTRY) == {torch.float32, torch.float64}
    assert "R1 render" in tracing.KERNELS


@pytest.mark.parametrize("case", ["soup", "band", "clamps"])
def test_modeled_atomics_count_the_warp_runs(case):
    """chip_smoke's model of R1's backward atomics against a loop over each
    warp's 32 pixels of a row: nine adds per run of equal clamped
    foreground faces (combined), nine per foreground pixel (per pixel)."""
    import chip_smoke

    idx = render_case(case, torch.float32)["index"]
    n_faces = int(idx.max()) - 1  # some indices past F - 1, clamped
    runs = pixels = 0
    for row in idx.reshape(-1, idx.shape[-1]).tolist():
        for x0 in range(0, len(row), 32):
            prev = None
            for f in row[x0:x0 + 32]:
                face = min(f, n_faces - 1) if f >= 0 else -1
                runs += face >= 0 and face != prev
                pixels += face >= 0
                prev = face
    assert chip_smoke.modeled_render_atomics(idx, n_faces) == {"combined": 9 * runs, "per_pixel": 9 * pixels}
    assert 0 < runs < pixels
