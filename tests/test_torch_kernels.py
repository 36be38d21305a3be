"""The CUDA kernels of drtk_tpu_torch against their plain PyTorch versions.

Imports only torch, numpy and the port, so it runs on a machine without
JAX. Tests marked ``cuda`` need an NVIDIA GPU and nvcc and skip elsewhere:
run them on the card with ``python -m pytest tests/test_torch_kernels.py
-m cuda -q``. The unmarked tests hold, on the CPU, what surrounds the
kernels: the dispatch, the launch counts and the setup packing, the latter
against a numpy emulation of kernel B1's algorithm.

Tolerances: kernel B2 copies table rows, so it must be bit-exact
(torch.equal). Kernel B1 rounds every product and sum on its own in the
plain version's order, so it should match the plain version exactly; the
assertion still allows the rasterizer's documented tie rule (index flips
only at pixels whose two depths agree to 1e-4 relative, fewer than 1e-3 of
the pixels; depth to rtol 1e-4 / atol 1e-6).
"""

import numpy as np
import pytest
import torch

import drtk_tpu_torch as tt
from drtk_tpu_torch.ops import rasterize_cuda, segment_rows
from drtk_tpu_torch.ops.rasterize import _canvas_cull, _rasterize_plain, broadcast_vi, triangle_setup
from drtk_tpu_torch.pipeline import render_textured
from drtk_tpu_torch.scenes import entry_scene_arrays, make_scene_arrays


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run with -m cuda on the card)")
    return torch.device("cuda")


def _soup(n, num_v, num_f, h, w, seed):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.2, 1.2, (n, num_v, 2)).astype(np.float32) * np.float32([w, h])
    z = rng.uniform(3.0, 9.0, (n, num_v, 1)).astype(np.float32)
    vi = rng.randint(0, num_v, (num_f, 3)).astype(np.int32)
    return {"v": np.concatenate([xy, z], -1), "vi": vi}


SCENES = {
    "soup_batch3": (lambda: _soup(3, 64, 96, 64, 128, 1), 64, 128),
    "nonaligned": (lambda: _soup(1, 48, 64, 70, 130, 2), 70, 130),
    "grid": (lambda: make_scene_arrays(128, 256, 9), 128, 256),
    "entry": (lambda: entry_scene_arrays(h=128, w=128), 128, 128),
}


def _assert_raster_match(d_ref, i_ref, d, i):
    d_ref, i_ref, d, i = (t.detach().cpu().numpy() for t in (d_ref, i_ref, d, i))
    mism = i_ref != i
    if mism.any():
        assert mism.mean() < 1e-3, f"{mism.sum()} index mismatches"
        near_tie = np.abs(d_ref - d) <= 1e-4 * np.abs(d_ref) + 1e-6
        assert near_tie[mism].all(), "index mismatch at non-tied depth"
    np.testing.assert_allclose(d_ref, d, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# On the CPU: dispatch, launch counts, setup packing
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_without_launching():
    tt.reset_kernel_launch_counts()
    s = SCENES["soup_batch3"][0]()
    v, vi = torch.from_numpy(s["v"]), torch.from_numpy(s["vi"])
    index_img = tt.rasterize(v, vi, 64, 128)
    tt.render(v, vi, index_img)
    assert tt.kernel_launch_counts() == {"B1 rasterize": 0, "B2 gather_rows": 0}


def test_unknown_impl_raises():
    table = torch.zeros((1, 4, 3))
    idx = torch.zeros((1, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="impl"):
        segment_rows.gather_rows_by_index(table, idx, impl="fast")
    with pytest.raises(ValueError, match="impl"):
        tt.rasterize(torch.zeros((1, 3, 3)), torch.zeros((1, 3), dtype=torch.int32), 4, 4, impl="fast")


def _emulate_b1(coef, meta, h, w):
    """numpy emulation of csrc/rasterize.cu: per triangle, walk its packed
    pixel range, round each product and sum on its own in float32, and keep
    the smallest packed key (~float_bits(di) << 32) | id."""
    n, f_cnt, _ = coef.shape
    keys = np.full((n, h, w), np.iinfo(np.uint64).max, np.uint64)
    for b in range(n):
        for t in range(f_cnt):
            tl_bits, x_lo, x_hi, y_lo, y_hi = (int(x) for x in meta[b, t])
            if x_lo > x_hi or y_lo > y_hi:
                continue
            c = coef[b, t]
            px = np.arange(x_lo, x_hi + 1, dtype=np.float32)[None, :]
            py = np.arange(y_lo, y_hi + 1, dtype=np.float32)[:, None]
            e = [(c[k] * px + c[3 + k] * py) + c[6 + k] for k in range(3)]
            keep = np.ones(e[0].shape, bool)
            for k in range(3):
                keep &= (e[k] > 0) | ((e[k] == 0) & bool(tl_bits >> k & 1))
            di = (e[0] * c[9] + e[1] * c[10]) + e[2] * c[11]
            bits = di.astype(np.float32).view(np.uint32) & np.uint32(0x7FFFFFFF)
            key = ((~bits).astype(np.uint64) << np.uint64(32)) | np.uint64(t)
            win = keys[b, y_lo : y_hi + 1, x_lo : x_hi + 1]
            win[keep] = np.minimum(win[keep], key[keep])
    ids = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    covered = ids != np.uint32(0xFFFFFFFF)
    di = (~(keys >> np.uint64(32)).astype(np.uint32)).view(np.float32)
    depth = np.where(covered, np.float32(1) / np.maximum(di, np.float32(1e-8)), np.float32(0))
    return depth, np.where(covered, ids.astype(np.int32), -1)


@pytest.mark.parametrize("scene", ["soup_batch3", "nonaligned", "grid", "entry"])
def test_packed_setup_reproduces_plain_resolve(scene):
    """What kernel B1 computes from pack_setup's rows (emulated in numpy)
    equals the plain resolve bit for bit."""
    make, h, w = SCENES[scene]
    s = make()
    v = torch.from_numpy(s["v"])
    vi = broadcast_vi(torch.from_numpy(s["vi"]), v.shape[0])
    setup = triangle_setup(v, vi)
    valid = _canvas_cull(setup, h, w)
    coef, meta = rasterize_cuda.pack_setup(setup, valid, h, w)
    assert coef.shape[-1] == rasterize_cuda.SETUP_FLOATS and meta.shape[-1] == rasterize_cuda.SETUP_INTS
    depth, index = _emulate_b1(coef.numpy(), meta.numpy(), h, w)
    d_ref, i_ref = _rasterize_plain(setup, valid, h, w)
    np.testing.assert_array_equal(index, i_ref.numpy())
    np.testing.assert_array_equal(depth, d_ref.numpy())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k_dim", [6, 9, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_kernel_is_bit_exact(cuda_device, k_dim, dtype):
    rng = np.random.RandomState(k_dim)
    n, f_cnt, h, w = 2, 300, 70, 130
    table = torch.from_numpy(rng.randn(n, f_cnt, k_dim)).to(dtype)
    idx = torch.from_numpy(rng.randint(-1, f_cnt, (n, h, w)).astype(np.int32))
    idx[0, 0, :4] = torch.tensor([-5, 0, f_cnt - 1, f_cnt + 7], dtype=torch.int32)
    want = segment_rows._gather_rows_plain(table, idx)
    before = segment_rows.launches
    got = segment_rows.gather_rows_by_index(table.to(cuda_device), idx.to(cuda_device))
    torch.cuda.synchronize()
    assert segment_rows.launches == before + 1
    assert got.dtype == dtype
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["soup_batch3", "nonaligned", "grid", "entry"])
def test_rasterize_kernel_matches_plain(cuda_device, scene):
    make, h, w = SCENES[scene]
    s = make()
    v = torch.from_numpy(s["v"]).to(cuda_device)
    vi = torch.from_numpy(s["vi"]).to(cuda_device)
    before = rasterize_cuda.launches
    d, i = tt.rasterize_with_depth(v, vi, h, w)
    torch.cuda.synchronize()
    assert rasterize_cuda.launches == before + 1
    d_ref, i_ref = tt.rasterize_with_depth(v, vi, h, w, impl="plain")
    _assert_raster_match(d_ref, i_ref, d, i)


@pytest.mark.cuda
def test_render_textured_kernels_match_plain(cuda_device):
    s = make_scene_arrays(128, 256, 9)
    v, vi, vt, tex = (torch.from_numpy(s[k]).to(cuda_device) for k in ("v", "vi", "vt", "tex"))
    tt.reset_kernel_launch_counts()
    img, idx = render_textured(v, vi, vt, tex, 128, 256)
    torch.cuda.synchronize()
    assert tt.kernel_launch_counts() == {"B1 rasterize": 1, "B2 gather_rows": 2}
    img_p, idx_p = render_textured(v, vi, vt, tex, 128, 256, impl="plain")
    same = (idx == idx_p)[:, None].expand_as(img)
    assert same.float().mean() > 0.999
    assert torch.isfinite(img).all()
    torch.testing.assert_close(img[same], img_p[same], rtol=0, atol=1e-5)
