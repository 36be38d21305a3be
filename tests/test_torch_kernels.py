"""The CUDA kernels of drtk_tpu_torch against their plain PyTorch versions.

Imports only torch, numpy and the port, so it runs on a machine without
JAX. Tests marked ``cuda`` need an NVIDIA GPU and nvcc and skip elsewhere:
run them on the card with ``python -m pytest tests/test_torch_kernels.py
-m cuda -q``. The unmarked tests hold, on the CPU, what surrounds the
kernels: the dispatch, the launch counts and the setup packing, the latter
against numpy emulations of kernel B1's and kernel B5's algorithms (B1's
tile bins, big list and per-tile resolve; B5's thread-to-(triangle, pixel)
mapping), full frame and row tiles.

Tolerances: kernel B2 copies table rows, so it must be bit-exact
(torch.equal). Kernels B1 and B5 round every product, sum and quotient on
its own in the plain version's order, so they should match the plain
version exactly, and a row tile the full frame's rows (asserted exactly;
B1 against the plain resolve too); the other assertions against the plain
version allow the rasterizer's documented tie rule (index flips
only at pixels whose two depths agree to 1e-4 relative, fewer than 1e-3 of
the pixels; depth to rtol 1e-4 / atol 1e-6). Kernels B3 and B4 add with
atomics in an order that changes from run to run: rtol 1e-5 and an atol of
1e-6 times the sum of the magnitudes that went into each output (in f64,
1e-12). The fitting step's gradients through the kernels agree with the
plain pipeline's to 1e-4 of the largest magnitude, its loss to 1e-5; so
do the inverse8 step's, to the world vertices and the texture.
"""

import numpy as np
import pytest
import torch

import drtk_tpu_torch as tt
from drtk_tpu_torch.ops import rasterize_cuda, segment_rows, window_accum
from drtk_tpu_torch.ops.rasterize import (
    _canvas_cull,
    _rasterize_lines_plain,
    _rasterize_plain,
    broadcast_vi,
    line_setup,
    triangle_setup,
)
from drtk_tpu_torch.pipeline import fit_step, inverse8_step, render_textured
from drtk_tpu_torch.scenes import entry_scene_arrays, inverse8_scene_arrays, make_scene_arrays, with_edge_flags


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs test files in
    parallel worker processes, and each worker's default of one OpenMP
    thread per core oversubscribes the machine many times over. The other
    tests/test_torch_*.py files import it from here, a module that needs no
    JAX."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run with -m cuda on the card)")
    return torch.device("cuda")


def _soup(n, num_v, num_f, h, w, seed):
    """Random triangle soup covering (and overhanging) the canvas."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.2, 1.2, (n, num_v, 2)).astype(np.float32) * np.float32([w, h])
    z = rng.uniform(3.0, 9.0, (n, num_v, 1)).astype(np.float32)
    vi = rng.randint(0, num_v, (num_f, 3)).astype(np.int32)
    return {"v": np.concatenate([xy, z], -1), "vi": vi}


def _binning_scene(case):
    """Kernel B1's list boundaries on a 96x288 canvas (6 x 18 tiles of 16
    pixels): triangle 0 spans exactly MAX_TILES tiles ("span_s", 4 x 4, so
    it goes to the tiles' segments) or one more ("span_s_plus_1", 17 x 1, so
    it goes to the big list), or ("tile_borders") two squares' worth of
    triangles have corners and edges on tile borders, pixel centres lying on
    the edges at x = 32 and y = 16, 48, and an edge at x = 47.5 between two
    tiles. Beside them, a far triangle covering the whole canvas (big list)
    and a soup of small near ones."""
    first = {
        "span_s": [[16.5, 16.5, 5.0], [78.5, 20.5, 5.5], [30.5, 78.5, 6.0]],
        "span_s_plus_1": [[0.5, 50.5, 5.0], [270.5, 55.0, 5.5], [100.5, 60.5, 6.0]],
        "tile_borders": [[32.0, 16.0, 5.0], [64.0, 16.0, 5.0], [32.0, 48.0, 5.0],
                         [64.0, 48.0, 5.5], [47.5, 16.0, 4.5], [47.5, 80.0, 4.5], [96.0, 48.0, 6.0]],
    }[case]
    vi = [[0, 1, 2], [1, 3, 2], [4, 5, 6]] if case == "tile_borders" else [[0, 1, 2]]
    far = [[-50.0, -50.0, 9.0], [600.0, -20.0, 9.0], [-40.0, 400.0, 9.0]]
    soup = _soup(1, 30, 20, 96, 288, 7)
    soup["v"][..., 2] += 4.0  # behind the featured triangles, partly before the far one
    v = np.concatenate([np.float32(first + far)[None], soup["v"]], axis=1)
    vi = np.concatenate([np.int32(vi), np.int32([[len(first), len(first) + 1, len(first) + 2]]),
                         soup["vi"] + len(first) + 3]).astype(np.int32)
    return {"v": v.astype(np.float32), "vi": vi}


SCENES = {
    "soup_batch3": (lambda: _soup(3, 64, 96, 64, 128, 1), 64, 128),
    "nonaligned": (lambda: _soup(1, 48, 64, 70, 130, 2), 70, 130),
    "grid": (lambda: make_scene_arrays(128, 256, 9), 128, 256),
    "entry": (lambda: entry_scene_arrays(h=128, w=128), 128, 128),
    **{case: (lambda case=case: _binning_scene(case), 96, 288) for case in ("span_s", "span_s_plus_1", "tile_borders")},
}
B1_SCENES = list(SCENES)
BINNING_SCENES = ["span_s", "span_s_plus_1", "tile_borders"]
NO_LAUNCHES = {
    "B1 rasterize": 0, "B2 gather_rows": 0, "B3 scatter_rows": 0, "B4 window_accum": 0, "B5 rasterize_lines": 0,
}


def _wire(scene):
    """A scene of SCENES with every edge visible, and per-face partial flags
    on the soups."""
    make, h, w = SCENES[scene]
    s = make()
    flags = np.arange(s["vi"].shape[0]) % 7 + 1 if scene.startswith("soup") else 0x7
    return {**s, "vi": with_edge_flags(s["vi"], flags)}, h, w


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
    tt.rasterize(v, torch.from_numpy(with_edge_flags(s["vi"])), 64, 128, wireframe=True, y_offset=8, full_height=80)
    assert tt.kernel_launch_counts() == NO_LAUNCHES


def test_unknown_impl_raises():
    table = torch.zeros((1, 4, 3))
    idx = torch.zeros((1, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="impl"):
        segment_rows.gather_rows_by_index(table, idx, impl="fast")
    for wireframe in (False, True):
        with pytest.raises(ValueError, match="impl"):
            tt.rasterize(torch.zeros((1, 3, 3)), torch.zeros((1, 3), dtype=torch.int32), 4, 4, wireframe, "fast")
    with pytest.raises(ValueError, match="impl"):
        segment_rows.scatter_rows_to_faces(torch.zeros((1, 2, 2, 3)), idx, 4, impl="fast")
    with pytest.raises(ValueError, match="impl"):
        window_accum.window_accumulate(torch.zeros((1, 3, 4)), idx.reshape(1, 4), idx.reshape(1, 4), 2, 2, impl="fast")


def test_accumulation_shape_validation():
    idx = torch.zeros((1, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="scatter_rows_to_faces"):
        segment_rows.scatter_rows_to_faces(torch.zeros((1, 2, 3, 3)), idx, 4)
    with pytest.raises(ValueError, match="window_accumulate"):
        window_accum.window_accumulate(torch.zeros((1, 3, 4)), idx.reshape(1, 4), idx.reshape(2, 2), 2, 2)
    with pytest.raises(ValueError, match="table size"):
        window_accum.window_accumulate(torch.zeros((1, 3, 4)), idx.reshape(1, 4), idx.reshape(1, 4), -1, 2)


def _emulate_b1(coef, meta, h, w, y_offset=0):
    """numpy emulation of csrc/rasterize.cu. Binning: each triangle's pixel
    range, clipped to the viewport, touches a rectangle of TILE x TILE
    tiles; with at most MAX_TILES of them the triangle joins each tile's
    segment (capacity N*F*MAX_TILES in all), else its batch's big list.
    Resolve, per tile: its segment and the big-list triangles whose range
    meets the tile, each tested at the tile's pixels inside its range, every
    product and sum rounded on its own in float32, edge i covering where
    e_i > its threshold (-(the smallest denormal) on a top-left edge, else
    0); the smallest key (~float_bits(di) << 32) | id wins. Returns depth,
    index and the bins: per triangle its tile count and list, and the number
    of pairs."""
    tile, cap = rasterize_cuda.TILE, rasterize_cuda.MAX_TILES
    n, f_cnt, _ = coef.shape
    tiles_y, tiles_x = -(-h // tile), -(-w // tile)
    segs = [[[] for _ in range(tiles_y * tiles_x)] for _ in range(n)]
    big = [[] for _ in range(n)]
    n_tiles = np.zeros((n, f_cnt), np.int64)
    for b in range(n):
        for t in range(f_cnt):
            _, x_lo, x_hi, y_lo, y_hi = (int(x) for x in meta[b, t])
            x_lo, x_hi = max(x_lo, 0), min(x_hi, w - 1)
            y_lo, y_hi = max(y_lo - y_offset, 0), min(y_hi - y_offset, h - 1)
            if x_lo > x_hi or y_lo > y_hi:
                continue
            tx, ty = range(x_lo // tile, x_hi // tile + 1), range(y_lo // tile, y_hi // tile + 1)
            n_tiles[b, t] = len(tx) * len(ty)
            if n_tiles[b, t] > cap:
                big[b].append(t)
                continue
            for j in ty:
                for i in tx:
                    segs[b][j * tiles_x + i].append(t)
    n_pairs = sum(len(seg) for batch in segs for seg in batch)
    assert n_pairs <= n * f_cnt * cap

    no_key = np.iinfo(np.uint64).max
    depth = np.zeros((n, h, w), np.float32)
    index = np.full((n, h, w), -1, np.int32)
    for b in range(n):
        for t_i, seg in enumerate(segs[b]):
            ty, tx = divmod(t_i, tiles_x)
            x0, y0 = tx * tile, ty * tile + y_offset  # y0: frame row
            m = meta[b]
            on_tile = [t for t in big[b] if m[t, 1] < x0 + tile and m[t, 2] >= x0 and m[t, 3] < y0 + tile
                       and m[t, 4] >= y0]
            ids = np.array(seg + on_tile, np.int64)
            if ids.size == 0:
                continue
            c, m = coef[b, ids][:, :, None, None], meta[b, ids][:, :, None, None]
            xs = np.arange(x0, x0 + tile)[None, None, :]
            ys = np.arange(y0, y0 + tile)[None, :, None]
            px, py = xs.astype(np.float32), ys.astype(np.float32)
            keep = (xs >= m[:, 1]) & (xs <= m[:, 2]) & (ys >= m[:, 3]) & (ys <= m[:, 4])
            e = [(c[:, k] * px + c[:, 3 + k] * py) + c[:, 6 + k] for k in range(3)]
            for k in range(3):
                keep = keep & (e[k] > np.where(m[:, 0] >> k & 1 == 1, -np.float32(2.0**-149), np.float32(0)))
            di = (e[0] * c[:, 9] + e[1] * c[:, 10]) + e[2] * c[:, 11]
            bits = di.astype(np.float32).view(np.uint32) & np.uint32(0x7FFFFFFF)
            key = ((~bits).astype(np.uint64) << np.uint64(32)) | ids[:, None, None].astype(np.uint64)
            best = np.where(keep, key, no_key).min(axis=0)
            rows, cols = min(tile, h - (y0 - y_offset)), min(tile, w - x0)
            best = best[:rows, :cols]
            covered = best != no_key
            di_best = (~(best >> np.uint64(32)).astype(np.uint32)).view(np.float32)
            win = (b, slice(y0 - y_offset, y0 - y_offset + rows), slice(x0, x0 + cols))
            depth[win] = np.where(covered, np.float32(1) / np.maximum(di_best, np.float32(1e-8)), np.float32(0))
            index[win] = np.where(covered, (best & np.uint64(0xFFFFFFFF)).astype(np.int32), -1)
    return depth, index, {"tiles": n_tiles, "big": big, "pairs": n_pairs}


# (y_offset, rows): the full frame, and row tiles of it
VIEWPORTS = [(0, None), (16, 24), (40, 24)]


def _packed(scene, y0=0, hb=None):
    """pack_setup's rows of a SCENES scene for rows [y0, y0 + hb), and the
    setup, the canvas cull and the frame's height and width."""
    make, h, w = SCENES[scene]
    s = make()
    v = torch.from_numpy(s["v"])
    vi = broadcast_vi(torch.from_numpy(s["vi"]), v.shape[0])
    setup = triangle_setup(v, vi)
    valid = _canvas_cull(setup, h, w)
    coef, meta = rasterize_cuda.pack_setup(setup, valid, hb or h, w, y0)
    return coef, meta, setup, valid, h, w


@pytest.mark.parametrize("viewport", VIEWPORTS)
@pytest.mark.parametrize("scene", B1_SCENES)
def test_packed_setup_reproduces_plain_resolve(scene, viewport):
    """What kernel B1 computes from pack_setup's rows (emulated in numpy)
    equals the plain resolve bit for bit, in a row tile too."""
    y0, hb = viewport
    coef, meta, setup, valid, h, w = _packed(scene, y0, hb)
    hb = hb or h
    assert coef.shape[-1] == rasterize_cuda.SETUP_FLOATS and meta.shape[-1] == rasterize_cuda.SETUP_INTS
    depth, index, _ = _emulate_b1(coef.numpy(), meta.numpy(), hb, w, y0)
    d_ref, i_ref = _rasterize_plain(setup, valid, hb, w, y_offset=y0)
    np.testing.assert_array_equal(index, i_ref.numpy())
    np.testing.assert_array_equal(depth, d_ref.numpy())
    if viewport[1] is not None:
        d_full, i_full = _rasterize_plain(setup, valid, h, w)
        np.testing.assert_array_equal(i_ref.numpy(), i_full[:, y0 : y0 + hb].numpy())


@pytest.mark.parametrize("scene", BINNING_SCENES)
def test_b1_bins_reach_both_lists(scene):
    """Each binning scene sends its triangle 0 to the list its name says,
    and some triangle to each list; the emulated resolve (held bit for bit
    against the plain one in test_packed_setup_reproduces_plain_resolve)
    draws the featured triangles as the scene describes."""
    coef, meta, _, _, h, w = _packed(scene)
    _, index, bins = _emulate_b1(coef.numpy(), meta.numpy(), h, w)
    tiles, big, img = bins["tiles"], bins["big"][0], index[0]
    assert bins["pairs"] > 0 and big and (img == 0).any()
    if scene == "span_s":
        assert tiles[0, 0] == rasterize_cuda.MAX_TILES and 0 not in big
    elif scene == "span_s_plus_1":
        assert tiles[0, 0] == rasterize_cuda.MAX_TILES + 1 and 0 in big
    else:
        # The square [32, 64] x [16, 48]: its top and left edges (tile borders
        # x = 32, y = 16) are drawn, its bottom edge (y = 48) is not; the
        # nearer triangle 2 starts at x = 47.5, between tiles 2 and 3.
        assert (img[16:48, 32] == 0).all() and (img[16, 32:47] == 0).all()
        assert not np.isin(img[48, 33:47], [0, 1]).any()
        assert img[40, 47] in (0, 1) and img[40, 48] == 2


def _emulate_b5(rows, meta, ends, h, w, y_offset=0):
    """numpy emulation of csrc/rasterize_lines.cu: thread t takes the first
    triangle whose running window-area sum exceeds t and the pixel
    t - (the sum before it) of its window, row-major; every product, sum and
    quotient is rounded on its own in float32; the smallest packed key
    (~float_bits(di) << 32) | id wins, id INT32_MAX where no edge crosses."""
    n, f_cnt, _ = rows.shape
    f32 = np.float32
    t = np.arange(int(ends[-1]) if ends.size else 0, dtype=np.int64)
    i = np.searchsorted(ends, t, side="right")
    off = t - np.concatenate([[0], ends])[i]
    r, m = rows.reshape(-1, rows.shape[-1])[i], meta.reshape(-1, meta.shape[-1])[i].astype(np.int64)
    cols = m[:, 2] - m[:, 1] + 1
    y, x = m[:, 3] + off // cols, m[:, 1] + off % cols
    px, py = x.astype(f32), y.astype(f32)
    e = [(r[:, k] * px + r[:, 3 + k] * py) + r[:, 6 + k] for k in range(3)]
    inside = np.ones(t.shape, bool)
    for k in range(3):
        inside &= (e[k] > 0) | ((e[k] == 0) & (m[:, 0] >> k & 1 == 1))

    def diamond(p1x, p1y, p2x, p2y):
        a0, b0, c0 = p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y

        def in_seg(ax, ay, bx, by, cx, cy):
            return (((bx >= cx) & (cx >= ax)) | ((bx <= cx) & (cx <= ax))) & (
                ((by >= cy) & (cy >= ay)) | ((by <= cy) & (cy <= ay)))

        def side(s0x, s0y, s1x, s1y):
            a2, b2, c2 = s0y - s1y, s1x - s0x, s0x * s1y - s1x * s0y
            d = a0 * b2 - a2 * b0
            with np.errstate(divide="ignore", invalid="ignore"):
                cx = np.where(d == 0, np.finfo(f32).max, (b0 * c2 - b2 * c0) / d).astype(f32)
                cy = np.where(d == 0, np.finfo(f32).max, (a2 * c0 - a0 * c2) / d).astype(f32)
            return in_seg(s0x, s0y, s1x, s1y, cx, cy) & in_seg(p1x, p1y, p2x, p2y, cx, cy)

        h_ = f32(0.5)
        return (side(px, py - h_, px + h_, py) | side(px + h_, py, px, py + h_)
                | side(px, py + h_, px - h_, py) | side(px - h_, py, px, py - h_))

    cross = np.zeros(t.shape, bool)
    for bit, (a, b) in ((3, (9, 11)), (4, (11, 13)), (5, (9, 13))):
        cross |= (m[:, 0] >> bit & 1 == 1) & diamond(r[:, a], r[:, a + 1], r[:, b], r[:, b + 1])
    b = [np.minimum(np.maximum(ek * r[:, 18], f32(0)), f32(1)) for ek in e]
    bs = (b[0] + b[1]) + b[2]
    with np.errstate(divide="ignore", invalid="ignore"):
        di = ((b[0] / bs) * r[:, 15] + (b[1] / bs) * r[:, 16]) + (b[2] / bs) * r[:, 17]
    write = inside | cross
    bits = di.astype(f32).view(np.uint32) & np.uint32(0x7FFFFFFF)
    ids = np.where(cross, i % f_cnt, 0x7FFFFFFF).astype(np.uint64)
    key = ((~bits).astype(np.uint64) << np.uint64(32)) | ids
    keys = np.full(n * h * w, np.iinfo(np.uint64).max, np.uint64)
    flat = ((i // f_cnt) * h + (y - y_offset)) * w + x
    np.minimum.at(keys, flat[write], key[write])
    keys = keys.reshape(n, h, w)
    written = keys != np.iinfo(np.uint64).max
    ids = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    di = (~(keys >> np.uint64(32)).astype(np.uint32)).view(np.float32)
    depth = np.where(written, f32(1) / np.maximum(di, f32(1e-8)), f32(0))
    return depth, np.where(written & (ids != 0x7FFFFFFF), ids.astype(np.int32), -1)


@pytest.mark.parametrize("viewport", VIEWPORTS)
@pytest.mark.parametrize("scene", ["soup_batch3", "nonaligned", "grid", "entry"])
def test_packed_lines_reproduce_plain_resolve(scene, viewport):
    """What kernel B5 computes from pack_lines' rows (emulated in numpy)
    equals the plain wireframe resolve bit for bit, in a row tile too."""
    s, h, w = _wire(scene)
    y0, hb = viewport
    hb = hb or h
    v = torch.from_numpy(s["v"])
    vi = broadcast_vi(torch.from_numpy(s["vi"]), v.shape[0])
    setup, lines = triangle_setup(v, vi), line_setup(v, vi)
    valid = _canvas_cull(setup, h, w)
    rows, meta, ends = rasterize_cuda.pack_lines(setup, lines, valid, hb, w, y0, h)
    assert rows.shape[-1] == rasterize_cuda.LINE_FLOATS and meta.shape[-1] == rasterize_cuda.LINE_INTS
    assert ends.dtype == torch.int64 and ends.shape == (v.shape[0] * vi.shape[1],)
    depth, index = _emulate_b5(rows.numpy(), meta.numpy(), ends.numpy(), hb, w, y0)
    d_ref, i_ref = _rasterize_lines_plain(setup, lines, valid, hb, w, y0, h)
    assert (i_ref >= 0).any() and ((i_ref < 0) & (d_ref > 0)).any()
    np.testing.assert_array_equal(index, i_ref.numpy())
    np.testing.assert_array_equal(depth, d_ref.numpy())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k_dim", [1, 6, 9, 16, 42])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_kernel_is_bit_exact(cuda_device, k_dim, dtype):
    """K = 6, 9, 16 take the compile-time kernels, 1 and 42 the run-time K;
    an odd P (71 x 131) starts batches 1 and 2 off the 16-byte grid, so the
    stores have misaligned heads and tails."""
    rng = np.random.RandomState(k_dim)
    n, f_cnt, h, w = 3, 300, 71, 131
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
def test_gather_kernel_raises_past_32_bit_offsets(cuda_device):
    """Offsets within a batch are 32-bit: the wrapper refuses F*K or P*K of
    2**31 before it allocates (stride-0 views stand in for the tensors)."""
    one = torch.zeros((), device=cuda_device)
    idx = torch.zeros((1, 4, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="32-bit"):
        segment_rows.gather_rows_by_index(one.expand(1, 2**27, 16), idx)  # F*K = 2**31
    with pytest.raises(ValueError, match="32-bit"):
        big_idx = torch.zeros((), dtype=torch.int32, device=cuda_device).expand(1, 2**14, 2**13)
        segment_rows.gather_rows_by_index(one.expand(1, 4, 16), big_idx)  # P*K = 2**31


@pytest.mark.cuda
@pytest.mark.parametrize("scene", B1_SCENES)
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
@pytest.mark.parametrize("viewport", VIEWPORTS)
@pytest.mark.parametrize("scene", B1_SCENES)
def test_rasterize_kernel_bins_and_resolve_exactly(cuda_device, scene, viewport):
    """Kernel B1 on pack_setup's rows: depth and index bit-identical to the
    plain resolve, and its device-built bins (pairs in use, big lists) those
    of the numpy emulation."""
    y0, hb = viewport
    coef, meta, setup, valid, h, w = _packed(scene, y0, hb)
    hb = hb or h
    d, i, bins = rasterize_cuda._resolve_binned(coef.to(cuda_device), meta.to(cuda_device), hb, w, y0)
    torch.cuda.synchronize()
    d_ref, i_ref = _rasterize_plain(setup, valid, hb, w, y_offset=y0)
    assert torch.equal(i.cpu(), i_ref) and torch.equal(d.cpu(), d_ref)
    _, _, want = _emulate_b1(coef.numpy(), meta.numpy(), hb, w, y0)
    assert int(bins.starts[-1]) == want["pairs"]
    assert bins.big_count.tolist() == [len(b) for b in want["big"]]


@pytest.mark.cuda
def test_render_textured_kernels_match_plain(cuda_device):
    s = make_scene_arrays(128, 256, 9)
    v, vi, vt, tex = (torch.from_numpy(s[k]).to(cuda_device) for k in ("v", "vi", "vt", "tex"))
    tt.reset_kernel_launch_counts()
    img, idx = render_textured(v, vi, vt, tex, 128, 256)
    torch.cuda.synchronize()
    assert tt.kernel_launch_counts() == {**NO_LAUNCHES, "B1 rasterize": 1, "B2 gather_rows": 2}
    img_p, idx_p = render_textured(v, vi, vt, tex, 128, 256, impl="plain")
    same = (idx == idx_p)[:, None].expand_as(img)
    assert same.float().mean() > 0.999
    assert torch.isfinite(img).all()
    torch.testing.assert_close(img[same], img_p[same], rtol=0, atol=1e-5)


def _magnitude_bound(got, want, magnitude, dtype):
    """|got - want| <= rtol |want| + atol_scale * magnitude."""
    rtol, scale = (1e-5, 1e-6) if dtype == torch.float32 else (1e-12, 1e-12)
    assert bool(((got - want).abs() <= rtol * want.abs() + scale * magnitude).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k_dim", [6, 9, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scatter_kernel_matches_plain(cuda_device, k_dim, dtype):
    rng = np.random.RandomState(k_dim)
    n, f_cnt, h, w = 2, 300, 70, 130
    rows = torch.from_numpy(rng.randn(n, h, w, k_dim)).to(dtype)
    idx = torch.from_numpy(rng.randint(-1, f_cnt, (n, h, w)).astype(np.int32))
    idx[0, 0, :3] = torch.tensor([-5, f_cnt - 1, f_cnt + 7], dtype=torch.int32)
    want = segment_rows._scatter_rows_plain(rows, idx, f_cnt)
    magnitude = segment_rows._scatter_rows_plain(rows.abs(), idx, f_cnt)
    before = segment_rows.scatter_launches
    got = segment_rows.scatter_rows_to_faces(rows.to(cuda_device), idx.to(cuda_device), f_cnt)
    torch.cuda.synchronize()
    assert segment_rows.scatter_launches == before + 1
    assert got.dtype == dtype and got.shape == (n, f_cnt, k_dim)
    _magnitude_bound(got.cpu(), want, magnitude, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_window_kernel_matches_plain(cuda_device, dtype):
    rng = np.random.RandomState(3)
    n, k_dim, p, out_h, out_w = 2, 12, 5000, 37, 61
    rows_pk = torch.from_numpy(rng.randn(n, p, k_dim)).to(dtype)
    iy = torch.from_numpy(rng.randint(-2, out_h + 2, (n, p)).astype(np.int32))  # inert and outside taps too
    ix = torch.from_numpy(rng.randint(-2, out_w + 2, (n, p)).astype(np.int32))
    want = window_accum._window_accumulate_plain(rows_pk.transpose(1, 2), iy, ix, out_h, out_w)
    magnitude = window_accum._window_accumulate_plain(rows_pk.abs().transpose(1, 2), iy, ix, out_h, out_w)
    before = window_accum.launches
    # the [N, P, K] rows as their [N, K, P] view, as the row scatter passes them
    got = window_accum.window_accumulate(
        rows_pk.to(cuda_device).transpose(1, 2), iy.to(cuda_device), ix.to(cuda_device), out_h, out_w)
    torch.cuda.synchronize()
    assert window_accum.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, k_dim, out_h, out_w)
    _magnitude_bound(got.cpu(), want, magnitude, dtype)


@pytest.mark.cuda
def test_fit_step_kernels_match_plain(cuda_device):
    s = make_scene_arrays(128, 256, 9)
    v, vi, vt, tex = (torch.from_numpy(s[k]).to(cuda_device) for k in ("v", "vi", "vt", "tex"))
    tt.reset_kernel_launch_counts()
    loss, grads = fit_step(v, vi, vt, tex, 128, 256)
    torch.cuda.synchronize()
    assert tt.kernel_launch_counts() == {
        **NO_LAUNCHES, "B1 rasterize": 1, "B2 gather_rows": 5, "B3 scatter_rows": 3, "B4 window_accum": 1,
    }
    idx = tt.rasterize(v, vi, 128, 256)
    loss, grads = fit_step(v, vi, vt, tex, 128, 256, index_img=idx)
    loss_p, grads_p = fit_step(v, vi, vt, tex, 128, 256, index_img=idx, impl="plain")
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    for name in ("v", "vt", "tex"):
        assert bool(torch.isfinite(grads[name]).all())
        err = (grads[name] - grads_p[name]).abs().max()
        assert err <= 1e-4 * grads_p[name].abs().max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["soup_batch3", "nonaligned", "grid", "entry"])
def test_lines_kernel_matches_plain(cuda_device, scene):
    s, h, w = _wire(scene)
    v = torch.from_numpy(s["v"]).to(cuda_device)
    vi = torch.from_numpy(s["vi"]).to(cuda_device)
    before = rasterize_cuda.lines_launches
    d, i = tt.rasterize_with_depth(v, vi, h, w, wireframe=True)
    torch.cuda.synchronize()
    assert rasterize_cuda.lines_launches == before + 1
    d_ref, i_ref = tt.rasterize_with_depth(v, vi, h, w, wireframe=True, impl="plain")
    assert bool((i >= 0).any())
    _assert_raster_match(d_ref, i_ref, d, i)


@pytest.mark.cuda
@pytest.mark.parametrize("wireframe", [False, True])
def test_viewport_tiles_on_the_card(cuda_device, wireframe):
    """Row tiles from kernel B1 (B5) equal the full frame's rows exactly,
    and each tile matches its plain version."""
    s, h, w = _wire("grid")
    v = torch.from_numpy(s["v"]).to(cuda_device)
    vi = torch.from_numpy(s["vi"]).to(cuda_device)
    d_full, i_full = tt.rasterize_with_depth(v, vi, h, w, wireframe=wireframe)
    for y0, hb in [(0, 32), (32, 32), (64, 32), (96, 32), (10, 77)]:
        kw = dict(wireframe=wireframe, y_offset=y0, full_height=h)
        d_t, i_t = tt.rasterize_with_depth(v, vi, hb, w, **kw)
        assert torch.equal(i_t, i_full[:, y0 : y0 + hb]) and torch.equal(d_t, d_full[:, y0 : y0 + hb])
        _assert_raster_match(*tt.rasterize_with_depth(v, vi, hb, w, impl="plain", **kw), d_t, i_t)


@pytest.mark.cuda
def test_inverse8_step_kernels_match_plain(cuda_device):
    s = {k: torch.from_numpy(a).to(cuda_device) for k, a in inverse8_scene_arrays(64, 9, 2, tex_size=32).items()}
    cams = {k: s[k] for k in ("campos", "camrot", "focal", "princpt")}
    with torch.no_grad():
        img_gt, _ = tt.render_multiview(s["v_world"], s["vi"], s["vt"], s["tex_gt"], cams, 64, 64)

    def params():
        return (s["v_world"] + 0.02).requires_grad_(), torch.full_like(s["tex_gt"], 0.5).requires_grad_()

    p = params()
    tt.reset_kernel_launch_counts()
    inverse8_step(p, torch.optim.Adam(p, lr=1e-3), s["vi"], s["vt"], cams, img_gt, 64, 64)
    torch.cuda.synchronize()
    assert tt.kernel_launch_counts() == {
        **NO_LAUNCHES, "B1 rasterize": 1, "B2 gather_rows": 5, "B3 scatter_rows": 2, "B4 window_accum": 1,
    }
    p_k, p_p = params(), params()
    idx = tt.rasterize(tt.transform(p_k[0].detach().expand(2, -1, -1), **cams), s["vi"], 64, 64)
    loss, grads = inverse8_step(p_k, torch.optim.Adam(p_k, lr=1e-3), s["vi"], s["vt"], cams, img_gt, 64, 64,
                                index_img=idx)
    loss_p, grads_p = inverse8_step(p_p, torch.optim.Adam(p_p, lr=1e-3), s["vi"], s["vt"], cams, img_gt, 64, 64,
                                    index_img=idx, impl="plain")
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    for name in ("v_world", "tex"):
        err = (grads[name] - grads_p[name]).abs().max()
        assert err <= 1e-4 * grads_p[name].abs().max(), name
