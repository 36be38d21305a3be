"""The CUDA kernels of drtk_tpu_torch against their plain PyTorch versions.

Imports only torch, numpy and the port, so it runs on a machine without
JAX. Tests marked ``cuda`` need an NVIDIA GPU and nvcc and skip elsewhere:
run them on the card with ``python -m pytest tests/test_torch_kernels.py
-m cuda -q``. The unmarked tests hold, on the CPU, what surrounds the
kernels: the dispatch, the launch counts and the setup packing, the latter
against numpy emulations of kernel B1's and kernel B5's algorithms (B1's
tile bins, big list and per-tile resolve; B5's lanes' walk to each
(triangle, pixel), its box and line rejects, which it takes from
chip_smoke.py's torch copy, and its warp queue), full frame and row tiles;
a property test (hypothesis) that B5's rejects never drop a side the full
test accepts; and numpy emulations of kernels B3 (pixel tiles, runs of
equal faces, per-tile face merge) and B4 (warp patches of taps, grouped by
texel) against the plain versions, with the global atomics each issues
held to the models that chip_smoke.py reports (and B5's surviving edge
tests to its model).

Tolerances: kernel B2 copies table rows, so it must be bit-exact
(torch.equal). Kernels B1 and B5 round every product, sum and quotient on
its own in the plain version's order, so they should match the plain
version exactly, and a row tile the full frame's rows (asserted exactly;
B1 against the plain resolve too, B5 on the near-miss and 4096-wide
scenes, whose edges lie within ulps of a diamond's reach or at
coordinates up to 4096); the other assertions against the plain
version allow the rasterizer's documented tie rule (index flips
only at pixels whose two depths agree to 1e-4 relative, fewer than 1e-3 of
the pixels; depth to rtol 1e-4 / atol 1e-6). Kernels B3 and B4 add with
atomics in an order that changes from run to run: rtol 1e-5 and an atol of
1e-6 times the sum of the magnitudes that went into each output (in f64,
1e-12). The fitting step's gradients through the kernels agree with the
plain pipeline's to 1e-4 of the largest magnitude, its loss to 1e-5; so
do the inverse8 step's, to the world vertices and the texture.
grid_scatter's output agrees with its float64 oracle, and filter2d's
forward and gradient with float64 (cuDNN's TF32 allowed), to 1e-5 of the
largest magnitude.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
import drtk_tpu_torch as tt
from drtk_tpu_torch.ops import grid_sample as gs
from drtk_tpu_torch.ops import mipmap_grid_sample as mipmap_mod
from drtk_tpu_torch.ops import rasterize_cuda, segment_rows, window_accum
from drtk_tpu_torch.ops.rasterize import (
    _canvas_cull,
    _rasterize_lines_plain,
    _rasterize_plain,
    broadcast_vi,
    line_setup,
    triangle_setup,
)
from drtk_tpu_torch.ops.row_gather import row_gather
from drtk_tpu_torch.pipeline import fit_step, inverse8_step, render_textured
from drtk_tpu_torch.ops import edge_grad as edge_grad_mod
from drtk_tpu_torch.ops.edge_grad import _stencil_table
from drtk_tpu_torch.pipeline import MIPVIEWS_STAGES, avatar4k_band, avatar4k_step, mip_pyramid, mipviews_step
from drtk_tpu_torch.scenes import (
    avatar4k_scene_arrays, box_pyramid, entry_scene_arrays, inverse8_scene_arrays, make_scene_arrays, with_edge_flags,
)


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
    "E1 edge_grad": 0, "M1 mipmap_sample": 0,
}


def _wide_scene(clusters=8, per_cluster=32, h=64, w=4096, seed=3):
    """A few hundred triangles of up to ~60 pixels in 8 clusters across a
    4096-wide canvas (one cluster per chunk of the plain version), so that
    coordinates reach 4096 while the windows stay small."""
    rng = np.random.RandomState(seed)
    centres = np.linspace(40, w - 40, clusters).repeat(per_cluster)[:, None, None]
    xy = np.concatenate([centres, rng.uniform(0, h, (clusters * per_cluster, 1, 1))], -1)
    xy = xy + rng.uniform(-30, 30, (clusters * per_cluster, 3, 2))
    z = rng.uniform(3.0, 9.0, (clusters * per_cluster, 3, 1))
    v = np.concatenate([xy, z], -1).reshape(1, -1, 3).astype(np.float32)
    return {"v": v, "vi": np.arange(3 * clusters * per_cluster, dtype=np.int32).reshape(-1, 3)}


# Wireframe-only scenes: edges at a diamond's reach and nearly parallel to
# its sides, to within ulps (chip_smoke.near_miss_scene), and coordinates
# up to 4096.
LINE_SCENES = {
    "near_miss": (lambda: chip_smoke.near_miss_scene(64, 128), 64, 128),
    "wide4096": (_wide_scene, 64, 4096),
}
B5_SCENES = ["soup_batch3", "nonaligned", "grid", "entry", *LINE_SCENES]


def _wire(scene):
    """A scene of SCENES or LINE_SCENES with every edge visible, and
    per-face partial flags on the soups."""
    make, h, w = {**SCENES, **LINE_SCENES}[scene]
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


def _b5_sides(p1x, p1y, p2x, p2y, visible, window, px, py, stage=3):
    """Kernel B5's rejects for one edge, through chip_smoke.b5_edge_sides on
    float32 CPU tensors (each op rounded on its own, as in the kernel):
    (the sides the owner lane keeps, the sides tested), bits in
    diamond_crossing's order; the second adds the box reject that stage 3
    leaves to the queue's lane. numpy in and out; ``window`` is (x_lo,
    x_hi, y_lo, y_hi)."""
    p1x, p1y, p2x, p2y, visible, px, py = (torch.from_numpy(np.array(a)) for a in (p1x, p1y, p2x, p2y, visible, px, py))
    window = tuple(torch.from_numpy(np.array(v)) for v in window)
    kept = chip_smoke.b5_edge_sides(p1x, p1y, p2x, p2y, visible, window, px, py, stage)
    box = chip_smoke.b5_edge_sides(p1x, p1y, p2x, p2y, visible, window, px, py, 1)
    return kept.numpy(), (kept & box).numpy()


def _b5_side_hits(p1x, p1y, p2x, p2y, px, py):
    """The four diamond-side tests of diamond_crossing, [4, ...] bool, every
    product, sum and quotient rounded in float32."""
    f32 = np.float32
    with np.errstate(all="ignore"):
        a0, b0, c0 = p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y

        def in_seg(ax, ay, bx, by, cx, cy):
            return (((bx >= cx) & (cx >= ax)) | ((bx <= cx) & (cx <= ax))) & (
                ((by >= cy) & (cy >= ay)) | ((by <= cy) & (cy <= ay)))

        def side(s0x, s0y, s1x, s1y):
            a2, b2, c2 = s0y - s1y, s1x - s0x, s0x * s1y - s1x * s0y
            d = a0 * b2 - a2 * b0
            cx = np.where(d == 0, np.finfo(f32).max, (b0 * c2 - b2 * c0) / d).astype(f32)
            cy = np.where(d == 0, np.finfo(f32).max, (a2 * c0 - a0 * c2) / d).astype(f32)
            return in_seg(s0x, s0y, s1x, s1y, cx, cy) & in_seg(p1x, p1y, p2x, p2y, cx, cy)

        h = f32(0.5)
        return np.stack([side(px, py - h, px + h, py), side(px + h, py, px, py + h),
                         side(px, py + h, px - h, py), side(px - h, py, px, py - h)])


B5_EDGES = ((9, 11), (11, 13), (9, 13))  # the corners (row offsets) of edges (p0, p1), (p1, p2), (p0, p2)


def _emulate_b5(rows, meta, ends, h, w, y_offset=0, stage=3, warps=3168):
    """numpy emulation of csrc/rasterize_lines.cu (``stage`` 3), or of its
    rejects alone writing keys without the queue (1: the box reject, 2: the
    box and line rejects): the lanes' walk (:func:`_b5_walk`) to each
    thread number's triangle (the first whose running window-area sum
    exceeds it) and pixel, row-major in its window; each visible edge tested
    on the sides its rejects leave (:func:`_b5_sides`). Every product, sum
    and quotient is rounded on its own in float32; the smallest packed key
    (~float_bits(di) << 32) | id wins, id INT32_MAX where no edge crosses.
    At stage 3 inside pixels write their interior key, and the (pixel, edge)
    pairs left to test go to the warp's queue, from which a crossed one
    writes the crossing key.
    Returns (depth, index, counts): window pixels, seeks, visible edges, the
    (pixel, edge) pairs tested and their sides, and at stage 3 the warp
    steps, the runs (``warps`` of them, by default one wave of 3 blocks of 8
    warps on 132 SMs, as the kernel's 80 registers allow), the queued pairs
    and the queue's passes of up to 32 pairs."""
    n, f_cnt, _ = rows.shape
    f32 = np.float32
    total = int(ends[-1]) if ends.size else 0
    t = np.arange(total, dtype=np.int64)
    i, x, y, seeks = _b5_walk(meta.reshape(-1, meta.shape[-1]), ends, per_warp(total, warps))
    r, m = rows.reshape(-1, rows.shape[-1])[i], meta.reshape(-1, meta.shape[-1])[i]
    px, py = x.astype(f32), y.astype(f32)
    e = [(r[:, k] * px + r[:, 3 + k] * py) + r[:, 6 + k] for k in range(3)]
    inside = np.ones(t.shape, bool)
    for k in range(3):
        inside &= (e[k] > 0) | ((e[k] == 0) & (m[:, 0] >> k & 1 == 1))

    queued, sides = [], []
    for k, (a, b) in enumerate(B5_EDGES):
        kept, tested = _b5_sides(r[:, a], r[:, a + 1], r[:, b], r[:, b + 1], m[:, 0] >> (3 + k) & 1 == 1,
                                 (m[:, 1], m[:, 2], m[:, 3], m[:, 4]), px, py, stage)
        queued.append(kept != 0)
        sides.append(tested)
    pairs = [s != 0 for s in sides]
    counts = {
        "window_pixels": total,
        **seeks,
        "visible_edges": int(sum(int((m[:, 0] >> (3 + k) & 1).sum()) for k in range(3))),
        "edge_tests": int(sum(int(p.sum()) for p in pairs)),
        "side_tests": int(sum(int((s >> b & 1).sum()) for s in sides for b in range(4))),
    }
    hits = []
    for k, (a, b) in enumerate(B5_EDGES):
        side_hits = _b5_side_hits(r[:, a], r[:, a + 1], r[:, b], r[:, b + 1], px, py)
        hits.append(((side_hits & ((sides[k] >> np.arange(4)[:, None]) & 1 == 1)).any(0)) & pairs[k])
    cross = hits[0] | hits[1] | hits[2]
    b = [np.minimum(np.maximum(ek * r[:, 18], f32(0)), f32(1)) for ek in e]
    bs = (b[0] + b[1]) + b[2]
    with np.errstate(divide="ignore", invalid="ignore"):
        di = ((b[0] / bs) * r[:, 15] + (b[1] / bs) * r[:, 16]) + (b[2] / bs) * r[:, 17]
    bits = (~(di.astype(f32).view(np.uint32) & np.uint32(0x7FFFFFFF))).astype(np.uint64) << np.uint64(32)
    flat = ((i // f_cnt) * h + (y - y_offset)) * w + x
    interior = bits | np.uint64(0x7FFFFFFF)
    crossed = bits | (i % f_cnt).astype(np.uint64)
    keys = np.full(n * h * w, np.iinfo(np.uint64).max, np.uint64)
    if stage < 3:
        write = inside | cross
        np.minimum.at(keys, flat[write], np.where(cross, crossed, interior)[write])
    else:
        # Owners write interior keys; the queue's pairs, in push order (per
        # step of 32: edge 0's pairs by lane, then edge 1's, edge 2's), are
        # tested 32 to a pass along each warp's run, and a crossed pair
        # writes its pixel's key with the triangle's id.
        np.minimum.at(keys, flat[inside], interior[inside])
        for k in range(3):
            np.minimum.at(keys, flat[hits[k]], crossed[hits[k]])
        run = t // per_warp(total, warps)
        n_runs = int(run[-1]) + 1 if total else 0
        per_run = sum(np.bincount(run, q, n_runs) for q in queued).astype(np.int64)
        counts.update(warp_steps=-(-total // 32), runs=n_runs, queued=int(per_run.sum()),
                      queue_passes=int((-(-per_run // 32)).sum()))
    keys = keys.reshape(n, h, w)
    written = keys != np.iinfo(np.uint64).max
    ids = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    di = (~(keys >> np.uint64(32)).astype(np.uint32)).view(np.float32)
    depth = np.where(written, f32(1) / np.maximum(di, f32(1e-8)), f32(0))
    return depth, np.where(written & (ids != 0x7FFFFFFF), ids.astype(np.int32), -1), counts


def _b5_walk(meta, ends, run):
    """Kernel B5's walk: each warp takes ``run`` consecutive thread numbers,
    lane j numbers j, j + 32, ...; a lane binary-searches its first
    triangle, then steps 32 on in its window (rows32 rows and cols32
    columns, one wrap at most) or seeks a later window (8 triangles one by
    one, then a binary search), finding its row and column with one
    division. Returns the triangle, x and y of every thread number, held to
    a direct search and division, and the lane seeks and the warp steps in
    which some lane seeks."""
    total = int(ends[-1]) if ends.size else 0
    out_i, out_x, out_y = (np.zeros(total, np.int64) for _ in range(3))
    starts = np.concatenate([[0], ends])
    cols_of = (meta[:, 2] - meta[:, 1] + 1).astype(np.int32)
    seeks = seek_steps = 0
    for begin in range(0, total, run):
        t = begin + np.arange(32)
        end = min(begin + run, total)
        live = t < end
        i = np.searchsorted(ends, np.where(live, t, 0), side="right")
        off = (t - starts[i]).astype(np.int32)
        row, col = off // cols_of[i], off % cols_of[i]
        seeks += int(live.sum())
        seek_steps += 1
        while live.any():
            tl = t[live]
            out_i[tl], out_x[tl], out_y[tl] = i[live], meta[i[live], 1] + col[live], meta[i[live], 3] + row[live]
            t = t + 32
            live = t < end
            same = live & (t < ends[i])
            w_cols = cols_of[i]
            col = col + np.where(same, 32 % w_cols, 0)
            row = row + np.where(same, 32 // w_cols, 0) + (same & (col >= w_cols))
            col = np.where(same & (col >= w_cols), col - w_cols, col)
            moved = live & ~same
            seek_steps += bool(moved.any())
            if moved.any():
                i = np.where(moved, np.searchsorted(ends, np.where(live, t, 0), side="right"), i)
                off = np.where(moved, t - starts[i], 0).astype(np.int32)
                row = np.where(moved, off // cols_of[i], row)
                col = np.where(moved, off % cols_of[i], col)
                seeks += int(moved.sum())
    i = np.searchsorted(ends, np.arange(total), side="right")
    off = np.arange(total) - starts[i]
    assert (off < 2**31).all()
    np.testing.assert_array_equal(out_i, i)
    np.testing.assert_array_equal(out_x, meta[i, 1] + off % cols_of[i])
    np.testing.assert_array_equal(out_y, meta[i, 3] + off // cols_of[i])
    return out_i, out_x, out_y, {"seeks": seeks, "seek_steps": seek_steps}


def per_warp(total, warps):
    """The thread numbers each warp of B5 walks: total/warps rounded up to
    a multiple of 32."""
    return max(32, -(-(-(-total // warps)) // 32) * 32)


def _packed_lines(scene, y0=0, hb=None):
    """pack_lines' rows of a wireframe scene for rows [y0, y0 + hb), with
    the setup, the canvas cull and the frame's height and width."""
    s, h, w = _wire(scene)
    v = torch.from_numpy(s["v"])
    vi = broadcast_vi(torch.from_numpy(s["vi"]), v.shape[0])
    setup, lines = triangle_setup(v, vi), line_setup(v, vi)
    valid = _canvas_cull(setup, h, w)
    rows, meta, ends = rasterize_cuda.pack_lines(setup, lines, valid, hb or h, w, y0, h)
    return rows, meta, ends, (setup, lines, valid), h, w


@pytest.mark.parametrize("viewport", VIEWPORTS)
@pytest.mark.parametrize("scene", B5_SCENES)
def test_packed_lines_reproduce_plain_resolve(scene, viewport):
    """What kernel B5 computes from pack_lines' rows (emulated in numpy)
    equals the plain wireframe resolve bit for bit, in a row tile too."""
    y0, hb = viewport
    rows, meta, ends, (setup, lines, valid), h, w = _packed_lines(scene, y0, hb)
    hb = hb or h
    assert rows.shape[-1] == rasterize_cuda.LINE_FLOATS and meta.shape[-1] == rasterize_cuda.LINE_INTS
    assert ends.dtype == torch.int64 and ends.shape == (rows.shape[0] * rows.shape[1],)
    depth, index, _ = _emulate_b5(rows.numpy(), meta.numpy(), ends.numpy(), hb, w, y0)
    d_ref, i_ref = _rasterize_lines_plain(setup, lines, valid, hb, w, y0, h)
    assert (i_ref >= 0).any() and ((i_ref < 0) & (d_ref > 0)).any()
    np.testing.assert_array_equal(index, i_ref.numpy())
    np.testing.assert_array_equal(depth, d_ref.numpy())


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("scene", B5_SCENES)
def test_b5_stages_reproduce_plain_resolve(scene, stage):
    """Kernel B5's rejects alone, without the queue, emulated: the box
    reject (1), the box and line rejects (2); each leaves the plain resolve
    bit for bit."""
    rows, meta, ends, (setup, lines, valid), h, w = _packed_lines(scene)
    depth, index, _ = _emulate_b5(rows.numpy(), meta.numpy(), ends.numpy(), h, w, stage=stage)
    d_ref, i_ref = _rasterize_lines_plain(setup, lines, valid, h, w, 0, h)
    np.testing.assert_array_equal(index, i_ref.numpy())
    np.testing.assert_array_equal(depth, d_ref.numpy())


def _inverse8_lines(h=128, gn=21, views=2):
    """pack_lines' rows of the inverse8 scene's views through transform, at
    the full scene's triangle size in pixels (~5.5 px grid cells)."""
    a = inverse8_scene_arrays(h, gn, views)
    cams = {k: torch.from_numpy(a[k]) for k in ("campos", "camrot", "focal", "princpt")}
    v = tt.transform(torch.from_numpy(a["v_world"]).expand(views, -1, -1), **cams)
    vi = broadcast_vi(torch.from_numpy(with_edge_flags(a["vi"])), views)
    setup, lines = triangle_setup(v, vi), line_setup(v, vi)
    valid = _canvas_cull(setup, h, h)
    return rasterize_cuda.pack_lines(setup, lines, valid, h, h, 0, h), h


def test_b5_rejects_cut_the_edge_tests_on_inverse8():
    """On the inverse8 views, the (pixel, edge) pairs left to the side tests
    per window pixel, out of 3 visible edges: at most 1.3 after the box
    reject, at most 0.3 after the line reject; a warp seeks new triangles
    in at most two steps per window boundary; the kernel's queue (stage 3)
    takes them in far fewer passes than one per step; and chip_smoke.py's
    model of the edge tests (modeled_edge_tests, its own walk over the
    packed rows) counts what the emulation does."""
    (rows, meta, ends), h = _inverse8_lines()
    counts = {stage: _emulate_b5(rows.numpy(), meta.numpy(), ends.numpy(), h, h, stage=stage, warps=64)[2]
              for stage in (1, 2, 3)}
    pixels = counts[1]["window_pixels"]
    assert counts[1]["visible_edges"] == 3 * pixels
    assert counts[1]["edge_tests"] <= 1.3 * pixels
    assert counts[2]["edge_tests"] <= 0.3 * pixels
    assert counts[3]["edge_tests"] == counts[2]["edge_tests"]
    # a warp steps into a new window in at most two steps per window boundary
    windows = int((np.diff(np.concatenate([[0], ends.numpy()])) > 0).sum())
    assert counts[3]["seek_steps"] <= 2 * windows + counts[3]["runs"]
    # stage 3 queues the (pixel, edge) pairs past the line reject, and tests
    # them in a pass of 32 per 3 steps of 32 pixels or fewer
    assert counts[2]["edge_tests"] <= counts[3]["queued"] <= 0.5 * pixels
    assert counts[3]["queue_passes"] <= counts[3]["warp_steps"] / 3
    model = chip_smoke.modeled_edge_tests(rows, meta, ends, chunk=1 << 14)
    assert model["window_pixels"] == pixels and model["visible"] == 3.0
    for stage, name in ((1, "box"), (2, "line")):
        assert model[f"edges_{name}"] * pixels == counts[stage]["edge_tests"]
        assert model[f"sides_{name}"] * pixels == counts[stage]["side_tests"]
    assert model["edges_queued"] * pixels == counts[3]["queued"]


def _ulps(x, steps=(-2, -1, 0, 1, 2)):
    """float32 x moved by each of ``steps`` ulps."""
    x = np.float32(x)
    out = []
    for k in steps:
        y = x
        for _ in range(abs(k)):
            y = np.nextafter(y, np.float32(np.copysign(np.inf, k)))
        out.append(y)
    return np.array(out, np.float32)


def _b5_sides_at(args, stage, wide=False):
    """The sides tested for segments and pixels ``args`` (float32 arrays,
    p1x p1y p2x p2y px py) of a visible edge whose window ends at the pixel,
    or with ``wide`` at 4094 (its thresholds then hold for a larger
    window)."""
    p1x, p1y, p2x, p2y, px, py = args
    x, y = px.astype(np.int64), py.astype(np.int64)
    hi = (np.maximum(x, 4094), np.maximum(y, 4094)) if wide else (x, y)
    return _b5_sides(p1x, p1y, p2x, p2y, True, (np.ones_like(x), hi[0], np.ones_like(y), hi[1]), px, py, stage)[1]


def _assert_reject_keeps_every_hit(p1x, p1y, p2x, p2y, px, py):
    """Every (edge, pixel, side) that the full side test accepts survives
    the box reject (stage 1), the box and line rejects (2, thresholds from
    the pixel's own window and from a wider one) and the kernel's (3);
    returns the accepted count."""
    args = np.broadcast_arrays(*(np.asarray(a, np.float32) for a in (p1x, p1y, p2x, p2y, px, py)))
    hits = _b5_side_hits(*args)
    for stage, wide in ((1, False), (2, False), (2, True), (3, False)):
        kept = (_b5_sides_at(args, stage, wide)[None] >> np.arange(4).reshape(4, *[1] * args[0].ndim)) & 1 == 1
        assert not (hits & ~kept).any(), f"stage {stage} rejects a side the full test accepts"
    return int(hits.sum())


def _near_segment(px, py, q, direction, lengths):
    """Segment through q along ``direction`` with the given lengths either
    side, every endpoint coordinate moved by -2..2 ulps (625 variants)."""
    d = np.asarray(direction, np.float64) / np.hypot(*direction)
    p1 = np.asarray(q) - lengths[0] * d
    p2 = np.asarray(q) + lengths[1] * d
    grids = np.meshgrid(_ulps(p1[0]), _ulps(p1[1]), _ulps(p2[0]), _ulps(p2[1]), indexing="ij")
    return [g.ravel() for g in grids] + [np.float32(px), np.float32(py)]


_PIXEL = st.tuples(st.integers(1, 4094), st.integers(1, 4094))
_LENGTHS = st.tuples(st.floats(0.0, 40.0), st.floats(0.0, 40.0))
_CORNERS = [(0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5)]
_SIDES = [((0.25, -0.25), (1.0, 1.0)), ((0.25, 0.25), (-1.0, 1.0)), ((-0.25, 0.25), (-1.0, -1.0)),
          ((-0.25, -0.25), (1.0, -1.0))]


@st.composite
def _reach_segments(draw):
    """Through a diamond corner, or a hair outside or inside it."""
    (px, py), corner = draw(_PIXEL), draw(st.sampled_from(_CORNERS))
    scale = 1.0 + draw(st.sampled_from([0.0, 1e-7, -1e-7, 1e-6, -1e-6, 1e-4, -1e-4]))
    ang = draw(st.floats(0.0, np.pi))
    q = (px + corner[0] * scale, py + corner[1] * scale)
    return _near_segment(px, py, q, (np.cos(ang), np.sin(ang)), draw(_LENGTHS))


@st.composite
def _parallel_segments(draw):
    """Along a diamond side, turned and moved by a hair."""
    (px, py), (mid, direction) = draw(_PIXEL), draw(st.sampled_from(_SIDES))
    turn = draw(st.sampled_from([0.0, 1e-7, -1e-7, 1e-6, -1e-5])) + draw(st.floats(-1e-6, 1e-6))
    shift = draw(st.floats(-1e-5, 1e-5))
    ang = np.arctan2(direction[1], direction[0]) + turn
    q = (px + mid[0] - shift * direction[1], py + mid[1] + shift * direction[0])
    return _near_segment(px, py, q, (np.cos(ang), np.sin(ang)), draw(_LENGTHS))


@st.composite
def _degenerate_segments(draw):
    """Zero-length, or axis-aligned through or beside the diamond."""
    (px, py) = draw(_PIXEL)
    q = (px + draw(st.sampled_from([0.0, 0.5, -0.5, 0.25])), py + draw(st.sampled_from([0.0, 0.5, -0.5, 0.25])))
    direction = draw(st.sampled_from([(1.0, 0.0), (0.0, 1.0), (1.0, 1.0)]))
    lengths = draw(st.sampled_from([(0.0, 0.0), (0.0, 3.0), (2.0, 2.0)]))
    return _near_segment(px, py, q, direction, lengths)


_WILD = st.one_of(st.floats(-5000.0, 5000.0, width=32),
                  st.sampled_from([np.inf, -np.inf, np.nan, 1e30, -1e30, 3.4e38, -3.4e38, 1e-30, 0.0, 2.0**-120]))


@st.composite
def _wild_segments(draw):
    """Huge, tiny and non-finite endpoint coordinates."""
    (px, py) = draw(_PIXEL)
    return [np.float32(draw(_WILD)) for _ in range(4)] + [np.float32(px), np.float32(py)]


@pytest.mark.parametrize("segments", [_reach_segments, _parallel_segments, _degenerate_segments, _wild_segments],
                         ids=["reach", "parallel", "degenerate", "wild"])
def test_b5_reject_never_drops_a_crossing(segments):
    """Property: kernel B5's rejects (chip_smoke.b5_edge_sides on float32
    CPU tensors, rounded op by op) never drop a diamond side that the full
    side test (numpy float32) accepts; drawn at pixels up to 4094, with
    segments at a corner of the diamond's reach, nearly parallel to a side,
    degenerate, and with huge or non-finite coordinates, each within +-2
    ulps."""

    @settings(max_examples=150, deadline=None, database=None, derandomize=True)
    @given(segments())
    def check(args):
        _assert_reject_keeps_every_hit(*args)

    check()


def test_b5_rejects_are_exercised():
    """The property test's constructions reach accepted sides and rejected
    ones: a segment through a diamond corner is crossed at some ulp
    variants, and one 2.7 pixels away, whose box holds the pixel, passes
    the box reject and fails the line reject on every side."""
    args = _near_segment(100, 200, (100.5, 200.0), (1.0, 2.0), (5.0, 5.0))
    assert _assert_reject_keeps_every_hit(*args) > 0
    far = _near_segment(100, 200, (103.0, 200.0), (1.0, -2.0), (10.0, 10.0))  # its box holds the pixel
    far = np.broadcast_arrays(*(np.asarray(a, np.float32) for a in far))
    assert (_b5_sides_at(far, 2) == 0).all()
    assert (_b5_sides_at(far, 1) != 0).any()


def _emulate_b3(rows, index_img, num_faces):
    """numpy emulation of csrc/scatter_rows.cu: per 8 x 32 pixel tile of each
    image, each tile row (a warp) is cut into runs of equal clamped faces
    (background and the lanes past a ragged edge as -1); each foreground
    run is summed, the runs' partials are merged per face in a table, and
    each (tile, distinct face) adds its row to the output: one global
    atomic per (tile, distinct face, k). Returns (out, global atomics)."""
    n, h, w, k_dim = rows.shape
    tile_h, tile_w = 8, 32  # kTileH x kTileW
    out = np.zeros((n, num_faces, k_dim), rows.dtype)
    atomics = 0
    for b in range(n):
        for y0 in range(0, h, tile_h):
            for x0 in range(0, w, tile_w):
                table = {}
                for y in range(y0, min(y0 + tile_h, h)):
                    faces = np.full(tile_w, -1, np.int64)
                    run = index_img[b, y, x0 : x0 + tile_w]
                    faces[: run.size] = np.where(run >= 0, np.minimum(run, num_faces - 1), -1)
                    heads = np.flatnonzero(np.r_[True, faces[1:] != faces[:-1]])
                    for start, end in zip(heads, np.r_[heads[1:], tile_w]):
                        if faces[start] >= 0:
                            part = rows[b, y, x0 + start : x0 + end].sum(0)
                            table[faces[start]] = table.get(faces[start], 0) + part
                for f, part in table.items():
                    out[b, f] += part
                atomics += len(table) * k_dim
    return out, atomics


def _rasterized(scene):
    """The plain rasterizer's index image of a SCENES scene, and its face count."""
    make, h, w = SCENES[scene]
    s = make()
    return tt.rasterize(torch.from_numpy(s["v"]), torch.from_numpy(s["vi"]), h, w).numpy(), s["vi"].shape[0]


def _b3_index(case):
    """B3's index images: "grid" the coherent grid scene (~240 px
    triangles), "soup" random faces per pixel, "ragged" a 70x130 frame,
    "batch3" three soups, "background" no face, "one_face" one face
    everywhere, "clamped" faces up to F + 20 (clamped to F - 1)."""
    rng = np.random.RandomState(5)
    if case in ("grid", "ragged", "batch3"):
        return _rasterized({"grid": "grid", "ragged": "nonaligned", "batch3": "soup_batch3"}[case])
    if case == "soup":
        return rng.randint(-1, 40, (2, 24, 70)).astype(np.int32), 40
    if case == "clamped":
        return rng.randint(-1, 60, (1, 16, 64)).astype(np.int32), 40
    return np.full((1, 20, 40), -1 if case == "background" else 0, np.int32), 3


@pytest.mark.parametrize("case", ["grid", "soup", "ragged", "batch3", "background", "one_face", "clamped"])
def test_b3_emulation_matches_plain_and_counts_its_atomics(case):
    """Kernel B3's algorithm (emulated in numpy) sums as the plain version
    does (f64, 1e-12), and issues as many global atomics as there are
    (tile, clamped foreground face) pairs times K, the count
    chip_smoke.modeled_scatter_atomics reports for the card."""
    index_img, num_faces = _b3_index(case)
    k_dim = 5
    rows = np.random.RandomState(6).randn(*index_img.shape, k_dim)
    got, atomics = _emulate_b3(rows, index_img, num_faces)
    rows_t, idx_t = torch.from_numpy(rows), torch.from_numpy(index_img)
    want = segment_rows._scatter_rows_plain(rows_t, idx_t, num_faces)
    magnitude = segment_rows._scatter_rows_plain(rows_t.abs(), idx_t, num_faces)
    _magnitude_bound(torch.from_numpy(got), want, magnitude, torch.float64)
    n, h, w = index_img.shape
    tile_h, tile_w = chip_smoke.SCATTER_TILE
    b, y, x = np.nonzero(index_img >= 0)
    face = np.minimum(index_img[b, y, x], num_faces - 1)
    direct = len({(bb, yy // tile_h, xx // tile_w, ff) for bb, yy, xx, ff in zip(b, y, x, face)}) * k_dim
    assert atomics == direct == chip_smoke.modeled_scatter_atomics(idx_t, num_faces, k_dim)
    per_pixel = b.size * k_dim
    if case == "grid":  # coherent faces: the merge saves most of a per-pixel scatter's atomics
        assert 4 * atomics <= per_pixel
    if case in ("background", "one_face"):
        assert atomics == (0 if case == "background" else -(-h // tile_h) * -(-w // tile_w) * k_dim)


def _emulate_b4(rows, iy, ix, out_h, out_w, rows_hw):
    """numpy emulation of csrc/window_accum.cu: the taps, on their rows_hw
    grid, go in warp patches of 4 x 8 (1 x 32 on a grid of fewer than 8
    rows); a patch's live
    taps are grouped by texel, and each group's summed row is added to the
    table once: one global atomic per (patch, distinct texel, k). Returns
    (out, global atomics)."""
    n, k_dim, _ = rows.shape
    r_h, r_w = rows_hw
    patch_h, patch_w = (4, 8) if r_h >= 8 else (1, 32)
    out = np.zeros((n, k_dim, out_h, out_w), rows.dtype)
    atomics = 0
    for b in range(n):
        for gy0 in range(0, r_h, patch_h):
            for gx0 in range(0, r_w, patch_w):
                gy, gx = np.meshgrid(np.arange(gy0, min(gy0 + patch_h, r_h)),
                                     np.arange(gx0, min(gx0 + patch_w, r_w)), indexing="ij")
                p = (gy * r_w + gx).ravel()
                y, x = iy[b, p], ix[b, p]
                live = (y >= 0) & (y < out_h) & (x >= 0) & (x < out_w)
                groups = {}
                for tap, texel in zip(p[live], zip(y[live], x[live])):
                    groups[texel] = groups.get(texel, 0) + rows[b, :, tap]
                for (ty, tx), row in groups.items():
                    out[b, :, ty, tx] += row
                atomics += len(groups) * k_dim
    return out, atomics


def _uv_taps(table_hw):
    """Taps of the grid scene (128x256, ~240 px triangles): every pixel's
    bilinear border base texel of a ``table_hw`` texture at its
    interpolated uv, inert (iy = -1) at the background, whose uv carries
    interpolate's sweep."""
    s = make_scene_arrays(128, 256, 9)
    v, vi, vt = (torch.from_numpy(s[k]) for k in ("v", "vi", "vt"))
    idx = tt.rasterize(v, vi, 128, 256)
    _, bary = tt.render(v, vi, idx)
    uv = tt.interpolate(vt, vi, idx, bary) * 2.0 - 1.0
    t_h, t_w = table_hw
    bx = torch.floor(gs._compute_source_index(uv[:, 0], t_w, "border", False)).int().clamp(0, t_w - 1)
    by = torch.floor(gs._compute_source_index(uv[:, 1], t_h, "border", False)).int().clamp(0, t_h - 1)
    return torch.where(idx >= 0, by, -1).reshape(1, -1).numpy(), bx.reshape(1, -1).numpy()


def _b4_taps(case, k_dim=12):
    """B4's inputs: (rows [N, P, K], iy, ix, table (h, w), rows_hw).
    "coherent": the grid scene's taps on a 64x64 texture (~8 taps a texel);
    "scattered": random taps on a 200x300 table (~1 tap a texel);
    "mixed": both in one batch; "flat": the coherent taps in the flat order
    (warps of 32 consecutive taps); "ragged": a 13x37 tap grid with inert
    and outside taps; "inert": no live tap."""
    rng = np.random.RandomState(7)
    if case in ("coherent", "flat", "mixed"):
        iy, ix = _uv_taps((64, 64))
        table, rows_hw = (64, 64), (128, 256)
        if case == "mixed":
            iy = np.concatenate([iy, rng.randint(-1, 64, iy.shape)]).astype(np.int32)
            ix = np.concatenate([ix, rng.randint(0, 64, ix.shape)]).astype(np.int32)
        rows_hw = None if case == "flat" else rows_hw
    elif case == "scattered":
        iy = rng.randint(-1, 200, (2, 16 * 64)).astype(np.int32)
        ix = rng.randint(0, 300, (2, 16 * 64)).astype(np.int32)
        table, rows_hw = (200, 300), (16, 64)
    elif case == "ragged":
        gy, gx = np.meshgrid(np.arange(13), np.arange(37), indexing="ij")
        iy, ix = (gy // 2).reshape(1, -1).astype(np.int32), (gx // 3).reshape(1, -1).astype(np.int32)
        iy[0, ::7] = -1
        ix[0, 5::11] = 40  # past the table's 13 columns: dropped
        table, rows_hw = (7, 13), (13, 37)
    else:
        iy = np.full((1, 512), -1, np.int32)
        ix = rng.randint(-5000, 5000, (1, 512)).astype(np.int32)
        table, rows_hw = (10, 10), (16, 32)
    rows = rng.randn(iy.shape[0], iy.shape[1], k_dim)
    return rows, iy, ix, table, rows_hw


@pytest.mark.parametrize("case", ["coherent", "scattered", "mixed", "flat", "ragged", "inert"])
def test_b4_emulation_matches_plain_and_counts_its_atomics(case):
    """Kernel B4's algorithm (emulated in numpy) sums as the plain version
    does (f64, 1e-12); it issues as many global atomics as
    chip_smoke.modeled_window_atomics reports for the card, never more than one
    per (live tap, k), and far fewer where neighbouring taps share texels."""
    rows, iy, ix, (t_h, t_w), rows_hw = _b4_taps(case)
    rows_kp = rows.transpose(0, 2, 1)
    got, atomics = _emulate_b4(rows_kp, iy, ix, t_h, t_w, rows_hw or (1, iy.shape[1]))
    args = (torch.from_numpy(iy), torch.from_numpy(ix), t_h, t_w)
    want = window_accum._window_accumulate_plain(torch.from_numpy(rows_kp), *args)
    magnitude = window_accum._window_accumulate_plain(torch.from_numpy(np.abs(rows_kp)), *args)
    _magnitude_bound(torch.from_numpy(got), want, magnitude, torch.float64)
    assert atomics == chip_smoke.modeled_window_atomics(*args, rows.shape[-1], rows_hw or (1, iy.shape[1]))
    live = int(((iy >= 0) & (iy < t_h) & (ix >= 0) & (ix < t_w)).sum()) * rows.shape[-1]
    assert atomics <= live
    if case in ("coherent", "flat"):  # ~8 taps a texel: the warp's sums save most of a per-tap scatter's atomics
        assert 3 * atomics <= live
    if case == "scattered":
        assert 10 * atomics >= 9 * live
    if case == "inert":
        assert atomics == 0


def test_rows_hw_changes_no_result():
    """row_gather and window_accumulate give the same results with and
    without the taps' 2-D shape, forward and backward; a shape that does
    not flatten to the taps raises."""
    rows, iy, ix, (t_h, t_w), rows_hw = _b4_taps("coherent", k_dim=3)
    rows_kp = torch.from_numpy(rows).transpose(1, 2)
    iy_t, ix_t = torch.from_numpy(iy), torch.from_numpy(ix)
    flat = window_accum.window_accumulate(rows_kp, iy_t, ix_t, t_h, t_w)
    assert torch.equal(window_accum.window_accumulate(rows_kp, iy_t, ix_t, t_h, t_w, rows_hw=rows_hw), flat)
    table = torch.from_numpy(np.random.RandomState(8).randn(1, t_h * t_w, 3)).requires_grad_()
    idx = torch.from_numpy(np.clip(iy, 0, None) * t_w + ix).long()
    grads = []
    for hw in (None, rows_hw):
        out = row_gather(table, idx, (t_h, t_w), rows_hw=hw)
        (grad,) = torch.autograd.grad((out * torch.from_numpy(rows)).sum(), table)
        grads.append((out, grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    with pytest.raises(ValueError, match="rows_hw"):
        row_gather(table, idx, (t_h, t_w), rows_hw=(127, 256))
    with pytest.raises(ValueError, match="rows_hw"):
        window_accum.window_accumulate(rows_kp, iy_t, ix_t, t_h, t_w, rows_hw=(256, 256))


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
    before = tt.kernel_launch_counts()["B2 gather_rows"]
    got = segment_rows.gather_rows_by_index(table.to(cuda_device), idx.to(cuda_device))
    torch.cuda.synchronize()
    assert tt.kernel_launch_counts()["B2 gather_rows"] == before + 1
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
    before = tt.kernel_launch_counts()["B1 rasterize"]
    d, i = tt.rasterize_with_depth(v, vi, h, w)
    torch.cuda.synchronize()
    assert tt.kernel_launch_counts()["B1 rasterize"] == before + 1
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
@pytest.mark.parametrize("image", ["random", "grid"])
@pytest.mark.parametrize("k_dim", [1, 6, 9, 16, 42])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scatter_kernel_matches_plain(cuda_device, k_dim, dtype, image):
    """Random faces per pixel (batch 2, a 70x130 frame: ragged tiles), or
    the grid scene's coherent index image, where a tile merges its pixels
    into few faces; clamped and background indices in both. K = 42 takes
    three channel chunks in f32 and six in f64."""
    rng = np.random.RandomState(k_dim)
    if image == "random":
        f_cnt = 300
        idx = torch.from_numpy(rng.randint(-1, f_cnt, (2, 70, 130)).astype(np.int32))
    else:
        idx_np, f_cnt = _rasterized("grid")
        idx = torch.from_numpy(idx_np)
    idx[0, 0, :3] = torch.tensor([-5, f_cnt - 1, f_cnt + 7], dtype=torch.int32)
    rows = torch.from_numpy(rng.randn(*idx.shape, k_dim)).to(dtype)
    want = segment_rows._scatter_rows_plain(rows, idx, f_cnt)
    magnitude = segment_rows._scatter_rows_plain(rows.abs(), idx, f_cnt)
    before = tt.kernel_launch_counts()["B3 scatter_rows"]
    got = segment_rows.scatter_rows_to_faces(rows.to(cuda_device), idx.to(cuda_device), f_cnt)
    torch.cuda.synchronize()
    assert tt.kernel_launch_counts()["B3 scatter_rows"] == before + 1
    assert got.dtype == dtype and got.shape == (idx.shape[0], f_cnt, k_dim)
    _magnitude_bound(got.cpu(), want, magnitude, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("taps", ["random", "coherent", "mixed", "flat", "ragged"])
@pytest.mark.parametrize("k_dim", [3, 12, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_window_kernel_matches_plain(cuda_device, dtype, k_dim, taps):
    """Random taps (inert and outside ones too) in the flat order, and the
    taps of _b4_taps: coherent ones with their 2-D shape, whose warps merge
    many taps per texel, and in the flat order, a batch that mixes them with
    scattered ones, and a ragged grid. K = 12 (a 3-channel texture's quad
    rows) in f32 takes the compile-time kernel; K = 3 (nearest mode) the
    run-time K with value-by-value staging, 40 four channel chunks in f32
    and seven in f64."""
    if taps == "random":
        rng = np.random.RandomState(3)
        n, p, out_h, out_w = 2, 5000, 37, 61
        rows_pk = torch.from_numpy(rng.randn(n, p, k_dim)).to(dtype)
        iy = torch.from_numpy(rng.randint(-2, out_h + 2, (n, p)).astype(np.int32))  # inert and outside taps too
        ix = torch.from_numpy(rng.randint(-2, out_w + 2, (n, p)).astype(np.int32))
        rows_hw = None
    else:
        rows, iy, ix, (out_h, out_w), rows_hw = _b4_taps(taps, k_dim)
        rows_pk, iy, ix = torch.from_numpy(rows).to(dtype), torch.from_numpy(iy), torch.from_numpy(ix)
    n, p, k_dim = rows_pk.shape
    want = window_accum._window_accumulate_plain(rows_pk.transpose(1, 2), iy, ix, out_h, out_w)
    magnitude = window_accum._window_accumulate_plain(rows_pk.abs().transpose(1, 2), iy, ix, out_h, out_w)
    before = tt.kernel_launch_counts()["B4 window_accum"]
    # the [N, P, K] rows as their [N, K, P] view, as the row scatter passes them
    got = window_accum.window_accumulate(
        rows_pk.to(cuda_device).transpose(1, 2), iy.to(cuda_device), ix.to(cuda_device), out_h, out_w,
        rows_hw=rows_hw)
    torch.cuda.synchronize()
    assert tt.kernel_launch_counts()["B4 window_accum"] == before + 1
    assert got.dtype == dtype and got.shape == (n, k_dim, out_h, out_w)
    _magnitude_bound(got.cpu(), want, magnitude, dtype)


@pytest.mark.cuda
def test_fit_step_kernels_match_plain(cuda_device):
    s = make_scene_arrays(128, 256, 9)
    v, vi, vt, tex = (torch.from_numpy(s[k]).to(cuda_device) for k in ("v", "vi", "vt", "tex"))
    tt.reset_kernel_launch_counts()
    loss, grads = fit_step(v, vi, vt, tex, 128, 256)
    torch.cuda.synchronize()
    assert tt.kernel_launch_counts() == {  # edge_grad's backward is one E1 launch, no B2 or B3
        **NO_LAUNCHES, "B1 rasterize": 1, "B2 gather_rows": 4, "B3 scatter_rows": 2, "B4 window_accum": 1,
        "E1 edge_grad": 1,
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
@pytest.mark.parametrize("scene", B5_SCENES)
def test_lines_kernel_matches_plain(cuda_device, scene):
    """Kernel B5 against the plain wireframe resolve; on the near-miss and
    4096-wide scenes bit for bit."""
    s, h, w = _wire(scene)
    v = torch.from_numpy(s["v"]).to(cuda_device)
    vi = torch.from_numpy(s["vi"]).to(cuda_device)
    before = tt.kernel_launch_counts()["B5 rasterize_lines"]
    d, i = tt.rasterize_with_depth(v, vi, h, w, wireframe=True)
    torch.cuda.synchronize()
    assert tt.kernel_launch_counts()["B5 rasterize_lines"] == before + 1
    d_ref, i_ref = tt.rasterize_with_depth(v, vi, h, w, wireframe=True, impl="plain")
    assert bool((i >= 0).any())
    _assert_raster_match(d_ref, i_ref, d, i)
    if scene in LINE_SCENES:
        assert torch.equal(i, i_ref) and torch.equal(d, d_ref)


@pytest.mark.cuda
def test_lines_kernel_raises_past_32_bit_windows(cuda_device):
    """B5's in-window offsets are 32-bit: the wrapper refuses H*W >= 2**31
    before it allocates anything."""
    rows = torch.zeros((1, 1, rasterize_cuda.LINE_FLOATS), device=cuda_device)
    meta = torch.zeros((1, 1, rasterize_cuda.LINE_INTS), dtype=torch.int32, device=cuda_device)
    ends = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    allocated = torch.cuda.memory_allocated(cuda_device)
    with pytest.raises(ValueError, match="32-bit"):
        rasterize_cuda.resolve_lines_packed(rows, meta, ends, 65536, 65536)
    assert torch.cuda.memory_allocated(cuda_device) == allocated


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
        **NO_LAUNCHES, "B1 rasterize": 1, "B2 gather_rows": 4, "B3 scatter_rows": 1, "B4 window_accum": 1,
        "E1 edge_grad": 1,
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


@pytest.mark.cuda
def test_tracer_spans_match_the_profiler(cuda_device):
    """The tracer on inverse8_step at the benchmark's size (8 views of
    1024^2, 51,200 triangles), 5 steps under torch.profiler. Each op span
    name's CUDA-event device ms, summed over the steps, is the profiler's
    device time of the work launched while its ``record_function`` ranges
    were open plus the device's idle time while the host was inside them, to
    10 % (names whose kernels take 1 ms or more; shorter spans are a few
    launches, of the size of their events' own cost). The step's top-level
    spans (whose ranges on the main thread hold none of the backward's
    kernels, which autograd's thread launches) sum to within 5 % of the
    step's time between CUDA events at the steps' ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from drtk_tpu_torch import tracing

    s = {k: torch.from_numpy(a).to(cuda_device) for k, a in inverse8_scene_arrays(1024, 161, 8, tex_size=512).items()}
    cams = {k: s[k] for k in ("campos", "camrot", "focal", "princpt")}
    with torch.no_grad():
        img_gt, _ = tt.render_multiview(s["v_world"], s["vi"], s["vt"], s["tex_gt"], cams, 1024, 1024)
    p = ((s["v_world"] + 0.02).requires_grad_(), torch.full_like(s["tex_gt"], 0.5).requires_grad_())
    opt = torch.optim.Adam(p, lr=1e-3)

    def step():
        inverse8_step(p, opt, s["vi"], s["vt"], cams, img_gt, 1024, 1024)

    for _ in range(3):
        step()
    tracer, ends = tracing.Tracer(), []
    # a first step under the profiler takes its start-up, and is not kept
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=5)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        with tracer:
            first = torch.cuda.Event(enable_timing=True)
            first.record()
            for i in range(5):
                step()
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
                if i < 4:
                    prof.step()  # not after the last: ending the cycle would drop its events
            torch.cuda.synchronize()
    spans = tracer.snapshot()["spans"]
    tops = [sp for sp in spans if sp["parent"] is None]
    event_ms, ranges, launched_at, device = {}, {}, {}, []
    for sp in spans:
        if sp["parent"] is not None:
            event_ms[sp["name"]] = event_ms.get(sp["name"], 0.0) + sp["device_end_ms"] - sp["device_start_ms"]
    # The profiler's own records, in ns of the host's clock: the spans'
    # ranges, the runtime calls that launch device work (a kernel launched
    # from the port's C code has no aten op around it), the device work.
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU:
            if ev.is_user_annotation() and ev.name() in event_ms:
                ranges.setdefault(ev.name(), []).append((ev.start_ns(), ev.end_ns()))
            elif ev.name().startswith("cuda"):
                launched_at[ev.correlation_id()] = ev.start_ns()
        elif not ev.is_user_annotation():
            device.append((ev.start_ns(), ev.end_ns(), ev.correlation_id()))
    device.sort()
    gaps, cur_end = [], device[0][1]
    for start, end, _ in device[1:]:
        if start > cur_end:
            gaps.append((cur_end, start))
        cur_end = max(cur_end, end)
    assert set(ranges) == set(event_ms)

    def inside(rs, t):
        return any(r0 <= t <= r1 for r0, r1 in rs)

    readings = {}
    for name, rs in ranges.items():
        kern = sum(end - start for start, end, corr in device if inside(rs, launched_at.get(corr, -1))) / 1e6
        idle = sum(max(0, min(g1, r1) - max(g0, r0)) for r0, r1 in rs for g0, g1 in gaps) / 1e6
        readings[name] = (event_ms[name], kern, idle)
    for name, (ev, kern, idle) in readings.items():
        assert kern < 1.0 or abs(ev - kern - idle) <= 0.1 * ev, (name, readings)
    assert {"rasterize", "grid_sample_bwd", "render_bwd"} <= {k for k, v in readings.items() if v[1] >= 1.0}
    step_ms = [a.elapsed_time(b) for a, b in zip([first] + ends[:-1], ends)]
    assert [sp["name"] for sp in tops] == ["forward", "backward", "adam"] * 5
    for i, ms in enumerate(step_ms):
        top_ms = sum(sp["device_end_ms"] - sp["device_start_ms"] for sp in tops[3 * i : 3 * i + 3])
        assert abs(top_ms - ms) <= 0.05 * ms, (i, top_ms, ms)


def _e1_scene(scene):
    """E1's inputs on the CPU: vertices, per-batch faces, an index image, a
    seeded 4-channel image and cotangent, and bary. "grid" has pixel
    centres on its diagonals; "soup" is a ragged 70 x 130 frame; "batch3"
    three soups; "background" no face; "one_face" one triangle on
    background; "clamped" a soup whose index reaches F + 20 (clamped to
    F - 1); "intersecting" two triangles whose depths cross; "vi_range" a
    soup whose faces name vertices past V and below 0 (clamped into
    [0, V - 1], as every gather of the port clamps them); "batch2_vi" two
    soups with a face list each; "near_miss" edges at a pixel diamond's
    reach, to within ulps; "grid_offset" the grid moved off the pixel
    centres (general position, for comparisons with JAX on the CPU, whose
    XLA contracts products into FMAs)."""
    make, h, w = {
        "grid": SCENES["grid"], "soup": SCENES["nonaligned"], "batch3": SCENES["soup_batch3"],
        "background": SCENES["nonaligned"], "clamped": SCENES["nonaligned"], "vi_range": SCENES["nonaligned"],
        "one_face": (lambda: {"v": np.float32([[[10.3, 5.2, 4.0], [100.7, 20.1, 5.0], [40.2, 60.6, 6.0]]]),
                              "vi": np.int32([[0, 1, 2]])}, 70, 130),
        "intersecting": (lambda: {"v": np.float32([[[10.3, 8.1, 3.0], [118.7, 12.2, 7.0], [14.4, 62.9, 3.2],
                                                    [8.2, 20.6, 7.1], [121.5, 30.3, 2.9], [60.7, 66.1, 5.0]]]),
                                  "vi": np.int32([[0, 1, 2], [3, 4, 5]])}, 70, 130),
        "batch2_vi": (lambda: {**_soup(2, 48, 64, 70, 130, 5),
                               "vi": np.random.RandomState(6).randint(0, 48, (2, 64, 3)).astype(np.int32)}, 70, 130),
        "near_miss": (lambda: chip_smoke.near_miss_scene(64, 128), 64, 128),
        "grid_offset": (lambda: _offset(make_scene_arrays(128, 256, 9)), 128, 256),
    }[scene]
    s = make()
    v = torch.from_numpy(s["v"])
    vi = broadcast_vi(torch.from_numpy(s["vi"]), v.shape[0])
    idx = tt.rasterize(v, vi, h, w)
    _, bary = tt.render(v, vi, idx)
    if scene == "background":
        idx = torch.full_like(idx, -1)
    if scene == "clamped":
        idx = torch.where(idx % 5 == 1, idx + vi.shape[1] + 20, idx)
    if scene == "vi_range":
        vi = vi.clone()
        vi[:, ::3, 0] += v.shape[1] + 7
        vi[:, 1::4, 2] = -3
    gen = torch.Generator().manual_seed(3)
    img = torch.rand((v.shape[0], 4, h, w), generator=gen)
    g = torch.randn((v.shape[0], 4, h, w), generator=gen)
    return v, vi, idx, img, g, bary


def _offset(s):
    """The scene moved by a fraction of a pixel in x and y."""
    return {**s, "v": (s["v"] + np.float32([0.173, 0.291, 0.0])).astype(np.float32)}


E1_SCENES = ["grid", "soup", "batch3", "background", "one_face", "clamped", "intersecting", "vi_range",
             "batch2_vi", "near_miss"]
E1_VIEWPORTS = ["frame", "channels_last", "band", "last_band"]


def _e1_viewport(viewport, idx, img, g, bary):
    """(y_offset, full_height, idx, img, g, bary) of a viewport of the frame:
    the whole frame (-1: no row tile); "channels_last", the whole frame with
    img, g and bary in channels-last layout (as a shading pipeline's
    products come out); "band", the 24 rows from H/3 and the halo row below
    them (the next band's first row), as the banded path slices a band;
    "last_band", the last 24 rows, with no halo row (the frame's last row
    holds no stencil centre). Strided slices of the frame."""
    h = idx.shape[1]
    if viewport in ("frame", "channels_last"):
        if viewport == "channels_last":
            img, g, bary = (t.contiguous(memory_format=torch.channels_last) for t in (img, g, bary))
        return 0, -1, idx, img, g, bary
    y0 = h // 3 if viewport == "band" else h - 24
    rows = slice(y0, y0 + 25)
    return y0, h, idx[:, rows], img[:, :, rows], g[:, :, rows], bary[:, :, rows]


def _e1_image_plain(v, vi, idx, img, g, max_dp_dr, y0, frame_h):
    """E1's image mode in plain PyTorch."""
    return edge_grad_mod._stencil_plain(_stencil_table(v, vi), idx, img, g, None, max_dp_dr, y0, frame_h)


def _assert_verts_close(got, want, rel):
    """Values within ``rel`` of the largest magnitude. (Not the nonzero
    vertices: a vertex's sum may cancel to exactly 0 in one order of the
    atomics and not in another, within the limit.)"""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got - want).abs().max() <= rel * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["verts", "image"])
@pytest.mark.parametrize("max_dp_dr", [1e4, 0.0])
@pytest.mark.parametrize("viewport", E1_VIEWPORTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scene", E1_SCENES)
def test_edge_grad_kernel_matches_plain(cuda_device, scene, dtype, viewport, max_dp_dr, mode):
    """E1 against its plain version on the card, one launch each. Verts
    mode: values within 1e-5 (f32) or 1e-12 (f64) of the largest magnitude
    (the atomics add in another order than the plain version's two
    index_add_ passes). Image mode: the same nonzero pixels, values within
    the same limits."""
    v, vi, idx, img, g, bary = (t.to(cuda_device) for t in _e1_scene(scene))
    v, img, g, bary = (t.to(dtype) for t in (v, img, g, bary))
    y0, frame_h, idx, img, g, bary = _e1_viewport(viewport, idx, img, g, bary)
    limit = 1e-12 if dtype == torch.float64 else 1e-5
    before = tt.kernel_launch_counts()["E1 edge_grad"]
    if mode == "verts":
        got = edge_grad_mod.edge_grad_to_verts(v, vi, idx, img, g, bary, max_dp_dr, y0, frame_h)
        assert tt.kernel_launch_counts()["E1 edge_grad"] == before + 1
        want = edge_grad_mod.edge_grad_to_verts(v, vi, idx, img, g, bary, max_dp_dr, y0, frame_h, impl="plain")
        torch.cuda.synchronize()
        _assert_verts_close(got, want, limit)
    else:
        got = edge_grad_mod._e1_cuda(v, vi, idx, img, g, None, max_dp_dr, y0, frame_h)
        assert tt.kernel_launch_counts()["E1 edge_grad"] == before + 1
        want = _e1_image_plain(v, vi, idx, img, g, max_dp_dr, y0, frame_h)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        assert torch.equal((got != 0).any(1), (want != 0).any(1))
        assert (got - want).abs().max() <= limit * want.abs().max()
    if scene != "background":
        assert bool((want != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_grad_bands_add_into_one_accumulator(cuda_device, dtype):
    """Two bands of a frame (the first with its halo row) added by E1 into
    one accumulator, which the wrapper zeroes once: the full frame's vertex
    gradient, one launch a band."""
    v, vi, idx, img, g, bary = (t.to(cuda_device) for t in _e1_scene("soup"))
    v, img, g, bary = (t.to(dtype) for t in (v, img, g, bary))
    h, hb = idx.shape[1], idx.shape[1] // 2
    tt.reset_kernel_launch_counts()
    acc = None
    for y0 in (0, hb):
        rows = slice(y0, y0 + hb + 1)
        out = edge_grad_mod.edge_grad_to_verts(v, vi, idx[:, rows], img[:, :, rows], g[:, :, rows],
                                               bary[:, :, rows], 1e4, y0, h, out=acc)
        assert acc is None or out is acc
        acc = out
    assert tt.kernel_launch_counts() == {**NO_LAUNCHES, "E1 edge_grad": 2}
    want = edge_grad_mod.edge_grad_to_verts(v, vi, idx, img, g, bary, 1e4, impl="plain")
    torch.cuda.synchronize()
    _assert_verts_close(acc, want, 1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_grad_kernel_under_contention(cuda_device, dtype):
    """The entry scene (128 large triangles at 256^2): along a silhouette
    the 32 lanes of a warp add into the same 9 addresses. The result is the
    plain version's."""
    s = entry_scene_arrays(h=256, w=256)
    v = torch.from_numpy(s["v"]).to(cuda_device, dtype)
    vi = broadcast_vi(torch.from_numpy(s["vi"]).to(cuda_device), 1)
    idx = tt.rasterize(v.float(), vi, 256, 256)
    _, bary = tt.render(v, vi, idx)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    img = torch.rand((1, 3, 256, 256), generator=gen, device=cuda_device, dtype=dtype)
    g = torch.randn((1, 3, 256, 256), generator=gen, device=cuda_device, dtype=dtype)
    got = edge_grad_mod.edge_grad_to_verts(v, vi, idx, img, g, bary, 1e4)
    want = edge_grad_mod.edge_grad_to_verts(v, vi, idx, img, g, bary, 1e4, impl="plain")
    torch.cuda.synchronize()
    assert bool((want != 0).any())
    _assert_verts_close(got, want, 1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.cuda
def test_edge_grad_kernel_has_no_fallback(cuda_device, monkeypatch):
    """A CUDA tensor never takes the plain version: when the build fails,
    the backward raises."""

    def failed_build(*args, **kwargs):
        raise RuntimeError("nvcc failed for csrc/edge_grad.cu")

    v, vi, idx, img, g, bary = (t.to(cuda_device) for t in _e1_scene("soup"))
    monkeypatch.setattr(edge_grad_mod._build, "entry", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        edge_grad_mod.edge_grad_to_verts(v, vi, idx, img, g, bary, 1e4)


@pytest.mark.cuda
def test_edge_grad_wrapper_refuses_on_the_card(cuda_device):
    """E1's wrapper refuses, before any launch, what the kernel does not
    take: CPU and CUDA tensors mixed, an int64 index, an accumulator of
    another shape."""
    v, vi, idx, img, g, bary = (t.to(cuda_device) for t in _e1_scene("soup"))
    before = tt.kernel_launch_counts()["E1 edge_grad"]
    with pytest.raises(ValueError, match="one CUDA device"):
        edge_grad_mod.edge_grad_to_verts(v, vi, idx, img.cpu(), g, bary, 1e4)
    with pytest.raises(ValueError, match="one CUDA device"):
        edge_grad_mod.edge_grad_to_verts(v, vi, idx, img, g, bary, 1e4, out=torch.zeros_like(v).cpu())
    with pytest.raises(TypeError, match="int32"):
        edge_grad_mod.edge_grad_to_verts(v, vi, idx.long(), img, g, bary, 1e4)
    with pytest.raises(ValueError, match="out must be"):
        edge_grad_mod.edge_grad_to_verts(v, vi, idx, img, g, bary, 1e4, out=torch.zeros_like(v[:, :-1]))
    assert tt.kernel_launch_counts()["E1 edge_grad"] == before


@pytest.mark.cuda
def test_edge_grad_kernel_raises_past_32_bit_offsets(cuda_device):
    """Past 2**31 pixels within a batch or 65535 batches: refused before
    anything is allocated or launched (stride-0 views stand in for the
    tensors)."""
    v = torch.zeros((1, 3, 3), device=cuda_device)
    vi = torch.zeros((1, 1, 3), dtype=torch.int32, device=cuda_device)
    big_idx = torch.zeros((), dtype=torch.int32, device=cuda_device).expand(1, 2**16, 2**15)
    big = torch.zeros((), device=cuda_device).expand(1, 3, 2**16, 2**15)
    allocated = torch.cuda.memory_allocated(cuda_device)
    with pytest.raises(ValueError, match="32-bit"):
        edge_grad_mod.edge_grad_to_verts(v, vi, big_idx, big, big, big, 1e4)
    assert torch.cuda.memory_allocated(cuda_device) == allocated
    small = torch.zeros((2**16, 1, 2, 2), device=cuda_device)
    with pytest.raises(ValueError, match="65535"):
        edge_grad_mod.edge_grad_to_verts(v.expand(2**16, -1, -1), vi.expand(2**16, -1, -1), small[:, 0].int(),
                                         small, small, small.expand(-1, 3, -1, -1), 1e4)


def test_window_accumulate_refuses_2_31_taps():
    """B4's tap offsets are 32-bit: the wrapper refuses 2**31 taps per batch
    before it allocates or builds (stride-0 views stand in for the tensors;
    the check runs before the device is used)."""
    taps = torch.zeros((), dtype=torch.int32).expand(1, 2**31)
    rows = torch.zeros(()).expand(1, 12, 2**31)
    with pytest.raises(ValueError, match="2\\*\\*31 taps"):
        window_accum._window_accumulate_cuda(rows, taps, taps, 4, 4, (2**16, 2**15))


AV_BAND = (2048, 64)  # rows [2048, 2112) of the avatar4k frame: a 64 x 4096 band


@pytest.fixture(scope="module")
def avatar4k_frame():
    """The avatar4k scene at 4096^2 on the card (16^2 rays), with its full
    frame's index and bary images."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run with -m cuda on the card)")
    dev = torch.device("cuda")
    s = tt.interop.scene_from_numpy(avatar4k_scene_arrays(4096, 226, 16), dev)
    with torch.no_grad():
        idx = tt.rasterize(s["v"], s["vi"], 4096, 4096)
        _, bary = tt.render(s["v"], s["vi"], idx)
    return s, idx, bary


def _b4_close(args):
    got = window_accum._window_accumulate_cuda(*args)
    want = window_accum._window_accumulate_plain(*args[:5])
    magnitude = window_accum._window_accumulate_plain(args[0].abs(), *args[1:5])
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-6 * magnitude).all())
    assert bool((want != 0).any())


def _capture_m1(monkeypatch, fn):
    """The arguments of M1's launches that ``fn`` makes (a stand-in for
    ``mipmap_grid_sample._m1_cuda``): forward (levels, grid, Jacobian,
    options), backward with the cotangent."""
    launch, calls = mipmap_mod._m1_cuda, []

    def spy(*args):
        calls.append(args)
        return launch(*args)

    monkeypatch.setattr(mipmap_mod, "_m1_cuda", spy)
    fn()
    monkeypatch.undo()
    return calls


def _m1_close(fwd, cot):
    """M1 against the composite (impl="plain") on the card, on one launch
    pair's arguments: the output, the grid's gradient and every level's
    within 1e-5 of the largest summed magnitude (the composite on the levels'
    and the cotangent's magnitudes: every weight is non-negative; the
    grid's: of its largest magnitude). Atomics order the level sums."""
    levels, grid, jac, opts = fwd
    max_aniso, pad, force, clip = opts

    def composite(lv, g):
        lv = [x.detach().requires_grad_() for x in lv]
        gr = grid.detach().requires_grad_()
        out = tt.mipmap_grid_sample(lv, gr, jac, max_aniso, "bilinear", pad, force_max_aniso=force, clip_grad=clip,
                                    impl="plain")
        return (out.detach(), *torch.autograd.grad(out, [gr, *lv], g))

    got = mipmap_mod._m1_cuda(levels, grid, jac, opts)
    got_grid, got_levels = mipmap_mod._m1_cuda(levels, grid, jac, opts, cot)
    want = composite(levels, cot)
    summed = composite([x.abs() for x in levels], cot.abs())
    torch.cuda.synchronize()
    assert (got - want[0]).abs().max() <= 1e-5 * summed[0].abs().max()
    assert (got_grid - want[1]).abs().max() <= 1e-5 * want[1].abs().max()
    for g, w, m in zip(got_levels, want[2:], summed[2:]):
        assert (g - w).abs().max() <= 1e-5 * m.max()
    assert bool((want[2] != 0).any())


@pytest.mark.cuda
def test_m1_matches_composite_on_an_avatar4k_band(avatar4k_frame, monkeypatch):
    """The mipmap of band 0 of the avatar4k step (1 x 1024 x 4096 pixels,
    the 4-level 3 x 512^2 pyramid, bilinear, border, max_aniso 2,
    clip_grad): its one M1 launch each way, captured, against the composite
    on the same inputs; no B4 launch, and most corner adds go through the
    blocks' windows."""
    s, _, _ = avatar4k_frame
    levels = [x.clone().requires_grad_() for x in s["levels"]]
    before = tt.kernel_launch_counts()

    def band():
        rgb = avatar4k_band(s["v"], s["vi"], s["vt"], levels, 0, 1024, 4096)[0]
        cot = torch.randn(rgb.shape, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
        torch.autograd.grad(rgb, levels, cot)

    calls = _capture_m1(monkeypatch, band)
    after = tt.kernel_launch_counts()
    assert [len(c) for c in calls] == [4, 6] and calls[0][1].shape == (1, 1024, 4096, 2)
    assert after["M1 mipmap_sample"] - before["M1 mipmap_sample"] == 2
    assert after["B4 window_accum"] == before["B4 window_accum"]
    _m1_close(calls[0], calls[1][4])
    with tt.tracing.Tracer() as tracer:
        mipmap_mod._m1_cuda(*calls[0], calls[1][4])
    counts = tracer.snapshot()["counts"]
    assert counts["M1 window_adds"] > counts["M1 fallback_adds"]


@pytest.mark.cuda
def test_m1_matches_composite_on_the_mipmap_views(cuda_device, monkeypatch):
    """The mipmapped views at chip_smoke.py's shape (8 views of 512^2, the
    inverse8 scene, a 4-level box pyramid of its 3 x 256^2 texture expanded
    over the views, bilinear, border, max_aniso 4): M1 against the
    composite on the launches' own inputs."""
    a = inverse8_scene_arrays(512, 81, 8)
    s = {k: torch.from_numpy(x).to(cuda_device) for k, x in a.items()}
    cams = {k: s[k] for k in ("campos", "camrot", "focal", "princpt")}
    levels = [torch.from_numpy(x).to(cuda_device).requires_grad_() for x in box_pyramid(a["tex_gt"], 4)]

    def views():
        out, _ = tt.render_mipmap_multiview(s["v_world"], s["vi"], s["vt"], levels, cams, 512, 512)
        cot = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
        torch.autograd.grad(out, levels, cot)

    calls = _capture_m1(monkeypatch, views)
    assert [len(c) for c in calls] == [4, 6] and calls[0][0][0].stride(0) == 0
    _m1_close(calls[0], calls[1][4])


@pytest.mark.cuda
def test_mipviews_step_kernels_match_plain(cuda_device):
    """The mipmapped fitting step at 8 views of 256^2 (a 41 x 41 grid, a 3 x
    512^2 texture in 8 levels: minified ~2.3:1, as the benchmark's cell)
    through the kernels against impl="plain" on the kernel's index image:
    loss to 1e-5, gradients to 1e-4 of their largest magnitude, as the
    inverse8 step is held. One step launches M1 once each way and B4 never,
    sets the marks of MIPVIEWS_STAGES, and with the tracer on records the
    pyramid's, the uv Jacobian's and the sampler's spans and M1's corner
    adds (to the blocks' windows and to the fallback)."""
    a = inverse8_scene_arrays(256, 41, 8, tex_size=512)
    s = {k: torch.from_numpy(x).to(cuda_device) for k, x in a.items()}
    cams = {k: s[k] for k in ("campos", "camrot", "focal", "princpt")}
    with torch.no_grad():
        img_gt, _ = tt.render_mipmap_multiview(s["v_world"], s["vi"], s["vt"], mip_pyramid(s["tex_gt"], 8), cams,
                                               256, 256)

    def step(p, **kw):
        return mipviews_step(p, torch.optim.Adam(p, lr=1e-3), s["vi"], s["vt"], cams, img_gt, 256, 256, 8, **kw)

    def params():
        return (s["v_world"] + 0.02).requires_grad_(), torch.full_like(s["tex_gt"], 0.5).requires_grad_()

    marks = []
    step(params(), stage_times=marks)
    tt.reset_kernel_launch_counts()
    with tt.tracing.Tracer() as tracer:
        step(params())
    torch.cuda.synchronize()
    assert [name for name, _ in marks] == ["start", *MIPVIEWS_STAGES]
    assert tt.kernel_launch_counts() == {
        **NO_LAUNCHES, "B1 rasterize": 1, "B2 gather_rows": 6, "B3 scatter_rows": 1, "E1 edge_grad": 1,
        "M1 mipmap_sample": 2,
    }
    snap = tracer.snapshot()
    names = {sp["name"] for sp in snap["spans"]}
    assert {"mip_pyramid", "mip_pyramid_bwd", "uv_derivative", "mipmap_grid_sample", "mipmap_grid_sample_bwd"} <= names
    assert snap["counts"]["M1 window_adds"] > 0 and "M1 fallback_adds" in snap["counts"]
    p_k, p_p = params(), params()
    idx = tt.rasterize(tt.transform(p_k[0].detach().expand(8, -1, -1), **cams), s["vi"], 256, 256)
    loss, grads = step(p_k, index_img=idx)
    loss_p, grads_p = step(p_p, index_img=idx, impl="plain")
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    for name in ("v_world", "tex"):
        err = (grads[name] - grads_p[name]).abs().max()
        assert err <= 1e-4 * grads_p[name].abs().max(), name


@pytest.mark.cuda
def test_b3_matches_plain_on_a_banded_edge_grad_band(avatar4k_frame):
    """The bary x g rows of one band of the edge_grad backward (64 rows and
    its halo row of the 4096^2 frame, from the plain stencil; no path gives
    B3 these rows since E1 reduces them itself), K = 9, against the plain
    scatter: a check of B3 alone."""
    s, idx, bary = avatar4k_frame
    y0, hb = AV_BAND
    gen = torch.Generator(device="cuda").manual_seed(1)
    img = torch.rand((1, 3, 4096, 4096), generator=gen, device="cuda")
    g = torch.randn((1, 3, 4096, 4096), generator=gen, device="cuda")
    vib = broadcast_vi(s["vi"], 1)
    rows_b = slice(y0, y0 + hb + 1)
    idx_b = idx[:, rows_b]
    rows = edge_grad_mod._stencil_plain(_stencil_table(s["v"], vib), idx_b, img[:, :, rows_b], g[:, :, rows_b],
                                        bary[:, :, rows_b], 1e4, y0, 4096)
    assert rows.shape == (1, hb + 1, 4096, 9) and bool((rows != 0).any())
    f_cnt = vib.shape[1]
    got = segment_rows.scatter_rows_to_faces(rows, idx_b, f_cnt)
    want = segment_rows._scatter_rows_plain(rows, idx_b, f_cnt)
    magnitude = segment_rows._scatter_rows_plain(rows.abs(), idx_b, f_cnt)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-6 * magnitude).all())


@pytest.mark.cuda
def test_gather_guard_nearest_its_limit(avatar4k_frame):
    """Of the wrappers' 32-bit guards, B2's P*K is the one the avatar4k path
    comes nearest: edge_grad's K = 16 rows over a whole 4096^2 frame and its
    halo row (n_bands = 1) are 2**28 floats, 1/8 of the limit (B4's taps
    there are 4 x 4096^2, 1/32 of theirs). At that shape the kernel runs
    and equals the plain gather; 8x the pixels are refused."""
    s, idx, _ = avatar4k_frame
    vib = broadcast_vi(s["vi"], 1)
    table = _stencil_table(s["v"], vib)
    idx_halo = torch.cat([idx, torch.full_like(idx[:, :1], -1)], dim=1)  # 4097 x 4096
    got = segment_rows.gather_rows_by_index(table, idx_halo)
    assert torch.equal(got, segment_rows._gather_rows_plain(table, idx_halo))
    big = torch.zeros((), dtype=torch.int32, device="cuda").expand(1, 4 * 4096, 2 * 4096)
    with pytest.raises(ValueError, match="32-bit"):
        segment_rows.gather_rows_by_index(table, big)


@pytest.mark.cuda
def test_avatar4k_step_on_the_card_matches_cpu(cuda_device):
    """The avatar4k step at 256^2 (a 33 x 33 grid, 4 bands, levels 64^2 to
    8^2, 32^2 rays) through the kernels against the same step with
    device="cpu": loss to 1e-5, gradients to 1e-4 of their largest
    magnitude, and the launches of one step."""
    a = avatar4k_scene_arrays(256, 33, 32)
    a["levels"] = [lvl[:, :, : 64 >> i, : 64 >> i].copy() for i, lvl in enumerate(a["levels"])]
    out = {}
    for dev in ("cpu", "cuda"):
        s = tt.interop.scene_from_numpy(a, dev)
        params = (s["v"].requires_grad_(), [x.requires_grad_() for x in s["levels"]], s["msi_tex"].requires_grad_())
        opt = torch.optim.Adam([params[0], *params[1], params[2]], lr=1e-3)
        tt.reset_kernel_launch_counts()
        out[dev] = avatar4k_step(params, opt, s["vi"], s["vt"], s["ray_o"], s["ray_d"], 256, 4, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert tt.kernel_launch_counts() == {
                **NO_LAUNCHES, "B1 rasterize": 8, "B2 gather_rows": 24, "B3 scatter_rows": 4, "E1 edge_grad": 4,
                "M1 mipmap_sample": 12,
            }
    (loss_c, grads_c), (loss_k, grads_k) = out["cpu"], out["cuda"]
    torch.testing.assert_close(loss_k.cpu(), loss_c, rtol=1e-5, atol=0)
    pairs = [("v", grads_k["v"], grads_c["v"]), ("msi_tex", grads_k["msi_tex"], grads_c["msi_tex"])]
    pairs += [(f"levels[{i}]", k, c) for i, (k, c) in enumerate(zip(grads_k["levels"], grads_c["levels"]))]
    for name, got, want in pairs:
        assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode, padding_mode", [("bilinear", "border"), ("bicubic", "zeros")])
def test_b4_matches_plain_under_grid_scatter(cuda_device, mode, padding_mode, monkeypatch):
    """grid_scatter's forward on a masked render's uv image (a 96 x 128
    textured scene) into a 3 x 64 x 64 texture: its one B4 launch, captured,
    against the plain version on the same taps ([T*H, W] tap grid); the op
    against its float64 oracle to 1e-5 of the largest magnitude."""
    from drtk_tpu_torch.ops import grid_scatter as gsc

    s = tt.interop.scene_from_numpy(make_scene_arrays(96, 128, 9), cuda_device)
    v, vi, vt, tex = s["v"], s["vi"], s["vt"], s["tex"]
    img, idx = render_textured(v, vi, vt, tex, 96, 128)
    with torch.no_grad():
        _, bary = tt.render(v, vi, idx)
        uv = tt.interpolate(vt, vi, idx, bary).movedim(1, -1) * 2.0 - 1.0
    launch, captured = window_accum._window_accumulate_cuda, []

    def spy(*args):
        captured.append(args)
        return launch(*args)

    monkeypatch.setattr(window_accum, "_window_accumulate_cuda", spy)
    out = tt.grid_scatter(img.detach(), uv, 64, 64, mode, padding_mode)
    monkeypatch.undo()
    assert len(captured) == 1
    taps = 4 if mode == "bilinear" else 16
    rows_kp, iy, _, t_h, t_w, rows_hw = captured[0]
    assert rows_kp.shape == (1, 3, taps * 96 * 128) and rows_hw == (taps * 96, 128) and (t_h, t_w) == (64, 64)
    assert bool((iy.reshape(1, taps, 96, 128)[(idx < 0)[:, None].expand(1, taps, 96, 128)] == -1).all())
    _b4_close(captured[0])
    ref = gsc.grid_scatter_ref(img.detach().double(), uv.double(), 64, 64, mode, padding_mode)
    torch.cuda.synchronize()
    assert (out.double() - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["downsample", "upsample", "low_pass_filter"])
def test_filter2d_is_full_float32_with_tf32_allowed(cuda_device, op, monkeypatch):
    """With cuDNN allowed TF32 (PyTorch's default, set here), filter2d's
    convolutions still round as float32: forward and the swap-construction
    gradient within 1e-5 (relative to the largest magnitude) of the
    float64 reference and of the op run in float64."""
    from drtk_tpu_torch.ops import filter2d as f2d
    from drtk_tpu_torch.ops import filter2d_ref as f2d_ref

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x = torch.rand((1, 3, 256, 192), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    kaiser = f2d.FilterOptions(6, f2d.FilterType.Kaiser, 0.5)
    lanczos = f2d.FilterOptions(4, f2d.FilterType.Lanczos)
    calls = {"downsample": lambda m, a: m.downsample(a, kaiser, 2), "upsample": lambda m, a: m.upsample(a, kaiser, 2),
             "low_pass_filter": lambda m, a: m.low_pass_filter(a, lanczos, 2.0)}[op]
    xr = x.clone().requires_grad_()
    out = calls(f2d, xr)
    w = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1), device=cuda_device)
    (grad,) = torch.autograd.grad((out * w).sum(), xr)
    ref = calls(f2d_ref, x.double())
    x64 = x.double().requires_grad_()
    (grad64,) = torch.autograd.grad((calls(f2d, x64) * w.double()).sum(), x64)
    assert torch.backends.cudnn.allow_tf32
    assert (out.double() - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert (grad.double() - grad64).abs().max() <= 1e-5 * grad64.abs().max()


def _normal_values_case(device):
    """The grid scene rasterized at 96x128 on ``device``: its faces'
    structure and the render's barycentrics."""
    s = make_scene_arrays(96, 128, 9)
    v, vi = torch.from_numpy(s["v"]).to(device), torch.from_numpy(s["vi"]).to(device)
    idx = tt.rasterize(v, vi, 96, 128)
    _, bary = tt.render(v, vi, idx)
    return vi, idx, bary, tt.interpolation_normal_structure(vi, v.shape[1])


@pytest.mark.cuda
def test_normal_values_b3_matches_plain(cuda_device):
    """The normal matrix's values: the nine products per pixel through B3
    at K = 9 (one launch), against the plain ``index_add_`` path, rtol 1e-5
    plus 1e-6 of the summed magnitudes (all products are >= 0 inside a
    triangle, so the magnitudes are the values)."""
    vi, idx, bary, s = _normal_values_case(cuda_device)
    before = tt.kernel_launch_counts()["B3 scatter_rows"]
    got = tt.interpolation_normal_matrix_values(s, vi, idx, bary)
    torch.cuda.synchronize()
    assert tt.kernel_launch_counts()["B3 scatter_rows"] == before + 1
    want = tt.interpolation_normal_matrix_values(s, vi, idx, bary, impl="plain")
    magnitude = tt.interpolation_normal_matrix_values(s, vi, idx, bary.abs(), impl="plain")
    _magnitude_bound(got, want, magnitude, torch.float32)


@pytest.mark.cuda
def test_normal_values_backward_b2_matches_plain(cuda_device):
    """The values' gradient to ``bary_img`` gathers the slots' cotangents
    per pixel with B2 (bit-exact): equal to the plain gather's."""
    vi, idx, bary, s = _normal_values_case(cuda_device)
    w = torch.randn((1, int(s.rows.shape[0])), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    grads = []
    for impl in ("auto", "plain"):
        b = bary.clone().requires_grad_()
        before = tt.kernel_launch_counts()["B2 gather_rows"]
        (g,) = torch.autograd.grad((tt.interpolation_normal_matrix_values(s, vi, idx, b, impl=impl) * w).sum(), b)
        torch.cuda.synchronize()
        assert tt.kernel_launch_counts()["B2 gather_rows"] == before + (impl == "auto")
        grads.append(g)
    assert torch.equal(grads[0], grads[1])


def _halo_rank(rank, store):
    """One of two Gloo ranks sharing the card: each sends its CUDA rows to
    the previous rank through ``next_rank_rows``."""
    import torch.distributed as dist

    from drtk_tpu_torch.ops.math import next_rank_rows

    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank)
    try:
        dev = torch.device("cuda", 0)
        rows = [torch.full((2, 3, 1, 5), rank + 0.5, device=dev), torch.full((2, 1, 5), rank + 7, dtype=torch.int32,
                                                                            device=dev)]
        got = next_rank_rows(rows, (0, -1), dist.group.WORLD)
        want = (1.5, 8) if rank == 0 else (0.0, -1)
        for g, r, w in zip(got, rows, want):
            if g.device != dev or g.dtype != r.dtype or g.shape != r.shape or not bool((g == w).all()):
                raise AssertionError(f"rank {rank}: got {g} on {g.device}, expected {w}")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_halo_rows_round_trip_through_the_host_under_gloo(cuda_device, tmp_path):
    """Two Gloo ranks on the card: the first receives the second's rows
    (through host memory), the last gets the fill; both on the card."""
    import torch.multiprocessing as mp

    mp.spawn(_halo_rank, args=(str(tmp_path / "store"),), nprocs=2)
