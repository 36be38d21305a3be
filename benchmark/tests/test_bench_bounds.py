"""The bound arithmetic against counts made by hand on a tiny scene: a
square of two triangles over the background, the image 1 on the square and
0 off it, the cotangent 1."""

import numpy as np
import torch

from drtkbench import harness


def _square_probe(h=12, w=10):
    v = torch.tensor([[[2.5, 3.5, 5.0], [7.5, 3.5, 5.0], [2.5, 8.5, 5.0], [7.5, 8.5, 5.0]]])
    vi = torch.tensor([[0, 1, 2], [1, 3, 2]], dtype=torch.int32)
    from reference.raster import rasterize

    idx = rasterize(v, vi, h, w)
    fg = (idx >= 0)[:, None].float()
    img = fg.expand(1, 3, h, w).contiguous()
    return {"v_pix": v, "vi": vi[None], "index": idx, "img": img, "cotangent": torch.ones_like(img),
            "bary": torch.zeros_like(img)}


def _hand_parts(fg: np.ndarray, centre_rows) -> np.ndarray:
    """Foreground pixels that differ from a neighbour to the right or below
    of a stencil centre on ``centre_rows``, or are that neighbour."""
    h, w = fg.shape
    out = np.zeros_like(fg)
    for y in centre_rows:
        for x in range(w):
            for yy, xx in ((y, x + 1), (y + 1, x)):
                if yy < h and xx < w and fg[y, x] != fg[yy, xx]:
                    out[(y, x) if fg[y, x] else (yy, xx)] = True
    return out


def _launch_bytes(idx, parts, rows):
    faces = len(set(idx[parts].tolist()))
    return rows * idx.shape[1] * 4 + 4 * 3 * 4 + int(parts.sum()) * (2 * 3 + 3) * 4 + faces * (12 + 9 * 4)


def test_e1_bytes_by_hand():
    probe = _square_probe()
    idx = probe["index"][0].numpy()
    h, w = idx.shape
    want = _launch_bytes(idx, _hand_parts(idx >= 0, range(h - 1)), h)
    assert want > h * w * 4 + 4 * 3 * 4
    assert harness.load_module("bounds", "e1").bytes_per_step({"height": h, "width": w}, probe) == want


def test_e1_bytes_by_hand_in_bands():
    """Two bands: rows 0-6 (the second band's first row as the halo), then
    rows 6-11; each band's centres are its own rows."""
    probe = _square_probe()
    idx = probe["index"][0].numpy()
    fg = idx >= 0
    want = (_launch_bytes(idx, _hand_parts(fg, range(0, 6)), 7)
            + _launch_bytes(idx, _hand_parts(fg, range(6, 11)), 6))
    got = harness.load_module("bounds", "e1").bytes_per_step({"height": 12, "width": 10, "bands": 2}, probe)
    assert got == want


def test_b1_bytes_by_hand():
    probe = _square_probe()
    b1 = harness.load_module("bounds", "b1")
    assert b1.bytes_per_launch({"height": 12, "width": 10}, probe) == 4 * 3 * 4 + 2 * 3 * 4 + 12 * 10 * 4
    assert b1.bytes_per_launch({"height": 12, "width": 10, "bands": 3}, probe) == 4 * 3 * 4 + 2 * 3 * 4 + 4 * 10 * 4
