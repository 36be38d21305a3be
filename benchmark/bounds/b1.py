"""B1's bytes bound, after ``chip_smoke.py``'s B1 record, counted for the
function and not the kernel's packed layout: one call of rasterize needs
the vertices [N, V, 3] float32 and the faces [F, 3] int32 read once and
its index image [N, rows, W] int32 written once (rows: the frame's height
over the configuration's row bands)."""


def bytes_per_launch(cfg: dict, probe: dict) -> int:
    v, vi = probe["v_pix"], probe["vi"]
    n, num_v = v.shape[:2]
    rows = cfg["height"] // cfg.get("bands", 1)
    return n * num_v * 3 * 4 + vi.shape[-2] * 3 * 4 + n * rows * cfg["width"] * 4
