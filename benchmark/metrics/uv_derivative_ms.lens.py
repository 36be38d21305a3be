"""Median over the traced steps of the ``uv_derivative`` stage in the
Fisheye62 views: the program's CUDA events from the interpolated uvs to the
screen-space uv Jacobian taken through the lens (``lens_jvp`` included;
``pipeline.mipviews_step(stage_times=...)``), on the cell
``fisheye62.fit``."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", "Ops", "mpix_per_s"
WORKLOADS = ["fisheye62.fit"]


def read(ctx):
    import statistics

    xs = ctx["stage_ms"].get("uv_derivative")
    return statistics.median(xs) if xs else None
