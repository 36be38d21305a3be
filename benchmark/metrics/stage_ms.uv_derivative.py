"""Median over the traced steps of the mipmapped step's ``uv_derivative``
stage: the program's CUDA events from the interpolated uvs to the
screen-space uv Jacobian (``pipeline.mipviews_step(stage_times=...)``)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", "Ops", "mpix_per_s"
WORKLOADS = ["mipviews.fit"]


def read(ctx):
    import statistics

    xs = ctx["stage_ms"].get("uv_derivative")
    return statistics.median(xs) if xs else None
