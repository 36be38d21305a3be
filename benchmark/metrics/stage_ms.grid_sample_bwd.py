"""Median over the traced steps of the mipmapped step's ``grid_sample_bwd``
stage: the program's CUDA events from the gradient of the edge-gradient
estimator's input to the gradient of the uvs, M1's backward
(``pipeline.mipviews_step(stage_times=...)``)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", "Ops, backward", "mpix_per_s"
WORKLOADS = ["mipviews.fit"]


def read(ctx):
    import statistics

    xs = ctx["stage_ms"].get("grid_sample_bwd")
    return statistics.median(xs) if xs else None
