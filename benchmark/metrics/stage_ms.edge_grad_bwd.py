"""Median over the traced steps of the multi-view step's ``edge_grad_bwd``
span: the program's CUDA events from the loss to the gradient of the
edge-gradient estimator's input (``pipeline.inverse8_step(stage_times=...)``)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", "Ops, backward", "mpix_per_s"
WORKLOADS = ["inverse8.fit"]


def read(ctx):
    import statistics

    xs = ctx["stage_ms"].get("edge_grad_bwd")
    return statistics.median(xs) if xs else None
