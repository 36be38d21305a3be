"""Median over the traced steps of the avatar4k step's ``backward`` span:
the program's CUDA events from the loss to the gradients, the band
recomputes included (``pipeline.avatar4k_step(stage_times=...)``)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", "Banding and ops backward", "mpix_per_s"
WORKLOADS = ["avatar4k.fit"]


def read(ctx):
    import statistics

    xs = ctx["stage_ms"].get("backward")
    return statistics.median(xs) if xs else None
