"""Device operations (kernels, copies, fills, collectives) per step in the
traced window (torch.profiler), the mean over the cards: what the host has
to dispatch for one step."""

import statistics

UNIT, BETTER, SOURCE, LAYER, MOVES = "count", "lower", "device_trace", "Host dispatch", "mpix_per_s"


def read(ctx):
    traces = ctx["traces"]
    if not all(t["device_ops"] for t in traces):
        return None
    return statistics.fmean(len(t["device_ops"]) / t["steps"] for t in traces)
