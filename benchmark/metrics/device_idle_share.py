"""Share of the traced window's wall time in which no device operation ran:
1 - (union of the device operations' intervals) / (the window from a
synchronize to a synchronize), in percent, the mean over the cards. Read
under torch.profiler, whose host time lengthens the host's side of every
step: where the host sets the pace, this reads above an untraced run's
idle share."""

import statistics

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "lower", "device_trace", "Device", "mpix_per_s"


def read(ctx):
    traces = ctx["traces"]
    if any(t["busy_s"] <= 0 or t["window_s"] <= 0 for t in traces):
        return None
    return statistics.fmean(100.0 * (1.0 - t["busy_s"] / t["window_s"]) for t in traces)
