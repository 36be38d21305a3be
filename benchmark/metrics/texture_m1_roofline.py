"""Kernel M1's share of its roofline (named for the texture sampler M1 is,
so that it sorts after the metrics the benchmark had): the least time for
the bytes the bilinear mipmapped sampling's two launches need on the first
traced step's data (``bounds/m1.py``, from the reference's sampling
inputs, selection and cotangent on the program's leaves at that step) over
the published memory bandwidth, divided by the device time per step of
M1's kernels, found by name in the trace (percent)."""

import re

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "device_trace", "Kernels", "mpix_per_s"
WORKLOADS = ["mipviews.fit"]
PROBE = True
# csrc/mipmap_sample.cu: one forward and one backward launch a step.
KERNELS = re.compile(r"\bmipmap_(forward|backward)_kernel\b")


def count(ctx):
    """Bytes per step, from the reference's mipmap inputs."""
    return ctx["bound"]("m1").bytes_per_step(ctx["cfg"], ctx["probe"])


def read(ctx):
    tr = ctx["traces"][0]
    seconds = sum(d for name, d in tr["device_ops"] if KERNELS.search(name))
    counted = ctx["counts"].get("texture_m1_roofline")
    if seconds <= 0 or not counted or ctx["peaks"] is None:
        return None
    return 100.0 * counted / ctx["peaks"][0] * tr["steps"] / seconds
