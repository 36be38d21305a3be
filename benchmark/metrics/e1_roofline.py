"""Kernel E1's share of its roofline: the least time for the bytes the
edge_grad backward needs on the first traced step's data (``bounds/e1.py``,
counted from the reference's backward on the program's leaves at that
step) over the published memory bandwidth, divided by the device time per
step of E1's kernels, found by name in the trace (percent)."""

import re

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "device_trace", "Kernels", "mpix_per_s"
WORKLOADS = ["inverse8.fit", "avatar4k.fit"]
PROBE = True
# csrc/edge_grad.cu: the verts mode the backward launches, and the image mode.
KERNELS = re.compile(r"\bedge_grad_(verts|image)_kernel\b")


def count(ctx):
    """Bytes per step, from the reference's edge-gradient inputs."""
    return ctx["bound"]("e1").bytes_per_step(ctx["cfg"], ctx["probe"])


def read(ctx):
    tr = ctx["traces"][0]
    seconds = sum(d for name, d in tr["device_ops"] if KERNELS.search(name))
    counted = ctx["counts"].get("e1_roofline")
    if seconds <= 0 or not counted or ctx["peaks"] is None:
        return None
    return 100.0 * counted / ctx["peaks"][0] * tr["steps"] / seconds
