"""Kernel B1's share of its roofline: per launch, the least time for the
bytes rasterize needs (``bounds/b1.py``, on the first traced step's data)
over the published memory bandwidth, times the launches, divided by the
device time of B1's kernels, found by name in the trace (percent). Its
memset of the tile counters is not named and not counted."""

import re

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "device_trace", "Kernels", "mpix_per_s"
WORKLOADS = ["inverse8.fit", "avatar4k.fit"]
PROBE = True
# csrc/rasterize.cu: the two binning passes, the scan, the per-tile resolve
# (one resolve per launch of B1).
KERNELS = re.compile(r"\b(bin_kernel|scan_kernel|resolve_kernel)\b")
RESOLVE = re.compile(r"\bresolve_kernel\b")


def count(ctx):
    """Bytes per launch, from the reference's edge-gradient inputs."""
    return ctx["bound"]("b1").bytes_per_launch(ctx["cfg"], ctx["probe"])


def read(ctx):
    tr = ctx["traces"][0]
    seconds = sum(d for name, d in tr["device_ops"] if KERNELS.search(name))
    launches = sum(1 for name, _ in tr["device_ops"] if RESOLVE.search(name))
    counted = ctx["counts"].get("b1_roofline")
    if seconds <= 0 or launches == 0 or not counted or ctx["peaks"] is None:
        return None
    return 100.0 * counted / ctx["peaks"][0] * launches / seconds
