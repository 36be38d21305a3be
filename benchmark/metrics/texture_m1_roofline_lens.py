"""Kernel M1's share of its roofline in the Fisheye62 views, where the level
and the tap count vary across every frame: ``texture_m1_roofline``'s
reading (the same bytes bound, ``bounds/m1.py``, on the reference's
sampling inputs at the first traced step, and the same kernels by name) on
the cell ``fisheye62.fit`` (percent)."""

from drtkbench.harness import load_module

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "device_trace", "Kernels", "mpix_per_s"
WORKLOADS = ["fisheye62.fit"]
PROBE = True
_M1 = load_module("metrics", "texture_m1_roofline")
count = _M1.count


def read(ctx):
    counted = ctx["counts"].get("texture_m1_roofline_lens")
    return _M1.read({**ctx, "counts": {"texture_m1_roofline": counted}})
