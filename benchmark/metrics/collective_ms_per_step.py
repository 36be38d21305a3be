"""Device time of the NCCL kernels per step inside the traced steps (the
gradients' all-reduces and the halo rows' send and receive, with whatever
waiting on the other cards they include), the largest over the cards
(torch.profiler)."""

import re

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "device_trace", "Multi-device", "mpix_per_s"
WORKLOADS = ["multiview4k.rows4"]
KERNELS = re.compile(r"nccl", re.IGNORECASE)


def read(ctx):
    per_card = [sum(d for name, d in t["device_ops"] if KERNELS.search(name)) * 1e3 / t["steps"]
                for t in ctx["traces"]]
    return max(per_card) if any(per_card) else None
