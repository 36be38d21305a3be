"""The device trace of a traced window (after ``chip_smoke.device_profile``,
with its window corrected: busy time over the traced window's wall time,
so idle time before the first device operation and after the last counts).
"""

from __future__ import annotations

import re
import time

import numpy as np

_NOT_HOST_WORK = {"Activity Buffer Request"}
_NOISE = re.compile(r"^void |at::native::|\(anonymous namespace\)::|std::")


def _short(name: str) -> str:
    """A kernel's name without its return type and namespaces, at most 160
    characters."""
    return _NOISE.sub("", name)[:160]


def trace(step, n_steps: int) -> dict:
    """``n_steps`` calls of ``step`` under torch.profiler, from a
    synchronize to a synchronize. Returns the window's wall seconds, the
    seconds in which some device operation ran, every device operation
    (name, seconds) and the breakdown: the device operations that took the
    most time and the longest idle gaps of the device, each named by the
    innermost host operation running when it began."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) or e.name in _NOT_HOST_WORK:
            continue  # an annotation's span on the device timeline, or the profiler's own bookkeeping
        rec = (e.time_range.start, e.time_range.end, _short(e.name))
        (dev if e.device_type == DeviceType.CUDA else host).append(rec)
    dev.sort()
    busy_us, gaps = 0.0, []
    if dev:
        cur_start, cur_end = dev[0][0], dev[0][1]
        for start, end, _ in dev[1:]:
            if start > cur_end:
                busy_us += cur_end - cur_start
                gaps.append((start - cur_end, cur_end))
                cur_start, cur_end = start, end
            else:
                cur_end = max(cur_end, end)
        busy_us += cur_end - cur_start
    by_name: dict[str, float] = {}
    for start, end, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    gaps.sort(reverse=True)
    idle = []
    if host and gaps:
        hs = np.array([h[0] for h in host], dtype=np.float64)
        he = np.array([h[1] for h in host], dtype=np.float64)
        for length, at in gaps[:10]:
            inside = np.nonzero((hs <= at) & (he >= at))[0]
            name = host[inside[np.argmax(hs[inside])]][2] if inside.size else "(no host operation)"
            idle.append([name, length / 1e6])
    return {
        "steps": n_steps, "window_s": window_s, "busy_s": busy_us / 1e6,
        "device_ops": [(name, (end - start) / 1e6) for start, end, name in dev],
        "breakdown": {"device_ops": [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
                      "idle_gaps": idle},
    }
