"""The program's own spans and counters in one cell, on the card: the
per-layer numbers that the port's tracer (``drtk_tpu_torch.tracing``) gives,
the device's idle gaps named by the program span open when each began, and
what the tracer costs when on. From the checkout's root:

    python3 benchmark/spans.py --workload avatar4k.fit --seed 7 --cost-seconds 10

Each process of the cell (one, or one per card under NCCL) sets up as a run
does (the scene from the seed, the program, its checked and warm-up steps);
then, with ``--cost-seconds``, runs the user's fit loop in windows of that
length with the tracer off and on in turn (off, on, on, off), each window's
Mpix/s read as ``mpix_per_s`` is; then the cell's ``trace_steps`` under
torch.profiler with the tracer on. Prints one JSON line: the numbers of
:data:`METRICS` (the largest over the cards), per card each span name's
device and host ms per step (median over the steps), the counters per step,
the 10 longest idle gaps of the device, each named by the innermost program
span open on the host when it began (or "outside the program") and by the
innermost host operation, the idle ms per step put down to each span, and
the windows of the cost.

The result line of ``run.py`` does not carry these numbers: its traced run
hands its metrics no spans (``PERF.md`` §7 names the edit).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
OUTSIDE = "outside the program"
NO_HOST_OP = "(no host operation)"
_NOT_HOST_WORK = {"Activity Buffer Request"}


# ---- the readings, from a window's spans --------------------------------------------------------


def steps_of(snap: dict) -> list[dict]:
    """A tracer's snapshot cut into steps, each starting at a top-level
    ``forward`` span: per step, each span name's ``[device ms, host ms,
    spans]`` (summed over its spans) and the host ms of the top-level spans
    (``top_host_ms``)."""
    steps = []
    for s in snap["spans"]:
        top = s["parent"] is None
        if top and s["name"] == "forward":
            steps.append({"spans": {}, "top_host_ms": 0.0})
        if not steps or s["host_end_ns"] is None:
            continue
        host_ms = (s["host_end_ns"] - s["host_start_ns"]) / 1e6
        dev_ms = s["device_end_ms"] - s["device_start_ms"] if s.get("device_end_ms") is not None else 0.0
        acc = steps[-1]["spans"].setdefault(s["name"], [0.0, 0.0, 0])
        acc[0] += dev_ms
        acc[1] += host_ms
        acc[2] += 1
        if top:
            steps[-1]["top_host_ms"] += host_ms
    return steps


def _device_ms(names):
    """The median over a card's steps of the device ms of ``names``' spans,
    the largest over the cards; None where no card has such a span."""

    def read(cards):
        per_card = [statistics.median(sum(st["spans"][n][0] for n in names if n in st["spans"])
                                      for st in card["steps"])
                    for card in cards if any(n in st["spans"] for st in card["steps"] for n in names)]
        return max(per_card) if per_card else None

    return read


def _host_ms(cards):
    per_card = [statistics.median(st["top_host_ms"] for st in card["steps"]) for card in cards if card["steps"]]
    return max(per_card) if per_card else None


def _collective_mb(cards):
    per_card = [(card["counts"].get("allreduce_bytes", 0) + card["counts"].get("halo_bytes", 0))
                / len(card["steps"]) / 1e6
                for card in cards if card["steps"] and "allreduce_bytes" in card["counts"]]
    return max(per_card) if per_card else None


def _bwd(*names):
    return names + tuple(n + "_bwd" for n in names)


# name: (unit, better, layer, cells, reader of [per card: {"steps": steps_of(...), "counts": per window}])
METRICS = {
    "host_ms_per_step": ("ms", "lower", "Host dispatch", ["inverse8.fit", "avatar4k.fit", "multiview4k.rows4"],
                         _host_ms),
    "span_ms.rasterize": ("ms", "lower", "Ops, forward", ["inverse8.fit", "avatar4k.fit", "multiview4k.rows4"],
                          _device_ms(("rasterize",))),
    "span_ms.shading": ("ms", "lower", "Ops", ["inverse8.fit", "multiview4k.rows4"],
                        _device_ms(_bwd("render", "interpolate", "grid_sample"))),
    "span_ms.mipmap_grid_sample": ("ms", "lower", "Ops", ["avatar4k.fit"], _device_ms(_bwd("mipmap_grid_sample"))),
    "span_ms.row_gather": ("ms", "lower", "Ops", ["avatar4k.fit"], _device_ms(_bwd("row_gather"))),
    "span_ms.background": ("ms", "lower", "Ops", ["avatar4k.fit"], _device_ms(_bwd("background"))),
    "span_ms.band_recompute": ("ms", "lower", "Banding and ops backward", ["avatar4k.fit"],
                               _device_ms(("band_recompute",))),
    "span_ms.collectives": ("ms", "lower", "Multi-device", ["multiview4k.rows4"],
                            _device_ms(("allreduce", "halo"))),
    "collective_mb_per_step": ("MB", "lower", "Multi-device", ["multiview4k.rows4"], _collective_mb),
}


def read_metrics(cards: list, cell: str) -> dict:
    """The numbers of :data:`METRICS` that ``cell`` reports, None where its
    spans hold nothing to read."""
    return {name: m[4](cards) for name, m in METRICS.items() if cell in m[3]}


class Ranges:
    """Ranges (start, end, name) of the host's timeline, for the innermost
    one open at a moment: the latest to start among those that hold it."""

    def __init__(self, ranges: list):
        self.starts = np.array([r[0] for r in ranges], dtype=np.float64)
        self.ends = np.array([r[1] for r in ranges], dtype=np.float64)
        self.names = [r[2] for r in ranges]

    def innermost(self, at: float, none: str) -> str:
        inside = np.nonzero((self.starts <= at) & (self.ends >= at))[0]
        return self.names[inside[np.argmax(self.starts[inside])]] if inside.size else none


def idle_gaps(dev: list) -> list:
    """The device's idle gaps (start, length), in the profiler's
    microseconds, from its operations' (start, end) intervals."""
    dev = sorted(dev)
    gaps = []
    if dev:
        cur_end = dev[0][1]
        for start, end in dev[1:]:
            if start > cur_end:
                gaps.append((cur_end, start - cur_end))
            cur_end = max(cur_end, end)
    return gaps


def name_gaps(gaps: list, spans: list, host: list, n_steps: int) -> tuple[list, dict]:
    """The 10 longest ``gaps`` as [span, host operation, ms], each named by
    the innermost program span (``spans``: the profiler's ranges of the
    spans) and host operation open when it began; and every gap's ms per
    step summed by that span's name (:data:`OUTSIDE` for none)."""
    spans, host = Ranges(spans), Ranges(host)
    longest = [[spans.innermost(at, OUTSIDE), host.innermost(at, NO_HOST_OP), length / 1e3]
               for at, length in sorted(gaps, key=lambda g: -g[1])[:10]]
    by_span: dict[str, float] = {}
    for at, length in gaps:
        name = spans.innermost(at, OUTSIDE)
        by_span[name] = by_span.get(name, 0.0) + length / 1e3 / n_steps
    return longest, dict(sorted(by_span.items(), key=lambda kv: -kv[1]))


# ---- one process on the card --------------------------------------------------------------------


def traced_window(step, n_steps: int) -> dict:
    """``n_steps`` calls of ``step`` under torch.profiler with the tracer on,
    from a synchronize to a synchronize, after one step that takes the
    profiler's start-up (traced, not kept): the tracer's snapshot, the
    device's idle gaps, the program's spans as the profiler saw them
    (annotation ranges named as spans), the host operations, and the
    window's wall seconds and busy seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from drtk_tpu_torch import tracing

    tracer = tracing.Tracer()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_steps)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        with tracer:
            for i in range(n_steps):
                step()
                if i < n_steps - 1:
                    prof.step()  # not after the last: ending the cycle would drop its events
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    snap = tracer.snapshot()
    names = {s["name"] for s in snap["spans"]}
    dev, host, spans = [], [], []
    for e in prof.events():
        rec = (e.time_range.start, e.time_range.end, e.name)
        if getattr(e, "is_user_annotation", False):
            if e.device_type == DeviceType.CPU and e.name in names:
                spans.append(rec)
        elif e.name not in _NOT_HOST_WORK:
            (dev if e.device_type == DeviceType.CUDA else host).append(rec)
    gaps = idle_gaps([(s, e) for s, e, _ in dev])
    busy_us = (max(e for _, e, _ in dev) - min(s for s, _, _ in dev) - sum(g for _, g in gaps)) if dev else 0.0
    return {"snapshot": snap, "gaps": gaps, "spans": spans, "host": host, "window_s": window_s,
            "busy_s": busy_us / 1e6, "device_ops": len(dev)}


def cost_windows(prog, seconds: float, pixels: int, comm) -> list:
    """The fit loop in windows of ``seconds``, tracer off, on, on, off:
    [tracing on, Mpix/s] per window."""
    from drtk_tpu_torch import tracing
    from drtkbench import harness

    out = []
    for on in (False, True, True, False):
        tracer = tracing.Tracer()
        if on:
            with tracer:
                win = harness._window(prog, seconds, comm)
        else:
            win = harness._window(prog, seconds, comm)
        out.append([on, pixels * len(win["step_ms"]) / win["window_s"] / 1e6])
    return out


def session(cell_name: str, seed: int, cost_seconds: float, device, comm=None) -> dict:
    """This process's record: set-up as a run's, the cost's windows, the
    traced window reduced to its steps, counters and named gaps."""
    import torch

    from drtkbench import harness

    cell = harness.Cell(cell_name)
    arrays = cell.scene(seed, device)
    prog, _ = harness.readings(cell, arrays, device)
    for _ in range(cell.work["warmup_steps"]):
        prog.step()
    torch.cuda.synchronize()
    if comm:
        comm.barrier()
    pixels = cell.entry.pixels(cell.cfg, cell.traffic)  # every card's, as mpix_per_s counts them
    cost = cost_windows(prog, cost_seconds, pixels, comm) if cost_seconds > 0 else []
    if comm:
        comm.barrier()
    n = cell.work["trace_steps"]
    win = traced_window(prog.step, n)
    steps = steps_of(win["snapshot"])
    gaps, idle_by_span = name_gaps(win["gaps"], win["spans"], win["host"], n)
    per_span = {name: [statistics.median(st["spans"].get(name, [0.0, 0.0, 0])[k] for st in steps) for k in range(3)]
                for name in sorted({k for st in steps for k in st["spans"]})}
    return {"device": torch.cuda.get_device_name(device), "power_limit": harness.power_limit(), "cost": cost,
            "steps": steps, "counts": win["snapshot"]["counts"],
            "per_span": per_span, "idle_gaps": gaps, "idle_ms_per_step": idle_by_span,
            "window_s": win["window_s"], "busy_s": win["busy_s"], "device_ops_per_step": win["device_ops"] / n,
            "step_device_ms": statistics.median(
                sum(v[0] for k, v in st["spans"].items() if k in ("forward", "backward", "adam")) for st in steps)}


def _rank(args: dict) -> int:
    """One rank of a cell on several cards: its card, the group (NCCL, and
    Gloo for the host), :func:`session`, its record in ``<dir>/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from drtkbench import ranks

    rank, world = args["rank"], args["world"]
    torch.cuda.set_device(rank)
    comm = ranks.init(rank, world, os.path.join(args["dir"], "store"), "nccl")
    try:
        rec = session(args["workload"], args["seed"], args["cost_seconds"], torch.device("cuda", rank), comm)
        with open(os.path.join(args["dir"], f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
        comm.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _launch(job: dict, world: int, timeout_s: float) -> list:
    tmp = tempfile.mkdtemp(prefix="drtkbench-spans-")
    procs = []
    try:
        for rank in range(world):
            args = {**job, "rank": rank, "world": world, "dir": tmp}
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank", json.dumps(args)],
                                          stdout=sys.stderr, cwd=ROOT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                raise RuntimeError(f"spans: rank exit codes {[p.poll() for p in procs]}")
            time.sleep(0.2)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"spans: rank exit codes {[p.returncode for p in procs]}")
        return [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    if sys.argv[1:2] == ["--rank"]:
        return _rank(json.loads(sys.argv[2]))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost-seconds", type=float, default=0.0)
    args = ap.parse_args()
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))

    import torch

    from drtk_tpu_torch import _build
    from drtkbench import harness

    work = harness.load_json("workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"spans.py: the cell needs {work['chips']} CUDA card(s)", file=sys.stderr)
        return 2
    _build.build_all()
    if work["chips"] == 1:
        cards = [session(args.workload, args.seed, args.cost_seconds, torch.device("cuda", 0))]
    else:
        job = {"workload": args.workload, "seed": args.seed, "cost_seconds": args.cost_seconds}
        cards = _launch(job, work["chips"], 1500)
    line = {"workload": args.workload, "seed": args.seed, "metrics": read_metrics(cards, args.workload),
            "cards": [{k: v for k, v in c.items() if k != "steps"} for c in cards]}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
