"""One run of one cell of the ``drtk_tpu_torch`` benchmark.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``: the scene's sizes), a traffic mix
(``traffic/<traffic>.json``: the fit loop's parameters), its cards and an
entry (``entries/<entry>.py``: the program's step, and
``reference/<entry>.py``: the plain reference of the same step).
A run, in each process of the cell (one, or one per card):

1. set-up (:func:`session`): imports the port, builds the scene from the
   seed, hands it to the program, and drives the program's step through its
   first steps (:func:`readings`: the steps the reference follows), then a
   few more to warm up; every kernel is built and every shape seen before
   the window;
2. the window: the user's fit loop for ``seconds`` (no synchronize inside;
   a CUDA event at each step's end), or, traced, a fixed number of steps
   under torch.profiler and as many with the program's stage spans;
3. after the window: the losses read, the peak memory read, the program's
   state freed, and the reference run from the same scene through the
   same first steps (:func:`reference_share`: each process its share of
   the scene's independent pieces);
4. :func:`result`: the processes' records into the result's line; the
   comparison (:func:`judge`) decides ``correct``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "drtk_tpu")
CHECKS = ("loss_gap", "grad_gap", "change_gap")


def load_json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module of its own."""
    mod_name = f"drtkbench_{kind}_{name}".replace(".", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_modules(cell: str) -> dict:
    """The per-layer metrics (``metrics/<name>.py``) this cell reports: those
    whose ``WORKLOADS`` name it, and those without ``WORKLOADS``."""
    out = {}
    for path in sorted((BENCH / "metrics").glob("*.py")):
        mod = load_module("metrics", path.stem)
        if getattr(mod, "WORKLOADS", None) is None or cell in mod.WORKLOADS:
            out[path.stem] = mod
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names: ``drtk_tpu_torch`` is not ``drtk_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Cell:
    """A cell's files: its workload, configuration, traffic, entry and
    reference."""

    def __init__(self, name: str, cfg_overrides: dict | None = None):
        self.name = name
        self.work = load_json("workloads", name)
        self.cfg = {**load_json("configs", self.work["config"]), **(cfg_overrides or {})}
        self.traffic = load_json("traffic", self.work["traffic"])
        self.entry = load_module("entries", self.work["entry"])
        if str(BENCH) not in sys.path:
            sys.path.insert(0, str(BENCH))
        self.ref = importlib.import_module(f"reference.{self.work['entry']}")

    def scene(self, seed: int, device) -> dict:
        """The scene from ``seed``: the entry's arrays, and what the
        reference prepares from them on ``device`` (a target image)."""
        arrays = self.entry.scene(self.cfg, self.traffic, seed)
        prepare = getattr(self.ref, "prepare", None)
        return prepare(arrays, self.cfg, device) if prepare else arrays


# ---- the readings compared ---------------------------------------------------


def _norm(t) -> float:
    import torch

    return float(torch.linalg.vector_norm(t.detach().double()))


def first_steps(prog, n: int) -> dict:
    """Drive ``prog`` through ``n`` steps; return what the comparison reads:
    each step's loss (this process's part of it, a device tensor), the first
    gradient as Adam holds it after one step, and each leaf's change after
    ``n`` steps (norms)."""
    import torch

    from reference import BETAS

    start = {k: p.detach().clone() for k, p in zip(prog.names, prog.leaves)}
    losses, grad1 = [], None
    for i in range(n):
        losses.append(prog.step())
        if i == 0:  # a leaf the optimizer never updated has no state: no gradient reached it
            grad1 = {k: prog.opt.state[p]["exp_avg"].detach().clone() / (1 - BETAS[0])
                     if "exp_avg" in prog.opt.state.get(p, {}) else torch.zeros_like(p)
                     for k, p in zip(prog.names, prog.leaves)}
    change = {k: p.detach() - start[k] for k, p in zip(prog.names, prog.leaves)}
    return {"losses": losses, "grad1": {k: _norm(g) for k, g in grad1.items()},
            "change": {k: _norm(c) for k, c in change.items()}}


def readings(cell: Cell, arrays: dict, device, fault: str | None = None):
    """The program built from ``arrays`` on ``device`` (with one of the
    entry's ``FAULTS`` planted, for the tests and the limits' readings) and
    driven through the cell's checked steps. Returns (the program, its
    readings, the losses as floats)."""
    planted = cell.entry.FAULTS[fault]() if fault else None
    if planted:
        planted.__enter__()
    try:
        prog = cell.entry.Program(cell.cfg, cell.traffic, arrays, device)
        got = first_steps(prog, cell.work["checked_steps"])
        got["losses"] = [float(x) for x in got["losses"]]
    finally:
        if planted:
            planted.__exit__(None, None, None)
    return prog, got


def free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def reference_share(cell: Cell, arrays: dict, names: list, device, q, rank: int = 0, world: int = 1) -> dict:
    """The reference's readings of :func:`first_steps` over this process's
    share of the scene's pieces (``reference.<entry>.pieces``: parts whose
    Adam runs are independent, such as cameras with leaves of their own;
    the whole scene where the module has none), in precision ``q``: each
    step's loss by block of rows (summed over the pieces), and per leaf the
    squares of the norms of the first gradient and of the change (summed
    likewise; :func:`judge` adds the shares of every process)."""
    import torch

    from reference import adam

    pieces = cell.ref.pieces(arrays, cell.cfg) if hasattr(cell.ref, "pieces") else [arrays]
    out = {"losses": None, "grad1_sq": {k: 0.0 for k in names}, "change_sq": {k: 0.0 for k in names}}
    for piece in pieces[rank::world]:
        s = {k: torch.as_tensor(a, device=device) for k, a in piece.items()}
        params = {k: s.pop(k) for k in names}
        losses, grad1, change = adam(lambda p: cell.ref.loss({**s, **p}, cell.cfg, q), params,
                                     cell.work["checked_steps"], cell.traffic["lr"])
        out["losses"] = losses if out["losses"] is None else [[a + b for a, b in zip(x, y)]
                                                              for x, y in zip(out["losses"], losses)]
        for k in names:
            out["grad1_sq"][k] += _norm(grad1[k]) ** 2
            out["change_sq"][k] += _norm(change[k]) ** 2
        del s, params, grad1, change
        free(device)
    return out


def combine(shares: list) -> dict:
    """The processes' reference shares added: losses [step][block], and the
    norms per leaf."""
    shares = [s for s in shares if s["losses"] is not None]
    losses = [[sum(vals) for vals in zip(*steps)] for steps in zip(*(s["losses"] for s in shares))]
    names = shares[0]["grad1_sq"]
    return {"losses": losses,
            "grad1": {k: math.sqrt(sum(s["grad1_sq"][k] for s in shares)) for k in names},
            "change": {k: math.sqrt(sum(s["change_sq"][k] for s in shares)) for k in names}}


def gaps(got: dict, want: dict) -> dict:
    """The numbers compared. ``loss_gap``: the largest over the steps of
    |loss - reference| / |reference|. ``grad_gap``: over the leaves, the gap
    between the norms of the first gradient, over the reference's norm of
    that leaf or of the median leaf, whichever is larger. ``change_gap``:
    the same of each leaf's change, over the leaves whose reference
    gradient is at least a thousandth of the median leaf's (the others move
    under Adam by round-off alone)."""
    losses = [float(x) for x in got["losses"]]
    loss_gap = max(abs(a - b) / abs(b) if b != 0 else abs(a - b) for a, b in zip(losses, want["losses"]))
    g_med = statistics.median(want["grad1"].values())
    grad_gap = max(abs(got["grad1"][k] - w) / max(w, g_med) if max(w, g_med) > 0 else abs(got["grad1"][k])
                   for k, w in want["grad1"].items())
    moved = [k for k, w in want["grad1"].items() if w >= 1e-3 * g_med]
    c_med = statistics.median(want["change"][k] for k in moved)
    change_gap = max(abs(got["change"][k] - want["change"][k]) / max(want["change"][k], c_med) for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "left_out": sorted(set(want["grad1"]) - set(moved))}


def judge(got_by_rank: list, want: dict) -> dict:
    """Each process's readings against the reference's (``want`` from
    :func:`combine`): process j's losses are those of block j of the rows;
    every process holds the whole of every leaf. Returns each number, the
    largest over the processes."""
    per_rank = [gaps(got, {"losses": [step[j] for step in want["losses"]], "grad1": want["grad1"],
                           "change": want["change"]})
                for j, got in enumerate(got_by_rank)]
    return {k: max(g[k] for g in per_rank) for k in CHECKS}


def correct(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in CHECKS)


# ---- one process of a run on the card --------------------------------------------


def _quantile(xs, q: float) -> float:
    return statistics.quantiles(xs, n=100, method="inclusive")[round(q * 100) - 1] if len(xs) > 1 else xs[0]


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def _window(prog, seconds: float, comm) -> dict:
    """The user's fit loop for ``seconds``: no synchronize inside, a CUDA
    event at each step's end; with ``comm`` (several processes) the first
    process's clock ends it for all."""
    import torch

    losses, ends = [], []
    torch.cuda.synchronize()
    if comm:
        comm.barrier()
    first = torch.cuda.Event(enable_timing=True)
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    first.record()
    while True:
        losses.append(prog.step())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        done = time.perf_counter() - t0 >= seconds
        if comm:
            done = comm.agree(done)
        if done:
            break
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    print(f"window: {window_s:.3f} s, this process's CPU time {time.process_time() - cpu0:.3f} s", file=sys.stderr)
    step_ms = [a.elapsed_time(b) for a, b in zip([first] + ends[:-1], ends)]
    per_s, t = [0], 0.0
    for ms in step_ms:
        t += ms / 1e3
        while t >= len(per_s):
            per_s.append(0)
        per_s[-1] += 1
    print(f"steps in each second of the window: {per_s}", file=sys.stderr)
    return {"window_s": window_s, "step_ms": step_ms, "losses": losses}


def _stage_window(prog, n: int, losses: list) -> dict:
    """``n`` steps, each with the program's stage spans (their losses
    appended to ``losses``); ms per stage, a list over the steps."""
    import torch

    marks = []
    for _ in range(n):
        st = []
        losses.append(prog.step(stage_times=st))
        marks.append(st)
    torch.cuda.synchronize()
    out: dict[str, list] = {}
    for st in marks:
        for (_, start), (name, end) in zip(st[:-1], st[1:]):
            out.setdefault(name, []).append(start.elapsed_time(end))
    return out


def session(cell: Cell, seed: int, seconds: float, trace: bool, t0_wall: float, device, comm=None) -> dict:
    """This process's part of a run on a CUDA ``device``: set-up, the window
    (or the traced steps), the program freed, then its share of the
    reference. Returns its record (JSON-able); ``comm`` joins the
    processes of a cell on several cards."""
    import torch

    work, dev = cell.work, torch.device(device)
    phases = {"imports": time.time() - t0_wall}
    arrays = cell.scene(seed, dev)
    phases["scene"] = time.time() - t0_wall
    prog, got = readings(cell, arrays, dev)
    names = list(prog.names)
    torch.cuda.synchronize()
    phases["first_steps"] = time.time() - t0_wall
    for _ in range(work["warmup_steps"]):
        prog.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    if comm:
        comm.barrier()
    setup_end = time.time()
    phases["warmup"] = setup_end - t0_wall
    print("set-up, seconds from the start at the end of each phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    rec = {"device": torch.cuda.get_device_name(dev), "device_index": dev.index if dev.index is not None
           else torch.cuda.current_device(), "setup_s": setup_end - t0_wall, "readings": got}
    metrics = metric_modules(cell.name)
    state = None
    if not trace:
        win = _window(prog, seconds, comm)
        losses = win.pop("losses")
        rec.update(win)
    else:
        from drtkbench.profile import trace as device_trace

        if any(getattr(m, "PROBE", False) for m in metrics.values()):
            # The program's leaves as the first traced step takes them: the
            # bounds count the parts of that step's data.
            state = {k: p.detach().clone() for k, p in zip(prog.names, prog.leaves)}
        losses = []
        if comm:
            comm.barrier()
        rec["trace"] = device_trace(lambda: losses.append(prog.step()), work["trace_steps"])
        if any(m.SOURCE == "program_span" for m in metrics.values()):
            rec["stage_ms"] = _stage_window(prog, work["trace_steps"], losses)
    rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    loss_values = torch.stack(losses).float().cpu()
    rec["steps"] = len(losses)
    rec["failed"] = int((~torch.isfinite(loss_values)).sum())
    del prog, losses
    free(dev)
    rec["forbidden"] = forbidden_modules()

    from reference import exact

    t_ref = time.perf_counter()
    rank, world = (comm.rank, comm.world) if comm else (0, 1)
    rec["reference"] = reference_share(cell, arrays, names, dev, exact, rank, world)
    if state is not None:
        rec["probe"] = probe_counts(cell, arrays, state, dev, metrics)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    return rec


def probe_counts(cell: Cell, arrays: dict, state: dict, device, metrics: dict) -> dict:
    """The bounds' byte counts (``metrics/*.py`` with ``PROBE``) on the data
    of the first traced step: the reference's forward and backward from the
    program's leaves at that step, its edge-gradient inputs captured."""
    import torch

    from reference import exact

    s = {k: torch.as_tensor(a, device=device) for k, a in arrays.items()}
    leaves = {k: t.requires_grad_() for k, t in state.items()}
    probe: dict = {}
    loss = cell.ref.loss({**s, **leaves}, cell.cfg, exact, probe)
    torch.autograd.grad(loss.sum(), list(leaves.values()), allow_unused=True)
    ctx = {"cfg": cell.cfg, "probe": probe, "bound": lambda k: load_module("bounds", k)}
    return {name: m.count(ctx) for name, m in metrics.items() if getattr(m, "PROBE", False)}


# ---- the result's line --------------------------------------------------------------


def result(cell: Cell, recs: list, trace: bool):
    """The result's line from the processes' records (one per card, in the
    order of their rows), and the numbers compared: name -> (value,
    limit)."""
    work, cfg, traffic = cell.work, cell.cfg, cell.traffic
    numbers = judge([r["readings"] for r in recs], combine([r["reference"] for r in recs]))
    limits = work["limits"]
    checks = {k: (numbers[k], limits[k]) for k in CHECKS}
    failed = sum(r["failed"] for r in recs)
    ok = correct(numbers, limits) and failed == 0
    kind = recs[0]["device"]
    peak = max(r["memory_peak_bytes"] for r in recs)
    device_rec = {"platform": "gpu", "kind": kind, "count": len({r["device_index"] for r in recs}),
                  "memory_peak_bytes": peak, "power_limit": power_limit()}
    metrics, breakdown = {}, None
    if not trace:
        step_ms = [max(xs) for xs in zip(*(r["step_ms"] for r in recs))]
        window_s = max(r["window_s"] for r in recs)
        metrics = {
            "mpix_per_s": {"value": cell.entry.pixels(cfg, traffic) * len(step_ms) / window_s / 1e6,
                           "unit": "Mpix/s"},
            "step_ms_p90": {"value": _quantile(step_ms, 0.9), "unit": "ms"},
            "peak_mem_mb": {"value": peak / 1e6, "unit": "MB"},
            "setup_s": {"value": max(r["setup_s"] for r in recs), "unit": "s"},
        }
    else:
        traces = [r["trace"] for r in recs]
        device_rec.update(busy_s=statistics.fmean(t["busy_s"] for t in traces),
                          window_s=max(t["window_s"] for t in traces))
        breakdown = traces[0]["breakdown"]
        from drtkbench.peaks import published_peaks

        ctx = {"traces": traces, "stage_ms": recs[0].get("stage_ms", {}), "cfg": cfg, "traffic": traffic,
               "counts": recs[0].get("probe", {}), "peaks": published_peaks(kind)}
        for name, mod in metric_modules(cell.name).items():
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    line = {"correct": ok, "attempted": recs[0]["steps"], "failed": failed, "metrics": metrics,
            "device": device_rec}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return line, checks


def run(cell_name: str, seed: int, seconds: float, trace: bool, t0_wall: float):
    """One run of a cell on one card, in this process; returns (the
    result's line as a dict, the checks: name -> (value, limit))."""
    cell = Cell(cell_name)
    return result(cell, [session(cell, seed, seconds, trace, t0_wall, "cuda")], trace)
