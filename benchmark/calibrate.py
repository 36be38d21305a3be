"""The readings that a cell's limits are set from, on the card at the cell's
own size (one process per card of the cell; run from the checkout's root):

    python3 benchmark/calibrate.py --workload inverse8.fit --seeds 1 2 3 --control-seeds 1 2 3

For each seed of ``--seeds``, the program's first steps against the
reference's (the lower readings); for each of ``--control-seeds``, the
control (the reference in bfloat16, put in the program's place) and each of
the entry's planted faults against the reference (the upper readings).
Prints one JSON line per reading and a summary: per number, the largest
program reading and the smallest control and fault readings. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def process_readings(cell, seeds: list, control_seeds: list, device, comm=None) -> list:
    """This process's readings for every seed: the program's (sound, and
    with each fault on the control seeds) and its share of the reference
    (and of the control)."""
    from drtkbench import harness
    from reference import bfloat16, exact

    rank, world = (comm.rank, comm.world) if comm else (0, 1)
    out = []
    for seed in dict.fromkeys(seeds + control_seeds):
        arrays = cell.scene(seed, device)
        rec = {"seed": seed, "program": {}}
        kinds = (["sound"] if seed in seeds else []) + (list(cell.entry.FAULTS) if seed in control_seeds else [])
        for kind in kinds:
            prog, rec["program"][kind] = harness.readings(cell, arrays, device, None if kind == "sound" else kind)
            names = list(prog.names)
            del prog
            harness.free(device)
        t0 = time.perf_counter()
        rec["reference"] = harness.reference_share(cell, arrays, names, device, exact, rank, world)
        rec["reference_s"] = time.perf_counter() - t0
        if seed in control_seeds:
            rec["control"] = harness.reference_share(cell, arrays, names, device, bfloat16, rank, world)
        out.append(rec)
        del arrays
        harness.free(device)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from drtkbench import harness, ranks

    cell = harness.Cell(args.workload)
    world = cell.work["chips"]
    if world == 1:
        per_rank = [process_readings(cell, args.seeds, args.control_seeds, torch.device("cuda"))]
    else:
        job = {"job": "calibrate", "workload": args.workload, "seeds": args.seeds,
               "control_seeds": args.control_seeds}
        per_rank = ranks.launch(job, world, 3300)
        if per_rank is None:
            return 1
    out = {}
    for by_rank in zip(*per_rank):
        seed = by_rank[0]["seed"]
        want = harness.combine([r["reference"] for r in by_rank])
        rows = [(f"fault.{k}" if k != "sound" else "program", [r["program"][k] for r in by_rank])
                for k in by_rank[0]["program"]]
        if "control" in by_rank[0]:
            ctl = harness.combine([r["control"] for r in by_rank])
            rows.append(("control", [{"losses": [step[j] for step in ctl["losses"]], "grad1": ctl["grad1"],
                                      "change": ctl["change"]} for j in range(world)]))
        for kind, got in rows:
            numbers = harness.judge(got, want)
            out.setdefault(kind, []).append(numbers)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "reference_s": max(r["reference_s"] for r in by_rank), **numbers,
                              "losses": [g["losses"] for g in got], "reference_losses": want["losses"],
                              "grad1": got[0]["grad1"], "reference_grad1": want["grad1"],
                              "change": got[0]["change"], "reference_change": want["change"]}), flush=True)
    summary = {kind: {k: (max if kind == "program" else min)(g[k] for g in gs) for k in harness.CHECKS}
               for kind, gs in out.items()}
    print(json.dumps({"workload": args.workload, "summary": summary, "device": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
