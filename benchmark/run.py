"""Run one cell of the drtk_tpu_torch benchmark once, from the checkout's root:

    python3 benchmark/run.py --workload inverse8.fit --seed 7 --seconds 20 --trace 0

Prints the result as one JSON object, the last line of standard output, and
the numbers that decide ``correct``, each beside its limit, as the last
lines of standard error. A cell on several cards runs one process per card
(``drtkbench/ranks.py``) and gathers their records here. Exits non-zero,
printing no result, when CUDA is absent or has fewer cards than the cell
asks for, when the port is not in the checkout, or when JAX, Flax or the
JAX package was loaded; a rank that fails gives ``correct`` false and a
non-zero exit.
"""

from __future__ import annotations

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# A cell on several cards: its ranks' whole run, the first of a checkout
# (which builds the kernels) included.
RANKS_TIMEOUT_S = 1000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # Kernel caches inside the checkout, at fixed paths (the port's own
    # libraries go to build/drtk_tpu_torch/ beside it).
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from drtkbench import harness

    work = harness.load_json("workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"run.py: the cell needs {work['chips']} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        from drtk_tpu_torch import _build
    except ImportError as err:
        print(f"run.py: the port is not in this checkout: {err}", file=sys.stderr)
        return 2
    trace = bool(args.trace)
    if work["chips"] == 1:
        result, checks = harness.run(args.workload, args.seed, args.seconds, trace, T0_WALL)
    else:
        from drtkbench import ranks

        _build.build_all()  # once here, not in every rank at once
        job = {"job": "run", "workload": args.workload, "seed": args.seed, "seconds": args.seconds, "trace": trace,
               "t0_wall": T0_WALL}
        recs = ranks.launch(job, work["chips"], RANKS_TIMEOUT_S)
        if recs is None:
            print(json.dumps({"correct": False, "attempted": 0, "failed": 0, "metrics": {},
                              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                         "count": work["chips"], "memory_peak_bytes": 0}}), flush=True)
            return 1
        result, checks = harness.result(harness.Cell(args.workload), recs, trace)
        found = sorted({m for r in recs for m in r["forbidden"]})
        if found:
            print(f"run.py: loaded in a rank: {', '.join(found)}", file=sys.stderr)
            return 3
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
