"""``BENCHMARK.json`` assembled from the benchmark's files: ``spec.json``
(the command, the run's length, the end-to-end metrics and their bounds),
``configs/*.json``, ``workloads/*.json`` (in the order of their
``rank``) and ``metrics/*.py``. From the checkout's root:

    python3 benchmark/spec.py           # print it
    python3 benchmark/spec.py --write   # write BENCHMARK.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def build() -> dict:
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from drtkbench import harness

    spec = json.loads((BENCH / "spec.json").read_text())
    cells = sorted(BENCH.glob("workloads/*.json"), key=lambda p: (json.loads(p.read_text())["rank"], p.stem))
    works = [(p.stem, json.loads(p.read_text())) for p in cells]
    used = list(dict.fromkeys(w["config"] for _, w in works))
    configs = []
    for name in used:
        c = harness.load_json("configs", name)
        configs.append({"name": name, "source": c["source"], "file": f"benchmark/configs/{name}.json",
                        "reduced": c["reduced"], "why": c["why"]})
    workloads = [{"name": n, "config": w["config"], "traffic": w["traffic"], "chips": w["chips"], "why": w["why"]}
                 for n, w in works]
    per_layer = []
    for path in sorted((BENCH / "metrics").glob("*.py")):
        m = harness.load_module("metrics", path.stem)
        entry = {"name": path.stem, "unit": m.UNIT, "better": m.BETTER, "source": m.SOURCE, "layer": m.LAYER,
                 "moves": m.MOVES}
        if getattr(m, "WORKLOADS", None) is not None:
            entry["workloads"] = list(m.WORKLOADS)
        per_layer.append(entry)
    return {"command": spec["command"], "paths": spec["paths"], "run_seconds": spec["run_seconds"],
            "configs": configs, "workloads": workloads, "end_to_end": spec["end_to_end"], "per_layer": per_layer}


def main() -> int:
    text = json.dumps(build(), indent=2) + "\n"
    if "--write" in sys.argv[1:]:
        (BENCH.parent / "BENCHMARK.json").write_text(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
