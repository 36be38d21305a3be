"""The harness is driven by files: a configuration, a cell, a traffic mix
and a per-layer metric added as new files are found by name, and
``BENCHMARK.json`` is what they assemble to."""

import json
import shutil
import sys

import pytest

import spec
from drtkbench import harness


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of the benchmark's files that the harness and the spec read."""
    root = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    monkeypatch.setattr(harness, "BENCH", root)
    monkeypatch.setattr(spec, "BENCH", root)
    yield root
    for name in [m for m in sys.modules if m.startswith("drtkbench_")]:
        del sys.modules[name]


def test_benchmark_json_is_assembled_from_the_files():
    with open(harness.BENCH.parent / "BENCHMARK.json") as f:
        assert json.load(f) == spec.build()


def test_new_files_are_found_by_name(tree):
    cfg = json.loads((tree / "configs" / "inverse8.json").read_text())
    cfg.update(name="inverse8x2k", height=2048, width=2048, grid=321)
    (tree / "configs" / "inverse8x2k.json").write_text(json.dumps(cfg))
    (tree / "traffic" / "vonly.json").write_text(json.dumps(
        {"why": "vertices alone", "wrt": ["v"], "frozen_index": False, "lr": 0.001}))
    work = json.loads((tree / "workloads" / "inverse8.fit.json").read_text())
    work.update(config="inverse8x2k", traffic="vonly", rank=99, why="a new cell")
    (tree / "workloads" / "inverse8x2k.vonly.json").write_text(json.dumps(work))
    (tree / "metrics" / "new_share.py").write_text(
        'UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "device_trace", "Device", "mpix_per_s"\n'
        'WORKLOADS = ["inverse8x2k.vonly"]\n\n\ndef read(ctx):\n    return None\n')

    cell = harness.Cell("inverse8x2k.vonly")
    assert cell.cfg["height"] == 2048 and cell.traffic["wrt"] == ["v"]
    assert "new_share" in harness.metric_modules("inverse8x2k.vonly")
    assert "new_share" not in harness.metric_modules("inverse8.fit")
    built = spec.build()
    assert built["workloads"][-1]["name"] == "inverse8x2k.vonly"
    assert "inverse8x2k" in [c["name"] for c in built["configs"]]
    assert {"name": "new_share", "unit": "%", "better": "higher", "source": "device_trace", "layer": "Device",
            "moves": "mpix_per_s", "workloads": ["inverse8x2k.vonly"]} in built["per_layer"]
