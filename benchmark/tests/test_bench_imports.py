"""What the harness and the reference load: no JAX, no Flax, no JAX
package (by whole top-level names), and the reference nothing of the port;
and what ``run.py`` does without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from drtkbench import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _python(code: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(BENCH), str(ROOT)])}
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)


def test_a_tiny_run_loads_no_jax():
    out = _python(
        "import sys, json\n"
        "from drtkbench import harness, ranks\n"
        "from reference import exact\n"
        "for name, tiny in (('inverse8.fit', {'height': 16, 'width': 16, 'grid': 5, 'texture': 8}),\n"
        "                   ('avatar4k.fit', {'height': 64, 'width': 64, 'grid': 9, 'texture': 16, 'rays': 8,\n"
        "                                     'msi': [2, 4, 8, 16], 'bands': 2})):\n"
        "    cell = harness.Cell(name, tiny)\n"
        "    arrays = cell.scene(1, 'cpu')\n"
        "    prog, got = harness.readings(cell, arrays, 'cpu')\n"
        "    harness.reference_share(cell, arrays, list(prog.names), 'cpu', exact)\n"
        "harness.Cell('multiview4k.rows4')\n"
        "for name in ('calibrate', 'spec'):\n"
        "    __import__(name)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert "drtk_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "drtk_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    out = _python(
        "import sys, json\n"
        "import reference, reference.inverse8, reference.rows, reference.avatar4k, reference.raster\n"
        "import reference.shade\n"
        "import reference.edge_grad\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert not top & {"drtk_tpu_torch", "drtk_tpu", "jax", "jaxlib", "flax", "drtkbench"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("jax", "jaxlib.xla", "flax.linen", "drtk_tpu", "drtk_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    found = harness.forbidden_modules()
    assert {"jax", "jaxlib.xla", "flax.linen", "drtk_tpu", "drtk_tpu.ops"} <= set(found)
    assert not [m for m in found if m.split(".")[0] not in ("jax", "jaxlib", "flax", "drtk_tpu")]


@pytest.mark.parametrize("cell", ["inverse8.fit", "multiview4k.rows4"])
def test_run_without_a_card_prints_no_result(cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    if out.returncode == 0:  # a machine with a card
        assert json.loads(out.stdout.splitlines()[-1])["correct"] in (True, False)
    else:
        assert out.stdout.strip() == "", out.stdout
        assert "CUDA" in out.stderr


def test_run_without_the_port_prints_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "inverse8.fit", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
