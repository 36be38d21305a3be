"""Runs of each cell on the CPU at a tiny size, the window left out (it
runs on the card alone): the port's plain versions through the cell's
checked steps against the reference, the planted faults and the control,
each judged as a run judges it. The four-card cell runs as four processes
under Gloo."""

import json
import os
import time

import pytest
import torch
import torch.multiprocessing as mp
from conftest import TINY

from drtkbench import harness, ranks
from reference import bfloat16, exact

CELLS = ["inverse8.fit", "avatar4k.fit"]
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _tiny(cell):
    return TINY[harness.load_json("workloads", cell)["config"]]


def _line(cell, got_by_rank, shares):
    """The result's line of a run whose processes read ``got_by_rank`` and
    whose reference shares are ``shares`` (the window's numbers made up)."""
    recs = [{"readings": got, "reference": share, "failed": 0, "device": "cpu", "device_index": i,
             "memory_peak_bytes": 1, "step_ms": [1.0, 1.0], "window_s": 1.0, "setup_s": 1.0, "steps": 2}
            for i, (got, share) in enumerate(zip(got_by_rank, shares))]
    return harness.result(cell, recs, False)[0]


def _as_readings(share):
    """A reference's share as the program's readings (the control in the
    program's place)."""
    return {"losses": [sum(parts) for parts in share["losses"]],
            "grad1": {k: v**0.5 for k, v in share["grad1_sq"].items()},
            "change": {k: v**0.5 for k, v in share["change_sq"].items()}}


def _one_process(cell_name, seed, fault=None, control=False):
    cell = harness.Cell(cell_name, _tiny(cell_name))
    arrays = cell.scene(seed, "cpu")
    prog, got = harness.readings(cell, arrays, "cpu", fault)
    names = list(prog.names)
    del prog
    share = harness.reference_share(cell, arrays, names, "cpu", exact)
    if control:
        got = _as_readings(harness.reference_share(cell, arrays, names, "cpu", bfloat16))
    return cell, _line(cell, [got], [share])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    _, line = _one_process(cell, 2**31 + 17)
    assert list(line) == CONTRACT_KEYS
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"mpix_per_s", "step_ms_p90", "peak_mem_mb", "setup_s"}
    assert list(line["checks"]) == list(harness.CHECKS)
    assert line["device"]["count"] == 1


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault):
    _, line = _one_process(cell, 5, fault)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    """The reference in bfloat16 put in the program's place fails at least
    one of the cell's limits."""
    _, line = _one_process(cell, 9, control=True)
    assert not line["correct"], line["checks"]


def test_seed_gives_same_inputs_and_sizes():
    c = harness.Cell("inverse8.fit", TINY["inverse8"])
    a, b, other = (c.entry.scene(c.cfg, c.traffic, s) for s in (2**31 + 5, 2**31 + 5, 4))
    assert all((a[k] == b[k]).all() for k in a)
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in other.items()}
    assert not (a["tex_gt"] == other["tex_gt"]).all()


# ---- the four-card cell, as four processes under Gloo ---------------------------------

ROWS = "multiview4k.rows4"
KINDS = ["sound", "unchanged", "half", "exchange", "control"]


def _rows_rank(rank, world, store, out, seed):
    comm = ranks.init(rank, world, store, "gloo")
    try:
        cell = harness.Cell(ROWS, TINY["multiview4k"])
        arrays = cell.scene(seed, "cpu")
        rec = {}
        for kind in KINDS[:-1]:
            prog, rec[kind] = harness.readings(cell, arrays, "cpu", None if kind == "sound" else kind)
            names = list(prog.names)
            del prog
        rec["reference"] = harness.reference_share(cell, arrays, names, "cpu", exact, comm.rank, comm.world)
        rec["control"] = harness.reference_share(cell, arrays, names, "cpu", bfloat16, comm.rank, comm.world)
        with open(os.path.join(out, f"{rank}.json"), "w") as f:
            json.dump(rec, f)
        comm.barrier()
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def rows_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("rows")
    world = harness.load_json("configs", "multiview4k")["mesh"][1]
    mp.spawn(_rows_rank, args=(world, str(out / "store"), str(out), 2**31 + 3), nprocs=world)
    recs = [json.loads((out / f"{r}.json").read_text()) for r in range(world)]
    return harness.Cell(ROWS, TINY["multiview4k"]), recs


@pytest.mark.parametrize("kind", KINDS)
def test_rows_run_is_judged(rows_run, kind):
    """Sound ranks are correct; each planted fault (the state unchanged, half
    the cameras, the all-reduce between the cards left out) and the control
    (the reference in bfloat16, every rank its block) are not."""
    cell, recs = rows_run
    shares = [r["reference"] for r in recs]
    if kind == "control":
        want = harness.combine([r["control"] for r in recs])
        got = [{"losses": [step[j] for step in want["losses"]], "grad1": want["grad1"], "change": want["change"]}
               for j in range(len(recs))]
    else:
        got = [r[kind] for r in recs]
    line = _line(cell, got, shares)
    assert list(line) == CONTRACT_KEYS
    assert line["correct"] == (kind == "sound"), line["checks"]
    if kind == "sound":
        assert line["device"]["count"] == len(recs)


def test_rows_ranks_hold_the_same_leaves(rows_run):
    _, recs = rows_run
    assert all(r["sound"]["grad1"] == recs[0]["sound"]["grad1"] for r in recs)
    assert len({tuple(r["sound"]["losses"]) for r in recs}) == len(recs)  # each its own block


def test_failed_rank_stops_the_run():
    """Ranks that cannot start (no card here) end the launch with no records,
    every process stopped, well within its time."""
    t0 = time.monotonic()
    job = {"job": "run", "workload": ROWS, "seed": 1, "seconds": 1.0, "trace": False, "t0_wall": time.time()}
    assert ranks.launch(job, 4, 120) is None
    assert time.monotonic() - t0 < 100


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_run_on_the_card(cuda_device, trace):
    line, checks = harness.run("inverse8.fit", 3, 1.0, trace, time.time())
    assert line["correct"], checks
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
