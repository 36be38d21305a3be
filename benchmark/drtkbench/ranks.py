"""A cell on several cards: one process per card, each a rank of one
``torch.distributed`` group.

:func:`launch` (in the process that prints the result) starts the ranks,
each ``python3 benchmark/drtkbench/ranks.py <arguments as JSON>``, with a
``FileStore`` for their rendezvous in a new directory under ``TMPDIR``;
every rank runs its job (:func:`harness.session`, or the readings of
``calibrate.py``) on its own card under NCCL, with a Gloo group beside it
that carries the first rank's decision to end the window, and writes its
record into that directory. When a rank fails or
the time runs out, the others are stopped; :func:`launch` waits for every
rank and returns the records, or None.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# A collective that waits longer than this raises in every rank.
COLLECTIVE_TIMEOUT_S = 300


class Comm:
    """This rank's place in the group: ``barrier()`` on the host, and
    ``agree(flag)``, the first rank's flag on every rank."""

    def __init__(self, rank: int, world: int, gloo):
        self.rank, self.world, self.gloo = rank, world, gloo

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.gloo)

    def agree(self, flag: bool) -> bool:
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.broadcast(t, src=0, group=self.gloo)
        return bool(t.item())


def init(rank: int, world: int, store_path: str, backend: str) -> Comm:
    """Joins the group: ``backend`` ("nccl": a card per rank, or "gloo")
    for the program's collectives, and a Gloo group for the host's."""
    import torch.distributed as dist

    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return Comm(rank, world, dist.new_group(backend="gloo"))


def worker(args: dict) -> int:
    """One rank: its card, the group, then its job, :func:`harness.session`
    (``"run"``) or :func:`calibrate.process_readings` (``"calibrate"``);
    its record written to ``<dir>/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from drtkbench import harness

    rank, world = args["rank"], args["world"]
    torch.cuda.set_device(rank)
    device = torch.device("cuda", rank)
    comm = init(rank, world, os.path.join(args["dir"], "store"), "nccl")
    try:
        cell = harness.Cell(args["workload"])
        if args["job"] == "run":
            rec = harness.session(cell, args["seed"], args["seconds"], args["trace"], args["t0_wall"], device, comm)
        else:
            import calibrate

            rec = calibrate.process_readings(cell, args["seeds"], args["control_seeds"], device, comm)
        tmp = os.path.join(args["dir"], f"rank{rank}.part")
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, os.path.join(args["dir"], f"rank{rank}.json"))
        comm.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def launch(job: dict, world: int, timeout_s: float) -> list | None:
    """Runs ``world`` ranks of ``job`` (:func:`worker`'s arguments but the
    rank's own); returns their records in rank order, or None when a rank
    fails or ``timeout_s`` passes (every rank is stopped, and waited for,
    before it returns)."""
    tmp = tempfile.mkdtemp(prefix="drtkbench-ranks-")
    procs = []
    try:
        for rank in range(world):
            args = {**job, "rank": rank, "world": world, "dir": tmp}
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), json.dumps(args)],
                                          stdout=sys.stderr, cwd=ROOT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        codes = [p.poll() for p in procs]
        if codes != [0] * world:
            print(f"ranks: exit codes {codes} (None: still running after {timeout_s:.0f} s or a peer's failure); "
                  "stopping the rest", file=sys.stderr)
            return None
        recs = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                recs.append(json.load(f))
        return recs
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    # This file's directory first on the path would let its profile.py
    # stand in for the standard library's.
    sys.path[0:1] = [str(BENCH), str(ROOT)]
    sys.exit(worker(json.loads(sys.argv[1])))
