"""The readings of ``spans.py`` from the port's spans: each per-layer
number on a made-up window of two steps, None without spans, and the idle
gaps named by the innermost span open when each began. One traced step of
the tiny inverse8 cell on the CPU gives a snapshot the readings take."""

import pytest

import spans
from drtkbench import harness


def _span(name, parent, dev, host_ms=1.0, start=0):
    return {"name": name, "parent": parent, "recompute": False, "host_start_ns": start,
            "host_end_ns": start + int(host_ms * 1e6), "device_start_ms": 0.0, "device_end_ms": dev}


def _step(base, top_dev, ops, host=(2.0, 3.0, 0.5)):
    """A step's spans from index ``base``: forward, backward and adam, each
    op (name, device ms, under "forward" or "backward") as a child."""
    out = [_span("forward", None, top_dev, host[0])]
    out += [_span(name, base, dev) for name, dev, top in ops if top == "forward"]
    out.append(_span("backward", None, top_dev, host[1]))
    b = base + len(out) - 1
    out += [_span(name, b, dev) for name, dev, top in ops if top == "backward"]
    out.append(_span("adam", None, 0.1, host[2]))
    return out


OPS = [("rasterize", 1.0, "forward"), ("render", 0.5, "forward"), ("mipmap_grid_sample", 4.0, "forward"),
       ("row_gather", 1.5, "forward"), ("background", 0.25, "forward"), ("mipmap_grid_sample_bwd", 6.0, "backward"),
       ("row_gather_bwd", 2.0, "backward"), ("band_recompute", 7.0, "backward"), ("rasterize", 1.0, "backward"),
       ("background_bwd", 0.75, "backward"), ("allreduce", 0.3, "backward"), ("halo", 0.1, "backward")]


def _cards(second_step_scale=3.0):
    s1 = _step(0, 20.0, OPS)
    s2 = _step(len(s1), 20.0, [(n, d * second_step_scale, t) for n, d, t in OPS], host=(4.0, 5.0, 1.0))
    snap = {"spans": s1 + s2, "counts": {"allreduce_bytes": 4_000_000, "halo_bytes": 1_000_000}}
    return [{"steps": spans.steps_of(snap), "counts": snap["counts"]}]


def test_steps_of_cuts_at_each_forward():
    steps = _cards()[0]["steps"]
    assert len(steps) == 2
    assert steps[0]["spans"]["rasterize"] == [2.0, 2.0, 2]
    assert steps[0]["top_host_ms"] == pytest.approx(5.5) and steps[1]["top_host_ms"] == pytest.approx(10.0)


@pytest.mark.parametrize("name, want", [
    ("host_ms_per_step", (5.5 + 10.0) / 2),
    ("span_ms.rasterize", (2.0 + 6.0) / 2),
    ("span_ms.mipmap_grid_sample", (10.0 + 30.0) / 2),
    ("span_ms.row_gather", (3.5 + 10.5) / 2),
    ("span_ms.background", (1.0 + 3.0) / 2),
    ("span_ms.band_recompute", (7.0 + 21.0) / 2),
    ("span_ms.collectives", (0.4 + 1.2) / 2),
    ("span_ms.shading", (0.5 + 1.5) / 2),
    ("collective_mb_per_step", 2.5),
])
def test_metric_reads_the_spans(name, want):
    assert spans.METRICS[name][4](_cards()) == pytest.approx(want)
    assert spans.METRICS[name][4]([{"steps": [], "counts": {}}]) is None


def test_the_largest_card_is_read():
    cards = _cards() + _cards(second_step_scale=5.0)
    assert spans.METRICS["span_ms.collectives"][4](cards) == pytest.approx((0.4 + 2.0) / 2)


def test_each_cell_reads_its_metrics():
    names = {cell: set(spans.read_metrics(_cards(), cell)) for cell in ("inverse8.fit", "avatar4k.fit",
                                                                        "multiview4k.rows4")}
    assert names["inverse8.fit"] == {"host_ms_per_step", "span_ms.rasterize", "span_ms.shading"}
    assert "span_ms.band_recompute" in names["avatar4k.fit"] and "collective_mb_per_step" in names["multiview4k.rows4"]
    cells = {p.stem for p in (harness.BENCH / "workloads").glob("*.json")}
    assert all(set(m[3]) <= cells for m in spans.METRICS.values())


def test_gaps_are_named_by_the_innermost_span():
    dev = [(0, 10), (12, 20), (20, 30), (40, 50), (49, 60), (61, 62)]
    gaps = spans.idle_gaps(dev)
    assert gaps == [(10, 2), (30, 10), (60, 1)]
    ranges = [(0, 100, "forward"), (25, 45, "render"), (5, 11, "transform")]
    host = [(0, 35, "aten::mul")]
    longest, by_span = spans.name_gaps(gaps + [(200, 4)], ranges, host, 2)
    assert longest == [["render", "aten::mul", 0.01], ["outside the program", "(no host operation)", 0.004],
                       ["transform", "aten::mul", 0.002], ["forward", "(no host operation)", 0.001]]
    assert by_span == {"render": 0.005, "outside the program": 0.002, "transform": 0.001, "forward": 0.0005}


def test_a_cpu_step_snapshot_reads():
    """The tiny inverse8 cell's program, one step traced on the CPU (no
    device times): the steps and the host time read."""
    from conftest import TINY
    from drtk_tpu_torch import tracing

    cell = harness.Cell("inverse8.fit", TINY["inverse8"])
    prog = cell.entry.Program(cell.cfg, cell.traffic, cell.scene(4, "cpu"), "cpu")
    with tracing.Tracer() as tracer:
        for _ in range(2):
            prog.step()
    cards = [{"steps": spans.steps_of(tracer.snapshot()), "counts": {}}]
    assert len(cards[0]["steps"]) == 2
    assert spans.METRICS["host_ms_per_step"][4](cards) > 0
    assert {"transform", "rasterize", "grid_sample_bwd", "adam"} <= set(cards[0]["steps"][1]["spans"])
    assert spans.METRICS["collective_mb_per_step"][4](cards) is None
