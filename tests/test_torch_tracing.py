"""The port's tracer (``drtk_tpu_torch.tracing``) on the CPU.

Off, a step records nothing and makes no CUDA event, no gradient hook, no
profiler range and no identity node; on, each step's span tree has the
spans and parents of its ops, the band recompute apart from the bands,
every span closed, and the step's results bit for bit those of the
untraced step. Two Gloo ranks of the row-sharded forward count the bytes
they all-reduce and send as halo. The kernels' launch counters keep their
names and reset. The CUDA events of a span are checked here through a
stand-in for ``torch.cuda.Event``; on the card, ``tests/test_torch_kernels.py``
holds them to the profiler.

Imports no JAX: the spawned ranks import this module.
"""

from __future__ import annotations

import json
import os

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import drtk_tpu_torch as tt
from drtk_tpu_torch import scenes, tracing
from drtk_tpu_torch.parallel import multihost, sharding, spmd
from drtk_tpu_torch.pipeline import avatar4k_step, inverse8_step, render_multiview

CAMS = ("campos", "camrot", "focal", "princpt")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread, as ``tests/test_torch_kernels.py``'s
    fixture (not imported from there: the spawned ranks import this
    module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inverse8():
    """A tiny inverse8 step: 2 views of 32^2, a 5x5 grid; returns a function
    that runs one step and returns (loss, grads)."""
    s = {k: torch.from_numpy(a) for k, a in scenes.inverse8_scene_arrays(32, 5, 2, tex_size=16).items()}
    cams = {k: s[k] for k in CAMS}
    with torch.no_grad():
        img_gt, _ = render_multiview(s["v_world"], s["vi"], s["vt"], s["tex_gt"], cams, 32, 32, device="cpu")
    p = ((s["v_world"] + 0.02).requires_grad_(), torch.full_like(s["tex_gt"], 0.5).requires_grad_())
    opt = torch.optim.Adam(p, lr=1e-3)

    def step():
        loss, grads = inverse8_step(p, opt, s["vi"], s["vt"], cams, img_gt, 32, 32, device="cpu")
        return loss, [grads["v_world"], grads["tex"], *p]

    return step


def _avatar4k():
    """A tiny avatar4k step: a 64^2 frame of a 9x9 grid in 2 bands under the
    recompute, an MSI on 16^2 rays."""
    a = scenes.avatar4k_scene_arrays(64, 9, 16)
    levels = [torch.from_numpy(lvl).requires_grad_() for lvl in a.pop("levels")]
    a = {k: torch.from_numpy(x) for k, x in a.items() if k != "tex"}
    v, msi_tex = a["v"].requires_grad_(), a["msi_tex"].requires_grad_()
    opt = torch.optim.Adam([v, *levels, msi_tex], lr=1e-3)

    def step():
        loss, grads = avatar4k_step((v, levels, msi_tex), opt, a["vi"], a["vt"], a["ray_o"], a["ray_d"], 64,
                                    n_bands=2, device="cpu")
        return loss, [grads["v"], *grads["levels"], grads["msi_tex"], v, *levels, msi_tex]

    return step


STEPS = {"inverse8": _inverse8, "avatar4k": _avatar4k}

OP = {  # an op's forward span and its spans inside
    "transform": [], "rasterize": [], "render": [], "interpolate": [], "edge_grad": [],
    "grid_sample": [("row_gather", [])], "mipmap_grid_sample": [("row_gather", [])],
}


def _band(name):
    return (name, [(op, OP[op]) for op in ("rasterize", "render", "interpolate", "mipmap_grid_sample")])


# Each step's span tree: (name, children), in the order the spans open.
TREES = {
    "inverse8": [
        ("forward", [(op, OP[op]) for op in ("transform", "rasterize", "render", "interpolate", "grid_sample",
                                              "edge_grad")]),
        ("backward", [("edge_grad_bwd", []), ("grid_sample_bwd", [("row_gather_bwd", [])]),
                      ("interpolate_bwd", []), ("render_bwd", []), ("transform_bwd", [])]),
        ("adam", []),
    ],
    "avatar4k": [
        ("forward", [("background", []), _band("band"), _band("band"), ("edge_grad", [])]),
        # autograd takes the bands last to first; each band's recompute runs
        # when its backward first unpacks a saved tensor
        ("backward", [("edge_grad_bwd", [])] + 2 * [
            _band("band_recompute"), ("mipmap_grid_sample_bwd", [("row_gather_bwd", [])]), ("interpolate_bwd", []),
            ("render_bwd", [])] + [("background_bwd", [])]),
        ("adam", []),
    ],
}


def _tree(spans, parent=None):
    return [(s["name"], _tree(spans, i)) for i, s in enumerate(spans) if s["parent"] == parent]


def _in_recompute(spans, i):
    while i is not None:
        if spans[i]["name"] == "band_recompute":
            return True
        i = spans[i]["parent"]
    return False


@pytest.fixture
def calls(monkeypatch):
    """Counts of what a tracer may create: CUDA events, tensor hooks,
    profiler ranges and the identity functions of backward spans."""
    n = {"event": 0, "hook": 0, "range": 0, "identity": 0}

    class Event:
        def __init__(self, *args, **kwargs):
            n["event"] += 1

        def record(self, *args):
            pass

    hook, rf = torch.Tensor.register_hook, torch.profiler.record_function

    def register_hook(self, fn):
        n["hook"] += 1
        return hook(self, fn)

    def record_function(name, *args):
        n["range"] += 1
        return rf(name, *args)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.Tensor, "register_hook", register_hook)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    for fn in (tracing._OpenBackward, tracing._CloseBackward):
        apply = fn.apply

        def counted(*args, _apply=apply):
            n["identity"] += 1
            return _apply(*args)

        monkeypatch.setattr(fn, "apply", counted)
    return n


@pytest.mark.parametrize("kind", STEPS)
def test_tracer_off_records_nothing(kind, calls):
    step = STEPS[kind]()
    tracer = tracing.Tracer()
    tt.reset_kernel_launch_counts()
    step()
    assert calls == {"event": 0, "hook": 0, "range": 0, "identity": 0}
    assert tracer.snapshot() == {"spans": [], "counts": {}}
    assert tracing.span("a") is tracing.span("b")
    assert tt.kernel_launch_counts() == dict.fromkeys(tracing.KERNELS, 0)  # CPU tensors launch no kernel


@pytest.mark.parametrize("kind", STEPS)
def test_span_tree_of_a_step(kind, calls):
    step = STEPS[kind]()
    with tracing.Tracer() as tracer:
        step()
    snap = tracer.snapshot()
    spans = snap["spans"]
    assert _tree(spans) == TREES[kind]
    assert all(s["host_end_ns"] is not None and s["host_end_ns"] >= s["host_start_ns"] for s in spans)
    assert all(s["recompute"] == _in_recompute(spans, i) for i, s in enumerate(spans))
    assert not any("device_start_ms" in s for s in spans)  # no CUDA here
    assert calls["range"] == len(spans) and calls["event"] == 0 and calls["hook"] == 0
    assert snap["counts"] == {}  # CPU tensors launch no kernel, and nothing here is a collective


@pytest.mark.parametrize("kind", STEPS)
def test_tracer_changes_no_result(kind):
    """Two copies of a step's state, two steps each, one copy traced: the
    losses, gradients and updated leaves are equal bit for bit."""
    plain, traced = STEPS[kind](), STEPS[kind]()
    for _ in range(2):
        loss, tensors = plain()
        with tracing.Tracer():
            loss_t, tensors_t = traced()
        assert torch.equal(loss, loss_t)
        assert all(torch.equal(a, b) for a, b in zip(tensors, tensors_t))


def test_spans_record_cuda_events(monkeypatch):
    """With CUDA (a stand-in for its events, each recorded at the next whole
    millisecond): two events a span, read from the tracer's first."""
    clock = iter(range(1000))

    class Event:
        def record(self, *args):
            self.t = next(clock)

        def elapsed_time(self, end):
            return float(end.t - self.t)

    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing: Event())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    tracer = tracing.Tracer()
    tracer._cuda = True
    x = torch.ones(3, requires_grad=True)
    with tracer:
        with tracing.span("outer"):
            with tracing.span("inner") as sp:
                (y,) = sp.grad_in(x)
                y = sp.grad_out(y * 2.0)
        y.sum().backward()
    spans = tracer.snapshot()["spans"]
    assert [(s["name"], s["parent"], s["device_start_ms"], s["device_end_ms"]) for s in spans] == [
        ("outer", None, 1.0, 4.0), ("inner", 0, 2.0, 3.0), ("inner_bwd", None, 5.0, 6.0)]
    torch.testing.assert_close(x.grad, torch.full((3,), 2.0))


def test_backward_span_covers_only_its_part():
    """An input that earlier work uses too: the backward span closes when
    the span's own part of its gradient is ready, before that work's
    backward runs, not with the input's whole gradient."""
    x = torch.ones(4, requires_grad=True)
    with tracing.Tracer() as tracer:
        b = _Spanned.apply(x * 5.0)  # an earlier use of x: its backward runs after the span's
        with tracing.span("first") as sp:
            (a,) = sp.grad_in(x)
            a = sp.grad_out(a * 3.0)
        (a + b).sum().backward()
    assert _tree(tracer.snapshot()["spans"]) == [("first", []), ("first_bwd", []), ("second_bwd", [])]
    torch.testing.assert_close(x.grad, torch.full((4,), 8.0))


class _Spanned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        with tracing.span("second_bwd"):
            return grad


def test_counters_and_launches():
    tt.reset_kernel_launch_counts()
    assert list(tt.kernel_launch_counts()) == ["B1 rasterize", "B2 gather_rows", "B3 scatter_rows",
                                               "B4 window_accum", "B5 rasterize_lines", "E1 edge_grad"]
    tracing.launched("B2 gather_rows")
    tracing.count("halo_bytes", 10)  # no tracer: not kept
    with tracing.Tracer() as tracer:
        tracing.launched("B2 gather_rows")
        tracing.launched("E1 edge_grad")
        tracing.count("halo_bytes", 10)
        tracing.count("halo_bytes", 6)
    assert tt.kernel_launch_counts() == {**dict.fromkeys(tracing.KERNELS, 0), "B2 gather_rows": 2, "E1 edge_grad": 1}
    assert tracer.snapshot()["counts"] == {"B2 gather_rows": 1, "E1 edge_grad": 1, "halo_bytes": 16}
    tracer.reset()
    assert tracer.snapshot() == {"spans": [], "counts": {}}
    tt.reset_kernel_launch_counts()
    assert tt.kernel_launch_counts() == dict.fromkeys(tracing.KERNELS, 0)


def test_one_tracer_at_a_time():
    with tracing.Tracer():
        with pytest.raises(RuntimeError, match="already on"):
            with tracing.Tracer():
                pass
    with tracing.Tracer():  # the first one left
        pass


def test_stage_marks_go_to_their_sink(monkeypatch):
    """``mark`` appends (name, event) to a ``stage_times`` list, at once or
    when a gradient is ready; with no list it does nothing."""
    monkeypatch.setattr(tracing, "_event", lambda: "event")
    sink = []
    x = torch.ones(2, requires_grad=True)
    y = x * 2.0
    tracing.mark(None, "none")
    tracing.mark(sink, "start")
    tracing.mark(sink, "y_bwd", y)
    tracing.mark(sink, "no_grad", torch.ones(2))
    assert sink == [("start", "event")]
    y.sum().backward()
    assert sink == [("start", "event"), ("y_bwd", "event")]


# ---- two Gloo ranks of the row-sharded forward ----------------------------------------------

SIZE, WORLD = 32, 2


def _rank(rank, store, outdir):
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", WORLD, rank, backend="gloo")
    try:
        a = scenes.make_scene_arrays(SIZE, SIZE, 5, seed=3)
        a["tex"] = a["tex"][:, :, :16, :16].copy()
        t = {k: torch.from_numpy(x) for k, x in a.items()}
        mesh = sharding.make_mesh(WORLD, batch=1, device_type="cpu")
        leaves = [t[k].clone().requires_grad_() for k in ("v", "vt", "tex")]
        fwd = spmd.make_row_sharded_forward(mesh, t["vi"], SIZE, SIZE)
        sent = []
        send = dist.batch_isend_irecv

        def batch_isend_irecv(ops):
            sent.extend(op.tensor.nbytes for op in ops if op.op is dist.isend)
            return send(ops)

        dist.batch_isend_irecv = batch_isend_irecv
        with tracing.Tracer() as tracer:
            block = fwd(*leaves)
            torch.autograd.grad((block**2).sum(), leaves)
        snap = tracer.snapshot()
        with open(os.path.join(outdir, f"{rank}.json"), "w") as f:
            json.dump({"spans": snap["spans"], "counts": snap["counts"], "sent": sum(sent),
                       "leaf_bytes": sum(p.numel() * p.element_size() for p in leaves)}, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("tracing_rows")
    mp.spawn(_rank, args=(str(out / "store"), str(out)), nprocs=WORLD)
    return [json.loads((out / f"{r}.json").read_text()) for r in range(WORLD)]


@pytest.mark.parametrize("rank", range(WORLD))
def test_row_sharded_spans_and_bytes(rows, rank):
    rec = rows[rank]
    spans = rec["spans"]
    forward = [(op, OP[op]) for op in ("rasterize", "render", "interpolate", "grid_sample", "edge_grad")]
    backward = [("edge_grad_bwd", [("halo", [])]), ("grid_sample_bwd", [("row_gather_bwd", [])]),
                ("interpolate_bwd", []), ("render_bwd", [])] + 3 * [("allreduce", [])]
    assert _tree(spans) == [("forward", forward), ("backward", backward)]
    assert all(s["host_end_ns"] is not None for s in spans)
    assert rec["counts"]["allreduce_bytes"] == rec["leaf_bytes"]  # v, vt and tex, whole, once each
    # rank 0 has no rank before it to send its first rows to
    assert rec["counts"].get("halo_bytes", 0) == rec["sent"] == (0 if rank == 0 else 4 * SIZE * (3 + 3 + 3 + 1))
