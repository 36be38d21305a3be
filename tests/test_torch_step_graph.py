"""The avatar4k step's CUDA graph (``drtk_tpu_torch.step_graph``,
``pipeline.avatar4k_step``).

On the CPU: the rule of when the graph engages (``eager_reason``), the key
(``StepKey`` through ``pipeline._avatar4k_key``), and the eager step's
counters. On the card (``-m cuda``; this file imports no JAX, so it runs
there with ``--noconftest``), at a reduced avatar4k size (a 512^2 frame of a
65 x 65 grid in 4 bands, the 3 x 512^2 .. 64^2 pyramid, 32^2 rays): graphed
steps against eager ones from the same state, within the limits of the
benchmark's ``avatar4k.fit`` (``loss_gap`` 6.4e-6, ``change_gap`` 6.8e-4;
the same kernels run, and only the order of their atomic adds may differ),
the returned tensors not overwritten by later replays, the counters, the
kernel launches a replay counts, a recapture for new tensors, and a
patched module function showing in the loss after a capture.
"""

import gc
import statistics

import pytest
import torch

from drtk_tpu_torch import pipeline, tracing
from drtk_tpu_torch.interop import scene_from_numpy
from drtk_tpu_torch.pipeline import avatar4k_step
from drtk_tpu_torch.scenes import avatar4k_scene_arrays
from drtk_tpu_torch.step_graph import StepKey, eager_reason

H, GN, BH, N_BANDS = 512, 65, 32, 4
LOSS_GAP, CHANGE_GAP = 6.4e-6, 6.8e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run with -m cuda on the card)")
    return torch.device("cuda")


def _inputs(device="cpu", h=16, gn=5, bh=4):
    """An avatar4k scene's tensors on ``device``, its leaves requiring
    gradients: (leaves, vi, vt, ray_o, ray_d)."""
    s = scene_from_numpy(avatar4k_scene_arrays(h, gn, bh), device)
    leaves = [s["v"].requires_grad_(), *(x.requires_grad_() for x in s["levels"]), s["msi_tex"].requires_grad_()]
    return leaves, s["vi"], s["vt"], s["ray_o"], s["ray_d"]


def _key(tensors, n_bands=N_BANDS):
    return pipeline._avatar4k_key(tensors, H, n_bands, True, "cuda")


# ---- the rule and the key, on the CPU ------------------------------------------------


@pytest.mark.parametrize("case, reason", [
    ("cpu tensors", "device"), ("stage_times", "stage_times"), ("tracer", "tracer"), ("impl plain", "impl"),
    ("no_grad", "no_grad"),
])
def test_eager_reason(case, reason):
    """Each condition alone keeps the step eager; the device is checked
    last, so every other case shows its own reason on CPU tensors."""
    leaves, *rest = _inputs()
    tensors = [*leaves, *rest]
    impl = "plain" if case == "impl plain" else "auto"
    stage_times = [] if case == "stage_times" else None
    if case == "tracer":
        with tracing.Tracer():
            assert eager_reason(tensors, impl, stage_times) == reason
    elif case == "no_grad":
        with torch.no_grad():
            assert eager_reason(tensors, impl, stage_times) == reason
    else:
        assert eager_reason(tensors, impl, stage_times) == reason


def test_key_is_the_same_for_the_same_objects():
    leaves, *rest = _inputs()
    tensors = [*leaves, *rest]
    assert _key(tensors) == _key(list(tensors))
    assert not (_key(tensors) != _key(tensors))


@pytest.mark.parametrize("change", [
    "new tensor at the address", "dead tensor, address reused", "stride", "requires_grad", "n_bands",
    "patched map_row_bands",
])
def test_key_changes(change, monkeypatch):
    """A key names objects in a state: a new tensor at the same address and
    layout, a tensor that died and whose address a new one took, a changed
    stride or ``requires_grad``, another band count and a patched module
    function each make a new key."""
    leaves, vi, vt, ray_o, ray_d = _inputs()
    base = torch.zeros(3, 3)
    extra = base.view_as(base)
    tensors = [*leaves, vi, vt, ray_o, ray_d, extra]
    before = _key(tensors)
    n_bands = N_BANDS
    if change == "new tensor at the address":
        tensors[-1] = base.view_as(base)
    elif change == "dead tensor, address reused":
        del tensors[-1], extra
        gc.collect()
        tensors.append(base.view_as(base))
    elif change == "stride":
        extra.t_()
    elif change == "requires_grad":
        extra.requires_grad_()
    elif change == "n_bands":
        n_bands = 2
    else:
        monkeypatch.setattr(pipeline, "map_row_bands", lambda *a, **k: None)
    after = _key(tensors, n_bands)
    assert tensors[-1].data_ptr() == base.data_ptr()
    assert after != before


def test_step_key_holds_no_tensor():
    """The key holds its tensors weakly: a key does not keep them alive."""
    t = torch.zeros(4)
    key = StepKey([t], ())
    ref = key.refs[0]
    del t
    gc.collect()
    assert ref() is None


def test_cpu_step_runs_eagerly():
    """On CPU tensors every step is eager, and counted so; the gradients
    are the ones applied, new each step."""
    leaves, vi, vt, ray_o, ray_d = _inputs(h=32, gn=5, bh=4)
    opt = torch.optim.Adam(leaves, lr=1e-3)
    before = tracing.step_graph_counts()
    grads = []
    for _ in range(2):
        _, g = avatar4k_step((leaves[0], leaves[1:-1], leaves[-1]), opt, vi, vt, ray_o, ray_d, 32, 4, device="cpu")
        grads.append(g["v"])
        assert leaves[0].grad is g["v"]
    after = tracing.step_graph_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "step_graph_captures": 0, "step_graph_replays": 0, "step_graph_eager": 2}
    assert grads[0] is not grads[1]


# ---- the graph on the card ---------------------------------------------------------------


class _Program:
    """The avatar4k step at the reduced size, fresh tensors on the card."""

    def __init__(self, dev):
        self.leaves, self.vi, self.vt, self.ray_o, self.ray_d = _inputs(dev, H, GN, BH)
        self.start = [p.detach().clone() for p in self.leaves]
        self.opt = torch.optim.Adam(self.leaves, lr=1e-3)

    def step(self, eager=False):
        """One step; returns (loss, grads, the kernel launches it counted)."""
        torch.cuda.synchronize()
        before = tracing.kernel_launch_counts()
        params = (self.leaves[0], self.leaves[1:-1], self.leaves[-1])
        loss, grads = avatar4k_step(params, self.opt, self.vi, self.vt, self.ray_o, self.ray_d, H, N_BANDS,
                                    stage_times=[] if eager else None)
        torch.cuda.synchronize()
        after = tracing.kernel_launch_counts()
        return loss, grads, {k: after[k] - before[k] for k in after}

    def changes(self):
        return [float((p.detach() - s).norm()) for p, s in zip(self.leaves, self.start)]


def _counts_since(before):
    after = tracing.step_graph_counts()
    return {k: after[k] - before[k] for k in after}


def _loss_gap(got, want):
    return max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(got, want))


def _change_gap(got, want):
    """``benchmark/drtkbench/harness.py``'s ``change_gap`` of the leaves'
    change norms, over every leaf."""
    med = statistics.median(want)
    return max(abs(a - b) / max(b, med) for a, b in zip(got, want))


@pytest.mark.cuda
def test_graphed_steps_match_eager_steps(cuda_device):
    """6 graphed steps (eager, captured, 4 replays) against 6 eager steps
    from the same state: losses and the leaves' changes within the cell's
    limits; the counters at 1 capture, 4 replays and 1 eager; each step's
    launches equal to an eager step's; a returned loss and gradient not
    overwritten by the next replay."""
    eager, graphed = _Program(cuda_device), _Program(cuda_device)
    eager_out = [eager.step(eager=True) for _ in range(6)]
    before = tracing.step_graph_counts()
    graph_out, seen = [], []
    for _ in range(6):
        graph_out.append(graphed.step())
        seen.append((float(graph_out[-1][0]), graph_out[-1][1]["v"].clone()))
    assert _counts_since(before) == {"step_graph_captures": 1, "step_graph_replays": 4, "step_graph_eager": 1}
    assert _loss_gap([o[0] for o in graph_out], [o[0] for o in eager_out]) <= LOSS_GAP
    assert _change_gap(graphed.changes(), eager.changes()) <= CHANGE_GAP
    launches = eager_out[0][2]
    assert launches["R1 render"] == 3 * N_BANDS and launches["E1 edge_grad"] == N_BANDS
    assert all(o[2] == launches for o in eager_out + graph_out)
    for (loss, grads, _), (loss_then, grad_then) in zip(graph_out, seen):
        assert float(loss) == loss_then
        assert torch.equal(grads["v"], grad_then)


@pytest.mark.cuda
def test_new_tensors_recapture(cuda_device):
    """A second program with fresh tensors runs eagerly, captures and
    replays again, reading its own tensors; when its tensors die the graph
    goes with them."""
    first, second = _Program(cuda_device), _Program(cuda_device)
    losses_first = [first.step()[0] for _ in range(3)]
    before = tracing.step_graph_counts()
    losses_second = [second.step()[0] for _ in range(3)]
    assert _counts_since(before) == {"step_graph_captures": 1, "step_graph_replays": 1, "step_graph_eager": 1}
    assert _loss_gap(losses_second, losses_first) <= LOSS_GAP
    assert _change_gap(second.changes(), first.changes()) <= CHANGE_GAP
    assert pipeline._AVATAR4K_GRAPH._graph is not None
    del second
    gc.collect()
    assert pipeline._AVATAR4K_GRAPH._graph is None


@pytest.mark.cuda
def test_a_patched_function_after_a_capture_shows_in_the_loss(cuda_device, monkeypatch):
    """The benchmark's ``half`` fault (only the upper half of the bands
    rendered, each twice) planted after a capture: the next step runs it,
    eagerly, and its loss is the half frame's."""
    prog = _Program(cuda_device)
    for _ in range(2):
        prog.step()
    params = (prog.leaves[0], prog.leaves[1:-1], prog.leaves[-1])
    args = (prog.vi, prog.vt, prog.ray_o, prog.ray_d, H, N_BANDS)
    orig = pipeline.map_row_bands

    def half(band_fn, height, n_bands, remat=True):
        out = orig(band_fn, height // 2, n_bands // 2, remat)
        return tuple(torch.cat([t, t], dim=-2) for t in out)

    full = float(pipeline.avatar4k_loss(params, *args).detach())
    monkeypatch.setattr(pipeline, "map_row_bands", half)
    want = float(pipeline.avatar4k_loss(params, *args).detach())
    before = tracing.step_graph_counts()
    loss = float(prog.step()[0])
    assert _counts_since(before) == {"step_graph_captures": 0, "step_graph_replays": 0, "step_graph_eager": 1}
    assert want != full
    assert abs(loss - want) <= abs(want - full) / 10
