"""The port's tracer: spans and counters, kept in memory.

Nothing is recorded until a caller enters a :class:`Tracer`::

    tracer = Tracer()
    with tracer:
        inverse8_step(...)
    snap = tracer.snapshot()  # {"spans": [...], "counts": {...}}

While no tracer is entered, :func:`span` returns one shared null context
(no CUDA event, no gradient hook, no profiler range), :func:`count` returns
at once, and only the kernels' launch counts (:func:`launched`, read by
:func:`kernel_launch_counts`) and the step graphs' counts
(:func:`step_graph_ran`, read by :func:`step_graph_counts`) are kept.

While one is entered, each span records its name, its parent (the
innermost span open when it opened), its host start and end
(``time.perf_counter_ns``) and, where CUDA is available, a CUDA event pair
on the current stream; it also enters a ``torch.profiler.record_function``
range of its name, so under torch.profiler the spans lie on the same
timeline as the device operations they issue.

A forward span is a ``with span(name)`` block. Its backward span (by
default named ``name + "_bwd"``) is a pair of gradient hooks around the
block's work: :meth:`_Span.grad_in` passes the block's inputs through an
identity function whose backward closes the span once the block's part of
their gradients is ready, and :meth:`_Span.grad_out` passes its outputs
through one whose backward opens it when their gradients arrive. An op
that is one autograd Function opens a plain span in its ``backward``
instead. Spans opened while :func:`bands` re-runs a band in the backward
(``torch.utils.checkpoint``'s recompute) carry ``recompute``; they
register no backward span, since the recompute's graph is never
differentiated.

:func:`mark` is the sink of the steps' ``stage_times=`` lists: (name, CUDA
event) at a point of the forward or when a tensor's gradient is ready.
"""

from __future__ import annotations

import time

import torch

__all__ = [
    "KERNELS", "Tracer", "bands", "count", "kernel_launch_counts", "launched", "mark", "on",
    "reset_kernel_launch_counts", "span", "step_graph_counts", "step_graph_ran",
]

# The hand-written kernels, by the names kernel_launch_counts() gives them.
KERNELS = ("B1 rasterize", "B2 gather_rows", "B3 scatter_rows", "B4 window_accum", "B5 rasterize_lines",
           "E1 edge_grad", "M1 mipmap_sample", "R1 render")
_launches = dict.fromkeys(KERNELS, 0)
# How the steps that can take a CUDA graph ran (drtk_tpu_torch/step_graph.py):
# captured (and replayed once), replayed, or eagerly.
STEP_GRAPH_COUNTS = ("step_graph_captures", "step_graph_replays", "step_graph_eager")
_step_graph = dict.fromkeys(STEP_GRAPH_COUNTS, 0)
_active: Tracer | None = None


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Record:
    """One span: its place in the tree, host times, CUDA events and the
    profiler range that is open while it is."""

    __slots__ = ("name", "index", "parent", "recompute", "host_start", "host_end", "ev_start", "ev_end", "range")

    def __init__(self, name: str, index: int, parent: int | None, recompute: bool):
        self.name, self.index, self.parent, self.recompute = name, index, parent, recompute
        self.host_start = self.host_end = self.ev_start = self.ev_end = self.range = None


class Tracer:
    """Spans and counters of the work done while it is entered (one tracer
    at a time). Records stay in memory until :meth:`reset`."""

    def __init__(self):
        self._cuda = torch.cuda.is_available()
        self._records: list[_Record] = []
        self._open: list[_Record] = []
        self._recompute = 0
        self._base = None
        self.counts: dict[str, int | torch.Tensor] = {}

    def __enter__(self) -> Tracer:
        global _active
        if _active is not None:
            raise RuntimeError("a tracer is already on")
        if self._cuda and self._base is None:
            self._base = _event()
        _active = self
        return self

    def __exit__(self, *exc) -> None:
        global _active
        _active = None

    def _start(self, name: str, recompute: bool = False) -> _Record:
        rec = _Record(name, len(self._records), self._open[-1].index if self._open else None,
                      recompute or self._recompute > 0)
        self._records.append(rec)
        self._open.append(rec)
        rec.host_start = time.perf_counter_ns()
        rec.range = torch.profiler.record_function(name)
        rec.range.__enter__()
        if self._cuda:
            rec.ev_start = _event()
        return rec

    def _stop(self, rec: _Record) -> None:
        if self._cuda:
            rec.ev_end = _event()
        rec.range.__exit__(None, None, None)
        rec.range = None
        rec.host_end = time.perf_counter_ns()
        # Backward spans close in autograd's order, which need not be the
        # reverse of their opening.
        self._open.remove(rec)

    def span(self, name: str, backward: str | None = None) -> _Span:
        return _Span(self, name, backward or name + "_bwd")

    def snapshot(self) -> dict:
        """The spans recorded so far, in the order they opened, and the
        counters. Each span: ``name``, ``parent`` (the index of its parent
        in the list, or None), ``recompute``, ``host_start_ns``,
        ``host_end_ns`` (None while open) and, with CUDA, ``device_start_ms``
        and ``device_end_ms`` from the moment the tracer was first entered
        (waits for the device)."""
        if self._cuda and self._records:
            torch.cuda.synchronize()
        spans = []
        for r in self._records:
            s = {"name": r.name, "parent": r.parent, "recompute": r.recompute, "host_start_ns": r.host_start,
                 "host_end_ns": r.host_end}
            if r.ev_start is not None:
                s["device_start_ms"] = self._base.elapsed_time(r.ev_start)
                s["device_end_ms"] = self._base.elapsed_time(r.ev_end) if r.ev_end is not None else None
            spans.append(s)
        return {"spans": spans, "counts": {k: int(v) for k, v in self.counts.items()}}

    def reset(self) -> None:
        """Forget every span and counter."""
        self._records, self._open, self.counts = [], [], {}


class _Pending:
    """A backward span between the hook that opens it and the one that
    closes it."""

    __slots__ = ("tracer", "name", "rec")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name, self.rec = tracer, name, None

    def open(self) -> None:
        self.rec = self.tracer._start(self.name)

    def close(self) -> None:
        if self.rec is not None:
            self.tracer._stop(self.rec)
            self.rec = None


class _OpenBackward(torch.autograd.Function):
    """Identity on a span's outputs; its backward opens the backward span."""

    @staticmethod
    def forward(ctx, pending, *tensors):
        ctx.pending = pending
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.pending.open()
        return (None, *grads)


class _CloseBackward(torch.autograd.Function):
    """Identity on a span's inputs; its backward, which runs once the span's
    part of their gradients is ready, closes the backward span."""

    @staticmethod
    def forward(ctx, pending, *tensors):
        ctx.pending = pending
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.pending.close()
        return (None, *grads)


def _differentiable(t) -> bool:
    return torch.is_tensor(t) and t.requires_grad


class _Span:
    """A forward span of an entered tracer, with the hooks of its backward
    span."""

    __slots__ = ("tracer", "name", "backward", "rec", "pending")

    def __init__(self, tracer: Tracer, name: str, backward: str):
        self.tracer, self.name, self.backward = tracer, name, backward
        self.rec = self.pending = None

    def __enter__(self) -> _Span:
        self.rec = self.tracer._start(self.name)
        return self

    def __exit__(self, *exc) -> None:
        self.tracer._stop(self.rec)

    def grad_in(self, *tensors) -> tuple:
        """``tensors`` (the span's inputs), those that require gradients
        through the hook that closes the backward span: use what it returns
        in their place."""
        if self.tracer._recompute or not torch.is_grad_enabled():
            return tensors
        live = [i for i, t in enumerate(tensors) if _differentiable(t)]
        if not live:
            return tensors
        self.pending = _Pending(self.tracer, self.backward)
        out = list(tensors)
        for i, t in zip(live, _CloseBackward.apply(self.pending, *(tensors[i] for i in live))):
            out[i] = t
        return tuple(out)

    def grad_out(self, out):
        """``out`` (the span's output, a tensor or a tuple of them) through
        the hook that opens the backward span."""
        if self.pending is None:
            return out
        outs = (out,) if torch.is_tensor(out) else tuple(out)
        live = [i for i, t in enumerate(outs) if _differentiable(t)]
        hooked = list(outs)
        for i, t in zip(live, _OpenBackward.apply(self.pending, *(outs[i] for i in live))):
            hooked[i] = t
        return hooked[0] if torch.is_tensor(out) else type(out)(hooked)


class _NullSpan:
    """The span of :func:`span` while no tracer is on."""

    def __enter__(self) -> _NullSpan:
        return self

    def __exit__(self, *exc) -> None:
        return None

    def grad_in(self, *tensors) -> tuple:
        return tensors

    def grad_out(self, out):
        return out


_NULL = _NullSpan()


def span(name: str, backward: str | None = None):
    """A span named ``name`` for a ``with`` block, recorded when a tracer
    is on; ``backward`` names its backward span (default ``name +
    "_bwd"``; see :meth:`_Span.grad_in`)."""
    t = _active
    return _NULL if t is None else t.span(name, backward)


def on() -> bool:
    """Whether a tracer is entered."""
    return _active is not None


def count(name: str, n: int | torch.Tensor = 1) -> None:
    """Add ``n`` to the entered tracer's counter ``name``: an int, or a
    one-element tensor that a kernel fills on the device, read when the
    tracer takes its snapshot."""
    t = _active
    if t is not None:
        t.counts[name] = t.counts.get(name, 0) + n


def launched(kernel: str, n: int = 1) -> None:
    """Count ``n`` launches of ``kernel`` (one of :data:`KERNELS`), also
    into the entered tracer's counter of that name."""
    _launches[kernel] += n
    count(kernel, n)


def kernel_launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset, by kernel."""
    return dict(_launches)


def reset_kernel_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in _launches:
        _launches[k] = 0


def step_graph_ran(how: str) -> None:
    """Count one step of a step graph, ``how`` one of
    :data:`STEP_GRAPH_COUNTS`."""
    _step_graph[how] += 1


def step_graph_counts() -> dict[str, int]:
    """Steps captured (each replayed once as it was captured), replayed
    and run eagerly by the step graphs since the process started."""
    return dict(_step_graph)


def bands(band_fn):
    """``band_fn(y0)`` of :func:`~drtk_tpu_torch.parallel.banded.map_row_bands`
    in a span per run: ``band`` the first time a band runs, and
    ``band_recompute``, with every span inside it marked ``recompute``, when
    the checkpoint runs it again in the backward. ``band_fn`` itself while
    no tracer is on."""
    t = _active
    if t is None:
        return band_fn
    seen = set()

    def run(y0):
        again = y0 in seen
        seen.add(y0)
        rec = t._start("band_recompute" if again else "band", again)
        t._recompute += again
        try:
            return band_fn(y0)
        finally:
            t._recompute -= again
            t._stop(rec)

    return run


def mark(sink: list | None, name: str, grad_of: torch.Tensor | None = None) -> None:
    """Append ``(name, CUDA event)`` to ``sink`` (a ``stage_times`` list):
    recorded now, or, with ``grad_of``, when the gradient of ``grad_of`` is
    computed in a backward pass (if it requires one). Nothing when ``sink``
    is None."""
    if sink is None:
        return
    if grad_of is None:
        sink.append((name, _event()))
    elif grad_of.requires_grad:
        grad_of.register_hook(lambda _grad: sink.append((name, _event())))
