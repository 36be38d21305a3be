"""A training step's forward and backward replayed as one CUDA graph.

A step of the port issues its kernels and eager PyTorch ops one launch at a
time from the host (``avatar4k_step``: ~1,750 device operations a step), and
where the host is the slower of the two the card waits for it.
:class:`StepGraph` captures a step's loss and gradients once, every op and
kernel in the order the eager step issues them, and replays the capture on
each later call: one graph launch a step. Nothing is fused, replaced or
reordered; the graph is the eager step.

A graph replays the same kernels on the same addresses, so it serves only the
same objects in the same state. :class:`StepKey` holds the step's input
tensors by weak reference, each with its address, shape, stride, dtype and
``requires_grad``, beside the step's other arguments (sizes, flags, and the
functions it resolves when it runs, so that a patched one makes a new key).
An address alone would not do: the caching allocator hands a freed tensor's
memory to the next one.

Per :class:`StepGraph`: the first call with a new key runs eagerly (the
warm-up: kernels are built, device constants cached and Adam's state made
outside the capture), on the stream the capture will use; the second
captures and replays once; every later call replays. It holds one graph at a
time: a new key, or the death of any tensor of the key, drops the graph and
with it its memory pool (about one eager step's intermediates). Graphed
calls return clones of the graph's outputs, which the next replay
overwrites.

:func:`eager_reason` is the rule of when a step may take its graph: CUDA
tensors, ``impl="auto"``, no ``stage_times`` marks, no tracer entered, grad
mode on. Otherwise the step runs eagerly, as it always did, so the spans and
marks keep reading the eager step.
"""

from __future__ import annotations

import weakref
from typing import Callable, Sequence

import torch

from drtk_tpu_torch import tracing

__all__ = ["StepGraph", "StepKey", "eager_reason"]


def eager_reason(tensors: Sequence[torch.Tensor], impl: str, stage_times: list | None) -> str | None:
    """Why a step over ``tensors`` must run eagerly ("impl", "stage_times",
    "tracer", "no_grad" or "device", the first that holds), or None when it
    may take its graph."""
    if impl != "auto":
        return "impl"
    if stage_times is not None:
        return "stage_times"
    if tracing.on():
        return "tracer"
    if not torch.is_grad_enabled():
        return "no_grad"
    if not all(t.is_cuda for t in tensors):
        return "device"
    return None


class StepKey:
    """What a step's graph serves: ``tensors`` (held weakly), each one's
    address, shape, stride, dtype and ``requires_grad``, and ``statics``, the
    step's other arguments (compared with ``==``, so functions by identity).
    Two keys are equal when they name the same living tensors, laid out
    alike, and equal statics."""

    __slots__ = ("refs", "layout", "device")
    __hash__ = None

    def __init__(self, tensors: Sequence[torch.Tensor], statics: tuple):
        self.refs = tuple(weakref.ref(t) for t in tensors)
        self.layout = (tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.requires_grad) for t in tensors),
                       statics)
        self.device = tensors[0].device

    def __eq__(self, other) -> bool:
        if not isinstance(other, StepKey) or self.layout != other.layout:
            return False
        return all(a() is not None and a() is b() for a, b in zip(self.refs, other.refs))


class StepGraph:
    """One step's CUDA graph at a time, by :class:`StepKey` (see the module
    docstring)."""

    def __init__(self):
        self._drop()

    def _drop(self, _dead=None) -> None:
        """Forget the key, its stream and its graph (also a weak reference's
        callback: a tensor of the key died)."""
        self._key, self._watch, self._stream, self._graph, self._outs, self._launches = None, [], None, None, (), {}

    def run(self, fn: Callable[[], tuple], key: StepKey | None) -> tuple:
        """``fn()``: the step's tensors (its detached loss and its
        gradients), eagerly when ``key`` is None (:func:`eager_reason`
        gave a reason) or new, else captured or replayed. Each call is one
        step of work; graphed calls return clones, and count the kernel
        launches the capture recorded (:func:`tracing.kernel_launch_counts`
        counts what the card runs)."""
        if key is None:
            tracing.step_graph_ran("step_graph_eager")
            return fn()
        with torch.cuda.device(key.device):
            if key != self._key:
                self._drop()
                self._key, self._stream = key, torch.cuda.Stream()
                self._watch = [weakref.ref(ref(), self._drop) for ref in key.refs]
                tracing.step_graph_ran("step_graph_eager")
                return self._warm_up(fn)
            if self._graph is None:
                self._capture(fn)
                tracing.step_graph_ran("step_graph_captures")
            else:
                self._graph.replay()
                for kernel, n in self._launches.items():
                    tracing.launched(kernel, n)
                tracing.step_graph_ran("step_graph_replays")
            return tuple(t.clone() for t in self._outs)

    def _warm_up(self, fn: Callable[[], tuple]) -> tuple:
        """``fn()`` on the capture's stream, ordered after the work queued
        before it and before the work queued after it."""
        caller = torch.cuda.current_stream()
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            outs = fn()
        caller.wait_stream(self._stream)
        return outs

    def _capture(self, fn: Callable[[], tuple]) -> None:
        """Capture ``fn()`` into a graph with a private memory pool, then
        replay it once on the caller's stream (a capture runs nothing)."""
        before = tracing.kernel_launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream):
            outs = tuple(fn())
        after = tracing.kernel_launch_counts()
        self._launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self._graph, self._outs = graph, outs
        graph.replay()
