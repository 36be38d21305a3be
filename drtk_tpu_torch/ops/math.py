"""Core numeric helpers shared by every op (counterpart of
``drtk_tpu/ops/math.py``).

``epsclamp`` is the library-wide singularity guard: it keeps values away
from zero while preserving sign, with a dtype-dependent epsilon (1e-8 for
float32 and below, 1e-16 for float64).

The collectives of the row-sharded pipeline (``drtk_tpu_torch.parallel.
spmd``) live here too, as ``psum_cotangent`` does in the JAX package:
:func:`psum_cotangent` is the identity forward and an all-reduce of the
gradient over a process group, the sum that shard_map's transpose inserts
at a replicated input in JAX; :func:`next_rank_rows` is the halo transport
of edge_grad's backward, JAX's one-hop ``ppermute``. Both follow the
group's backend as the caller named it: under NCCL they move the card's
tensors; under any other backend (Gloo, which has no send or receive of
CUDA tensors) the halo rows travel through host memory, while the
all-reduce, which Gloo does on CUDA tensors, stays on the card's tensors.
Nothing falls back to the CPU for compute, and a failed collective raises.

JAX's ``vary_like`` has no counterpart: it is a type annotation in JAX's
varying-manual-axes system and does nothing at run time.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from drtk_tpu_torch import tracing

__all__ = ["autocast_f32", "epsclamp", "eps_for_dtype", "next_rank_rows", "psum_cotangent"]


def eps_for_dtype(dtype: torch.dtype) -> float:
    """Epsilon used by :func:`epsclamp`: 1e-16 for float64, else 1e-8."""
    if dtype == torch.float64:
        return 1e-16
    return 1e-8


def epsclamp(x: torch.Tensor) -> torch.Tensor:
    """Clamp ``x`` away from zero, preserving sign.

    ``epsclamp(v) = v < 0 ? min(v, -eps) : max(v, eps)``

    The branch tests ``v < 0``, which is false for negative zero, so both
    ``0.0`` and ``-0.0`` map to ``+eps``. Gradient parity at degenerate
    configurations depends on this asymmetry.
    """
    eps = eps_for_dtype(x.dtype)
    return torch.where(x < 0, torch.clamp(x, max=-eps), torch.clamp(x, min=eps))


def autocast_f32(x):
    """Cast float16/bfloat16 tensors to float32; pass anything else
    (ints, f32/f64, ``None``) through untouched. Half-precision inputs to
    an op therefore compute, and return, float32."""
    if x is not None and x.dtype in (torch.float16, torch.bfloat16):
        return x.to(torch.float32)
    return x


class _PsumCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        with tracing.span("allreduce"):
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
            tracing.count("allreduce_bytes", grad.nbytes)
            return grad, None


def psum_cotangent(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``group`` (one
    ``all_reduce`` per backward). Apply it to an input that every rank of
    ``group`` holds whole while each computes part of the output (the
    vertices of a row-sharded frame): each rank's backward then yields the
    gradient of the whole output (``drtk_tpu/ops/math.py:67-86``)."""
    return _PsumCotangent.apply(x, group)


def next_rank_rows(tensors, fills, group) -> list:
    """Each rank of ``group`` sends ``tensors`` to the rank before it and
    receives the next rank's (one message per tensor, all in one
    ``batch_isend_irecv``); the last rank, which has no next, gets tensors
    of its own shapes filled with ``fills``. Returns the received tensors
    on the devices of ``tensors``. Under NCCL the card's tensors travel;
    under any other backend, copies in host memory."""
    with tracing.span("halo"):
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        on_card = dist.get_backend(group) == "nccl"
        send = [t.contiguous() if on_card else t.detach().cpu().contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in send]
        ops = []
        if rank > 0:
            prev = dist.get_global_rank(group, rank - 1)
            ops += [dist.P2POp(dist.isend, t, prev, group, tag) for tag, t in enumerate(send)]
            tracing.count("halo_bytes", sum(t.nbytes for t in send))
        if rank < size - 1:
            nxt = dist.get_global_rank(group, rank + 1)
            ops += [dist.P2POp(dist.irecv, t, nxt, group, tag) for tag, t in enumerate(recv)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if rank == size - 1:
            return [torch.full_like(t, fill) for t, fill in zip(tensors, fills)]
        return [r.to(t.device) for r, t in zip(recv, tensors)]
