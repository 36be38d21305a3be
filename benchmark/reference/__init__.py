"""The plain reference of the benchmark's steps: plain PyTorch, float32
outside the parts that compute in float64, TF32 off. It imports nothing of
the port and takes nothing the port made: it works out the index image,
the barycentrics, the shading, the edge gradient and Adam's state again
from the scene the benchmark made. One module per entry (``inverse8``,
``avatar4k``, ``rows``) holds that entry's loss; this one the optimizer
and the precision of the control."""

from __future__ import annotations

import torch

BETAS, EPS = (0.9, 0.999), 1e-8


def exact(x: torch.Tensor) -> torch.Tensor:
    """The reference's precision: ``x`` as it is."""
    return x


def bfloat16(x: torch.Tensor) -> torch.Tensor:
    """The control's precision: ``x`` rounded to bfloat16, the gradient
    passed straight through."""
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


def adam(loss_fn, params: dict, steps: int, lr: float):
    """``steps`` Adam steps (``betas`` 0.9, 0.999, eps 1e-8, the update of
    ``torch.optim.Adam`` written out) on copies of ``params`` (name ->
    tensor) with the loss ``loss_fn(params)``: a scalar, or a vector of the
    loss's parts by block of rows, which add to it. Returns (the loss of
    each step before its update, as a list of its parts; the first step's
    gradients and each parameter's change after the last step, by
    name)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = {k: t.detach().clone().requires_grad_() for k, t in params.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    s = {k: torch.zeros_like(t) for k, t in p.items()}
    losses, first = [], None
    b1, b2 = BETAS
    for t in range(1, steps + 1):
        loss = loss_fn(p)
        grads = torch.autograd.grad(loss.sum(), list(p.values()), allow_unused=True)
        grads = {k: torch.zeros_like(t) if g is None else g for (k, t), g in zip(p.items(), grads)}
        losses.append([float(x) for x in loss.detach().reshape(-1)])
        del loss
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, g in grads.items():
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (s[k].sqrt() / (1 - b2**t) ** 0.5).add_(EPS)
                p[k].addcdiv_(m[k], denom, value=-lr / (1 - b1**t))
        del grads
    change = {k: (p[k].detach() - params[k].detach()) for k in p}
    return losses, first, change
