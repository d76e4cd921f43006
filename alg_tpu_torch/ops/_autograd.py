"""Shared pieces of the kernels' autograd wrappers."""

from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """True when autograd is recording and one of ``tensors`` (None allowed) requires a gradient."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def plain_vjp(plain, inputs, needs, grad_out):
    """Gradients of ``plain(*inputs)`` for the inputs flagged in ``needs``
    (None for the others), by autograd on detached copies of ``inputs``:
    the backward of a wrapper whose kernel has no backward kernel."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(plain(*leaves), wanted, grad_out))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)
