"""Shared pieces of the kernels' autograd wrappers."""

from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """True when autograd is recording and one of ``tensors`` (None allowed) requires a gradient."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def plain_vjp(plain, inputs, needs, grad_out):
    """Gradients of ``plain(*inputs)`` for the inputs flagged in ``needs``
    (None for the others, and for inputs that are None), by autograd on
    detached copies of ``inputs``: the backward of a wrapper whose kernel has
    no backward kernel. ``plain`` may return a tuple, with ``grad_out`` the
    tuple of its outputs' gradients."""
    with torch.enable_grad():
        leaves = [t if t is None else t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        out = plain(*leaves)
        if not isinstance(out, tuple):
            out, grad_out = (out,), (grad_out,)
        pairs = [(o, g) for o, g in zip(out, grad_out) if o.requires_grad]  # outputs that depend on a wanted input
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True))
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in leaves)
