"""Block-level rematerialisation toggle for training (counterpart of
``alg_tpu/core/remat.py``).

Without it every DiT block's activations stay alive for the backward pass.
Inside a :func:`remat_blocks` context the block loops of the three DiTs run
each block through ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``: the forward keeps only the block's inputs, and the
backward runs the block again, one extra forward's work for activation
memory that does not grow with depth. Sampling never enters the context and
is untouched.

The loss may run the model through ``torch.func.functional_call`` with
substituted parameters (LoRA, a compute-dtype cast). That substitution ends
when the forward returns, before the backward recomputes a block, so
:func:`run_block` captures the block's parameters and buffers as they are
during the forward and substitutes them again in the recomputation.

PyTorch's checkpoint runs the first forward with autograd on (it drops what
that forward saves), so under remat both the forward and the recomputation
of an attention call write the LSE residual.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

_REMAT = False


def remat_enabled() -> bool:
    """True while inside a :func:`remat_blocks` context."""
    return _REMAT


@contextlib.contextmanager
def remat_blocks(enable: bool = True):
    """Checkpoint every DiT block run inside the context."""
    global _REMAT
    prev = _REMAT
    _REMAT = enable
    try:
        yield
    finally:
        _REMAT = prev


def run_block(block: torch.nn.Module, *args, params=None):
    """``block(*args)``, checkpointed when remat is on and a gradient is
    being recorded; ``params`` (name -> tensor) stand in for the block's own
    (a pipeline stage's differentiable copies)."""
    remat = _REMAT and torch.is_grad_enabled()
    if params is None and not remat:
        return block(*args)
    state = {**dict(block.named_parameters()), **dict(block.named_buffers()), **(params or {})}
    call = lambda *a: torch.func.functional_call(block, state, a)  # noqa: E731
    return checkpoint(call, *args, use_reentrant=False) if remat else call(*args)
