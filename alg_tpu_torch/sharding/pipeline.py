"""Pipeline parallelism: GPipe over the DiTs' block lists (counterpart of
``alg_tpu/sharding/pipeline.py``).

The models route their block loops through :func:`run_blocks`. Outside a
:func:`pipeline_blocks` context (or on a mesh whose pp axis is 1) that is
the plain loop, each block through ``core.remat.run_block``. Inside one,
stage ``s`` of ``pp`` runs its ``L / pp`` consecutive blocks (a DiT from
``partition.shard_transformer`` holds only those) in a GPipe schedule:
``n_micro`` microbatches split the batch, stage 0 feeds them, each stage
receives a microbatch's activations from the previous stage and sends its
result on (``send``/``recv`` over the pp group), and the last stage's
outputs are broadcast back over pp, so that the compute around the blocks
(embeddings, the head, the loss) runs on every stage, as ``alg_tpu``'s SPMD
body does.

The backward is GPipe's: each stage keeps the graph of every microbatch it
ran, and in reverse microbatch order takes the gradient of its outputs (from
the next stage, or on the last stage from the loss), runs its graph
backward, and sends the gradient of its inputs to the previous stage.
:class:`_GPipe` returns the gradients of the carry (stage 0's; zero
elsewhere), of the per-sample conditioning ``ctx`` and of the stage's block
parameters. ``ctx`` (the time embedding, Wan's and Hunyuan's text streams)
feeds every stage, so the gradients of the parameters outside the blocks
are partial on each stage; ``training.train.make_sharded_train_step``
counts the loss once (on the last stage) and sums those gradients over pp.

Protocol: ``carry`` is a tuple of batch-leading tensors that the blocks
map to a tuple of the same shapes; ``ctx`` a tuple of batch-leading tensors
(or None) every block reads; ``consts`` batch-free arguments (RoPE tables,
lengths). A block is called as ``block(*carry, *ctx, *consts)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from alg_tpu_torch.core.remat import run_block

_ACTIVE: Optional["_PPContext"] = None


@dataclasses.dataclass(frozen=True)
class _PPContext:
    mesh: Any
    n_micro: Optional[int]


@contextlib.contextmanager
def pipeline_blocks(mesh, n_micro: Optional[int] = None):
    """Run every :func:`run_blocks` inside as a GPipe pipeline over
    ``mesh``'s pp axis with ``n_micro`` microbatches (default: the pp
    degree)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = _PPContext(mesh, n_micro)
    try:
        yield
    finally:
        _ACTIVE = prev


def _tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def run_blocks(blocks, carry: tuple, ctx: tuple = (), consts: tuple = ()) -> tuple:
    """Apply ``blocks`` in order to ``carry`` (see the module docstring);
    returns the carry tuple."""
    active = _ACTIVE
    if active is None or active.mesh.size("pp") == 1:
        for blk in blocks:
            carry = _tuple(run_block(blk, *carry, *ctx, *consts))
        return carry
    return _Schedule(blocks, carry, ctx, consts, active).run()


class _Schedule:
    def __init__(self, blocks, carry, ctx, consts, active: _PPContext):
        mesh = active.mesh
        self.pp, self.stage = mesh.size("pp"), mesh.local_rank("pp")
        self.group, self.ranks = mesh.group("pp"), mesh.group_ranks("pp")
        self.n_micro = active.n_micro or self.pp
        blocks = list(blocks)
        if len(blocks) % self.pp:
            raise ValueError(f"num_layers={len(blocks)} not divisible by pp={self.pp}")
        batches = {t.shape[0] for t in carry + ctx if t is not None}
        if len(batches) != 1:
            raise ValueError(f"carry/ctx leaves disagree on batch axis: {batches}")
        (batch,) = batches
        if batch % self.n_micro:
            raise ValueError(f"batch={batch} not divisible by n_micro={self.n_micro}")
        per = len(blocks) // self.pp
        self.blocks = blocks[self.stage * per:(self.stage + 1) * per]
        if any(type(b).__name__ == "RemoteBlock" for b in self.blocks):
            raise ValueError("the model's blocks are staged for another pipeline layout")
        self.carry, self.ctx, self.consts = carry, ctx, consts

    # -- point to point -------------------------------------------------------

    def _send(self, tensors, to: int) -> None:
        for t in tensors:
            dist.send(t.detach().contiguous(), self.ranks[to], group=self.group)

    def _recv(self, like, frm: int) -> tuple:
        out = tuple(torch.empty_like(t) for t in like)
        for t in out:
            dist.recv(t, self.ranks[frm], group=self.group)
        return out

    # -- the schedule ---------------------------------------------------------

    def _micro(self, tensors, m: int) -> tuple:
        return tuple(None if t is None else t.chunk(self.n_micro)[m] for t in tensors)

    def _stage(self, x: tuple, cx: tuple, params) -> tuple:
        for blk, p in zip(self.blocks, params):
            x = _tuple(run_block(blk, *x, *cx, *self.consts, params=p))
        return x

    def forward(self, carry, ctx, params, record: bool):
        """Run the microbatches through this stage; returns the outputs (on
        every stage) and, with ``record``, each microbatch's graph."""
        last = self.pp - 1
        outs, records = [], []
        for m in range(self.n_micro):
            x = self._micro(carry, m) if self.stage == 0 else self._recv(self._micro(carry, m), self.stage - 1)
            cx = self._micro(ctx, m)
            if record:
                with torch.enable_grad():
                    x = tuple(t.detach().requires_grad_(t.is_floating_point()) for t in x)
                    cx = tuple(None if c is None else c.detach().requires_grad_(c.requires_grad) for c in cx)
                    y = self._stage(x, cx, params)
                records.append((x, cx, y))
            else:
                y = self._stage(x, cx, params)
            if self.stage < last:
                self._send(y, self.stage + 1)
            outs.append(tuple(t.detach() for t in y))
        if self.stage == last:
            out = tuple(torch.cat(parts) for parts in zip(*outs))
        else:
            out = tuple(torch.empty_like(t) for t in carry)
        for t in out:  # the last stage's result, on every stage
            dist.broadcast(t, self.ranks[last], group=self.group)
        return out, records

    def backward(self, records, grads, params):
        last = self.pp - 1
        flat = [p for d in params for p in d.values()]
        g_params = [torch.zeros_like(p) for p in flat]
        g_carry = [[] for _ in self.carry]
        g_ctx = [[] for _ in self.ctx]
        grads = tuple(torch.zeros_like(t) if g is None else g for g, t in zip(grads, self.carry))
        for m in reversed(range(self.n_micro)):
            x, cx, y = records[m]
            gy = self._micro(grads, m) if self.stage == last else self._recv(y, self.stage + 1)
            pairs = [(o, g) for o, g in zip(y, gy) if o.requires_grad]
            inputs = list(x) + [c for c in cx if c is not None and c.requires_grad] + flat
            wanted = [t for t in inputs if t.requires_grad]
            res = (torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True)
                   if pairs and wanted else [None] * len(wanted))
            got = {id(t): g for t, g in zip(wanted, res)}
            gx = tuple(torch.zeros_like(t) if got.get(id(t)) is None else got[id(t)] for t in x)
            if self.stage > 0:
                self._send(gx, self.stage - 1)
            for i, t in enumerate(x):
                g_carry[i].insert(0, gx[i] if self.stage == 0 else torch.zeros_like(t))
            for i, c in enumerate(cx):
                g = None if c is None else got.get(id(c))
                g_ctx[i].insert(0, None if c is None else (torch.zeros_like(c) if g is None else g))
            for i, p in enumerate(flat):
                if got.get(id(p)) is not None:
                    g_params[i] += got[id(p)]
        cat = lambda parts: None if parts[0] is None else torch.cat(parts)  # noqa: E731
        return [cat(p) for p in g_carry], [cat(p) for p in g_ctx], g_params

    def run(self) -> tuple:
        params = [{n: p for n, p in blk.named_parameters()} for blk in self.blocks]
        trainable = [p for d in params for p in d.values() if p.requires_grad]
        inputs = [t for t in self.carry + self.ctx if t is not None]
        if not (torch.is_grad_enabled() and any(t.requires_grad for t in inputs + trainable)):
            return self.forward(self.carry, self.ctx, [None] * len(self.blocks), record=False)[0]
        leaves = [{n: p.detach().requires_grad_(p.requires_grad) for n, p in d.items()} for d in params]
        ctx_t = [c for c in self.ctx if c is not None]
        flat = [p for d in params for p in d.values()]
        return _GPipe.apply(self, leaves, len(self.carry), len(ctx_t), *self.carry, *ctx_t, *flat)


class _GPipe(torch.autograd.Function):
    """The pipeline as one autograd node: forward runs the schedule and keeps
    each microbatch's graph; backward runs GPipe's reverse schedule."""

    @staticmethod
    def forward(fctx, sched: _Schedule, leaves, n_carry: int, n_ctx: int, *tensors):
        carry = tensors[:n_carry]
        ctx_it = iter(tensors[n_carry:n_carry + n_ctx])
        ctx = tuple(None if c is None else next(ctx_it) for c in sched.ctx)
        out, records = sched.forward(carry, ctx, leaves, record=True)
        fctx.sched, fctx.leaves, fctx.records, fctx.counts = sched, leaves, records, (n_carry, n_ctx)
        return out

    @staticmethod
    def backward(fctx, *grads):
        sched = fctx.sched
        g_carry, g_ctx, g_params = sched.backward(fctx.records, grads, fctx.leaves)
        fctx.records = None
        out = [*g_carry, *[g for c, g in zip(sched.ctx, g_ctx) if c is not None], *g_params]
        return (None, None, None, None, *[g if need else None for g, need in zip(out, fctx.needs_input_grad[4:])])
