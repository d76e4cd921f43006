"""The train step (counterpart of ``alg_tpu/training/train.py``): value and
gradient of the loss, micro-batch gradient accumulation, global-norm clip,
AdamW, block rematerialisation.

Trainable parameters are a tree: nested dicts whose leaves are tensors (the
LoRA adapters, or a DiT's ``named_parameters()`` dict for a full fine-tune).
The optimizer is written out, not ``torch.optim``: the clip and AdamW repeat
``optax.clip_by_global_norm`` and ``optax.adamw`` operation for operation
(unchanged below the bound, else ``g / ‖g‖ · c``; bias-corrected moments,
``eps`` outside the root, decay decoupled and times the learning rate), so
that steps agree with the JAX package's to fp32 rounding, and its state is a
tree that ``training.checkpoint`` saves.

Where the JAX step takes a PRNG key, this one takes a ``torch.Generator``
and draws through ``loss_fn.draw`` (one draw per micro-batch), or takes the
draws themselves: a dict, or one dict per micro-batch.

The step updates parameters and optimizer moments in place, so a full
fine-tune holds no second copy of the weights; it returns the same trees.

:func:`make_sharded_train_step` is the mesh-sharded and pipelined step
(``alg_tpu/training/train.py:make_sharded_train_step``): each rank holds
its tp shards (and under pp its stage's blocks) of the parameters and of the
AdamW moments, takes its dp rows of the batch, and the gradients are
reduced across ranks before the clip and AdamW run on the local shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from alg_tpu_torch.core.remat import remat_blocks


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0  # global-norm clip; <= 0 disables
    accum_steps: int = 1  # micro-batch gradient accumulation factor
    remat: bool = False  # checkpoint DiT block bodies


# -- trees: nested dicts with tensor leaves, walked in sorted key order --------


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_leaves_with_path(tree, prefix: str = "") -> list:
    """[("a/b/c", leaf)] in the order of :func:`tree_leaves`."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in tree_leaves_with_path(tree[key], f"{prefix}{key}/")]
    return [(prefix[:-1], tree)]


def tree_unflatten(like, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}  # keep the template's key order
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    return tree_unflatten(tree, [fn(*leaves) for leaves in zip(tree_leaves(tree), *map(tree_leaves, rest))])


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in tree_leaves(tree)))


# -- optimizer ----------------------------------------------------------------


class Optimizer:
    """Global-norm clip, then AdamW. ``init(params)`` gives the state
    ``{"count", "mu", "nu"}``; ``update(grads, state, params)`` the updates
    to add to the parameters and the new state (moments updated in place)."""

    def __init__(self, tc: TrainConfig):
        self.tc = tc

    def init(self, params):
        zeros = tree_map(torch.zeros_like, params)
        return {"count": torch.zeros((), dtype=torch.int32), "mu": zeros, "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads, state, params, g_norm=None):
        """``g_norm``: the global norm of the gradients when they are shards
        of a larger tree (computed here from ``grads`` when None)."""
        tc = self.tc
        if tc.grad_clip and tc.grad_clip > 0:
            g_norm = global_norm(grads) if g_norm is None else g_norm
            if not bool(g_norm < tc.grad_clip):
                grads = tree_map(lambda g: (g / g_norm.to(g.dtype)) * tc.grad_clip, grads)
        count = state["count"] + 1
        # the corrections in fp32, as optax takes 1 - decay**count
        c1, c2 = (float(np.float32(1) - np.float32(decay) ** np.float32(int(count))) for decay in (tc.b1, tc.b2))

        def one(g, mu, nu, p):
            mu.mul_(tc.b1).add_(g, alpha=1.0 - tc.b1)
            nu.mul_(tc.b2).add_(g * g, alpha=1.0 - tc.b2)
            step = (mu / c1) / (torch.sqrt(nu / c2) + tc.eps)
            return -tc.learning_rate * (step + tc.weight_decay * p)

        updates = tree_map(one, grads, state["mu"], state["nu"], params)
        return updates, {"count": count, "mu": state["mu"], "nu": state["nu"]}


def make_optimizer(tc: TrainConfig) -> Optimizer:
    return Optimizer(tc)


# -- the step -----------------------------------------------------------------


def make_train_step(loss_fn: Callable, tc: TrainConfig):
    """``(train_step, optimizer)`` from ``loss_fn(params, batch, draws)``.

    ``train_step(params, opt_state, batch, key, *frozen) -> (params,
    opt_state, {"loss", "grad_norm"})``. ``key`` is a ``torch.Generator``
    (the draws then come from ``loss_fn.draw(micro_batch, key)``) or the
    draws themselves. With ``accum_steps > 1`` the batch's leading axis must
    divide by it; micro-batches run one after another, each with its own
    draw, and the applied gradient is their mean. Positional arguments after
    ``key`` (a frozen base) pass through to the loss untouched."""
    opt = make_optimizer(tc)

    def run_loss(params, batch, draws, *frozen):
        with remat_blocks(tc.remat):
            return loss_fn(params, batch, draws, *frozen)

    def value_and_grad(params, batch, draws, *frozen):
        leaves = tree_leaves(params)
        if not all(leaf.requires_grad for leaf in leaves):
            raise ValueError("every trainable leaf must require a gradient")
        loss = run_loss(params, batch, draws, *frozen)
        return loss.detach(), tree_unflatten(params, torch.autograd.grad(loss, leaves))

    def draws_for(micro, key, i, n):
        if isinstance(key, torch.Generator):
            return loss_fn.draw(micro, key)
        if n == 1:
            return key
        if isinstance(key, dict) or len(key) != n:
            raise ValueError(f"accum_steps={n} takes a generator or {n} draws, one per micro-batch")
        return key[i]

    def value_and_grads(params, batch, key, *frozen):
        n = tc.accum_steps
        if n == 1:
            return value_and_grad(params, batch, draws_for(batch, key, 0, 1), *frozen)
        for name, x in batch.items():
            if x.shape[0] % n:
                raise ValueError(f"batch axis {x.shape[0]} of {name!r} not divisible by accum_steps={n}")
        loss_acc, g_acc = None, None
        for i in range(n):
            micro = {name: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i] for name, x in batch.items()}
            loss, grads = value_and_grad(params, micro, draws_for(micro, key, i, n), *frozen)
            loss_acc = loss if loss_acc is None else loss_acc + loss
            g_acc = grads if g_acc is None else tree_map(torch.add, g_acc, grads)
        inv = 1.0 / n
        return loss_acc * inv, tree_map(lambda g: g * inv, g_acc)

    def train_step(params, opt_state, batch, key, *frozen):
        loss, grads = value_and_grads(params, batch, key, *frozen)
        updates, opt_state = opt.update(grads, opt_state, params)
        with torch.no_grad():
            for p, u in zip(tree_leaves(params), tree_leaves(updates)):
                p.add_(u.to(p.dtype))
        return params, opt_state, {"loss": loss, "grad_norm": global_norm(grads)}

    return train_step, opt


# -- the mesh-sharded step ----------------------------------------------------


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's dp rows of a batch (numpy arrays or tensors, every rank
    passing the same global batch); the leading axis must divide by dp."""
    dp, r = mesh.size("dp"), mesh.local_rank("dp")
    out = {}
    for name, x in batch.items():
        if x.shape[0] % dp:
            raise ValueError(f"batch axis {x.shape[0]} of {name!r} not divisible by dp={dp}")
        n = x.shape[0] // dp
        out[name] = x[r * n:(r + 1) * n]
    return out


def _global_draws(loss_fn, batch: dict, key, dp: int):
    """The draws of the global batch (``dp`` times the local one) from a
    generator in the same state on every rank, or the global draws given."""
    if not isinstance(key, torch.Generator):
        return key
    proxy = {name: x.new_empty((x.shape[0] * dp,) + tuple(x.shape[1:])) for name, x in batch.items()}
    return loss_fn.draw(proxy, key)


def make_sharded_train_step(loss_fn: Callable, tc: TrainConfig, mesh, params, specs, pp_micro=None):
    """``(train_step, opt_state)`` for a full fine-tune over ``mesh``.

    ``params`` are this rank's shards, by name: the parameters of the DiT
    that ``partition.shard_transformer`` built over the same mesh (trained
    in place, so no second copy of the weights exists), or
    ``partition.shard_params`` of a whole tree. ``specs`` are the whole
    tree's partition specs (``sharding.partition``), and ``loss_fn``'s model
    must be that sharded DiT. The step ``train_step(params, opt_state,
    batch, key) -> (params, opt_state, {"loss", "grad_norm"})`` takes this
    rank's dp rows of the batch (:func:`shard_batch`) and a generator in the
    same state on every rank (or the global batch's draws): the global
    batch's draws are taken and this rank's rows kept, so the step is the
    unsharded step's (at ``accum_steps`` 1 exactly; with accumulation each
    rank splits its own rows). With a pp axis the loss runs inside
    ``pipeline.pipeline_blocks(mesh, pp_micro)``.

    Gradients: the loss is counted on the last pp stage only and the
    gradients of the parameters outside the blocks are summed over pp (the
    pipeline's context feeds every stage); then every gradient is averaged
    over dp; the per-head q/k norms' gradients, partial on each tp rank, are
    summed over tp first. The clip uses the norm of the whole tree (tp shards and stages
    summed, replicated leaves counted once) and AdamW runs on the local
    shards, so its moments keep their layout."""
    from alg_tpu_torch.sharding import collectives as C
    from alg_tpu_torch.sharding.partition import add_pp, partial_over_tp
    from alg_tpu_torch.sharding.pipeline import pipeline_blocks

    pp, dp = mesh.size("pp"), mesh.size("dp")
    if pp > 1:
        specs = add_pp(specs)
    for leaf in params.values():
        leaf.requires_grad_()
    opt = make_optimizer(tc)
    opt_state = opt.init(params)
    staged = {name: specs[name][:1] == ("pp",) for name in params}
    split = {name: "tp" in specs[name] or any(not isinstance(s, (str, type(None))) for s in specs[name])
             for name in params}
    names = list(tree_leaves_with_path(params))
    per_head = partial_over_tp(specs)
    count_loss = 1.0 if pp == 1 or mesh.local_rank("pp") == pp - 1 else 0.0

    def run_loss(p, batch, draws):
        with remat_blocks(tc.remat), (pipeline_blocks(mesh, pp_micro) if pp > 1 else contextlib.nullcontext()):
            return loss_fn(p, batch, draws)

    def micro_grads(p, batch, draws):
        leaves = tree_leaves(p)
        loss = run_loss(p, batch, draws)
        grads = torch.autograd.grad(loss * count_loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]

    def norm(grads) -> torch.Tensor:
        if mesh.size("tp") == 1 and pp == 1:  # every leaf whole here: the unsharded step's sum, in its order
            return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        sums = {}
        for (name, _), g in zip(names, grads):
            key = (split[name], staged[name])
            sums[key] = sums.get(key, 0.0) + torch.sum(g.float() ** 2)
        total = torch.zeros((), device=mesh.device)
        for (is_split, is_staged), v in sums.items():
            v = torch.as_tensor(v, dtype=torch.float32, device=mesh.device).clone()
            if is_split:
                C.all_reduce_(v, mesh.group("tp"))
            if is_staged:
                C.all_reduce_(v, mesh.group("pp"))
            total = total + v
        return torch.sqrt(total)

    def train_step(p, opt_state, batch, key):
        n = tc.accum_steps
        draws_all = _global_draws(loss_fn, batch, key, dp) if n == 1 else None
        loss_acc, g_acc = None, None
        for i in range(n):
            if n == 1:
                micro, draws = batch, shard_batch(draws_all, mesh)
            else:
                micro = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i] for k, x in batch.items()}
                draws = shard_batch(_global_draws(loss_fn, micro, key if isinstance(key, torch.Generator)
                                                  else key[i], dp), mesh)
            loss, grads = micro_grads(p, micro, draws)
            loss_acc = loss if loss_acc is None else loss_acc + loss
            g_acc = grads if g_acc is None else [a + g for a, g in zip(g_acc, grads)]
        loss = (loss_acc / n).clone()
        with torch.no_grad():
            grads = [g / n for g in g_acc]
            for (name, _), g in zip(names, grads):
                if name in per_head:
                    C.all_reduce_(g, mesh.group("tp"))
                if pp > 1 and not staged[name]:
                    C.all_reduce_(g, mesh.group("pp"))
                if dp > 1:
                    C.all_reduce_(g, mesh.group("dp"))
                    g /= dp
            if dp > 1:
                C.all_reduce_(loss, mesh.group("dp"))
                loss /= dp
        g_tree = tree_unflatten(p, grads)
        g_norm = norm(grads)
        updates, opt_state = opt.update(g_tree, opt_state, p, g_norm=g_norm)
        with torch.no_grad():
            for x, u in zip(tree_leaves(p), tree_leaves(updates)):
                x.add_(u.to(x.dtype))
        return p, opt_state, {"loss": loss, "grad_norm": g_norm}

    train_step.loss = lambda p, batch, draws: _mean_over_dp(run_loss(p, batch, draws).detach(), mesh)
    return train_step, opt_state


def _mean_over_dp(loss: torch.Tensor, mesh) -> torch.Tensor:
    from alg_tpu_torch.sharding import collectives as C

    loss = loss.clone()
    C.all_reduce_(loss, mesh.group("dp"))
    return loss / mesh.size("dp")


# -- parameter files ----------------------------------------------------------


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()  # numpy has no bf16; fp32 holds it exactly


def save_params_npz(path: str, params) -> None:
    """Save a parameter tree as a path-keyed ``.npz`` (keys ``a/b/c``)."""
    np.savez(path, **{key: to_numpy(leaf) for key, leaf in tree_leaves_with_path(params)})


def load_params_npz(path: str, like):
    """Load a :func:`save_params_npz` file into the structure, dtypes and
    devices of ``like``; the leaves require a gradient where ``like``'s do."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    out = []
    for key, leaf in tree_leaves_with_path(like):
        arr = data.pop(key)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: saved {arr.shape} != expected {tuple(leaf.shape)}")
        out.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype).requires_grad_(leaf.requires_grad))
    if data:
        raise ValueError(f"unconsumed tensors in {path}: {sorted(data)[:5]}")
    return tree_unflatten(like, out)
