"""Fine-tuning entry point (counterpart of ``alg_tpu/train_cli.py``).

LoRA (default) or full fine-tuning of one of the three DiT families on
latent batches: a directory of per-example ``.npz`` files with the loss's
batch keys (``training/losses.py``, without the batch axis), or
``--synthetic N`` random examples shaped by the model config and the
config's ``generation`` section.

    python -m alg_tpu_torch.train_cli --config configs/cogvideox_alg.yaml --model_cache_dir /path/to/checkpoints --data latents/ --steps 1000 --remat --compute_dtype bfloat16 --output adapters.npz

The DiT comes from the checkpoint directory that ``model.path`` names
(``io/model_zoo.resolve_model_dir`` with ``--model_cache_dir``), loaded alone
in the config's dtype (``io/model_zoo.load_transformer``), or with
``--random_init`` at the published size with random weights from the seed,
made on the device. ``--data`` is what ``prepare_cli`` writes
(``alg-tpu-torch-prepare``). LoRA adapters are saved as a peft-layout
``.npz`` that ``io.lora.merge_lora_*`` and ``cli --lora`` merge; a full
fine-tune saves a path-keyed parameter ``.npz``
(``training.train.load_params_npz``). With ``--checkpoint_dir`` the run
saves its state every ``--save_every`` steps and ``--resume`` continues from
the newest one with the same data order and the same draws.
``--val_frac`` holds out the last examples and logs their loss
(``val_loss``) every ``--eval_every`` steps and at the last;
``--profile_dir`` writes a ``torch.profiler`` trace of the steps after the
first and the program's spans beside it (``utils/profiling.trace_to``).

:func:`run` is the body, callable with an already parsed config (a dict
with ``model`` and ``generation`` sections) and, for tests, an already built
DiT. ``--quantize w8|w4`` (``--mode lora`` only) trains the adapters over
a frozen W8A8 / W4A8 base (QLoRA, ``ops/quant.py``): a loaded or given DiT
is quantized without its modulation linears; with ``--random_init`` each
block is made and quantized before the next, HunyuanVideo's modulation
linears too.

Several GPUs (``--mode full``): one process per GPU under ``torchrun``,
e.g. ``torchrun --nproc_per_node 8 -m alg_tpu_torch.train_cli ... --mode full
--dp 2 --tp 2 --pp 2 --pp_micro 4``. The DiT shards over the ``(dp, pp, 1,
tp)`` mesh (``sharding.partition.shard_transformer``): each rank loads it
on the host and puts only its own shards on its card, where they are
trained in place. Each rank reads the same batches and trains on its dp rows
(``training.train.make_sharded_train_step``; GPipe over pp with
``--pp_micro`` microbatches), and rank 0 writes the whole parameter tree.
With ``--checkpoint_dir`` each rank keeps its shards in ``rank{r}/`` under
it. A launch with several ranks and no mesh flags is data-parallel over all
of them. LoRA runs on one rank: ``--dp/--tp/--pp`` above 1 with ``--mode
lora`` raise (``alg_tpu`` leaves them unused).
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

FAMILIES = ("cogvideox", "wan", "hunyuan")


def family_of(model_path: str) -> str:
    """Model family by substring of ``model.path``, as the JAX package's ``RunConfig.family``."""
    lowered = model_path.lower()
    for family in FAMILIES:
        if family in lowered:
            return family
    raise ValueError(f"Cannot infer model family from path {model_path!r}")


def random_init_transformer(family: str, dtype: torch.dtype, device, seed: int, quantize: Optional[str] = None):
    """The family's DiT at its published size with random weights from ``seed``, made on ``device``. With
    ``quantize`` ("w8" | "w4") each block is made and its linears quantized before the next
    (``ops.quant.random_init_quantized``), HunyuanVideo's modulation linears too, as
    ``alg_tpu/train_cli.py:random_init_pipeline`` does: the bf16 block stacks never exist whole."""
    from alg_tpu_torch.models import layers as L

    if family == "cogvideox":
        from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer as Cls
        from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformerConfig as Cfg
    elif family == "wan":
        from alg_tpu_torch.models.wan.transformer import WanTransformer as Cls, WanTransformerConfig as Cfg
    elif family == "hunyuan":
        from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformer as Cls
        from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformerConfig as Cfg
    else:
        raise ValueError(family)
    gen = torch.Generator(device).manual_seed(seed)
    if quantize is not None:
        from alg_tpu_torch.ops.quant import random_init_quantized

        return random_init_quantized(Cls(Cfg(), device="meta", dtype=dtype), gen, quantize,
                                     modulation=family == "hunyuan")
    return L.init_random_(Cls(Cfg(), device=device, dtype=dtype), gen)


def synth_examples(family: str, tcfg, n: int, gen: dict, seed: int) -> list:
    """Random latent-space examples shaped by the model config and the
    ``generation`` section (VAE factors 8 in space, 4 in time)."""
    height, width = int(gen.get("height") or 32), int(gen.get("width") or 32)
    frames, max_seq = int(gen.get("num_frames") or 5), int(gen.get("max_sequence_length") or 16)
    f, h, w = (frames - 1) // 4 + 1, height // 8, width // 8
    rng = np.random.RandomState(seed)
    c = tcfg.out_channels

    def randn(*shape):
        return rng.randn(*shape).astype(np.float32)

    out = []
    for _ in range(n):
        if family == "cogvideox":
            out.append({"latents": randn(f, c, h, w), "image_latents": randn(f, tcfg.in_channels - c, h, w),
                        "encoder_hidden_states": randn(max_seq, tcfg.text_embed_dim)})
        elif family == "wan":
            ex = {"latents": randn(c, f, h, w), "condition": randn(tcfg.in_channels - c, f, h, w),
                  "encoder_hidden_states": randn(max_seq, tcfg.text_dim)}
            if tcfg.image_dim is not None:
                ex["encoder_hidden_states_image"] = randn(5, tcfg.image_dim)
            out.append(ex)
        else:
            out.append({"latents": randn(c, f, h, w), "image_latents": randn(c, 1, h, w),
                        "encoder_hidden_states": randn(max_seq, tcfg.text_embed_dim),
                        "encoder_attention_mask": np.ones(max_seq, np.int32),
                        "pooled_projections": randn(tcfg.pooled_projection_dim)})
    return out


def build_loss(model, family: str, geom, compute_dtype, shift: Optional[float], guidance_scale: float):
    """The family's loss closed over the rope tables for the data's latent geometry ``(f, h, w)``."""
    from alg_tpu_torch.training import losses

    f, h, w = geom
    if family == "cogvideox":
        cos = sin = None
        if model.cfg.use_rotary_positional_embeddings:
            from alg_tpu_torch.models.cogvideox.transformer import cogvideox_rope

            cos, sin = cogvideox_rope(model.cfg, h * 8, w * 8, f)
        return losses.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin, compute_dtype=compute_dtype)
    if family == "wan":
        from alg_tpu_torch.models.wan.transformer import wan_rope

        cos, sin = wan_rope(model.cfg, f, h, w)
        return losses.make_wan_flow_loss(model, shift=5.0 if shift is None else shift, rope_cos=cos, rope_sin=sin,
                                         compute_dtype=compute_dtype)
    from alg_tpu_torch.models.hunyuan.transformer import hunyuan_rope

    cos, sin = hunyuan_rope(model.cfg, f, h, w)
    return losses.make_hunyuan_flow_loss(model, shift=7.0 if shift is None else shift, guidance_scale=guidance_scale,
                                         rope_cos=cos, rope_sin=sin, compute_dtype=compute_dtype)


def _train_mesh(args):
    """The mesh for a sharded full fine-tune: the flags', or dp over every
    rank of a launch with several; None when the flags ask for no mesh in a
    one-rank launch, and for a LoRA run."""
    import torch.distributed as dist

    from alg_tpu_torch.sharding import make_mesh

    flags = args.dp * args.tp * args.pp > 1 or args.pp_micro is not None
    if args.mode != "full":
        if flags:
            raise ValueError(f"--dp {args.dp} --tp {args.tp} --pp {args.pp} --pp_micro {args.pp_micro}: the mesh "
                             "shards a full fine-tune (--mode full); LoRA runs on one rank")
        return None
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))
    if not (flags or world > 1):
        return None
    dp = args.dp if flags else world
    return make_mesh(dp=dp, tp=args.tp, pp=args.pp, sp=1, device=args.device)


def memory_batches(examples, batch_size: int, steps: int, seed: int, start: int = 0):
    """Shuffled epochs over in-memory examples, stacked into host batches;
    ``start`` skips batches, so a resumed run keeps the data order."""
    rng = np.random.RandomState(seed)
    order: list = []
    for step in range(steps):
        while len(order) < batch_size:
            epoch = list(range(len(examples)))
            rng.shuffle(epoch)
            order.extend(epoch)
        idx, order = order[:batch_size], order[batch_size:]
        if step >= start:
            yield {k: np.stack([examples[i][k] for i in idx]) for k in examples[0]}


def validation_split(n: int, val_frac: float, batch_size: int):
    """``(n_train, held out)``: the last ``max(1, int(n * val_frac))`` of
    ``n`` examples are held out and the first ``n_train`` train; the held-out
    indices are cycled to whole batches of ``batch_size``."""
    n_val = max(1, int(n * val_frac))
    if n_val >= n:
        raise ValueError(f"--val_frac {val_frac} holds out all {n} examples")
    held = list(range(n - n_val, n))
    while len(held) % batch_size:
        held.append(held[len(held) % n_val])
    return n - n_val, held


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="alg_tpu_torch fine-tuning (LoRA or full)")
    p.add_argument("--config", type=str, required=True, help="run-style YAML (model and generation sections)")
    p.add_argument("--model_cache_dir", type=str, default=None, help="where model.path's checkpoint directory lies")
    p.add_argument("--data", type=str, default=None, help="directory of per-example .npz files")
    p.add_argument("--synthetic", type=int, default=0, help="train on N random examples instead of --data")
    p.add_argument("--random_init", action="store_true", help="full-size random weights instead of a checkpoint")
    p.add_argument("--mode", choices=("lora", "full"), default="lora")
    p.add_argument("--quantize", choices=("none", "w8", "w4"), default="none",
                   help="QLoRA: freeze the base DiT as W8A8 / W4A8 and train adapters over it; --mode lora only")
    p.add_argument("--rank", type=int, default=16, help="LoRA rank")
    p.add_argument("--lora_scale", type=float, default=1.0, help="alpha/rank scale")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--accum", type=int, default=1, help="gradient accumulation micro-steps")
    p.add_argument("--remat", action="store_true", help="checkpoint DiT blocks")
    p.add_argument("--compute_dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--shift", type=float, default=None, help="flow-matching timestep shift (default: the family's)")
    p.add_argument("--dp", type=int, default=1, help="data-parallel mesh axis (full mode)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh axis (full mode)")
    p.add_argument("--pp", type=int, default=1, help="pipeline-parallel stages over the DiT blocks (full mode)")
    p.add_argument("--pp_micro", type=int, default=None, help="GPipe microbatches (default: --pp)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--output", type=str, required=True, help=".npz output (peft adapters | parameter tree)")
    p.add_argument("--checkpoint_dir", type=str, default=None, help="save and resume training state here")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--keep", type=int, default=3, help="checkpoints retained (0 = all)")
    p.add_argument("--resume", action="store_true", help="resume from the newest checkpoint in --checkpoint_dir")
    p.add_argument("--ema_decay", type=float, default=0.0, help="EMA decay; the EMA is exported when set")
    p.add_argument("--prefetch", type=int, default=2, help="host-side batch prefetch depth (0 = off)")
    p.add_argument("--val_frac", type=float, default=0.0, help="hold out this fraction of examples for validation")
    p.add_argument("--eval_every", type=int, default=50, help="validation-loss interval in steps (with --val_frac)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="torch.profiler trace of the second to fourth steps, and their spans (spans_*.json), "
                        "written here")
    p.add_argument("--device", type=str, default="cuda")
    return p


def run(config: dict, args, transformer=None, mesh=None) -> dict:
    """Train as ``args`` (a :func:`make_parser` namespace) says over the
    parsed ``config``; ``transformer`` replaces the DiT of the checkpoint
    directory ``model.path`` names (or the random one of ``--random_init``).
    ``mesh`` (``sharding.make_mesh``) shards a full fine-tune over it in
    place of the mesh the flags ask for.
    Returns ``{"losses", "val_losses",
    "trainable", "steps"}``: ``val_losses`` holds the mean validation loss
    of each evaluation.

    Under a mesh the DiT is loaded (or drawn) on the host and only this
    rank's shards go to its card (``sharding.partition.shard_transformer``),
    where the step trains them in place; a given DiT is left as it is."""
    from alg_tpu_torch.core.config import resolve_dtype
    from alg_tpu_torch.io import model_zoo
    from alg_tpu_torch.training import checkpoint as C
    from alg_tpu_torch.training.data import LatentDataset, prefetch, to_device
    from alg_tpu_torch.training.lora import FAMILY_PEFT, init_lora_params, lora_base, make_lora_loss, to_peft_state
    from alg_tpu_torch.training.train import (TrainConfig, make_sharded_train_step, make_train_step, save_params_npz,
                                              shard_batch, tree_leaves)
    from alg_tpu_torch.utils.profiling import trace_to

    quantize = None if args.quantize == "none" else args.quantize
    if quantize is not None and args.mode != "lora":
        make_parser().error("--quantize requires --mode lora (the quantized base is frozen; train adapters)")
    if mesh is None:
        mesh = _train_mesh(args)
    elif args.mode != "full":
        raise ValueError("a mesh shards a full fine-tune (--mode full); LoRA runs on one rank")
    model_cfg, gen_cfg = config.get("model", {}), dict(config.get("generation") or {})
    family = family_of(model_cfg["path"])
    device = torch.device(args.device)
    if transformer is None:
        dtype = resolve_dtype(model_cfg.get("dtype", "bfloat16"))
        made_on = device if mesh is None else torch.device("cpu")  # under a mesh only the shards reach the card
        if args.random_init:
            transformer = random_init_transformer(family, dtype, made_on, args.seed, quantize)
        else:
            model_dir = model_zoo.resolve_model_dir(model_cfg["path"], args.model_cache_dir)
            logger.info("Loading the %s DiT from %s", family, model_dir)
            transformer = model_zoo.load_transformer(model_dir, family, dtype=dtype, quantize=quantize,
                                                     device=made_on)
    elif quantize is not None:  # a given DiT is quantized in place, as a loaded one is
        from alg_tpu_torch.ops.quant import quantize_transformer_

        quantize_transformer_(transformer, mode=quantize)
    transformer = transformer.requires_grad_(False)
    if mesh is None:
        transformer = transformer.to(device)

    dataset = examples = None
    if args.synthetic:
        examples = synth_examples(family, transformer.cfg, args.synthetic, gen_cfg, args.seed)
        first = examples[0]
        n_examples = len(examples)
    elif args.data:
        dataset = LatentDataset(args.data)
        first = dataset.example(0)
        n_examples = len(dataset)
        logger.info("Dataset: %d examples from %s", n_examples, args.data)
    else:
        raise ValueError("one of --data or --synthetic is required")

    # the validation holdout: fixed batches of the last examples
    val_batches = []
    if args.val_frac > 0:
        n_train, held = validation_split(n_examples, args.val_frac, args.batch_size)
        if dataset is not None:
            val_examples = [dataset.example(i) for i in held]
            dataset.files = dataset.files[:n_train]
        else:
            val_examples, examples = [examples[i] for i in held], examples[:n_train]
        for j in range(0, len(val_examples), args.batch_size):
            chunk = val_examples[j:j + args.batch_size]
            val_batches.append(to_device({k: np.stack([ex[k] for ex in chunk]) for k in sorted(chunk[0])}, device))
        logger.info("Validation: %d examples (%d batches)", n_examples - n_train, len(val_batches))

    lat = first["latents"].shape
    geom = (lat[0], lat[2], lat[3]) if family == "cogvideox" else (lat[1], lat[2], lat[3])
    # float32 over a bf16 base casts the base up inside the loss, as JAX's promotion would: PyTorch's linears
    # do not mix dtypes
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    guidance = gen_cfg.get("guidance_scale")
    guidance = 6.0 if guidance is None else float(guidance)
    tc = TrainConfig(learning_rate=args.lr, weight_decay=args.weight_decay, grad_clip=args.grad_clip,
                     accum_steps=args.accum, remat=args.remat)

    if mesh is not None:  # the sharded full fine-tune: this rank's shards, on its card, trained in place
        from alg_tpu_torch.sharding.partition import add_pp, shard_transformer, transformer_specs

        specs = transformer_specs(transformer)
        sharded = shard_transformer(transformer, mesh, specs, copy_all=True)
        transformer = None  # a DiT on the host goes here: the card holds the shards alone
        train_loss = build_loss(sharded, family, geom, compute_dtype, args.shift, guidance)
        trainable = dict(sharded.named_parameters())
        step, opt_state = make_sharded_train_step(train_loss, tc, mesh, trainable, specs, args.pp_micro)
        frozen, specs = (), add_pp(specs) if mesh.size("pp") > 1 else specs
        logger.info("%s DiT, this rank's shards %.2f GiB, sharded full fine-tune over mesh %s", family,
                    sum(t.numel() * t.element_size() for t in trainable.values()) / 2**30, mesh.shape)
    else:
        base = lora_base(transformer)
        logger.info("%s DiT, %.2f GiB, %s mode%s", family,
                    sum(t.numel() * t.element_size() for t in base.values()) / 2**30, args.mode,
                    f" over a {quantize} base (QLoRA)" if quantize else "")
        loss_fn = build_loss(transformer, family, geom, compute_dtype, args.shift, guidance)
        if args.mode == "lora":
            prefixes = FAMILY_PEFT[family][0]
            trainable = init_lora_params(torch.Generator(device).manual_seed(args.seed), base, rank=args.rank,
                                         prefixes=prefixes)
            frozen = (base,)
            train_loss = make_lora_loss(loss_fn, None, scale=args.lora_scale, attach=True)
            logger.info("LoRA: rank %d over %d modules", args.rank, len(trainable))
        else:
            trainable, frozen, train_loss = {name: p.detach().clone() for name, p in base.items()}, (), loss_fn
        step, opt = make_train_step(train_loss, tc)
        for leaf in tree_leaves(trainable):
            leaf.requires_grad_()
        opt_state = opt.init(trainable)

    @torch.no_grad()
    def validation_loss(params) -> float:
        vals = []
        for j, vb in enumerate(val_batches):
            draws = train_loss.draw(vb, torch.Generator(device).manual_seed(10_000 + j))
            if mesh is None:
                vals.append(float(train_loss(params, vb, draws, *frozen)))
            else:  # the global batch's draws, this rank's rows
                vals.append(float(step.loss(params, shard_batch(vb, mesh), shard_batch(draws, mesh))))
        return float(np.mean(vals))

    ema = C.init_ema(trainable) if args.ema_decay else None
    ema_fn = C.make_ema_update(args.ema_decay) if args.ema_decay else None
    start = 0
    ckpt_dir = args.checkpoint_dir
    if ckpt_dir and mesh is not None and mesh.devices.size > 1:
        ckpt_dir = os.path.join(ckpt_dir, f"rank{mesh.rank}")  # each rank's shards
    if args.resume:
        if not ckpt_dir:
            raise ValueError("--resume requires --checkpoint_dir")
        path = C.latest_checkpoint(ckpt_dir)
        if path is not None:
            start, trainable, opt_state, r_ema = C.load_train_state(path, trainable, opt_state, ema)
            ema = r_ema if r_ema is not None else ema
            logger.info("Resumed from %s (step %d)", path, start)

    if dataset is not None:
        batch_iter = dataset.batches(args.batch_size, args.steps, args.seed, start=start)
    else:
        batch_iter = memory_batches(examples, args.batch_size, args.steps, args.seed, start=start)
    batch_iter = prefetch(batch_iter, args.prefetch, device, mesh=mesh) if args.prefetch else (
        to_device(b if mesh is None else shard_batch(b, mesh), device) for b in batch_iter)

    losses, val_losses, t0 = [], [], time.perf_counter()
    with contextlib.ExitStack() as tracing:
        for i, batch in enumerate(batch_iter, start=start):
            if args.profile_dir and i == start + 1:  # the first step warms up
                tracing.enter_context(trace_to(args.profile_dir))
                logger.info("Profiling steps %d-%d to %s", i + 1, min(i + 3, args.steps), args.profile_dir)
            draws = torch.Generator(device).manual_seed(args.seed * 1_000_003 + i)  # a step's draws depend on its index only
            trainable, opt_state, m = step(trainable, opt_state, batch, draws, *frozen)
            if ema_fn is not None:
                ema = ema_fn(ema, trainable)
            if args.profile_dir and (i == start + 3 or i == args.steps - 1):  # closing an unopened stack is a no-op
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                tracing.close()
            losses.append(float(m["loss"]))
            if not np.isfinite(losses[-1]):
                raise RuntimeError(f"non-finite loss at step {i + 1}")
            if val_batches and ((i + 1) % args.eval_every == 0 or i + 1 == args.steps):
                val_losses.append(validation_loss(trainable))
                logger.info("step %d/%d  val_loss %.5f", i + 1, args.steps, val_losses[-1])
            if (i - start) % args.log_every == 0 or i == args.steps - 1:
                logger.info("step %d/%d  loss %.5f  grad_norm %.4f  (%.2f s/step)", i + 1, args.steps, losses[-1],
                            float(m["grad_norm"]), (time.perf_counter() - t0) / (i + 1 - start))
            if ckpt_dir and ((i + 1) % args.save_every == 0 or i + 1 == args.steps):
                os.makedirs(ckpt_dir, exist_ok=True)
                C.save_train_state(C.checkpoint_path(ckpt_dir, i + 1), i + 1, trainable, opt_state, ema)
                C.prune_checkpoints(ckpt_dir, args.keep)

    export = ema if ema is not None else trainable
    if mesh is not None:
        from alg_tpu_torch.sharding.partition import gather_params

        export = gather_params(export, specs, mesh)
        if mesh.rank != 0:  # rank 0 writes the whole tree
            return {"losses": losses, "val_losses": val_losses, "trainable": trainable, "steps": start + len(losses)}
    if args.mode == "lora":
        np.savez(args.output, **to_peft_state(export, FAMILY_PEFT[family][1]))
    else:
        save_params_npz(args.output, export)
    logger.info("Saved %s to %s", "peft adapters" if args.mode == "lora" else "the parameter tree", args.output)
    logger.info("Training complete.")
    return {"losses": losses, "val_losses": val_losses, "trainable": trainable, "steps": start + len(losses)}


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s", stream=sys.stdout)
    args = make_parser().parse_args(argv)
    import yaml

    with open(args.config, "r") as f:
        config = yaml.safe_load(f)
    run(config, args)


if __name__ == "__main__":
    main()
