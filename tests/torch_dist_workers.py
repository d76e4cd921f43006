"""Ranks for the port's multi-device tests: gloo processes on the CPU.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``
(a fork server that imports PyTorch and the port once and forks the ranks
of every test), each on one PyTorch thread, joined into a gloo process group
over a ``file://`` store in the test's temporary directory (parallel test
workers never race for a port), runs one of the functions below in each and
returns every rank's result. Imports neither JAX nor the JAX package: the
tests build the JAX references in the parent and pass numpy trees and the
port's configs here."""

import os
import pickle

import numpy as np
import torch


# what the fork server imports once, before it forks the ranks of every later test of the process
_PRELOAD = ["torch", "torch.distributed", "torch.utils.checkpoint", "torch_dist_workers", "alg_tpu_torch.sharding",
            "alg_tpu_torch.training.train", "alg_tpu_torch.training.losses", "alg_tpu_torch.cli", "alg_tpu_torch.serving",
            "alg_tpu_torch.models.cogvideox.transformer", "alg_tpu_torch.models.wan.transformer",
            "alg_tpu_torch.models.hunyuan.transformer"]


class Ranks:
    """``world`` ranks running ``fn(*args)``, started at construction;
    :meth:`results` waits for them. A test starts its ranks first and builds
    its JAX reference while they run."""

    def __init__(self, fn, world: int, tmp_path, *args):
        import torch.multiprocessing as mp

        self.world = world
        os.makedirs(str(tmp_path), exist_ok=True)
        self.out = os.path.join(str(tmp_path), f"ranks_{fn.__name__}_{len(os.listdir(str(tmp_path)))}")
        os.makedirs(self.out)
        store = "file://" + os.path.join(self.out, "store")
        mp.set_forkserver_preload(_PRELOAD)
        self.context = mp.start_processes(_entry, args=(fn, world, store, self.out, args), nprocs=world,
                                          start_method="forkserver", join=False)

    def results(self) -> list:
        """``[fn(*args) on rank r for r in range(world)]``; a rank's exception is raised here."""
        while not self.context.join():
            pass
        results = []
        for r in range(self.world):
            with open(os.path.join(self.out, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def spawn(fn, world: int, tmp_path, *args) -> list:
    """``[fn(*args) on rank r for r in range(world)]``."""
    return Ranks(fn, world, tmp_path, *args).results()


def _entry(rank, fn, world, store, out, args):
    import torch.distributed as dist

    from alg_tpu_torch.sharding.mesh import init_process_group

    torch.set_num_threads(1)
    init_process_group(rank, world, store, "cpu")
    try:
        result = fn(*args)
        with open(os.path.join(out, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


def build(kind: str, cfg, tree, quantize=None):
    """The port's DiT (``kind`` "dit" | "wan_dit" | "hunyuan_dit") from a
    JAX-layout numpy tree, on the CPU in fp32."""
    from alg_tpu_torch.io.jax_params import load_jax_params
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer
    from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformer
    from alg_tpu_torch.models.wan.transformer import WanTransformer

    cls = {"dit": CogVideoXTransformer, "wan_dit": WanTransformer, "hunyuan_dit": HunyuanVideoTransformer}[kind]
    model = load_jax_params(cls(cfg), tree)
    if quantize is not None:
        from alg_tpu_torch.ops.quant import quantize_transformer_

        quantize_transformer_(model, mode=quantize)
    return model


def _dp_rows(x, mesh):
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    n = x.shape[0] // mesh.size("dp")
    return x[mesh.local_rank("dp") * n:(mesh.local_rank("dp") + 1) * n]


def dit_forward(kind, cfg, tree, inputs: dict, dims, seq_mode="gather", n_micro=None, quantize=None,
                batch_keys=()):
    """This rank's dp rows of a sharded DiT forward over a ``dims`` =
    ``(dp, pp, sp, tp)`` mesh, and of the unsharded DiT's forward; ``inputs``
    are numpy keyword arguments, those in ``batch_keys`` split over dp."""
    from alg_tpu_torch.ops.attention import attention_mesh_scope
    from alg_tpu_torch.sharding import make_mesh, pipeline_blocks, shard_transformer

    dp, pp, sp, tp = dims
    mesh = make_mesh(dp=dp, pp=pp, sp=sp, tp=tp, device="cpu")
    whole = build(kind, cfg, tree, quantize)
    model = shard_transformer(whole, mesh)
    kw = {k: (None if v is None else torch.as_tensor(np.asarray(v))) for k, v in inputs.items()}
    kw = {k: _dp_rows(v, mesh) if k in batch_keys else v for k, v in kw.items()}
    with torch.no_grad():
        with attention_mesh_scope(mesh, "sp", seq_mode), pipeline_blocks(mesh, n_micro):
            out = model(**kw)
        ref = whole(**kw)
    return mesh.coords, _np(out), _np(ref)


def attention_calls(q, k, v, dims, seq_mode, cases):
    """Sharded ``ops.attention.attention`` over a ``(dp, pp, sp, tp)`` mesh:
    each rank takes its dp rows and tp heads of q, k and v (numpy, whole).
    ``cases``: a list of (name, keyword arguments, expected warning or
    error text or None). Returns this rank's coordinates and, per case, its
    output slab or the caught message."""
    import warnings

    from alg_tpu_torch.ops.attention import attention, attention_mesh_scope
    from alg_tpu_torch.sharding import make_mesh

    dp, pp, sp, tp = dims
    mesh = make_mesh(dp=dp, pp=pp, sp=sp, tp=tp, device="cpu")

    def local(x):
        x = _dp_rows(torch.as_tensor(np.asarray(x)), mesh)
        h = x.shape[1] // tp
        return x[:, mesh.local_rank("tp") * h:(mesh.local_rank("tp") + 1) * h]

    results = {}
    with attention_mesh_scope(mesh, "sp", seq_mode):
        for name, kw, _ in cases:
            kw = dict(kw)
            qq, kk, vv = (local(kw.pop(n, d)) for n, d in (("q", q), ("k", k), ("v", v)))
            if "kv_len" in kw:
                kw["kv_len"] = _dp_rows(torch.as_tensor(np.asarray(kw["kv_len"])), mesh)
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                try:
                    results[name] = _np(attention(qq, kk, vv, **kw))
                except NotImplementedError as e:
                    results[name] = f"raised: {e}"
            results[name + ":warnings"] = [str(w.message) for w in rec]
    return mesh.coords, results


def mesh_layout(dims):
    """This rank's coordinates and the ranks of its groups; the tp fill-in
    (``make_mesh(dp=...)``, ``cpu_mesh``); a mesh larger than the world's
    message."""
    from alg_tpu_torch.sharding import cpu_mesh, make_mesh

    dp, pp, sp, tp = dims
    mesh = make_mesh(dp=dp, pp=pp, sp=sp, tp=tp, device="cpu")
    too_big = None
    try:
        make_mesh(dp=dp * 2, pp=pp, sp=sp, tp=tp, device="cpu")
    except ValueError as e:
        too_big = str(e)
    return {"coords": mesh.coords, "groups": {a: mesh.group_ranks(a) for a in ("dp", "pp", "sp", "tp")},
            "model": mesh.group_ranks(("pp", "sp", "tp")), "tp_fill": make_mesh(dp=dp, device="cpu").shape,
            "cpu_mesh": cpu_mesh(dp * pp * sp * tp, dp=dp).shape, "too_big": too_big}


def w4_forward(cfg, qtree, inputs, misaligned):
    """A W4A8 CogVideoX DiT, loaded from the JAX package's quantized numpy
    tree ``qtree`` (the same codes and scales), at tp = 4 and unsharded; and
    the refusal to shard the ``misaligned`` (config, float tree) at tp = 4."""
    from alg_tpu_torch.sharding import make_mesh, shard_transformer

    mesh = make_mesh(tp=4, device="cpu")
    model = build("dit", cfg, qtree)
    kw = {k: torch.as_tensor(np.asarray(v)) for k, v in inputs.items()}
    with torch.no_grad():
        ref = model(**kw)
        out = shard_transformer(model, mesh)(**kw)
    try:
        shard_transformer(build("dit", *misaligned, "w4"), mesh)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return mesh.coords, _np(out), _np(ref), refused


def cogvideox_train_steps(cfg, tree, rope, batch, draws, dims, tc, pp_micro=None):
    """Two full fine-tune steps of the CogVideoX DiT over a ``dims`` mesh
    (``training.train.make_sharded_train_step`` on the parameters of
    ``shard_transformer``'s DiT): each rank takes its dp rows of the numpy
    ``batch`` and the global ``draws`` of each step. Returns the metrics,
    the whole parameter tree after the steps, gathered, and whether
    ``shard_transformer`` over the same layout on the ``meta`` device copies
    this rank's shards there and nothing else (``shard_params``' leaves, none
    of them shared with the host's DiT)."""
    from alg_tpu_torch.sharding import make_mesh, shard_transformer
    from alg_tpu_torch.sharding.mesh import Mesh
    from alg_tpu_torch.sharding.partition import add_pp, gather_params, shard_params, transformer_specs
    from alg_tpu_torch.training.losses import make_cogvideox_vpred_loss
    from alg_tpu_torch.training.train import TrainConfig, make_sharded_train_step, shard_batch

    dp, pp, sp, tp = dims
    mesh = make_mesh(dp=dp, pp=pp, sp=sp, tp=tp, device="cpu")
    whole = build("dit", cfg, tree)
    specs = transformer_specs(whole)
    staged = add_pp(specs) if pp > 1 else specs
    want = {n: tuple(t.shape) for n, t in shard_params(dict(whole.named_parameters()), staged, mesh).items()}
    on_meta = dict(shard_transformer(whole, Mesh(dp, pp, sp, tp, "meta")).named_parameters())
    placed = {n: tuple(t.shape) for n, t in on_meta.items()} == want and all(
        t.device.type == "meta" for t in on_meta.values())
    model = shard_transformer(whole, mesh)
    loss_fn = make_cogvideox_vpred_loss(model, rope_cos=rope[0], rope_sin=rope[1])
    local = dict(model.named_parameters())
    step, opt_state = make_sharded_train_step(loss_fn, TrainConfig(**tc), mesh, local, specs, pp_micro)
    local_batch = shard_batch({k: torch.as_tensor(v) for k, v in batch.items()}, mesh)
    metrics = []
    for d in draws:
        local, opt_state, m = step(local, opt_state, local_batch, {k: torch.as_tensor(v) for k, v in d.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    full = gather_params(local, staged, mesh)
    return metrics, _np(full), placed


def serve(config: dict, requests, gen_kwargs: dict, dims, sp_mode):
    """``serving.serve_batch`` of the port's pipeline loaded from the tiny
    checkpoint ``config`` names, over a ``dims`` mesh; the whole batch's
    output on every rank."""
    from alg_tpu_torch.cli import load_pipeline
    from alg_tpu_torch.core.config import run_config_from_dict
    from alg_tpu_torch.serving import serve_batch
    from alg_tpu_torch.sharding import make_mesh

    dp, pp, sp, tp = dims
    mesh = make_mesh(dp=dp, pp=pp, sp=sp, tp=tp, device="cpu")
    pipe = load_pipeline(run_config_from_dict(config), device="cpu")
    with torch.no_grad():
        out = serve_batch(pipe, requests, mesh=mesh, sp_mode=sp_mode, **gen_kwargs)
    return mesh.coords, _np(out)


def serve_multihost(config: dict, requests, gen_kwargs: dict):
    """``sharding.serve_batch_multihost`` with each rank a host of its own
    (no ``LOCAL_WORLD_SIZE``): ``(videos, indices)`` of this host's block."""
    from alg_tpu_torch.cli import load_pipeline
    from alg_tpu_torch.core.config import run_config_from_dict
    from alg_tpu_torch.sharding import local_mesh, local_request_slice, serve_batch_multihost

    pipe = load_pipeline(run_config_from_dict(config), device="cpu")
    mesh = local_mesh(device="cpu")
    videos, indices = serve_batch_multihost(pipe, requests, mesh=mesh, **gen_kwargs)
    return _np(videos), indices, [local_request_slice(n).stop - local_request_slice(n).start for n in (5, 1)]


def decode_spread(z, dims):
    """``vae_tiling.tiled_decode`` of ``z`` with the tiles spread over a
    ``dims`` mesh and one after another, with a toy decoder (x2 nearest
    upsampling of each tile, ``tanh`` of the sum over channels)."""
    from alg_tpu_torch.models.vae_tiling import tiled_decode
    from alg_tpu_torch.sharding import make_mesh

    dp, pp, sp, tp = dims
    mesh = make_mesh(dp=dp, pp=pp, sp=sp, tp=tp, device="cpu")
    calls = []

    def decode(t):
        calls.append(tuple(t.shape))
        up = t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return torch.tanh(up.sum(-1, keepdim=True)).expand(*up.shape[:-1], 3)

    zt = torch.as_tensor(z)
    spread = tiled_decode(decode, zt, 2, tile_latent=8, stride_latent=6, mesh=mesh)
    n = len(calls)
    seq = tiled_decode(decode, zt, 2, tile_latent=8, stride_latent=6)
    return _np(spread), _np(seq), n, len(calls) - n


def cli_run(module: str, argv, env=None, config=None, transformer=None):
    """``alg_tpu_torch.<module>.run`` on this rank with ``argv`` (and the
    environment ``env``): ``serve_cli`` returns (the paths it wrote, the
    frames each ``write_video`` call got), ``train_cli`` its result with the
    written parameter file's tensors."""
    import importlib

    import alg_tpu_torch.io.video as V

    os.environ.update(env or {})
    mod = importlib.import_module(f"alg_tpu_torch.{module}")
    if module == "serve_cli":
        frames = {}
        write = V.write_video

        def record(path, video, fps=8):
            frames[os.path.basename(path)] = np.asarray(video)
            return write(path, video, fps=fps)

        V.write_video = record
        try:
            return mod.run(mod.build_parser().parse_args(argv)), frames
        finally:
            V.write_video = write
    args = mod.make_parser().parse_args(argv)
    out = mod.run(config, args, transformer=transformer)
    saved = None
    if torch.distributed.get_rank() == 0:  # the rank that writes the file
        with np.load(args.output) as z:
            saved = {k: z[k] for k in z.files}
    return {"losses": out["losses"], "steps": out["steps"]}, saved


def train_cli_one_rank(config: dict, argv, transformer):
    """``train_cli`` in a one-rank launch: whether ``--dp 1 --tp 1 --pp 1``
    ask for a mesh, and ``run`` given ``mesh=make_mesh()`` (the sharded
    step, ``transformer`` sharded from the host): its losses and trained
    parameters."""
    from alg_tpu_torch import train_cli
    from alg_tpu_torch.sharding import make_mesh

    args = train_cli.make_parser().parse_args(argv + ["--dp", "1", "--tp", "1", "--pp", "1"])
    unsharded = train_cli._train_mesh(args) is None
    out = train_cli.run(config, args, transformer=transformer, mesh=make_mesh(device="cpu"))
    return unsharded, out["losses"], _np(out["trainable"])


def http_mesh(config: dict, requests, gen_kwargs: dict, dims):
    """The HTTP daemon's batching over a ``dims`` mesh without the HTTP
    front: rank 0's ``BatchingWorker`` takes the requests as one
    micro-batch (padded to dp) and hands it to the other ranks, which run
    ``http_serving.follow`` until it stops. Rank 0 returns the videos and
    the micro-batch sizes; the others the number of micro-batches they ran."""
    from alg_tpu_torch.cli import load_pipeline
    from alg_tpu_torch.core.config import run_config_from_dict
    from alg_tpu_torch.http_serving import BatchingWorker, follow
    from alg_tpu_torch.serving import shard_pipeline
    from alg_tpu_torch.sharding import make_mesh

    dp, pp, sp, tp = dims
    mesh = make_mesh(dp=dp, pp=pp, sp=sp, tp=tp, device="cpu")
    pipe = shard_pipeline(load_pipeline(run_config_from_dict(config), device="cpu"), mesh)
    if mesh.rank != 0:
        return follow(pipe, mesh)
    worker = BatchingWorker(pipe, gen_kwargs, max_batch=len(requests), batch_window=5.0, mesh=mesh)
    pending = [worker.submit(r) for r in requests]
    worker.start()
    for p in pending:
        p.done.wait()
    worker.shutdown()
    worker.join()
    return [p.error for p in pending], _np([p.result for p in pending]), worker.batches
