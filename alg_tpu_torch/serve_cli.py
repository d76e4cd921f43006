"""Batch-serving entry point (counterpart of ``alg_tpu/serve_cli.py``): N
requests through one batched pipeline call, one video file each::

    python -m alg_tpu_torch.serve_cli --config configs/cogvideox_alg.yaml \\
        --requests requests.jsonl --output_dir out/ [--model_cache_dir ...]

(``alg-tpu-torch-serve`` is the same as a console script.) ``requests.jsonl``
holds one JSON object a line::

    {"prompt": "...", "image_path": "a.png", "negative_prompt": "...",
     "seed": 7, "output": "bus.mp4", "last_image_path": "z.png"}

``negative_prompt`` defaults to ``""``, ``seed`` to 42, ``output`` to
``{index:03d}.mp4``; ``last_image_path`` (Wan's FLF2V) is optional. The
generation and ALG keywords come from the YAML config with ``cli.py``'s
merge. With ``--listen PORT`` the process instead stays up as an HTTP daemon
(:mod:`alg_tpu_torch.http_serving`) that micro-batches requests up to
``--max_batch`` within ``--batch_window`` seconds.

HunyuanVideo: the size bucket depends on the image's aspect ratio, but one
batch has one shape, so it comes from the first request's image.

:func:`run` is the body: it also takes an already parsed config and a list
of :class:`~alg_tpu_torch.serving.BatchRequest` whose images are RGB uint8
arrays, for machines without PyYAML or PIL. Everything runs on ``--device``
(``cuda`` unless asked otherwise); ``--quantize w8|w4`` loads the DiT with
W8A8 / W4A8 block linears (``cli.load_pipeline``).

Several GPUs: one process per GPU under ``torchrun``, e.g. ``torchrun
--nproc_per_node 4 -m alg_tpu_torch.serve_cli ... --dp 2 --sp 2
--sp_mode ring``. ``--dp``, ``--sp`` and ``--tp`` (0: the ranks the others
leave) lay out a mesh over the ranks (``sharding.make_mesh``); a launch with
several ranks and none of them fills tp. The DiT shards over it
(``serving.shard_pipeline``), the requests split over dp, and rank 0 writes
the videos. ``--multihost`` serves a contiguous block of the requests on
each host, over a mesh of that host's ranks, with the process group from
``--coordinator host:port``, ``--num_processes`` and ``--process_id`` (or
``torchrun``'s environment); each host's first rank writes its block.
``--listen`` serves HTTP from rank 0 while the other ranks follow its
micro-batches (``http_serving.follow``); it is single-host, as in
``alg_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys

logger = logging.getLogger(__name__)

def load_requests(path):
    """``(requests, output names)`` from a JSONL file; images opened with PIL."""
    from PIL import Image

    from alg_tpu_torch.serving import BatchRequest

    requests, outputs = [], []
    with open(path) as f:
        for idx, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            requests.append(BatchRequest(
                prompt=obj["prompt"],
                image=Image.open(obj["image_path"]).convert("RGB"),
                negative_prompt=obj.get("negative_prompt"),
                seed=int(obj.get("seed", 42)),
                last_image=(Image.open(obj["last_image_path"]).convert("RGB")
                            if obj.get("last_image_path") else None),
            ))
            outputs.append(obj.get("output", f"{idx:03d}.mp4"))
    if not requests:
        raise ValueError(f"no requests found in {path}")
    return requests, outputs


def _mesh(args):
    """``(mesh or None, writes)``: the mesh the flags ask for (with
    ``--multihost``, over this host's ranks, after joining the process
    group) and whether this rank writes the videos."""
    import torch.distributed as dist

    from alg_tpu_torch.sharding import local_mesh, make_mesh, multihost_initialize

    if args.multihost:
        if args.listen is not None:
            raise ValueError("--listen is single-process (front it with a router for multihost)")
        rank, world = multihost_initialize(args.coordinator, args.num_processes, args.process_id, device=args.device)
        logger.info("Multihost: process %d/%d", rank, world)
        mesh = local_mesh(dp=args.dp, sp=args.sp, tp=args.tp or None, device=args.device)
        return mesh, int(mesh.devices.flat[0]) == rank
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))
    if args.dp == 1 and args.sp == 1 and args.tp == 0 and world == 1:
        return None, True
    mesh = make_mesh(dp=args.dp, sp=args.sp, tp=args.tp or None, device=args.device)
    logger.info("Serving on mesh %s", mesh.shape)
    return mesh, mesh.rank == 0


def run(args, config=None, requests=None) -> list:
    """Serve what ``args`` (a :func:`build_parser` namespace) asks for.
    ``config``: the parsed YAML mapping, read from ``args.config`` when None.
    ``requests``: a list of :class:`~alg_tpu_torch.serving.BatchRequest`,
    written as ``{index:03d}.mp4``; read from ``args.requests`` when None.
    Returns the paths written (``write_video`` may change an extension); with
    ``--listen`` serves until interrupted and returns an empty list."""
    from alg_tpu_torch.cli import load_pipeline
    from alg_tpu_torch.core.config import load_run_config, run_config_from_dict
    from alg_tpu_torch.io.video import write_video
    from alg_tpu_torch.ops.attention import get_attention_int8, set_attention_int8
    from alg_tpu_torch.serving import hunyuan_size, serve_batch, shard_pipeline

    cfg = run_config_from_dict(config) if config is not None else load_run_config(args.config)
    logger.info("Using device: %s", args.device)
    if args.listen is None and requests is None:
        if args.requests is None:
            raise ValueError("--requests is required unless --listen is given")
        requests, outputs = load_requests(args.requests)
        logger.info("Loaded %d requests from %s", len(requests), args.requests)
    elif requests is not None:
        outputs = [f"{i:03d}.mp4" for i in range(len(requests))]
    mesh, writes = _mesh(args)
    if args.multihost and requests is not None:
        from alg_tpu_torch.sharding import local_request_slice

        sl = local_request_slice(len(requests))
        requests, outputs = requests[sl], outputs[sl]
        logger.info("Multihost: this host serves requests [%d, %d)", sl.start, sl.stop)
        if not requests:
            logger.info("Multihost: no requests for this host. Run complete.")
            return []
    if mesh is not None and requests is not None and len(requests) % mesh.size("dp"):
        raise ValueError(f"{len(requests)} requests do not lay out on dp={mesh.size('dp')}; the batch size must be "
                         "divisible by dp")
    if args.sp_mode != "gather" and (mesh is None or mesh.size("sp") == 1):
        logger.warning("--sp_mode %s has no effect without --sp > 1", args.sp_mode)

    int8_before = get_attention_int8()
    if args.int8_attn:
        set_attention_int8(args.int8_attn)
    try:
        pipe = load_pipeline(cfg, args.model_cache_dir, quantize=args.quantize, lora=args.lora,
                             lora_scale=args.lora_scale, device=args.device, random_init=args.random_init)
        logger.info("Pipeline loaded successfully.")
        if mesh is not None:
            pipe = shard_pipeline(pipe, mesh, sp_mode=args.sp_mode)
        if args.listen is not None:
            _serve_forever(pipe, cfg, args, mesh)
            return []

        gen_kwargs = dict(cfg.pipeline_kwargs)
        if cfg.family == "hunyuan" and "resolution" in (cfg.video or {}):
            # bucketed from the first request's image; an explicit generation.height / width applies when the
            # config names no video.resolution
            gen_kwargs["height"], gen_kwargs["width"] = hunyuan_size(cfg.video["resolution"], requests[0].image)

        logger.info("Starting batched generation (%d requests)...", len(requests))
        prof = contextlib.nullcontext()
        if args.profile_dir:
            from alg_tpu_torch.utils.profiling import trace_to

            prof = trace_to(args.profile_dir)
            logger.info("Profiling to %s (a Chrome trace)", args.profile_dir)
        with prof:
            videos = serve_batch(pipe, requests, **gen_kwargs)
    finally:
        set_attention_int8(int8_before)

    if not writes:
        return []
    os.makedirs(args.output_dir, exist_ok=True)
    written = []
    for name, frames in zip(outputs, videos):
        written.append(write_video(os.path.join(args.output_dir, name), frames, fps=cfg.video["fps"]))
        logger.info("Saved %s (%d frames)", written[-1], len(frames))
    logger.info("Batch complete: %d videos. Run complete.", len(videos))
    return written


def _serve_forever(pipe, cfg, args, mesh=None) -> None:
    from alg_tpu_torch.http_serving import follow, serve_http

    if mesh is not None and mesh.rank != 0:
        follow(pipe, mesh)  # until rank 0 shuts down
        return
    server = serve_http(pipe, cfg, host=args.host, port=args.listen, max_batch=args.max_batch,
                        batch_window=args.batch_window, mesh=mesh)
    logger.info("Listening on http://%s:%d", *server.server_address[:2])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("Shutting down.")
    finally:
        server.alg_worker.shutdown()
        server.server_close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Batched multi-prompt serving")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--requests", type=str, default=None,
                        help="JSONL: one request object per line (required unless --listen)")
    parser.add_argument("--listen", type=int, default=None, metavar="PORT",
                        help="run a persistent HTTP daemon instead of a one-shot batch: the weights stay on the "
                             "device, requests micro-batch up to --max_batch within --batch_window "
                             "(alg_tpu_torch.http_serving)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--max_batch", type=int, default=1,
                        help="largest micro-batch the daemon runs (each runs at its real size)")
    parser.add_argument("--batch_window", type=float, default=0.2,
                        help="seconds to wait for more requests after the first (daemon mode)")
    parser.add_argument("--output_dir", type=str, default="serve_out")
    parser.add_argument("--model_cache_dir", type=str, default=None)
    parser.add_argument("--quantize", type=str, choices=("w8", "w4"), default=None,
                        help="quantize the DiT blocks at load: W8A8 (w8) or W4A8 int4 storage (w4); "
                             "not with --lora")
    parser.add_argument("--int8_attn", type=str, choices=("qk", "full"), default=None,
                        help="run DiT self-attention through the int8 kernel (qk = int8 QK^T logits, "
                             "full = both attention products in int8)")
    parser.add_argument("--lora", type=str, default=None,
                        help="peft-layout adapter (.npz or .safetensors) merged into the DiT before serving")
    parser.add_argument("--lora_scale", type=float, default=1.0)
    parser.add_argument("--dp", type=int, default=1, help="data-parallel mesh axis (requests)")
    parser.add_argument("--sp", type=int, default=1, help="sequence-parallel mesh axis (DiT tokens in attention)")
    parser.add_argument("--sp_mode", type=str, choices=("gather", "ring", "ulysses"), default="gather",
                        help="sequence-parallel KV strategy: gather = all-gathered KV; ring = ring attention over "
                             "the flash kernel's LSE; ulysses = all-to-all head exchange (needs heads/tp "
                             "divisible by sp)")
    parser.add_argument("--tp", type=int, default=0,
                        help="tensor-parallel mesh axis (0 = the ranks the other axes leave)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace (Chrome format) of the batched generation here, "
                             "and the program's spans beside it (spans_*.json)")
    parser.add_argument("--multihost", action="store_true",
                        help="each host serves a contiguous block of the requests on a mesh of its own ranks")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="process-group address host:port (default: torchrun's environment)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda", help="torch device to run on (cuda unless asked)")
    parser.add_argument("--random_init", action="store_true",
                        help="random weights from a seed at the checkpoint's shapes instead of its tensors "
                             "(configs and tokenizers are still read)")
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s", stream=sys.stdout)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
