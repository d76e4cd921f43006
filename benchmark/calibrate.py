"""Readings that a cell's correctness limits are set from, many seeds in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 11,12,... --seconds 30 \
        [--controls fp8_reference,w8,int8_full,int8_qk] [--control-seeds 3] [--out calib.jsonl]

For each seed: the program's window as a run has it (``--seconds``), judged
against the reference at the steps a run would draw (the lower readings),
and also at step 0. For the first ``--control-seeds`` seeds, each control
takes step 0 from the same initial noise, judged against the same reference
step (the upper readings): ``fp8_reference``, the reference itself with its
products in float8, or the program with a path of its own in a lower precision
than the configuration states switched on (``int8_qk``, ``int8_full``: int8
attention; ``w8``: W8A8 block linears). One JSON line per (seed, path). Not run
by the benchmark's own runs.
"""

import argparse
import json
import os
import sys
import time

import torch

from benchmark import inputs
from benchmark import manifest as mf
from benchmark.drivers import sample

VARIANTS = ("int8_qk", "int8_full", "w8")
DEVICE = "cuda:0"


def switch_on(pipe, variant: str):
    """The program's own lower-precision path ``variant`` switched on in ``pipe``."""
    from alg_tpu_torch.ops.attention import set_attention_int8

    if variant not in VARIANTS:
        raise ValueError(f"unknown program variant {variant!r}")
    set_attention_int8({"int8_qk": "qk", "int8_full": "full"}.get(variant))
    if variant == "w8":
        from alg_tpu_torch.ops.quant import quantize_transformer_

        pipe.transformer = quantize_transformer_(pipe.transformer, mode="w8")
    return pipe


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--controls", default="")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from alg_tpu_torch.ops.attention import set_attention_int8

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = mf.cell_spec(mf.load_manifest(), args.workload)
    config, traffic, device = spec.config, spec.traffic, DEVICE
    controls = [c for c in args.controls.split(",") if c]
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    kind0 = sample.kind(traffic, 0)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        pipe = sample.build_pipeline(config, seed, device)
        image, prompt, negative = inputs.request(seed, traffic, config["transformer"]["text_embed_dim"], device,
                                                 pipe.dtype)
        noise = inputs.SeededNoise(seed, "noise", device)
        obs, _, outputs, _ = sample.window(pipe, sample.call_kwargs(traffic), args.seconds, noise, image, prompt,
                                           negative, device, trace=False)
        steps = sample.sampled_steps(traffic, len(obs.latents), seed)
        kept = {i: outputs[i] for i in set(steps.values()) | {0}}
        obs.pipe = None
        del pipe, outputs
        torch.cuda.empty_cache()
        ref = sample.Reference(config, traffic, seed, device, noise, image, prompt, negative)
        t0 = time.perf_counter()
        first = step0 = None  # step 0 from the initial noise, shared by the program and the controls
        if 0 in steps.values() or (n < args.control_seeds and controls):
            first = ref.reference(0, ref.latents0)
            step0 = ref.numbers(kind0, torch.from_numpy(obs.latents[0]).to(device), *first[:2], kept[0], first[2])
        numbers = {}
        for i in sorted(set(steps.values())):
            numbers.update(step0 if i == 0 else ref.judge(i, torch.from_numpy(obs.latents[i - 1]).to(device),
                                                          torch.from_numpy(obs.latents[i]), kept[i]))
        emit({"cell": spec.name, "seed": seed, "path": "program", "steps": len(obs.latents), "checked": steps,
              "numbers": numbers, "step0": step0, "check_s": time.perf_counter() - t0,
              "step_s": [b - a for a, b in zip([obs.start] + obs.times[:-1], obs.times)]})
        del kept
        if n < args.control_seeds:
            for variant in controls:
                if variant == "fp8_reference":
                    t0 = time.perf_counter()
                    x_ctrl, _, passes_ctrl = ref.reference(0, ref.latents0, lowp=True)
                    row = {"cell": spec.name, "seed": seed, "path": variant, "seconds": time.perf_counter() - t0,
                           "step0": ref.numbers(kind0, x_ctrl, *first[:2], torch.cat(passes_ctrl), first[2])}
                    emit(row)
                    continue
                pipe = switch_on(sample.build_pipeline(config, seed, device), variant)
                noise_c = inputs.SeededNoise(seed, "noise", device)
                outputs_c = sample.PassOutputs(pipe.transformer)
                obs_c = sample.Observer(pipe, max_steps=1)
                pipe(image=image.cpu().numpy(), prompt_embeds=prompt, negative_prompt_embeds=negative,
                     noise_source=noise_c, output_type="latent", step_observer=obs_c,
                     **sample.call_kwargs(traffic))
                outputs_c.remove()
                obs_c.pipe = None
                del pipe
                set_attention_int8(None)
                emit({"cell": spec.name, "seed": seed, "path": variant, "step0": ref.numbers(
                    kind0, torch.from_numpy(obs_c.latents[0]).to(device), *first[:2], outputs_c.outputs[0],
                    first[2])})
                del outputs_c
                torch.cuda.empty_cache()
        del ref, first
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(mf.ROOT, ".bench_cache", "cuda"))
    sys.exit(main())
