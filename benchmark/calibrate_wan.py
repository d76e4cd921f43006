"""Readings that the Wan cell's correctness limits are set from, many seeds in one process.

    python3 -m benchmark.calibrate_wan --seeds 11,12,... --seconds 31 \
        [--controls fp8_reference] [--control-seeds 3] [--out calib.jsonl]

For each seed: the program's window as a run has it (``--seconds``), judged
against the reference at the steps a run would draw (the lower readings).
For the first ``--control-seeds`` seeds also step 0 from the initial noise:
the program's, and the control's (``fp8_reference``: the reference with its
products in float8), both judged against the same reference step (the
upper readings). One JSON line per (seed, path). Not run by the benchmark's
own runs.
"""

import argparse
import json
import os
import sys
import time

import torch

from benchmark import inputs
from benchmark import manifest as mf
from benchmark.drivers import wan
from benchmark.drivers.sample import Reference as SampleReference
from benchmark.drivers.sample import kind, sampled_steps
from benchmark.reference.wan_sampler import UniPCState

CELL = "wan2.1-i2v-14b.alg-81f"
DEVICE = "cuda:0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default=CELL)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--controls", default="")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = mf.cell_spec(mf.load_manifest(), args.workload)
    config, traffic, device = spec.config, spec.traffic, DEVICE
    controls = [c for c in args.controls.split(",") if c]
    if set(controls) - {"fp8_reference"}:
        raise ValueError(f"unknown controls {controls}")
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    kind0 = kind(traffic, 0)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        pipe = wan.build_pipeline(config, seed, device)
        req = wan.request(seed, config, traffic, device, pipe.dtype)
        noise = inputs.SeededNoise(seed, "noise", device)
        obs, _, outputs, _ = wan.window(pipe, wan.call_kwargs(traffic), args.seconds, noise, req, device, trace=False)
        steps = sampled_steps(traffic, len(obs.latents), seed)
        obs.pipe = None
        del pipe
        torch.cuda.empty_cache()
        ref = wan.Reference(config, traffic, seed, device, noise, req)
        t0 = time.perf_counter()
        control = n < args.control_seeds and bool(controls)
        first = ref.reference(0, ref.latents0, UniPCState()) if control else None  # step 0 from the initial noise
        step0 = None if first is None else SampleReference.numbers(
            kind0, torch.from_numpy(obs.latents[0]).to(device), *first[:2], outputs[0], first[2])
        numbers = {}
        for k, i in steps.items():
            numbers.update(step0 if i == 0 and step0 is not None else wan.check(ref, obs, outputs, {k: i}))
        emit({"cell": spec.name, "seed": seed, "path": "program", "steps": len(obs.latents), "checked": steps,
              "numbers": numbers, "step0": step0, "check_s": time.perf_counter() - t0,
              "step_s": [b - a for a, b in zip([obs.start] + obs.times[:-1], obs.times)]})
        if control:
            t0 = time.perf_counter()
            x_ctrl, _, passes_ctrl = ref.reference(0, ref.latents0, UniPCState(), lowp=True)
            emit({"cell": spec.name, "seed": seed, "path": "fp8_reference", "seconds": time.perf_counter() - t0,
                  "step0": SampleReference.numbers(kind0, x_ctrl, *first[:2], torch.cat(passes_ctrl), first[2])})
        del ref, outputs
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(mf.ROOT, ".bench_cache", "cuda"))
    sys.exit(main())
