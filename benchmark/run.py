"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, one process per run. With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics; with ``--trace 1`` the
window runs under ``torch.profiler`` and the metrics are the cell's per-layer
metrics, with the device's busy and window seconds and a breakdown. The last
line of standard output is the result, one JSON object; the lines before it
say what ran (the card and its power limit, steps and their times, launches
by kernel, peak memory). The last lines of standard error give each number
the correctness check compared, beside its limit.

It exits with a nonzero code and prints no result when it finds no CUDA card
(or fewer than the cell asks for), when a step fails, and when ``jax``,
``jaxlib``, ``flax`` or ``alg_tpu`` is loaded once the window has closed.
"""

import os
import sys
import time

T_PROCESS = time.time()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from benchmark import manifest as mf  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "alg_tpu")
CACHE_DIR = os.path.join(mf.ROOT, ".bench_cache")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_process: float


def forbidden_modules() -> list:
    """Loaded modules of those packages, top-level names compared whole (a ``None`` entry blocks an import)."""
    return sorted(m for m, mod in list(sys.modules.items()) if mod is not None and m.split(".")[0] in FORBIDDEN)


def fixed_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the port's kernel library itself
    is built into ``alg_tpu_torch/_build/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ") or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({type(e).__name__})"


def judge(numbers: dict, limits: dict):
    """(correct, failed count, checks) with every limited number beside its limit."""
    checks, failed = {}, 0
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        failed += not ok
        checks[name] = {"value": value, "limit": limit}
    return failed == 0, failed, checks


def execute(cell: Cell, spec: mf.CellSpec) -> dict:
    """Drive the cell once and assemble the result (without looking for a card).

    The traffic's driver returns ``attempted``, ``numbers`` (what the correctness check compared,
    judged here against the cell's limits), ``memory_peak_bytes``, ``end_to_end`` (each end-to-end
    metric it measured), ``view`` (None, or under ``--trace 1`` what the per-layer readers read,
    with the window's :class:`benchmark.trace.Trace` as ``view.trace``) and ``lines`` (what ran,
    printed before the result)."""
    res = mf.driver(spec.traffic["driver"]).run(cell)
    correct, failed, checks = judge(res["numbers"], spec.limits)
    result = {"correct": correct, "attempted": res["attempted"], "failed": failed, "metrics": {}}
    device = {"platform": "gpu" if cell.device.startswith("cuda") else "cpu",
              "kind": _device_name(cell.device), "count": spec.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if cell.trace:
        view = res["view"]
        for m in spec.per_layer:
            value = mf.metric_reader(m["name"])(view)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = view.trace.busy_s
        device["window_s"] = view.trace.window_s
        result["breakdown"] = {"device_ops": [list(k) for k in view.trace.top_kernels(10)],
                               "idle_gaps": [list(g) for g in view.trace.idle_gaps(10)]}
    else:
        for m in spec.end_to_end:
            if m["name"] in res["end_to_end"]:
                result["metrics"][m["name"]] = {"value": res["end_to_end"][m["name"]], "unit": m["unit"]}
    result["device"] = device
    result["checks"] = checks
    return {"result": result, "run": res}


def _device_name(device: str) -> str:
    import torch

    return torch.cuda.get_device_name(torch.device(device)) if device.startswith("cuda") else "cpu"


def report(out: dict, cell: Cell) -> None:
    print(f"card: {card_line()}")
    print(f"cell {cell.name}: seed {cell.seed}")
    for line in out["run"]["lines"]:
        print(line)
    for name, c in out["result"]["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_cache_dirs()
    spec = mf.cell_spec(mf.load_manifest(), args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"no CUDA card, or fewer than the {spec.chips} cell {spec.name} asks for: nothing measured",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = Cell(name=spec.name, config=spec.config, traffic=spec.traffic, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), device="cuda:0", t_process=T_PROCESS)
    out = execute(cell, spec)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    report(out, cell)
    sys.stdout.flush()
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
