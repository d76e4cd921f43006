#!/usr/bin/env python3
"""Time tile variants of the fp32 CUDA-core attention kernels on one GPU.

Each variant is a copy of ``alg_tpu_torch`` under a scratch directory with
lines of ``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu`` or
``csrc/flash_simt.cuh`` replaced (the other kernel sources are left out, so
each copy builds only the two fp32 units). Each copy is built by the port's
own ``ops/_build.py`` and timed in a process of its own with
``chip_smoke.py``'s phase-B cases (kernel, plain version, SDPA, bound); the
registers and spilled bytes of its fp32 forward, dq and dkv instantiations
are printed from the build log, with the static mix of
their SASS instructions (``cuobjdump -sass``: FFMA, shared-memory loads by
width, shuffles, barriers, MUFU) and the FMAs per float those loads bring,
and the device time a launch of the forward at the two CLIP shapes from
``torch.profiler``.

Run from the repository root on a machine with one CUDA card::

    python3 tools/sweep_fp32_tiles.py [variant ...] [--scratch DIR]

With no variant names it runs them all, in the order of ``VARIANTS``. The
variants listed are those measured for the fp32 forward, dq and dkv
(PERF.md, section 6): "base" is the tree as it is.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD, BWD, SIMT = "flash_attention.cu", "flash_attention_bwd.cu", "flash_simt.cuh"
BLOCK_K = "return kD == 64 ? 64 : kD == 80 ? (tm > 2 ? 32 : 64) : (tm > 2 ? 48 : 32);"
TM_LARGE = "constexpr int kTMLarge = kD == 128 ? 4 : 8;"
SMALL = "*tm = blocks(tm_large) >= sms ? tm_large : blocks(2) >= sms ? 2 : 1;"
DKV_TK = "constexpr int kTK = 4;"
DQ_TM_LARGE = "constexpr int kTMLarge = kD == 64 ? 8 : 4;"
DQ_BLOCK_K = "return tm > 2 ? (kD == 80 ? 64 : 32) : (kD == 128 ? 32 : 64);"
DQ_BLOCK_K_64 = "return tm > 2 ? (kD == 128 ? 32 : 64) : (kD == 128 ? 32 : 64);"  # 64 keys a tile, 32 at D = 128

# name: [(source, line as it is in the tree, line in the variant)]
VARIANTS = {
    "base": [],
    # the forward's largest blocks 64 rows (TM = 4) at every head dim
    "fwd_tm4": [(FWD, TM_LARGE, "constexpr int kTMLarge = 4;")],
    # D = 128: 64-row blocks with 32-key tiles, or 64-key tiles (one block an SM)
    "fwd_d128_bk32": [(FWD, BLOCK_K, BLOCK_K.replace("48", "32"))],
    "fwd_d128_bk64": [(FWD, BLOCK_K, BLOCK_K.replace("48", "64"))],
    # D = 128: 128-row blocks (TM = 8; one block an SM)
    "fwd_d128_tm8": [(FWD, TM_LARGE, "constexpr int kTMLarge = 8;")],
    # 32-row blocks only where they give every SM two blocks, else 16-row ones (the forward's and dq's rule)
    "fwd_small_tm1": [(SIMT, SMALL, SMALL.replace("blocks(2) >= sms", "blocks(2) >= 2 * sms"))],
    # dkv with 2 keys a thread at D = 128 (32 keys a block, two blocks an SM)
    "dkv_d128_tk2": [(BWD, DKV_TK, "constexpr int kTK = kD == 128 ? 2 : 4;")],
    # dkv with 8 keys a thread at D = 64 (128 keys a block, one block an SM)
    "dkv_d64_tk8": [(BWD, DKV_TK, "constexpr int kTK = kD == 64 ? 8 : 4;")],
    # dq at D = 64: 64-row blocks (4 × 4 S and dP micro-tiles with 32-key tiles, 4 × 8 with 64)
    "dq_d64_tm4": [(BWD, DQ_TM_LARGE, "constexpr int kTMLarge = 4;")],
    "dq_d64_tm4_bk64": [(BWD, DQ_TM_LARGE, "constexpr int kTMLarge = 4;"), (BWD, DQ_BLOCK_K, DQ_BLOCK_K_64)],
    # dq at D = 64, 128-row blocks with 48- or 64-key tiles (8 × 6 or 8 × 8 micro-tiles; one block an SM)
    "dq_d64_bk48": [(BWD, DQ_BLOCK_K, DQ_BLOCK_K.replace("(kD == 80 ? 64 : 32)", "(kD == 64 ? 48 : kD == 80 ? 64 : 32)"))],
    "dq_d64_bk64": [(BWD, DQ_BLOCK_K, DQ_BLOCK_K_64)],
    # dq at D = 128, 64-row blocks with 48- or 64-key tiles (4 × 6 or 4 × 8 micro-tiles; one block an SM)
    "dq_d128_bk48": [(BWD, DQ_BLOCK_K, DQ_BLOCK_K.replace("(kD == 80 ? 64 : 32)", "(kD == 128 ? 48 : kD == 80 ? 64 : 32)"))],
    "dq_d128_bk64": [(BWD, DQ_BLOCK_K, DQ_BLOCK_K.replace("(kD == 80 ? 64 : 32)", "(kD == 64 ? 32 : 64)"))],
}


def make_copy(name: str, scratch: str) -> str:
    root = os.path.join(scratch, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "alg_tpu_torch"), os.path.join(root, "alg_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(root, "alg_tpu_torch", "csrc")
    for f in os.listdir(csrc):
        if f.endswith(".cu") and f not in (FWD, BWD):
            os.remove(os.path.join(csrc, f))
    for f, old, new in VARIANTS[name]:
        path = os.path.join(csrc, f)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"{name}: {f} has no line {old!r}")
        open(path, "w").write(text.replace(old, new))
    return root


SASS_CLASSES = ("FFMA", "LDS.128", "LDS.64", "LDS.32", "STS", "SHFL", "BAR", "MUFU", "LDGSTS")


def sass_class(opcode: str):
    """The class of SASS_CLASSES an opcode falls in (shared-memory loads by width), or None."""
    base = opcode.split(".")[0]
    if base == "LDS":
        return "LDS.128" if ".128" in opcode else "LDS.64" if ".64" in opcode else "LDS.32"
    return base if base in SASS_CLASSES else None


def sass_mix(lib) -> dict:
    """{fp32 forward, dq or dkv kernel: {class: static count, "total": instructions}} from ``cuobjdump -sass``."""
    import re
    from pathlib import Path

    import chip_smoke as c
    from alg_tpu_torch.ops import _build

    out = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    mix, current = {}, None
    for line in out.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            current = name if any(re.search(p, name) for p in c.FP32_KERNELS.values()) else None
            if current:
                mix[current] = dict.fromkeys(SASS_CLASSES + ("total",), 0)
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if current and op:
            mix[current]["total"] += 1
            cls = sass_class(op.group(1))
            if cls:
                mix[current][cls] += 1
    return mix


def time_one(name: str) -> None:
    """In the variant's own process: build, print resources, time the cases."""
    sys.path.append(REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from alg_tpu_torch.ops import _build
    from alg_tpu_torch.ops.flash_attention import flash_attention

    print(c._card_line(), flush=True)
    path = _build.build()
    for line in c._kernel_resources(path.with_suffix(".log").read_text()):
        print(line.split(" _Z")[0], line.split(":")[-1])
    for kernel, counts in sass_mix(path).items():
        floats = 4 * counts["LDS.128"] + 2 * counts["LDS.64"] + counts["LDS.32"]
        print(f"[S] {kernel}: " + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
              + f"; FFMA per float loaded {counts['FFMA'] / max(1, floats):.2f}", flush=True)
    records, gen = [], torch.Generator("cuda").manual_seed(0)
    c._set_tf32(False, False)
    f32 = torch.float32
    c._attn_case(records, "flash_dit", (2, 48, 4276, 64), f32, gen, 64 ** -0.5, False, reps=5)
    c._attn_case(records, "flash_dit", (2, 48, 17776, 64), f32, gen, 64 ** -0.5, False, reps=2)
    c._attn_case(records, "flash_wan_self", (2, 40, 4680, 128), f32, gen, 128 ** -0.5, False, reps=5)
    c._attn_case(records, "flash_wan_cross_text", (2, 40, 4680, 128), f32, gen, 128 ** -0.5, False, sk=512)
    c._attn_case(records, "flash_clip", (1, 16, 257, 80), f32, gen, 80 ** -0.5, True, reps=20)
    c._attn_case(records, "flash_clip_text_causal", (1, 12, 77, 64), f32, gen, 64 ** -0.5, True, causal=True,
                 reps=20)
    c._attn_case(records, "flash_t5_bias_stable", (1, 64, 226, 64), f32, gen, 1.0, True, with_bias=True)
    c._attn_bwd_case(records, "dit", (1, 48, 4276, 64), f32, gen, 64 ** -0.5)
    c._attn_bwd_case(records, "dit", (1, 48, 17776, 64), f32, gen, 64 ** -0.5, reps=1)
    c._attn_bwd_case(records, "wan_self", (1, 40, 4680, 128), f32, gen, 128 ** -0.5)
    c._attn_bwd_case(records, "wan_cross_text", (1, 40, 4680, 128), f32, gen, 128 ** -0.5, sk=512)
    c._attn_bwd_case(records, "square_causal", (1, 32, 4096, 128), f32, gen, 128 ** -0.5, stable=True, causal=True)
    for shape, causal in (((1, 16, 257, 80), False), ((1, 12, 77, 64), True)):
        q = torch.randn(shape, device="cuda")
        flash_attention(q, q, q, shape[-1] ** -0.5, causal=causal)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                flash_attention(q, q, q, shape[-1] ** -0.5, causal=causal)
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if "flash_fwd_kernel" in e.key]
        us = sum(getattr(e, "device_time_total", 0) for e in found) / 20
        print(f"[P] {list(shape)} causal={causal}: {us:.2f} us of device time a launch", flush=True)
    print("ALL OK" if all(r["ok"] for r in records) else "SOME FAILED", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", help=f"of {list(VARIANTS)}")
    parser.add_argument("--scratch", default=None, help="where the copies go (default: a new temporary directory)")
    parser.add_argument("--one", default=None, help=argparse.SUPPRESS)  # the timing process of one copy
    args = parser.parse_args()
    if args.one:
        time_one(args.one)
        return 0
    names = args.variants or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}")
    scratch = args.scratch or tempfile.mkdtemp(prefix="sweep_fp32_")
    failed = 0
    for name in names:
        root = make_copy(name, scratch)
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name],
                              env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True, timeout=1200)
        print(f"===== {name} rc={proc.returncode} {time.time() - t0:.0f} s", flush=True)
        print(proc.stdout, proc.stderr[-3000:] if proc.returncode else "", flush=True)
        failed += proc.returncode != 0 or "ALL OK" not in proc.stdout
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
