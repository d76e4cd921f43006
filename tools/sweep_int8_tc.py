#!/usr/bin/env python3
"""Time variants of the int8 tensor-core attention kernel on one GPU.

Each variant is a copy of ``alg_tpu_torch`` under a scratch directory with
lines of ``csrc/flash_attention_int8_tc.cu`` replaced (the other kernel
sources are left out, so each copy builds only that unit, at both head
dims). Each copy is built by the port's own ``ops/_build.py`` and run in a
process of its own: its registers and spilled bytes from the build log, its
agreement with ``flash_attention_int8_plain`` at a small shape (printed, not
a gate: some variants leave work out on purpose and are wrong), and the
device time a launch of the kernel alone (``torch.profiler``) in both modes
at the shipped CogVideoX and Wan self-attention shapes in bf16.

Run from the repository root on a machine with one CUDA card::

    python3 tools/sweep_int8_tc.py [variant ...] [--scratch DIR]

With no variant names it runs them all, in the order of ``VARIANTS``:
"base" is the tree as it is; the variants that leave work out ("noexp",
"nopv", "nomax") show what that work costs, the others are other designs.
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
SRC = "flash_attention_int8_tc.cu"
EXP2 = "          const float pv = exp2f(exponent<kRowTiles, kMasked>(sacc, sc, key0, n_keys, mt, j, hf, e));"
ROWS = "  static constexpr int kRowTiles = kD == 128 && (kFull || kSimt) ? 1 : 2;  // m16 row tiles a warp"
WARPS = "constexpr int kWarps = 4;"
PV_QK = "              mma_bf16(o[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);"
PHASE = "    st.phase = !kFull ? 1 : st.kb_end - kb0 <= kTile ? 2 : 0;"
FAST = "          fast = __all_sync(0xffffffffu, rows_fast);"

# name: [(line as it is in the source, line in the variant)]
VARIANTS = {
    "base": [],
    # "qk": the exponential left out, p is its exponent (wrong; shows what exp2f costs)
    "noexp": [(EXP2, "          const float pv = exponent<kRowTiles, kMasked>(sacc, sc, key0, n_keys, mt, j, hf, e);")],
    # "qk": half of the P·V products left out (wrong; shows what the bf16 product costs)
    "nopv": [(PV_QK, "")],
    # "full": no separate sweep for the row maximum, each tile taken as a key block of its own (wrong)
    "nomax": [(PHASE, "    st.phase = !kFull ? 1 : 2;")],
    # "full": the P codes always on the exact path (exp2f, then the minimum and the select, as the plain version)
    "exact_codes": [(FAST, "          fast = false;")],
    # one m16 row tile a warp in both bf16 modes, or in "full" mode only (64-row blocks); fp32 "qk" keeps its
    # 8 x 8 tiles of O
    "rows1": [(ROWS, "  static constexpr int kRowTiles = kSimt && kD == 64 ? 2 : 1;")],
    "full_rows1": [(ROWS, "  static constexpr int kRowTiles = kFull || (kSimt && kD == 128) ? 1 : 2;")],
    # 8 warps a block: twice the query rows share each staged K and V tile
    "warps8": [(WARPS, "constexpr int kWarps = 8;")],
}


def make_copy(name: str, scratch: str) -> str:
    root = os.path.join(scratch, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "alg_tpu_torch"), os.path.join(root, "alg_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(root, "alg_tpu_torch", "csrc")
    for f in os.listdir(csrc):
        if f.endswith(".cu") and f != SRC:
            os.remove(os.path.join(csrc, f))
    path = os.path.join(csrc, SRC)
    text = open(path).read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"{name}: {SRC} has no line {old!r}")
        text = text.replace(old, new)
    open(path, "w").write(text)
    return root


def time_one(name: str) -> None:
    """In the variant's own process: build, print resources, check and time."""
    import re

    sys.path.append(REPO)
    import torch

    import chip_smoke as c
    from alg_tpu_torch.ops import _build
    from alg_tpu_torch.ops.flash_attention_int8 import flash_attention_int8, flash_attention_int8_plain

    print(c._card_line(), flush=True)
    path = _build.build()
    kernel = None
    for line in path.with_suffix(".log").read_text().splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = found.group(1)
            kernel = ("full" if "ILb1E" in name else "qk") + (" fp32" if "EfE" in name else " bf16")
        used = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if kernel and (used or spill):
            print(f"[R] {kernel}: {line.strip()}", flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    for d in (64, 128):
        q, k, v = c._dit_like_qkv((1, 4, 1500, d), torch.bfloat16, gen)
        for pv_int8 in (False, True):
            out = flash_attention_int8(q, k, v, d ** -0.5, pv_int8=pv_int8)
            ref = flash_attention_int8_plain(q, k, v, d ** -0.5, pv_int8=pv_int8)
            diff = (out.float() - ref.float()).abs()
            print(f"[C] D={d} {'full' if pv_int8 else 'qk'}: max|diff| {diff.max().item():.3e}, mean "
                  f"{diff.mean().item():.3e} (mean|ref| {ref.float().abs().mean().item():.3e})", flush=True)
    for shape, reps in (((2, 48, 17776, 64), 3), ((2, 40, 32760, 128), 1)):
        q, k, v = c._dit_like_qkv(shape, torch.bfloat16, gen)
        for pv_int8 in (False, True):
            ms = c._device_ms(lambda: flash_attention_int8(q, k, v, shape[-1] ** -0.5, pv_int8=pv_int8),
                              "flash_int8_tc", reps=reps)
            print(f"[T] {name} {'full' if pv_int8 else 'qk':<4} {list(shape)}: kernel device time "
                  f"{'not measured' if ms is None else f'{ms:.3f} ms'}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    print("DONE", flush=True)


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
    scratch = args.scratch or tempfile.mkdtemp(prefix="sweep_int8_")
    failed = 0
    for name in names:
        root = make_copy(name, scratch)
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name],
                              env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True, timeout=1200)
        print(f"===== {name} rc={proc.returncode} {time.time() - t0:.0f} s", flush=True)
        print(proc.stdout, proc.stderr[-3000:] if proc.returncode else "", flush=True)
        failed += proc.returncode != 0 or "DONE" not in proc.stdout
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
