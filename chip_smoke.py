#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``alg_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which must pass:

  A. build: compile ``alg_tpu_torch/csrc/*.cu`` with nvcc for sm_90a into
     ``alg_tpu_torch/_build/`` (ops/_build.py) and print the build time and
     the compiler's register/shared-memory report;
  B. kernels: each CUDA kernel against its plain PyTorch version on the card,
     in bf16 and fp32 (fp32 with TF32 off), at the shapes of the CogVideoX
     main path; prints max|diff| beside the stated tolerance and the median
     time of kernel and plain version;
  C. slice: the full-width CogVideoX-5b-I2V pipeline (42-layer DiT and 24-layer
     T5-XXL in bf16, VAE in fp32, random weights from a seed) driven once
     through ``CogVideoXPipeline.__call__`` with the shipped ALG config at
     9 frames, 480x720, 4 steps (2 three-pass, 2 two-pass); checks the
     output shape, finiteness and the exact kernel launch counts, and prints
     the time of each stage;
  D. agreement: a small pipeline (head dim 64, two layers) run on the card
     through the kernels and on the CPU through the plain versions, fp32 with
     TF32 off; final latents within atol 2e-3, decoded frames above 40 dB.

Prints the card's name and power limit first, a JSON line of kernel records
before the last line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits nonzero, without that line, if there is no CUDA device, the port
cannot be imported, or any phase fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` on the current stream (one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _set_tf32(matmul: bool, cudnn: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    print(f"  TF32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)


# ---------------------------------------------------------------------------
# A. build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from alg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[A] built {path.name} in {time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS[:2])})")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("    " + line.strip())


# ---------------------------------------------------------------------------
# B. kernels against their plain versions
# ---------------------------------------------------------------------------

# bf16: the kernel rounds once at the end where the plain version rounds
# after each op (qk_prep) or rounds P to bf16 (attention) — up to about two
# bf16 ulps at unit scale, hence atol 2e-2 plus rtol 1e-2 for larger values.
# fp32: only the summation order differs (64-wide norms, up to 17,776-key
# softmax sums), so a few fp32 ulps.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (2e-5, 1e-5)}


def tol_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _report(records, name, dtype, shape, err, ok, tol, ms, plain_ms):
    print(f"[B] {name:<22} {dtype:<8} {str(shape):<22} max|diff| {err:.3e} "
          f"(atol {tol[0]:g}, rtol {tol[1]:g}) kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    records.append(dict(name=name, dtype=dtype, shape=list(shape), max_abs_err=err, ok=ok,
                        ms=ms, plain_ms=plain_ms))


def _close(a, b, tol):
    import torch

    a, b = a.float(), b.float()
    err = (a - b).abs().max().item()
    return err, bool(torch.allclose(a, b, atol=tol[0], rtol=tol[1]))


def _qk_case(records, shape, dtype, gen, text_len=226):
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.ops.qk_prep import qk_norm_rope, qk_norm_rope_plain

    b, h, s, d = shape
    dev = "cuda"
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    bias = 0.1 * torch.randn(d, generator=gen, device=dev)
    ang = torch.rand(s, d // 2, generator=gen, device=dev) * 6.28
    ang[:text_len] = 0.0  # identity rows over the text prefix, as in the DiT
    cos = torch.cos(ang).repeat_interleave(2, -1).contiguous()
    sin = torch.sin(ang).repeat_interleave(2, -1).contiguous()
    tol = TOL[tol_name(dtype)]
    out = qk_norm_rope(x, scale, bias, cos, sin, 1e-6)
    ref = qk_norm_rope_plain(x, scale, bias, cos, sin, 1e-6)
    err, ok = _close(out, ref, tol)
    # identity rows reduce to the LayerNorm output: at most one rounding step
    # of the activation dtype apart (the two compute mean/var in other orders)
    ln = L.layer_norm(x[:, :, :text_len], scale, bias, 1e-6)
    id_tol = (1e-6, 8e-3) if dtype == torch.bfloat16 else (2e-6, 1e-6)
    id_err, id_ok = _close(out[:, :, :text_len], ln, id_tol)
    print(f"[B] qk_prep identity rows {str(dtype):<14} max|diff| vs layer_norm {id_err:.3e} "
          f"(atol {id_tol[0]:g}, rtol {id_tol[1]:g}) {'PASS' if id_ok else 'FAIL'}")
    ms = _time_ms(lambda: qk_norm_rope(x, scale, bias, cos, sin, 1e-6))
    plain_ms = _time_ms(lambda: qk_norm_rope_plain(x, scale, bias, cos, sin, 1e-6))
    _report(records, "qk_prep", tol_name(dtype), shape, err, ok and id_ok, tol, ms, plain_ms)


def _attn_case(records, name, shape_q, dtype, gen, scale, stable, with_bias=False, q_chunk=None):
    """Kernel vs plain attention. ``q_chunk`` runs the plain version over
    query chunks (per batch element) so its [H, chunk, Sk] logits fit."""
    import torch

    from alg_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    b, h, s, d = shape_q
    dev = "cuda"
    q, k, v = (torch.randn(shape_q, generator=gen, device=dev).to(dtype) for _ in range(3))
    bias = 0.5 * torch.randn((1, h, s, s), generator=gen, device=dev) if with_bias else None
    tol = TOL[tol_name(dtype)]

    def kernel():
        return flash_attention(q, k, v, scale, bias=bias, stable=stable)

    def plain_chunks():
        if q_chunk is None:
            yield (slice(None), slice(None)), attention_plain(q, k, v, scale, bias)
            return
        for bi in range(b):
            for i in range(0, s, q_chunk):
                sl = (slice(bi, bi + 1), slice(i, i + q_chunk))
                bsl = None if bias is None else bias[:, :, i:i + q_chunk]
                yield sl, attention_plain(q[sl[0], :, sl[1]], k[sl[0]], v[sl[0]], scale, bsl)

    def plain():
        for _ in plain_chunks():
            pass

    out = kernel()
    err, ok = 0.0, True
    for (bs, qs), ref in plain_chunks():
        e, o = _close(out[bs, :, qs], ref, tol)
        err, ok = max(err, e), ok and o
    ms = _time_ms(kernel, reps=3)
    plain_ms = _time_ms(plain, reps=3)
    _report(records, name, tol_name(dtype), shape_q, err, ok, tol, ms, plain_ms)


def phase_kernels() -> list:
    import torch

    records = []
    gen = torch.Generator("cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        _set_tf32(False, False)
        for shape in ((2, 48, 4276, 64), (2, 48, 17776, 64)):
            _qk_case(records, shape, dtype, gen)
        _attn_case(records, "flash_t5_bias_stable", (1, 64, 226, 64), dtype, gen, 1.0, True, with_bias=True)
        _attn_case(records, "flash_dit", (2, 48, 4276, 64), dtype, gen, 64 ** -0.5, False)
        _attn_case(records, "flash_dit", (2, 48, 17776, 64), dtype, gen, 64 ** -0.5, False, q_chunk=2048)
        torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel comparison(s) out of tolerance: {bad}")
    return records


# ---------------------------------------------------------------------------
# C. the full-width slice through CogVideoXPipeline.__call__
# ---------------------------------------------------------------------------

PROMPT = "a red fox runs through fresh snow at dawn"


def _seeded_tokenize(vocab_size: int):
    """Tokenizer stand-in: seeded ids ``[len(prompts), max_len]`` in
    [0, vocab_size), different for each prompt text."""
    import numpy as np

    def tokenize(prompts, max_len):
        return np.stack([np.random.RandomState(sum(map(ord, p)) + 1).randint(0, vocab_size, max_len)
                         for p in prompts]).astype(np.int64)

    return tokenize


def _alg_kwargs(**over):
    kw = dict(negative_prompt="", guidance_scale=6.0, seed=42, num_inference_steps=4,
              use_low_pass_guidance=True, lp_filter_type="down_up", lp_filter_in_latent=True,
              lp_resize_factor=0.25, lp_strength_schedule_type="interval",
              schedule_interval_start_time=0.0, schedule_interval_end_time=0.4)
    kw.update(over)
    return kw


class _StageTimer:
    """Wall time of pipeline stages, each bracketed by device synchronises.

    A denoise step runs from its DiT forward's start to the next step's
    (or to the decode's) start: the DiT forward (also timed alone), the CFG
    combine, the DDIM update and the next step's input preparation (ALG
    filter, concatenation)."""

    def __init__(self):
        self.rows = []  # (stage, ms, DiT ms or None)
        self._step = None  # [label, start, DiT ms]

    def close_step(self, now):
        if self._step is not None:
            label, start, dit_ms = self._step
            self.rows.append((label, (now - start) * 1e3, dit_ms))
            self._step = None

    def wrap(self, name, fn, check=None):
        import torch

        def timed(*args, **kwargs):
            if check is not None:
                check(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.close_step(t0)
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.rows.append((name, (time.perf_counter() - t0) * 1e3, None))
            return out

        return timed

    def hook_dit(self, dit):
        import torch

        def pre(module, args):
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.close_step(now)
            x, text = args[0], args[1]  # [B, F, C, H, W], [B, S_text, D]
            seq = text.shape[1] + x.shape[1] * x.shape[3] * x.shape[4] // module.cfg.patch_size ** 2
            self._step = [f"denoise step ({x.shape[0]}-pass, S={seq})", now, None]

        def post(module, args, out):
            torch.cuda.synchronize()
            self._step[2] = (time.perf_counter() - self._step[1]) * 1e3

        return [dit.register_forward_pre_hook(pre), dit.register_forward_hook(post)]

    def count(self, prefix):
        return sum(1 for name, _, _ in self.rows if name.startswith(prefix))


def _require_finite(latents, *_):
    import torch

    if not bool(torch.isfinite(latents).all()):
        raise AssertionError("final latents are not finite")


def phase_slice() -> dict:
    """Drive the full-width pipeline once; return the kernel launch counts."""
    import numpy as np
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer, CogVideoXTransformerConfig
    from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE, CogVideoXVAEConfig
    from alg_tpu_torch.models.t5 import T5Config, T5Encoder
    from alg_tpu_torch.ops.flash_attention import flash_attention
    from alg_tpu_torch.ops.qk_prep import qk_norm_rope
    from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline

    _set_tf32(False, True)  # PyTorch's defaults: fp32 matmuls in full fp32, cuDNN convs in TF32
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    tcfg, t5cfg, vcfg = CogVideoXTransformerConfig(), T5Config(), CogVideoXVAEConfig()
    dit = L.init_random_(CogVideoXTransformer(tcfg, device=dev, dtype=torch.bfloat16), gen)
    t5 = L.init_random_(T5Encoder(t5cfg, device=dev, dtype=torch.bfloat16), gen)
    vae = L.init_random_(CogVideoXVAE(vcfg, device=dev, dtype=torch.float32), gen)
    torch.cuda.synchronize()
    n = {name: sum(p.numel() for p in m.parameters()) for name, m in (("dit", dit), ("t5", t5), ("vae", vae))}
    print(f"[C] random init on the card in {time.perf_counter() - t0:.1f} s: DiT {n['dit'] / 1e9:.2f} B params "
          f"(bf16), T5 {n['t5'] / 1e9:.2f} B (bf16), VAE {n['vae'] / 1e6:.1f} M (fp32); "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)

    pipe = CogVideoXPipeline(transformer=dit, vae=vae, t5=t5, tokenize=_seeded_tokenize(t5cfg.vocab_size),
                             dtype=torch.bfloat16, device=dev)
    timer = _StageTimer()
    pipe.encode_prompt = timer.wrap("T5 encode", pipe.encode_prompt)
    pipe.vae_encode_sample = timer.wrap("VAE encode + posterior draw", pipe.vae_encode_sample)
    pipe.decode_latents = timer.wrap("VAE tiled decode", pipe.decode_latents, check=_require_finite)
    hooks = timer.hook_dit(dit)
    image = np.random.RandomState(0).uniform(-1, 1, (1, 3, 480, 720)).astype(np.float32)

    torch.cuda.reset_peak_memory_stats()
    qk_norm_rope.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    video = pipe(image=image, prompt=PROMPT, height=480, width=720, num_frames=9, output_type="np",
                 **_alg_kwargs())
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = {"qk_prep": qk_norm_rope.launches, "flash_attention": flash_attention.launches}
    for h in hooks:
        h.remove()

    for name, ms, dit_ms in timer.rows:
        print(f"[C] {name:<36} {ms:10.1f} ms" + ("" if dit_ms is None else f"  (DiT forward {dit_ms:.1f} ms)"))
    print(f"[C] pipeline call total {total_s:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)

    dit_fwd, t5_enc = timer.count("denoise step"), timer.count("T5 encode")
    three, two = timer.count("denoise step (3-pass"), timer.count("denoise step (2-pass")
    want = {"qk_prep": 2 * tcfg.num_layers * dit_fwd,
            "flash_attention": tcfg.num_layers * dit_fwd + t5cfg.num_layers * t5_enc}
    print(f"[C] launches {counts} (want {want}: {dit_fwd} DiT forwards, {t5_enc} T5 encodes)")
    if (dit_fwd, t5_enc, three, two) != (4, 2, 2, 2):
        raise AssertionError(f"stage counts: {dit_fwd} DiT forwards ({three} 3-pass, {two} 2-pass), "
                             f"{t5_enc} T5 encodes; want 4 (2, 2), 2")
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != {want}")
    if video.shape != (1, 9, 480, 720, 3) or not np.isfinite(video).all():
        raise AssertionError(f"output {video.shape}, finite={bool(np.isfinite(video).all())}")
    print(f"[C] output {video.shape} finite, mean {video.mean():.4f} std {video.std():.4f}: PASS", flush=True)

    _headline_forward(dit, gen)
    del dit, t5, vae, pipe
    torch.cuda.empty_cache()
    return counts


def _headline_forward(dit, gen) -> None:
    """Time one 2-pass DiT forward at the shipped config's 49 frames (13
    latent frames, S = 226 + 13·1350 = 17,776) on random inputs."""
    import torch

    from alg_tpu_torch.models.cogvideox.transformer import cogvideox_rope

    cfg, dev = dit.cfg, gen.device
    x = torch.randn((2, 13, cfg.in_channels, 60, 90), generator=gen, device=dev).to(torch.bfloat16)
    emb = torch.randn((2, cfg.max_text_seq_length, cfg.text_embed_dim), generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = (torch.from_numpy(a).to(dev) for a in cogvideox_rope(cfg, 480, 720, 13))
    ts = torch.full((2,), 999.0, device=dev)
    with torch.no_grad():
        dit(x, emb, ts, cos, sin)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dit(x, emb, ts, cos, sin)
        torch.cuda.synchronize()
    print(f"[C] DiT forward at 49 frames (2-pass, B=2, S=17776): {(time.perf_counter() - t0) * 1e3:.1f} ms, "
          f"finite={bool(torch.isfinite(out).all())}", flush=True)


# ---------------------------------------------------------------------------
# D. the same path on the card (kernels) and on the CPU (plain versions)
# ---------------------------------------------------------------------------


def phase_agreement() -> None:
    import copy

    import numpy as np
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer, CogVideoXTransformerConfig
    from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE, CogVideoXVAEConfig
    from alg_tpu_torch.models.t5 import T5Config, T5Encoder
    from alg_tpu_torch.ops.flash_attention import flash_attention
    from alg_tpu_torch.ops.qk_prep import qk_norm_rope
    from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline

    _set_tf32(False, False)
    tcfg = CogVideoXTransformerConfig(num_attention_heads=2, attention_head_dim=64, in_channels=8,
                                      out_channels=4, time_embed_dim=32, text_embed_dim=64, num_layers=2,
                                      sample_height=8, sample_width=8, max_text_seq_length=8)
    t5cfg = T5Config(vocab_size=128, d_model=64, d_kv=64, d_ff=128, num_layers=2, num_heads=2,
                     relative_attention_num_buckets=8, relative_attention_max_distance=16)
    vcfg = CogVideoXVAEConfig(block_out_channels=(8, 16, 16, 32), latent_channels=4, layers_per_block=1,
                              norm_num_groups=4)
    gen = torch.Generator("cpu").manual_seed(1)
    mods = [L.init_random_(m, gen) for m in (CogVideoXTransformer(tcfg), T5Encoder(t5cfg), CogVideoXVAE(vcfg))]
    image = np.random.RandomState(1).uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)
    kw = _alg_kwargs(image=image, prompt=PROMPT, height=64, width=64, num_frames=5, max_sequence_length=8,
                     output_type="latent")
    results = {}
    for dev in ("cpu", "cuda"):
        dit, t5, vae = (copy.deepcopy(m).to(dev) for m in mods)
        pipe = CogVideoXPipeline(transformer=dit, vae=vae, t5=t5, tokenize=_seeded_tokenize(t5cfg.vocab_size),
                                 device=dev)
        qk_norm_rope.launches = flash_attention.launches = 0
        lat = pipe(**kw)
        frames = pipe.decode_latents(torch.from_numpy(lat).to(dev)).cpu().numpy()
        results[dev] = (lat, np.clip(frames / 2 + 0.5, 0, 1), qk_norm_rope.launches, flash_attention.launches)
    (lat_c, fr_c, qk_c, fa_c), (lat_g, fr_g, qk_g, fa_g) = results["cpu"], results["cuda"]
    err = float(np.abs(lat_g - lat_c).max())
    mse = float(np.mean((fr_g.astype(np.float64) - fr_c) ** 2))
    psnr = float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)
    # launches: 4 DiT forwards x 2 layers (2 qk_prep each) + 2 T5 encodes x 2 layers
    ok = err <= 2e-3 and psnr > 40.0 and (qk_c, fa_c) == (0, 0) and (qk_g, fa_g) == (16, 12)
    print(f"[D] small pipeline, card (kernels) vs CPU (plain), fp32: latents max|diff| {err:.3e} (atol 2e-3), "
          f"frames PSNR {psnr:.1f} dB (> 40), launches card qk {qk_g} flash {fa_g} / CPU {qk_c} {fa_c}: "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("card and CPU runs of the small pipeline disagree")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# the phase-B case whose numbers go into each kernel's JSON record: the
# shape the slice's 2-pass steps give it, in bf16
_HEADLINE = {"qk_prep": ("qk_prep", [2, 48, 4276, 64]), "flash_attention": ("flash_dit", [2, 48, 4276, 64])}
_SOURCES = {
    "qk_prep": ("alg_tpu_torch/csrc/qk_prep.cu", "alg_tpu/ops/qk_prep.py:56"),
    "flash_attention": ("alg_tpu_torch/csrc/flash_attention.cu", "alg_tpu/ops/flash_attention.py:98"),
}


def _kernel_json(records, counts) -> dict:
    out = []
    for name, (case, shape) in _HEADLINE.items():
        rec = next(r for r in records if r["name"] == case and r["shape"] == shape and r["dtype"] == "bfloat16")
        out.append({"name": name, "route": "cuda", "source": _SOURCES[name][0], "replaces": _SOURCES[name][1],
                    "launches": counts[name], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "at": f"bfloat16 {shape}"})
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        import alg_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root", file=sys.stderr)
        return 2

    print(_card_line(), flush=True)
    try:
        phase_build()
        records = phase_kernels()
        counts = phase_slice()
        phase_agreement()
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps(_kernel_json(records, counts)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
