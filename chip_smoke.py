#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``alg_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which must pass:

  A.  build: compile ``alg_tpu_torch/csrc/*.cu`` with nvcc for sm_90a into
      ``alg_tpu_torch/_build/`` (ops/_build.py; one nvcc process per compile
      unit, side by side) and print the build time and the compiler's
      register/shared-memory report, with one line for each instantiation
      of the register-tiled fp32 forward, dq and dkv kernels, the bf16
      tensor-core forward, the Hopper forward, the int8 kernel (both modes,
      both types) and the qk prolog kernel (registers, spilled bytes, head
      dim), and the compile units; then ``cuobjdump -sass`` of the library:
      every kernel of the tensor-core entry points must hold tensor-core
      instructions, whose counts are printed per kernel: HGMMA and no HMMA
      in the Hopper forward (``csrc/flash_attention_wgmma.cu``, the bf16 calls
      at D = 64 and 128 without a bias; one kernel a head dim and mode),
      HMMA and no HGMMA in the bf16 mma.sync
      forward, HMMA in dq and dkv, IMMA in both modes of the int8 kernel in both
      types and HMMA in its bf16 "qk" mode as well (P·V in bf16); its fp32
      "qk" mode must hold no HMMA (P·V in exact fp32 FMAs, no TF32);
  B.  kernels: each CUDA kernel against its plain PyTorch version on the
      card, in bf16 and fp32 (fp32 with TF32 off; bf16 attention and bf16
      dq and dkv run the tensor-core kernels, fp32 the CUDA-core ones), at
      the shapes of the
      CogVideoX, Wan and HunyuanVideo main paths (the causal attention of
      Llama and the CLIP text encoder among them, and one square causal call
      beside its dense twin, which shows the skipped tiles); prints
      max|diff| beside the stated
      tolerance, the median time of kernel and plain version, the bound (the
      least time the card could take: bytes over 3.35 TB/s or operations over
      the peak rate of the type, whichever is larger) and, for attention, the
      time of ``torch.nn.functional.scaled_dot_product_attention`` on the
      same tensors, a yardstick that the port never calls (a call on the
      Hopper forward also times the ``"tc"`` kernel on the same tensors; the
      Wan DiT's three attentions of a 3-pass step at the shipped 81 frames,
      ``[3,40,32760,128]`` to 32,760, 512 and 257 keys, among them);
      then the training kernels: the forward's LSE output against the plain
      residual version, and the dq and dkv backward kernels against their
      plain versions, at the attention shapes a training step of each family
      gives them (CogVideoX at 9 and 49 frames, Wan self and cross,
      HunyuanVideo's joint call with ``kv_len``, a square causal call, one
      call with ``kv_len`` 0 in a batch row), with the backward time of
      ``scaled_dot_product_attention`` under autograd as the yardstick (its
      forward on inputs that require a gradient for the LSE call);
      then the int8 attention kernel against ``flash_attention_int8_plain``
      (its bf16 entry on bf16 inputs, its fp32 entry on the same values in
      fp32), modes "qk" and "full", at the self-attention
      shapes of the three DiTs at 9 frames and at the shipped lengths (the
      Hunyuan ones with ``kv_len``) and with ``kv_len`` 0 in a batch row, on
      DiT-like inputs, with their drift against exact attention beside the JAX
      package's bounds, their bound, the quantizers' times (each apart), the
      bf16 flash kernel and ``scaled_dot_product_attention`` on the same
      tensors, and "full" mode again with ``block_k`` equal to the kernels'
      key tile; then the
      flash kernel's qk prolog (five combinations of norm, RoPE, ``stable``
      and ``prolog_k``): the call (the ``qk_prolog`` kernel on q and k, then
      the forward kernel of the dtype) against ``apply_prolog_plain`` and the
      plain attention, beside the unfused sequence the DiTs run today, and
      the ``qk_prolog`` kernel alone against ``apply_prolog_plain`` with its
      device time (``torch.profiler``) beside its byte bound; and the
      CogVideoX-1.5 shapes in bf16: qk_prep and the tensor-core forward at
      [2, 48, S, 64] for S = 8,386 (9 frames at 768x1360) and 45,106 (the
      model card's 81 frames), the LSE, dq and dkv at [1, 48, 45106, 64];
      then the DiT blocks' AdaLN chain (``csrc/ada_norm.cu``) against its
      plain composition at the three cells' shipped lengths
      ([2, 18002, 3072] and [2, 45332, 3072], 226 text rows first, and
      [3, 32760, 5120]), each variant a block launches, in bf16 and fp32:
      the residuals bit for bit, the normed rows within a rounding at the
      norm, one launch a call, the kernel's time (and its device time) beside
      its bytes bound at 3.35 TB/s, the share of the bound, and the plain
      version's time;
  C.  CogVideoX slice: the full-width CogVideoX-5b-I2V pipeline (42-layer DiT
      and 24-layer T5-XXL in bf16, VAE in fp32, random weights from a seed)
      driven once through ``CogVideoXPipeline.__call__`` with the shipped ALG
      config at 9 frames, 480x720, 4 steps (2 three-pass, 2 two-pass); checks
      the output shape, finiteness and the exact kernel launch counts (the
      AdaLN chain's 3 a block, 3 x 42 a DiT forward: norm1, the attention's
      gated residual with norm2, the MLP's gated residual), and prints the
      time of each stage; then the same call under
      ``set_attention_int8("qk")`` and ``("full")`` (42 int8 launches a DiT
      forward and no bf16 flash launch from the DiT), with each step's time
      beside the bf16 run's and the drift of the final latents against it;
      then the rest of the sampling surface on the same pipeline, each call
      to the latents with exact launch counts (the plan's 3- and 2-pass
      forwards times a forward's launches) and its peak memory: C-pixel,
      BASELINE config #2 (gaussian blur sigma 3, kernel 0.1 of H, on the RGB
      frame, re-encoded by the VAE on every step) under the linear (1 -> 0
      by t = 0.5) and the exponential (rate 5, kernel scheduled) schedules,
      with each step's pixel filter, VAE encode and DiT milliseconds;
      C-sched, DPM, eta 0.5 and dynamic CFG; C-resume, the bf16 call's own
      arguments with a snapshot every step and an observer that interrupts
      after step 2, then the call that resumes it, held to the
      uninterrupted bf16 latents bit for bit; C-cache, cache_interval 2
      over 6 steps of the shipped interval (4 DiT forwards);
  C2. Wan slice: the full-width Wan2.1-I2V-14B pipeline (40-layer DiT and
      24-layer UMT5-XXL in bf16, CLIP ViT-H and VAE in fp32, random weights
      from a seed) driven once through ``WanPipeline.__call__`` with the
      shipped ALG settings at 9 frames, 480x832, 4 steps (2 three-pass, 2
      two-pass), the prompt through ``encode_prompt`` with a prefix mask and
      the CLIP tower's penultimate output as ``image_embeds``; same checks
      (the AdaLN chain's 4 launches a block, 4 x 40 a DiT forward: the
      modulated norm, the gated residual with norm2, the cross-attention's
      residual with the MLP's modulated norm, the MLP's gated residual),
      and the DiT's 120 flash launches a forward on the Hopper kernel, UMT5's
      (a bias) on mma.sync; then the same call under int8 "qk" (40 int8 and 80 bf16 flash launches
      a DiT forward: the two cross-attentions stay where they were); then
      C2-pixel, the same settings on the RGB frame (the condition video
      rebuilt, encoded tile by tile and sampled on each 3-pass step), and
      one such rebuild at the shipped 81 frames, 480x832, with its time and
      peak memory;
  C3. HunyuanVideo slice: the full-width HunyuanVideo-I2V pipeline (20 + 40
      block DiT and Llava-Llama3-8B with its CLIP ViT-L/14-336 tower in bf16,
      CLIP text and VAE in fp32, random weights from a seed) driven once
      through ``HunyuanVideoPipeline.__call__`` with the shipped single-pass
      ALG settings at 9 frames, 352x608, 4 steps (2 on the filtered first
      frame, 2 on the clean one), the prompt through ``encode_prompt`` with
      tokenizer and image-processor hooks; same checks; then the same call
      under int8 "full" (60 int8 launches a DiT forward with ``kv_len`` at
      head dim 128, 2 bf16 ones for the token refiner); then C3-pixel, the
      same settings on the RGB frame with the mode of its posterior on every
      step; then one DiT forward at the shipped 129 frames (33 latent frames);
  C5. CogVideoX-1.5 slice: the full-width CogVideoX-1.5-5B-I2V pipeline
      (42-layer DiT with temporal patches of 2 and the ofs embedding, T5-XXL,
      both bf16; the VAE with ``invert_scale_latents`` in fp32; random
      weights from a seed, built after C3's modules are freed) through
      ``CogVideoXPipeline.__call__`` with the shipped ALG config at 9 frames
      (3 latent frames padded to 4, S = 8,386), 768x1360, 4 steps: the
      decoded frames [1, 9, 3, 768, 1360], finiteness, exact launch counts,
      each stage's time and the peak memory; then one 2-pass DiT forward at
      the model card's 81 frames (S = 45,106), timed, and profiled for the
      tensor-core forward's share;
  C4. the qk prolog's path: no model passes a prolog, so its path is the
      entry point, ``attention(..., stable=False, prolog={...})``, on bf16
      tensors of the CogVideoX 9-frame shape (LayerNorm + RoPE) and the
      Hunyuan 9-frame joint shape with ``kv_len`` (RMS norm + RoPE), held
      against the unfused sequence, with exact launch counts (two
      ``qk_prolog`` launches, two tensor-core forwards, no CUDA-core
      forward);
  F.  the entry point users call: ``io/hf_checkpoint.py`` writes a
      CogVideoX-5b-I2V checkpoint at the published widths (DiT 48 x 64
      heads, T5-XXL, the full VAE; DiT and T5 cut to 2 layers each; random
      bf16 tensors from a seed, drawn on the card) to a temporary directory,
      and ``cli.run`` loads it (``io/model_zoo.py``: safetensors mapped,
      names converted, copied into modules built on the card) and runs the
      shipped ALG config as a parsed mapping with phase C's cut (9 frames,
      480x720, 4 steps) on a seeded RGB uint8 image to a written video;
      checks every loaded parameter against the drawn tensor bit for bit,
      the exact launch counts, and the written frames (9 of 480x720x3 uint8,
      finite, not constant, in whatever form ``write_video`` chose: H.264,
      MJPEG-AVI or ``.npy`` frames); prints the write's bytes and time, the
      load's read, convert and copy time per component, each stage's time
      and the peak device memory, with the card's name and power limit;
  D.  agreement: a small CogVideoX pipeline (head dim 64, two layers) run on
      the card through the kernels and on the CPU through the plain versions,
      fp32 with TF32 off; final latents within atol 2e-3, decoded frames
      above 40 dB; then the same under int8 "qk" and "full" (frames above
      40 dB, latents within 1e-1 at the largest and 1e-2 on the mean: rounding
      ties fall differently in the two runs, see ``INT8_LATENT_MAX``); these
      fp32 runs take the int8 kernel's fp32 entry (``"tc_fp32"``), whose
      launches are the ``agreement_*_int8_*`` paths of the JSON line; then the same without
      int8 in pixel-space ALG (gaussian blur, linear schedule), with DPM and
      with eta 0.5, within 2e-3 and 40 dB;
  D2. the same for a small Wan pipeline (DiT head dim 128, UMT5 with a mask,
      CLIP head dim 80), and again in pixel-space ALG;
  D3. the same for a small HunyuanVideo pipeline (DiT and Llava head dim 128,
      CLIP text head dim 64, through ``encode_prompt``, true CFG with ALG so
      that 3- and 2-pass steps run), again under int8 "full" and again in
      pixel-space ALG.
  D4. the same for a small CogVideoX-1.5 pipeline (temporal patches, the
      ofs embedding, a VAE with ``invert_scale_latents``; 9 frames, 3 latent
      frames padded to 4) in latent and in pixel-space ALG.
  F2. agreement through the loader: a small CogVideoX and a small Wan
      checkpoint from ``io/hf_checkpoint.py`` (head dims the kernels take),
      each through ``cli.run`` on the card and on the CPU, fp32 with TF32
      off; final latents within 2e-3, frames above 40 dB.

  E.  training slice: the full-width CogVideoX-5b DiT (bf16, frozen, random
      weights from a seed) with rank-8 LoRA adapters attached to the block
      linears (fp32 adapters and AdamW state), remat on, synthetic batch of
      one: 4 train steps at 9 frames (S = 4,276), the last under
      ``torch.profiler`` (the ten device kernels that take the most time,
      each with its share of the step, and the device's idle share), and 1
      at 49 frames (S = 17,776) through ``make_cogvideox_vpred_loss`` ->
      ``make_lora_loss`` -> ``make_train_step``; checks finite loss and
      gradient norm, that every adapter moved, that the base weights did
      not, and the exact kernel launch counts of a step; then the same
      recipe through the training
      entry point, ``alg_tpu_torch.train_cli.run`` over a parsed config on
      its defaults for the card (its own full-width random DiT, synthetic
      9-frame examples prefetched to the device, bf16 compute, 3 steps, a
      checkpoint, the peft export, and ``--resume`` for a fourth step), with
      the same launch counts a step;
  E2. agreement: a small CogVideoX LoRA run of 3 steps on the card through
      the kernels and on the CPU through the plain versions, fp32 with TF32
      off; losses within rtol 1e-4, adapters within atol 1e-4 (AdamW eps
      1e-4), and, with no optimizer between, the gradients of one loss at
      adapters with A and B nonzero within 1e-4 of each leaf's largest value.
  G.  the fine-tuning workflow, prepare -> train -> merge, over checkpoint
      directories written from a seed on the card: G1, a CogVideoX-5b-I2V
      checkpoint at the published widths (phase F's cut: DiT 2 of 42 layers,
      T5-XXL 2 of 24); ``prepare_cli.run`` over a manifest of 3 seeded uint8
      480x720 clips (one of 51 frames, cut to 49): keys, shapes and dtypes
      of ``alg_tpu``'s ``.npz`` files, exact launches, each example's T5 and
      VAE encode times and peak memory; ``train_cli.run`` over the same
      directory on those latents (no ``--random_init``): one example held
      out, 4 steps, an evaluation every 2, rank 8, remat, bf16 compute and
      ``--profile_dir``: finite losses and two validation means, exact
      launches (the steps' and the validation forwards'), each step's time,
      the trace naming the port's kernels; then ``cli.run --lora`` with the
      adapters at phase F's cut: every adapted linear of the merged DiT
      differs from the base and the rest is bit-equal, the video is written,
      exact launches. G2, a Wan2.1-I2V-14B checkpoint at the published
      widths (``hf_checkpoint.WAN21_I2V_14B``: DiT 2 of 40 layers, UMT5-XXL
      2 of 24, CLIP ViT-H and the VAE whole): ``prepare_cli.run`` over two
      seeded 81-frame 480x832 clips, the second with ``"flf2v": true``
      (shapes, the mask blocks, the encode times including the two tiled
      81-frame encodes, the peak), then 2 LoRA steps over the directory at
      81 frames (S = 32,760), remat, bf16, with exact launches. G3, a small
      CogVideoX and a small Wan checkpoint (phase F2's) through
      ``prepare_cli.run`` on the card and on the CPU, fp32 with TF32 off:
      every array within atol 1e-4 + rtol 1e-4, the mask blocks exact.
  F3, G4. A CogVideoX-1.5-5B-I2V checkpoint at the published widths
      (``hf_checkpoint.COGVIDEOX15_5B_I2V``, DiT and T5-XXL cut to 2 layers):
      F3, ``cli.run`` over it at phase C5's cut (loaded bit for bit, exact
      launches, 9 written 768x1360 frames); G4, ``prepare_cli.run`` over one seeded 85-frame 768x1360 clip (22
      latent frames), then 2 LoRA steps of ``train_cli.run`` over the
      directory at S = 45,106 (the LSE, dq and dkv at [1, 48, 45106, 64]),
      with exact launches.
  S.  serving (``serving.serve_batch`` under ``serve_cli.run``, the
      HTTP daemon's ``BatchingWorker``): S1, phase F's CogVideoX-5b-I2V
      checkpoint through ``serve_cli.run`` with two requests (seeds 42 and
      7, two prompts, seeded uint8 images) in one batch at phase C's cut:
      parameters bit for bit, exact launches (the CFG batch of both requests
      rides in each forward: one request's counts), two written videos that
      differ; the seed-42 request alone (B = 1) against it in the batch (PSNR
      and max|diff|, printed); the time a request takes at B = 1 and at B = 2
      and the batch's peak memory. S2, the same for phase G2's Wan2.1-I2V-14B
      checkpoint at 9 frames, 480x832 (CLIP ViT-H once a request). S3,
      ``hf_checkpoint.HUNYUAN_VIDEO_I2V`` cut to 2 double, 2 single and 2
      refiner blocks and Llava to 2 + 2 layers (CLIP text and VAE whole),
      written on the card: ``cli.run`` with the shipped config at phase C3's
      cut on a 352x608 image (360p buckets it to itself), then
      ``serve_cli.run`` with two requests bucketed from the first; the
      loaded pipeline's image processor is phase C3's seeded stand-in (Llava's
      CLIP preprocessing of an image that is not 336 x 336 needs PIL). S4,
      a ``BatchingWorker`` with ``max_batch=2`` on S1's pipeline: three
      requests from threads run as micro-batches of 2 and 1, each bit for bit
      a ``serve_batch`` of the same micro-batch. S5, small CogVideoX, Wan and
      HunyuanVideo checkpoints (head dims the kernels take) through
      ``serve_batch`` with two requests on the card and on the CPU, fp32 with
      TF32 off: final latents within 2e-3, frames above 40 dB, and each
      request's card output within the same bounds of it served alone.

  Q.  the opt-in W8A8 / W4A8 linears and QLoRA (``ops/quant.py``; no hand
      kernel: the int8 product is ``torch._int_mm``), after S: Q1, the
      linear in bf16 at CogVideoX-5b's [35552, 3072] -> 3072 and 12288 and
      [35552, 12288] -> 3072, Wan's [65520, 5120] -> 13824 and Hunyuan's
      modulation [1, 3072] -> 18432 (the padded path): the int32
      accumulators bit-equal to the int8 operands' fp64 product on the
      card, 24 rows against the CPU's plain version, the drift from bf16
      ``F.linear`` under ``tests/test_quant.py``'s 2% (w8) and 20% (w4) of its
      largest value, and the times of ``F.linear``, the W8A8 and W4A8
      calls, the activation quantizer, ``_int_mm``, ``w4_to_int8`` and the
      epilogue beside their bounds (1,979 TOP/s int8, 989 TFLOP/s bf16,
      3.35 TB/s); Q2, phase C's full-width CogVideoX-5b-I2V pipeline at its
      cut in bf16, then ``quantize_pipeline`` w8 and w4 (the DiT drawn again
      for w4): each call's latents against the bf16 run's
      (``tests/test_quant.py``'s correlation and mean|d| / RMS), the DiT's
      bytes, and the 49-frame 2-pass forward in bf16 and under W8A8, timed
      and profiled; Q3, ``cli.run --quantize w8`` over phase F's checkpoint,
      ``serve_cli.run --quantize w4`` over S2's Wan directory and ``--quantize
      w8`` over S3's Hunyuan directory, each bit for bit the same run over
      ``quantize_pipeline`` of the unquantized load, exact launches; Q4,
      ``train_cli.run --mode lora --quantize w8`` over that Hunyuan
      directory at ``configs/train/qlora_hunyuan_smoke.yaml``'s 17 frames,
      320x480, then at full depth with ``--random_init``: the 12.82 B
      Hunyuan DiT (w8, modulation too) and CogVideoX-5b (w4), built block by
      block on the card, 2 steps each: step times, peak memory, trainable
      values, and no gradient in the base; Q5, small checkpoints of the
      three families through ``serve_batch`` under w8 and w4 and one QLoRA
      step, card against CPU in fp32, each quantized linear call of the
      card fed the input and output of the CPU's (a code that rounds the
      other way at a tie moves a row by 1/127 of its largest value) and its
      own input held within 1e-4 of the fed one (``tests/quant_feed.py``):
      latents within 2e-3 and frames above 40 dB; the loss within rtol 1e-5,
      the gradients within 1e-4 of each leaf's largest, and the step within
      atol 1e-5 of the CPU's optimizer on the card's gradients (AdamW lr
      1e-2, eps 1e-4).
  H.  the HunyuanVideo prepare: H1, ``HUNYUAN_VIDEO_I2V`` cut as S3 cuts it,
      ``prepare_cli.run`` over one seeded 129-frame 352x608 clip passed as an
      array at the generated size (Llava's image processor C3's seeded one):
      stage times, peak memory, the example's shapes; H2, a small HunyuanVideo
      checkpoint through ``prepare_cli.run`` card against CPU in fp32.
  M.  multi-device (``alg_tpu_torch/sharding``) on the one card: M1, the
      ring of ``ops.attention._ring_attention_local`` with one process
      playing the sp ranks in turn (an injected rotation hands over the
      previous rank's chunk), each launching the bf16 forward with its LSE
      once a chunk, at ``[2,48,17776,64]`` and the Hunyuan joint
      ``[1,24,28128,128]`` with ``kv_len`` (one row's chunks wholly past it)
      at sp = 2 and 4: against the ring over
      ``tensor_core_attention_plain`` and one whole kernel call within one
      bf16 step, a rank's launches and time against the one call; M2, a
      world of one rank with an NCCL process group (every collective the
      identity, so none runs): ``train_cli.run(mesh=make_mesh())`` over H1's
      example bit for bit against the unsharded run and with a peak memory
      not above it, ``serve_batch(mesh=make_mesh())`` of the three families
      at the published widths (2 DiT layers) bit for bit against
      ``mesh=None``, and ``serve_cli --dp 1 --tp 1`` under ``torchrun
      --nproc_per_node 1``.

``python3 chip_smoke.py --dense-flash`` builds the kernels and times only rope
at ``[2,40,32760,128]``, ``[1,24,28128,128]`` and ``[2,40,4680,128]`` in bf16
(with its device time from ``torch.profiler``), qk_prep in bf16 at
``[2,48,17776,64]`` and ``[2,48,4276,64]`` (device time; on a contiguous
input, then on the head-split view beside the transposing copy it saves),
``flash_attention_int8`` in bf16 and in fp32, in both modes, at ``[2,48,17776,64]`` and
``[2,40,32760,128]`` (the call with its quantizers, and the kernel's device
time, beside fp32 SDPA with TF32 off and the bf16 flash kernel on the same
values), the bf16 DiT calls at ``[3,48,18002,64]`` and ``[2,48,45106,64]``, the
Wan DiT's three bf16 attentions of a 3-pass step at ``[3,40,32760,128]`` (self,
cross to 512 and to 257 keys), the
dense flash calls of phase B at head dims 64 and 128 (each bf16 call on the
Hopper forward beside the ``"tc"`` kernel on the same tensors, through
its entry point, and SDPA), the fp32 CLIP calls
``[1,16,257,80]`` and ``[1,12,77,64]`` (causal), the qk prolog calls of
phase B at ``[2,48,4276,64]`` (LayerNorm + RoPE) and ``[1,24,3048,128]`` (RMS
norm + RoPE, ``kv_len``) in bf16 and fp32 beside the unfused sequence, and
the training kernels at
``[1,48,17776,64]`` and ``[1,40,4680,128]`` in bf16 and fp32 (for comparing
two trees on one card, the parent's too: it does not require the
tensor-core kernels; it prints no result line). ``python3 chip_smoke.py
--cli`` builds the kernels and runs phases F and F2 alone, ``python3
chip_smoke.py --finetune`` phase G alone, ``python3 chip_smoke.py
--cogvideox15`` phase B's CogVideoX-1.5 shapes, C5, F3, G4 and D4 alone,
``python3 chip_smoke.py --serve`` phases S1-S5 alone, ``python3 chip_smoke.py
--quant`` phases Q1-Q5 alone, ``python3 chip_smoke.py --multi`` phases H and M
alone (none of them prints a result line).

Prints the card's name and power limit first, a JSON line of kernel records
before the last line (one entry a kernel; the tensor-core forward, dq and
dkv kernels (bf16 records), the CUDA-core ones (fp32 records), the int8
kernel's two entry points (bf16 records, fp32 records) and
the qk prolog kernel (the prolog calls' records along),
have entries of their own; ``launches_by_path`` names the run each count
comes from, the int8 runs of the three pipelines among them; ``also``
carries the other shapes and modes), and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits nonzero, without that line, if there is no CUDA device, the port
cannot be imported, or any phase fails.
"""

from __future__ import annotations

import copy
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


def _card_state() -> str:
    """SM clock, power draw and temperature now: a long forward that ran at a lower clock shows here."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout.strip() else "not read"


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


def _device_ms(fn, kernel: str, reps: int = 20, flush_l2: bool = False):
    """Mean device milliseconds of one launch of the kernels whose name holds
    ``kernel`` (``fn`` launches one of them a call), from ``torch.profiler``
    over ``reps`` calls (one warm-up): their device time over the launches
    the profiler saw, since it may miss some; None where it saw none. With
    ``flush_l2`` a 256 MB buffer is written before each call, so that the
    kernel finds its inputs in device memory and not in the 50 MB L2. The
    CUDA-event time of one call also holds the wrapper's host path when the
    device waits for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda") if flush_l2 else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if kernel in e.key]
    us, launches = sum(getattr(e, "device_time_total", 0) for e in seen), sum(e.count for e in seen)
    if launches != reps:
        print(f"    (torch.profiler saw {launches} of the {reps} launches of {kernel})", flush=True)
    return us / launches / 1e3 if us > 0 else None


def _set_tf32(matmul: bool, cudnn: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    print(f"  TF32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)


# ---------------------------------------------------------------------------
# A. build
# ---------------------------------------------------------------------------


# The tensor-core kernels: the C entry point that launches them, a part of their kernels' mangled names, the
# tensor-core instructions each must hold (HMMA: bf16 products by mma.sync; HGMMA: bf16 warpgroup products by
# wgmma; IMMA: int8 products) and those it must not. "flash_fwd_tc_kernelI" is the mma.sync forward alone (its
# template arguments follow the name), "flash_fwd_tc_kernel_wgmmaILi64E" and "...ILi128E" the Hopper forward at
# each head dim (its first template argument). The
# int8 kernel's instantiations by mode and output type: "qk" (template arguments false, bf16) takes QKᵀ in int8
# and P·V in bf16, "full" both in int8 in either type; fp32 "qk" (false, float) QKᵀ in int8 and P·V in exact fp32
# FMAs, so no HMMA (a TF32 or bf16 product) may appear in it.
TC_KERNELS = {"alg_flash_attention_tc_fwd_d<D>": ("flash_fwd_tc_kernelI", ("HMMA",), ("HGMMA",)),
              "alg_flash_attention_wgmma_fwd_d64": ("flash_fwd_tc_kernel_wgmmaILi64E", ("HGMMA",), ("HMMA",)),
              "alg_flash_attention_wgmma_fwd_d128": ("flash_fwd_tc_kernel_wgmmaILi128E", ("HGMMA",), ("HMMA",)),
              "alg_flash_attention_bwd_dq_tc_d<D>": ("flash_bwd_dq_tc_kernel", ("HMMA",), ()),
              "alg_flash_attention_bwd_dkv_tc_d<D>": ("flash_bwd_dkv_tc_kernel", ("HMMA",), ()),
              "alg_flash_attention_int8_tc_d<D> qk": ("flash_int8_tc_kernelILb0E13__nv_bfloat16E", ("IMMA", "HMMA"),
                                                      ()),
              "alg_flash_attention_int8_tc_d<D> full": ("flash_int8_tc_kernelILb1E13__nv_bfloat16E", ("IMMA",), ()),
              "alg_flash_attention_int8_tc_fp32_d<D> qk": ("flash_int8_tc_kernelILb0EfE", ("IMMA",), ("HMMA",)),
              "alg_flash_attention_int8_tc_fp32_d<D> full": ("flash_int8_tc_kernelILb1EfE", ("IMMA",), ())}


def _sass_hmma(lib) -> dict:
    """{kernel: {"HMMA": n, "HGMMA": g, "IMMA": m}}, the tensor-core instructions in the SASS of every kernel of
    the built library (``cuobjdump -sass``)."""
    import re
    from pathlib import Path

    from alg_tpu_torch.ops import _build

    proc = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass failed: {proc.stderr[-2000:]}")
    counts, current = {}, None
    for line in proc.stdout.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            current = found.group(1)
            counts[current] = {"HMMA": 0, "HGMMA": 0, "IMMA": 0}
        elif current is not None:
            for op in ("HMMA", "HGMMA", "IMMA"):
                if op in line:
                    counts[current][op] += 1
    return counts


# Kernels whose instantiations phase A names one by one, by a part of their mangled names: the register-tiled
# fp32 forward (csrc/flash_attention.cu; not the tensor-core forward), dq and dkv (csrc/flash_attention_bwd.cu;
# not the tensor-core ones), the bf16 tensor-core forward, the Hopper forward, the int8 kernel's four
# instantiations and the qk prolog kernel.
FP32_KERNELS = {"fp32 forward": r"\d+flash_fwd_kernelI", "fp32 dq": r"\d+flash_bwd_dq_kernelI",
                "fp32 dkv": r"\d+flash_bwd_dkv_kernel[EI]"}
RESOURCE_KERNELS = {**FP32_KERNELS, "bf16 tc forward": r"\d+flash_fwd_tc_kernelI",
                    "bf16 wgmma forward": r"\d+flash_fwd_tc_kernel_wgmmaI",
                    "int8 qk bf16": r"flash_int8_tc_kernelILb0E13__nv_bfloat16E",
                    "int8 full bf16": r"flash_int8_tc_kernelILb1E13__nv_bfloat16E",
                    "int8 qk fp32": r"flash_int8_tc_kernelILb0EfE", "int8 full fp32": r"flash_int8_tc_kernelILb1EfE",
                    "qk prolog": r"\d+qk_prolog_kernelI"}


def _kernel_resources(log: str) -> list:
    """Lines naming the registers and spilled bytes of every instantiation of
    the kernels of ``RESOURCE_KERNELS``, from the build log's ``ptxas -v``
    report (the head dim from the unit's ``-DALG_*_HEAD_DIM``, else from a
    kernel templated on it, the Hopper forward's ``ILi<D>E``; "-" for a unit
    of one head dim)."""
    import re

    lines, head_dim, kernel, props = [], None, None, None
    for line in log.splitlines():
        unit = re.search(r"-DALG_\w+_HEAD_DIM=(\d+)", line)
        if "nvcc" in line and " -c " in line:
            head_dim = unit.group(1) if unit else "-"
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            kernel, props = found.group(1), None
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            props = spill.groups()
        used = re.search(r"Used (\d+) registers", line)
        if used and kernel is not None:
            for what, pattern in RESOURCE_KERNELS.items():
                if re.search(pattern, kernel):
                    stores, loads = props or ("?", "?")
                    templated = re.search(r"wgmmaILi(\d+)E", kernel)
                    dim = templated.group(1) if head_dim == "-" and templated else head_dim
                    lines.append(f"[A] {what} D={dim} {kernel}: {used.group(1)} registers, {stores} bytes spill "
                                 f"stores, {loads} bytes spill loads")
            kernel = None
    return lines


def phase_build(require_tensor_cores: bool = True) -> None:
    """Build the library, print the compiler's resource report and, from the
    SASS, the HMMA and IMMA (tensor-core) instructions of every kernel of the
    tensor-core entry points; fail if one lacks those it must hold (``require_tensor_cores``
    False only prints them: ``--dense-flash`` also times trees without those
    kernels)."""
    from alg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    units = _build.compile_units()
    print(f"[A] built {path.name} in {time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS[:2])}, "
          f"{len(units)} compile units: {', '.join(stem for stem, _, _ in units)})")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("    " + line.strip())
        for line in _kernel_resources(log.read_text()):
            print(line)
    sass = _sass_hmma(path)
    for entry, (part, wanted, unwanted) in TC_KERNELS.items():
        kernels = {name: n for name, n in sass.items() if part in name}
        for name, n in sorted(kernels.items()):
            print(f"[A] {entry}: {n['HMMA']} HMMA, {n['HGMMA']} HGMMA and {n['IMMA']} IMMA instructions in {name}")
        if require_tensor_cores and (not kernels or not all(n[op] for n in kernels.values() for op in wanted)
                                     or any(n[op] for n in kernels.values() for op in unwanted)):
            raise AssertionError(f"{entry}: kernels {kernels} (want each with {' and '.join(wanted)} instructions"
                                 + (f" and none of {' or '.join(unwanted)}" if unwanted else "") + ")")


# ---------------------------------------------------------------------------
# B. kernels against their plain versions
# ---------------------------------------------------------------------------

# bf16: the kernel rounds once at the end where the plain version rounds
# after each op (qk_prep, rope) or rounds P to bf16 (attention) — up to about
# two bf16 ulps at unit scale, hence atol 2e-2 plus rtol 1e-2 for larger
# values. fp32: only the summation order differs (64-wide norms, up to
# 32,760-key softmax sums), so a few fp32 ulps.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (2e-5, 1e-5)}
# Attention averages over its keys, so its outputs are far below unit scale
# (about 0.02 at 4,680 keys, 0.01 at 32,760): in bf16 the absolute part of
# its tolerance is tied to the output's size, 5% of the reference's mean
# magnitude and never above the 2e-2 of unit scale. One bf16 step of the
# output stays inside the rtol; the rounding of P moves an output by under 1%
# of its typical size, so a kernel that dropped or mis-weighted even 1% of
# the keys would be out.
FLASH_BF16_ATOL_SHARE = 0.05


def tol_name(dtype) -> str:
    return str(dtype).split(".")[-1]


# Published peaks of one H100 SXM (dense): device memory rate, and operations
# per second by the type the inputs come in (fp32 outside the tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def _bound(ops: float, nbytes: float, dtype: str):
    """(least milliseconds the card could take, "bytes" | "operations")."""
    ops_ms, bytes_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def _report(records, name, dtype, shape, err, ok, tol, ms, plain_ms, bound, library_ms=None, ref_size=None):
    lib = "" if library_ms is None else f"  sdpa {library_ms:.3f} ms"
    size = "" if ref_size is None else f", mean|ref| {ref_size:.3e}"
    print(f"[B] {name:<22} {dtype:<8} {str(shape):<24} max|diff| {err:.3e} "
          f"(atol {tol[0]:.3g}, rtol {tol[1]:g}{size}) kernel {ms:.3f} ms  plain {plain_ms:.3f} ms{lib}  "
          f"bound {bound[0]:.4f} ms ({bound[1]})  {'PASS' if ok else 'FAIL'}", flush=True)
    records.append(dict(name=name, dtype=dtype, shape=list(shape), max_abs_err=err, ok=ok, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms))


def _close(a, b, tol):
    import torch

    a, b = a.float(), b.float()
    diff = (a - b).abs()
    return diff.max().item(), bool((diff <= tol[0] + tol[1] * b.abs()).all())  # tol[0]: a number or a tensor


def _qk_case(records, shape, dtype, gen, text_len=226, reps=5):
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
    ms = _time_ms(lambda: qk_norm_rope(x, scale, bias, cos, sin, 1e-6), reps)
    plain_ms = _time_ms(lambda: qk_norm_rope_plain(x, scale, bias, cos, sin, 1e-6), reps)
    nbytes = 2 * x.numel() * x.element_size() + 4 * (cos.numel() + sin.numel() + scale.numel() + bias.numel())
    bound = _bound(12 * x.numel(), nbytes, tol_name(dtype))  # about 12 operations a value, fp32 CUDA cores
    _report(records, "qk_prep", tol_name(dtype), shape, err, ok and id_ok, tol, ms, plain_ms, bound)
    device_ms = _device_ms(lambda: qk_norm_rope(x, scale, bias, cos, sin, 1e-6), "qk_prep_kernel")
    records[-1]["device_ms"] = device_ms
    print(f"[B]   qk_prep {tol_name(dtype)} {shape}: device time a launch "
          f"{'not measured' if device_ms is None else f'{device_ms:.4f} ms'} (torch.profiler)", flush=True)


def _rope_case(records, shape, dtype, gen, reps=5, identity_suffix=None):
    """Kernel vs plain on the view the Wan DiT passes, the [B, S, H, D]
    projection seen as [B, H, S, D]; with ``identity_suffix`` on what the
    Hunyuan DiT passes: a contiguous [B, H, S, D] whose last
    ``identity_suffix`` rows (the text) have cos = 1, sin = 0."""
    import torch

    from alg_tpu_torch.ops.rope import apply_rope_interleaved, rope_interleaved

    b, h, s, d = shape
    dev = "cuda"
    ang = torch.rand(s, d // 2, generator=gen, device=dev) * 6.28
    if identity_suffix is None:
        x = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
    else:
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        ang[s - identity_suffix:] = 0.0
    cos = torch.cos(ang).repeat_interleave(2, -1).contiguous()
    sin = torch.sin(ang).repeat_interleave(2, -1).contiguous()
    tol = TOL[tol_name(dtype)]
    out = rope_interleaved(x, cos, sin)
    err, ok = _close(out, apply_rope_interleaved(x, cos, sin), tol)
    if identity_suffix is not None:  # identity rows come back as they went in
        ok = ok and bool(torch.equal(out[:, :, s - identity_suffix:], x[:, :, s - identity_suffix:]))
    ms = _time_ms(lambda: rope_interleaved(x, cos, sin), reps)
    plain_ms = _time_ms(lambda: apply_rope_interleaved(x, cos, sin), reps)
    nbytes = 2 * x.numel() * x.element_size() + 4 * (cos.numel() + sin.numel())
    bound = _bound(3 * x.numel(), nbytes, tol_name(dtype))  # 2 multiplies and an add a value, fp32 CUDA cores
    name = "rope_interleaved" if identity_suffix is None else "rope_hunyuan_joint"
    _report(records, name, tol_name(dtype), shape, err, ok, tol, ms, plain_ms, bound)
    device_ms = _device_ms(lambda: rope_interleaved(x, cos, sin), "rope_kernel")
    records[-1]["device_ms"] = device_ms
    print(f"[B]   {name} {tol_name(dtype)} {shape}: device time a launch "
          f"{'not measured' if device_ms is None else f'{device_ms:.4f} ms'} (torch.profiler)", flush=True)


def _attn_case(records, name, shape_q, dtype, gen, scale, stable, sk=None, with_bias=False, kv_len=None,
               causal=False, reps=3):
    """Kernel vs plain attention, and the time of one
    ``scaled_dot_product_attention`` call on the same tensors (bias,
    ``kv_len`` and a causal mask beside ``kv_len`` as its ``attn_mask``; a
    causal mask alone as ``is_causal``); a call on the Hopper kernel's route
    (``"wgmma"``) also times it and the ``"tc"`` kernel it replaced on the
    same tensors through their entry points alone, in turns (a call under a
    millisecond 50 times back to back, its device time rather than the host's
    per call). The plain version, which holds the
    fp32 logits, runs over query chunks (per batch element) of at most
    2 GiB of logits; a causal chunk takes the keys up to its last row's
    limit, which keeps the diagonal where it is. In bf16 the absolute
    tolerance follows the size of the reference's values
    (``FLASH_BF16_ATOL_SHARE``), chunk by chunk, and under the causal mask
    row by row; the smallest one used is printed beside the reference's mean
    magnitude."""
    import torch
    import torch.nn.functional as F

    from alg_tpu_torch.ops import flash_attention as FA
    from alg_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    b, h, sq, d = shape_q
    sk = sq if sk is None else sk
    if causal and sq > sk:
        raise ValueError("the causal cases here have Sq <= Sk (every row sees a key)")
    dev = "cuda"
    q = torch.randn(shape_q, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, h, sk, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    bias = 0.5 * torch.randn((1, h, sq, sk), generator=gen, device=dev) if with_bias else None
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=dev)
    tol = TOL[tol_name(dtype)]
    q_chunk = max(1, min(sq, 2 ** 29 // (h * sk)))
    causal_kw = dict(causal=True) if causal else {}  # a dense call names no option of the causal variant

    def kernel():
        return flash_attention(q, k, v, scale, bias=bias, stable=stable, kv_len=lens, **causal_kw)

    def plain_chunks():
        for bi in range(b):
            for i in range(0, sq, q_chunk):
                sl = (slice(bi, bi + 1), slice(i, i + q_chunk))
                n = min(sq, i + q_chunk) + sk - sq if causal else sk  # keys the chunk's last row may see
                bsl = None if bias is None else bias[:, :, i:i + q_chunk, :n]
                yield sl, attention_plain(q[sl[0], :, sl[1]], k[sl[0], :, :n], v[sl[0], :, :n], scale, bsl,
                                          None if lens is None else lens[sl[0]], **causal_kw)

    def plain():
        for _ in plain_chunks():
            pass

    mask = None
    if bias is not None or lens is not None:
        mask = torch.zeros((b if lens is not None else 1, 1, sq, sk), device=dev) if bias is None else bias
        if lens is not None:
            keep = torch.arange(sk, device=dev)[None, :] < lens[:, None]
            mask = mask.masked_fill(~keep[:, None, None, :], float("-inf"))
        if causal:
            hidden = torch.arange(sk, device=dev)[None, :] > torch.arange(sq, device=dev)[:, None] + (sk - sq)
            mask = mask.masked_fill(hidden, float("-inf"))
        mask = mask.to(dtype)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale,
                                              is_causal=causal and mask is None)

    out = kernel()
    err, ok, atol, sizes = 0.0, True, tol[0], []
    for (bs, qs), ref in plain_chunks():
        size = ref.float().abs().mean().item()
        if dtype != torch.bfloat16:
            chunk_atol = tol[0]
        elif causal:  # query i averages i + 1 + Sk - Sq values: the share of the size is taken row by row
            chunk_atol = (FLASH_BF16_ATOL_SHARE * ref.float().abs().mean(dim=(1, 3), keepdim=True)).clamp(max=tol[0])
        else:
            chunk_atol = min(tol[0], FLASH_BF16_ATOL_SHARE * size)
        e, o = _close(out[bs, :, qs], ref, (chunk_atol, tol[1]))
        err, ok, atol = max(err, e), ok and o, min(atol, float(torch.as_tensor(chunk_atol).min()))
        sizes.append(size)
    ms = _time_ms(kernel, reps=reps)
    plain_ms = _time_ms(plain, reps=reps)
    library_ms = _time_ms(library, reps=reps)  # a yardstick only: the port never calls it
    entry_ms = {}  # a tree without the Hopper forward (copied there by --dense-flash) has no "wgmma" route
    if "wgmma" in FA.flash_attention.launches_by_route and FA.kernel_route(dtype, d, bias is not None) == "wgmma":
        entry_out = torch.empty_like(q)
        # both bf16 kernels through their entry points alone, in turns, so that neither pays the wrapper's host
        # time; a call under a millisecond is launched 50 times back to back, so that its device time shows
        launches = 1 if ms > 1.0 else 50

        def entries(which):
            for _ in range(launches):
                rc = FA._entry(d, which)(FA._build.DTYPE_CODE[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                         0, None if lens is None else lens.data_ptr(), entry_out.data_ptr(), None, b,
                                         h, sq, sk, float(scale), int(stable), int(causal),
                                         torch.cuda.current_stream().cuda_stream)
                FA._build.check(rc, f"the {which} flash kernel")

        for which in ("tc", "wgmma", "wgmma", "tc"):
            entry_ms.setdefault(which, []).append(_time_ms(lambda: entries(which), reps=reps) / launches)
    # what this call's data needs: batch row b reads its first min(kv_len[b], Sk) keys and values and as
    # many columns of the bias (one bias for all batch rows: the most any row needs); q and the output whole.
    # Under the causal mask query i multiplies only with its first min(kept, i + Sk - Sq + 1) keys.
    kept = [sk] * b if kv_len is None else [min(n, sk) for n in kv_len]
    nbytes = (2 * q.numel() + 2 * h * sum(kept) * d) * q.element_size() \
        + (0 if bias is None else 4 * h * sq * max(kept)) + (0 if lens is None else 4 * b)
    pairs = sum(sum(min(n, i + sk - sq + 1) for i in range(sq)) if causal else sq * n for n in kept)
    bound = _bound(4.0 * h * pairs * d, nbytes, tol_name(dtype))
    shape = tuple(shape_q) if sk == sq else (b, h, f"{sq}->{sk}", d)
    _report(records, name, tol_name(dtype), shape, err, ok, (atol, tol[1]), ms, plain_ms, bound, library_ms,
            ref_size=statistics.fmean(sizes))
    if entry_ms:
        wgmma_ms, tc_ms = min(entry_ms["wgmma"]), min(entry_ms["tc"])
        records[-1].update(wgmma_entry_ms=wgmma_ms, tc_ms=tc_ms)
        print(f"[B] {name:<22} entry points alone ({launches} launches back to back, in turns): wgmma "
              f"{', '.join(f'{t:.4f}' for t in entry_ms['wgmma'])} ms ({bound[0] / wgmma_ms:.1%} of the bound) against "
              f"the tc kernel {', '.join(f'{t:.4f}' for t in entry_ms['tc'])} ms ({bound[0] / tc_ms:.1%}); sdpa "
              f"{library_ms:.3f} ms ({bound[0] / library_ms:.1%}); {_card_line()}", flush=True)


# The HunyuanVideo path's sequence lengths, as the pipeline's prompt bookkeeping gives them (phase C3
# checks that its run has these): Llava sees the 359-token template row with the <image> token widened to
# 576 positions; the DiT's text is every second image position and the 252 prompt positions left by the crop.
HY_PROMPT_TOKENS = 27  # the tokenizer stand-in's length of PROMPT: three ids a word
HY_LLAMA_LEN, HY_LLAMA_KEYS = 359 + 575, 103 + HY_PROMPT_TOKENS + 5 + 575
HY_TEXT_LEN, HY_TEXT_KEYS = 288 + 252, 288 + HY_PROMPT_TOKENS + 1
HY_VIDEO_TOKENS = {9: 3 * 22 * 38, 129: 33 * 22 * 38}  # frames -> tokens at 352 x 608


def _hunyuan_kernel_cases(records, gen) -> None:
    """The shapes phase C3 launches, in its dtypes, the joint call also in
    fp32 and at the shipped 129 frames, and a square causal call beside the
    same call without the mask."""
    import torch

    bf16, fp32 = torch.bfloat16, torch.float32
    _set_tf32(False, False)
    _attn_case(records, "flash_llama_causal_kvlen", (1, 32, HY_LLAMA_LEN, 128), bf16, gen, 128 ** -0.5, True,
               kv_len=[HY_LLAMA_KEYS], causal=True, reps=5)
    _attn_case(records, "flash_clip_text_causal", (1, 12, 77, 64), fp32, gen, 64 ** -0.5, True, causal=True, reps=5)
    _attn_case(records, "flash_clip_l_vision", (1, 16, 577, 64), bf16, gen, 64 ** -0.5, True, reps=5)
    _attn_case(records, "flash_hunyuan_refiner", (1, 24, HY_TEXT_LEN, 128), bf16, gen, 128 ** -0.5, True,
               kv_len=[HY_TEXT_KEYS], reps=5)
    for frames, dtypes in ((9, (bf16, fp32)), (129, (bf16,))):
        s = HY_VIDEO_TOKENS[frames] + HY_TEXT_LEN
        for dtype in dtypes:
            _rope_case(records, (1, 24, s, 128), dtype, gen, identity_suffix=HY_TEXT_LEN)
            _attn_case(records, "flash_hunyuan_joint", (1, 24, s, 128), dtype, gen, 128 ** -0.5, False,
                       kv_len=[HY_VIDEO_TOKENS[frames] + HY_TEXT_KEYS], reps=3 if frames == 9 else 1)
        torch.cuda.empty_cache()
    for causal in (False, True, True, False):  # in turns
        _attn_case(records, "flash_square_causal" if causal else "flash_square_dense", (1, 32, 4096, 128), bf16,
                   gen, 128 ** -0.5, True, causal=causal, reps=5)
    torch.cuda.empty_cache()


# The forward's LSE: base-2 units; kernel and plain version sum the same fp32 logits (from the same bf16
# or fp32 inputs) in another order, so one absolute bound serves both dtypes; in bf16 at D = 64 and 80 the
# sum is of the bf16-rounded p, and a p on a rounding tie adds tensor_core_lse_plain's `tie`.
LSE_ATOL = 1e-4


def _attn_bwd_case(records, name, shape_q, dtype, gen, scale, stable=False, sk=None, kv_len=None, causal=False,
                   reps=3):
    """The training kernels on one attention shape: the forward's LSE output
    against the plain residual version, and the dq and dkv kernels against
    their plain versions, all over query chunks of at most 2 GiB of logits as
    in :func:`_attn_case` (dk and dv summed over the chunks in fp32). The
    yardstick for dq + dkv together is the backward of one
    ``scaled_dot_product_attention`` call under autograd, on the same
    tensors. In bf16 the absolute tolerance of a gradient follows the size of
    the reference's values (``FLASH_BF16_ATOL_SHARE``), row by row under the
    causal mask; the yardstick for the LSE call is that call's forward on
    inputs that require a gradient. Records ``<name>`` prefixed flash_lse_,
    flash_bwd_dq_ and flash_bwd_dkv_."""
    import torch
    import torch.nn.functional as F

    from alg_tpu_torch.ops import flash_attention as FA
    from alg_tpu_torch.ops.flash_attention import attention_plain_residuals, flash_attention
    from alg_tpu_torch.ops.flash_attention_bwd import (flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
                                                       flash_attention_bwd_dq, flash_attention_bwd_dq_plain,
                                                       row_delta)

    b, h, sq, d = shape_q
    sk = sq if sk is None else sk
    dev = "cuda"
    q, do = (torch.randn(shape_q, generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, h, sk, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=dev)
    tol = TOL[tol_name(dtype)]
    q_chunk = max(1, min(sq, 2 ** 29 // (h * sk)))
    chunks = [(slice(bi, bi + 1), slice(i, min(sq, i + q_chunk))) for bi in range(b) for i in range(0, sq, q_chunk)]

    def keys_of(qs):  # keys a causal chunk's last row may see: cutting there keeps the diagonal where it is
        return max(0, qs.stop + sk - sq) if causal else sk

    def forward():
        return flash_attention(q, k, v, scale, stable=stable, kv_len=lens, causal=causal, return_residuals=True)

    # the LSE's plain version is the kernel's denominator: in bf16 the tensor-core forward's, the TPU kernel's
    # (at D = 64 and 80 the sum of the bf16-rounded p, where a p on a rounding tie adds `tie` to the bound);
    # a tree without tensor_core_lse_plain sums the fp32 p in both types
    tc_lse = getattr(FA, "tensor_core_lse_plain", None) if dtype == torch.bfloat16 else None

    def plain_forward():
        lse, tie = (torch.zeros((b, h, sq), dtype=torch.float32, device=dev) for _ in range(2))
        for bs, qs in chunks:
            n = keys_of(qs)
            if n == 0:
                lse[bs, :, qs] = float("-inf")
                continue
            args = (q[bs, :, qs], k[bs, :, :n], scale, None, None if lens is None else lens[bs], causal)
            if tc_lse is not None:
                lse[bs, :, qs], tie[bs, :, qs] = tc_lse(*args, stable=stable)
            else:
                lse[bs, :, qs] = attention_plain_residuals(args[0], args[1], v[bs, :, :n], *args[2:])[1]
        return lse, tie

    out, lse = forward()
    ref_lse, tie = plain_forward()
    finite = torch.isfinite(ref_lse)
    lse_err = (lse[finite] - ref_lse[finite]).abs().max().item() if bool(finite.any()) else 0.0
    lse_ok = bool(((lse - ref_lse).abs()[finite] <= LSE_ATOL + tie[finite]).all()) \
        and bool(torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse)))
    delta = row_delta(out, do)

    def plain_dq():
        dq = torch.empty_like(q)
        for bs, qs in chunks:
            n = keys_of(qs)
            if n == 0:
                dq[bs, :, qs] = 0
                continue
            dq[bs, :, qs] = flash_attention_bwd_dq_plain(
                q[bs, :, qs], k[bs, :, :n], v[bs, :, :n], do[bs, :, qs], lse[bs, :, qs], delta[bs, :, qs], scale,
                causal, None if lens is None else lens[bs])
        return dq

    def plain_dkv():
        dk, dv = (torch.zeros(k.shape, dtype=torch.float32, device=dev) for _ in range(2))
        for bs, qs in chunks:
            n = keys_of(qs)
            if n == 0:
                continue
            # fp32 copies of k and v, so that the chunks' parts add up in fp32
            pk, pv = flash_attention_bwd_dkv_plain(
                q[bs, :, qs], k[bs, :, :n].float(), v[bs, :, :n].float(), do[bs, :, qs], lse[bs, :, qs],
                delta[bs, :, qs], scale, causal, None if lens is None else lens[bs])
            dk[bs, :, :n] += pk
            dv[bs, :, :n] += pv
        return dk.to(dtype), dv.to(dtype)

    def close(got, ref):
        # never tighter than the fp32 bound: where a gradient cancels (a query with one visible key has
        # ds = dp - delta = 0 in exact arithmetic) the reference is rounding noise and its size says nothing
        size, floor = ref.float().abs().mean().item(), TOL["float32"][0]
        if dtype != torch.bfloat16:
            atol = tol[0]
        elif causal:
            atol = (FLASH_BF16_ATOL_SHARE * ref.float().abs().mean(dim=(1, 3), keepdim=True)).clamp(floor, tol[0])
        else:
            atol = max(floor, min(tol[0], FLASH_BF16_ATOL_SHARE * size))
        err, ok = _close(got, ref, (atol, tol[1]))
        return err, ok and bool(torch.isfinite(got).all()), float(torch.as_tensor(atol).min()), size

    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal, lens)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal, lens)
    torch.cuda.synchronize()
    dq_err, dq_ok, dq_atol, dq_size = close(dq, plain_dq())
    ref_dk, ref_dv = plain_dkv()
    dk_err, dk_ok, dk_atol, dk_size = close(dk, ref_dk)
    dv_err, dv_ok, dv_atol, dv_size = close(dv, ref_dv)
    del ref_dk, ref_dv

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    mask = None
    if lens is not None:
        keep = torch.arange(sk, device=dev)[None, :] < lens[:, None]
        mask = torch.zeros((b, 1, sq, sk), device=dev).masked_fill(~keep[:, None, None, :], float("-inf"))
        if causal:
            hidden = torch.arange(sk, device=dev)[None, :] > torch.arange(sq, device=dev)[:, None] + (sk - sq)
            mask = mask.masked_fill(hidden, float("-inf"))
        mask = mask.to(dtype)
    def library_forward():  # on inputs that require grad it keeps its log-sum-exp for the backward, as the LSE call does
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale,
                                              is_causal=causal and mask is None)

    lib_out = library_forward()

    def library():  # the backward alone, as dq + dkv are
        return torch.autograd.grad(lib_out, (qg, kg, vg), do, retain_graph=True)

    lse_ms = _time_ms(forward, reps)
    fwd_ms = _time_ms(lambda: flash_attention(q, k, v, scale, stable=stable, kv_len=lens, causal=causal), reps)
    lse_plain_ms = _time_ms(plain_forward, reps)
    dq_ms = _time_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal, lens), reps)
    dkv_ms = _time_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal, lens), reps)
    dq_plain_ms, dkv_plain_ms = _time_ms(plain_dq, reps), _time_ms(plain_dkv, reps)
    library_ms = _time_ms(library, reps)
    del lib_out
    library_fwd_ms = _time_ms(library_forward, reps)

    # what this call's data needs (see _attn_case): dq three products over the visible pairs, dkv four
    kept = [sk] * b if kv_len is None else [min(n, sk) for n in kv_len]
    pairs = sum(sum(max(0, min(n, i + sk - sq + 1)) for i in range(sq)) if causal else sq * n for n in kept)
    es, rows = q.element_size(), 2 * 4 * b * h * sq + (0 if lens is None else 4 * b)  # lse and delta, kv_len
    kv_bytes = h * sum(kept) * d * es
    name_dt = tol_name(dtype)
    shape = tuple(shape_q) if sk == sq else (b, h, f"{sq}->{sk}", d)
    print(f"[B] {name}: forward without the LSE {fwd_ms:.3f} ms, with it {lse_ms:.3f} ms (sdpa's forward under "
          f"autograd {library_fwd_ms:.3f} ms); sdpa backward {library_ms:.3f} ms beside dq + dkv "
          f"{dq_ms + dkv_ms:.3f} ms")
    _report(records, "flash_lse_" + name, name_dt, shape, lse_err, lse_ok, (LSE_ATOL, 0.0), lse_ms, lse_plain_ms,
            _bound(4.0 * h * pairs * d, 2 * q.numel() * es + 2 * kv_bytes + rows // 2, name_dt), library_fwd_ms)
    _report(records, "flash_bwd_dq_" + name, name_dt, shape, dq_err, dq_ok, (dq_atol, tol[1]), dq_ms, dq_plain_ms,
            _bound(6.0 * h * pairs * d, 3 * q.numel() * es + 2 * kv_bytes + rows, name_dt), library_ms,
            ref_size=dq_size)
    _report(records, "flash_bwd_dkv_" + name, name_dt, shape, max(dk_err, dv_err), dk_ok and dv_ok,
            (min(dk_atol, dv_atol), tol[1]), dkv_ms, dkv_plain_ms,
            _bound(8.0 * h * pairs * d, 2 * q.numel() * es + 4 * kv_bytes + rows, name_dt), library_ms,
            ref_size=min(dk_size, dv_size))


def _training_kernel_cases(records, gen) -> None:
    """The attention shapes of a training step (batch of one) of each family."""
    import torch

    _set_tf32(False, False)
    s_hy = HY_VIDEO_TOKENS[9] + HY_TEXT_LEN
    for dtype in (torch.bfloat16, torch.float32):
        _attn_bwd_case(records, "dit", (1, 48, 4276, 64), dtype, gen, 64 ** -0.5)
        _attn_bwd_case(records, "dit", (1, 48, 17776, 64), dtype, gen, 64 ** -0.5, reps=1)
        _attn_bwd_case(records, "wan_self", (1, 40, 4680, 128), dtype, gen, 128 ** -0.5)
        _attn_bwd_case(records, "wan_cross_text", (1, 40, 4680, 128), dtype, gen, 128 ** -0.5, sk=512)
        _attn_bwd_case(records, "hunyuan_joint", (1, 24, s_hy, 128), dtype, gen, 128 ** -0.5,
                       kv_len=[HY_VIDEO_TOKENS[9] + HY_TEXT_KEYS])
        _attn_bwd_case(records, "square_causal", (1, 32, 4096, 128), dtype, gen, 128 ** -0.5, stable=True, causal=True)
        _attn_bwd_case(records, "kvlen_zero_row", (2, 8, 515, 64), dtype, gen, 64 ** -0.5, kv_len=[0, 300])
        torch.cuda.empty_cache()


# Published int8 tensor-core rate of one H100 SXM (dense), for the int8 products' bounds.
PEAK_INT8_OPS_PER_S = PEAK_OPS_PER_S["int8"]
# The int8 kernel against its plain version. fp32 inputs (its fp32 entry), "qk": the same codes and
# scales, only the order of the fp32 sums differs. "full": a P code on a rounding tie may flip (one code is
# 1/127 of a row's largest p), so the mean and the largest difference are bounded, as in the JAX package's own
# tests. bf16 inputs (its bf16 entry), "qk": one bf16 step of the plain version (rtol 2**-7, atol
# 2**-7 of the output's mean magnitude), since both round P to bf16 alike and differ only in the order of the
# fp32 sums of P·V and in the plain version's rounding of that product to bf16; "full": the bf16 attention
# tolerance above.
INT8_QK_TOL = (2e-5, 2e-5)
INT8_FULL_MEAN, INT8_FULL_MAX = 1e-5, 2e-3
BF16_STEP = 2.0 ** -7  # one bf16 step at x is at most BF16_STEP·|x|
# The JAX package's bounds on the drift of int8 attention against exact attention, over the exact output's
# rms, on DiT-like inputs: (mean, max) by mode, the wider of its D = 64 and D = 128 bounds. A record here.
INT8_DRIFT_BOUNDS = {False: (2e-2, 1.5e-1), True: (3e-2, 3e-1)}


def _dit_like_qkv(shape, dtype, gen):
    """q and k with unit-norm rows times sqrt(D), as after a per-head norm, a
    common-mode offset on k (what the mean-centring removes), normal v."""
    import torch

    b, h, s, d = shape
    q, k = (torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
    q, k = (t / t.norm(dim=-1, keepdim=True) * d ** 0.5 for t in (q, k))
    k = k + 3.0 * torch.randn((b, h, 1, d), generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _int8_bound(shape, kept, pv_int8, element_size, with_kv_len):
    """(least ms, what bounds it) of one int8 call: QKᵀ at the int8 rate plus P·V at the rate of the inputs'
    type ("qk": bf16 on the tensor cores, fp32 FMAs outside them) or the int8 rate ("full") over the visible
    pairs, or the bytes of q, k, v and the output if that is more."""
    b, h, s, d = shape
    pairs = sum(s * n for n in kept)
    pv_rate = PEAK_INT8_OPS_PER_S if pv_int8 else PEAK_OPS_PER_S["float32" if element_size == 4 else "bfloat16"]
    ops_ms = (2.0 * h * pairs * d / PEAK_INT8_OPS_PER_S + 2.0 * h * pairs * d / pv_rate) * 1e3
    nbytes = (2 * b * h * s * d + 2 * h * sum(kept) * d) * element_size + (4 * b if with_kv_len else 0)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def _int8_shape_cases(records, tag, shape, gen, kv_len=None, reps=3, tile_block=False):
    """The int8 kernel at one shape, on one draw of bf16 values: its bf16
    route on the bf16 tensors and its fp32 route on the same values in fp32,
    both modes, each against ``flash_attention_int8_plain``
    on the card (taken over groups of batch·heads, one block of query rows at
    a time), with its drift against exact fp32 attention, its bound, the
    quantizers' own time (they run inside every call; printed apart, with the
    transposed copy of V's codes that "full" mode makes), the bf16 flash kernel and ``scaled_dot_product_attention`` in
    the call's type (fp32 with TF32 off) on the same values. The plain version's time is that of the one run
    that is compared. ``tile_block`` also times "full" mode with ``block_k``
    equal to the kernels' key tile, where a key block is staged once."""
    import torch
    import torch.nn.functional as F

    from alg_tpu_torch.ops.flash_attention import attention_plain, flash_attention
    from alg_tpu_torch.ops.flash_attention_int8 import (KEY_TILE, flash_attention_int8, flash_attention_int8_plain,
                                                        pv_codes_for_tc, quantize_qk_int8, quantize_v_int8, route)

    b, h, s, d = shape
    scale = d ** -0.5
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    kept = [s] * b if kv_len is None else [min(n, s) for n in kv_len]
    group = max(1, min(h, 2 ** 19 // s))  # heads a plain call takes: [group, 512, S] fp32 logits (1 GiB) and a few like it
    qb, kb, vb = _dit_like_qkv(shape, torch.bfloat16, gen)
    bf16_ms = _time_ms(lambda: flash_attention(qb, kb, vb, scale, stable=False, kv_len=lens), reps)
    # exact attention in fp32 on the same values, for the drift, kept on the card as the inputs' dtype allows
    exact = torch.empty(shape, dtype=torch.float32, device="cuda")
    q_chunk = max(1, min(s, 2 ** 28 // (group * s)))
    for bi in range(b):
        for h0 in range(0, h, group):
            sl = (slice(bi, bi + 1), slice(h0, h0 + group))
            kf, vf = kb[sl].float(), vb[sl].float()
            for i in range(0, s, q_chunk):
                exact[sl][:, :, i:i + q_chunk] = attention_plain(qb[sl][:, :, i:i + q_chunk].float(), kf, vf, scale,
                                                                 None, None if lens is None else lens[bi:bi + 1])
    rms = exact.pow(2).mean().sqrt().item()
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(dtype) for t in (qb, kb, vb))
        name_dt = tol_name(dtype)
        # the yardstick in the type of the call (fp32 with TF32 off), a dense mask for kv_len
        mask = None
        if lens is not None:
            keep = torch.arange(s, device="cuda")[None, :] < lens[:, None]
            mask = torch.zeros((b, 1, s, s), device="cuda").masked_fill(~keep[:, None, None, :],
                                                                        float("-inf")).to(dtype)
        sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale), reps)
        del mask
        quant_qk_ms = _time_ms(lambda: quantize_qk_int8(q, k, scale, 512, 1024, lens), reps)
        quant_v_ms = _time_ms(lambda: quantize_v_int8(v, lens), reps)
        v_codes = quantize_v_int8(v, lens)[0]
        transpose_ms = _time_ms(lambda: pv_codes_for_tc(v_codes), reps) if dtype == torch.bfloat16 else 0.0
        del v_codes
        for pv_int8 in (False, True):
            mode = "full" if pv_int8 else "qk"
            which = route(q, pv_int8)
            out = flash_attention_int8(q, k, v, scale, pv_int8=pv_int8, kv_len=lens)
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(out).all())
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ref = flash_attention_int8_plain(q, k, v, scale, pv_int8=pv_int8, kv_len=lens)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            size = ref.float().abs().mean().item()
            diff = (out.float() - ref.float()).abs()
            err, err_mean = diff.max().item(), diff.mean().item()
            if dtype == torch.bfloat16 and not pv_int8:
                tol = (BF16_STEP * size, BF16_STEP)
                ok = ok and bool((diff <= tol[0] + tol[1] * ref.float().abs()).all())
            elif dtype == torch.bfloat16:
                tol = (min(TOL["bfloat16"][0], FLASH_BF16_ATOL_SHARE * size), TOL["bfloat16"][1])
                ok = ok and bool((diff <= tol[0] + tol[1] * ref.float().abs()).all())
            elif not pv_int8:
                tol = INT8_QK_TOL
                ok = ok and bool((diff <= tol[0] + tol[1] * ref.abs()).all())
            else:
                tol = (INT8_FULL_MAX, 0.0)
                ok = ok and err < INT8_FULL_MAX and err_mean < INT8_FULL_MEAN
            del ref, diff
            drift = (out.float() - exact).abs()
            drift_mean, drift_max = drift.mean().item() / rms, drift.max().item() / rms
            del drift
            ms = _time_ms(lambda: flash_attention_int8(q, k, v, scale, pv_int8=pv_int8, kv_len=lens), reps)
            bound = _int8_bound(shape, kept, pv_int8, q.element_size(), lens is not None)
            quant_ms = quant_qk_ms + (quant_v_ms + transpose_ms if pv_int8 else 0.0)
            limits = INT8_DRIFT_BOUNDS[pv_int8]
            print(f"[B] int8 {mode:<4} {tag:<14} {name_dt:<8} {str(shape):<22} route {which}: mean|diff| "
                  f"{err_mean:.3e}; drift against exact attention over its rms: mean {drift_mean:.3e} (reference's "
                  f"bound {limits[0]:g}), max {drift_max:.3e} ({limits[1]:g}); quantizers {quant_ms:.3f} ms of the "
                  f"kernel's time (q and k {quant_qk_ms:.3f}"
                  + (f", v {quant_v_ms:.3f}" + (f", v's codes transposed {transpose_ms:.3f}" if transpose_ms else "")
                     if pv_int8 else "")
                  + f"); bf16 flash kernel on the same values in bf16 {bf16_ms:.3f} ms", flush=True)
            _report(records, f"flash_int8_{mode}_{tag}", name_dt, shape, err, ok, tol, ms, plain_ms, bound, sdpa_ms,
                    ref_size=size)
            records[-1].update(drift_mean=drift_mean, drift_max=drift_max, quantizers_ms=quant_ms,
                               bf16_flash_ms=bf16_ms, route=which)
        if tile_block:
            tile_ms = _time_ms(lambda: flash_attention_int8(q, k, v, scale, block_k=KEY_TILE, pv_int8=True,
                                                            kv_len=lens), reps)
            tile_out = flash_attention_int8(q, k, v, scale, block_k=KEY_TILE, pv_int8=True, kv_len=lens)
            tile_drift = (tile_out.float() - exact).abs()
            print(f"[B] int8 full {tag:<14} {name_dt:<8} {str(shape):<22} with block_k = {KEY_TILE} (one staging a "
                  f"key block): kernel {tile_ms:.3f} ms beside {ms:.3f} ms at block_k = 1024; drift mean "
                  f"{tile_drift.mean().item() / rms:.3e}, max {tile_drift.max().item() / rms:.3e}", flush=True)
            records.append(dict(name=f"flash_int8_full_bk{KEY_TILE}_{tag}", dtype=name_dt, shape=list(shape),
                                max_abs_err=None, ok=bool(torch.isfinite(tile_out).all()), ms=tile_ms, plain_ms=None,
                                bound_ms=bound[0], bound_by=bound[1], library_ms=sdpa_ms))
            del tile_out, tile_drift
        del q, k, v, out
        torch.cuda.empty_cache()
    del qb, kb, vb, exact
    torch.cuda.empty_cache()


def _int8_kernel_cases(records, gen) -> None:
    """The int8 kernel at the self-attention shapes of the three DiTs, at 9
    frames and at the shipped lengths, and one call with ``kv_len`` 0 in a
    batch row."""
    import torch

    _set_tf32(False, False)
    # the plain version's bf16 P·V with fp32 partial sums, as the kernel's (cuBLAS may otherwise reduce in bf16)
    kept = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _int8_shape_cases(records, "dit", (2, 48, 4276, 64), gen, tile_block=True)
    _int8_shape_cases(records, "dit", (2, 48, 17776, 64), gen, reps=1, tile_block=True)
    _int8_shape_cases(records, "wan_self", (2, 40, 4680, 128), gen)
    _int8_shape_cases(records, "wan_self", (2, 40, 32760, 128), gen, reps=1)
    for frames in (9, 129):
        _int8_shape_cases(records, "hunyuan_joint", (1, 24, HY_VIDEO_TOKENS[frames] + HY_TEXT_LEN, 128), gen,
                          kv_len=[HY_VIDEO_TOKENS[frames] + HY_TEXT_KEYS], reps=3 if frames == 9 else 1,
                          tile_block=frames == 9)
    _int8_shape_cases(records, "kvlen_zero_row", (2, 8, 1100, 64), gen, kv_len=[0, 700])
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = kept


# The five combinations of norm, RoPE, `stable` and `prolog_k` that the JAX package's own prolog test runs.
PROLOG_MODES = (("layer", True, False, True), ("rms", True, True, True), (None, True, False, True),
                ("layer", False, False, True), ("layer", True, False, False))
PROLOG_FP32_TOL = (5e-6, 1e-5)  # the same ops in another order: norms over D values, softmax sums over the keys


def _prolog_case(records, shape, dtype, gen, mode, has_rope, stable, prolog_k, kv_len=None, reps=3,
                 transform_record=True):
    """The flash call with the qk prolog (the ``qk_prolog`` kernel on q and k,
    then the forward kernel of the dtype) against ``apply_prolog_plain`` and
    the plain attention (over query chunks, as in :func:`_attn_case`), and
    beside it the time of the unfused sequence a DiT runs today for the same
    result where there is one: ``qk_norm_rope`` on q and on k (LayerNorm +
    RoPE at D = 64), or the RMS norm in PyTorch ops and ``rope_interleaved``
    on q and on k (D = 128), then ``flash_attention``; and the device time
    (``torch.profiler``) of the call's prolog kernel and of its forward
    kernel. With ``transform_record`` also a record of the ``qk_prolog``
    kernel alone against ``apply_prolog_plain`` at its byte bound. Only
    public functions in the call and the unfused sequence, so that one
    script times two trees."""
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.ops.flash_attention import apply_prolog_plain, attention_plain, flash_attention
    from alg_tpu_torch.ops.qk_prep import qk_norm_rope
    from alg_tpu_torch.ops.rope import rope_interleaved

    b, h, s, d = shape
    dev, scale = "cuda", d ** -0.5
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
    ang = torch.rand(s, d // 2, generator=gen, device=dev) * 6.28
    cos, sin = (f(ang).repeat_interleave(2, -1).contiguous() for f in (torch.cos, torch.sin))
    qs, ks = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev) for _ in range(2))
    qb, kb = (0.1 * torch.randn(d, generator=gen, device=dev) for _ in range(2))
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=dev)
    prolog = {"norm": mode, "eps": 1e-6, "q_scale": qs, "q_bias": qb, "k_scale": ks, "k_bias": kb,
              "cos": cos if has_rope else None, "sin": sin if has_rope else None}
    qr, kr = apply_prolog_plain(q, k, prolog)
    k_in = k if prolog_k else kr  # the caller brings k transformed when only the q side is fused
    kwargs = dict(qk_norm=mode, norm_eps=1e-6, q_norm_scale=qs if mode else None,
                  q_norm_bias=qb if mode == "layer" else None, k_norm_scale=ks if mode and prolog_k else None,
                  k_norm_bias=kb if mode == "layer" and prolog_k else None, rope_cos=prolog["cos"],
                  rope_sin=prolog["sin"], prolog_k=prolog_k)

    def fused():
        return flash_attention(q, k_in, v, scale, stable=stable, kv_len=lens, **kwargs)

    q_chunk = max(1, min(s, 2 ** 29 // (h * s)))

    def plain_chunks():
        for bi in range(b):
            q2, k2 = apply_prolog_plain(q[bi:bi + 1], k[bi:bi + 1], prolog)
            for i in range(0, s, q_chunk):
                yield (slice(bi, bi + 1), slice(i, i + q_chunk)), attention_plain(
                    q2[:, :, i:i + q_chunk], k2, v[bi:bi + 1], scale, None, None if lens is None else lens[bi:bi + 1])

    def plain():
        for _ in plain_chunks():
            pass

    unfused = None
    if prolog_k and has_rope and (mode, d) == ("layer", 64):
        def unfused():
            return flash_attention(qk_norm_rope(q, qs, qb, cos, sin, 1e-6), qk_norm_rope(k, ks, kb, cos, sin, 1e-6), v,
                                   scale, stable=stable, kv_len=lens)
    elif prolog_k and has_rope and (mode, d) == ("rms", 128):
        def unfused():
            return flash_attention(rope_interleaved(L.t5_layer_norm(q, qs, 1e-6), cos, sin),
                                   rope_interleaved(L.t5_layer_norm(k, ks, 1e-6), cos, sin), v, scale, stable=stable,
                                   kv_len=lens)

    out = fused()
    tol = TOL["bfloat16"] if dtype == torch.bfloat16 else PROLOG_FP32_TOL
    err, ok, atol, sizes = 0.0, bool(torch.isfinite(out).all()), tol[0], []
    for (bs, qsl), ref in plain_chunks():
        size = ref.float().abs().mean().item()
        chunk_atol = min(tol[0], FLASH_BF16_ATOL_SHARE * size) if dtype == torch.bfloat16 else tol[0]
        e, o = _close(out[bs, :, qsl], ref, (chunk_atol, tol[1]))
        err, ok, atol = max(err, e), ok and o, min(atol, chunk_atol)
        sizes.append(size)
    ms, plain_ms = _time_ms(fused, reps), _time_ms(plain, reps)
    kept = [s] * b if kv_len is None else [min(n, s) for n in kv_len]
    # the call's bytes: q, the keys and values each row reads, the output, the tables and the affines, once each;
    # the transform's: q (and k) read and written once, the tables and the affines read once; about 12 operations
    # a transformed value on the CUDA cores
    table_bytes = 4 * (2 * s * d if has_rope else 0) + 4 * 4 * d
    nbytes = (2 * q.numel() + 2 * h * sum(kept) * d) * q.element_size() + table_bytes
    bound = _bound(4.0 * h * sum(s * n for n in kept) * d, nbytes, tol_name(dtype))
    transformed = q.numel() * (2 if prolog_k else 1)
    transform_bound = _bound(12.0 * transformed, 2 * transformed * q.element_size() + table_bytes, tol_name(dtype))
    suffix = "_".join(filter(None, (mode, "rope" if has_rope else None, "stable" if stable else None,
                                    None if prolog_k else "q_only")))
    name = "flash_prolog_" + suffix
    prolog_dev = _device_ms(fused, "qk_prolog_kernel", reps=max(reps, 10))  # the profiler misses a first few
    forward_dev = _device_ms(fused, "flash_fwd", reps=max(reps, 10))
    fmt = lambda t: "not measured" if t is None else f"{t:.4f} ms"  # noqa: E731
    print(f"[B] {name} {tol_name(dtype)} {shape}: device time of the call's prolog kernel {fmt(prolog_dev)} "
          f"(bound {transform_bound[0]:.4f} ms, {transform_bound[1]}), of its forward kernel {fmt(forward_dev)} "
          f"(torch.profiler)", flush=True)
    if unfused is not None:
        unfused_ms = _time_ms(unfused, reps)
        bare_ms = _time_ms(lambda: flash_attention(qr, kr, v, scale, stable=stable, kv_len=lens), reps)
        print(f"[B] {name} {tol_name(dtype)} {shape}: prolog + forward {ms:.3f} ms; the unfused sequence (norm and "
              f"RoPE on q and on k, then the flash kernel) {unfused_ms:.3f} ms "
              f"({'at most' if ms <= unfused_ms else 'ABOVE'} it), of which the flash kernel alone {bare_ms:.3f} ms",
              flush=True)
    _report(records, name, tol_name(dtype), shape, err, ok, (atol, tol[1]), ms, plain_ms, bound,
            ref_size=statistics.fmean(sizes))
    records[-1].update(prolog_device_ms=prolog_dev, forward_device_ms=forward_dev)
    if unfused is not None:
        records[-1].update(unfused_ms=unfused_ms, flash_alone_ms=bare_ms)
    if transform_record:
        _qk_prolog_record(records, suffix, q, k, prolog, prolog_k, qr, kr if prolog_k else None, transform_bound,
                          reps)


# bf16: the qk prolog kernel is its plain version bit for bit but where a norm result lies on a rounding tie (the
# statistics are summed in another order): a value on a tie moves by one bf16 step, and the rotation's roundings
# of its products and their sum by about one more, so two bf16 steps of the row's largest value at most, on a few
# values.
QK_PROLOG_BF16_SHARE = 1e-3  # the share of values that may differ


def _qk_prolog_record(records, suffix, q, k, prolog, prolog_k, qr, kr, bound, reps):
    """The ``qk_prolog`` kernel alone against ``apply_prolog_plain`` (``qr``,
    ``kr``; kr None without ``prolog_k``), its time, the plain version's and
    its device time (``torch.profiler``) beside ``bound``."""
    import torch

    from alg_tpu_torch.ops.flash_attention import apply_prolog_plain, qk_prolog

    got = qk_prolog(q, k, prolog, prolog_k)
    pairs = [(got[0], qr)] + ([(got[1], kr)] if prolog_k else [])
    dtype = tol_name(q.dtype)
    err, ok, differ, total = 0.0, got[1] is k or prolog_k, 0, 0
    for g, w in pairs:
        diff = (g.float() - w.float()).abs()
        err = max(err, diff.max().item())
        if q.dtype == torch.bfloat16:
            differ += int((g != w).sum())
            total += g.numel()
            ok = ok and bool((diff <= 2.0 ** -6 * w.float().abs().amax(-1, keepdim=True)).all())
        else:
            ok = ok and bool((diff <= PROLOG_FP32_TOL[0] + PROLOG_FP32_TOL[1] * w.float().abs()).all())
    if q.dtype == torch.bfloat16:
        ok = ok and differ <= QK_PROLOG_BF16_SHARE * total
        tol = (0.0, 2.0 ** -6)
    else:
        tol = PROLOG_FP32_TOL
    del got
    ms = _time_ms(lambda: qk_prolog(q, k, prolog, prolog_k), reps=max(reps, 10))
    plain_ms = _time_ms(lambda: apply_prolog_plain(q, k, prolog, prolog_k), reps=max(reps, 10))
    _report(records, "qk_prolog_" + suffix, dtype, tuple(q.shape), err, ok, tol, ms, plain_ms, bound)
    device_ms = _device_ms(lambda: qk_prolog(q, k, prolog, prolog_k), "qk_prolog_kernel", flush_l2=True)
    records[-1].update(device_ms=device_ms, values_that_differ=differ if q.dtype == torch.bfloat16 else None)
    share = "not measured" if device_ms is None else f"{bound[0] / device_ms:.1%} of its bound"
    print(f"[B]   qk_prolog_{suffix} {dtype} {tuple(q.shape)}: device time a launch "
          f"{'not measured' if device_ms is None else f'{device_ms:.4f} ms'} (torch.profiler, L2 flushed before "
          f"each launch; {share})"
          + (f"; {differ} of {total} values differ from the plain version (norm-rounding ties, at most two bf16 "
             f"steps of their row's largest)" if q.dtype == torch.bfloat16 else ""), flush=True)


def _prolog_kernel_cases(records, gen, transform_record=True, combinations=PROLOG_MODES) -> None:
    """The five combinations at the CogVideoX 9-frame shape, and RMS norm +
    RoPE at the Hunyuan 9-frame joint shape with ``kv_len``, bf16 and fp32."""
    import torch

    _set_tf32(False, False)
    s_hy = HY_VIDEO_TOKENS[9] + HY_TEXT_LEN
    for dtype in (torch.bfloat16, torch.float32):
        for mode, has_rope, stable, prolog_k in combinations:
            _prolog_case(records, (2, 48, 4276, 64), dtype, gen, mode, has_rope, stable, prolog_k,
                         transform_record=transform_record)
        _prolog_case(records, (1, 24, s_hy, 128), dtype, gen, "rms", True, False, True,
                     kv_len=[HY_VIDEO_TOKENS[9] + HY_TEXT_KEYS], transform_record=transform_record)
        torch.cuda.empty_cache()


def _qk_dense_case(records, shape, gen, reps=20) -> None:
    """qk_prep in bf16 on a contiguous input against its plain version, with
    its device time (``torch.profiler``); then on the [B, S, H, D] projection
    viewed as [B, H, S, D], which the CogVideoX DiT passes where the tree's
    wrapper takes it, beside the transposing copy that a tree whose wrapper
    refuses the view makes first. Public functions only, so that one script
    times two trees."""
    import torch

    from alg_tpu_torch.ops.qk_prep import qk_norm_rope

    _qk_case(records, shape, torch.bfloat16, gen, reps=reps)
    b, h, s, d = shape
    x = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
    scale, bias = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    tab = torch.ones(s, d, device="cuda")
    copy_ms = _device_ms(lambda: x.contiguous(), "elementwise_kernel")
    try:
        view_ms = _device_ms(lambda: qk_norm_rope(x, scale, bias, tab, tab, 1e-6), "qk_prep_kernel")
        view = f"{view_ms:.4f} ms" if view_ms is not None else "not measured"
    except ValueError:  # a wrapper that takes contiguous inputs only
        view = "not taken by this tree's wrapper"
    print(f"[dense] qk_prep bf16 {shape} on the transposed view: device time a launch {view}; the transposing copy "
          f"it saves: {'not measured' if copy_ms is None else f'{copy_ms:.4f} ms'} of device time (torch.profiler)",
          flush=True)


def _int8_dense_case(shape, gen, reps=3) -> None:
    """``flash_attention_int8`` on DiT-like inputs in bf16 and on the same
    values in fp32, in both modes, through its public function (quantizers
    included), and the device time of the kernel alone (``torch.profiler``),
    beside the bf16 flash kernel on the bf16 tensors and
    ``scaled_dot_product_attention`` in fp32 (TF32 off) on the fp32 ones, the
    yardstick of exact attention. Printed only: the outputs must be finite."""
    import torch
    import torch.nn.functional as F

    from alg_tpu_torch.ops.flash_attention import flash_attention
    from alg_tpu_torch.ops.flash_attention_int8 import flash_attention_int8

    qb, kb, vb = _dit_like_qkv(shape, torch.bfloat16, gen)
    scale = shape[-1] ** -0.5
    bf16_ms = _time_ms(lambda: flash_attention(qb, kb, vb, scale, stable=False), reps)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(dtype) for t in (qb, kb, vb))
        sdpa_ms = (_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps)
                   if dtype == torch.float32 else None)
        for pv_int8 in (False, True):
            out = flash_attention_int8(q, k, v, scale, pv_int8=pv_int8)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"int8 {shape} {dtype}: non-finite output")
            del out
            ms = _time_ms(lambda: flash_attention_int8(q, k, v, scale, pv_int8=pv_int8), reps)
            device_ms = _device_ms(lambda: flash_attention_int8(q, k, v, scale, pv_int8=pv_int8), "flash_int8",
                                   reps=reps)
            beside = (f"bf16 flash kernel on the same tensors {bf16_ms:.3f} ms" if sdpa_ms is None else
                      f"fp32 SDPA (TF32 off) on the same tensors {sdpa_ms:.3f} ms")
            print(f"[dense] int8 {'full' if pv_int8 else 'qk':<4} {tol_name(dtype):<8} {str(shape):<22} call {ms:.3f} "
                  f"ms (quantizers included), kernel device time "
                  f"{'not measured' if device_ms is None else f'{device_ms:.3f} ms'} (torch.profiler); {beside}",
                  flush=True)
        del q, k, v
    del qb, kb, vb
    torch.cuda.empty_cache()


def phase_dense_flash() -> None:
    """Only rope in bf16 at the shipped Wan and Hunyuan shapes and at 9 Wan
    frames, qk_prep in bf16 at the shipped and 9-frame CogVideoX shapes, the
    int8 kernel in bf16 and fp32 in both modes at the shipped CogVideoX and Wan
    self-attention shapes, the dense flash calls of phase B at head dims 64 and 128, the
    fp32 CLIP calls, the qk prolog calls of phase B at the CogVideoX (LayerNorm
    + RoPE) and Hunyuan (RMS norm + RoPE, ``kv_len``) 9-frame shapes in bf16 and
    fp32, and the training kernels (LSE, dq, dkv) at the 49-frame
    CogVideoX and 9-frame Wan self-attention shapes in bf16 and fp32, for
    timing two trees against each other on one card."""
    import torch

    records = []  # printed case by case; a comparison out of tolerance fails the phase
    gen = torch.Generator("cuda").manual_seed(0)
    _set_tf32(False, False)
    _rope_case(records, (2, 40, 32760, 128), torch.bfloat16, gen, reps=20)
    _rope_case(records, (1, 24, HY_VIDEO_TOKENS[129] + HY_TEXT_LEN, 128), torch.bfloat16, gen, reps=20,
               identity_suffix=HY_TEXT_LEN)
    _rope_case(records, (2, 40, 4680, 128), torch.bfloat16, gen, reps=20)
    _qk_dense_case(records, (2, 48, 17776, 64), gen)
    _qk_dense_case(records, (2, 48, 4276, 64), gen)
    _int8_dense_case((2, 48, 17776, 64), gen)
    _int8_dense_case((2, 40, 32760, 128), gen, reps=1)
    _attn_case(records, "flash_dit_b3", (3, 48, 18002, 64), torch.bfloat16, gen, 64 ** -0.5, False)
    _attn_case(records, "flash_dit", (2, 48, COGVIDEOX15_S[81], 64), torch.bfloat16, gen, 64 ** -0.5, False, reps=1)
    _wan_shipped_attention(records, gen, reps=3)
    for dtype in (torch.bfloat16, torch.float32):
        _attn_case(records, "flash_dit", (2, 48, 4276, 64), dtype, gen, 64 ** -0.5, False, reps=5)
        _attn_case(records, "flash_dit", (2, 48, 17776, 64), dtype, gen, 64 ** -0.5, False)
        _attn_case(records, "flash_wan_self", (2, 40, 4680, 128), dtype, gen, 128 ** -0.5, False, reps=5)
        _attn_case(records, "flash_wan_self", (2, 40, 32760, 128), dtype, gen, 128 ** -0.5, False, reps=1)
        torch.cuda.empty_cache()
    _attn_case(records, "flash_clip", (1, 16, 257, 80), torch.float32, gen, 80 ** -0.5, True, reps=20)
    _attn_case(records, "flash_clip_text_causal", (1, 12, 77, 64), torch.float32, gen, 64 ** -0.5, True,
               causal=True, reps=20)
    _prolog_kernel_cases(records, gen, transform_record=False, combinations=[("layer", True, False, True)])
    for dtype in (torch.bfloat16, torch.float32):
        _attn_bwd_case(records, "dit", (1, 48, 17776, 64), dtype, gen, 64 ** -0.5, reps=1)
        _attn_bwd_case(records, "wan_self", (1, 40, 4680, 128), dtype, gen, 128 ** -0.5)
        torch.cuda.empty_cache()
    if not all(r["ok"] for r in records):
        raise AssertionError("a dense flash comparison is out of tolerance")


def phase_kernels() -> list:
    import torch

    records = []
    gen = torch.Generator("cuda").manual_seed(0)
    bf16, fp32 = torch.bfloat16, torch.float32
    for dtype in (bf16, fp32):
        _set_tf32(False, False)
        # CogVideoX path
        for shape in ((2, 48, 4276, 64), (2, 48, 17776, 64)):
            _qk_case(records, shape, dtype, gen)
        _attn_case(records, "flash_t5_bias_stable", (1, 64, 226, 64), dtype, gen, 1.0, True, with_bias=True)
        _attn_case(records, "flash_dit", (2, 48, 4276, 64), dtype, gen, 64 ** -0.5, False)
        _attn_case(records, "flash_dit", (2, 48, 17776, 64), dtype, gen, 64 ** -0.5, False)
        if dtype == bf16:  # a 3-pass ALG step of the shipped config, on the Hopper forward
            _attn_case(records, "flash_dit_b3", (3, 48, 18002, 64), dtype, gen, 64 ** -0.5, False, reps=2)
        # Wan path: 9 frames (S = 4,680) and the shipped 81 frames (S = 32,760)
        for shape in ((2, 40, 4680, 128), (2, 40, 32760, 128)):
            _rope_case(records, shape, dtype, gen)
        if dtype == bf16:  # a 3-pass ALG step of the shipped config: its three attentions, on the Hopper forward
            _wan_shipped_attention(records, gen)
        _attn_case(records, "flash_wan_self", (2, 40, 4680, 128), dtype, gen, 128 ** -0.5, False)
        _attn_case(records, "flash_wan_self", (2, 40, 32760, 128), dtype, gen, 128 ** -0.5, False, reps=1)
        _attn_case(records, "flash_wan_cross_text", (2, 40, 4680, 128), dtype, gen, 128 ** -0.5, False, sk=512)
        _attn_case(records, "flash_wan_cross_image", (2, 40, 4680, 128), dtype, gen, 128 ** -0.5, False, sk=257)
        _attn_case(records, "flash_umt5_bias_kvlen", (2, 64, 512, 64), dtype, gen, 1.0, True, with_bias=True,
                   kv_len=[27, 1])
        torch.cuda.empty_cache()
    # the other shapes phase C2 launches, in its dtype: a 3-pass step's batch of 3, and UMT5 one prompt
    # at a time (the prompt's 27 tokens, the empty negative's 1)
    _rope_case(records, (3, 40, 4680, 128), bf16, gen)
    _attn_case(records, "flash_wan_self", (3, 40, 4680, 128), bf16, gen, 128 ** -0.5, False)
    _attn_case(records, "flash_wan_cross_text", (3, 40, 4680, 128), bf16, gen, 128 ** -0.5, False, sk=512)
    _attn_case(records, "flash_wan_cross_image", (3, 40, 4680, 128), bf16, gen, 128 ** -0.5, False, sk=257)
    for n in (27, 1):
        _attn_case(records, f"flash_umt5_bias_kvlen={n}", (1, 64, 512, 64), bf16, gen, 1.0, True, with_bias=True,
                   kv_len=[n])
    _attn_case(records, "flash_clip", (1, 16, 257, 80), fp32, gen, 80 ** -0.5, True)  # the tower runs in fp32
    _hunyuan_kernel_cases(records, gen)
    _training_kernel_cases(records, gen)
    _cogvideox15_kernel_cases(records, gen)
    _int8_kernel_cases(records, gen)
    _prolog_kernel_cases(records, gen)
    _ada_norm_cases(records, gen, dtypes=("bfloat16", "float32"))
    _require_all_ok(records)
    return records


def _wan_shipped_attention(records, gen, reps=1) -> None:
    """The Wan DiT's three bf16 attentions of a 3-pass step at the shipped 81 frames, 480 x 832: self-attention
    over the 32,760 video tokens, cross-attention to the 512 text and 257 image tokens."""
    import torch

    shape = (3, 40, 32760, 128)
    _attn_case(records, "flash_wan_self", shape, torch.bfloat16, gen, 128 ** -0.5, False, reps=reps)
    _attn_case(records, "flash_wan_cross_text", shape, torch.bfloat16, gen, 128 ** -0.5, False, sk=512, reps=reps)
    _attn_case(records, "flash_wan_cross_image", shape, torch.bfloat16, gen, 128 ** -0.5, False, sk=257, reps=reps)
    torch.cuda.empty_cache()


def _require_all_ok(records) -> None:
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel comparison(s) out of tolerance: {bad}")


# CogVideoX-1.5-5B-I2V's joint lengths at 768 x 1360: 226 text tokens and (latent frames / 2) x 48 x 85 video
# tokens; 9 frames are 3 latent frames padded to 4, the model card's 81 frames 21 padded to 22
COGVIDEOX15_S = {9: 226 + 2 * 48 * 85, 81: 226 + 11 * 48 * 85}


def _cogvideox15_kernel_cases(records, gen) -> None:
    """The kernels of the CogVideoX-1.5 path at its shapes, in bf16 (the
    path's dtype): qk_prep and the tensor-core forward at a 2-pass step's
    [2, 48, S, 64] for phase C5's 9 frames (S = 8,386) and the shipped 81
    (S = 45,106), then the LSE, dq and dkv of a train step at [1, 48, 45106,
    64] (phase G4's)."""
    import torch

    _set_tf32(False, False)
    for s in COGVIDEOX15_S.values():
        _qk_case(records, (2, 48, s, 64), torch.bfloat16, gen)
    _attn_case(records, "flash_dit", (2, 48, COGVIDEOX15_S[9], 64), torch.bfloat16, gen, 64 ** -0.5, False)
    _attn_case(records, "flash_dit", (2, 48, COGVIDEOX15_S[81], 64), torch.bfloat16, gen, 64 ** -0.5, False, reps=1)
    torch.cuda.empty_cache()
    _attn_bwd_case(records, "dit", (1, 48, COGVIDEOX15_S[81], 64), torch.bfloat16, gen, 64 ** -0.5, reps=1)
    torch.cuda.empty_cache()


# The cells' AdaLN chain at their shipped joint lengths: (tag, B, rows a stream (text, then video), d, the
# variants a block launches). Variants name the parts of a launch: "add" the residual add, "gate" the gated
# add, "norm" the LayerNorm, "affine" its fp32 affine, "mod" the modulation.
ADA_NORM_SHAPES = (
    ("cogvideox-49f", 2, (226, 17776), 3072, ("norm_affine_mod", "gate_norm_affine_mod", "gate")),
    ("cogvideox15-81f", 2, (226, 45106), 3072, ("norm_affine_mod", "gate_norm_affine_mod", "gate")),
    ("wan-81f", 3, (32760,), 5120, ("norm_mod", "gate_norm_affine", "add_norm_mod", "gate")),
)


def _ada_norm_inputs(gen, b, rows, d, variant, dtype, dev="cuda"):
    """``ada_norm``'s arguments for ``variant`` on the card, the vectors [B, 1, d] views of a [B, 6d] output."""
    import torch

    parts = set(variant.split("_"))
    xs = tuple(torch.randn((b, r, d), generator=gen, device=dev).to(dtype) for r in rows)
    mods = [(0.3 * torch.randn((b, 6 * d), generator=gen, device=dev)).to(dtype) for _ in rows]
    vec = lambda k: tuple(m[:, None, k * d:(k + 1) * d] for m in mods)  # noqa: E731
    affine = "affine" in parts
    return xs, dict(o=torch.randn((b, sum(rows), d), generator=gen, device=dev).to(dtype) if parts & {"add", "gate"}
                    else None, gates=vec(2) if "gate" in parts else None, scales=vec(1) if "mod" in parts else None,
                    shifts=vec(0) if "mod" in parts else None,
                    weight=(1 + 0.2 * torch.randn(d, generator=gen, device=dev)).to(dtype) if affine else None,
                    bias=(0.2 * torch.randn(d, generator=gen, device=dev)).to(dtype) if affine else None, eps=1e-6,
                    norm="norm" in parts)


def _ada_norm_bytes(xs, kw) -> int:
    """Bytes a launch must move: x read; o read and x' written with a residual add; y written with a norm; the
    vectors and the fp32 affine once a batch element."""
    elems = sum(x.numel() for x in xs)
    add = kw["o"] is not None
    vecs = sum(v.numel() for name in ("gates", "scales", "shifts") if kw[name] is not None for v in kw[name])
    return xs[0].element_size() * (elems * (1 + 2 * add + kw["norm"]) + vecs) + 8 * xs[0].shape[2] * (
        kw["weight"] is not None)


def _ada_norm_ok(xs, kw, got, want, dtype) -> tuple:
    """(largest difference of the normed rows, ok): the residuals bit for bit; the normed rows in fp32 within
    1e-5 + 1e-5·|ref|, in bf16 within one rounding step at the norm, widened by 2^-19 of the magnitudes that meet
    in its fp32 value (the row sums' order moves the statistics by a few fp32 ulps), carried through the
    modulation's roundings (that times 1 + scale, a step of the product, a step of the result)."""
    import torch

    from alg_tpu_torch.models import layers as L

    (res, y), (res_ref, y_ref) = got, want
    ok = all(torch.equal(a, r) for a, r in zip(res, res_ref))
    if y_ref is None:
        return 0.0, ok and y is None
    err = (y.float() - y_ref.float()).abs()
    if dtype == torch.float32:
        bound = 1e-5 + 1e-5 * y_ref.float().abs()
    else:
        def ulp(v):
            return torch.exp2(torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126))) - 7)

        ln = torch.cat([L.layer_norm(x, kw["weight"], kw["bias"], kw["eps"]) for x in res_ref], dim=1)
        mags = []
        for x in res_ref:
            xf = x.float()
            mean = xf.mean(-1, keepdim=True)
            mag = (xf.abs() + mean.abs()) * torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + kw["eps"])
            if kw["weight"] is not None:
                mag = mag * kw["weight"].float().abs() + kw["bias"].float().abs()
            mags.append(mag)
            del xf
        bound = ulp(ln) + 2.0 ** -19 * torch.cat(mags, dim=1)
        del mags
        if kw["scales"] is not None:
            s1 = torch.cat([(1 + sc).expand(x.shape) for sc, x in zip(kw["scales"], res_ref)], dim=1)
            bound = bound * s1.float().abs() + ulp(ln * s1) + ulp(y_ref)
        del ln
    return err.max().item(), ok and bool((err <= bound).all())


def _ada_norm_cases(records, gen, dtypes=("bfloat16",), reps=10) -> None:
    """The AdaLN chain kernel against its plain composition at the cells' shipped lengths, each variant a block
    launches: the kernel's time (CUDA events over one launch, and its device time by ``torch.profiler``), its
    bytes bound at 3.35 TB/s, the share of the bound it reaches, and the plain version's time."""
    import torch

    from alg_tpu_torch.ops.ada_norm import ada_norm, ada_norm_plain

    for dtype_name in dtypes:
        dtype = getattr(torch, dtype_name)
        for tag, b, rows, d, variants in ADA_NORM_SHAPES:
            for variant in variants:
                xs, kw = _ada_norm_inputs(gen, b, rows, d, variant, dtype)
                before = ada_norm.launches
                got = ada_norm(xs, **kw)
                torch.cuda.synchronize()
                launched = ada_norm.launches - before
                err, ok = _ada_norm_ok(xs, kw, got, ada_norm_plain(xs, **kw), dtype)
                del got
                ms = _time_ms(lambda: ada_norm(xs, **kw), reps)
                plain_ms = _time_ms(lambda: ada_norm_plain(xs, **kw), 3)
                device_ms = _device_ms(lambda: ada_norm(xs, **kw), "ada_norm_kernel")
                bound = _bound(0.0, _ada_norm_bytes(xs, kw), dtype_name)
                shape = (b, sum(rows), d)
                share = "not measured" if device_ms is None else f"{100 * bound[0] / device_ms:.1f}%"
                print(f"[B] ada_norm {variant:<21} {dtype_name:<8} {str(shape):<18} {tag:<16} max|diff| {err:.3e} "
                      f"(residuals bit for bit; normed rows within a rounding at the norm) launches {launched} "
                      f"kernel {ms:.4f} ms (device {'not measured' if device_ms is None else f'{device_ms:.4f}'} "
                      f"ms, {share} of the bound)  plain {plain_ms:.3f} ms  bound {bound[0]:.4f} ms ({bound[1]})  "
                      f"{'PASS' if ok and launched == 1 else 'FAIL'}", flush=True)
                records.append(dict(name=f"ada_norm {variant}", dtype=dtype_name, shape=list(shape), max_abs_err=err,
                                    ok=ok and launched == 1, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                                    bound_by=bound[1], library_ms=None, device_ms=device_ms))
                del xs, kw
                torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# C. the full-width slices through CogVideoXPipeline.__call__ and WanPipeline.__call__
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

    def __init__(self, batch: int = 1):
        self.rows = []  # (stage, ms, DiT ms or None)
        self._step = None  # [label, start, DiT ms]
        self.batch = batch  # requests a call serves: a k-pass step's DiT forward holds k times as many rows

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

    def hook_dit(self, dit, seq_len):
        """``seq_len(module, args)``: the DiT's sequence length for a forward's arguments."""
        import torch

        def pre(module, args):
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.close_step(now)
            self._step = [f"denoise step ({args[0].shape[0] // self.batch}-pass, S={seq_len(module, args)})", now,
                          None]

        def post(module, args, out):
            torch.cuda.synchronize()
            self._step[2] = (time.perf_counter() - self._step[1]) * 1e3

        return [dit.register_forward_pre_hook(pre), dit.register_forward_hook(post)]

    def hook_module(self, name, module):
        """Time every forward of ``module`` as a stage ``name``."""
        import torch

        start = []

        def pre(_module, _args):
            torch.cuda.synchronize()
            start.append(time.perf_counter())
            self.close_step(start[-1])

        def post(_module, _args, _out):
            torch.cuda.synchronize()
            self.rows.append((name, (time.perf_counter() - start.pop()) * 1e3, None))

        return [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

    def count(self, prefix):
        return sum(1 for name, _, _ in self.rows if name.startswith(prefix))


def _cog_seq_len(dit, args) -> int:
    """The CogVideoX DiT's joint [text; video] length for a forward's args (x [B, F, C, H, W], text [B, S_text,
    D]): F / patch_size_t temporal patches (1.5) of (H/p)·(W/p) tokens each."""
    cfg = dit.cfg
    return args[1].shape[1] + (args[0].shape[1] // (cfg.patch_size_t or 1)) * args[0].shape[3] * args[0].shape[4] \
        // cfg.patch_size ** 2


def _kernel_counters() -> dict:
    """{kernel name: (dict, key or keys) of its launch count}. A forward
    launch is counted twice: as a launch of the forward wrapper, and under
    the route its wrapper took (tensor cores, either the Hopper kernel or the
    mma.sync one, or CUDA cores); one that wrote the LSE also under that
    name. Likewise a dq, dkv or int8 launch, under its route. The qk prolog
    kernel has its own count."""
    from alg_tpu_torch.ops.flash_attention import flash_attention, qk_prolog
    from alg_tpu_torch.ops.flash_attention_bwd import flash_attention_bwd_dkv, flash_attention_bwd_dq
    from alg_tpu_torch.ops.flash_attention_int8 import flash_attention_int8
    from alg_tpu_torch.ops.qk_prep import qk_norm_rope
    from alg_tpu_torch.ops.rope import rope_interleaved

    fwd, dq = flash_attention.launches_by_route, flash_attention_bwd_dq.launches_by_route
    dkv = flash_attention_bwd_dkv.launches_by_route
    return {"qk_prep": (qk_norm_rope.__dict__, "launches"), "rope_interleaved": (rope_interleaved.__dict__, "launches"),
            "flash_attention": (flash_attention.__dict__, "launches"),
            "flash_attention_lse": (flash_attention.__dict__, "residual_launches"),
            "qk_prolog": (qk_prolog.__dict__, "launches"), "flash_attention_tc": (fwd, ("wgmma", "tc")),
            "flash_attention_cuda_core": (fwd, "cuda_core"),
            "flash_attention_bwd_dq": (flash_attention_bwd_dq.__dict__, "launches"),
            "flash_attention_bwd_dq_tc": (dq, "tc"), "flash_attention_bwd_dq_cuda_core": (dq, "cuda_core"),
            "flash_attention_bwd_dkv": (flash_attention_bwd_dkv.__dict__, "launches"),
            "flash_attention_bwd_dkv_tc": (dkv, "tc"), "flash_attention_bwd_dkv_cuda_core": (dkv, "cuda_core"),
            "flash_attention_int8": (flash_attention_int8.__dict__, "launches"),
            "flash_attention_int8_tc": (flash_attention_int8.launches_by_route, "tc"),
            "flash_attention_int8_tc_fp32": (flash_attention_int8.launches_by_route, "tc_fp32")}


# what a path with the int8 mode off and no caller of the qk prolog leaves at zero
_NO_OPT_IN = {"flash_attention_int8": 0, "flash_attention_int8_tc": 0, "flash_attention_int8_tc_fp32": 0,
              "qk_prolog": 0}
# what a sampling path in bf16 leaves at zero: it takes no gradient either
_NO_TRAINING = {"flash_attention_lse": 0, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dq_tc": 0,
                "flash_attention_bwd_dq_cuda_core": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dkv_tc": 0,
                "flash_attention_bwd_dkv_cuda_core": 0, **_NO_OPT_IN}
# what an fp32 path leaves at zero: the tensor-core forward, dq and dkv take bf16 only
_NO_TENSOR_CORES = {"flash_attention_tc": 0, "flash_attention_bwd_dq_tc": 0, "flash_attention_bwd_dkv_tc": 0}
# what a bf16 path leaves at zero: no bf16 call reaches a CUDA-core forward, dq or dkv kernel
_NO_CUDA_CORES = {"flash_attention_cuda_core": 0, "flash_attention_bwd_dq_cuda_core": 0,
                  "flash_attention_bwd_dkv_cuda_core": 0}


def _keys(key) -> tuple:
    return key if isinstance(key, tuple) else (key,)


def _reset_counts() -> None:
    for counts, key in _kernel_counters().values():
        for k in _keys(key):
            counts[k] = 0


def _read_counts() -> dict:
    return {name: sum(counts[k] for k in _keys(key)) for name, (counts, key) in _kernel_counters().items()}


def _free_device_memory() -> None:
    """Collect what only reference cycles keep (a pipeline and the timed
    wrappers around its own methods hold each other) and hand the freed device
    memory back, so that the next slice's weights find room."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _require_finite(latents, *_):
    import torch

    if not bool(torch.isfinite(latents).all()):
        raise AssertionError("final latents are not finite")


def _keep_finite(kept: list):
    """A decode's check that also keeps the latents it was given, as numpy, in ``kept``."""

    def check(latents, *_):
        _require_finite(latents)
        kept.append(latents.detach().float().cpu().numpy())

    return check


def _int8_reruns(tag, modes, run, timer, bf16_rows, bf16_latents, want_of, shape) -> dict:
    """Run the pipeline call ``run()`` (the call phase ``tag`` just made, with
    ``output_type="latent"``) again under each int8 mode of ``modes``, with
    the same seed. Checks the latents' shape and finiteness and the exact
    launch counts ``want_of(DiT forwards)``; prints each denoise step's time
    beside the bf16 run's and the drift of the final latents against the bf16
    run's (random weights: a record, not a gate). Returns {mode: counts}."""
    import numpy as np
    import torch

    from alg_tpu_torch.ops.attention import get_attention_int8, set_attention_int8

    bf16_steps = [(name, ms) for name, ms, _ in bf16_rows if name.startswith("denoise step")]
    out = {}
    for mode in modes:
        timer.rows = []
        set_attention_int8(mode)
        try:
            if get_attention_int8() != mode:
                raise AssertionError(f"int8 mode {get_attention_int8()!r} after set_attention_int8({mode!r})")
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            latents = run()
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            timer.close_step(time.perf_counter())
            counts = _read_counts()
        finally:
            set_attention_int8(False)
        steps = [(name, ms) for name, ms, _ in timer.rows if name.startswith("denoise step")]
        want = want_of(len(steps))
        want["flash_attention_int8_tc"] = want["flash_attention_int8"]  # bf16: every int8 launch on the tensor cores
        drift = np.abs(latents.astype(np.float64) - bf16_latents)
        rms = float(np.sqrt(np.mean(bf16_latents.astype(np.float64) ** 2)))
        for (name, ms), (_, base_ms) in zip(steps, bf16_steps):
            print(f"[{tag}] int8 {mode:<4} {name:<36} {ms:10.1f} ms  (bf16 run {base_ms:.1f} ms)")
        print(f"[{tag}] int8 {mode}: call to the latents {total_s:.2f} s; launches {counts} (want {want}); final latents "
              f"against the bf16 run's: mean|diff| / rms {drift.mean() / rms:.3e}, max|diff| / rms {drift.max() / rms:.3e} "
              f"(random weights: a record, not a gate)", flush=True)
        if len(steps) != len(bf16_steps) or counts != want or not counts["flash_attention_int8"]:
            raise AssertionError(f"[{tag}] int8 {mode}: {len(steps)} DiT forwards, launches {counts} != {want}")
        if latents.shape != shape or not np.isfinite(latents).all():
            raise AssertionError(f"[{tag}] int8 {mode}: latents {latents.shape}, finite={bool(np.isfinite(latents).all())}")
        out[mode] = counts
    return out


C15_FRAMES, C15_HEIGHT, C15_WIDTH = 9, 768, 1360  # phase C's cut of the model card's 81 frames at 768 x 1360

# the CogVideoX-I2V pipelines phase C drives: {path: (phase tag, io/hf_checkpoint's constant of the published
# configs, the call's height and width, the model card's frames, S of a forward at those frames)}
COG_SLICES = {"cogvideox": ("C", "COGVIDEOX_5B_I2V", 480, 720, 49, 226 + 13 * 30 * 45),
              "cogvideox15": ("C5", "COGVIDEOX15_5B_I2V", C15_HEIGHT, C15_WIDTH, 81, COGVIDEOX15_S[81])}


def phase_slice(path: str = "cogvideox") -> dict:
    """Phase C (CogVideoX-5b-I2V at 480x720) or C5 (CogVideoX-1.5-5B-I2V at
    768x1360, 3 latent frames padded to 4, S = 8,386): the full-width
    pipeline of ``COG_SLICES[path]`` (42-layer DiT and T5-XXL in bf16, the
    VAE in fp32, random weights from seed 0) driven once through
    ``CogVideoXPipeline.__call__`` with the shipped ALG config at 9 frames, 4
    steps. Checks the decoded frames, the latents given to the decode (the
    padded latent frame dropped), the output's shape and finiteness and the
    exact launch counts; prints each stage's time and the peak memory. For
    5b the same call then runs under each int8 mode and over the sampling
    surface. Last, with the T5 and VAE freed, one 2-pass DiT forward at the
    model card's frame count. Returns {path name: kernel launch counts of
    that run}."""
    import numpy as np
    import torch

    from alg_tpu_torch.io import hf_checkpoint
    from alg_tpu_torch.io.model_zoo import cogvideox_configs
    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer
    from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE
    from alg_tpu_torch.models.t5 import T5Encoder
    from alg_tpu_torch.ops.ada_norm import ada_norm
    from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline

    tag, config, height, width, card_frames, card_s = COG_SLICES[path]
    frames = 9
    _set_tf32(False, True)  # PyTorch's defaults: fp32 matmuls in full fp32, cuDNN convs in TF32
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    tcfg, vcfg, t5cfg = cogvideox_configs(getattr(hf_checkpoint, config))
    dit = L.init_random_(CogVideoXTransformer(tcfg, device=dev, dtype=torch.bfloat16), gen)
    t5 = L.init_random_(T5Encoder(t5cfg, device=dev, dtype=torch.bfloat16), gen)
    vae = L.init_random_(CogVideoXVAE(vcfg, device=dev, dtype=torch.float32), gen)
    torch.cuda.synchronize()
    n = {name: sum(p.numel() for p in m.parameters()) for name, m in (("dit", dit), ("t5", t5), ("vae", vae))}
    print(f"[{tag}] {config} random init on the card in {time.perf_counter() - t0:.1f} s: DiT "
          f"{n['dit'] / 1e9:.3f} B params (bf16, patch_size_t {tcfg.patch_size_t}, ofs {tcfg.ofs_embed_dim}), T5 "
          f"{n['t5'] / 1e9:.2f} B (bf16), VAE {n['vae'] / 1e6:.1f} M (fp32, invert_scale_latents "
          f"{vcfg.invert_scale_latents}); {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)

    pipe = CogVideoXPipeline(transformer=dit, vae=vae, t5=t5, tokenize=_seeded_tokenize(t5cfg.vocab_size),
                             dtype=torch.bfloat16, device=dev)
    timer = _StageTimer()
    pipe.encode_prompt = timer.wrap("T5 encode", pipe.encode_prompt)
    pipe.vae_encode_sample = timer.wrap("VAE encode + posterior draw", pipe.vae_encode_sample)
    final, decoded = [], []  # the latents each decode is given; the shape and finiteness of what it returns
    decode = timer.wrap("VAE tiled decode", pipe.decode_latents, check=_keep_finite(final))

    def decode_kept(*args, **kwargs):
        out = decode(*args, **kwargs)
        decoded.append((tuple(out.shape), bool(torch.isfinite(out).all())))
        return out

    pipe.decode_latents = decode_kept
    hooks = timer.hook_dit(dit, _cog_seq_len)
    image = np.random.RandomState(0).uniform(-1, 1, (1, 3, height, width)).astype(np.float32)

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ada0 = ada_norm.launches
    t0 = time.perf_counter()
    video = pipe(image=image, prompt=PROMPT, height=height, width=width, num_frames=frames, output_type="np",
                 **_alg_kwargs())
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = _read_counts()
    ada = ada_norm.launches - ada0

    for name, ms, dit_ms in timer.rows:
        print(f"[{tag}] {name:<36} {ms:10.1f} ms" + ("" if dit_ms is None else f"  (DiT forward {dit_ms:.1f} ms)"))
    print(f"[{tag}] pipeline call total {total_s:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({_card_line()})", flush=True)

    latent_frames = (frames - 1) // vcfg.temporal_compression_ratio + 1
    tokens = (height // 8 // tcfg.patch_size) * (width // 8 // tcfg.patch_size)
    call_s = tcfg.max_text_seq_length + -(-latent_frames // (tcfg.patch_size_t or 1)) * tokens  # 1.5: padded
    dit_fwd, t5_enc = timer.count("denoise step"), timer.count("T5 encode")
    three = timer.count(f"denoise step (3-pass, S={call_s})")
    two = timer.count(f"denoise step (2-pass, S={call_s})")
    flash = tcfg.num_layers * dit_fwd + t5cfg.num_layers * t5_enc  # bf16: every one on the tensor cores
    want = {"qk_prep": 2 * tcfg.num_layers * dit_fwd, "rope_interleaved": 0, "flash_attention": flash,
            "flash_attention_tc": flash, **_NO_TRAINING, **_NO_CUDA_CORES}
    print(f"[{tag}] launches {counts} (want {want}: {dit_fwd} DiT forwards at S = {call_s}, {t5_enc} T5 encodes)")
    if (dit_fwd, t5_enc, three, two) != (4, 2, 2, 2):
        raise AssertionError(f"[{tag}] stage counts: {dit_fwd} DiT forwards ({three} 3-pass, {two} 2-pass), "
                             f"{t5_enc} T5 encodes; want 4 (2, 2), 2")
    if counts != want:
        raise AssertionError(f"[{tag}] kernel launches {counts} != {want}")
    # the AdaLN chain: three launches a block (norm1; the attention's gated residual with norm2; the MLP's gated
    # residual)
    print(f"[{tag}] ada_norm launches {ada} (want 3 x {tcfg.num_layers} blocks x {dit_fwd} DiT forwards)", flush=True)
    if ada != 3 * tcfg.num_layers * dit_fwd:
        raise AssertionError(f"[{tag}] ada_norm launches {ada} != {3 * tcfg.num_layers * dit_fwd}")
    from alg_tpu_torch.ops.flash_attention import flash_attention

    # of the tensor-core forwards, the DiT's (head dim 64, no bias) on the Hopper kernel, T5's (a bias) on mma.sync
    by_route = dict(flash_attention.launches_by_route)
    if (by_route["wgmma"], by_route["tc"]) != (tcfg.num_layers * dit_fwd, t5cfg.num_layers * t5_enc):
        raise AssertionError(f"[{tag}] forward launches by route {by_route}: want the DiT's "
                             f"{tcfg.num_layers * dit_fwd} on wgmma, T5's {t5cfg.num_layers * t5_enc} on tc")
    print(f"[{tag}] forward launches by route {by_route}")
    ok = (decoded == [((1, frames, 3, height, width), True)]
          and final[0].shape == (1, latent_frames, vcfg.latent_channels, height // 8, width // 8)
          and video.shape == (1, frames, height, width, 3) and bool(np.isfinite(video).all()))
    print(f"[{tag}] decoded frames {decoded}, the latents given to the decode {final[0].shape}, output "
          f"{video.shape} finite, mean {video.mean():.4f} std {video.std():.4f}: {'PASS' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"[{tag}] the output is not {frames} finite {width}x{height} frames")
    out = {path: counts}

    if path == "cogvideox":
        # the same call under the int8 modes: every DiT attention goes to the int8 kernel, T5's stays where it was
        by_mode = _int8_reruns(
            tag, ("qk", "full"),
            lambda: pipe(image=image, prompt=PROMPT, height=height, width=width, num_frames=frames,
                         output_type="latent", **_alg_kwargs()),
            timer, timer.rows, final[0],
            lambda fwd: {"qk_prep": 2 * tcfg.num_layers * fwd, "rope_interleaved": 0,
                         "flash_attention": t5cfg.num_layers * t5_enc,
                         "flash_attention_tc": t5cfg.num_layers * t5_enc, **_NO_TRAINING, **_NO_CUDA_CORES,
                         "flash_attention_int8": tcfg.num_layers * fwd}, final[0].shape)
        out.update({f"cogvideox_int8_{mode}": n for mode, n in by_mode.items()})
        out.update(_cogvideox_surface(pipe, timer, image, tcfg, t5cfg, final[0]))
    for h in hooks:
        h.remove()
    del pipe, t5, vae, decode, decode_kept  # the wrapped decode holds the pipeline, and with it T5 and the VAE
    _free_device_memory()
    _headline_forward(tag, dit, gen, card_frames, height, width, card_s)
    del dit
    _free_device_memory()
    return out


def _headline_forward(tag, dit, gen, frames, height, width, want_s) -> None:
    """One 2-pass DiT forward at the model card's ``frames`` (5b: 49 frames at
    480x720, 13 latent frames, S = 17,776; 1.5: 81 frames at 768x1360, 21
    latent frames padded to 22, S = 45,106) on random inputs: a warm-up, one
    timed by the host clock between synchronises, and one under
    ``torch.profiler`` for the share of the tensor-core forward and of
    qk_prep in the device time."""
    import torch

    from alg_tpu_torch.models.cogvideox.transformer import cogvideox_rope

    cfg, dev = dit.cfg, gen.device
    latent_frames = (frames - 1) // 4 + 1
    latent_frames += -latent_frames % (cfg.patch_size_t or 1)  # 1.5: whole temporal patches, as the pipeline pads
    x = torch.randn((2, latent_frames, cfg.in_channels, height // 8, width // 8), generator=gen,
                    device=dev).to(torch.bfloat16)
    emb = torch.randn((2, cfg.max_text_seq_length, cfg.text_embed_dim), generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = (torch.from_numpy(a).to(dev) for a in cogvideox_rope(cfg, height, width, latent_frames))
    ts = torch.full((2,), 999.0, device=dev)
    ofs = None if cfg.ofs_embed_dim is None else torch.full((1,), 2.0, device=dev)  # the pipeline's ofs
    s = _cog_seq_len(dit, (x, emb))
    if s != want_s:
        raise AssertionError(f"[{tag}] the {frames}-frame forward's S is {s}, not {want_s}")
    with torch.no_grad():
        dit(x, emb, ts, cos, sin, ofs=ofs)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = dit(x, emb, ts, cos, sin, ofs=ofs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        _, prof = _profiled(lambda: dit(x, emb, ts, cos, sin, ofs=ofs))
    shares = {name: sum(k_ms for k, k_ms, _ in prof["kernels"] if name in k) for name in
              ("flash_fwd_tc_kernel", "qk_prep_kernel")}
    print(f"[{tag}] DiT forward at {frames} frames, {width}x{height} (2-pass, B=2, S={s}): {ms:.1f} ms, peak "
          f"{peak:.1f} GiB, finite={bool(torch.isfinite(out).all())}; profiled: {prof['window_ms']:.1f} ms window, "
          f"device busy {prof['busy_ms']:.1f} ms, flash forward {shares['flash_fwd_tc_kernel']:.1f} ms "
          f"({shares['flash_fwd_tc_kernel'] / prof['window_ms']:.1%}), qk_prep {shares['qk_prep_kernel']:.1f} ms "
          f"({shares['qk_prep_kernel'] / prof['window_ms']:.1%}); card after it: {_card_state()}", flush=True)
    _print_profile(f"[{tag}] the {frames}-frame forward", prof)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"[{tag}] the {frames}-frame forward is not finite")


def _seeded_tokenize_mask(vocab_size: int):
    """UMT5 tokenizer stand-in: ``(ids, mask)``, each ``[len(prompts),
    max_len]``; three seeded ids a word (at least one, as an end-of-sequence
    token alone), zero-padded, with the prefix mask over them."""
    import numpy as np

    ids_of = _seeded_tokenize(vocab_size)

    def tokenize(prompts, max_len):
        lens = np.array([min(max_len, max(1, 3 * len(p.split()))) for p in prompts])
        mask = (np.arange(max_len)[None, :] < lens[:, None]).astype(np.int64)
        return ids_of(prompts, max_len) * mask, mask

    return tokenize


def phase_slice_wan() -> dict:
    """Drive the full-width Wan pipeline once in bf16 and once under int8
    "qk"; return {path name: kernel launch counts of that run}."""
    import numpy as np
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionModel
    from alg_tpu_torch.models.t5 import UMT5_XXL, T5Encoder
    from alg_tpu_torch.models.wan.transformer import WanTransformer, WanTransformerConfig
    from alg_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig
    from alg_tpu_torch.ops.ada_norm import ada_norm
    from alg_tpu_torch.pipelines.wan import WanPipeline

    _set_tf32(False, True)  # PyTorch's defaults: fp32 matmuls in full fp32, cuDNN convs in TF32
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    tcfg, ccfg, vcfg = WanTransformerConfig(), CLIPVisionConfig(), WanVAEConfig()
    dit = L.init_random_(WanTransformer(tcfg, device=dev, dtype=torch.bfloat16), gen)
    t5 = L.init_random_(T5Encoder(UMT5_XXL, device=dev, dtype=torch.bfloat16), gen)
    clip = L.init_random_(CLIPVisionModel(ccfg, device=dev, dtype=torch.float32), gen)
    vae = L.init_random_(WanVAE(vcfg, device=dev, dtype=torch.float32), gen)
    torch.cuda.synchronize()
    n = {name: sum(p.numel() for p in m.parameters())
         for name, m in (("dit", dit), ("t5", t5), ("clip", clip), ("vae", vae))}
    print(f"[C2] random init on the card in {time.perf_counter() - t0:.1f} s: DiT {n['dit'] / 1e9:.2f} B params "
          f"(bf16), UMT5 {n['t5'] / 1e9:.2f} B (bf16), CLIP {n['clip'] / 1e6:.0f} M (fp32), VAE "
          f"{n['vae'] / 1e6:.1f} M (fp32); {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)

    pipe = WanPipeline(transformer=dit, vae=vae, t5=t5, clip=clip, tokenize=_seeded_tokenize_mask(UMT5_XXL.vocab_size),
                       dtype=torch.bfloat16, device=dev)
    timer = _StageTimer()
    pipe.encode_prompt = timer.wrap("UMT5 encode", pipe.encode_prompt)
    pipe._encode_video_condition = timer.wrap("VAE tiled encode of the condition video",
                                              pipe._encode_video_condition)
    final = []  # the latents the decode is given
    pipe.decode_latents = timer.wrap("VAE tiled decode", pipe.decode_latents, check=_keep_finite(final))
    clip_tower = timer.wrap("CLIP vision tower", lambda px: clip(px)[-2])
    # args: x [B, C, F, h, w]
    hooks = timer.hook_dit(dit, lambda m, a: a[0].shape[2] * a[0].shape[3] * a[0].shape[4]
                           // (m.cfg.patch_size[0] * m.cfg.patch_size[1] * m.cfg.patch_size[2]))
    rng = np.random.RandomState(0)
    image = rng.uniform(-1, 1, (1, 3, 480, 832)).astype(np.float32)
    pixels = torch.from_numpy(rng.randn(1, 3, ccfg.image_size, ccfg.image_size).astype(np.float32)).to(dev)

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ada0 = ada_norm.launches
    t0 = time.perf_counter()
    with torch.no_grad():
        image_embeds = clip_tower(pixels)  # the penultimate layer's output, [1, 257, 1280]
    # shipped settings (down_up at 0.4, interval from 0, CFG 5.0); the interval's end is raised
    # from 0.20 to 0.4 so that the 4 steps hold two 3-pass and two 2-pass steps
    video = pipe(image=image, prompt=PROMPT, image_embeds=image_embeds, height=480, width=832, num_frames=9,
                 output_type="np", **_alg_kwargs(guidance_scale=5.0, lp_resize_factor=0.4))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = _read_counts()
    ada = ada_norm.launches - ada0

    for name, ms, dit_ms in timer.rows:
        print(f"[C2] {name:<40} {ms:10.1f} ms" + ("" if dit_ms is None else f"  (DiT forward {dit_ms:.1f} ms)"))
    print(f"[C2] CLIP tower + pipeline call total {total_s:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)

    dit_fwd, t5_enc, clip_runs = timer.count("denoise step"), timer.count("UMT5 encode"), timer.count("CLIP")
    three, two = timer.count("denoise step (3-pass, S=4680)"), timer.count("denoise step (2-pass, S=4680)")
    bf16_flash = 3 * tcfg.num_layers * dit_fwd + UMT5_XXL.num_layers * t5_enc  # on the tensor cores; CLIP is fp32
    want = {"qk_prep": 0, "rope_interleaved": 2 * tcfg.num_layers * dit_fwd,
            "flash_attention": bf16_flash + ccfg.num_hidden_layers * clip_runs, "flash_attention_tc": bf16_flash,
            "flash_attention_cuda_core": ccfg.num_hidden_layers * clip_runs, **_NO_TRAINING}
    print(f"[C2] launches {counts} (want {want}: {dit_fwd} DiT forwards, {t5_enc} UMT5 encodes, {clip_runs} CLIP run)")
    if (dit_fwd, t5_enc, clip_runs, three, two) != (4, 2, 1, 2, 2):
        raise AssertionError(f"stage counts: {dit_fwd} DiT forwards ({three} 3-pass, {two} 2-pass at S=4680), "
                             f"{t5_enc} UMT5 encodes, {clip_runs} CLIP runs; want 4 (2, 2), 2, 1")
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != {want}")
    # the AdaLN chain: four launches a block (the modulated norm; the gated residual with norm2; the
    # cross-attention's residual with the MLP's modulated norm; the MLP's gated residual)
    print(f"[C2] ada_norm launches {ada} (want 4 x {tcfg.num_layers} blocks x {dit_fwd} DiT forwards)", flush=True)
    if ada != 4 * tcfg.num_layers * dit_fwd:
        raise AssertionError(f"[C2] ada_norm launches {ada} != {4 * tcfg.num_layers * dit_fwd}")
    from alg_tpu_torch.ops.flash_attention import flash_attention

    # of the tensor-core forwards, the DiT's three a block (head dim 128, no bias) on the Hopper kernel, UMT5's
    # (a bias) on mma.sync
    by_route = dict(flash_attention.launches_by_route)
    if (by_route["wgmma"], by_route["tc"]) != (3 * tcfg.num_layers * dit_fwd, UMT5_XXL.num_layers * t5_enc):
        raise AssertionError(f"[C2] forward launches by route {by_route}: want the DiT's "
                             f"{3 * tcfg.num_layers * dit_fwd} on wgmma, UMT5's {UMT5_XXL.num_layers * t5_enc} on tc")
    print(f"[C2] forward launches by route {by_route}")
    if video.shape != (1, 9, 480, 832, 3) or not np.isfinite(video).all():
        raise AssertionError(f"output {video.shape}, finite={bool(np.isfinite(video).all())}")
    print(f"[C2] output {video.shape} finite, mean {video.mean():.4f} std {video.std():.4f}: PASS", flush=True)

    # the same call under int8 "qk": the self-attention goes to the int8 kernel, the two cross-attentions
    # (Sq != Sk) and UMT5 stay on the bf16 kernel; the CLIP tower is not run again
    by_mode = _int8_reruns(
        "C2", ("qk",),
        lambda: pipe(image=image, prompt=PROMPT, image_embeds=image_embeds, height=480, width=832, num_frames=9,
                     output_type="latent", **_alg_kwargs(guidance_scale=5.0, lp_resize_factor=0.4)),
        timer, timer.rows, final[0],
        lambda fwd: {"qk_prep": 0, "rope_interleaved": 2 * tcfg.num_layers * fwd,
                     "flash_attention": 2 * tcfg.num_layers * fwd + UMT5_XXL.num_layers * t5_enc,
                     "flash_attention_tc": 2 * tcfg.num_layers * fwd + UMT5_XXL.num_layers * t5_enc, **_NO_TRAINING,
                     **_NO_CUDA_CORES, "flash_attention_int8": tcfg.num_layers * fwd}, final[0].shape)
    surface = _wan_surface(pipe, timer, image, image_embeds, tcfg)
    for h in hooks:
        h.remove()
    del dit, t5, clip, vae, pipe
    _free_device_memory()
    return {"wan": counts, **{f"wan_int8_{mode}": n for mode, n in by_mode.items()}, **surface}


def _hunyuan_hooks(template, image_token, pad_token, vocab_low, vocab_high, clip_eos):
    """Stand-ins for the Llava tokenizer, the CLIP tokenizer and the CLIP
    image processor (the card's machine has no tokenizer files and no PIL).

    ``tokenize_llama(texts, max_len) -> (ids, mask)`` lays a row out as the
    Llava tokenizer lays out the chat template: ``crop_start`` head tokens
    with the ``<image>`` token at ``image_emb_start`` and three double-return
    tokens, three seeded ids a word of the prompt (at least one), the five
    tokens of the assistant header, which end in the fourth double-return
    token, then right padding. ``tokenize_clip(texts, max_len) -> ids``: one
    seeded id a word, then the end-of-sequence id to the end of the row.
    ``image_processor(image, size)``: seeded pixel values that differ from
    image to image."""
    import numpy as np

    crop, drt = template["crop_start"], template["double_return_token_id"]
    head, tail = template["template"].split("{}")

    def words(text):
        return len(text[len(head):len(text) - len(tail)].split())

    def tokenize_llama(texts, max_len):
        rows = []
        for text in texts:
            row = np.random.RandomState(sum(map(ord, text)) % 2 ** 31).randint(vocab_low, vocab_high, max_len)
            row[row == drt] += 1
            n_real = crop + min(max_len - crop - 5, max(1, 3 * words(text))) + 5
            row[n_real:] = pad_token
            row[template["image_emb_start"]] = image_token
            row[[4, crop - 2, crop - 1, n_real - 1]] = drt
            rows.append(row.astype(np.int64))
        ids = np.stack(rows)
        return ids, (ids != pad_token).astype(np.int64)

    def tokenize_clip(texts, max_len):
        rows = []
        for text in texts:
            row = np.random.RandomState(sum(map(ord, text)) % 2 ** 31 + 1).randint(0, clip_eos, max_len)
            row[min(max_len - 1, 1 + len(text.split())):] = clip_eos
            rows.append(row.astype(np.int64))
        return np.stack(rows)

    def image_processor(image, size):
        seed = int(np.abs(np.asarray(image, np.float64)).sum() * 1e3) % 2 ** 31
        return np.random.RandomState(seed).randn(1, 3, size, size).astype(np.float32)

    return tokenize_llama, tokenize_clip, image_processor


def phase_slice_hunyuan() -> dict:
    """Drive the full-width HunyuanVideo pipeline once in bf16 and once under
    int8 "full"; return {path name: kernel launch counts of that run}."""
    import numpy as np
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformer, HunyuanVideoTransformerConfig
    from alg_tpu_torch.models.hunyuan.vae import HunyuanVAE, HunyuanVAEConfig
    from alg_tpu_torch.models.llama import LlavaConfig, LlavaModel
    from alg_tpu_torch.pipelines.hunyuan import DEFAULT_PROMPT_TEMPLATE, HunyuanVideoPipeline

    _set_tf32(False, True)  # PyTorch's defaults: fp32 matmuls in full fp32, cuDNN convs in TF32
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    tcfg, lcfg, ccfg, vcfg = HunyuanVideoTransformerConfig(), LlavaConfig(), CLIPTextConfig(), HunyuanVAEConfig()
    dit = L.init_random_(HunyuanVideoTransformer(tcfg, device=dev, dtype=torch.bfloat16), gen)
    llava = L.init_random_(LlavaModel(lcfg, device=dev, dtype=torch.bfloat16), gen)
    clip = L.init_random_(CLIPTextModel(ccfg, device=dev, dtype=torch.float32), gen)
    vae = L.init_random_(HunyuanVAE(vcfg, device=dev, dtype=torch.float32), gen)
    torch.cuda.synchronize()
    n = {name: sum(p.numel() for p in m.parameters())
         for name, m in (("dit", dit), ("llava", llava), ("clip", clip), ("vae", vae))}
    print(f"[C3] random init on the card in {time.perf_counter() - t0:.1f} s: DiT {n['dit'] / 1e9:.2f} B params "
          f"(bf16), Llava {n['llava'] / 1e9:.2f} B (bf16), CLIP text {n['clip'] / 1e6:.0f} M (fp32), VAE "
          f"{n['vae'] / 1e6:.1f} M (fp32); {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)

    tok_llama, tok_clip, image_processor = _hunyuan_hooks(
        DEFAULT_PROMPT_TEMPLATE, lcfg.image_token_index, lcfg.pad_token_id, 1000, 100000, ccfg.eos_token_id)
    pipe = HunyuanVideoPipeline(transformer=dit, vae=vae, llava=llava, clip=clip, tokenize_llama=tok_llama,
                                tokenize_clip=tok_clip, image_processor=image_processor, dtype=torch.bfloat16,
                                device=dev)
    timer = _StageTimer()
    hooks = timer.hook_module("Llava (CLIP-L tower, projector, 32 Llama layers)", llava)
    hooks += timer.hook_module("CLIP text", clip)
    vae.encode = timer.wrap("VAE encode of the image", vae.encode)
    final = []  # the latents the decode is given
    pipe.decode_latents = timer.wrap("VAE tiled decode", pipe.decode_latents, check=_keep_finite(final))
    text_keys = []
    # args: x [B, C, F, h, w], timestep, text [B, S_text, D], text mask [B, S_text]: the joint [video; text] stream
    hooks += timer.hook_dit(dit, lambda m, a: (text_keys.append(int(a[3].sum())), a[2].shape[1] + a[0].shape[2]
                                               * a[0].shape[3] * a[0].shape[4] // m.cfg.patch_size ** 2)[1])
    image = np.random.RandomState(0).uniform(-1, 1, (1, 3, 352, 608)).astype(np.float32)

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    # shipped settings (latent down_up at 0.625, interval from 0, distilled guidance 6.0, no true CFG, so one
    # pass a step); the interval's end is raised from 0.04 to 0.4 so that 2 of the 4 steps take the filtered
    # first-frame latent and 2 the clean one
    video = pipe(image=image, prompt=PROMPT, height=352, width=608, num_frames=9, output_type="np",
                 true_cfg_scale=1.0, i2v_stable=True, **_alg_kwargs(negative_prompt=None, lp_resize_factor=0.625))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = _read_counts()

    for name, ms, dit_ms in timer.rows:
        print(f"[C3] {name:<50} {ms:10.1f} ms" + ("" if dit_ms is None else f"  (DiT forward {dit_ms:.1f} ms)"))
    print(f"[C3] pipeline call total {total_s:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)

    s_joint = HY_VIDEO_TOKENS[9] + HY_TEXT_LEN
    dit_fwd, llava_runs, clip_runs = timer.count("denoise step"), timer.count("Llava"), timer.count("CLIP text")
    one = timer.count(f"denoise step (1-pass, S={s_joint})")
    blocks = tcfg.num_layers + tcfg.num_single_layers
    llava_flash = (lcfg.text.num_hidden_layers + lcfg.vision.num_hidden_layers) * llava_runs
    bf16_flash = (tcfg.num_refiner_layers + blocks) * dit_fwd + llava_flash  # on the tensor cores; CLIP text is fp32
    want = {"qk_prep": 0, "rope_interleaved": 2 * blocks * dit_fwd,
            "flash_attention": bf16_flash + ccfg.num_hidden_layers * clip_runs, "flash_attention_tc": bf16_flash,
            "flash_attention_cuda_core": ccfg.num_hidden_layers * clip_runs, **_NO_TRAINING}
    print(f"[C3] launches {counts} (want {want}: {dit_fwd} DiT forwards, {llava_runs} Llava run, {clip_runs} CLIP "
          f"text run); valid text positions a forward {text_keys} (phase B: {HY_TEXT_KEYS} of {HY_TEXT_LEN})")
    if (dit_fwd, one, llava_runs, clip_runs) != (4, 4, 1, 1) or text_keys != [HY_TEXT_KEYS] * 4:
        raise AssertionError(f"stage counts: {dit_fwd} DiT forwards ({one} 1-pass at S={s_joint}), {llava_runs} "
                             f"Llava runs, {clip_runs} CLIP text runs, text keys {text_keys}; want 4 (4), 1, 1, "
                             f"{HY_TEXT_KEYS}")
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != {want}")
    if video.shape != (1, 9, 352, 608, 3) or not np.isfinite(video).all():
        raise AssertionError(f"output {video.shape}, finite={bool(np.isfinite(video).all())}")
    print(f"[C3] output {video.shape} finite, mean {video.mean():.4f} std {video.std():.4f}: PASS", flush=True)

    # the same call under int8 "full" (kv_len at head dim 128): the 60 joint attentions of a forward go to the
    # int8 kernel, the two refiner blocks (stable=True), Llava and the CLIP text model stay on the bf16 kernel
    by_mode = _int8_reruns(
        "C3", ("full",),
        lambda: pipe(image=image, prompt=PROMPT, height=352, width=608, num_frames=9, output_type="latent",
                     true_cfg_scale=1.0, i2v_stable=True, **_alg_kwargs(negative_prompt=None, lp_resize_factor=0.625)),
        timer, timer.rows, final[0],
        lambda fwd: {"qk_prep": 0, "rope_interleaved": 2 * blocks * fwd,
                     "flash_attention": tcfg.num_refiner_layers * fwd + llava_flash + ccfg.num_hidden_layers * clip_runs,
                     "flash_attention_tc": tcfg.num_refiner_layers * fwd + llava_flash,
                     "flash_attention_cuda_core": ccfg.num_hidden_layers * clip_runs, **_NO_TRAINING,
                     "flash_attention_int8": blocks * fwd},
        final[0].shape)

    def want_of(fwd):  # as the call above, for the Llava and CLIP text runs of the call being counted
        flash = (tcfg.num_refiner_layers + blocks) * fwd + (
            lcfg.text.num_hidden_layers + lcfg.vision.num_hidden_layers) * timer.count("Llava")
        clip_flash = ccfg.num_hidden_layers * timer.count("CLIP text")
        return {"qk_prep": 0, "rope_interleaved": 2 * blocks * fwd, "flash_attention": flash + clip_flash,
                "flash_attention_tc": flash, "flash_attention_cuda_core": clip_flash, **_NO_TRAINING}

    surface = _hunyuan_surface(pipe, timer, image, want_of)
    for h in hooks:
        h.remove()

    del llava, clip, vae, pipe
    _free_device_memory()
    _headline_forward_hunyuan(dit, gen)
    del dit
    _free_device_memory()
    return {"hunyuan": counts, **{f"hunyuan_int8_{mode}": n for mode, n in by_mode.items()}, **surface}


def _headline_forward_hunyuan(dit, gen) -> None:
    """Time one single-pass DiT forward at the shipped config's 129 frames
    (33 latent frames of 44 x 76, S = 27,588 + 540) on random inputs, once:
    the kernels are warm from the pipeline call."""
    import torch

    from alg_tpu_torch.models.hunyuan.transformer import hunyuan_rope

    cfg, dev = dit.cfg, gen.device
    x = torch.randn((1, cfg.in_channels, 33, 44, 76), generator=gen, device=dev).to(torch.bfloat16)
    text = torch.randn((1, HY_TEXT_LEN, cfg.text_embed_dim), generator=gen, device=dev).to(torch.bfloat16)
    pooled = torch.randn((1, cfg.pooled_projection_dim), generator=gen, device=dev).to(torch.bfloat16)
    mask = (torch.arange(HY_TEXT_LEN, device=dev)[None, :] < HY_TEXT_KEYS).to(torch.int32)
    cos, sin = (torch.from_numpy(a).to(dev) for a in hunyuan_rope(cfg, 33, 44, 76))
    ts, guidance = torch.full((1,), 999.0, device=dev), torch.full((1,), 6000.0, device=dev)
    _reset_counts()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dit(x, ts, text, mask, pooled, guidance, cos, sin)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(out).all())
    print(f"[C3] DiT forward at 129 frames (1-pass, B=1, S={HY_VIDEO_TOKENS[129] + HY_TEXT_LEN}): {ms:.1f} ms, "
          f"launches {_read_counts()}, finite={finite}; card after it: {_card_state()}", flush=True)
    if not finite or out.shape != x.shape:
        raise AssertionError(f"headline forward: output {tuple(out.shape)}, finite={finite}")


# ---------------------------------------------------------------------------
# C-pixel, C-sched, C-resume, C-cache; C2 and C3 pixel: the rest of the sampling surface on the full-width
# pipelines of phases C, C2 and C3, before each is freed
# ---------------------------------------------------------------------------

PIXEL_FILTER, VAE_ENCODE = "pixel filter", "VAE encode"


def _print_steps(tag, rows) -> None:
    """One line for the stages before the first denoise step, then one line a
    step: the pixel filter and VAE encode of pixel-space ALG's condition
    rebuild (where the step has one) and the step with its DiT forward; then
    the means over the steps that rebuilt their condition."""
    head, pending, k, rebuilt = [], [], 0, {PIXEL_FILTER: [], VAE_ENCODE: []}
    for name, ms, dit_ms in rows:
        if name.startswith("denoise step"):
            if k == 0 and head:
                print(f"[{tag}] before the loop: " + ", ".join(f"{n} {v:.1f} ms" for n, v in head))
            for n, v in pending:
                rebuilt.setdefault(n, []).append(v)
            stages = "".join(f"{n} {v:.1f} ms, " for n, v in pending)
            print(f"[{tag}] forward {k}: {stages}{name[13:]} {ms:.1f} ms (DiT forward {dit_ms:.1f} ms)")
            pending, k = [], k + 1
        elif k == 0 and not pending and name != PIXEL_FILTER:
            head.append((name, ms))
        else:
            pending.append((name, ms))
    if rebuilt[PIXEL_FILTER]:
        mean = {n: statistics.mean(v) for n, v in rebuilt.items() if v}
        print(f"[{tag}] condition rebuilt on {len(rebuilt[PIXEL_FILTER])} steps: mean pixel filter "
              f"{mean[PIXEL_FILTER]:.2f} ms, mean VAE encode {mean.get(VAE_ENCODE, float('nan')):.1f} ms")


def _surface_run(tag, timer, call, want_of, shape, passes):
    """One pipeline call ``call()`` (to the latents, as numpy) with the launch
    counts set to 0 just before it and read just after. ``want_of(forwards)``:
    the exact counts for that many DiT forwards; ``passes``: the forwards
    wanted by pass count ({3: n, 2: n, 1: n}, from the run's plan). Prints each
    step, the call's wall time and peak device memory; checks the pass counts,
    the launches and the latents. Returns (latents, counts)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    timer.close_step(time.perf_counter())
    timer.rows = []
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    latents = call()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    timer.close_step(time.perf_counter())
    counts = _read_counts()
    _print_steps(tag, timer.rows)
    got = {n: timer.count(f"denoise step ({n}-pass") for n in (1, 2, 3)}
    got = {n: c for n, c in got.items() if c}
    want = want_of(sum(got.values()))
    finite = bool(np.isfinite(latents).all())
    print(f"[{tag}] call {total_s:.2f} s, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"DiT forwards by pass count {got} (plan {passes}); launches {counts} (want {want}); latents "
          f"{latents.shape} finite={finite}", flush=True)
    if got != passes or counts != want or latents.shape != shape or not finite:
        raise AssertionError(f"[{tag}] forwards {got} != {passes}, launches {counts} != {want}, or latents "
                             f"{latents.shape} (want {shape}) finite={finite}")
    return latents, counts


def _lp_plan(num_steps, h, w, exp_shortcut, **alg):
    """The ALG plan of the pipeline keywords ``alg`` (others ignored) over an (h, w) filter."""
    import dataclasses

    from alg_tpu_torch.alg.schedule import LPConfig, build_lp_plan

    fields = {f.name for f in dataclasses.fields(LPConfig)}
    return build_lp_plan(LPConfig(**{k: v for k, v in alg.items() if k in fields}), num_steps, h, w, exp_shortcut)


def _passes(plan, skipped=0) -> dict:
    """{3: the plan's 3-pass steps, 2: its other steps less ``skipped``}."""
    three = int(plan.three_pass.sum())
    return {n: c for n, c in ((3, three), (2, plan.num_steps - three - skipped)) if c}


def _add_counts(*runs) -> dict:
    return {k: sum(r[k] for r in runs) for k in runs[0]}


class _Patched:
    """Set attributes for a ``with`` block and put the old values back after
    (an attribute that lived in the class goes back to the class's)."""

    def __init__(self, *triples):
        self.triples, self.saved = triples, []

    def __enter__(self):
        for obj, name, value in self.triples:
            self.saved.append((obj, name, obj.__dict__.get(name, _Patched)))
            setattr(obj, name, value)
        return self

    def __exit__(self, *exc):
        for obj, name, old in reversed(self.saved):
            if old is _Patched:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


def _pixel_kwargs(**over):
    """BASELINE config #2's pixel-space settings: gaussian blur, sigma 3.0,
    kernel 0.1 of H, on the RGB frame."""
    return _alg_kwargs(**{**dict(lp_filter_type="gaussian_blur", lp_filter_in_latent=False, lp_blur_sigma=3.0,
                                 lp_blur_kernel_size=0.1), **over})


PIXEL_SCHEDULES = {
    "linear": dict(lp_strength_schedule_type="linear", schedule_linear_start_weight=1.0, schedule_linear_end_weight=0.0,
                   schedule_linear_end_time=0.5),
    "exponential": dict(lp_strength_schedule_type="exponential", schedule_exp_decay_rate=5.0,
                        schedule_blur_kernel_size=True),
}


def _cogvideox_surface(pipe, timer, image, tcfg, t5cfg, uninterrupted) -> dict:
    """C-pixel (BASELINE config #2 under both schedules), C-sched (DPM, eta,
    dynamic CFG), C-resume (an interrupted call with snapshots, then the call
    that resumes it, against ``uninterrupted``: phase C's bf16 latents, to
    the bit) and C-cache on phase C's pipeline. Returns {path: counts}."""
    import os
    import tempfile

    import numpy as np

    from alg_tpu_torch.alg.schedule import build_cache_schedule
    from alg_tpu_torch.pipelines import cogvideox as CP

    def want_of(fwd):
        flash = tcfg.num_layers * fwd + t5cfg.num_layers * timer.count("T5 encode")
        return {"qk_prep": 2 * tcfg.num_layers * fwd, "rope_interleaved": 0, "flash_attention": flash,
                "flash_attention_tc": flash, **_NO_TRAINING, **_NO_CUDA_CORES}

    def call(**kw):
        return pipe(image=image, prompt=PROMPT, height=480, width=720, num_frames=9, output_type="latent", **kw)

    shape, out = uninterrupted.shape, {}
    t0 = time.perf_counter()
    encode = timer.wrap(VAE_ENCODE, CP.CogVideoXPipeline._encode_moments.__get__(pipe))
    with _Patched((CP, "apply_filter_matrices", timer.wrap(PIXEL_FILTER, CP.apply_filter_matrices)),
                  (pipe, "_encode_moments", encode),
                  (pipe, "vae_encode_sample", CP.CogVideoXPipeline.vae_encode_sample.__get__(pipe))):
        runs = []
        for name, sched in PIXEL_SCHEDULES.items():
            kw = _pixel_kwargs(**sched)
            runs.append(_surface_run(f"C-pixel {name}", timer, lambda: call(**kw), want_of, shape,
                                     _passes(_lp_plan(4, 480, 720, True, **kw)))[1])
    out["cogvideox_pixel"] = _add_counts(*runs)
    print(f"[C-pixel] wall time {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    passes = _passes(_lp_plan(4, 60, 90, True, **_alg_kwargs()))
    with _Patched((pipe, "scheduler", "dpm")):
        out["cogvideox_dpm"] = _surface_run("C-sched dpm", timer, lambda: call(**_alg_kwargs()), want_of, shape,
                                            passes)[1]
    out["cogvideox_eta"] = _surface_run("C-sched eta 0.5", timer, lambda: call(eta=0.5, **_alg_kwargs()), want_of,
                                        shape, passes)[1]
    out["cogvideox_dyncfg"] = _surface_run("C-sched dynamic CFG", timer,
                                           lambda: call(use_dynamic_cfg=True, **_alg_kwargs()), want_of, shape,
                                           passes)[1]
    print(f"[C-sched] wall time {time.perf_counter() - t0:.1f} s", flush=True)

    # C-resume: the bf16 call's own arguments with snapshots every step; the observer interrupts after step 2
    t0 = time.perf_counter()
    snap = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_runstate_"), "cogvideox.npz")

    def interrupt_after_two(i, _latents):
        if i == 1:
            pipe.interrupt = True

    first, n1 = _surface_run("C-resume 1/2 (interrupted)", timer,
                             lambda: call(checkpoint=snap, checkpoint_every=1, step_observer=interrupt_after_two,
                                          **_alg_kwargs()), want_of, shape, {3: 2})
    if not os.path.exists(snap):
        raise AssertionError("[C-resume] the interrupted call left no snapshot")
    resumed, n2 = _surface_run("C-resume 2/2 (resumed at step 2)", timer,
                               lambda: call(checkpoint=snap, checkpoint_every=1, **_alg_kwargs()), want_of, shape,
                               {2: 2})
    left = os.path.exists(snap)
    if not left:
        os.rmdir(os.path.dirname(snap))
    out["cogvideox_resume"] = _add_counts(n1, n2)
    diff = np.abs(resumed.astype(np.float64) - uninterrupted)
    equal = bool(np.array_equal(resumed, uninterrupted))
    print(f"[C-resume] resumed latents against phase C's uninterrupted bf16 run: bit-equal={equal}, max|diff| "
          f"{diff.max():.3e}, {int((diff > 0).sum())} of {diff.size} values differ; snapshot removed at the end: "
          f"{not left}; wall time {time.perf_counter() - t0:.1f} s", flush=True)

    # C-cache: the shipped interval (0.04: one ALG step) over 6 steps with cache_interval 2
    t0 = time.perf_counter()
    kw = _alg_kwargs(num_inference_steps=6, schedule_interval_end_time=0.04)
    plan = _lp_plan(6, 60, 90, True, **kw)
    compute = build_cache_schedule(6, 2, plan.strengths)
    out["cogvideox_cache"] = _surface_run("C-cache interval 2", timer, lambda: call(cache_interval=2, **kw),
                                          want_of, shape, _passes(plan, skipped=6 - int(compute.sum())))[1]
    print(f"[C-cache] computed steps {np.flatnonzero(compute).tolist()} of 6; wall time "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not equal or left:
        raise AssertionError(f"[C-resume] resumed run not bit-equal to the uninterrupted one (max|diff| "
                             f"{diff.max():.3e}) or its snapshot left behind ({left})")
    return out


def _wan_surface(pipe, timer, image, image_embeds, tcfg) -> dict:
    """C2-pixel on phase C2's pipeline (down_up 0.4 on the RGB frame, the
    interval C2 runs), then one pixel condition rebuild at the shipped 81
    frames, 480x832: filter, tiled encode, posterior draw, normalisation.
    Returns {path: counts}."""
    import torch

    from alg_tpu_torch.models.t5 import UMT5_XXL
    from alg_tpu_torch.pipelines import wan as WP

    def want_of(fwd):  # the CLIP tower is not run again: image_embeds are given
        flash = 3 * tcfg.num_layers * fwd + UMT5_XXL.num_layers * timer.count("UMT5 encode")
        return {"qk_prep": 0, "rope_interleaved": 2 * tcfg.num_layers * fwd, "flash_attention": flash,
                "flash_attention_tc": flash, **_NO_TRAINING, **_NO_CUDA_CORES}

    t0 = time.perf_counter()
    z = pipe.vae.cfg.z_dim
    kw = _alg_kwargs(guidance_scale=5.0, lp_resize_factor=0.4, lp_filter_in_latent=False)
    plan = _lp_plan(4, 480, 832, False, **kw)
    encode = timer.wrap(VAE_ENCODE, WP.WanPipeline._encode_video_condition.__get__(pipe))
    with _Patched((WP, "apply_filter_matrices", timer.wrap(PIXEL_FILTER, WP.apply_filter_matrices)),
                  (pipe, "_encode_video_condition", encode)):
        _, counts = _surface_run(
            "C2-pixel", timer, lambda: pipe(image=image, prompt=PROMPT, image_embeds=image_embeds, height=480,
                                            width=832, num_frames=9, output_type="latent", **kw),
            want_of, (1, z, 3, 60, 104), _passes(plan))
    print(f"[C2-pixel] wall time {time.perf_counter() - t0:.1f} s", flush=True)

    # R4's case: the rebuild at the shipped length, its tiles encoded one after another
    t0 = time.perf_counter()
    dev = pipe.device
    j = int(plan.m_idx[0])
    m_h, m_w = (torch.from_numpy(m[j]).to(dev) for m in (plan.m_h, plan.m_w))
    eps = torch.randn((1, z, 21, 60, 104), generator=torch.Generator().manual_seed(4))
    mask = torch.zeros((1, 4, 21, 60, 104), device=dev)
    pixel_image = torch.from_numpy(image).to(dev)[:, None]
    resident = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with torch.no_grad():
        cond = pipe._pixel_condition(pixel_image, m_h, m_w, eps, 81, mask)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(cond).all())
    print(f"[C2-pixel] condition rebuild at 81 frames, 480x832 (filter, 15 tiles encoded one at a time, posterior "
          f"draw, normalisation): {ms:.1f} ms; peak device memory {peak / 2**30:.2f} GiB with {resident / 2**30:.2f} "
          f"GiB resident before it ({(peak - resident) / 2**30:.2f} GiB for the rebuild); condition "
          f"{tuple(cond.shape)} finite={finite}; wall time {time.perf_counter() - t0:.1f} s", flush=True)
    if tuple(cond.shape) != (1, 4 + z, 21, 60, 104) or not finite:
        raise AssertionError(f"[C2-pixel] 81-frame condition {tuple(cond.shape)}, finite={finite}")
    return {"wan_pixel": counts}


def _hunyuan_surface(pipe, timer, image, want_of) -> dict:
    """C3-pixel on phase C3's pipeline: the shipped single-pass settings with
    the filter on the RGB frame and the mode of its posterior (the argmax
    encode) on every step. ``want_of(forwards)``: phase C3's launch counts.
    Returns {path: counts}."""
    from alg_tpu_torch.pipelines import hunyuan as HP

    t0 = time.perf_counter()
    kw = _alg_kwargs(negative_prompt=None, lp_resize_factor=0.625, lp_filter_in_latent=False)
    encode = timer.wrap(VAE_ENCODE, HP.HunyuanVideoPipeline._encode_mode.__get__(pipe))
    with _Patched((HP, "apply_filter_matrices", timer.wrap(PIXEL_FILTER, HP.apply_filter_matrices)),
                  (pipe, "_encode_mode", encode), (pipe.vae, "encode", type(pipe.vae).encode.__get__(pipe.vae))):
        _, counts = _surface_run(
            "C3-pixel", timer, lambda: pipe(image=image, prompt=PROMPT, height=352, width=608, num_frames=9,
                                            output_type="latent", true_cfg_scale=1.0, i2v_stable=True, **kw),
            want_of, (1, pipe.vae.cfg.latent_channels, 3, 44, 76), {1: 4})
    print(f"[C3-pixel] wall time {time.perf_counter() - t0:.1f} s", flush=True)
    return {"hunyuan_pixel": counts}


# ---------------------------------------------------------------------------
# C4. the qk prolog's path: attention(prolog=...) at full width
# ---------------------------------------------------------------------------


def phase_prolog_entry() -> dict:
    """No model passes a prolog (the JAX package's do not either), so the
    variant's path is the entry point itself: ``attention(q, k, v,
    stable=False, prolog={...})`` on bf16 tensors of the CogVideoX 9-frame
    shape (LayerNorm + RoPE) and of the Hunyuan 9-frame joint shape with
    ``kv_len`` (RMS norm + RoPE), each held against the unfused sequence the
    DiTs run (norm and RoPE on q and k, then ``attention``). Returns the
    launch counts of the two calls."""
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.ops.attention import attention
    from alg_tpu_torch.ops.qk_prep import qk_norm_rope
    from alg_tpu_torch.ops.rope import rope_interleaved

    gen = torch.Generator("cuda").manual_seed(5)
    dev, dtype = "cuda", torch.bfloat16
    s_hy = HY_VIDEO_TOKENS[9] + HY_TEXT_LEN
    cases = (("layer", (2, 48, 4276, 64), None), ("rms", (1, 24, s_hy, 128), [HY_VIDEO_TOKENS[9] + HY_TEXT_KEYS]))
    inputs = []
    for mode, shape, kv_len in cases:
        s, d = shape[2], shape[3]
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
        ang = torch.rand(s, d // 2, generator=gen, device=dev) * 6.28
        cos, sin = (f(ang).repeat_interleave(2, -1).contiguous() for f in (torch.cos, torch.sin))
        prolog = {"norm": mode, "eps": 1e-6, "cos": cos, "sin": sin,
                  "q_scale": 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev),
                  "k_scale": 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)}
        if mode == "layer":
            prolog.update(q_bias=0.1 * torch.randn(d, generator=gen, device=dev),
                          k_bias=0.1 * torch.randn(d, generator=gen, device=dev))
        inputs.append((q, k, v, prolog, None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=dev)))
    _reset_counts()
    outs = [attention(q, k, v, kv_len=lens, stable=False, prolog=prolog) for q, k, v, prolog, lens in inputs]
    torch.cuda.synchronize()
    counts = _read_counts()
    want = {name: 0 for name in counts}
    want.update(flash_attention=2, flash_attention_tc=2, qk_prolog=2)  # no CUDA-core forward
    for (mode, shape, _), (q, k, v, pro, lens), out in zip(cases, inputs, outs):
        if mode == "layer":
            q2, k2 = (qk_norm_rope(x, pro[f"{n}_scale"], pro[f"{n}_bias"], pro["cos"], pro["sin"], 1e-6)
                      for x, n in ((q, "q"), (k, "k")))
        else:
            q2, k2 = (rope_interleaved(L.t5_layer_norm(x, pro[f"{n}_scale"], 1e-6), pro["cos"], pro["sin"])
                      for x, n in ((q, "q"), (k, "k")))
        ref = attention(q2, k2, v, kv_len=lens, stable=False)
        size = ref.float().abs().mean().item()
        tol = (min(TOL["bfloat16"][0], FLASH_BF16_ATOL_SHARE * size), TOL["bfloat16"][1])
        err, ok = _close(out, ref, tol)
        ok = ok and out.shape == q.shape and bool(torch.isfinite(out).all())
        print(f"[C4] attention(prolog={{{mode} norm + RoPE}}) bf16 {shape}: max|diff| against the unfused sequence "
              f"{err:.3e} (atol {tol[0]:.3g}, rtol {tol[1]:g}, mean|ref| {size:.3e}): {'PASS' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"[C4] the fused prolog disagrees with the unfused sequence at {shape}")
    print(f"[C4] launches {counts} (want {want})", flush=True)
    if counts != want:
        raise AssertionError(f"[C4] kernel launches {counts} != {want}")
    return counts


# ---------------------------------------------------------------------------
# F. the entry point users call: a checkpoint directory through cli.run
# ---------------------------------------------------------------------------

# configs/cogvideox_alg.yaml as a mapping (the card's machine has no PyYAML), with phase C's cut: 9 frames and
# 4 steps at the config's own 480x720, the ALG interval's end raised to 0.4 (2 three-pass steps, 2 two-pass)
CLI_CONFIG = {
    "model": {"path": "THUDM/CogVideoX-5b-I2V", "dtype": "bfloat16"},
    "generation": {"height": None, "width": None, "num_frames": 9, "num_inference_steps": 4, "guidance_scale": 6.0},
    "alg": {"use_low_pass_guidance": True, "lp_filter_type": "down_up", "lp_filter_in_latent": True,
            "lp_blur_sigma": None, "lp_blur_kernel_size": None, "lp_resize_factor": 0.25,
            "lp_strength_schedule_type": "interval", "schedule_blur_kernel_size": False,
            "schedule_interval_start_time": 0.0, "schedule_interval_end_time": 0.4,
            "schedule_linear_start_weight": None, "schedule_linear_end_weight": None,
            "schedule_linear_end_time": None},
    "video": {"fps": 12},
}
CLI_FRAMES, CLI_HEIGHT, CLI_WIDTH = 9, 480, 720


# the CogVideoX pipeline's encode stages, timed by _CliProbe
COG_STAGES = {"encode_prompt": "T5 encode", "vae_encode_sample": "VAE encode + posterior draw"}


class _CliProbe:
    """Hooks for one ``cli.run`` (or ``serve_cli.run``): the pipeline it
    loads (with the loader's read / convert / copy times), its stage timer
    (the pipeline methods ``stages`` names, the DiT's forwards at
    ``seq_len``), the latents its decode is given and the frames and path of
    its ``write_video`` calls (``written`` the last, ``writes`` all).
    ``on_load(pipe)`` runs on the loaded pipeline."""

    def __init__(self, timer=None, stages=COG_STAGES, seq_len=_cog_seq_len, on_load=None):
        self.timer, self.timings, self.final, self.written, self.writes = timer, {}, [], {}, []
        self.stages, self.seq_len, self.on_load = stages, seq_len, on_load
        self.pipe = self.load_s = None

    def __enter__(self):
        import numpy as np
        import torch

        import alg_tpu_torch.cli as cli
        import alg_tpu_torch.io.video as video

        self._load, self._write, self._hooks = cli.load_pipeline, video.write_video, []

        def load(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe = self._load(*args, timings=self.timings, **kwargs)
            torch.cuda.synchronize()
            self.load_s = time.perf_counter() - t0
            if self.on_load is not None:
                self.on_load(pipe)
            if self.timer is not None:
                for attr, label in self.stages.items():
                    setattr(pipe, attr, self.timer.wrap(label, getattr(pipe, attr)))
                self._hooks = self.timer.hook_dit(pipe.transformer, self.seq_len)
            decode = pipe.decode_latents
            if self.timer is not None:
                decode = self.timer.wrap("VAE tiled decode", decode)

            def decode_kept(latents, *a):
                self.final.append(latents.detach().float().cpu().numpy())
                return decode(latents, *a)

            pipe.decode_latents = decode_kept
            self.pipe = pipe
            return pipe

        def write(path, frames, fps):
            t0 = time.perf_counter()
            out = self._write(path, frames, fps)
            self.written = dict(frames=np.asarray(frames), path=out, seconds=time.perf_counter() - t0)
            self.writes.append(self.written)
            return out

        cli.load_pipeline, video.write_video = load, write
        return self

    def __exit__(self, *exc):
        import alg_tpu_torch.cli as cli
        import alg_tpu_torch.io.video as video

        cli.load_pipeline, video.write_video = self._load, self._write
        for h in self._hooks:
            h.remove()
        return False


def _cli_args(root: str, device: str, out: str):
    from alg_tpu_torch.cli import build_parser

    return build_parser().parse_args(["--model_cache_dir", root, "--output_path", out, "--device", device])


def _written_frames(path: str):
    """What ``write_video`` left at ``path``: its form, and the frames it can
    read back without PIL or ffmpeg (a directory of ``.npy`` frames), or the
    frame count, width and height an MJPEG-AVI's headers state."""
    import os
    import struct

    import numpy as np

    if os.path.isdir(path):
        names = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
        return "npy frames", np.stack([np.load(os.path.join(path, f)) for f in names])
    if path.endswith(".avi"):
        with open(path, "rb") as f:
            head = f.read(4096)
        i = head.index(b"avih") + 8
        frames, width, height = (struct.unpack_from("<I", head, i + 4 * j)[0] for j in (4, 8, 9))
        return "MJPEG-AVI", (frames, height, width)
    return "H.264 (ffmpeg)", os.path.getsize(path)


def phase_cli() -> dict:
    """F: a CogVideoX-5b-I2V checkpoint at the published widths (DiT and
    T5-XXL cut to 2 layers each) through ``cli.run`` with the shipped ALG
    config at phase C's cut (:func:`_cli_over_checkpoint`). Returns the run's
    launch counts."""
    import os
    import shutil
    import tempfile

    from alg_tpu_torch.io import hf_checkpoint as H

    ck = copy.deepcopy(H.COGVIDEOX_5B_I2V)
    ck["transformer"]["num_layers"], ck["text_encoder"]["num_layers"] = 2, 2  # of 42 and 24
    tmp = tempfile.mkdtemp(prefix="alg_cli_")
    try:
        return _cli_over_checkpoint("F", "CogVideoX-5b-I2V", ck, CLI_CONFIG, (CLI_FRAMES, CLI_HEIGHT, CLI_WIDTH),
                                    tmp)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_device_memory()


# the subdirectories the loaders build in fp32 (VAEs, CLIP towers); the rest in the config's bf16
FP32_SUBS = ("vae", "image_encoder", "text_encoder_2")


def _loaded_parts(pipe):
    """(checkpoint subdirectory, module, name map) of each model a loaded pipeline holds."""
    from alg_tpu_torch.io import weights as W

    family = type(pipe).__name__
    if family == "CogVideoXPipeline":
        return (("transformer", pipe.transformer, W.convert_cogvideox_transformer),
                ("vae", pipe.vae, W.convert_cogvideox_vae), ("text_encoder", pipe.t5, W.convert_t5_encoder))
    if family == "WanPipeline":
        return (("transformer", pipe.transformer, W.convert_wan_transformer), ("vae", pipe.vae, W.convert_wan_vae),
                ("text_encoder", pipe.t5, W.convert_t5_encoder),
                ("image_encoder", pipe.clip, W.convert_clip_vision))
    return (("transformer", pipe.transformer, W.convert_hunyuan_transformer),
            ("vae", pipe.vae, W.convert_hunyuan_vae), ("text_encoder", pipe.llava, W.convert_llava),
            ("text_encoder_2", pipe.clip, W.convert_clip_text))


def _check_loaded(tag, pipe, drawn) -> None:
    """Every parameter of the loaded ``pipe`` is the tensor the writer drew:
    bf16 bit for bit, the fp32 modules (``FP32_SUBS``) the bf16 values."""
    import torch

    from alg_tpu_torch.io import weights as W

    compared = {}
    for sub, module, convert in _loaded_parts(pipe):
        want = dict(W.flatten_tree(convert(drawn[sub], module.cfg)))
        got = module.state_dict()
        if set(want) != set(got):
            raise AssertionError(f"[{tag}] {sub}: loaded names differ from the drawn ones")
        dtype = torch.float32 if sub in FP32_SUBS else torch.bfloat16
        for pname, t in got.items():
            w = want[pname]
            same = (torch.equal(t.view(torch.int16), w.view(torch.int16)) if t.dtype == torch.bfloat16
                    else torch.equal(t, w.to(t.dtype)))
            if not same or t.dtype != dtype:
                raise AssertionError(f"[{tag}] {sub}.{pname} ({t.dtype}) is not the drawn tensor")
        compared[f"{sub} ({str(dtype).replace('torch.', '')})"] = sum(t.numel() for t in got.values())
    print(f"[{tag}] loaded parameters equal the drawn tensors bit for bit (fp32 modules the bf16 values): "
          f"{compared} values: PASS", flush=True)


def _print_load(tag, probe) -> None:
    for sub, t in probe.timings.items():
        moved = t["read_s"] + t["convert_s"] + t["copy_s"]
        print(f"[{tag}] load {sub:<14} {t['bytes']:>11} bytes: read {t['read_s']:.3f} s, convert {t['convert_s']:.3f} "
              f"s, copy to the card {t['copy_s']:.3f} s ({t['bytes'] / moved / 1e9:.2f} GB/s over the three)", flush=True)
    print(f"[{tag}] load_pipeline {probe.load_s:.2f} s", flush=True)


def _write_checkpoint(tag, name, write, ck, root):
    """``write(root, ck)`` from seed 0, drawn on the card; prints its bytes and time; returns the tensors drawn."""
    import os

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drawn = write(root, ck, seed=0, device="cuda")
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    print(f"[{tag}] wrote a {name} checkpoint on {_card_line()}: {nbytes} bytes in {write_s:.2f} s "
          f"({nbytes / write_s / 1e9:.2f} GB/s, drawing on the card included)", flush=True)
    return drawn


def _cli_over_checkpoint(tag, name, ck, config, size, tmp):
    """Write the checkpoint ``ck`` (random bf16 tensors from seed 0, drawn on
    the card) under ``tmp`` at ``config``'s model path, and run ``cli.run``
    over it with ``config`` as a parsed mapping on a seeded uint8 image of
    ``size`` = (frames, height, width). Checks that every loaded parameter
    is the tensor the writer drew, bit for bit; the exact kernel launch
    counts of the run (4 DiT forwards: 2 three-pass, 2 two-pass; 2 T5
    encodes); the written video's frames. Prints the write, the load (read,
    convert, copy per component), each stage and the peak device memory.
    Returns (the run's launch counts, the checkpoint's directory)."""
    import os

    import numpy as np
    import torch

    from alg_tpu_torch.cli import run
    from alg_tpu_torch.io import hf_checkpoint as H

    _set_tf32(False, True)
    card = _card_line()
    frames_n, height, width = size
    root = os.path.join(tmp, config["model"]["path"])
    drawn = _write_checkpoint(tag, f"{name} (the published widths, DiT {ck['transformer']['num_layers']} and T5 "
                                   f"{ck['text_encoder']['num_layers']} layers)", H.write_cogvideox, ck, root)

    timer = _StageTimer()
    image = np.random.RandomState(0).randint(0, 256, (height, width, 3)).astype(np.uint8)
    torch.cuda.reset_peak_memory_stats()
    with _CliProbe(timer) as probe:
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(_cli_args(tmp, "cuda", os.path.join(tmp, "out.mp4")), config=config, image=image)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = _read_counts()
    pipe = probe.pipe
    _print_load(tag, probe)

    _check_loaded(tag, pipe, drawn)
    del drawn

    for stage, ms, dit_ms in timer.rows:
        print(f"[{tag}] {stage:<36} {ms:10.1f} ms" + ("" if dit_ms is None else f"  (DiT forward {dit_ms:.1f} ms)"))
    print(f"[{tag}] write_video {probe.written['seconds'] * 1e3:.1f} ms; cli.run total {total_s:.2f} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})", flush=True)

    tcfg, t5cfg = pipe.transformer.cfg, pipe.t5.cfg
    dit_fwd, t5_enc = timer.count("denoise step"), timer.count("T5 encode")
    three, two = timer.count("denoise step (3-pass"), timer.count("denoise step (2-pass")
    flash = tcfg.num_layers * dit_fwd + t5cfg.num_layers * t5_enc  # bf16: every one on the tensor cores
    want = {"qk_prep": 2 * tcfg.num_layers * dit_fwd, "rope_interleaved": 0, "flash_attention": flash,
            "flash_attention_tc": flash, **_NO_TRAINING, **_NO_CUDA_CORES}
    print(f"[{tag}] launches {counts} (want {want}: {dit_fwd} DiT forwards, {t5_enc} T5 encodes)", flush=True)
    if (dit_fwd, t5_enc, three, two) != (4, 2, 2, 2) or counts != want:
        raise AssertionError(f"[{tag}] stage counts ({dit_fwd}, {t5_enc}, {three}, {two}) or launches {counts} "
                             f"!= (4, 2, 2, 2), {want}")

    _check_video(tag, probe.written, probe.final[0], size)
    return counts, root


def _check_video(tag, written, final, size):
    """One ``write_video`` call's record (``_CliProbe.writes``): ``size`` =
    (frames, height, width) finite, non-constant frames, in whatever form
    ``write_video`` chose, and finite final latents. Returns the uint8 frames."""
    import numpy as np

    from alg_tpu_torch.io.video import _frames_to_uint8

    frames_n, height, width = size
    frames, out = written["frames"], written["path"]
    u8 = _frames_to_uint8(frames)
    form, back = _written_frames(out)
    ok = (frames.shape == (frames_n, height, width, 3) and bool(np.isfinite(frames).all()) and u8.dtype == np.uint8
          and float(u8.std()) > 0 and bool(np.isfinite(final).all()))
    if form == "npy frames":
        ok = ok and back.shape == u8.shape and back.dtype == np.uint8 and np.array_equal(back, u8)
    elif form == "MJPEG-AVI":
        ok = ok and back == (frames_n, height, width)
    else:
        ok = ok and back > 0
    print(f"[{tag}] wrote {out} as {form} ({back.shape if form == 'npy frames' else back}); frames {u8.shape} "
          f"{u8.dtype}, mean {u8.mean():.2f} std {u8.std():.2f}, final latents {final.shape} finite: "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[{tag}] the written video is not {frames_n} finite, non-constant {height}x{width}x3 "
                             "uint8 frames")
    return u8


# small checkpoints whose head dims the kernels take (64 and 128; CLIP 80): phase D's and D2's widths
SMALL_COGVIDEOX = {
    "transformer": {"num_attention_heads": 2, "attention_head_dim": 64, "in_channels": 8, "out_channels": 4,
                    "time_embed_dim": 32, "text_embed_dim": 64, "num_layers": 2, "attention_bias": True,
                    "sample_width": 8, "sample_height": 8, "sample_frames": 9, "patch_size": 2, "patch_size_t": None,
                    "max_text_seq_length": 8, "norm_eps": 1e-5, "use_rotary_positional_embeddings": True},
    "vae": {"block_out_channels": [8, 16, 16, 32], "latent_channels": 4, "layers_per_block": 1, "norm_num_groups": 4,
            "norm_eps": 1e-6, "temporal_compression_ratio": 4, "scaling_factor": 0.7, "invert_scale_latents": False},
    "text_encoder": {"vocab_size": 128, "d_model": 64, "d_kv": 64, "d_ff": 128, "num_layers": 2, "num_heads": 2,
                     "relative_attention_num_buckets": 8, "relative_attention_max_distance": 16},
}
SMALL_WAN = {
    "transformer": {"num_attention_heads": 2, "attention_head_dim": 128, "in_channels": 12, "out_channels": 4,
                    "num_layers": 2, "ffn_dim": 64, "freq_dim": 16, "text_dim": 64, "image_dim": 160,
                    "patch_size": [1, 2, 2], "eps": 1e-6},
    "vae": {"base_dim": 8, "z_dim": 4, "dim_mult": [1, 2, 2, 2], "num_res_blocks": 1,
            "temperal_downsample": [False, True, True], "latents_mean": [-0.5, -0.1, 0.2, 0.5],
            "latents_std": [1.0, 1.3, 1.7, 2.0]},
    "text_encoder": {"vocab_size": 128, "d_model": 64, "d_kv": 64, "d_ff": 128, "num_layers": 2, "num_heads": 2,
                     "relative_attention_num_buckets": 8, "relative_attention_max_distance": 16},
    # 64 x 64 images need no resize (clip_preprocess without PIL); head dim 80, 17 tokens
    "image_encoder": {"hidden_size": 160, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
                      "image_size": 64, "patch_size": 16, "hidden_act": "gelu"},
}


def _small_cli_config(path: str, **generation) -> dict:
    cfg = copy.deepcopy(CLI_CONFIG)
    cfg["model"] = {"path": path, "dtype": "float32"}
    cfg["generation"] = {"height": 64, "width": 64, "num_inference_steps": 4, **generation}
    cfg["video"] = {"fps": 8}
    return cfg


def phase_cli_agreement() -> None:
    """A small CogVideoX and a small Wan checkpoint from ``hf_checkpoint``,
    each through ``cli.run`` on the card (the kernels) and on the CPU (the
    plain versions), fp32 with TF32 off: final latents within 2e-3, frames
    above 40 dB, the card's exact launch counts and none on the CPU."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from alg_tpu_torch.cli import run
    from alg_tpu_torch.io import hf_checkpoint as H

    _set_tf32(False, False)
    image = np.random.RandomState(3).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    tmp = tempfile.mkdtemp(prefix="alg_cli_small_")
    try:
        cases = (
            # 4 DiT forwards x 2 layers (2 qk_prep each) + 2 T5 encodes x 2 layers
            ("F2 CogVideoX", "SmallCogVideoX", H.write_cogvideox, SMALL_COGVIDEOX,
             dict(num_frames=5, guidance_scale=6.0, max_sequence_length=8), {},
             {"qk_prep": 16, "rope_interleaved": 0, "flash_attention": 12}),
            # 4 DiT forwards x 2 layers x (2 rope, 3 flash) + 2 UMT5 encodes x 2 layers + 2 CLIP layers
            ("F2 Wan", "SmallWan", H.write_wan, SMALL_WAN,
             dict(num_frames=9, guidance_scale=5.0, max_sequence_length=32), {"lp_resize_factor": 0.4},
             {"qk_prep": 0, "rope_interleaved": 16, "flash_attention": 30}),
        )
        for tag, name, write, ck, generation, alg, want in cases:
            write(os.path.join(tmp, name), ck, seed=4)
            config = _small_cli_config(name, **generation)
            config["alg"].update(alg)
            results = {}
            for dev in ("cpu", "cuda"):
                with _CliProbe() as probe:
                    _reset_counts()
                    run(_cli_args(tmp, dev, os.path.join(tmp, f"{name}_{dev}.mp4")), config=config, image=image)
                    counts = _read_counts()
                results[dev] = (probe.final[0], probe.written["frames"].astype(np.float64), counts)
            _compare_runs(tag, results, want)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_device_memory()


# ---------------------------------------------------------------------------
# G. the fine-tuning workflow: prepare_cli over clips, train_cli over the checkpoint directory, cli.run --lora
# ---------------------------------------------------------------------------


def _write_manifest(tmp: str, clips) -> str:
    """``clips``: [(file name, frames, height, width, seed, extra manifest keys)]: seeded uint8 ``.npy`` clips
    and a JSONL manifest naming them; returns the manifest's path."""
    import os

    import numpy as np

    lines = []
    for name, frames, height, width, seed, extra in clips:
        path = os.path.join(tmp, name)
        np.save(path, np.random.RandomState(seed).randint(0, 256, (frames, height, width, 3)).astype(np.uint8))
        lines.append(json.dumps({"video": path, "prompt": PROMPT, **extra}))
    manifest = os.path.join(tmp, "manifest.jsonl")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    return manifest


def _run_prepare(config, root: str, manifest: str, out_dir: str, device: str, stages: dict, on_load=None):
    """``prepare_cli.run`` over ``manifest`` on ``device``, each of the pipeline
    methods named in ``stages`` ({method: label}) timed between synchronises.
    Returns (the examples as dicts of arrays, the launch counts, one entry a
    example: (ms, [(stage, ms)], peak GiB), the pipeline's load seconds)."""
    import numpy as np
    import torch

    import alg_tpu_torch.cli as cli
    from alg_tpu_torch import prepare_cli
    from alg_tpu_torch.core.config import run_config_from_dict

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    family = run_config_from_dict(config).family
    load0, encode0 = cli.load_pipeline, prepare_cli._ENCODERS[family]
    rows, examples, load_s = [], [], []

    def timed(label, fn):
        def call(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            shape = getattr(args[0], "shape", None) if args else None
            frames = f" ({shape[1]} frame{'s' * (shape[1] != 1)})" if shape is not None and len(shape) == 5 else ""
            rows.append((label + frames, (time.perf_counter() - t0) * 1e3))
            return out
        return call

    def load(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        pipe = load0(*args, **kwargs)
        sync()
        load_s.append(time.perf_counter() - t0)
        for method, label in stages.items():
            setattr(pipe, method, timed(label, getattr(pipe, method)))
        if on_load is not None:
            on_load(pipe)
        return pipe

    def encode(*args, **kwargs):
        rows.clear()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        out = encode0(*args, **kwargs)
        sync()
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
        examples.append(((time.perf_counter() - t0) * 1e3, list(rows), peak))
        return out

    args = prepare_cli.build_parser().parse_args(["--config", "-", "--model_cache_dir", root, "--manifest", manifest,
                                                  "--output_dir", out_dir, "--device", device])
    cli.load_pipeline, prepare_cli._ENCODERS[family] = load, encode
    try:
        _reset_counts()
        written = prepare_cli.run(args, config)
        counts = _read_counts()
    finally:
        cli.load_pipeline, prepare_cli._ENCODERS[family] = load0, encode0
        if cuda:
            _free_device_memory()
    data = []
    for path in written:
        with np.load(path) as z:
            data.append({k: z[k] for k in z.files})
    return data, counts, examples, load_s[0]


def _print_prepare(tag, examples, load_s, card) -> None:
    print(f"[{tag}] prepare_cli.run: load_pipeline {load_s:.2f} s ({card})", flush=True)
    for i, (ms, rows, peak) in enumerate(examples):
        stages = ", ".join(f"{label} {stage_ms:.1f} ms" for label, stage_ms in rows)
        print(f"[{tag}] example {i}: {ms:.1f} ms ({stages}); peak device memory {peak:.2f} GiB", flush=True)


class _StepClock:
    """Times each train step that ``train_cli.run`` takes, between device
    synchronises, by wrapping the step that ``make_train_step`` returns."""

    def __enter__(self):
        import torch

        import alg_tpu_torch.training.train as T

        self.ms, self._make = [], T.make_train_step

        def make(loss_fn, tc):
            step, opt = self._make(loss_fn, tc)

            def timed(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*args, **kwargs)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return out

            return timed, opt

        T.make_train_step = make
        return self

    def __exit__(self, *exc):
        import alg_tpu_torch.training.train as T

        T.make_train_step = self._make
        return False


def _run_train(tag, config, root, data, out_path, extra, card):
    """``train_cli.run`` over the checkpoint directory (no ``--random_init``)
    with ``--data``; returns (its result, launch counts, step ms)."""
    import numpy as np
    import torch

    from alg_tpu_torch import train_cli

    args = train_cli.make_parser().parse_args(
        ["--config", "-", "--model_cache_dir", root, "--data", data, "--rank", "8", "--remat", "--compute_dtype",
         "bfloat16", "--seed", "0", "--lr", "1e-3", "--log_every", "1", "--output", out_path, *extra])
    torch.cuda.reset_peak_memory_stats()
    with _StepClock() as clock:
        _reset_counts()
        t0 = time.perf_counter()
        out = train_cli.run(config, args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _read_counts()
    steps = ", ".join(f"{ms:.1f}" for ms in clock.ms)
    print(f"[{tag}] train_cli.run over the checkpoint directory {' '.join(extra)}: {len(out['losses'])} steps of "
          f"[{steps}] ms, {seconds:.1f} s with the DiT's load, losses {out['losses']}, validation means "
          f"{out['val_losses']}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})",
          flush=True)
    if not (all(np.isfinite(out["losses"])) and all(np.isfinite(out["val_losses"]))):
        raise AssertionError(f"[{tag}] a loss or a validation mean is not finite")
    return out, counts, clock.ms


def _wan_train_step_launches(layers: int) -> dict:
    """Kernel launches of one Wan LoRA step with remat: a block's forward runs
    twice (rope on q and k, then self-attention and the text and image
    cross-attentions, each writing the LSE), then the three attentions'
    backward kernels once; rope's backward is its plain version."""
    return {"qk_prep": 0, "rope_interleaved": 4 * layers, "flash_attention": 6 * layers,
            "flash_attention_lse": 6 * layers, "flash_attention_tc": 6 * layers,
            "flash_attention_bwd_dq": 3 * layers, "flash_attention_bwd_dq_tc": 3 * layers,
            "flash_attention_bwd_dkv": 3 * layers, "flash_attention_bwd_dkv_tc": 3 * layers, **_NO_OPT_IN,
            **_NO_CUDA_CORES}


def _with_zeros(want: dict) -> dict:
    """``want`` over every counted kernel, the others at zero."""
    return {**{name: 0 for name in _kernel_counters()}, **want}


def _check_counts(tag, counts, want) -> None:
    want = _with_zeros(want)
    ok = counts == want
    print(f"[{tag}] launches {counts} (want {want}): {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[{tag}] launches {counts} != {want}")


def _check_trace(tag, prof_dir: str, kernels) -> None:
    """The Chrome trace ``--profile_dir`` holds (``trace_*.json``, beside the
    program's spans in ``spans_*.json``, ``utils/profiling.trace_to``) names
    each of ``kernels`` among its device kernels."""
    import os

    names = sorted(os.listdir(prof_dir))
    traces = [n for n in names if n.startswith("trace_") and n.endswith(".json")]
    if len(traces) != 1 or any(not (n.startswith("spans_") and n.endswith(".json")) for n in names if n not in traces):
        raise AssertionError(f"[{tag}] --profile_dir holds {names}, not one trace file and its spans")
    names = traces
    with open(os.path.join(prof_dir, names[0])) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    found = {k: sum(1 for e in device if k in e.get("name", "")) for k in kernels}
    ok = all(found.values())
    print(f"[{tag}] trace {names[0]}: {os.path.getsize(os.path.join(prof_dir, names[0]))} bytes, {len(device)} device "
          f"kernels; the port's kernels by launches {found}: {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[{tag}] the trace names none of {[k for k, n in found.items() if not n]}")


def phase_finetune_cogvideox() -> dict:
    """G1: a CogVideoX-5b-I2V checkpoint at the published widths (phase F's
    cut: DiT 2 of 42 layers, T5-XXL 2 of 24) written to a temporary
    directory; ``prepare_cli.run`` over 3 seeded 480x720 uint8 clips (one of
    51 frames, cut to 49); ``train_cli.run`` over the same directory on the
    written latents (1 held out, 4 steps, evaluation every 2, rank 8, remat,
    bf16, a profiler trace); then ``cli.run --lora`` with the adapters at
    phase F's cut. Returns the launch counts of the three runs by path."""
    import copy
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from alg_tpu_torch.cli import build_parser, run
    from alg_tpu_torch.io import hf_checkpoint as H
    from alg_tpu_torch.io import model_zoo

    _set_tf32(False, True)
    card = _card_line()
    ck = copy.deepcopy(H.COGVIDEOX_5B_I2V)
    ck["transformer"]["num_layers"], ck["text_encoder"]["num_layers"] = 2, 2  # of 42 and 24
    layers, t5_layers = 2, 2
    tmp = tempfile.mkdtemp(prefix="alg_finetune_")
    counts = {}
    try:
        root = os.path.join(tmp, CLI_CONFIG["model"]["path"])
        t0 = time.perf_counter()
        H.write_cogvideox(root, ck, seed=0, device="cuda")
        torch.cuda.synchronize()
        print(f"[G1] wrote a CogVideoX-5b-I2V checkpoint at the published widths (DiT and T5 2 layers) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        _free_device_memory()
        manifest = _write_manifest(tmp, [(f"clip{i}.npy", frames, 480, 720, 10 + i, {})
                                         for i, frames in enumerate((49, 51, 49))])
        config = {"model": dict(CLI_CONFIG["model"]),
                  "generation": {"height": 480, "width": 720, "num_frames": 49, "guidance_scale": 6.0,
                                 "max_sequence_length": 226}}
        data_dir = os.path.join(tmp, "latents")
        data, counts["prepare_cogvideox"], examples, load_s = _run_prepare(
            config, tmp, manifest, data_dir, "cuda", {"encode_prompt": "T5 encode", "vae_encode_sample": "VAE encode"})
        _print_prepare("G1", examples, load_s, card)
        ok = True
        for i, ex in enumerate(data):
            shapes = {k: v.shape for k, v in ex.items()}
            ok &= (shapes == {"latents": (13, 16, 60, 90), "image_latents": (13, 16, 60, 90),
                              "encoder_hidden_states": (226, 4096)}
                   and all(v.dtype == np.float32 and np.isfinite(v).all() for v in ex.values())
                   and float(np.abs(ex["image_latents"][1:]).max()) == 0.0
                   and float(np.abs(ex["image_latents"][0]).max()) > 0.0 and float(ex["latents"].std()) > 0.0)
            print(f"[G1] example_{i:05d}.npz {shapes}", flush=True)
        print(f"[G1] prepared latents: keys, shapes, float32, finite, image_latents zero past latent frame 0: "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("[G1] the prepared latents are not as alg_tpu writes them")
        # a T5 encode of each example, every layer one tensor-core launch
        _check_counts("G1 prepare", counts["prepare_cogvideox"],
                      {"flash_attention": 3 * t5_layers, "flash_attention_tc": 3 * t5_layers})

        adapters, prof = os.path.join(tmp, "adapters.npz"), os.path.join(tmp, "profile")
        out, counts["train_ckpt_cogvideox"], _ = _run_train(
            "G1", config, tmp, data_dir, adapters,
            ["--val_frac", "0.34", "--steps", "4", "--eval_every", "2", "--profile_dir", prof], card)
        if len(out["losses"]) != 4 or len(out["val_losses"]) != 2:
            raise AssertionError(f"[G1] {len(out['losses'])} steps and {len(out['val_losses'])} validation means, "
                                 "want 4 and 2")
        step = _train_step_launches(layers)
        val = {"qk_prep": 2 * layers, "flash_attention": layers, "flash_attention_tc": layers}  # no_grad forward
        _check_counts("G1 train", counts["train_ckpt_cogvideox"],
                      {k: 4 * step.get(k, 0) + 2 * val.get(k, 0) for k in set(step) | set(val)})
        _check_trace("G1", prof, ("qk_prep_kernel", "flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                                  "flash_bwd_dkv_tc_kernel"))
        adapted = [(path, i) for path, ab in out["trainable"].items() for i in range(ab["A"].shape[0])]
        del out
        _free_device_memory()

        with _CliProbe() as probe:
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            args = build_parser().parse_args(["--model_cache_dir", tmp, "--output_path", os.path.join(tmp, "out.mp4"),
                                              "--device", "cuda", "--lora", adapters])
            written = run(args, config=CLI_CONFIG)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            counts["cli_lora_cogvideox"] = _read_counts()
        merged = probe.pipe.transformer.state_dict()
        base = model_zoo.load_transformer(root, "cogvideox", dtype=torch.bfloat16, device="cuda").state_dict()
        names = {f"{path.split('/')[0]}.{i}.{'.'.join(path.split('/')[1:])}.weight" for path, i in adapted}
        moved = sum(not torch.equal(merged[n], base[n]) for n in names)
        kept = all(torch.equal(t, base[n]) for n, t in merged.items() if n not in names)
        form, back = _written_frames(written)
        frames = probe.written["frames"]
        ok = (moved == len(names) == 6 * layers and kept and frames.shape == (CLI_FRAMES, CLI_HEIGHT, CLI_WIDTH, 3)
              and bool(np.isfinite(frames).all()) and bool(np.isfinite(probe.final[0]).all()))
        print(f"[G1] cli.run --lora {total_s:.2f} s ({card}): the merged DiT differs from the base in {moved} of "
              f"{len(names)} adapted linears, the rest bit-equal: {kept}; wrote {written} as {form}, frames "
              f"{frames.shape}: {'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("[G1] cli.run --lora did not merge the adapters or write the video")
        _check_counts("G1 cli --lora", counts["cli_lora_cogvideox"],
                      {"qk_prep": 2 * layers * 4, "flash_attention": layers * 4 + t5_layers * 2,
                       "flash_attention_tc": layers * 4 + t5_layers * 2})
        del base, merged, probe
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_device_memory()


C15_CLI_CONFIG = {**CLI_CONFIG, "model": {"path": "THUDM/CogVideoX1.5-5B-I2V", "dtype": "bfloat16"},
                  "generation": {**CLI_CONFIG["generation"], "num_frames": C15_FRAMES, "height": C15_HEIGHT,
                                 "width": C15_WIDTH}}


def phase_cogvideox15_checkpoint() -> dict:
    """F3 and G4 over one CogVideoX-1.5-5B-I2V checkpoint at the published
    widths (``hf_checkpoint.COGVIDEOX15_5B_I2V``: a linear patch embed over
    32·2·2·2, the ofs embedding, a VAE with ``invert_scale_latents``; DiT and
    T5-XXL cut to 2 layers). F3: ``cli.run`` over it at phase C5's cut (9
    frames, 768x1360, 4 steps), loaded bit-equal, with exact launches and the
    written frames (:func:`_cli_over_checkpoint`). G4: ``prepare_cli.run``
    over one seeded 85-frame 768x1360 uint8 clip (22 latent frames, a
    multiple of the temporal patch), then 2 LoRA steps of ``train_cli.run``
    over the directory on that example (rank 8, remat, bf16): S = 45,106, so
    the LSE, dq and dkv run at [1, 48, 45106, 64]. Returns the launch counts
    by path."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from alg_tpu_torch.io import hf_checkpoint as H

    layers, t5_layers = 2, 2  # of 42 and 24
    ck = copy.deepcopy(H.COGVIDEOX15_5B_I2V)
    ck["transformer"]["num_layers"], ck["text_encoder"]["num_layers"] = layers, t5_layers
    tmp = tempfile.mkdtemp(prefix="alg_cogvideox15_")
    counts = {}
    try:
        counts["cli_cogvideox15"], _ = _cli_over_checkpoint("F3", "CogVideoX-1.5-5B-I2V", ck, C15_CLI_CONFIG,
                                                            (C15_FRAMES, C15_HEIGHT, C15_WIDTH), tmp)
        _free_device_memory()
        card = _card_line()
        manifest = _write_manifest(tmp, [("clip0.npy", 85, C15_HEIGHT, C15_WIDTH, 40, {})])
        config = {"model": dict(C15_CLI_CONFIG["model"]),
                  "generation": {"height": C15_HEIGHT, "width": C15_WIDTH, "num_frames": 85, "guidance_scale": 6.0,
                                 "max_sequence_length": 226}}
        data_dir = os.path.join(tmp, "latents")
        data, counts["prepare_cogvideox15"], examples, load_s = _run_prepare(
            config, tmp, manifest, data_dir, "cuda", {"encode_prompt": "T5 encode", "vae_encode_sample": "VAE encode"})
        _print_prepare("G4", examples, load_s, card)
        ex = data[0]
        shapes = {k: v.shape for k, v in ex.items()}
        ok = (shapes == {"latents": (22, 16, 96, 170), "image_latents": (22, 16, 96, 170),
                         "encoder_hidden_states": (226, 4096)}
              and all(v.dtype == np.float32 and np.isfinite(v).all() for v in ex.values())
              and float(np.abs(ex["image_latents"][1:]).max()) == 0.0 and float(ex["latents"].std()) > 0.0)
        print(f"[G4] example_00000.npz {shapes}: 22 latent frames of 85, float32, finite, image_latents zero past "
              f"latent frame 0: {'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("[G4] the prepared 1.5 latents are not as alg_tpu writes them")
        _check_counts("G4 prepare", counts["prepare_cogvideox15"],
                      {"flash_attention": t5_layers, "flash_attention_tc": t5_layers})

        s = 226 + ex["latents"].shape[0] // 2 * (ex["latents"].shape[2] // 2) * (ex["latents"].shape[3] // 2)
        if s != COGVIDEOX15_S[81]:
            raise AssertionError(f"[G4] the train step's S is {s}, not {COGVIDEOX15_S[81]}")
        out, counts["train_ckpt_cogvideox15"], _ = _run_train(
            "G4", config, tmp, data_dir, os.path.join(tmp, "adapters.npz"), ["--steps", "2"], card)
        if len(out["losses"]) != 2:
            raise AssertionError(f"[G4] {len(out['losses'])} steps, want 2")
        step = _train_step_launches(layers)
        print(f"[G4] 2 LoRA steps at S = {s}: the LSE, dq and dkv at [1, 48, {s}, 64]", flush=True)
        _check_counts("G4 train", counts["train_ckpt_cogvideox15"], {k: 2 * n for k, n in step.items()})
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_device_memory()


WAN_FINETUNE_CONFIG = {
    "model": {"path": "Wan-AI/Wan2.1-I2V-14B-480P-Diffusers", "dtype": "bfloat16"},
    "generation": {"height": 480, "width": 832, "num_frames": 81, "guidance_scale": 5.0, "max_sequence_length": 512},
}


def phase_finetune_wan() -> dict:
    """G2: a Wan2.1-I2V-14B checkpoint at the published widths (DiT 2 of 40
    layers, UMT5-XXL 2 of 24, CLIP ViT-H and the VAE whole) written to a
    temporary directory; ``prepare_cli.run`` over two seeded 81-frame 480x832
    uint8 clips, the second with ``"flf2v": true``; then 2 LoRA steps of
    ``train_cli.run`` over the directory at 81 frames (S = 32,760), remat,
    bf16. Returns the launch counts of both runs by path."""
    import copy
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from alg_tpu_torch.io import hf_checkpoint as H

    _set_tf32(False, True)
    card = _card_line()
    ck = copy.deepcopy(H.WAN21_I2V_14B)
    ck["transformer"]["num_layers"], ck["text_encoder"]["num_layers"] = 2, 2  # of 40 and 24
    layers, t5_layers, clip_layers = 2, 2, ck["image_encoder"]["num_hidden_layers"]
    tmp = tempfile.mkdtemp(prefix="alg_finetune_wan_")
    counts = {}
    try:
        root = os.path.join(tmp, WAN_FINETUNE_CONFIG["model"]["path"])
        t0 = time.perf_counter()
        H.write_wan(root, ck, seed=0, device="cuda")
        torch.cuda.synchronize()
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        print(f"[G2] wrote a Wan2.1-I2V-14B checkpoint at the published widths (DiT and UMT5 2 layers, CLIP ViT-H "
              f"and the VAE whole): {nbytes} bytes in {time.perf_counter() - t0:.2f} s", flush=True)
        _free_device_memory()
        manifest = _write_manifest(tmp, [("clip0.npy", 81, 480, 832, 20, {}),
                                         ("clip1.npy", 81, 480, 832, 21, {"flf2v": True})])
        data_dir = os.path.join(tmp, "latents")
        data, counts["prepare_wan"], examples, load_s = _run_prepare(
            WAN_FINETUNE_CONFIG, tmp, manifest, data_dir, "cuda",
            {"encode_prompt": "UMT5 encode", "encode_image": "CLIP ViT-H encode",
             "_encode_video_condition": "VAE encode"})
        _print_prepare("G2", examples, load_s, card)
        ok = True
        for i, ex in enumerate(data):
            shapes = {k: v.shape for k, v in ex.items()}
            mask = ex["condition"][:4]
            masked = mask[:, 0].min() == 1.0 and np.abs(mask[:, 1:-1]).max() == 0.0
            if i == 1:  # FLF2V: the last pixel frame in the last latent frame's fourth t-channel
                masked = masked and mask[3, -1].min() == 1.0 and np.abs(mask[:3, -1]).max() == 0.0
                masked = masked and float(np.abs(ex["condition"][4:, -1]).max()) > 0.0
            else:
                masked = masked and np.abs(mask[:, -1]).max() == 0.0
            ok &= (shapes == {"latents": (16, 21, 60, 104), "condition": (20, 21, 60, 104),
                              "encoder_hidden_states": (512, 4096), "encoder_hidden_states_image": (257, 1280)}
                   and all(v.dtype == np.float32 and np.isfinite(v).all() for v in ex.values()) and bool(masked))
            print(f"[G2] example_{i:05d}.npz {shapes}, mask block as the reference builds it "
                  f"({'FLF2V' if i == 1 else 'first frame'}): {bool(masked)}", flush=True)
        print(f"[G2] prepared latents: keys, shapes, float32, finite, mask blocks: {'PASS' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError("[G2] the prepared latents are not as alg_tpu writes them")
        # each example: a UMT5 encode (tensor cores) and a CLIP ViT-H encode in fp32 (CUDA cores)
        _check_counts("G2 prepare", counts["prepare_wan"],
                      {"flash_attention": 2 * (t5_layers + clip_layers), "flash_attention_tc": 2 * t5_layers,
                       "flash_attention_cuda_core": 2 * clip_layers})

        out, counts["train_ckpt_wan"], _ = _run_train("G2", WAN_FINETUNE_CONFIG, tmp, data_dir,
                                                      os.path.join(tmp, "adapters.npz"), ["--steps", "2"], card)
        if len(out["losses"]) != 2:
            raise AssertionError(f"[G2] {len(out['losses'])} steps, want 2")
        _check_counts("G2 train", counts["train_ckpt_wan"],
                      {k: 2 * n for k, n in _wan_train_step_launches(layers).items()})
        del out
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_device_memory()


def phase_finetune_agreement() -> None:
    """G3: a small CogVideoX and a small Wan checkpoint (phase F2's) through
    ``prepare_cli.run`` on the card (the kernels) and on the CPU (the plain
    versions), fp32 with TF32 off: every array within atol 1e-4 + rtol 1e-4,
    the mask blocks exact, the card's exact launch counts and none on the
    CPU."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from alg_tpu_torch.io import hf_checkpoint as H

    _set_tf32(False, False)
    tmp = tempfile.mkdtemp(prefix="alg_prepare_small_")
    try:
        cases = (
            # one example: a T5 encode of 2 layers
            ("G3 CogVideoX", "SmallCogVideoX", H.write_cogvideox, SMALL_COGVIDEOX, [("c0.npy", 9, 64, 64, 30, {})],
             dict(max_sequence_length=8), {"flash_attention": 2, "flash_attention_cuda_core": 2}),
            # two examples, the second FLF2V: a UMT5 encode of 2 layers and a CLIP encode of 2 layers each
            ("G3 Wan", "SmallWan", H.write_wan, SMALL_WAN,
             [("w0.npy", 9, 64, 64, 31, {}), ("w1.npy", 9, 64, 64, 32, {"flf2v": True})],
             dict(max_sequence_length=32), {"flash_attention": 8, "flash_attention_cuda_core": 8}),
        )
        for tag, name, write, ck, clips, generation, want in cases:
            write(os.path.join(tmp, name), ck, seed=4)
            case_dir = os.path.join(tmp, tag.split()[1])
            os.makedirs(case_dir)
            manifest = _write_manifest(case_dir, clips)
            config = {"model": {"path": name, "dtype": "float32"},
                      "generation": {"height": 64, "width": 64, "num_frames": 9, **generation}}
            runs = {dev: _run_prepare(config, tmp, manifest, os.path.join(case_dir, dev), dev, {})
                    for dev in ("cpu", "cuda")}
            (data_c, n_c, _, _), (data_g, n_g, _, _) = runs["cpu"], runs["cuda"]
            ok, errs = len(data_c) == len(data_g) == len(clips), {}
            for ex_c, ex_g in zip(data_c, data_g):
                ok &= sorted(ex_c) == sorted(ex_g)
                for k in ex_c:
                    a, b = ex_c[k], ex_g[k]
                    ok &= a.shape == b.shape and a.dtype == b.dtype
                    errs[k] = max(errs.get(k, 0.0), float(np.abs(a.astype(np.float64) - b).max()))
                    ok &= bool(np.allclose(b, a, atol=1e-4, rtol=1e-4))
                if "condition" in ex_c:
                    ok &= bool(np.array_equal(ex_c["condition"][:4], ex_g["condition"][:4]))
            want = _with_zeros(want)
            ok &= not any(n_c.values()) and n_g == want
            print(f"[{tag}] prepare_cli.run card (kernels) vs CPU (plain), fp32, {len(clips)} example(s): max|diff| "
                  f"by key {errs} (atol 1e-4 + rtol 1e-4; mask blocks exact), launches card {n_g} (want {want}) / "
                  f"CPU {n_c}: {'PASS' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"[{tag}] the card's and the CPU's prepared latents disagree")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_device_memory()


# ---------------------------------------------------------------------------
# D. the same path on the card (kernels) and on the CPU (plain versions)
# ---------------------------------------------------------------------------


# Card against CPU with int8 attention on, fp32. On the same input the kernel and its plain version agree to
# the phase-B tolerances (and the on-card tests hold them there at small shapes), but over 4 denoise steps the
# two runs' activations differ in the last bits (GEMMs in another order), so a q, k, v or P value on a rounding
# tie takes the neighbouring code in one of them: a K code moves that key's weight in every row by about 1%, a
# P code moves a weight by 1/127 of the row's largest. The small pipelines attend over 40 to 60 tokens, where
# one key carries a large share of a row, and their random weights carry a difference of 1e-6 to 1e-4 in the
# run without int8, so a few flips show in the latents at the size of the mode's own effect (printed beside
# them: about 2e-2 at the largest, 2e-3 to 5e-3 on the mean). What this phase can hold is therefore coarse:
# the largest difference to 1e-1, the mean to 1e-2, the decoded frames to the same 40 dB as without int8.
INT8_LATENT_MAX, INT8_LATENT_MEAN = 1e-1, 1e-2


def _psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _compare_runs(tag, results, want_card, atol=2e-3, mean_atol=None, exact=None) -> dict:
    """``results[dev] = (latents, frames in [0, 1], launch counts)``: the card
    against the CPU, and the launch counts of both. ``mean_atol`` also
    bounds the mean difference; ``exact`` (the CPU latents of the run
    without int8) is what the int8 mode's own effect is printed against.
    Returns the card's launch counts."""
    import numpy as np

    (lat_c, fr_c, n_c), (lat_g, fr_g, n_g) = results["cpu"], results["cuda"]
    err, mean_err = float(np.abs(lat_g - lat_c).max()), float(np.abs(lat_g - lat_c).mean())
    psnr = _psnr(fr_g, fr_c)
    # an fp32 run: every flash launch is one of the CUDA-core kernel, every int8 launch one of the fp32 entry
    want_card = {**_NO_TRAINING, **_NO_TENSOR_CORES, **want_card,
                 "flash_attention_cuda_core": want_card["flash_attention"],
                 "flash_attention_int8_tc_fp32": want_card.get("flash_attention_int8", 0)}
    ok = (err <= atol and (mean_atol is None or mean_err <= mean_atol) and psnr > 40.0 and not any(n_c.values())
          and n_g == want_card)
    mean_txt = "" if mean_atol is None else f", mean|diff| {mean_err:.3e} (atol {mean_atol:g})"
    mode_txt = "" if exact is None else (f"; the mode moves the CPU run's latents by max {np.abs(lat_c - exact).max():.3e}, "
                                         f"mean {np.abs(lat_c - exact).mean():.3e}")
    print(f"[{tag}] small pipeline, card (kernels) vs CPU (plain), fp32: latents max|diff| {err:.3e} (atol {atol:g})"
          f"{mean_txt}, frames PSNR {psnr:.1f} dB (> 40){mode_txt}, launches card {n_g} (want {want_card}) / CPU {n_c}: "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[{tag}] card and CPU runs of the small pipeline disagree")
    return n_g


def _small_runs(make_pipe, kw, mode=None) -> dict:
    """``{dev: (latents, frames, launch counts)}`` of ``make_pipe(dev)(**kw)``
    on the CPU and on the card, under the int8 attention mode ``mode``."""
    import numpy as np
    import torch

    from alg_tpu_torch.ops.attention import set_attention_int8

    results = {}
    set_attention_int8(mode)
    try:
        for dev in ("cpu", "cuda"):
            pipe = make_pipe(dev)
            _reset_counts()
            lat = pipe(**kw)
            frames = pipe.decode_latents(torch.from_numpy(lat).to(dev)).cpu().numpy()
            results[dev] = (lat, np.clip(frames / 2 + 0.5, 0, 1), _read_counts())
    finally:
        set_attention_int8(False)
    return results


def phase_agreement() -> dict:
    import copy
    import dataclasses

    import numpy as np
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer, CogVideoXTransformerConfig
    from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE, CogVideoXVAEConfig
    from alg_tpu_torch.models.t5 import T5Config, T5Encoder
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

    def make_pipe(dev):
        dit, t5, vae = (copy.deepcopy(m).to(dev) for m in mods)
        return CogVideoXPipeline(transformer=dit, vae=vae, t5=t5, tokenize=_seeded_tokenize(t5cfg.vocab_size),
                                 device=dev)

    # 4 DiT forwards x 2 layers (2 qk_prep each) + 2 T5 encodes x 2 layers
    base = _small_runs(make_pipe, kw)
    _compare_runs("D", base, {"qk_prep": 16, "rope_interleaved": 0, "flash_attention": 12})
    counts = {}
    for mode in ("qk", "full"):  # the DiT's 8 attentions through the fp32 int8 kernel, T5's 4 where they were
        counts[f"agreement_cogvideox_int8_{mode}"] = _compare_runs(
            f"D int8 {mode}", _small_runs(make_pipe, kw, mode),
            {"qk_prep": 16, "rope_interleaved": 0, "flash_attention": 4, "flash_attention_int8": 8},
            atol=INT8_LATENT_MAX, mean_atol=INT8_LATENT_MEAN, exact=base["cpu"][0])
    # the sampling surface: pixel-space ALG (gaussian blur, linear schedule), DPM and stochastic DDIM
    for name, scheduler, over in (("pixel", "ddim", _pixel_kwargs(**PIXEL_SCHEDULES["linear"])),
                                  ("dpm", "dpm", {}), ("eta", "ddim", {"eta": 0.5})):
        t0 = time.perf_counter()
        runs = _small_runs(lambda dev: dataclasses.replace(make_pipe(dev), scheduler=scheduler), {**kw, **over})
        counts[f"agreement_cogvideox_{name}"] = _compare_runs(
            f"D {name}", runs, {"qk_prep": 16, "rope_interleaved": 0, "flash_attention": 12})
        print(f"[D {name}] wall time {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def phase_agreement_cogvideox15() -> dict:
    """D4: a small CogVideoX-1.5 pipeline (head dim 64, 2 layers, temporal
    patches of 2, the ofs embedding, a VAE with ``invert_scale_latents``) on
    the card through the kernels and on the CPU through the plain versions,
    fp32 with TF32 off, 9 frames (3 latent frames padded to 4) at 64x64:
    latent ALG and pixel-space ALG, each within 2e-3 and above 40 dB with
    exact launches (D's bounds). Returns the card's counts by path."""
    import copy

    import numpy as np
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer, CogVideoXTransformerConfig
    from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE, CogVideoXVAEConfig
    from alg_tpu_torch.models.t5 import T5Config, T5Encoder
    from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline

    _set_tf32(False, False)
    tcfg = CogVideoXTransformerConfig(num_attention_heads=2, attention_head_dim=64, in_channels=8, out_channels=4,
                                      time_embed_dim=32, ofs_embed_dim=32, text_embed_dim=64, num_layers=2,
                                      sample_height=300, sample_width=300, patch_size_t=2, max_text_seq_length=8)
    t5cfg = T5Config(vocab_size=128, d_model=64, d_kv=64, d_ff=128, num_layers=2, num_heads=2,
                     relative_attention_num_buckets=8, relative_attention_max_distance=16)
    vcfg = CogVideoXVAEConfig(block_out_channels=(8, 16, 16, 32), latent_channels=4, layers_per_block=1,
                              norm_num_groups=4, invert_scale_latents=True)
    gen = torch.Generator("cpu").manual_seed(5)
    mods = [L.init_random_(m, gen) for m in (CogVideoXTransformer(tcfg), T5Encoder(t5cfg), CogVideoXVAE(vcfg))]
    image = np.random.RandomState(5).uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)
    kw = _alg_kwargs(image=image, prompt=PROMPT, height=64, width=64, num_frames=9, max_sequence_length=8,
                     output_type="latent")

    def make_pipe(dev):
        dit, t5, vae = (copy.deepcopy(m).to(dev) for m in mods)
        return CogVideoXPipeline(transformer=dit, vae=vae, t5=t5, tokenize=_seeded_tokenize(t5cfg.vocab_size),
                                 device=dev)

    counts = {}
    # 4 DiT forwards x 2 layers (2 qk_prep each) + 2 T5 encodes x 2 layers
    for name, over in (("", {}), ("_pixel", _pixel_kwargs(**PIXEL_SCHEDULES["linear"]))):
        runs = _small_runs(make_pipe, {**kw, **over})
        if runs["cuda"][0].shape != (1, 4, 4, 8, 8):
            raise AssertionError(f"[D4{name}] latents {runs['cuda'][0].shape}, want the 4 padded latent frames")
        counts[f"agreement_cogvideox15{name}"] = _compare_runs(
            f"D4{name.replace('_', ' ')}", runs, {"qk_prep": 16, "rope_interleaved": 0, "flash_attention": 12})
    return counts


def phase_agreement_wan() -> dict:
    import copy

    import numpy as np
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionModel
    from alg_tpu_torch.models.t5 import T5Config, T5Encoder
    from alg_tpu_torch.models.wan.transformer import WanTransformer, WanTransformerConfig
    from alg_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig
    from alg_tpu_torch.pipelines.wan import WanPipeline

    _set_tf32(False, False)
    tcfg = WanTransformerConfig(num_attention_heads=2, attention_head_dim=128, in_channels=12, out_channels=4,
                                num_layers=2, ffn_dim=64, freq_dim=16, text_dim=64, image_dim=160)
    t5cfg = T5Config(vocab_size=128, d_model=64, d_kv=64, d_ff=128, num_layers=2, num_heads=2,
                     relative_attention_num_buckets=8, relative_attention_max_distance=16,
                     per_layer_relative_bias=True)
    ccfg = CLIPVisionConfig(hidden_size=160, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14)  # head dim 80, 17 tokens
    vcfg = WanVAEConfig(base_dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1,
                        latents_mean=(-0.5, -0.1, 0.2, 0.5), latents_std=(1.0, 1.3, 1.7, 2.0))
    gen = torch.Generator("cpu").manual_seed(2)
    mods = [L.init_random_(m, gen) for m in (WanTransformer(tcfg), T5Encoder(t5cfg), CLIPVisionModel(ccfg),
                                             WanVAE(vcfg))]
    rng = np.random.RandomState(2)
    image = rng.uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)
    pixels = torch.from_numpy(rng.randn(1, 3, 56, 56).astype(np.float32))
    kw = _alg_kwargs(image=image, prompt=PROMPT, height=64, width=64, num_frames=9, max_sequence_length=32,
                     guidance_scale=5.0, lp_resize_factor=0.4, output_type="latent")

    def runs(**over):
        results = {}
        for dev in ("cpu", "cuda"):
            dit, t5, clip, vae = (copy.deepcopy(m).to(dev) for m in mods)
            pipe = WanPipeline(transformer=dit, vae=vae, t5=t5, clip=clip,
                               tokenize=_seeded_tokenize_mask(t5cfg.vocab_size), device=dev)
            _reset_counts()
            with torch.no_grad():
                image_embeds = clip(pixels.to(dev))[-2]
            lat = pipe(image_embeds=image_embeds, **{**kw, **over})
            frames = pipe.decode_latents(torch.from_numpy(lat).to(dev)).cpu().numpy()
            results[dev] = (lat, np.clip(frames / 2 + 0.5, 0, 1), _read_counts())
        return results

    # 4 DiT forwards x 2 layers x (2 rope, 3 flash) + 2 UMT5 encodes x 2 layers + 2 CLIP layers
    want = {"qk_prep": 0, "rope_interleaved": 16, "flash_attention": 30}
    _compare_runs("D2", runs(), want)
    t0 = time.perf_counter()
    pixel = _compare_runs("D2 pixel", runs(lp_filter_in_latent=False), want)  # down_up 0.4 on the RGB frame
    print(f"[D2 pixel] wall time {time.perf_counter() - t0:.1f} s", flush=True)
    return {"agreement_wan_pixel": pixel}


def phase_agreement_hunyuan() -> dict:
    import copy

    import numpy as np
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel, CLIPVisionConfig
    from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformer, HunyuanVideoTransformerConfig
    from alg_tpu_torch.models.hunyuan.vae import HunyuanVAE, HunyuanVAEConfig
    from alg_tpu_torch.models.llama import LlamaConfig, LlavaConfig, LlavaModel
    from alg_tpu_torch.pipelines.hunyuan import HunyuanVideoPipeline

    _set_tf32(False, False)
    tcfg = HunyuanVideoTransformerConfig(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=128,
                                         num_layers=1, num_single_layers=1, num_refiner_layers=1, mlp_ratio=2.0,
                                         text_embed_dim=256, pooled_projection_dim=128)
    lcfg = LlavaConfig(
        text=LlamaConfig(vocab_size=128, hidden_size=256, intermediate_size=128, num_hidden_layers=3,
                         num_attention_heads=2, num_key_value_heads=1, rope_theta=10000.0),  # head dim 128, GQA
        vision=CLIPVisionConfig(hidden_size=128, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                                image_size=28, patch_size=14, hidden_act="quick_gelu"),  # head dim 64, 5 tokens
        image_token_index=120, pad_token_id=0)
    ccfg = CLIPTextConfig(vocab_size=64, hidden_size=128, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=2, max_position_embeddings=16, eos_token_id=63)  # head dim 64
    vcfg = HunyuanVAEConfig(block_out_channels=(8, 16, 16, 16), latent_channels=4, layers_per_block=1,
                            norm_num_groups=4)
    # the chat template cut to the small Llava: an 8-token head, the image block (2 x 2 patches) at [5, 9)
    template = {"template": "{}", "crop_start": 8, "image_emb_start": 5, "image_emb_end": 9, "image_emb_len": 4,
                "double_return_token_id": 7}
    tok_llama, tok_clip, image_processor = _hunyuan_hooks(template, lcfg.image_token_index, lcfg.pad_token_id,
                                                          10, 100, ccfg.eos_token_id)
    gen = torch.Generator("cpu").manual_seed(3)
    mods = [L.init_random_(m, gen) for m in (HunyuanVideoTransformer(tcfg), LlavaModel(lcfg), CLIPTextModel(ccfg),
                                             HunyuanVAE(vcfg))]
    image = np.random.RandomState(3).uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)
    # true CFG with ALG: 2 three-pass steps, then 2 two-pass; the empty negative prompt goes through
    # encode_prompt against a black image (1 prompt token, the rest of the row padding)
    kw = _alg_kwargs(image=image, prompt="a red fox runs", negative_prompt="", height=64, width=64, num_frames=9,
                     true_cfg_scale=2.0, lp_resize_factor=0.625, prompt_template=template, max_sequence_length=20,
                     output_type="latent")

    def make_pipe(dev):
        dit, llava, clip, vae = (copy.deepcopy(m).to(dev) for m in mods)
        return HunyuanVideoPipeline(transformer=dit, vae=vae, llava=llava, clip=clip, tokenize_llama=tok_llama,
                                    tokenize_clip=tok_clip, image_processor=image_processor, device=dev)

    # 4 DiT forwards x (1 refiner + 1 double + 1 single block; rope on q and k of the last two)
    # + 2 prompt encodes x (3 Llama + 2 CLIP vision + 2 CLIP text layers)
    base = _small_runs(make_pipe, kw)
    want = {"qk_prep": 0, "rope_interleaved": 16, "flash_attention": 26}
    _compare_runs("D3", base, want)
    # int8 "full" with kv_len at head dim 128: the double and the single block's joint attention (8 calls)
    counts = {"agreement_hunyuan_int8_full": _compare_runs(
        "D3 int8 full", _small_runs(make_pipe, kw, "full"),
        {"qk_prep": 0, "rope_interleaved": 16, "flash_attention": 18, "flash_attention_int8": 8},
        atol=INT8_LATENT_MAX, mean_atol=INT8_LATENT_MEAN, exact=base["cpu"][0])}
    t0 = time.perf_counter()  # pixel-space ALG with the argmax encode on the 3-pass steps
    counts["agreement_hunyuan_pixel"] = _compare_runs(
        "D3 pixel", _small_runs(make_pipe, {**kw, "lp_filter_in_latent": False}), want)
    print(f"[D3 pixel] wall time {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


# ---------------------------------------------------------------------------
# E. the training slice: CogVideoX-5b LoRA steps through the kernels and their backward
# ---------------------------------------------------------------------------


def _cog_train_batch(cfg, frames_latent, gen, dtype):
    import torch

    dev = gen.device
    shape = (1, frames_latent, cfg.out_channels, 60, 90)  # 480 x 720
    return {"latents": torch.randn(shape, generator=gen, device=dev).to(dtype),
            "image_latents": torch.randn(shape, generator=gen, device=dev).to(dtype),
            "encoder_hidden_states": torch.randn((1, cfg.max_text_seq_length, cfg.text_embed_dim), generator=gen,
                                                 device=dev).to(dtype)}


def _train_step_launches(layers: int) -> dict:
    """Kernel launches of one CogVideoX LoRA step with remat: every block runs
    its forward twice (PyTorch's checkpoint keeps autograd on in the first
    pass, so both write the LSE), then its two backward kernels once."""
    return {"qk_prep": 4 * layers, "rope_interleaved": 0, "flash_attention": 2 * layers,
            "flash_attention_lse": 2 * layers, "flash_attention_tc": 2 * layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dq_tc": layers, "flash_attention_bwd_dkv": layers,
            "flash_attention_bwd_dkv_tc": layers, **_NO_OPT_IN, **_NO_CUDA_CORES}


def phase_train_entry() -> dict:
    """The training entry point, ``train_cli.run`` over a parsed config, on its
    defaults for the card: the full-width random DiT (bf16), synthetic 9-frame
    examples prefetched to the device, rank-8 LoRA with remat and bf16
    compute, 3 steps, a checkpoint, the peft export; then ``--resume`` for a
    fourth step. Returns the launch counts of both runs together."""
    import os
    import tempfile

    import numpy as np
    import torch

    from alg_tpu_torch import train_cli
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformerConfig

    _set_tf32(False, True)
    config = {"model": {"path": "THUDM/CogVideoX-5b-I2V", "dtype": "bfloat16"},
              "generation": {"height": 480, "width": 720, "num_frames": 9, "max_sequence_length": 226}}
    layers = CogVideoXTransformerConfig().num_layers
    want_step = _train_step_launches(layers)
    total = {name: 0 for name in want_step}
    with tempfile.TemporaryDirectory() as tmp:
        out_path, ckpt = os.path.join(tmp, "adapters.npz"), os.path.join(tmp, "ckpt")
        common = ["--config", "-", "--random_init", "--synthetic", "2", "--rank", "8", "--remat", "--compute_dtype",
                  "bfloat16", "--weight_decay", "0.01", "--seed", "0", "--checkpoint_dir", ckpt, "--save_every", "3",
                  "--output", out_path]
        losses = []
        for steps, extra in ((3, []), (4, ["--resume"])):
            args = train_cli.make_parser().parse_args(common + ["--steps", str(steps)] + extra)
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            out = train_cli.run(config, args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _read_counts()
            ran = len(out["losses"])
            losses += out["losses"]
            print(f"[E] train_cli.run {' '.join(['--steps', str(steps)] + extra)}: {ran} step(s) in {seconds:.1f} s "
                  f"with the DiT's set-up, losses {out['losses']}, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, launches {counts}", flush=True)
            want = {name: n * ran for name, n in want_step.items()}
            if out["steps"] != steps or ran != (3 if not extra else 1) or counts != want:
                raise AssertionError(f"train_cli.run took {ran} steps to step {out['steps']} with launches {counts}, "
                                     f"want {want}")
            if not all(np.isfinite(out["losses"])) or any(str(t.device) == "cpu" for ab in out["trainable"].values()
                                                          for t in ab.values()):
                raise AssertionError("train_cli.run: a loss is not finite or an adapter is not on the card")
            for name in total:
                total[name] += counts[name]
            del out
            torch.cuda.empty_cache()
        saved = sorted(os.listdir(ckpt))
        with np.load(out_path) as z:
            state = {k: z[k] for k in z.files}
        b_moved = all(np.abs(v).max() > 0 for k, v in state.items() if k.endswith("lora_B.weight"))
        shapes_ok = all(v.shape[0 if k.endswith("lora_A.weight") else 1] == 8 and np.isfinite(v).all()
                        for k, v in state.items())
        ok = len(state) == 2 * 6 * layers and b_moved and shapes_ok and saved == ["step_00000003.npz",
                                                                                  "step_00000004.npz"]
        print(f"[E] train_cli.run: peft file of {len(state)} arrays (want {2 * 6 * layers}), every lora_B moved: "
              f"{b_moved}, rank and finiteness: {shapes_ok}, checkpoints {saved}: {'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("train_cli.run: the exported adapters or the checkpoints are not as expected")
    return total


def phase_train() -> dict:
    """Full-width CogVideoX-5b LoRA train steps; returns the launch counts of the whole run."""
    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.cogvideox.transformer import (CogVideoXTransformer, CogVideoXTransformerConfig,
                                                            cogvideox_rope)
    from alg_tpu_torch.training.lora import DEFAULT_TARGETS, init_lora_params, make_lora_loss
    from alg_tpu_torch.training.losses import make_cogvideox_vpred_loss
    from alg_tpu_torch.training.train import TrainConfig, make_train_step, tree_leaves

    _set_tf32(False, True)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    cfg = CogVideoXTransformerConfig()
    t0 = time.perf_counter()
    dit = L.init_random_(CogVideoXTransformer(cfg, device=dev, dtype=torch.bfloat16), gen).requires_grad_(False)
    base = dict(dit.named_parameters())
    frozen = {name: p.clone() for name, p in base.items()}
    loras = init_lora_params(gen, base, rank=8, targets=DEFAULT_TARGETS, prefixes=("blocks",))
    for leaf in tree_leaves(loras):
        leaf.requires_grad_()
    n_lora = sum(leaf.numel() for leaf in tree_leaves(loras))
    torch.cuda.synchronize()
    print(f"[E] DiT {sum(p.numel() for p in base.values()) / 1e9:.2f} B params (bf16, frozen) and {len(loras)} "
          f"stacked rank-8 adapters, {n_lora / 1e6:.1f} M values (fp32), on the card in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated "
          f"(a second copy of the base among it, for the check below)", flush=True)

    tc = TrainConfig(learning_rate=1e-4, weight_decay=0.01, grad_clip=1.0, remat=True)
    layers = cfg.num_layers
    want_step = _train_step_launches(layers)
    total = {name: 0 for name in want_step}
    opt_state = None
    for frames_latent, steps in ((3, 4), (13, 1)):  # the fourth 9-frame step runs under the profiler
        cos, sin = cogvideox_rope(cfg, 480, 720, frames_latent)
        loss = make_lora_loss(make_cogvideox_vpred_loss(dit, rope_cos=cos, rope_sin=sin), None, scale=1.0,
                              attach=True)
        step, opt = make_train_step(loss, tc)
        opt_state = opt.init(loras) if opt_state is None else opt_state
        seq = cfg.max_text_seq_length + frames_latent * 1350
        for i in range(steps):
            batch = _cog_train_batch(cfg, frames_latent, gen, torch.bfloat16)
            before = [leaf.detach().clone() for leaf in tree_leaves(loras)]
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            torch.cuda.synchronize()
            profiled = frames_latent == 3 and i == steps - 1
            t0 = time.perf_counter()
            if profiled:
                (loras, opt_state, metrics), profile = _profiled(lambda: step(loras, opt_state, batch, gen, base))
            else:
                loras, opt_state, metrics = step(loras, opt_state, batch, gen, base)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = _read_counts()
            if profiled:  # its time is the profiler's window: the clock above also holds the trace's export
                _print_profile("[E] profiled step", profile)
                ms = profile["window_ms"]
            loss_v, norm_v = float(metrics["loss"]), float(metrics["grad_norm"])
            moved = [not torch.equal(a, b.detach()) for a, b in zip(before, tree_leaves(loras))]
            print(f"[E] step at S={seq} ({1 + 4 * (frames_latent - 1)} frames): {ms:.1f} ms"
                  f"{' under the profiler (its window)' if profiled else ''}, loss {loss_v:.5f}, "
                  f"grad_norm {norm_v:.5f}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
                  f"launches {counts}; card after it: {_card_state()}", flush=True)
            if not (loss_v == loss_v and norm_v == norm_v and abs(loss_v) != float("inf") and norm_v > 0.0
                    and abs(norm_v) != float("inf")):
                raise AssertionError(f"loss {loss_v} or grad_norm {norm_v} is not a finite positive number")
            if counts != want_step:
                raise AssertionError(f"kernel launches of a step {counts} != {want_step}")
            # B starts at 0, so the first step's gradient reaches only B; from then on A moves too
            b_moved = [m for (path, leaf), m in zip(_lora_leaf_names(loras), moved) if leaf == "B"]
            if not all(b_moved) or (int(opt_state["count"]) > 1 and not all(moved)):
                raise AssertionError(f"adapters that did not move: {moved.count(False)} of {len(moved)}")
            for name in total:
                total[name] += counts[name]
    same = all(torch.equal(p, frozen[name]) for name, p in base.items())
    no_grad = all(p.grad is None for p in base.values())
    print(f"[E] base weights bit-identical after {int(opt_state['count'])} steps: {same}; no gradient stored on "
          f"them: {no_grad}: {'PASS' if same and no_grad else 'FAIL'}", flush=True)
    if not (same and no_grad):
        raise AssertionError("the frozen base changed or received a gradient")
    del dit, base, frozen, loras, opt_state
    torch.cuda.empty_cache()
    return total


def _profiled(fn):
    """``(fn(), profile)``: ``fn`` run once under ``torch.profiler`` (CPU and
    CUDA activity) inside a named range that ends after a synchronise.
    ``profile``: {"window_ms": the range's length, "busy_ms": the union of
    the device's kernel, copy and fill intervals inside it, "kernels":
    [(name, ms, launches)] by total time}. Read from the profiler's trace."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_profiled_window"):
            out = fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace) if e.get("ph") == "X"]
    window = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == "chip_smoke_profiled_window")
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    device = sorted((max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])), e["cat"], e["name"])
                    for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end, kernels = 0.0, w0, {}
    for a, b, cat, name in device:
        if b <= a:
            continue
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        if cat == "kernel":
            ms, n = kernels.get(name, (0.0, 0))
            kernels[name] = (ms + (b - a) / 1e3, n + 1)
    ranked = sorted(((name, ms, n) for name, (ms, n) in kernels.items()), key=lambda r: -r[1])
    return out, {"window_ms": (w1 - w0) / 1e3, "busy_ms": busy / 1e3, "kernels": ranked}


def _print_profile(tag, prof) -> None:
    """The ten device kernels that take the most time, each with its share of the window, and the idle share."""
    window = prof["window_ms"]
    if not prof["kernels"]:
        print(f"{tag}: the profiler recorded no device kernel in {window:.1f} ms: kernel shares and the idle share "
              f"not measured", flush=True)
        return
    print(f"{tag}: {window:.1f} ms window, device busy {prof['busy_ms']:.1f} ms, idle share "
          f"{1.0 - prof['busy_ms'] / window:.4f}; {len(prof['kernels'])} kernel names, the ten that take the most "
          f"time:", flush=True)
    for name, ms, n in prof["kernels"][:10]:
        short = name[5:] if name.startswith("void ") else name
        print(f"{tag}:   {ms:9.2f} ms {ms / window:7.2%} of the step, {n:4d} launches  {short[:110]}", flush=True)
    families = {}  # the port's kernels, the matrix products of PyTorch's libraries, and the rest
    ours, products = ("flash_fwd", "flash_bwd", "qk_prep_kernel", "rope_kernel"), ("gemm", "nvjet", "cutlass", "sm90_")
    for name, ms, _ in prof["kernels"]:
        family = ("the port's kernels" if any(part in name for part in ours)
                  else "matrix products" if any(part in name.lower() for part in products) else "other")
        families[family] = families.get(family, 0.0) + ms
    print(f"{tag}: by family " + ", ".join(f"{family} {ms:.2f} ms ({ms / window:.2%})"
                                          for family, ms in sorted(families.items(), key=lambda kv: -kv[1])),
          flush=True)


def _lora_leaf_names(loras) -> list:
    from alg_tpu_torch.training.train import tree_leaves_with_path

    return [tuple(path.rsplit("/", 1)) for path, _ in tree_leaves_with_path(loras)]


def phase_train_agreement() -> dict:
    """A small CogVideoX LoRA run on the card (kernels) and on the CPU (plain
    versions); returns the card run's launch counts (fp32: the CUDA-core
    forward, dq and dkv kernels)."""
    import copy

    import torch

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.cogvideox.transformer import (CogVideoXTransformer, CogVideoXTransformerConfig,
                                                            cogvideox_rope)
    from alg_tpu_torch.training.lora import init_lora_params, make_lora_loss
    from alg_tpu_torch.training.losses import make_cogvideox_vpred_loss
    from alg_tpu_torch.core.remat import remat_blocks
    from alg_tpu_torch.training.train import (TrainConfig, make_train_step, tree_leaves, tree_leaves_with_path,
                                              tree_map)

    _set_tf32(False, False)
    cfg = CogVideoXTransformerConfig(num_attention_heads=2, attention_head_dim=64, in_channels=8, out_channels=4,
                                     time_embed_dim=32, text_embed_dim=64, num_layers=2, sample_height=8,
                                     sample_width=8, max_text_seq_length=8)
    gen = torch.Generator("cpu").manual_seed(4)
    model = L.init_random_(CogVideoXTransformer(cfg), gen).requires_grad_(False)
    loras0 = init_lora_params(gen, dict(model.named_parameters()), rank=4, prefixes=("blocks",))
    cos, sin = cogvideox_rope(cfg, 64, 64, 3)  # 3 latent frames of 8 x 8: 48 video tokens, 8 text tokens
    batches, draws = [], []
    for _ in range(3):
        batches.append({"latents": torch.randn((2, 3, 4, 8, 8), generator=gen),
                        "image_latents": torch.randn((2, 3, 4, 8, 8), generator=gen),
                        "encoder_hidden_states": torch.randn((2, 8, 64), generator=gen)})
        draws.append({"t": torch.randint(0, 1000, (2,), generator=gen), "noise": torch.randn((2, 3, 4, 8, 8), generator=gen)})
    # where the gradients are compared: B is 0 at the start and A's gradient with it, so give B values
    point = tree_map(lambda t: t.clone(), loras0)
    for path, leaf in tree_leaves_with_path(point):
        if path.endswith("/B"):
            leaf.detach().copy_(0.05 * torch.randn(leaf.shape, generator=gen))
    # eps 1e-4: AdamW's update is sign-like (lr·g/(|g| + eps)), so with the default 1e-8 an element whose
    # gradient is rounding noise would move by up to lr in a direction that differs between the two runs
    tc = TrainConfig(learning_rate=1e-2, weight_decay=0.01, grad_clip=1.0, eps=1e-4, remat=True)
    runs = {}
    for dev in ("cpu", "cuda"):
        dit = copy.deepcopy(model).to(dev)
        loras = tree_map(lambda t: t.clone().to(dev).requires_grad_(), loras0)
        loss = make_lora_loss(make_cogvideox_vpred_loss(dit, rope_cos=cos, rope_sin=sin),
                              dict(dit.named_parameters()), scale=2.0, attach=True)
        step, opt = make_train_step(loss, tc)
        state, losses = opt.init(loras), []
        _reset_counts()
        for batch, draw in zip(batches, draws):
            loras, state, m = step(loras, state, {k: v.to(dev) for k, v in batch.items()},
                                   {k: v.to(dev) for k, v in draw.items()})
            losses.append(float(m["loss"]))
        counts = _read_counts()
        at = tree_map(lambda t: t.clone().to(dev).requires_grad_(), point)
        with remat_blocks(True):
            value = loss(at, {k: v.to(dev) for k, v in batches[0].items()}, {k: v.to(dev) for k, v in draws[0].items()})
        grads = [g.cpu() for g in torch.autograd.grad(value, tree_leaves(at))]
        runs[dev] = (losses, [leaf.detach().cpu() for leaf in tree_leaves(loras)], counts, grads)
    (l_c, p_c, n_c, g_c), (l_g, p_g, n_g, g_g) = runs["cpu"], runs["cuda"]
    grad_err = max(float((a - b).abs().max() / a.abs().max()) for a, b in zip(g_c, g_g))
    grads_live = all(bool(a.abs().max() > 0) for a in g_c)
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(l_c, l_g))
    err = max(float((a - b).abs().max()) for a, b in zip(p_c, p_g))
    moved = all(bool(leaf.abs().max() > 0) for leaf in p_g)
    # 3 steps x 2 layers, each block forward run twice under remat
    want = {"qk_prep": 24, "rope_interleaved": 0, "flash_attention": 12, "flash_attention_lse": 12,
            "flash_attention_bwd_dq": 6, "flash_attention_bwd_dkv": 6, "flash_attention_cuda_core": 12,
            "flash_attention_bwd_dq_cuda_core": 6, "flash_attention_bwd_dkv_cuda_core": 6, **_NO_OPT_IN,
            **_NO_TENSOR_CORES}
    ok = (loss_err <= 1e-4 and err <= 1e-4 and moved and not any(n_c.values()) and n_g == want and grads_live
          and grad_err <= 1e-4)
    print(f"[E2] small LoRA run of 3 steps, card (kernels) vs CPU (plain), fp32: losses {l_g} vs {l_c}, max rel diff "
          f"{loss_err:.3e} (rtol 1e-4), adapters max|diff| {err:.3e} (atol 1e-4), launches card {n_g} (want {want}) "
          f"/ CPU {n_c}; gradients of one loss at nonzero A and B, max|diff| over a leaf's max|ref| {grad_err:.3e} "
          f"(bound 1e-4, every leaf's gradient nonzero: {grads_live}): {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("[E2] card and CPU runs of the small LoRA training disagree")
    return n_g


# ---------------------------------------------------------------------------
# S. serving: serve_cli.run over checkpoint directories of the three families, the HTTP daemon's batching
# worker, and serve_batch card against CPU
# ---------------------------------------------------------------------------

SERVE_PROMPTS = (PROMPT, "a panda eats bamboo in the rain")
SERVE_SEEDS = (42, 7)

# configs/wan_alg.yaml and configs/hunyuan_video_alg.yaml as parsed mappings, cut as phases C2 and C3 cut them:
# 9 frames, 4 steps, the ALG interval's end raised to 0.4 (Wan: two 3-pass and two 2-pass steps; HunyuanVideo:
# 2 of its 4 single-pass steps on the filtered first frame)
SERVE_WAN_CONFIG = {
    "model": {"path": "Wan-AI/Wan2.1-I2V-14B-480P-Diffusers", "dtype": "bfloat16"},
    "generation": {"num_frames": 9, "num_inference_steps": 4, "guidance_scale": 5.0, "height": 480, "width": 832},
    "alg": {**CLI_CONFIG["alg"], "lp_resize_factor": 0.4},
    "video": {"fps": 16},
}
SERVE_HY_CONFIG = {
    "model": {"path": "hunyuanvideo-community/HunyuanVideo-I2V", "dtype": "bfloat16", "flow_shift": 7.0,
              "flow_reverse": False},
    "generation": {"num_frames": 9, "num_inference_steps": 4, "guidance_scale": 6.0, "i2v_stable": True,
                   "true_cfg_scale": 1.0},
    "alg": {**CLI_CONFIG["alg"], "lp_resize_factor": 0.625},
    "video": {"resolution": "360p", "fps": 30},
}
SERVE_HY_SIZE = (352, 608)  # an image of this aspect buckets to itself at 360p, phase C3's size

WAN_STAGES = {"encode_prompt": "UMT5 encode", "encode_image": "CLIP ViT-H encode",
              "_encode_video_condition": "VAE encode of the condition video"}
HY_STAGES = {"encode_prompt": "Llava + CLIP text encode", "_encode_mode": "VAE encode (mode)"}


def _wan_seq_len(m, a) -> int:
    return a[0].shape[2] * a[0].shape[3] * a[0].shape[4] // (m.cfg.patch_size[0] * m.cfg.patch_size[1]
                                                             * m.cfg.patch_size[2])


class _HunyuanLengths:
    """The DiT's joint length for a forward's args (x [B, C, F, h, w], timestep, text [B, S_text, D], text mask),
    recording each forward's text length and valid text positions, and each Llava run's input length."""

    def __init__(self):
        self.text, self.llava = [], []

    def __call__(self, m, a) -> int:
        self.text.append((a[2].shape[1], int(a[3][0].sum())))
        return a[2].shape[1] + a[0].shape[2] * a[0].shape[3] * a[0].shape[4] // m.cfg.patch_size ** 2

    def hook_llava(self, llava):
        return llava.register_forward_pre_hook(lambda _m, args: self.llava.append(args[0].shape[1]))


def _hunyuan_image_processor(pipe) -> None:
    """Llava's CLIP preprocessing of an image that is not 336 x 336 needs PIL, which the card's machine may lack:
    phase C3's seeded processor stands in for it; the tokenizers and every model still come from the directory."""
    from alg_tpu_torch.pipelines.hunyuan import DEFAULT_PROMPT_TEMPLATE

    cfg = pipe.llava.cfg
    pipe.image_processor = _hunyuan_hooks(DEFAULT_PROMPT_TEMPLATE, cfg.image_token_index, cfg.pad_token_id, 0, 1,
                                          pipe.clip.cfg.eos_token_id)[2]
    print("  the loaded pipeline's image_processor is phase C3's seeded stand-in (no PIL needed)", flush=True)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _serve_over_checkpoint(tag, config, images, tmp, drawn, probe_kw, want, size):
    """``serve_cli.run`` over the checkpoint under ``tmp`` with ``config`` as
    a parsed mapping and two requests (``SERVE_PROMPTS`` at ``SERVE_SEEDS`` on
    the uint8 ``images``) in one batch. Checks the loaded parameters against
    ``drawn``, 4 DiT forwards and the exact launches ``want``, and the two
    written videos of ``size`` = (frames, height, width): finite, not
    constant, different from each other. Then, on the loaded pipeline, the
    seed-42 request alone (``serve_batch`` at B = 1: the PSNR of its frames
    and the max|diff| of its final latents against the batch's, printed), and
    the time a request takes at B = 1 and at B = 2 (each call's second run,
    host clock between synchronises) with the peak memory of the batch of
    two. Returns (the run's launch counts, the pipeline, its keywords, the
    requests)."""
    import os

    import numpy as np
    import torch

    from alg_tpu_torch import serve_cli, serving
    from alg_tpu_torch.core.config import run_config_from_dict

    reqs = [serving.BatchRequest(p, img, negative_prompt="", seed=seed)
            for p, img, seed in zip(SERVE_PROMPTS, images, SERVE_SEEDS)]
    timer = _StageTimer(batch=len(reqs))
    args = serve_cli.build_parser().parse_args(["--config", "-", "--model_cache_dir", tmp, "--output_dir",
                                                os.path.join(tmp, "served"), "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    with _CliProbe(timer, **probe_kw) as probe:
        _reset_counts()
        written, total_s = _timed(lambda: serve_cli.run(args, config=config, requests=reqs))
        counts = _read_counts()
    pipe = probe.pipe
    _print_load(tag, probe)
    if drawn is not None:
        _check_loaded(tag, pipe, drawn)
    for stage, ms, dit_ms in timer.rows:
        print(f"[{tag}] {stage:<40} {ms:10.1f} ms" + ("" if dit_ms is None else f"  (DiT forward {dit_ms:.1f} ms)"))
    print(f"[{tag}] serve_cli.run (B = 2, the load included) {total_s:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    fwd = timer.count("denoise step")
    if fwd != 4:
        raise AssertionError(f"[{tag}] {fwd} DiT forwards, want 4")
    _check_counts(f"{tag} serve_cli.run, B = 2", counts, want)
    names = [os.path.basename(os.path.splitext(w)[0]) for w in written]
    if len(probe.writes) != 2 or names != ["000", "001"]:
        raise AssertionError(f"[{tag}] wrote {written}, want 000 and 001")
    u8 = [_check_video(f"{tag} request {i}", w, probe.final[0][i], size) for i, w in enumerate(probe.writes)]
    if np.array_equal(u8[0], u8[1]):
        raise AssertionError(f"[{tag}] the two requests' videos are the same")

    for attr in probe_kw.get("stages", COG_STAGES):  # the timed wrappers off: the calls below run bare
        delattr(pipe, attr)
    cfg = run_config_from_dict(config)
    kw = dict(cfg.pipeline_kwargs)
    if cfg.family == "hunyuan" and "resolution" in cfg.video:
        kw["height"], kw["width"] = serving.hunyuan_size(cfg.video["resolution"], images[0])
    alone, _ = _timed(lambda: serving.serve_batch(pipe, reqs[:1], **kw))
    err = float(np.abs(probe.final[-1][0] - probe.final[0][0]).max())
    print(f"[{tag}] the seed-42 request alone (B = 1) against it in the batch of two: frames PSNR "
          f"{_psnr(alone[0], probe.writes[0]['frames']):.1f} dB, final latents max|diff| {err:.3e} (bf16 at two batch "
          "sizes: a record; phase S5 holds the fp32 bound)", flush=True)
    _, b1_s = _timed(lambda: serving.serve_batch(pipe, reqs[:1], **kw))
    torch.cuda.reset_peak_memory_stats()
    _, b2_s = _timed(lambda: serving.serve_batch(pipe, reqs, **kw))
    print(f"[{tag}] seconds per request ({_card_line()}): B = 1 {b1_s:.3f} s; B = 2 {b2_s / 2:.3f} s "
          f"({b2_s:.3f} s a batch); peak device memory of the batch of two "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del probe
    return counts, pipe, kw, reqs


def _serve_cogvideox(tmp) -> dict:
    """S1: phase F's CogVideoX-5b-I2V checkpoint (DiT 2 of 42 layers, T5-XXL 2 of 24) served at phase C's cut,
    then S4 on its pipeline."""
    import numpy as np

    from alg_tpu_torch.io import hf_checkpoint as H

    ck = copy.deepcopy(H.COGVIDEOX_5B_I2V)
    ck["transformer"]["num_layers"], ck["text_encoder"]["num_layers"] = 2, 2
    root = f"{tmp}/{CLI_CONFIG['model']['path']}"
    drawn = _write_checkpoint("S1", "CogVideoX-5b-I2V (DiT and T5 2 layers)", H.write_cogvideox, ck, root)
    images = [np.random.RandomState(30 + i).randint(0, 256, (CLI_HEIGHT, CLI_WIDTH, 3)).astype(np.uint8)
              for i in range(2)]
    # 4 DiT forwards x 2 layers (2 qk_prep, 1 flash each) + 2 T5 encodes (prompts, negatives) x 2 layers: the CFG
    # batch of the two requests rides in each forward, so the counts are those of one request (phase F)
    flash = 2 * 4 + 2 * 2
    counts, pipe, kw, reqs = _serve_over_checkpoint(
        "S1", CLI_CONFIG, images, tmp, drawn, {}, {"qk_prep": 16, "flash_attention": flash, "flash_attention_tc": flash},
        (CLI_FRAMES, CLI_HEIGHT, CLI_WIDTH))
    del drawn
    out = {"serve_cogvideox": counts, "serve_worker_cogvideox": _serve_worker("S4", pipe, kw, images, counts)}
    del pipe
    _free_device_memory()
    return out


def _serve_worker(tag, pipe, kw, images, batch_counts) -> dict:
    """S4: a ``BatchingWorker`` with ``max_batch=2`` on the pipeline; three requests submitted from threads within
    one window run as two micro-batches (2 + 1), each at its real size, and each result is bit for bit a
    ``serve_batch`` of the same micro-batch. Returns the worker's launch counts (twice ``batch_counts``: the CFG
    batch rides in each forward whatever the micro-batch's size)."""
    import threading

    import numpy as np

    from alg_tpu_torch import serving
    from alg_tpu_torch.http_serving import BatchingWorker

    reqs = [serving.BatchRequest(f"{PROMPT}, take {i}", images[i % 2], negative_prompt="", seed=11 + i)
            for i in range(3)]
    ran, serve = [], serving.serve_batch

    def recorded(pipeline, requests, **gen_kwargs):
        out = serve(pipeline, requests, **gen_kwargs)
        ran.append((list(requests), np.array(out)))
        return out

    serving.serve_batch = recorded  # the worker reads it when it starts
    try:
        worker = BatchingWorker(pipe, kw, max_batch=2, batch_window=1.0)
        worker.start()
        pending = [None] * 3

        def submit(i):
            pending[i] = worker.submit(reqs[i])
            pending[i].done.wait()

        _reset_counts()
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(3)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        total_s = time.perf_counter() - t0
        counts = _read_counts()
        worker.shutdown()
        worker.join(timeout=60)
    finally:
        serving.serve_batch = serve
    errors = [p.error for p in pending if p.error is not None]
    if errors or worker.batches != [2, 1] or len(ran) != 2:
        raise AssertionError(f"[{tag}] micro-batches {worker.batches}, errors {errors}; want [2, 1] and none")
    same = []
    for requests, out in ran:
        again = np.asarray(serve(pipe, requests, **kw))
        mine = [next(p for p, q in zip(pending, reqs) if q is r) for r in requests]
        same.append(np.array_equal(again, out) and all(np.array_equal(p.result, out[j]) for j, p in enumerate(mine)))
    print(f"[{tag}] BatchingWorker(max_batch=2): 3 requests from threads in {total_s:.2f} s as micro-batches "
          f"{worker.batches}; each result bit-equal to serve_batch of its micro-batch: {same}", flush=True)
    if not all(same):
        raise AssertionError(f"[{tag}] a micro-batch's results differ from serve_batch's")
    _check_counts(tag, counts, {k: 2 * n for k, n in batch_counts.items()})
    return counts


def _serve_wan(tmp) -> dict:
    """S2: phase G2's Wan2.1-I2V-14B checkpoint (DiT 2 of 40 layers, UMT5-XXL 2 of 24, CLIP ViT-H and the VAE
    whole) served at 9 frames, 480x832, 4 steps."""
    import numpy as np

    from alg_tpu_torch.io import hf_checkpoint as H

    ck = copy.deepcopy(H.WAN21_I2V_14B)
    ck["transformer"]["num_layers"], ck["text_encoder"]["num_layers"] = 2, 2
    root = f"{tmp}/{SERVE_WAN_CONFIG['model']['path']}"
    drawn = _write_checkpoint("S2", "Wan2.1-I2V-14B (DiT and UMT5 2 layers)", H.write_wan, ck, root)
    images = [np.random.RandomState(40 + i).randint(0, 256, (480, 832, 3)).astype(np.uint8) for i in range(2)]
    clip_layers = ck["image_encoder"]["num_hidden_layers"]
    # 4 DiT forwards x 2 layers (2 rope; self, text and image attention) + 2 UMT5 encodes x 2 layers on the tensor
    # cores; the fp32 CLIP ViT-H tower once a request on the CUDA cores
    tc, cc = 3 * 2 * 4 + 2 * 2, clip_layers * 2
    counts = _serve_over_checkpoint(
        "S2", SERVE_WAN_CONFIG, images, tmp, drawn, {"stages": WAN_STAGES, "seq_len": _wan_seq_len},
        {"rope_interleaved": 16, "flash_attention": tc + cc, "flash_attention_tc": tc,
         "flash_attention_cuda_core": cc}, (9, 480, 832))[0]
    del drawn
    _free_device_memory()
    return {"serve_wan": counts}


def _serve_hunyuan(tmp) -> dict:
    """S3: ``hf_checkpoint.HUNYUAN_VIDEO_I2V`` cut to 2 double, 2 single and 2 refiner blocks, Llava's Llama to 2
    of 32 layers and its vision tower to 2 of 24 (the CLIP text model and the VAE whole): ``cli.run`` with
    the shipped config at phase C3's cut on a 352x608 image (bucketed to itself at 360p), then ``serve_cli.run``
    with two requests bucketed from the first."""
    import os

    import numpy as np

    from alg_tpu_torch.cli import build_parser, run
    from alg_tpu_torch.io import hf_checkpoint as H

    ck = copy.deepcopy(H.HUNYUAN_VIDEO_I2V)
    t, lc = ck["transformer"], ck["text_encoder"]
    t["num_layers"], t["num_single_layers"], t["num_refiner_layers"] = 2, 2, 2
    lc["text_config"]["num_hidden_layers"], lc["vision_config"]["num_hidden_layers"] = 2, 2
    root = os.path.join(tmp, SERVE_HY_CONFIG["model"]["path"])
    drawn = _write_checkpoint("S3", "HunyuanVideo-I2V (2 + 2 + 2 DiT blocks, Llava 2 + 2 layers)", H.write_hunyuan,
                              ck, root)
    images = [np.random.RandomState(50 + i).randint(0, 256, (*SERVE_HY_SIZE, 3)).astype(np.uint8) for i in range(2)]
    blocks, clip_layers = t["num_layers"] + t["num_single_layers"], ck["text_encoder_2"]["num_hidden_layers"]
    llava_layers = lc["text_config"]["num_hidden_layers"] + lc["vision_config"]["num_hidden_layers"]

    def want(requests):  # 4 single-pass DiT forwards; Llava and the CLIP text model once a request
        tc, cc = (t["num_refiner_layers"] + blocks) * 4 + llava_layers * requests, clip_layers * requests
        return {"rope_interleaved": 2 * blocks * 4, "flash_attention": tc + cc, "flash_attention_tc": tc,
                "flash_attention_cuda_core": cc}

    lengths = _HunyuanLengths()
    timer = _StageTimer()

    def on_load(pipe):
        _hunyuan_image_processor(pipe)
        hooks.append(lengths.hook_llava(pipe.llava))

    hooks = []
    args = build_parser().parse_args(["--model_cache_dir", tmp, "--output_path", os.path.join(tmp, "cli.mp4"),
                                      "--device", "cuda"])
    with _CliProbe(timer, stages=HY_STAGES, seq_len=lengths, on_load=on_load) as probe:
        _reset_counts()
        _, total_s = _timed(lambda: run(args, config=SERVE_HY_CONFIG, image=images[0]))
        cli_counts = _read_counts()
    _print_load("S3", probe)
    _check_loaded("S3", probe.pipe, drawn)
    for stage, ms, dit_ms in timer.rows:
        print(f"[S3] {stage:<40} {ms:10.1f} ms" + ("" if dit_ms is None else f"  (DiT forward {dit_ms:.1f} ms)"))
    print(f"[S3] cli.run {total_s:.2f} s; Llava sees {lengths.llava} positions; the DiT's text {lengths.text[:1]} "
          "(length, valid positions) from the written tokenizers", flush=True)
    if timer.count("denoise step (1-pass") != 4:
        raise AssertionError(f"[S3] {timer.count('denoise step')} DiT forwards, want 4 single-pass")
    _check_counts("S3 cli.run", cli_counts, want(1))
    _check_video("S3 cli.run", probe.written, probe.final[0][0], (9, *SERVE_HY_SIZE))
    for h in hooks:
        h.remove()
    del probe
    _free_device_memory()

    serve_counts = _serve_over_checkpoint(
        "S3", SERVE_HY_CONFIG, images, tmp, drawn,
        {"stages": HY_STAGES, "seq_len": _HunyuanLengths(), "on_load": _hunyuan_image_processor}, want(2),
        (9, *SERVE_HY_SIZE))[0]
    del drawn
    _free_device_memory()
    return {"cli_hunyuan": cli_counts, "serve_hunyuan": serve_counts}


# a small HunyuanVideo checkpoint whose head dims the kernels take (DiT and Llava 128, the vision tower and the CLIP
# text model 64) at phase D3's widths, its vision tower at 64 x 64 (the requests' size: no resize, no PIL)
SMALL_HUNYUAN = {
    "transformer": {"in_channels": 4, "out_channels": 4, "num_attention_heads": 2, "attention_head_dim": 128,
                    "num_layers": 1, "num_single_layers": 1, "num_refiner_layers": 1, "mlp_ratio": 2.0,
                    "patch_size": 2, "patch_size_t": 1, "text_embed_dim": 256, "pooled_projection_dim": 128,
                    "guidance_embeds": True, "rope_theta": 256.0, "rope_axes_dim": [16, 56, 56],
                    "image_condition_type": "token_replace"},
    "vae": {"latent_channels": 4, "block_out_channels": [8, 16, 16, 16], "layers_per_block": 1, "norm_num_groups": 4,
            "scaling_factor": 0.476986, "temporal_compression_ratio": 4},
    "text_encoder": {"image_token_index": 120, "pad_token_id": 0,
                     "text_config": {"vocab_size": 128, "hidden_size": 256, "intermediate_size": 128,
                                     "num_hidden_layers": 3, "num_attention_heads": 2, "num_key_value_heads": 1,
                                     "rope_theta": 10000.0},
                     "vision_config": {"hidden_size": 128, "intermediate_size": 64, "num_hidden_layers": 2,
                                       "num_attention_heads": 2, "image_size": 64, "patch_size": 32,
                                       "hidden_act": "quick_gelu"}},
    "text_encoder_2": {"vocab_size": 64, "hidden_size": 128, "intermediate_size": 64, "num_hidden_layers": 2,
                       "num_attention_heads": 2, "max_position_embeddings": 16, "hidden_act": "quick_gelu",
                       "eos_token_id": 63},
}
# phase D3's chat template cut to the small Llava: an 8-token head, the image block (2 x 2 patches) at [5, 9)
SMALL_HY_TEMPLATE = {"template": "{}", "crop_start": 8, "image_emb_start": 5, "image_emb_end": 9, "image_emb_len": 4,
                     "double_return_token_id": 7}


def phase_serve_agreement() -> dict:
    """S5: small CogVideoX, Wan and HunyuanVideo checkpoints from ``hf_checkpoint`` (head dims the kernels take),
    each loaded on the card and on the CPU; ``serve_batch`` with two requests on each, fp32 with TF32 off: final
    latents (``output_type="latent"``) within 2e-3 and frames (a second call) above 40 dB, exact launches on the
    card and none on the CPU; and each request's card output within the same bounds of a B = 1 serve of it on the
    card. Returns the card's counts by path."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from alg_tpu_torch import serving
    from alg_tpu_torch.cli import load_pipeline
    from alg_tpu_torch.core.config import run_config_from_dict
    from alg_tpu_torch.io import hf_checkpoint as H

    _set_tf32(False, False)
    images = [np.random.RandomState(60 + i).randint(0, 256, (64, 64, 3)).astype(np.uint8) for i in range(2)]
    reqs = [serving.BatchRequest(p, img, negative_prompt="", seed=seed)
            for p, img, seed in zip(SERVE_PROMPTS, images, SERVE_SEEDS)]
    hy_config = _small_cli_config("SmallHunyuanVideo", num_frames=9, guidance_scale=1.0, true_cfg_scale=2.0,
                                  i2v_stable=True, max_sequence_length=20, prompt_template=SMALL_HY_TEMPLATE)
    hy_config["model"].update(flow_shift=7.0, flow_reverse=False)
    hy_config["alg"]["lp_resize_factor"] = 0.625
    wan_config = _small_cli_config("SmallWan", num_frames=9, guidance_scale=5.0)
    wan_config["alg"]["lp_resize_factor"] = 0.4
    cases = (
        # 4 DiT forwards x 2 layers (2 qk_prep each) + 2 T5 encodes x 2 layers
        ("S5 CogVideoX", "cogvideox", "SmallCogVideoX", H.write_cogvideox, SMALL_COGVIDEOX,
         _small_cli_config("SmallCogVideoX", num_frames=5, guidance_scale=6.0),
         {"qk_prep": 16, "rope_interleaved": 0, "flash_attention": 12}),
        # 4 DiT forwards x 2 layers x (2 rope, 3 flash) + 2 UMT5 encodes x 2 layers + 2 CLIP layers a request
        ("S5 Wan", "wan", "SmallWan", H.write_wan, SMALL_WAN, wan_config,
         {"qk_prep": 0, "rope_interleaved": 16, "flash_attention": 24 + 4 + 2 * 2}),
        # true CFG: 4 DiT forwards x (1 refiner, 1 double, 1 single block; rope on q and k of the last two) + 4
        # prompt encodes (each request's, and its negative against a black image) x (3 Llama + 2 vision tower + 2
        # CLIP text layers)
        ("S5 HunyuanVideo", "hunyuan", "SmallHunyuanVideo", H.write_hunyuan, SMALL_HUNYUAN, hy_config,
         {"qk_prep": 0, "rope_interleaved": 16, "flash_attention": 4 * 3 + 4 * 7}),
    )
    tmp = tempfile.mkdtemp(prefix="alg_serve_small_")
    counts = {}
    try:
        for tag, family, name, write, ck, config, want in cases:
            write(os.path.join(tmp, name), ck, seed=4)
            cfg = run_config_from_dict(config)
            kw = cfg.pipeline_kwargs
            results, pipes = {}, {}
            for dev in ("cpu", "cuda"):
                pipes[dev] = load_pipeline(cfg, tmp, device=dev)
                _reset_counts()
                lat = serving.serve_batch(pipes[dev], reqs, **kw, output_type="latent")
                n = _read_counts()
                frames = serving.serve_batch(pipes[dev], reqs, **kw, output_type="np")
                results[dev] = (lat, frames, n)
            counts[f"agreement_serve_{family}"] = _compare_runs(tag, results, want)
            lat2, fr2 = results["cuda"][:2]
            for i, req in enumerate(reqs):
                lat1 = serving.serve_batch(pipes["cuda"], [req], **kw, output_type="latent")
                fr1 = serving.serve_batch(pipes["cuda"], [req], **kw, output_type="np")
                err, psnr = float(np.abs(lat1[0] - lat2[i]).max()), _psnr(fr1[0], fr2[i])
                ok = err <= 2e-3 and psnr > 40.0
                print(f"[{tag}] request {i} alone (B = 1) against it in the batch of two, on the card: latents "
                      f"max|diff| {err:.3e} (atol 2e-3), frames PSNR {psnr:.1f} dB (> 40): {'PASS' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    raise AssertionError(f"[{tag}] request {i} served alone differs from it in the batch")
            del pipes
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_device_memory()
    return counts


def phase_serve() -> dict:
    """S1-S5 (``python3 chip_smoke.py --serve`` runs them alone); returns the launch counts by path."""
    import shutil
    import tempfile

    _set_tf32(False, True)
    counts = {}
    for serve_family in (_serve_cogvideox, _serve_wan, _serve_hunyuan):
        tmp = tempfile.mkdtemp(prefix="alg_serve_")
        try:
            counts.update(serve_family(tmp))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            _free_device_memory()
    counts.update(phase_serve_agreement())
    return counts


# ---------------------------------------------------------------------------
# Q. the opt-in W8A8 / W4A8 linears and QLoRA (ops/quant.py, models.layers.QuantizedLinear): no hand kernel, the
# int8 product is torch._int_mm; the attention kernels of each path are counted as in the bf16 runs
# ---------------------------------------------------------------------------

# (name, rows M, in K, out N) of the linears the main paths give the W8A8 / W4A8 linear: a CogVideoX-5b 2-pass
# forward at 49 frames (S = 17,776), a Wan2.1-14B 2-pass forward at 81 frames (S = 32,760), and a HunyuanVideo
# modulation linear (one conditioning row a sample; it takes the padded path)
Q1_SHAPES = (("CogVideoX-5b attention", 2 * 17776, 3072, 3072), ("CogVideoX-5b ff.fc_in", 2 * 17776, 3072, 12288),
             ("CogVideoX-5b ff.fc_out", 2 * 17776, 12288, 3072), ("Wan2.1-14B ffn.fc_in", 2 * 32760, 5120, 13824),
             ("HunyuanVideo norm1_linear", 1, 3072, 18432))
Q1_PLAIN_ROWS = 24  # rows the CPU's plain version recomputes
# the bounds against the float product, max|quantized - float| over max|float|: W8A8 2%
# (tests/test_quant.py:33-35), W4A8 20% (tests/test_quant.py:239-241: int4's grid)
Q_FP_REL = {"w8": 0.02, "w4": 0.2}


def _q1_case(name, m, k, n, gen) -> dict:
    """One shape: the int32 accumulators of ``torch._int_mm`` (W8 and W4 weights) bit-equal to the exact product
    (the int8 operands in fp64 on the card), the W8A8 and W4A8 calls against the CPU's plain version on
    ``Q1_PLAIN_ROWS`` rows and against bf16 ``F.linear``, and the times of the parts beside their bounds."""
    import torch
    import torch.nn.functional as F

    from alg_tpu_torch.models.layers import QuantizedLinear
    from alg_tpu_torch.ops import quant as Q

    dev = gen.device
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    lin = torch.nn.Linear(k, n, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((n, k), generator=gen, device=dev) * k ** -0.5)
        lin.bias.copy_(torch.randn((n,), generator=gen, device=dev) * 0.1)
    mods = {mode: QuantizedLinear.from_linear(lin, mode) for mode in ("w8", "w4")}
    xq, xs = Q.quantize_rows(x)
    rec = {"name": name, "shape": [m, k, n]}
    with torch.no_grad():
        ref = F.linear(x, lin.weight, lin.bias)
        for mode, ql in mods.items():
            w8 = ql.int8_weight()
            acc = Q.int8_matmul(xq, w8)
            exact = xq.double() @ w8.double().t()
            same = bool(torch.equal(acc.double(), exact))
            del exact
            y = ql(x)
            rows = min(m, Q1_PLAIN_ROWS)
            plain = QuantizedLinear.from_linear(copy.deepcopy(lin).cpu(), mode)(x[:rows].cpu())
            err, close = _close(y[:rows].cpu(), plain, TOL["bfloat16"])
            differ = int((y[:rows].cpu() != plain).sum())
            fp_rel = float((y.float() - ref.float()).abs().max() / ref.float().abs().max())
            ok = same and close and fp_rel < Q_FP_REL[mode] and bool(torch.isfinite(y).all())
            print(f"[Q1] {name:<36} {mode} [{m}, {k}] -> {n}: int32 accumulators bit-equal to the exact fp64 "
                  f"product: {same}; {rows} rows against the CPU's plain version max|diff| {err:.3e} (atol "
                  f"{TOL['bfloat16'][0]}, rtol {TOL['bfloat16'][1]}; {differ} values differ); max|{mode} - bf16| over "
                  f"max|bf16| {fp_rel:.4f} (< {Q_FP_REL[mode]}): {'PASS' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"[Q1] {name} {mode} disagrees")
            rec[f"{mode}_fp_rel"], rec[f"{mode}_max_abs_err"] = fp_rel, err
            del acc, y
        b = 2  # bytes of a bf16 value
        mkn = 2.0 * m * k * n
        parts = {  # each with its bound: the int8 or bf16 product's operations, or the bytes of a pass
            "bf16 F.linear": (lambda: F.linear(x, lin.weight, lin.bias),
                              _bound(mkn, b * (m * k + n * k + m * n), "bfloat16")),
            "W8A8 call": (lambda: mods["w8"](x), _bound(mkn, b * m * k + n * k + b * m * n, "int8")),
            "W4A8 call": (lambda: mods["w4"](x), _bound(mkn, b * m * k + n * k // 2 + b * m * n, "int8")),
            "activation quantizer": (lambda: Q.quantize_rows(x), _bound(0, b * m * k + m * k + 4 * m, "int8")),
            "_int_mm": (lambda: Q.int8_matmul(xq, mods["w8"].weight_q), _bound(mkn, m * k + n * k + 4 * m * n, "int8")),
            "w4_to_int8": (lambda: mods["w4"].int8_weight(), _bound(0, n * k // 2 + n * k, "int8")),
        }
        acc = Q.int8_matmul(xq, mods["w8"].weight_q)
        parts["epilogue"] = (lambda: Q._epilogue(acc, xs, mods["w8"].w_scale, lin.bias, x.dtype),
                             _bound(0, 4 * m * n + b * m * n, "int8"))
        times = {}
        for part, (fn, bound) in parts.items():
            times[part] = _time_ms(fn, reps=10)
            print(f"[Q1] {name:<36} {part:<22} {times[part]:9.3f} ms  bound {bound[0]:.4f} ms ({bound[1]})",
                  flush=True)
        rec["ms"] = times
        del acc
    print(f"[Q1] {name}: W8A8 / bf16 time {times['W8A8 call'] / times['bf16 F.linear']:.2f}, W4A8 / bf16 "
          f"{times['W4A8 call'] / times['bf16 F.linear']:.2f}; W8A8's parts: quantizer + _int_mm + epilogue "
          f"{times['activation quantizer'] + times['_int_mm'] + times['epilogue']:.3f} ms ({_card_line()})", flush=True)
    return rec


def phase_quant_linear() -> list:
    """Q1: the W8A8 / W4A8 linear at the shipped shapes, bf16 (:func:`_q1_case`); the layout ``_int_mm`` takes the
    weight in, ``ops.quant.WEIGHT_LAYOUT``, checked first."""
    import torch

    from alg_tpu_torch.ops import quant as Q

    gen = torch.Generator("cuda").manual_seed(0)
    a = torch.randint(-127, 128, (64, 256), generator=gen, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (128, 256), generator=gen, device="cuda", dtype=torch.int8)
    exact = (a.double() @ w.double().t())
    for label, operand in (("weight_q.t() (a view)", w.t()), ("weight_q.t().contiguous()", w.t().contiguous())):
        try:
            ok = bool(torch.equal(torch._int_mm(a, operand).double(), exact))
            print(f"[Q1] torch._int_mm takes {label}: exact {ok}", flush=True)
        except RuntimeError as e:
            print(f"[Q1] torch._int_mm refuses {label}: {str(e).splitlines()[0]}", flush=True)
    print(f"[Q1] the port passes {Q.WEIGHT_LAYOUT}", flush=True)
    records = [_q1_case(name, m, k, n, gen) for name, m, k, n in Q1_SHAPES]
    _free_device_memory()
    return records


def _dit_bytes(dit) -> int:
    from alg_tpu_torch.training.lora import lora_base

    return sum(t.numel() * t.element_size() for t in lora_base(dit).values())


def _drift(q, fp):
    """(within ``tests/test_quant.py:60-107``'s bounds, its drift of quantized latents against the bf16 run's)."""
    import numpy as np

    q, fp = np.asarray(q, np.float64).ravel(), np.asarray(fp, np.float64).ravel()
    corr = float(np.corrcoef(q, fp)[0, 1])
    mean_abs, rms = float(np.abs(q - fp).mean()), float(np.sqrt(np.mean(fp ** 2)))
    ok = corr > 0.95 and mean_abs < 0.25 * rms
    return ok, (f"corr {corr:.4f} (> 0.95), mean|d| {mean_abs:.4f} over the bf16 RMS {rms:.4f} = {mean_abs / rms:.4f} "
                f"(< 0.25), max|d| {float(np.abs(q - fp).max()):.4f}")


def phase_quant_pipeline() -> dict:
    """Q2: phase C's CogVideoX-5b-I2V pipeline (42-layer DiT and T5-XXL in bf16, VAE fp32, seed 0) at phase C's
    cut, in bf16 and then with ``quantize_pipeline`` w8 and w4 (the DiT drawn again from the seed for w4): the
    latents' drift against the bf16 run, the DiT's bytes before and after, each call's time; then the 49-frame
    2-pass forward (S = 17,776) in bf16 and under W8A8, timed and profiled. Returns {path: launch counts}."""
    import numpy as np
    import torch

    from alg_tpu_torch.io import hf_checkpoint
    from alg_tpu_torch.io.model_zoo import cogvideox_configs
    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer
    from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE
    from alg_tpu_torch.models.t5 import T5Encoder
    from alg_tpu_torch.ops.quant import quantize_pipeline
    from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline

    _set_tf32(False, True)
    dev = torch.device("cuda")
    tcfg, vcfg, t5cfg = cogvideox_configs(hf_checkpoint.COGVIDEOX_5B_I2V)

    def draw_dit():
        gen = torch.Generator(dev).manual_seed(0)  # phase C's order: the DiT first from seed 0
        return L.init_random_(CogVideoXTransformer(tcfg, device=dev, dtype=torch.bfloat16), gen), gen

    dit, gen = draw_dit()
    t5 = L.init_random_(T5Encoder(t5cfg, device=dev, dtype=torch.bfloat16), gen)
    vae = L.init_random_(CogVideoXVAE(vcfg, device=dev, dtype=torch.float32), gen)
    pipe = CogVideoXPipeline(transformer=dit, vae=vae, t5=t5, tokenize=_seeded_tokenize(t5cfg.vocab_size),
                             dtype=torch.bfloat16, device=dev)
    image = np.random.RandomState(0).uniform(-1, 1, (1, 3, 480, 720)).astype(np.float32)

    def call():
        return pipe(image=image, prompt=PROMPT, height=480, width=720, num_frames=9, output_type="latent",
                    **_alg_kwargs())

    want = {"qk_prep": 2 * tcfg.num_layers * 4, "flash_attention": tcfg.num_layers * 4 + t5cfg.num_layers * 2,
            "flash_attention_tc": tcfg.num_layers * 4 + t5cfg.num_layers * 2}
    runs, counts, bf16_bytes = {}, {}, _dit_bytes(dit)
    s49 = 226 + 13 * 30 * 45
    for mode in ("bf16", "w8", "w4"):
        if mode == "w4":  # the bf16 DiT again, from the seed
            pipe.transformer = dit = None
            _free_device_memory()
            pipe.transformer = dit = draw_dit()[0]
        q_s = 0.0
        if mode != "bf16":
            _, q_s = _timed(lambda: quantize_pipeline(pipe, mode))
            _free_device_memory()
        _reset_counts()
        latents, seconds = _timed(call)
        counts[mode] = _read_counts()
        _check_counts(f"Q2 {mode}", counts[mode], want)
        runs[mode] = np.asarray(latents, np.float32)
        line = f"[Q2] {mode}: call {seconds:.2f} s; the DiT {_dit_bytes(dit) / 2**30:.2f} GiB"
        if mode != "bf16":
            n = sum(type(mm).__name__ == "QuantizedLinear" for mm in dit.modules())
            ok, drift = _drift(runs[mode], runs["bf16"])
            line += (f" (bf16 {bf16_bytes / 2**30:.2f} GiB; {n} linears quantized in place in {q_s:.2f} s); "
                     f"latents against the bf16 run: {drift}: {'PASS' if ok else 'FAIL'}")
            if not ok or not np.isfinite(runs[mode]).all():
                raise AssertionError(f"[Q2] the {mode} latents drift past tests/test_quant.py's bounds")
        print(line + f" ({_card_line()})", flush=True)
        if mode in ("bf16", "w8"):  # the 49-frame 2-pass forward in bf16, then under W8A8
            _headline_forward(f"Q2 {mode}", dit, torch.Generator(dev).manual_seed(1), 49, 480, 720, s49)
    del pipe, t5, vae, dit
    _free_device_memory()
    return {f"quant_pipeline_cogvideox_{mode}": counts[mode] for mode in ("w8", "w4")}


def _quant_entry(tag, run_fn, probe_kw, mode, want):
    """``run_fn(quantize)`` (a ``cli.run`` or ``serve_cli.run``) with ``--quantize mode`` and again without it over
    a pipeline that ``on_load`` quantizes with ``quantize_pipeline``: the final latents of the two bit for bit, the
    exact launches ``want`` in both. Returns the ``--quantize`` run's counts."""
    import numpy as np
    import torch

    from alg_tpu_torch.ops.quant import quantize_pipeline

    finals, counts = {}, {}
    extra = probe_kw.pop("on_load", None)
    for how in ("--quantize", "quantize_pipeline"):
        def on_load(pipe, how=how):
            if extra is not None:
                extra(pipe)
            if how == "quantize_pipeline":
                quantize_pipeline(pipe, mode)

        torch.cuda.reset_peak_memory_stats()
        with _CliProbe(None, on_load=on_load, **probe_kw) as probe:
            _reset_counts()
            _, seconds = _timed(lambda: run_fn(mode if how == "--quantize" else None))
            counts[how] = _read_counts()
        dit = probe.pipe.transformer
        n = {m.mode for m in dit.modules() if type(m).__name__ == "QuantizedLinear"}
        finals[how] = [np.asarray(f) for f in probe.final]
        print(f"[{tag}] {how} {mode}: {seconds:.2f} s with the load ({probe.load_s:.2f} s), the DiT "
              f"{_dit_bytes(dit) / 2**30:.3f} GiB with {mode} linears {sorted(n)}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({_card_line()})", flush=True)
        _check_counts(f"{tag} {how}", counts[how], want)
        del probe, dit
        _free_device_memory()
    same = len(finals["--quantize"]) == len(finals["quantize_pipeline"]) and all(
        np.array_equal(a, b) for a, b in zip(finals["--quantize"], finals["quantize_pipeline"]))
    print(f"[{tag}] --quantize {mode} against quantize_pipeline of the unquantized load: final latents bit for bit: "
          f"{'PASS' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError(f"[{tag}] --quantize and quantize_pipeline differ")
    return counts["--quantize"]


def phase_quant_entry() -> dict:
    """Q3: ``cli.run --quantize w8`` over phase F's CogVideoX-5b-I2V checkpoint, ``serve_cli.run --quantize w4``
    over S2's Wan2.1-I2V-14B directory with two requests, ``serve_cli.run --quantize w8`` over S3's
    HunyuanVideo-I2V directory with two requests (:func:`_quant_entry`). Returns {path: launch counts}."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from alg_tpu_torch import serve_cli, serving
    from alg_tpu_torch.cli import build_parser, run
    from alg_tpu_torch.io import hf_checkpoint as H

    out = {}
    tmp = tempfile.mkdtemp(prefix="alg_quant_")
    try:
        ck = copy.deepcopy(H.COGVIDEOX_5B_I2V)
        ck["transformer"]["num_layers"], ck["text_encoder"]["num_layers"] = 2, 2
        _write_checkpoint("Q3", "CogVideoX-5b-I2V (DiT and T5 2 layers)", H.write_cogvideox, ck,
                          f"{tmp}/{CLI_CONFIG['model']['path']}")
        _free_device_memory()
        image = np.random.RandomState(0).randint(0, 256, (CLI_HEIGHT, CLI_WIDTH, 3)).astype(np.uint8)

        def cli_run(quantize):
            argv = ["--model_cache_dir", tmp, "--output_path", os.path.join(tmp, "q.mp4"), "--device", "cuda"]
            return run(build_parser().parse_args(argv + (["--quantize", quantize] if quantize else [])),
                       config=CLI_CONFIG, image=image)

        out["cli_cogvideox_w8"] = _quant_entry("Q3 cli.run CogVideoX-5b-I2V", cli_run, {}, "w8",
                                               {"qk_prep": 16, "flash_attention": 12, "flash_attention_tc": 12})

        def serve_run(config, images, outdir):
            reqs = [serving.BatchRequest(p, img, negative_prompt="", seed=seed)
                    for p, img, seed in zip(SERVE_PROMPTS, images, SERVE_SEEDS)]

            def go(quantize):
                argv = ["--config", "-", "--model_cache_dir", tmp, "--output_dir", os.path.join(tmp, outdir),
                        "--device", "cuda"]
                return serve_cli.run(serve_cli.build_parser().parse_args(
                    argv + (["--quantize", quantize] if quantize else [])), config=config, requests=reqs)

            return go

        ck = copy.deepcopy(H.WAN21_I2V_14B)
        ck["transformer"]["num_layers"], ck["text_encoder"]["num_layers"] = 2, 2
        _write_checkpoint("Q3", "Wan2.1-I2V-14B (DiT and UMT5 2 layers)", H.write_wan, ck,
                          f"{tmp}/{SERVE_WAN_CONFIG['model']['path']}")
        _free_device_memory()
        images = [np.random.RandomState(40 + i).randint(0, 256, (480, 832, 3)).astype(np.uint8) for i in range(2)]
        cc = ck["image_encoder"]["num_hidden_layers"] * 2
        out["serve_wan_w4"] = _quant_entry(
            "Q3 serve_cli.run Wan2.1-I2V-14B", serve_run(SERVE_WAN_CONFIG, images, "wan"),
            {"stages": WAN_STAGES, "seq_len": _wan_seq_len}, "w4",
            {"rope_interleaved": 16, "flash_attention": 28 + cc, "flash_attention_tc": 28,
             "flash_attention_cuda_core": cc})
        shutil.rmtree(f"{tmp}/{SERVE_WAN_CONFIG['model']['path']}", ignore_errors=True)

        ck = copy.deepcopy(H.HUNYUAN_VIDEO_I2V)
        t, lc = ck["transformer"], ck["text_encoder"]
        t["num_layers"], t["num_single_layers"], t["num_refiner_layers"] = 2, 2, 2
        lc["text_config"]["num_hidden_layers"], lc["vision_config"]["num_hidden_layers"] = 2, 2
        _write_checkpoint("Q3", "HunyuanVideo-I2V (2 + 2 + 2 DiT blocks, Llava 2 + 2 layers)", H.write_hunyuan, ck,
                          os.path.join(tmp, SERVE_HY_CONFIG["model"]["path"]))
        _free_device_memory()
        images = [np.random.RandomState(50 + i).randint(0, 256, (*SERVE_HY_SIZE, 3)).astype(np.uint8)
                  for i in range(2)]
        cc = ck["text_encoder_2"]["num_hidden_layers"] * 2
        tc = (2 + 4) * 4 + 4 * 2
        out["serve_hunyuan_w8"] = _quant_entry(
            "Q3 serve_cli.run HunyuanVideo-I2V", serve_run(SERVE_HY_CONFIG, images, "hy"),
            {"stages": HY_STAGES, "seq_len": _HunyuanLengths(), "on_load": _hunyuan_image_processor}, "w8",
            {"rope_interleaved": 32, "flash_attention": tc + cc, "flash_attention_tc": tc,
             "flash_attention_cuda_core": cc})
        # Q4's first run trains over this directory
        out.update(_qlora_over_checkpoint(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_device_memory()
    return out


QLORA_HY_CONFIG = {  # configs/train/qlora_hunyuan_smoke.yaml as a mapping (the card's machine may lack PyYAML)
    "model": {"path": "hunyuanvideo-community/HunyuanVideo-I2V", "dtype": "bfloat16"},
    "generation": {"height": 320, "width": 480, "num_frames": 17, "num_inference_steps": 50, "guidance_scale": 6.0,
                   "max_sequence_length": 256},
}
QLORA_COG_CONFIG = {  # configs/train/qlora_cogvideox_smoke.yaml
    "model": {"path": "THUDM/CogVideoX-5b-I2V", "dtype": "bfloat16"},
    "generation": {"height": 320, "width": 480, "num_frames": 17, "num_inference_steps": 50, "guidance_scale": 6.0,
                   "max_sequence_length": 226},
}


def _qlora_run(tag, config, extra, transformer=None):
    """``train_cli.run --mode lora`` with ``extra`` (2 synthetic examples, 2 steps, remat, bf16 compute); checks finite
    losses, that every adapter moved and that the base took no gradient and did not move. Returns (launch counts,
    step ms)."""
    import tempfile

    import numpy as np
    import torch

    from alg_tpu_torch import train_cli
    from alg_tpu_torch.training.lora import lora_base

    import alg_tpu_torch.io.model_zoo as model_zoo

    seen = [] if transformer is None else [transformer]  # the run's DiT: given, or loaded (read back below)
    with tempfile.TemporaryDirectory() as tmp:
        args = train_cli.make_parser().parse_args(
            ["--config", "-", "--synthetic", "2", "--steps", "2", "--remat", "--compute_dtype", "bfloat16", "--seed",
             "0", "--lr", "1e-3", "--log_every", "1", "--mode", "lora", "--output", f"{tmp}/a.npz", *extra])
        load_transformer = model_zoo.load_transformer

        def keep(*a, **kw):
            seen.append(load_transformer(*a, **kw))
            return seen[-1]

        model_zoo.load_transformer = keep
        torch.cuda.reset_peak_memory_stats()
        try:
            with _StepClock() as clock:
                _reset_counts()
                out, seconds = _timed(lambda: train_cli.run(config, args, transformer=transformer))
                counts = _read_counts()
        finally:
            model_zoo.load_transformer = load_transformer
    dit = seen[-1]
    base = lora_base(dit)
    trainable = sum(t.numel() for ab in out["trainable"].values() for t in ab.values())
    quantized = sorted({m.mode for m in dit.modules() if type(m).__name__ == "QuantizedLinear"})
    no_grad = all(t.grad is None and not t.requires_grad for t in base.values())
    moved = all(bool(ab["B"].abs().max() > 0) for ab in out["trainable"].values())
    ok = no_grad and moved and bool(np.isfinite(out["losses"]).all()) and quantized
    print(f"[{tag}] train_cli.run {' '.join(extra)}: steps [{', '.join(f'{ms:.1f}' for ms in clock.ms)}] ms, "
          f"{seconds:.1f} s in all; losses {out['losses']}; base {_dit_bytes(dit) / 2**30:.2f} GiB ({quantized} "
          f"linears), {trainable} trainable adapter values; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({_card_line()}); the base took no gradient: "
          f"{no_grad}, every adapter moved: {moved}: {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[{tag}] the QLoRA run failed its checks")
    return counts, clock.ms


def _qlora_over_checkpoint(tmp) -> dict:
    """Q4's first run: 2 QLoRA steps (w8) over Q3's written HunyuanVideo-I2V directory at
    ``qlora_hunyuan_smoke.yaml``'s geometry (17 frames, 320x480)."""
    config = copy.deepcopy(QLORA_HY_CONFIG)
    counts, _ = _qlora_run("Q4 HunyuanVideo-I2V directory", config, ["--model_cache_dir", tmp, "--quantize", "w8"])
    return {"qlora_ckpt_hunyuan": counts}


def phase_qlora() -> dict:
    """Q4 at full depth: ``--random_init --quantize w8`` at ``qlora_hunyuan_smoke.yaml`` (the 12.82 B DiT with its
    modulation linears quantized, built block by block on the card) and ``--random_init --quantize w4`` at
    ``qlora_cogvideox_smoke.yaml``, 2 steps each. Returns {path: launch counts}."""
    import torch

    from alg_tpu_torch import train_cli

    out = {}
    for tag, family, config, mode, path in (
            ("Q4 HunyuanVideo full depth", "hunyuan", QLORA_HY_CONFIG, "w8", "qlora_hunyuan_full_w8"),
            ("Q4 CogVideoX-5b full depth", "cogvideox", QLORA_COG_CONFIG, "w4", "qlora_cogvideox_full_w4")):
        torch.cuda.reset_peak_memory_stats()
        dit, build_s = _timed(lambda: train_cli.random_init_transformer(family, torch.bfloat16, torch.device("cuda"),
                                                                        0, mode))
        block = next(m for m in dit.modules() if type(m).__name__ == "QuantizedLinear")
        snapshot = {n: b.clone() for n, b in block.named_buffers()}
        print(f"[{tag}] random_init_transformer(quantize={mode}) built and quantized block by block in {build_s:.1f} "
              f"s: {_dit_bytes(dit) / 2**30:.2f} GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        counts, _ = _qlora_run(tag, copy.deepcopy(config), ["--random_init", "--quantize", mode], transformer=dit)
        if not all(torch.equal(b, snapshot[n]) for n, b in block.named_buffers()):
            raise AssertionError(f"[{tag}] a quantized weight moved")
        out[path] = counts
        del dit, block, snapshot
        _free_device_memory()
    return out


def _quant_feed():
    """``tests/quant_feed.py``, jax-free and shared with the on-card tests: ``QuantFeed`` feeds each quantized
    linear call the input and output another run's call of the same weight took and gave, checking each against
    the call's own, and ``qlora_step_agreement`` is Q5's QLoRA step."""
    import importlib
    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module("quant_feed")


def phase_quant_agreement() -> dict:
    """Q5: small CogVideoX, Wan and HunyuanVideo checkpoints (S5's) loaded with ``quantize`` w8 and w4 on the card
    and on the CPU, fp32 with TF32 off, ``serve_batch`` of two requests, the card's quantized linears fed the CPU
    run's inputs and outputs (``quant_feed.QuantFeed``, each checked against the card's own: inputs within 1e-4
    of their largest value, at most 1e-3 of the codes and of the product's rows rounding the other way): final latents within 2e-3, frames above 40 dB;
    then one QLoRA step of a small CogVideoX DiT (w8, rank 4, remat, AdamW lr 1e-2 and eps 1e-4 as E2) card
    against CPU (``quant_feed.qlora_step_agreement``): loss rtol 1e-5, gradients within 1e-4 of each leaf's
    largest, the card's step within atol 1e-5 of the CPU's optimizer on the card's gradients. Returns {path: the
    card's launch counts}."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from alg_tpu_torch import serving
    from alg_tpu_torch.cli import load_pipeline
    from alg_tpu_torch.core.config import run_config_from_dict
    from alg_tpu_torch.io import hf_checkpoint as H

    _set_tf32(False, False)
    images = [np.random.RandomState(60 + i).randint(0, 256, (64, 64, 3)).astype(np.uint8) for i in range(2)]
    reqs = [serving.BatchRequest(p, img, negative_prompt="", seed=seed)
            for p, img, seed in zip(SERVE_PROMPTS, images, SERVE_SEEDS)]
    hy_config = _small_cli_config("SmallHunyuanVideo", num_frames=9, guidance_scale=1.0, true_cfg_scale=2.0,
                                  i2v_stable=True, max_sequence_length=20, prompt_template=SMALL_HY_TEMPLATE)
    hy_config["model"].update(flow_shift=7.0, flow_reverse=False)
    hy_config["alg"]["lp_resize_factor"] = 0.625
    wan_config = _small_cli_config("SmallWan", num_frames=9, guidance_scale=5.0)
    wan_config["alg"]["lp_resize_factor"] = 0.4
    cases = (("cogvideox", "SmallCogVideoX", H.write_cogvideox, SMALL_COGVIDEOX,
              _small_cli_config("SmallCogVideoX", num_frames=5, guidance_scale=6.0), ("qk_prep",)),
             ("wan", "SmallWan", H.write_wan, SMALL_WAN, wan_config, ("rope_interleaved",)),
             ("hunyuan", "SmallHunyuanVideo", H.write_hunyuan, SMALL_HUNYUAN, hy_config, ("rope_interleaved",)))
    tmp = tempfile.mkdtemp(prefix="alg_quant_small_")
    counts = {}
    try:
        for family, name, write, ck, config, _ in cases:
            write(os.path.join(tmp, name), ck, seed=4)
            cfg = run_config_from_dict(config)
            kw = cfg.pipeline_kwargs
            for mode in ("w8", "w4"):
                feed, results = _quant_feed().QuantFeed(), {}
                for dev, fed in (("cpu", feed.recording), ("cuda", feed.feeding)):
                    pipe = load_pipeline(cfg, tmp, quantize=mode, device=dev)
                    with fed():
                        _reset_counts()
                        lat = serving.serve_batch(pipe, reqs, **kw, output_type="latent")
                        n = _read_counts()
                        frames = serving.serve_batch(pipe, reqs, **kw, output_type="np")
                    results[dev] = (lat, frames, n)
                    del pipe
                lat_c, fr_c, n_c = results["cpu"]
                lat_g, fr_g, n_g = results["cuda"]
                err, psnr = float(np.abs(lat_g - lat_c).max()), _psnr(fr_g, fr_c)
                ok = err <= 2e-3 and psnr > 40.0 and not any(n_c.values()) and any(n_g.values())
                print(f"[Q5 {family} {mode}] serve_batch of two, card vs CPU, fp32, the card's quantized linear calls "
                      f"fed the CPU's ({feed.report()}): latents max|diff| {err:.3e} (atol 2e-3), frames PSNR "
                      f"{psnr:.1f} dB (> 40), launches card {n_g} / CPU {n_c}: {'PASS' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"[Q5 {family} {mode}] card and CPU disagree")
                feed.check()
                counts[f"agreement_serve_{family}_{mode}"] = n_g
        counts["agreement_qlora_cogvideox"] = _qlora_agreement()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_device_memory()
    return counts


def _qlora_agreement() -> dict:
    """Q5's QLoRA step (``quant_feed.qlora_step_agreement``, w8, seed 4); returns the card's launch counts."""
    _reset_counts()
    out = _quant_feed().qlora_step_agreement("cuda", "w8", seed=4)
    n_g = _read_counts()
    ok = out["ok"] and n_g["flash_attention_lse"] > 0
    print(f"[Q5 QLoRA] one step over a small CogVideoX DiT, card vs CPU, fp32, the card's quantized linear calls fed "
          f"the CPU's: {out['line']}; launches card {n_g}: {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("[Q5 QLoRA] card and CPU disagree")
    return n_g


def phase_quant() -> dict:
    """Q1-Q5 (``python3 chip_smoke.py --quant`` runs them alone); returns the launch counts by path."""
    phase_quant_linear()
    counts = phase_quant_pipeline()
    counts.update(phase_quant_entry())  # Q3, and Q4's run over Q3's Hunyuan directory
    counts.update(phase_qlora())
    counts.update(phase_quant_agreement())
    return counts


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# For each kernel: its source, the TPU kernel it replaces, the phase-B case whose numbers go into its JSON
# record (the shape a 2-pass step of the slice that runs it gives it) and that case's dtype (the CUDA-core
# forward, dq and dkv kernels take fp32 only since the tensor-core kernels took bf16), and the name of its
# launches in a run's counts.
_KERNELS = {
    "qk_prep": ("alg_tpu_torch/csrc/qk_prep.cu", "alg_tpu/ops/qk_prep.py:56", "qk_prep", [2, 48, 4276, 64],
                "bfloat16", "qk_prep"),
    "rope_interleaved": ("alg_tpu_torch/csrc/rope.cu", "alg_tpu/ops/qk_prep.py:134", "rope_interleaved",
                         [2, 40, 4680, 128], "bfloat16", "rope_interleaved"),
    "flash_attention_tc": ("alg_tpu_torch/csrc/flash_attention_tc.cu", "alg_tpu/ops/flash_attention.py:98",
                           "flash_wan_self", [2, 40, 4680, 128], "bfloat16", "flash_attention_tc"),
    "flash_attention": ("alg_tpu_torch/csrc/flash_attention.cu", "alg_tpu/ops/flash_attention.py:98",
                        "flash_wan_self", [2, 40, 4680, 128], "float32", "flash_attention_cuda_core"),
    # the training kernels, at the shape the 49-frame CogVideoX train step gives them; the LSE is an output of
    # both forward kernels, here of the tensor-core one
    "flash_attention_lse": ("alg_tpu_torch/csrc/flash_attention_tc.cu", "alg_tpu/ops/flash_attention.py:98",
                            "flash_lse_dit", [1, 48, 17776, 64], "bfloat16", "flash_attention_lse"),
    "flash_attention_bwd_dq_tc": ("alg_tpu_torch/csrc/flash_attention_bwd_dq_tc.cu",
                                  "alg_tpu/ops/flash_attention_bwd.py:89", "flash_bwd_dq_dit", [1, 48, 17776, 64],
                                  "bfloat16", "flash_attention_bwd_dq_tc"),
    "flash_attention_bwd_dq": ("alg_tpu_torch/csrc/flash_attention_bwd.cu", "alg_tpu/ops/flash_attention_bwd.py:89",
                               "flash_bwd_dq_dit", [1, 48, 17776, 64], "float32", "flash_attention_bwd_dq_cuda_core"),
    "flash_attention_bwd_dkv_tc": ("alg_tpu_torch/csrc/flash_attention_bwd_tc.cu",
                                   "alg_tpu/ops/flash_attention_bwd.py:144", "flash_bwd_dkv_dit", [1, 48, 17776, 64],
                                   "bfloat16", "flash_attention_bwd_dkv_tc"),
    "flash_attention_bwd_dkv": ("alg_tpu_torch/csrc/flash_attention_bwd.cu", "alg_tpu/ops/flash_attention_bwd.py:144",
                                "flash_bwd_dkv_dit", [1, 48, 17776, 64], "float32",
                                "flash_attention_bwd_dkv_cuda_core"),
    # the int8 kernel, "qk" mode, at the shape a 2-pass CogVideoX step gives it; the other mode and shapes ride
    # along: its bf16 instantiations (the sampling paths under the int8 modes) and its fp32 ones (the agreement
    # runs under the int8 modes)
    "flash_attention_int8_tc": ("alg_tpu_torch/csrc/flash_attention_int8_tc.cu",
                                "alg_tpu/ops/flash_attention_int8.py:109", "flash_int8_qk_dit", [2, 48, 4276, 64],
                                "bfloat16", "flash_attention_int8_tc"),
    "flash_attention_int8_tc_fp32": ("alg_tpu_torch/csrc/flash_attention_int8_tc.cu",
                                     "alg_tpu/ops/flash_attention_int8.py:109", "flash_int8_qk_dit",
                                     [2, 48, 4276, 64], "float32", "flash_attention_int8_tc_fp32"),
    # the qk prolog kernel, the transform of the forward kernel's prolog variant: LayerNorm + RoPE at the
    # CogVideoX shape; the prolog calls (prolog kernel and forward) ride along
    "qk_prolog": ("alg_tpu_torch/csrc/qk_prolog.cu", "alg_tpu/ops/flash_attention.py:138", "qk_prolog_layer_rope",
                  [2, 48, 4276, 64], "bfloat16", "qk_prolog"),
}
# Other variants of a kernel whose phase-B numbers ride along in its record ("also"): the other shapes, the
# causal calls and the Hunyuan DiT's joint call with kv_len, at the shapes phase C3 launches; for the forward,
# dq and dkv kernels only the records of the type each kernel takes.
_TRAIN_SHAPES = ("dit", "wan_self", "wan_cross_text", "hunyuan_joint", "square_causal")
_FLASH_SHAPES = ("flash_dit", "flash_wan_self", "flash_wan_cross_text", "flash_wan_cross_image", "flash_t5_bias_stable",
                 "flash_umt5_bias_kvlen", "flash_llama_causal_kvlen", "flash_clip_text_causal", "flash_clip",
                 "flash_clip_l_vision", "flash_hunyuan_refiner", "flash_hunyuan_joint", "flash_square_causal",
                 "flash_square_dense")
_ALSO = {"flash_attention_tc": _FLASH_SHAPES, "flash_attention": _FLASH_SHAPES, "qk_prep": ("qk_prep",),
         "rope_interleaved": ("rope_interleaved", "rope_hunyuan_joint"),
         "flash_attention_lse": tuple("flash_lse_" + n for n in _TRAIN_SHAPES),
         "flash_attention_bwd_dq_tc": tuple("flash_bwd_dq_" + n for n in _TRAIN_SHAPES),
         "flash_attention_bwd_dq": tuple("flash_bwd_dq_" + n for n in _TRAIN_SHAPES),
         "flash_attention_bwd_dkv_tc": tuple("flash_bwd_dkv_" + n for n in _TRAIN_SHAPES),
         "flash_attention_bwd_dkv": tuple("flash_bwd_dkv_" + n for n in _TRAIN_SHAPES),
         **{name: tuple(f"flash_int8_{mode}_{tag}" for mode in ("qk", "full", "full_bk64")
                        for tag in ("dit", "wan_self", "hunyuan_joint", "kvlen_zero_row"))
            for name in ("flash_attention_int8_tc", "flash_attention_int8_tc_fp32")},
         "qk_prolog": tuple(f"{kind}_prolog_{suffix}" for kind in ("qk", "flash")
                            for suffix in ("layer_rope", "rms_rope_stable", "rope", "layer", "layer_rope_q_only",
                                           "rms_rope"))}
_ONE_TYPE = ("flash_attention_tc", "flash_attention", "flash_attention_bwd_dq_tc", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv_tc", "flash_attention_bwd_dkv", "flash_attention_int8_tc",
             "flash_attention_int8_tc_fp32")


# ---------------------------------------------------------------------------
# H. the HunyuanVideo prepare on the card; M. multi-device (A13) on one card
# ---------------------------------------------------------------------------

# phase S3's HunyuanVideo-I2V config at the shipped 129 frames (the 352x608 clip buckets to itself at 360p)
PREP_HY_CONFIG = {**SERVE_HY_CONFIG, "generation": {**SERVE_HY_CONFIG["generation"], "num_frames": 129}}


def phase_hunyuan_prepare(tmp) -> dict:
    """H1: ``hf_checkpoint.HUNYUAN_VIDEO_I2V`` cut as phase S3 cuts it (2 double, 2 single and 2 refiner blocks,
    Llava 2 + 2 layers) written under ``tmp``; ``prepare_cli.run`` over one seeded 129-frame 352x608 clip, an
    array at the generated size (no PIL), Llava's image processor phase C3's seeded one: the stage times, the
    peak memory and the example's shapes. H2: a small HunyuanVideo checkpoint through ``prepare_cli.run`` on the
    card and on the CPU, fp32 with TF32 off, as G3 holds CogVideoX and Wan. Returns ``{"root", "data", counts}``
    for phase M2, which trains over the written example."""
    import os

    import numpy as np

    from alg_tpu_torch.io import hf_checkpoint as H

    ck = copy.deepcopy(H.HUNYUAN_VIDEO_I2V)
    t, lc = ck["transformer"], ck["text_encoder"]
    t["num_layers"], t["num_single_layers"], t["num_refiner_layers"] = 2, 2, 2
    lc["text_config"]["num_hidden_layers"], lc["vision_config"]["num_hidden_layers"] = 2, 2
    root = os.path.join(tmp, "h1")
    drawn = _write_checkpoint("H1", "HunyuanVideo-I2V (2 + 2 + 2 DiT blocks, Llava 2 + 2 layers)", H.write_hunyuan,
                              ck, os.path.join(root, PREP_HY_CONFIG["model"]["path"]))
    del drawn
    clip_dir = os.path.join(tmp, "h1_clip")
    os.makedirs(clip_dir)
    manifest = _write_manifest(clip_dir, [("h.npy", 129, *SERVE_HY_SIZE, 70, {})])
    data_dir = os.path.join(tmp, "h1_latents")
    examples, counts, rows, load_s = _run_prepare(PREP_HY_CONFIG, root, manifest, data_dir, "cuda", HY_STAGES,
                                                  on_load=_hunyuan_image_processor)
    _print_prepare("H1", rows, load_s, _card_line())
    shapes = {k: tuple(v.shape) for k, v in examples[0].items()}
    print(f"[H1] the example: {shapes}; launches {counts}", flush=True)
    lat = examples[0]["latents"]
    if lat.shape[1:] != (33, 44, 76) or not all(np.isfinite(v).all() for v in examples[0].values()):
        raise AssertionError(f"[H1] the prepared example is not 33 latent frames of 44 x 76, or not finite: {shapes}")
    if not counts["flash_attention"]:
        raise AssertionError("[H1] the Llava and CLIP text encodes launched no flash-attention kernel")
    _free_device_memory()

    _set_tf32(False, False)
    small = os.path.join(tmp, "h2")
    H.write_hunyuan(os.path.join(small, "SmallHunyuanVideo"), SMALL_HUNYUAN, seed=4)
    case_dir = os.path.join(tmp, "h2_clip")
    os.makedirs(case_dir)
    manifest = _write_manifest(case_dir, [("h0.npy", 9, 64, 64, 71, {})])
    config = {"model": {"path": "SmallHunyuanVideo", "dtype": "float32"},
              "generation": {"height": 64, "width": 64, "num_frames": 9, "max_sequence_length": 20}}
    runs = {dev: _run_prepare(config, small, manifest, os.path.join(case_dir, dev), dev, {}) for dev in ("cpu", "cuda")}
    (data_c, n_c, _, _), (data_g, n_g, _, _) = runs["cpu"], runs["cuda"]
    ok, errs = len(data_c) == len(data_g) == 1 and sorted(data_c[0]) == sorted(data_g[0]), {}
    for k in data_c[0]:
        a, b = data_c[0][k], data_g[0][k]
        ok &= a.shape == b.shape and a.dtype == b.dtype
        errs[k] = float(np.abs(a.astype(np.float64) - b).max())
        ok &= bool(np.allclose(b, a, atol=1e-4, rtol=1e-4))
    ok &= bool(np.array_equal(data_c[0]["encoder_attention_mask"], data_g[0]["encoder_attention_mask"]))
    ok &= not any(n_c.values()) and n_g["flash_attention"] > 0
    print(f"[H2] prepare_cli.run of a small HunyuanVideo checkpoint, card (kernels) vs CPU (plain), fp32: "
          f"max|diff| by key {errs} (atol 1e-4 + rtol 1e-4; the attention mask exact), launches card {n_g} / CPU "
          f"{n_c}: {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("[H2] the card's and the CPU's prepared HunyuanVideo latents disagree")
    _free_device_memory()
    return {"root": root, "data": data_dir, "counts": counts}


def _bf16_steps(a, b) -> float:
    """max|a - b| in bf16 steps at the largest magnitude of ``b`` (one step: 2^(floor(log2 max|b|) - 7))."""
    import math

    top = float(b.float().abs().max())
    return float((a.float() - b.float()).abs().max()) / 2.0 ** (math.floor(math.log2(top)) - 7)


def _ring_case(name, shape, sp, gen, kv_len=None, stable=False, reps=3) -> dict:
    """M1: one process plays the ``sp`` ranks of a ring in turn (``_ring_attention_local`` with a rotation that
    hands over the previous rank's chunk), each launching the flash forward with its LSE once a chunk, against
    the same ring whose chunks go through ``tensor_core_attention_plain`` and against one unsharded kernel call.
    Returns the record: errors, times, launches."""
    import torch

    from alg_tpu_torch.ops.attention import _ring_attention_local
    from alg_tpu_torch.ops.flash_attention import flash_attention, tensor_core_attention_plain

    b, h, s, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    scale, chunk = d ** -0.5, s // sp
    kc, vc = ([t.contiguous() for t in x.split(chunk, dim=2)] for x in (k, v))
    qc = [t.contiguous() for t in q.split(chunk, dim=2)]

    def ring(chunk_attention=None):
        outs = []
        for idx in range(sp):
            rotate = lambda r, k_, v_, i=idx: (lambda: (kc[(i - r - 1) % sp], vc[(i - r - 1) % sp]))  # noqa: E731
            outs.append(_ring_attention_local(qc[idx], kc[idx], vc[idx], kvl,
                                              scale=scale, stable=stable, sp=sp, index=idx, rotate=rotate,
                                              chunk_attention=chunk_attention))
        return torch.cat(outs, dim=2)

    def plain(q_, k_, v_, kv, heads=4):  # a few heads at a time: the fp32 logits of a chunk pair are 30 GB whole
        parts = [tensor_core_attention_plain(q_[:, i:i + heads], k_[:, i:i + heads], v_[:, i:i + heads], scale,
                                             kv_len=kv, stable=stable) for i in range(0, h, heads)]
        return torch.cat([o for o, _ in parts], dim=1), torch.cat([lse for _, lse in parts], dim=1)

    _reset_counts()
    out = ring()
    torch.cuda.synchronize()
    n = _read_counts()
    ref_ring = ring(plain)
    one = flash_attention(q, k, v, scale, stable=stable, kv_len=kvl)
    steps_plain, steps_one = _bf16_steps(out, ref_ring), _bf16_steps(out, one)
    finite = bool(torch.isfinite(out).all())
    want = sp * sp  # every rank launches the forward once a chunk
    ok = finite and steps_plain <= 1.0 and steps_one <= 1.0 and n["flash_attention_lse"] == want == \
        n["flash_attention_tc"]
    ring_ms = _time_ms(lambda: ring(), reps) / sp  # one rank's share: its sp launches
    one_ms = _time_ms(lambda: flash_attention(q, k, v, scale, stable=stable, kv_len=kvl), reps)
    print(f"[M1] {name} [{b},{h},{s},{d}] bf16 sp={sp}{'' if kv_len is None else f' kv_len={kv_len}'}: ring "
          f"(kernel chunks) vs plain ring {steps_plain:.3f} and vs one unsharded kernel call {steps_one:.3f} bf16 "
          f"steps (at most 1), finite {finite}; launches {n['flash_attention_lse']} forward-with-LSE (want "
          f"{want}, {sp} a rank); one rank's ring {ring_ms:.3f} ms ({sp} launches) vs one whole call "
          f"{one_ms:.3f} ms ({_card_line()}): {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[M1] the ring over the kernel disagrees at {name} sp={sp}")
    return {"name": name, "shape": list(shape), "sp": sp, "kv_len": kv_len, "steps_vs_plain_ring": steps_plain,
            "steps_vs_one_call": steps_one, "rank_ring_ms": ring_ms, "one_call_ms": one_ms,
            "launches": n["flash_attention_lse"]}


def phase_ring() -> list:
    """M1 at the CogVideoX-5b shape [2, 48, 17776, 64] (``stable=False``) at sp = 2 and 4, and at HunyuanVideo's
    joint [1, 24, 28128, 128] with ``kv_len``: the shipped text (27,872 video and 256 text positions, 118 of them
    real) and a row whose last chunks at sp = 4 lie wholly past ``kv_len`` (20,000), where the kernel must give
    zeros and an LSE of -inf. Returns the records."""
    import torch

    gen = torch.Generator("cuda").manual_seed(80)
    records = []
    for sp in (2, 4):
        records.append(_ring_case("CogVideoX-5b 49 frames", (2, 48, 17776, 64), sp, gen))
        records.append(_ring_case("HunyuanVideo 129 frames joint", (1, 24, 28128, 128), sp, gen, kv_len=[27990]))
    records.append(_ring_case("HunyuanVideo joint, chunks past kv_len", (1, 24, 28128, 128), 4, gen, kv_len=[20000]))
    _free_device_memory()
    return records


def _serve_script(tmp) -> str:
    """A launcher for ``serve_cli.run`` with a parsed config and uint8 requests (no PyYAML or PIL needed), for
    ``torchrun``: argv[1] is a JSON spec of the flags, the config, the prompts, seeds and an ``.npy`` of images."""
    import os

    path = os.path.join(tmp, "serve_under_torchrun.py")
    with open(path, "w") as f:
        f.write(
            "import json, sys\n"
            "import numpy as np\n"
            "from alg_tpu_torch import serve_cli\n"
            "from alg_tpu_torch.serving import BatchRequest\n"
            "spec = json.load(open(sys.argv[1]))\n"
            "images = np.load(spec['images'])\n"
            "reqs = [BatchRequest(p, img, negative_prompt='', seed=s)\n"
            "        for p, img, s in zip(spec['prompts'], images, spec['seeds'])]\n"
            "paths = serve_cli.run(serve_cli.build_parser().parse_args(spec['argv']), config=spec['config'],\n"
            "                      requests=reqs)\n"
            "print('WROTE ' + json.dumps(paths), flush=True)\n")
    return path


def _multi_serve_cases(tmp, hy_root):
    """M2's checkpoints at the published widths, cut to 2 DiT layers as phases S1-S3 cut them: (family, config, the
    model cache directory, the requests' images). CogVideoX-5b-I2V (DiT and T5 2 layers) and Wan2.1-I2V-14B (DiT and
    UMT5 2 layers) are written under ``tmp``; HunyuanVideo-I2V is phase H1's directory ``hy_root``."""
    import os

    import numpy as np

    from alg_tpu_torch.io import hf_checkpoint as H

    cases = []
    for tag, name, family, write, base, config, size in (
            ("M2", "CogVideoX-5b-I2V (DiT and T5 2 layers)", "cogvideox", H.write_cogvideox, H.COGVIDEOX_5B_I2V,
             CLI_CONFIG, (CLI_HEIGHT, CLI_WIDTH)),
            ("M2", "Wan2.1-I2V-14B (DiT and UMT5 2 layers)", "wan", H.write_wan, H.WAN21_I2V_14B, SERVE_WAN_CONFIG,
             (480, 832))):
        ck = copy.deepcopy(base)
        ck["transformer"]["num_layers"], ck["text_encoder"]["num_layers"] = 2, 2
        root = os.path.join(tmp, family)
        _write_checkpoint(tag, name, write, ck, os.path.join(root, config["model"]["path"]))  # the drawn tensors go
        cases.append((family, config, root, size))
    cases.append(("hunyuan", SERVE_HY_CONFIG, hy_root, SERVE_HY_SIZE))
    return [(family, config, root, [np.random.RandomState(70 + i).randint(0, 256, (*size, 3)).astype(np.uint8)
                                    for i in range(2)]) for family, config, root, size in cases]


def phase_multi(prepared: dict) -> dict:
    """M2: the mesh entry points in a world of one rank over NCCL (``sharding.init_process_group``). In such a world
    every axis holds one rank, so the mesh makes no process group and every collective is the identity, and at tp =
    1 the DiTs keep their unsharded modules: no NCCL collective, ring exchange or tensor-parallel layer runs here
    (the CPU tests run them over gloo). What runs is the mesh's plumbing on the card: the NCCL process group,
    ``make_mesh``, ``shard_pipeline`` and the mesh branches of ``serve_batch``, ``train_cli.run`` and
    ``make_sharded_train_step``, and ``serve_cli`` under ``torchrun``.

    * ``train_cli.run(mesh=make_mesh())`` over phase H1's example (the HunyuanVideo DiT of 2 + 2 + 2 blocks at the
      published width, loaded on the host and sharded onto the card) against the unsharded ``train_cli.run`` (the
      DiT loaded onto the card) of the same flags: losses and parameters bit for bit, and the sharded run's peak
      device memory not above the unsharded one's.
    * ``serve_batch(mesh=make_mesh(), sp_mode="ring")`` of the three families at the published widths, 2 DiT
      layers (:func:`_multi_serve_cases`), bit for bit ``mesh=None``.
    * ``serve_cli --dp 1 --tp 1`` under ``torchrun --nproc_per_node 1`` over the CogVideoX checkpoint.

    Returns the launch counts by path."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import alg_tpu_torch.training.train as T
    from alg_tpu_torch import serving, train_cli
    from alg_tpu_torch.cli import load_pipeline
    from alg_tpu_torch.core.config import run_config_from_dict
    from alg_tpu_torch.sharding import init_process_group, make_mesh
    from alg_tpu_torch.sharding.mesh import free_port

    counts = {}
    init_process_group(0, 1, f"tcp://127.0.0.1:{free_port()}", "cuda")
    print(f"[M2] process group: backend {dist.get_backend()}, world {dist.get_world_size()}", flush=True)
    train_argv = ["--config", "-", "--model_cache_dir", prepared["root"], "--data", prepared["data"], "--mode",
                  "full", "--remat", "--compute_dtype", "bfloat16", "--seed", "0", "--lr", "1e-5", "--steps", "2",
                  "--log_every", "1", "--prefetch", "0", "--output", os.devnull, "--dp", "1", "--tp", "1", "--pp", "1"]
    args = train_cli.make_parser().parse_args(train_argv)
    if train_cli._train_mesh(args) is not None:
        raise AssertionError("[M2] --dp 1 --tp 1 --pp 1 in a one-rank launch asked for a mesh")
    save = T.save_params_npz
    T.save_params_npz = lambda path, params: None  # 4.4 GB of fp32 parameters, compared in memory instead
    try:
        runs = {}
        for tag, mesh in (("unsharded", None), ("mesh", make_mesh(device="cuda"))):
            _free_device_memory()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            out = train_cli.run(PREP_HY_CONFIG, args, mesh=mesh)
            torch.cuda.synchronize()
            elapsed, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
            out["trainable"] = {k: v.detach().cpu() for k, v in out["trainable"].items()}  # off the card: the
            runs[tag] = (out, _read_counts(), elapsed, peak)  # next run's peak counts its own tensors alone
    finally:
        T.save_params_npz = save
    (a, n_a, s_a, m_a), (b, n_b, s_b, m_b) = runs["unsharded"], runs["mesh"]
    same = a["losses"] == b["losses"] and set(a["trainable"]) == set(b["trainable"]) and all(
        torch.equal(a["trainable"][k], b["trainable"][k]) for k in a["trainable"])
    ok = same and n_a == n_b and all(np.isfinite(a["losses"])) and m_b <= m_a
    print(f"[M2] train_cli.run --mode full over H1's example (HunyuanVideo 2 + 2 + 2 blocks, S = 28,128), 2 steps: "
          f"unsharded (the DiT loaded onto the card) {s_a:.1f} s, peak {m_a:.2f} GiB; mesh=make_mesh() (the DiT "
          f"loaded on the host, its shards put on the card) {s_b:.1f} s, peak {m_b:.2f} GiB (want at most the "
          f"unsharded peak); losses {a['losses']} / {b['losses']}; parameters bit for bit {same}; launches {n_b} "
          f"({_card_line()}): {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("[M2] the sharded step at world size 1 is not the unsharded step, or holds more memory")
    counts["multi_train_hunyuan"] = n_b
    del runs, a, b
    _free_device_memory()

    mesh = make_mesh(device="cuda")
    tmp = tempfile.mkdtemp(prefix="alg_multi_serve_")
    cases = _multi_serve_cases(tmp, prepared["root"])
    for family, config, root, images in cases:
        reqs = [serving.BatchRequest(p, img, negative_prompt="", seed=seed)
                for p, img, seed in zip(SERVE_PROMPTS, images, SERVE_SEEDS)]
        cfg = run_config_from_dict(config)
        pipe = load_pipeline(cfg, root, device="cuda")
        if family == "hunyuan":
            _hunyuan_image_processor(pipe)
        kw = dict(cfg.pipeline_kwargs)
        if family == "hunyuan":
            kw["height"], kw["width"] = serving.hunyuan_size(cfg.video["resolution"], images[0])
        single, single_s = _timed(lambda: serving.serve_batch(pipe, reqs, **kw, output_type="latent"))
        _reset_counts()
        sharded, sharded_s = _timed(lambda: serving.serve_batch(pipe, reqs, mesh=mesh, sp_mode="ring", **kw,
                                                                output_type="latent"))
        n = _read_counts()
        single, sharded = np.asarray(single), np.asarray(sharded)
        same = bool(np.array_equal(single, sharded))
        ok = same and bool(np.isfinite(sharded).all()) and n["flash_attention_tc"] > 0
        print(f"[M2] serve_batch(mesh=make_mesh(), sp_mode='ring') of the {family} checkpoint at the published widths "
              f"(2 DiT layers), bf16, two requests, latents {tuple(sharded.shape)}: against mesh=None bit for bit "
              f"{same}; {sharded_s:.2f} s against {single_s:.2f} s ({_card_line()}); launches {n}: "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"[M2] serving over a one-rank mesh changed the {family} output")
        counts[f"multi_serve_{family}"] = n
        del pipe
        _free_device_memory()

    # serve_cli under torchrun: a mesh of the launch's one rank, in its own process
    _, cog_config, cog_root, images = cases[0]
    spec = os.path.join(tmp, "spec.json")
    np.save(os.path.join(tmp, "images.npy"), np.stack(images))
    with open(spec, "w") as f:
        json.dump({"argv": ["--config", "-", "--model_cache_dir", cog_root, "--output_dir", os.path.join(tmp, "out"),
                            "--device", "cuda", "--dp", "1", "--tp", "1"], "config": cog_config,
                   "prompts": list(SERVE_PROMPTS), "seeds": list(SERVE_SEEDS),
                   "images": os.path.join(tmp, "images.npy")}, f)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1", "--master_port",
                           str(free_port()), _serve_script(tmp), spec], cwd=repo, env=env, capture_output=True,
                          text=True, timeout=600)
    wrote = [json.loads(line[6:]) for line in proc.stdout.splitlines() if line.startswith("WROTE ")]
    ok = proc.returncode == 0 and len(wrote) == 1 and len(wrote[0]) == 2 and all(os.path.exists(p) for p in wrote[0])
    print(f"[M2] torchrun --nproc_per_node 1 serve_cli --dp 1 --tp 1 (CogVideoX-5b-I2V at the published widths, DiT "
          f"and T5 2 layers, bf16, two requests): exit {proc.returncode}, wrote {wrote} in "
          f"{time.perf_counter() - t0:.1f} s: {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", flush=True)
        raise AssertionError("[M2] serve_cli under torchrun failed")
    dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)
    _free_device_memory()
    return counts


def phase_multi_all() -> dict:
    """H then M (``python3 chip_smoke.py --multi`` runs them alone); returns the launch counts by path."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="alg_multi_")
    try:
        t0 = time.perf_counter()
        prepared = phase_hunyuan_prepare(tmp)
        t1 = time.perf_counter()
        ring = phase_ring()
        t2 = time.perf_counter()
        counts = phase_multi(prepared)
        counts["prepare_hunyuan"] = prepared["counts"]
        print(f"[H/M] H {t1 - t0:.1f} s, M1 {t2 - t1:.1f} s, M2 {time.perf_counter() - t2:.1f} s; the ring records: "
              f"{json.dumps(ring)}", flush=True)
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _kernel_json(records, counts_by_path) -> dict:
    """``counts_by_path``: {path name: launch counts of that path's run}."""
    out = []
    for name, (source, replaces, case, shape, dtype, count) in _KERNELS.items():
        rec = next(r for r in records if r["name"] == case and r["shape"] == shape and r["dtype"] == dtype)
        by_path = {path: counts[count] for path, counts in counts_by_path.items()}
        also = [{key: r[key] for key in ("name", "dtype", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "drift_mean", "drift_max", "quantizers_ms",
                                         "bf16_flash_ms", "unfused_ms", "flash_alone_ms", "device_ms",
                                         "prolog_device_ms", "forward_device_ms", "values_that_differ") if key in r}
                for case_name in _ALSO.get(name, ()) for r in records
                if r["name"] == case_name and r is not rec and (name not in _ONE_TYPE or r["dtype"] == dtype)]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": sum(by_path.values()), "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"], "at": f"{dtype} {shape}", "launches_by_path": by_path,
                    "also": also})
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
    if sys.argv[1:] == ["--dense-flash"]:
        try:
            phase_build(require_tensor_cores=False)
            phase_dense_flash()
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    if sys.argv[1:] == ["--cli"]:
        try:
            phase_build()
            phase_cli()
            phase_cli_agreement()
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    if sys.argv[1:] == ["--finetune"]:
        try:
            phase_build()
            phase_finetune_cogvideox()
            phase_finetune_wan()
            phase_finetune_agreement()
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    if sys.argv[1:] == ["--serve"]:
        try:
            phase_build()
            phase_serve()
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    if sys.argv[1:] == ["--quant"]:
        try:
            phase_build()
            phase_quant()
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    if sys.argv[1:] == ["--multi"]:
        try:
            phase_build()
            phase_multi_all()
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    if sys.argv[1:] == ["--cogvideox15"]:
        try:
            phase_build()
            records = []
            _cogvideox15_kernel_cases(records, torch.Generator("cuda").manual_seed(0))
            _require_all_ok(records)
            phase_slice("cogvideox15")
            phase_cogvideox15_checkpoint()
            phase_agreement_cogvideox15()
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    try:
        phase_build()
        records = phase_kernels()
        counts = phase_slice()  # the bf16 path and the int8 paths over the same pipeline
        counts.update(phase_slice_wan())  # after the CogVideoX modules are freed
        counts.update(phase_slice_hunyuan())  # after the Wan modules are freed
        counts.update(phase_slice("cogvideox15"))  # after the Hunyuan modules are freed
        counts["prolog_entry"] = phase_prolog_entry()
        counts["cli_cogvideox"] = phase_cli()
        counts.update(phase_agreement())  # the card's counts of its fp32 runs under the int8 modes
        counts.update(phase_agreement_wan())
        counts.update(phase_agreement_hunyuan())
        counts.update(phase_agreement_cogvideox15())
        phase_cli_agreement()
        counts["train_cogvideox"] = phase_train()
        for name, n in phase_train_entry().items():
            counts["train_cogvideox"][name] += n
        counts["train_agreement_fp32"] = phase_train_agreement()
        counts.update(phase_finetune_cogvideox())  # prepare, train over the checkpoint, cli.run --lora
        counts.update(phase_finetune_wan())
        phase_finetune_agreement()
        counts.update(phase_cogvideox15_checkpoint())  # F3, G4
        counts.update(phase_serve())  # S1-S5
        counts.update(phase_quant())  # Q1-Q5
        counts.update(phase_multi_all())  # H1-H2, M1-M2
        for path, kernels in (("cogvideox", ("qk_prep", "flash_attention_tc")),
                              ("cli_cogvideox", ("qk_prep", "flash_attention_tc")),
                              ("wan", ("rope_interleaved", "flash_attention_tc", "flash_attention_cuda_core")),
                              ("hunyuan", ("rope_interleaved", "flash_attention_tc", "flash_attention_cuda_core")),
                              ("cogvideox_int8_qk", ("qk_prep", "flash_attention_tc", "flash_attention_int8_tc")),
                              ("cogvideox_int8_full", ("qk_prep", "flash_attention_tc", "flash_attention_int8_tc")),
                              ("wan_int8_qk", ("rope_interleaved", "flash_attention_tc", "flash_attention_int8_tc")),
                              ("hunyuan_int8_full", ("rope_interleaved", "flash_attention_tc",
                                                     "flash_attention_int8_tc")),
                              ("agreement_cogvideox_int8_qk", ("qk_prep", "flash_attention_int8_tc_fp32")),
                              ("agreement_cogvideox_int8_full", ("qk_prep", "flash_attention_int8_tc_fp32")),
                              ("agreement_hunyuan_int8_full", ("rope_interleaved", "flash_attention_int8_tc_fp32")),
                              ("prolog_entry", ("qk_prolog", "flash_attention_tc")),
                              *((path, ("qk_prep", "flash_attention_tc")) for path in (
                                  "cogvideox_pixel", "cogvideox_dpm", "cogvideox_eta", "cogvideox_dyncfg",
                                  "cogvideox_resume", "cogvideox_cache")),
                              ("wan_pixel", ("rope_interleaved", "flash_attention_tc")),
                              ("hunyuan_pixel", ("rope_interleaved", "flash_attention_tc",
                                                 "flash_attention_cuda_core")),
                              *((f"agreement_cogvideox_{name}", ("qk_prep", "flash_attention_cuda_core"))
                                for name in ("pixel", "dpm", "eta")),
                              *((f"agreement_{family}_pixel", ("rope_interleaved", "flash_attention_cuda_core"))
                                for family in ("wan", "hunyuan")),
                              ("train_cogvideox", ("qk_prep", "flash_attention_tc", "flash_attention_lse",
                                                   "flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc")),
                              ("train_agreement_fp32", ("flash_attention_cuda_core", "flash_attention_bwd_dq_cuda_core",
                                                        "flash_attention_bwd_dkv_cuda_core")),
                              ("prepare_cogvideox", ("flash_attention_tc",)),
                              ("prepare_wan", ("flash_attention_tc", "flash_attention_cuda_core")),
                              ("train_ckpt_cogvideox", ("qk_prep", "flash_attention_lse", "flash_attention_bwd_dq_tc",
                                                        "flash_attention_bwd_dkv_tc")),
                              ("train_ckpt_wan", ("rope_interleaved", "flash_attention_lse",
                                                  "flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc")),
                              ("cli_lora_cogvideox", ("qk_prep", "flash_attention_tc")),
                              *((path, ("qk_prep", "flash_attention_tc")) for path in ("cogvideox15", "cli_cogvideox15")),
                              ("prepare_cogvideox15", ("flash_attention_tc",)),
                              ("train_ckpt_cogvideox15", ("qk_prep", "flash_attention_lse",
                                                          "flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc")),
                              *((path, ("qk_prep", "flash_attention_cuda_core"))
                                for path in ("agreement_cogvideox15", "agreement_cogvideox15_pixel")),
                              *((path, ("qk_prep", "flash_attention_tc"))
                                for path in ("serve_cogvideox", "serve_worker_cogvideox")),
                              *((path, ("rope_interleaved", "flash_attention_tc", "flash_attention_cuda_core"))
                                for path in ("serve_wan", "cli_hunyuan", "serve_hunyuan")),
                              ("agreement_serve_cogvideox", ("qk_prep", "flash_attention_cuda_core")),
                              *((f"agreement_serve_{family}", ("rope_interleaved", "flash_attention_cuda_core"))
                                for family in ("wan", "hunyuan")),
                              # Q: the quantized paths launch the attention kernels their bf16 runs launch
                              *((f"quant_pipeline_cogvideox_{mode}", ("qk_prep", "flash_attention_tc"))
                                for mode in ("w8", "w4")),
                              ("cli_cogvideox_w8", ("qk_prep", "flash_attention_tc")),
                              *((path, ("rope_interleaved", "flash_attention_tc", "flash_attention_cuda_core"))
                                for path in ("serve_wan_w4", "serve_hunyuan_w8")),
                              *((path, ("rope_interleaved", "flash_attention_lse", "flash_attention_bwd_dq_tc",
                                        "flash_attention_bwd_dkv_tc"))
                                for path in ("qlora_ckpt_hunyuan", "qlora_hunyuan_full_w8")),
                              ("qlora_cogvideox_full_w4", ("qk_prep", "flash_attention_lse", "flash_attention_bwd_dq_tc",
                                                           "flash_attention_bwd_dkv_tc")),
                              *((f"agreement_serve_cogvideox_{mode}", ("qk_prep", "flash_attention_cuda_core"))
                                for mode in ("w8", "w4")),
                              *((f"agreement_serve_{family}_{mode}", ("rope_interleaved", "flash_attention_cuda_core"))
                                for family in ("wan", "hunyuan") for mode in ("w8", "w4")),
                              ("agreement_qlora_cogvideox", ("qk_prep", "flash_attention_cuda_core",
                                                             "flash_attention_bwd_dq_cuda_core",
                                                             "flash_attention_bwd_dkv_cuda_core")),
                              # H, M: the prepare's encoders, the sharded step and the mesh-routed serving
                              ("prepare_hunyuan", ("flash_attention_tc",)),
                              ("multi_train_hunyuan", ("rope_interleaved", "flash_attention_lse",
                                                       "flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc")),
                              ("multi_serve_cogvideox", ("qk_prep", "flash_attention_tc")),
                              *((f"multi_serve_{family}", ("rope_interleaved", "flash_attention_tc"))
                                for family in ("wan", "hunyuan"))):
            idle = [k for k in kernels if not counts[path][k]]
            if idle:
                raise AssertionError(f"the {path} path launched no {idle} kernel")
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps(_kernel_json(records, counts)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
