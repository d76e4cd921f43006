"""Traffic driver ``wan``: one image-to-video request through ``WanPipeline.__call__``.

As the ``sample`` driver does for CogVideoX: set-up builds the DiT (bf16)
and the VAE (fp32) on the device, copies into them weights the benchmark
draws from the seed in the published layout (through the program's
checkpoint name map), and warms up with a short call at the traffic's
``warmup`` size. The window is one call at the traffic's generation
settings with ``output_type="latent"``, the seed's prompt, negative-prompt
and image embeddings (UMT5-XXL's and CLIP ViT-H's output shapes), and a
``step_observer`` (:class:`NearestEnd`) that notes the time and the latents
after each step and ends the window at the step end nearest ``seconds``: a
step here is about half the window, so ending at the first step end past
``seconds`` would put the window's end where a card's speed decides
between 2 and 3 steps. ``sample_step_s`` is the window's wall time over the
steps completed. A forward hook on the DiT keeps each forward's output on
the device; no copy or synchronise is added to the step.

After the window, with the program freed, the plain reference recomputes a
step drawn from the seed among the window's steps (one of each kind, 3-pass
and 2-pass, where the window holds it) from what the program held before
it: its latents, and the UniPC history, rebuilt by the reference's own
combine and solver from the latents each earlier step started from and the
program's DiT outputs of those steps. It judges the latents the program
produced and each CFG pass's DiT output.

Under ``--trace 1`` the window also holds a range around the call, one
around each DiT forward (opened and closed after a synchronise) and one at
the end of each step, which the per-layer readers find in ``sample.View``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.drivers.sample import CALL_RANGE, DIT_RANGE, DTYPES, STEP_END_RANGE, Observer, PassOutputs
from benchmark.drivers.sample import Reference as SampleReference
from benchmark.drivers.sample import DitSpans, View, _dataclass, _ranges, _sync, kind, sampled_steps
from benchmark.flops_wan import video_tokens
from benchmark.reference import wan_sampler
from benchmark.weights import derive_seed, make_weights
from benchmark.weights_wan import wan_transformer_spec, wan_vae_spec


def build_pipeline(config: dict, seed: int, device):
    """The program's pipeline, with the seed's weights, as the configuration states it."""
    from alg_tpu_torch.io import weights as W
    from alg_tpu_torch.models.wan.transformer import WanTransformer, WanTransformerConfig
    from alg_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig
    from alg_tpu_torch.pipelines.wan import WanPipeline
    from alg_tpu_torch.schedulers.unipc import UniPCConfig

    dit_dtype, vae_dtype = DTYPES[config["dtypes"]["transformer"]], DTYPES[config["dtypes"]["vae"]]
    tcfg = _dataclass(WanTransformerConfig, config["transformer"])
    vcfg = _dataclass(WanVAEConfig, config["vae"])
    dit = WanTransformer(tcfg, device="meta", dtype=dit_dtype).to_empty(device=device)
    state = make_weights(wan_transformer_spec(config["transformer"]), derive_seed(seed, "dit"), device, dit_dtype)
    W.load_tree(dit, W.convert_wan_transformer(state, tcfg))
    del state
    vae = WanVAE(vcfg, device="meta", dtype=vae_dtype).to_empty(device=device)
    state = make_weights(wan_vae_spec(config["vae"]), derive_seed(seed, "vae"), device, vae_dtype)
    W.load_tree(vae, W.convert_wan_vae(state, vcfg))
    del state
    dit.requires_grad_(False)
    vae.requires_grad_(False)
    return WanPipeline(transformer=dit, vae=vae, scheduler_cfg=_dataclass(UniPCConfig, config["scheduler"]),
                       dtype=dit_dtype, device=device)


@torch.no_grad()
def request(seed: int, config: dict, traffic: dict, device, dtype):
    """(image, prompt, negative, image_embeds): ``benchmark.inputs.request``'s image and UMT5-shaped
    embeddings, and CLIP ViT-H's penultimate hidden states ``[1, image_tokens, image_dim]`` drawn
    N(0, 1) in ``dtype`` from a generator of their own."""
    tc = config["transformer"]
    image, prompt, negative = inputs.request(seed, traffic, tc["text_dim"], device, dtype)
    gen = torch.Generator(device).manual_seed(derive_seed(seed, "image_embeds"))
    image_embeds = torch.randn((1, traffic["image_tokens"], tc["image_dim"]), generator=gen, device=device).to(dtype)
    return image, prompt, negative, image_embeds


def call_kwargs(traffic: dict) -> dict:
    """The pipeline's generation arguments from a traffic file."""
    kw = {k: traffic[k] for k in ("height", "width", "num_frames", "num_inference_steps", "guidance_scale")}
    kw.update(traffic.get("alg", {}))
    return kw


class NearestEnd(Observer):
    """``sample.Observer`` whose window ends at the step end nearest ``seconds`` after ``start``: after a
    step it sets the pipeline's ``interrupt`` once one more step as long as that one would end further
    from ``seconds`` than this step's end does."""

    def __call__(self, i, latents):
        super().__call__(i, latents)
        last = self.times[-1] - (self.times[-2] if len(self.times) > 1 else self.start)
        if self.times[-1] - self.start + last / 2 >= self.seconds:
            self.pipe.interrupt = True


class Forwards(DitSpans):
    """``sample.DitSpans`` for ``WanTransformer``, whose forward takes ``(hidden_states [B, C, F, h, w],
    timestep, encoder_hidden_states, encoder_hidden_states_image, rope_cos, rope_sin)``: each forward's
    passes (batch rows), text and image tokens and latent shape. Only in a traced run."""

    def _pre(self, module, args):
        _sync(self.device)
        x, text, img = args[0], args[2], args[3]
        self.forwards.append({"passes": x.shape[0], "s_text": text.shape[1], "s_image": 0 if img is None else
                              img.shape[1], "frames": x.shape[2], "h": x.shape[3], "w": x.shape[4]})
        self._range = self.record_function(DIT_RANGE)
        self._range.__enter__()


def view_of(trace, forwards: list, steps: int, dit_cfg: dict) -> View:
    dits, calls, ends = _ranges(trace, DIT_RANGE), _ranges(trace, CALL_RANGE), _ranges(trace, STEP_END_RANGE)
    if len(dits) != len(forwards) or len(calls) != 1 or len(ends) != steps:
        raise RuntimeError(f"the trace holds {len(dits)} DiT ranges, {len(calls)} calls and {len(ends)} step ends "
                           f"for {len(forwards)} forwards in {steps} steps")
    rows = [{**f, "s_video": video_tokens(dit_cfg, f["frames"], f["h"], f["w"]), "start": a, "end": b,
             "seconds": (b - a) / 1e6} for f, (a, b) in zip(forwards, dits)]
    return View(trace=trace, forwards=rows, call_start=calls[0][0], step_ends=[b for _, b in ends], steps=steps,
                dit_cfg=dit_cfg)


def launch_counts() -> dict:
    """The port's launch counters of the kernels the window drives."""
    from alg_tpu_torch.ops.flash_attention import flash_attention
    from alg_tpu_torch.ops.rope import rope_interleaved

    out = {"rope": rope_interleaved.launches, "flash_attention": flash_attention.launches}
    out.update({f"flash_attention_{k}": v for k, v in flash_attention.launches_by_route.items()})
    return out


def window(pipe, kw: dict, seconds: float, noise, req, device, trace: bool):
    """One call of the pipeline, interrupted after ``seconds``.
    Returns (observer, latents, each forward's output, (trace, forwards) or None)."""
    from benchmark import trace as tr

    image, prompt, negative, image_embeds = req
    outputs = PassOutputs(pipe.transformer)
    spans = Forwards(pipe.transformer, device) if trace else None
    image_np = image.cpu().numpy()
    with contextlib.ExitStack() as stack:
        box = stack.enter_context(tr.profiled(lambda: _sync(device))) if trace else None
        obs = NearestEnd(pipe, seconds, mark=spans.step_end if trace else None)
        if trace:
            stack.enter_context(spans.record_function(CALL_RANGE))
        out = pipe(image=image_np, prompt_embeds=prompt, negative_prompt_embeds=negative, image_embeds=image_embeds,
                   noise_source=noise, output_type="latent", step_observer=obs, **kw)
        _sync(device)
    outputs.remove()
    if trace:
        spans.remove()
    return obs, out, outputs.outputs, (box[0], spans.forwards) if trace else None


class Reference:
    """The plain reference of one run: the seed's weights made again, the condition encoded from the
    same image, and :meth:`judge` for a step the program took."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, noise, req):
        from benchmark.reference import strict_fp32, wan_vae

        strict_fp32()
        self.config, self.traffic, self.device = config, traffic, device
        image, prompt, negative, image_embeds = req
        self.latents0 = noise.draws[0]
        vae_w = make_weights(wan_vae_spec(config["vae"]), derive_seed(seed, "vae"), device,
                             DTYPES[config["dtypes"]["vae"]])
        self.cond = wan_vae.condition(vae_w, config["vae"], image.to(device), traffic["num_frames"])
        del vae_w
        if self.cond.shape[2:] != self.latents0.shape[2:]:
            raise RuntimeError(f"the program's initial latents are {tuple(self.latents0.shape)}, the reference's "
                               f"condition {tuple(self.cond.shape)}")
        self.dit_w = make_weights(wan_transformer_spec(config["transformer"]), derive_seed(seed, "dit"), device,
                                  DTYPES[config["dtypes"]["transformer"]])
        self.prompt, self.negative, self.image = prompt.float(), negative.float(), image_embeds.float()
        self.solver = wan_sampler.UniPC(config["scheduler"], traffic["num_inference_steps"])

    def state(self, xs, passes) -> wan_sampler.UniPCState:
        """The solver's state before step ``len(xs)`` from the program's inputs and DiT outputs of the
        steps before it."""
        return wan_sampler.replay(self.solver, wan_sampler.guidance(self.traffic),
                                  [x.to(self.device) for x in xs], [p.to(self.device) for p in passes])

    def reference(self, i: int, x_in: torch.Tensor, state: wan_sampler.UniPCState, lowp: bool = False):
        """(the reference's latents after step ``i`` from ``x_in``, the model term, each CFG pass's DiT
        output). ``lowp``: the control, the reference with its products in float8."""
        return wan_sampler.step(self.dit_w, self.config["transformer"], self.solver, self.traffic, i,
                                x_in.float().to(self.device), state, self.cond, self.negative, self.prompt,
                                self.image, lowp=lowp)

    def judge(self, i: int, xs, passes, x_out: torch.Tensor) -> dict:
        """The numbers of step ``i``: ``xs`` the latents each step ``0..i`` started from, ``passes`` the
        program's DiT outputs of those steps, ``x_out`` its latents after step ``i``."""
        x_ref, term, ref_passes = self.reference(i, xs[i], self.state(xs[:i], passes[:i]))
        return SampleReference.numbers(kind(self.traffic, i), x_out.to(self.device), x_ref, term,
                                       passes[i].to(self.device), ref_passes)


def check(ref: Reference, obs, outputs: list, steps: dict) -> dict:
    """The numbers of the sampled ``steps`` ({kind: step}), judged against the reference."""
    xs = [ref.latents0] + [torch.from_numpy(a) for a in obs.latents]
    numbers = {}
    for i in sorted(set(steps.values())):
        numbers.update(ref.judge(i, xs[:i + 1], outputs[:i + 1], xs[i + 1]))
    return numbers


def run(cell) -> dict:
    device, seed, traffic, config = cell.device, cell.seed, cell.traffic, cell.config
    marks = [("imports", time.time())]
    pipe = build_pipeline(config, seed, device)
    req = request(seed, config, traffic, device, pipe.dtype)
    image, prompt, negative, image_embeds = req
    kw = call_kwargs(traffic)
    _sync(device)
    marks.append(("weights and modules", time.time()))

    warm = traffic["warmup"]
    warm_obs = Observer(pipe, max_steps=warm["steps"])
    pipe(image=image.cpu().numpy(), prompt_embeds=prompt, negative_prompt_embeds=negative, image_embeds=image_embeds,
         noise_source=inputs.SeededNoise(seed, "warmup", device), output_type="latent", step_observer=warm_obs,
         **{**kw, "num_frames": warm["num_frames"]})
    _sync(device)
    marks.append(("warm-up", time.time()))
    setup_s = marks[-1][1] - cell.t_process
    setup_parts = {name: t - prev for (name, t), prev in zip(marks, [cell.t_process] + [t for _, t in marks])}
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    counts0 = launch_counts()
    noise = inputs.SeededNoise(seed, "noise", device)
    obs, out, outputs, traced = window(pipe, kw, cell.seconds, noise, req, device, cell.trace)
    counts = {k: v - counts0.get(k, 0) for k, v in launch_counts().items()}
    steps = len(obs.times)
    window_s = obs.times[-1] - obs.start
    memory_peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    if not np.array_equal(out, obs.latents[-1]):
        raise RuntimeError("the call returned other latents than its last step's")
    if len(outputs) != steps:
        raise RuntimeError(f"{len(outputs)} DiT forwards in {steps} steps")
    step_s = np.diff([obs.start] + obs.times)
    checked = sampled_steps(traffic, steps, seed)
    outputs = outputs[:max(checked.values()) + 1]
    view = view_of(traced[0], traced[1], steps, dict(config["transformer"])) if traced else None
    obs.pipe = warm_obs.pipe = None
    del pipe, out
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    numbers = check(Reference(config, traffic, seed, device, noise, req), obs, outputs, checked)
    check_s = time.perf_counter() - t0
    lines = [
        f"{steps} steps in {window_s:.4f} s ({window_s / steps:.6f} s a step), set-up {setup_s:.4f} s",
        "set-up seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in setup_parts.items()),
        "step seconds: " + " ".join(f"{s:.4f}" for s in step_s),
        "launches in the window: " + ", ".join(f"{k} {v}" for k, v in counts.items() if v),
        "launches a DiT forward: " + ", ".join(f"{k} {v / steps:g}" for k, v in counts.items() if v),
        f"peak device memory in the window: {memory_peak} bytes",
        "checked steps: " + ", ".join(f"{k} {v}" for k, v in checked.items())
        + f"; the reference took {check_s:.1f} s",
    ]
    if view is not None:
        lines.append(f"traced: the call's start to the first DiT forward "
                     f"{(view.forwards[0]['start'] - view.call_start) / 1e3:.3f} ms")
    return {
        "attempted": steps,
        "numbers": numbers,
        "memory_peak_bytes": int(memory_peak),
        "end_to_end": {"setup_s": setup_s, "sample_step_s": window_s / steps},
        "view": view,
        "lines": lines,
        "checked_steps": checked,
    }
