"""Traffic driver ``sample``: one image-to-video request through ``CogVideoXPipeline.__call__``.

Set-up builds the DiT and the VAE on the device, copies into them weights the
benchmark draws from the seed (through the program's checkpoint name map), and
warms up with a short call at the traffic's ``warmup`` size. The window is
one call at the traffic's generation settings with ``output_type="latent"``:
a ``step_observer`` notes the time and the latents after each step, and once
``seconds`` have passed since the call it sets the pipeline's ``interrupt``
flag, so the step that is running then is finished and counted, and the loop
returns. ``sample_step_s`` is the window's wall time, from the call to the
end of its last step, over the steps completed. A forward hook on the DiT
keeps each forward's output (its CFG passes, as the DiT returned them) on the
device; no copy or synchronise is added to the step.

After the window, with the program freed, the plain reference recomputes
sampled steps from the latents the program held before each (the first step
from the initial noise) and judges, at each, every CFG pass's DiT output and
the latents the program produced: one 3-pass (ALG) step and one 2-pass step,
each drawn from the seed among the window's steps of its kind.

Under ``--trace 1`` the window also holds a range around the call, one around
each DiT forward (opened and closed after a synchronise) and one at the end of
each step, which the per-layer readers find in :class:`View`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from benchmark import flops, inputs
from benchmark.reference import sampler as ref_sampler
from benchmark.weights import cogvideox_transformer_spec, cogvideox_vae_spec, derive_seed, make_weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CALL_RANGE = "benchmark.call"
DIT_RANGE = "benchmark.dit_forward"
STEP_END_RANGE = "benchmark.step_end"


def _dataclass(cls, values: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in values.items() if k in names})


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_pipeline(config: dict, seed: int, device):
    """The program's pipeline, with the seed's weights, as the configuration states it."""
    from alg_tpu_torch.io import weights as W
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer, CogVideoXTransformerConfig
    from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE, CogVideoXVAEConfig
    from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline
    from alg_tpu_torch.schedulers.ddim_cogvideox import CogVideoXDDIMConfig

    dit_dtype, vae_dtype = DTYPES[config["dtypes"]["transformer"]], DTYPES[config["dtypes"]["vae"]]
    tcfg = _dataclass(CogVideoXTransformerConfig, config["transformer"])
    vcfg = _dataclass(CogVideoXVAEConfig, config["vae"])
    state = make_weights(cogvideox_transformer_spec(config["transformer"]), derive_seed(seed, "dit"), device,
                         dit_dtype)
    dit = CogVideoXTransformer(tcfg, device="meta", dtype=dit_dtype).to_empty(device=device)
    W.load_tree(dit, W.convert_cogvideox_transformer(state, tcfg))
    del state
    state = make_weights(cogvideox_vae_spec(config["vae"]), derive_seed(seed, "vae"), device, vae_dtype)
    vae = CogVideoXVAE(vcfg, device="meta", dtype=vae_dtype).to_empty(device=device)
    W.load_tree(vae, W.convert_cogvideox_vae(state, vcfg))
    del state
    dit.requires_grad_(False)
    vae.requires_grad_(False)
    return CogVideoXPipeline(transformer=dit, vae=vae, scheduler="ddim",
                             scheduler_cfg=_dataclass(CogVideoXDDIMConfig, config["scheduler"]), dtype=dit_dtype,
                             device=device)


def call_kwargs(traffic: dict) -> dict:
    """The pipeline's generation arguments from a traffic file."""
    kw = {k: traffic[k] for k in ("height", "width", "num_frames", "num_inference_steps", "guidance_scale", "eta")}
    kw.update(traffic.get("alg", {}))
    return kw


def kind(traffic: dict, i: int) -> str:
    """``alg_step`` for a step with ALG's 3 passes, else ``cfg_step``."""
    strength = ref_sampler.lp_strength(i, traffic["num_inference_steps"], traffic.get("alg", {}))
    return "alg_step" if strength != 0.0 else "cfg_step"


class Observer:
    """``step_observer``: the time and latents after each step; sets ``interrupt`` once ``seconds``
    have passed since ``start`` (or after ``max_steps`` steps). ``mark()``, if given, runs at each
    step's end."""

    def __init__(self, pipe, seconds: float = float("inf"), max_steps: Optional[int] = None, mark=None):
        self.pipe, self.seconds, self.max_steps, self.mark = pipe, seconds, max_steps, mark
        self.start = time.perf_counter()
        self.times, self.latents = [], []

    def __call__(self, i, latents):
        now = time.perf_counter()
        if self.mark is not None:
            self.mark()
        self.times.append(now)
        self.latents.append(latents)
        if now - self.start >= self.seconds or (self.max_steps is not None and i + 1 >= self.max_steps):
            self.pipe.interrupt = True


class PassOutputs:
    """A forward hook on the DiT that keeps each forward's output, ``[passes, F, C, h, w]``, as
    returned (a reference to the tensor, no copy)."""

    def __init__(self, dit):
        self.outputs = []
        self.handle = dit.register_forward_hook(lambda module, args, out: self.outputs.append(out.detach()))

    def remove(self):
        self.handle.remove()


class DitSpans:
    """Each DiT forward between two synchronises, inside a ``record_function`` range: its passes
    (batch rows), text tokens and latent shape. Only in a traced run."""

    def __init__(self, dit, device):
        from torch.profiler import record_function

        self.device, self.record_function = device, record_function
        self.forwards, self._range = [], None
        self.handles = [dit.register_forward_pre_hook(self._pre), dit.register_forward_hook(self._post)]

    def _pre(self, module, args):
        _sync(self.device)
        x, text = args[0], args[1]
        self.forwards.append({"passes": x.shape[0], "s_text": text.shape[1], "frames": x.shape[1],
                              "h": x.shape[3], "w": x.shape[4]})
        self._range = self.record_function(DIT_RANGE)
        self._range.__enter__()

    def _post(self, module, args, out):
        _sync(self.device)
        self._range.__exit__(None, None, None)

    def step_end(self):
        with self.record_function(STEP_END_RANGE):
            pass

    def remove(self):
        for h in self.handles:
            h.remove()


@dataclasses.dataclass
class View:
    """What a per-layer metric's reader gets from a traced run; times in microseconds on the trace's clock."""

    trace: object  # benchmark.trace.Trace
    forwards: list  # each DiT forward: passes, s_text, s_video, start, end, seconds
    call_start: float  # the pipeline call's range
    step_ends: list  # each step's end, after its latents reached the host
    steps: int
    dit_cfg: dict


def _ranges(trace, name):
    return sorted((a, b) for a, b, n in trace.ranges if n == name)


def view_of(trace, forwards: list, steps: int, dit_cfg: dict) -> View:
    dits, calls, ends = _ranges(trace, DIT_RANGE), _ranges(trace, CALL_RANGE), _ranges(trace, STEP_END_RANGE)
    if len(dits) != len(forwards) or len(calls) != 1 or len(ends) != steps:
        raise RuntimeError(f"the trace holds {len(dits)} DiT ranges, {len(calls)} calls and {len(ends)} step ends "
                           f"for {len(forwards)} forwards in {steps} steps")
    rows = [{**f, "s_video": flops.dit_tokens(dit_cfg, f["frames"], f["h"], f["w"]), "start": a, "end": b,
             "seconds": (b - a) / 1e6} for f, (a, b) in zip(forwards, dits)]
    return View(trace=trace, forwards=rows, call_start=calls[0][0], step_ends=[b for _, b in ends], steps=steps,
                dit_cfg=dit_cfg)


def launch_counts() -> dict:
    """The port's launch counters of the kernels the window drives."""
    from alg_tpu_torch.ops.flash_attention import flash_attention
    from alg_tpu_torch.ops.flash_attention_int8 import flash_attention_int8
    from alg_tpu_torch.ops.qk_prep import qk_norm_rope

    out = {"qk_prep": qk_norm_rope.launches, "flash_attention": flash_attention.launches,
           "flash_attention_int8": flash_attention_int8.launches}
    out.update({f"flash_attention_{k}": v for k, v in flash_attention.launches_by_route.items()})
    return out


def window(pipe, kw: dict, seconds: float, noise, image, prompt, negative, device, trace: bool):
    """One call of the pipeline, interrupted after ``seconds``.
    Returns (observer, latents, each forward's output, (trace, forwards) or None)."""
    from benchmark import trace as tr

    outputs = PassOutputs(pipe.transformer)
    spans = DitSpans(pipe.transformer, device) if trace else None
    image_np = image.cpu().numpy()
    with contextlib.ExitStack() as stack:
        box = stack.enter_context(tr.profiled(lambda: _sync(device))) if trace else None
        obs = Observer(pipe, seconds, mark=spans.step_end if trace else None)
        if trace:
            stack.enter_context(spans.record_function(CALL_RANGE))
        out = pipe(image=image_np, prompt_embeds=prompt, negative_prompt_embeds=negative, noise_source=noise,
                   output_type="latent", step_observer=obs, **kw)
        _sync(device)
    outputs.remove()
    if trace:
        spans.remove()
    return obs, out, outputs.outputs, (box[0], spans.forwards) if trace else None


class Reference:
    """The plain reference of one run: the seed's weights made again, the condition from the same
    image and posterior noise, and :meth:`judge` for a step the program took."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, noise, image, prompt, negative):
        from benchmark.reference import strict_fp32

        strict_fp32()
        self.config, self.traffic = config, traffic
        tc, vc = config["transformer"], config["vae"]
        vae_w = make_weights(cogvideox_vae_spec(vc), derive_seed(seed, "vae"), device, DTYPES[config["dtypes"]["vae"]])
        eps, self.latents0 = noise.draws[0], noise.draws[1]
        frames = ref_sampler.latent_frames(traffic["num_frames"], vc, tc)
        if self.latents0.shape[1] != frames:
            raise RuntimeError(f"the program's initial latents hold {self.latents0.shape[1]} frames, not {frames}")
        self.cond = ref_sampler.image_latents(vae_w, vc, image, eps, frames)
        del vae_w
        self.dit_w = make_weights(cogvideox_transformer_spec(tc), derive_seed(seed, "dit"), device,
                                  DTYPES[config["dtypes"]["transformer"]])
        self.prompt, self.negative, self.device = prompt.float(), negative.float(), device

    def reference(self, i: int, x_in: torch.Tensor, lowp: bool = False):
        """(the reference's latents after step ``i`` from ``x_in``, the model term ``b_t·sqrt(1 - ā_t)·v``,
        each CFG pass's DiT output). ``lowp``: the control, the reference with its products in float8."""
        x_ref, v, coef, passes = ref_sampler.step(self.dit_w, self.config["transformer"], self.config["scheduler"],
                                                  self.traffic, i, x_in.float(), self.cond, self.negative,
                                                  self.prompt, lowp=lowp)
        return x_ref, abs(coef) * v, passes

    @staticmethod
    def numbers(kind: str, x_out: torch.Tensor, x_ref: torch.Tensor, term: torch.Tensor, passes_out: torch.Tensor,
                passes_ref: list) -> dict:
        """``l2``: the norm of the step's departure from the reference over the norm of the model
        term; ``max``: its largest element over the model term's root mean square. ``pass_l2``,
        ``pass_max``: the same of each CFG pass's DiT output against the reference's, over that
        pass's own norm and root mean square, the worst pass."""
        diff = x_out.float() - x_ref
        out = {f"{kind}.l2": float(diff.norm() / term.norm()),
               f"{kind}.max": float(diff.abs().max() / term.pow(2).mean().sqrt())}
        if passes_out.shape[0] != len(passes_ref):
            raise RuntimeError(f"the program's DiT ran {passes_out.shape[0]} passes, the reference {len(passes_ref)}")
        l2 = mx = 0.0
        for o, r in zip(passes_out, passes_ref):
            d = o.float() - r[0]
            l2 = max(l2, float(d.norm() / r.norm()))
            mx = max(mx, float(d.abs().max() / r.pow(2).mean().sqrt()))
        out.update({f"{kind}.pass_l2": l2, f"{kind}.pass_max": mx})
        return out

    def judge(self, i: int, x_in: torch.Tensor, x_out: torch.Tensor, passes_out: torch.Tensor) -> dict:
        x_ref, term, passes = self.reference(i, x_in)
        return self.numbers(kind(self.traffic, i), x_out.to(self.device), x_ref, term, passes_out.to(self.device),
                            passes)


def sampled_steps(traffic: dict, done: int, seed: int) -> dict:
    """{kind: step}: one step of each kind among the ``done`` steps of the window, drawn from the seed."""
    rng = np.random.default_rng(derive_seed(seed, "check"))
    out = {}
    for k in ("alg_step", "cfg_step"):
        group = [i for i in range(done) if kind(traffic, i) == k]
        if group:
            out[k] = int(group[rng.integers(len(group))])
    return out


def check(ref: Reference, obs, outputs: dict) -> dict:
    """The numbers of the sampled steps ``outputs`` ({step: its DiT output}), judged against the reference."""
    numbers = {}
    for i, passes_out in sorted(outputs.items()):
        x_in = ref.latents0 if i == 0 else torch.from_numpy(obs.latents[i - 1])
        numbers.update(ref.judge(i, x_in.to(ref.device), torch.from_numpy(obs.latents[i]), passes_out))
    return numbers


def run(cell) -> dict:
    device, seed, traffic, config = cell.device, cell.seed, cell.traffic, cell.config
    marks = [("imports", time.time())]
    pipe = build_pipeline(config, seed, device)
    image, prompt, negative = inputs.request(seed, traffic, config["transformer"]["text_embed_dim"], device,
                                             pipe.dtype)
    kw = call_kwargs(traffic)
    _sync(device)
    marks.append(("weights and modules", time.time()))

    warm = traffic["warmup"]
    warm_obs = Observer(pipe, max_steps=warm["steps"])
    pipe(image=image.cpu().numpy(), prompt_embeds=prompt, negative_prompt_embeds=negative,
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
    obs, out, outputs, traced = window(pipe, kw, cell.seconds, noise, image, prompt, negative, device, cell.trace)
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
    outputs = {i: outputs[i] for i in checked.values()}
    view = view_of(traced[0], traced[1], steps, dict(config["transformer"])) if traced else None
    obs.pipe = warm_obs.pipe = None
    del pipe, out
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    numbers = check(Reference(config, traffic, seed, device, noise, image, prompt, negative), obs, outputs)
    check_s = time.perf_counter() - t0
    lines = [
        f"{steps} steps in {window_s:.4f} s ({window_s / steps:.6f} s a step), set-up {setup_s:.4f} s",
        "set-up seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in setup_parts.items()),
        "step seconds: " + " ".join(f"{s:.4f}" for s in step_s),
        "launches in the window: " + ", ".join(f"{k} {v}" for k, v in counts.items() if v),
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
