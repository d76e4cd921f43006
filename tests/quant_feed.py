"""Feeding a quantized model's linears what another run of the model gave its own.

Two runs of a W8A8 model agree only up to the activation codes that lie within an ulp of a rounding tie: a code
that rounds the other way moves its row of the linear's output by up to 1/127 of the input row's largest value
times a weight column, and the model carries that on. Such a flip happens between two implementations of the same
arithmetic (the JAX package's jitted run flips codes that its own op-by-op run, and the port, do not), and between
a model's own runs wherever the layers before a linear round differently. So a run is compared with each quantized
linear given the input and the output that the other run's linear got and gave, and checked on every call:

* the linear's own input lies within ``RTOL`` (of the fed input's largest value) of the fed input: with every
  linear's output fed, the two differ by the rounding of the layers since the last linear, so the norms,
  attention and activations between the linears are held;
* the linear's product on the fed input gives the fed output within ``RTOL`` on all but the rows that a flip
  moved, and those stay below ``MAX_FLIP_SHARE`` of the rows;
* at the end, the codes of the linears' own inputs that round the other way from the fed inputs' stay below
  ``MAX_FLIP_SHARE`` of the codes, and every recorded call was fed.

The patch is on ``alg_tpu_torch.ops.quant.quantized_linear``, which ``QuantizedLinear.forward`` calls (an attached
adapter adds its term after it, on the module's own input); calls are matched by the weight's codes.

Imports neither JAX nor the JAX package: the CPU tests (``torch_port_common.QuantTeacher`` records the JAX
package's calls into it), the on-card tests and ``chip_smoke.py`` share it."""

import contextlib

import numpy as np
import torch

# how far a linear's own input (and its product's rows) may lie from the fed ones, over their largest value
RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}
MAX_FLIP_SHARE = 1e-3  # the most of the codes, and of the output rows, that may round the other way


class _Fed(torch.autograd.Function):
    """``want``'s values exactly, with ``x``'s gradient: a QLoRA step differentiates through the fed values."""

    @staticmethod
    def forward(ctx, x, want):
        return want

    @staticmethod
    def backward(ctx, g):
        return g, None


def weight_key(weight: torch.Tensor):
    """A quantized linear's key: its int8 or packed int4 codes in the JAX package's ``[in, out]`` layout, the
    key its ``kernel_q`` or ``kernel_q4`` leaf gets from :func:`kernel_key`."""
    return kernel_key(weight.t().detach().cpu().numpy())


def kernel_key(kernel_in_out: np.ndarray):
    return kernel_in_out.shape, np.ascontiguousarray(kernel_in_out).tobytes()


def _rel(a: torch.Tensor, b: torch.Tensor, dims=None) -> torch.Tensor:
    d = (a.float() - b.float()).abs()
    d = d.amax() if dims is None else d.amax(dims)
    return d / b.float().abs().amax().clamp_min(1e-30)


class QuantFeed:
    """Records a run's quantized linear calls (``recording``), input and output, by weight and in call order,
    and feeds them to another run's calls of the same weights (``feeding``), checking each as the module
    docstring says."""

    def __init__(self):
        self.calls = {}
        self.recorded = self.fed = 0
        self.flipped = self.codes = 0  # the own inputs' codes that round the other way, of all
        self.moved = self.rows = 0  # the product's rows beyond RTOL of the fed output, of all
        self.worst = 0.0  # the largest max|own input - fed input| / max|fed input|

    def put(self, key, x, y) -> None:
        self.calls.setdefault(key, []).append((x, y))
        self.recorded += 1

    @contextlib.contextmanager
    def _patched(self, fn):
        from alg_tpu_torch.ops import quant

        original = quant.quantized_linear
        quant.quantized_linear = lambda x, weight, *rest: fn(original, x, weight, *rest)
        try:
            yield self
        finally:
            quant.quantized_linear = original

    def recording(self):
        """Inside the block, every quantized linear call is recorded."""

        def record(original, x, weight, *rest):
            y = original(x, weight, *rest)
            self.put(weight_key(weight), x.detach().clone(), y.detach().clone())
            return y

        return self._patched(record)

    def feeding(self):
        """Inside the block, every quantized linear call takes the next recorded input and gives the next
        recorded output of its weight, each checked against its own."""
        from alg_tpu_torch.ops.quant import quantize_rows

        def feed(original, x, weight, *rest):
            want_x, want_y = (torch.as_tensor(t).to(x.device, x.dtype) for t in self.calls[weight_key(weight)].pop(0))
            if want_x.shape != x.shape:
                raise AssertionError(f"fed {tuple(want_x.shape)} for {tuple(x.shape)}")
            tol = RTOL[x.dtype]
            y = original(_Fed.apply(x, want_x), weight, *rest)
            with torch.no_grad():
                rel = float(_rel(x, want_x))
                self.worst = max(self.worst, rel)
                if not rel <= tol:
                    raise AssertionError(f"a quantized linear's own input {tuple(x.shape)} lies {rel:.3e} (of the "
                                         f"fed input's largest value) from the fed one, above {tol:.0e} for {x.dtype}")
                self.flipped += int((quantize_rows(x)[0] != quantize_rows(want_x)[0]).sum())
                self.codes += x.numel()
                self.moved += int((_rel(y, want_y, -1) > tol).sum())
                self.rows += y.numel() // y.shape[-1]
            self.fed += 1
            return _Fed.apply(y, want_y)

        return self._patched(feed)

    def report(self) -> str:
        return (f"{self.fed} calls fed, own inputs at most {self.worst:.2e} from the fed ones, {self.flipped} of "
                f"{self.codes} of their codes round the other way, {self.moved} of {self.rows} rows of the product "
                f"on the fed input beyond RTOL of the fed output")

    def check(self) -> None:
        """Every recorded call was fed, and flips stayed below ``MAX_FLIP_SHARE``."""
        left = sum(len(v) for v in self.calls.values())
        if not (self.fed == self.recorded > 0 and left == 0):
            raise AssertionError(f"{self.recorded} calls recorded, {self.fed} fed, {left} left")
        if self.flipped > MAX_FLIP_SHARE * self.codes or self.moved > MAX_FLIP_SHARE * self.rows:
            raise AssertionError(f"above {MAX_FLIP_SHARE:.0e}: {self.report()}")


# One QLoRA step card against CPU: AdamW at eps 1e-4, rank 4, remat. Adam's first step moves an element by
# lr·g/(|g| + eps), which turns the fp32 summation noise of a gradient near eps into up to lr/(4·eps) times that
# noise in the adapter. So the gradients are held at a relative bound, and the step at atol 1e-5 against the CPU's
# optimizer applied to the card's gradients; the adapters' distance from the CPU's own step is reported beside the
# gradient of the element that moved most.
QLORA_TRAIN = dict(learning_rate=1e-2, weight_decay=0.01, grad_clip=1.0, eps=1e-4, remat=True)
LOSS_RTOL, GRAD_RTOL, STEP_ATOL = 1e-5, 1e-4, 1e-5


def qlora_step_agreement(device, mode: str = "w8", seed: int = 4) -> dict:
    """One QLoRA step over a small CogVideoX DiT (head dim 64, 2 layers, block linears of 128 and 512) quantized
    in place, on ``device`` against the CPU in fp32 with TF32 off, ``device``'s quantized linears fed the CPU
    run's calls (:class:`QuantFeed`). Returns the numbers, ``ok`` and a ``line`` that reports them."""
    import copy

    from alg_tpu_torch.models import layers as L
    from alg_tpu_torch.models.cogvideox.transformer import (CogVideoXTransformer, CogVideoXTransformerConfig,
                                                            cogvideox_rope)
    from alg_tpu_torch.ops.quant import quantize_transformer_
    from alg_tpu_torch.training.lora import init_lora_params, lora_base, make_lora_loss
    from alg_tpu_torch.training.losses import make_cogvideox_vpred_loss
    from alg_tpu_torch.training.train import (TrainConfig, make_optimizer, make_train_step, tree_leaves, tree_map,
                                              tree_unflatten)

    cfg = CogVideoXTransformerConfig(num_attention_heads=2, attention_head_dim=64, in_channels=8, out_channels=4,
                                     time_embed_dim=32, text_embed_dim=64, num_layers=2, sample_height=8,
                                     sample_width=8, max_text_seq_length=8)
    tc = TrainConfig(**QLORA_TRAIN)
    gen = torch.Generator("cpu").manual_seed(seed)
    model = quantize_transformer_(L.init_random_(CogVideoXTransformer(cfg), gen).requires_grad_(False), mode)
    loras0 = init_lora_params(gen, lora_base(model), rank=4, prefixes=("blocks",))
    for leaf in tree_leaves(loras0):  # B off zero, so that A's gradient is not zero
        leaf.add_(0.05 * torch.randn(leaf.shape, generator=gen))
    cos, sin = cogvideox_rope(cfg, 64, 64, 3)
    batch = {"latents": torch.randn((2, 3, 4, 8, 8), generator=gen),
             "image_latents": torch.randn((2, 3, 4, 8, 8), generator=gen),
             "encoder_hidden_states": torch.randn((2, 8, 64), generator=gen)}
    draw = {"t": torch.randint(0, 1000, (2,), generator=gen), "noise": torch.randn((2, 3, 4, 8, 8), generator=gen)}
    feed, runs = QuantFeed(), []
    for dev, fed in (("cpu", feed.recording), (device, feed.feeding)):
        dit = copy.deepcopy(model).to(dev)
        hooks = []
        base = lora_base(dit)
        loras = tree_map(lambda t: t.clone().to(dev).requires_grad_(), loras0)
        grads = [None] * len(tree_leaves(loras))
        for i, leaf in enumerate(tree_leaves(loras)):  # the gradients the optimizer is given, before clipping
            hooks.append(leaf.register_hook(lambda g, i=i: grads.__setitem__(i, g.detach().cpu())))
        step, opt = make_train_step(make_lora_loss(make_cogvideox_vpred_loss(dit, rope_cos=cos, rope_sin=sin),
                                                   base, scale=2.0), tc)
        with fed():
            loras, _, m = step(loras, opt.init(loras), {k: v.to(dev) for k, v in batch.items()},
                               {k: v.to(dev) for k, v in draw.items()})
        for h in hooks:
            h.remove()
        if any(t.grad is not None for t in base.values()):
            raise AssertionError("the quantized base took a gradient")
        runs.append((float(m["loss"]), grads, [leaf.detach().cpu() for leaf in tree_leaves(loras)]))
    feed.check()
    (l_c, g_c, p_c), (l_d, g_d, p_d) = runs
    # the CPU's optimizer on the device's gradients: what the device's step must give
    opt = make_optimizer(tc)
    start = tree_map(lambda t: t.clone(), loras0)
    updates, _ = opt.update(tree_unflatten(start, g_d), opt.init(start), start)
    replay = [p + u for p, u in zip(tree_leaves(start), tree_leaves(updates))]
    out = {"loss": (l_d, l_c), "loss_rel": abs(l_d - l_c) / abs(l_c),
           "grad_rel": max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_d, g_c)),
           "step_err": max(float((a - b).abs().max()) for a, b in zip(p_d, replay)), "feed": feed.report()}
    i, diff = max(enumerate(p_d[k] - p_c[k] for k in range(len(p_c))), key=lambda kv: float(kv[1].abs().max()))
    at = int(diff.abs().argmax())
    out["run_err"] = float(diff.abs().flatten()[at])
    out["run_err_grad"] = (float(g_d[i].flatten()[at]), float(g_c[i].flatten()[at]))
    out["ok"] = out["loss_rel"] <= LOSS_RTOL and out["grad_rel"] <= GRAD_RTOL and out["step_err"] <= STEP_ATOL
    out["line"] = (f"{mode} lr {tc.learning_rate:g}, eps {tc.eps:g}: loss {l_d:.6f} vs {l_c:.6f}, rel diff "
                   f"{out['loss_rel']:.3e} (rtol {LOSS_RTOL:g}); gradients max|diff| {out['grad_rel']:.3e} of the "
                   f"leaf's largest (rtol {GRAD_RTOL:g}); the step against the CPU's optimizer on the same gradients "
                   f"max|diff| {out['step_err']:.3e} (atol {STEP_ATOL:g}); adapters against the CPU's step max|diff| "
                   f"{out['run_err']:.3e}, at an element whose gradient is {out['run_err_grad'][0]:.3e} here and "
                   f"{out['run_err_grad'][1]:.3e} on the CPU; {feed.report()}")
    return out
