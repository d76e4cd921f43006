"""The control at a size a test run holds: the reference put in the program's place with its products in
float8 comes out not correct under each cell's limits, while the program in bf16 at the same size is
correct, at three times its reading or more. (On the card at the cells' own sizes: ``benchmark.calibrate``;
readings in PERF.md.)"""

import pytest
import torch

import tiny
from benchmark import inputs, run
from benchmark.drivers import sample


def _readings(cell, seed):
    spec = tiny.tiny_spec(cell, "bfloat16")
    spec.config["transformer"].update(num_layers=4, attention_head_dim=64)
    cfg, traffic = spec.config, spec.traffic
    pipe = sample.build_pipeline(cfg, seed, "cpu")
    image, prompt, negative = inputs.request(seed, traffic, cfg["transformer"]["text_embed_dim"], "cpu", pipe.dtype)
    noise = inputs.SeededNoise(seed, "noise", "cpu")
    outputs = sample.PassOutputs(pipe.transformer)
    obs = sample.Observer(pipe, max_steps=1)
    pipe(image=image.numpy(), prompt_embeds=prompt, negative_prompt_embeds=negative, noise_source=noise,
         output_type="latent", step_observer=obs, **sample.call_kwargs(traffic))
    outputs.remove()
    ref = sample.Reference(cfg, traffic, seed, "cpu", noise, image, prompt, negative)
    x_ref, term, passes = ref.reference(0, ref.latents0)
    kind = sample.kind(traffic, 0)
    program = ref.numbers(kind, torch.from_numpy(obs.latents[0]), x_ref, term, outputs.outputs[0], passes)
    x_ctrl, _, passes_ctrl = ref.reference(0, ref.latents0, lowp=True)
    control = ref.numbers(kind, x_ctrl, x_ref, term, torch.cat(passes_ctrl), passes)
    limits = {k: v for k, v in spec.limits.items() if k.startswith(kind)}
    return program, control, limits, kind


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_fp8_control_is_not_correct_and_the_program_is(cell, seed):
    program, control, limits, kind = _readings(cell, seed)
    assert run.judge(program, limits)[0] is True
    assert run.judge(control, limits)[0] is False
    assert control[f"{kind}.l2"] >= 3 * program[f"{kind}.l2"]
    assert control[f"{kind}.pass_l2"] >= 3 * program[f"{kind}.pass_l2"]


def test_fp8_rounds_to_e4m3_with_an_absmax_scale():
    from benchmark.reference.dit import fp8

    x = torch.tensor([448.0, 1.0, -3.3, 0.0])
    assert fp8(x).tolist() == [448.0, 1.0, -3.25, 0.0]
    y = torch.tensor([[2.0, 1.1], [0.5, 0.0]])
    assert fp8(y, dim=-1)[0, 0] == 2.0 and fp8(y, dim=-1)[1, 0] == 0.5
