"""The harness's run, past its look for a card, with the timed path broken underneath: ``correct``
comes out false for each fault a cell can have. (The cells run on one card, so no exchange between
cards can be left out.)"""

import contextlib

import pytest
import torch

import tiny

CELLS = tiny.CELLS


@contextlib.contextmanager
def step_returns_its_state():
    """The DDIM update hands back the latents it was given."""
    import alg_tpu_torch.pipelines.cogvideox as pipe_mod

    real = pipe_mod.ddim_step
    pipe_mod.ddim_step = lambda plan, i, model_output, sample, noise=None: sample
    try:
        yield
    finally:
        pipe_mod.ddim_step = real


@contextlib.contextmanager
def half_the_batch_left_out():
    """The DiT runs the first half of its batch (its CFG passes) and gives every row the mean of those."""
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer

    real = CogVideoXTransformer.forward

    def forward(self, x, text, t, *args, **kwargs):
        k = max(1, x.shape[0] // 2)
        out = real(self, x[:k], text[:k], t[:k], *args, **kwargs)
        return out.mean(0, keepdim=True).expand(x.shape[0], *out.shape[1:]).contiguous()

    CogVideoXTransformer.forward = forward
    try:
        yield
    finally:
        CogVideoXTransformer.forward = real


@contextlib.contextmanager
def answer_altered():
    """Each step's latents leave the update with one element moved by 1."""
    import alg_tpu_torch.pipelines.cogvideox as pipe_mod

    real = pipe_mod.ddim_step

    def step(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out.view(-1)[out.numel() // 3] += 1.0
        return out

    pipe_mod.ddim_step = step
    try:
        yield
    finally:
        pipe_mod.ddim_step = real


FAULTS = {"step_returns_its_state": step_returns_its_state, "half_the_batch_left_out": half_the_batch_left_out,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with FAULTS[fault]():
        out = tiny.run_tiny(cell, seed=5, seconds=0.2)
    result = out["result"]
    assert result["correct"] is False and result["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_same_run_unbroken_is_correct(cell):
    out = tiny.run_tiny(cell, seed=5, seconds=0.2)
    assert out["result"]["correct"] is True
    assert torch.get_default_dtype() == torch.float32
