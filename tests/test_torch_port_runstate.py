"""The port's resumable-run snapshots (``alg_tpu_torch/io/runstate.py``)
against ``alg_tpu.io.runstate``: the same fingerprint for the same
arguments, a round trip of each family's carry (nested tuples, the UniPC
NamedTuple) bit for bit, the cases that start fresh with a warning (another
fingerprint, another shape or dtype or leaf count, a truncated file), the
``maybe_save`` interval, ``complete``, a temporary name that no ``*`` sweep
matches, and a snapshot ``alg_tpu`` reads back as its own."""

import glob
import logging
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alg_tpu.io import runstate as JR

from alg_tpu_torch.io import runstate as TR
from alg_tpu_torch.schedulers.unipc import UniPCState

from torch_port_common import one_thread


ARGS = [
    dict(prompt="a cat", negative_prompt="", seed=42, height=480, width=720, num_frames=49, num_inference_steps=50,
         guidance_scale=6.0, use_dynamic_cfg=False, eta=0.0, timesteps=None, scheduler="ddim",
         alg=(True, "down_up", True, 3.0, 0.1, 0.25, "interval", False, 0.0, 0.04, 1.0, 0.0, 1.0, 5.0)),
    dict(prompt=["a", "b"], seed=7, sigmas=(1.0, 0.5, 0.25), cache_interval=2, has_last_image=True),
    dict(),
]


@pytest.mark.parametrize("kind", ["cogvideox", "wan", "hunyuan"])
@pytest.mark.parametrize("i", range(len(ARGS)), ids=["cogvideox-args", "lists-and-tuples", "no-args"])
def test_fingerprint_matches_alg_tpu(kind, i):
    assert TR.run_fingerprint(kind, **ARGS[i]) == JR.run_fingerprint(kind, **ARGS[i])
    assert TR.run_fingerprint(kind, **ARGS[i]) != TR.run_fingerprint(kind, **{**ARGS[i], "seed": -1})


def _carries():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    return {
        "cogvideox": (r(1, 2, 4, 3, 3), r(1, 2, 4, 3, 3)),
        "cogvideox-cache": (r(1, 2, 4, 3, 3), r(1, 2, 4, 3, 3), r(1, 2, 4, 3, 3)),
        "wan": (r(1, 4, 2, 3, 3), UniPCState(m=(r(1, 4, 2, 3, 3), r(1, 4, 2, 3, 3)), last_sample=r(1, 4, 2, 3, 3))),
        "hunyuan": (r(1, 4, 2, 3, 3),),
    }


@pytest.mark.parametrize("family", list(_carries()))
def test_round_trip(tmp_path, family):
    carry = _carries()[family]
    path = str(tmp_path / "run.npz")
    TR.RunCheckpoint(path, "fp").save(5, carry)
    template = TR.unflatten(carry, [torch.zeros_like(t) for t in TR.flatten(carry)])
    step, restored = TR.RunCheckpoint(path, "fp").restore(template)
    assert step == 5 and type(restored) is type(carry)
    if family == "wan":
        assert isinstance(restored[1], UniPCState)
    assert all(torch.equal(a, b) for a, b in zip(TR.flatten(restored), TR.flatten(carry)))


def test_alg_tpu_reads_the_ports_snapshot(tmp_path):
    """Same file layout and leaf order: ``alg_tpu`` restores the port's Wan
    snapshot into its own carry (jax arrays, the same NamedTuple layout)."""
    from alg_tpu.schedulers.unipc import UniPCState as JState

    carry = _carries()["wan"]
    path = str(tmp_path / "run.npz")
    TR.RunCheckpoint(path, "fp").save(3, carry)
    template = (jnp.zeros((1, 4, 2, 3, 3)), JState(m=(jnp.zeros((1, 4, 2, 3, 3)),) * 2,
                                                   last_sample=jnp.zeros((1, 4, 2, 3, 3))))
    step, restored = JR.RunCheckpoint(path, "fp").restore(template)
    assert step == 3
    np.testing.assert_array_equal(np.asarray(restored[1].m[1]), carry[1].m[1].numpy())
    np.testing.assert_array_equal(np.asarray(restored[1].last_sample), carry[1].last_sample.numpy())


@pytest.mark.parametrize("case", ["fingerprint", "shape", "dtype", "leaf-count", "truncated", "missing"])
def test_mismatches_start_fresh(tmp_path, caplog, case):
    carry = _carries()["cogvideox"]
    path = str(tmp_path / "run.npz")
    TR.RunCheckpoint(path, "fp").save(2, carry)
    template, fp = carry, "fp"
    if case == "fingerprint":
        fp = "other"
    elif case == "shape":
        template = (torch.zeros(1, 2, 4, 3, 4), carry[1])
    elif case == "dtype":
        template = (carry[0].double(), carry[1])
    elif case == "leaf-count":
        template = carry + (carry[0],)
    elif case == "truncated":
        with open(path, "r+b") as f:
            f.truncate(100)
    else:
        os.remove(path)
    with caplog.at_level(logging.WARNING, logger=TR.__name__):
        step, out = TR.RunCheckpoint(path, fp).restore(template)
    assert step == 0 and out is template
    assert (case == "missing") == (not caplog.records)


def test_maybe_save_interval_and_complete(tmp_path):
    """Saved at the first call and then once ``every`` steps have passed
    since the last save; ``complete`` removes the file, ``keep`` keeps it;
    a save leaves nothing else in the directory."""
    carry = _carries()["hunyuan"]
    path = str(tmp_path / "run.npz")
    ck = TR.RunCheckpoint(path, "fp", every=3)
    saved = []
    for step in range(1, 9):
        ck.maybe_save(step, carry)
        with np.load(path) as z:
            saved.append(int(z["step"]))
    assert saved == [1, 1, 1, 4, 4, 4, 7, 7]
    assert os.listdir(tmp_path) == ["run.npz"]
    ck.complete()
    assert not os.path.exists(path)
    ck.complete()  # a second call finds nothing to remove
    kept = TR.RunCheckpoint(path, "fp", keep=True)
    kept.save(1, carry)
    kept.complete()
    assert os.path.exists(path)


def test_temporary_name_is_hidden_and_unique(tmp_path, monkeypatch):
    """The file written before the rename starts with a dot (no ``*`` glob
    matches it) and is unique to the writer."""
    seen = []
    replace = os.replace

    def spy(src, dst):
        seen.append(src)
        assert glob.glob(os.path.join(str(tmp_path), "*")) in ([], [dst])
        return replace(src, dst)

    monkeypatch.setattr(TR.os, "replace", spy)
    ck = TR.RunCheckpoint(str(tmp_path / "run.npz"), "fp")
    ck.save(1, _carries()["hunyuan"])
    ck.save(2, _carries()["hunyuan"])
    assert len(seen) == 2 and seen[0] != seen[1]
    assert all(os.path.basename(p).startswith(".run.npz.") for p in seen)


def test_as_checkpoint():
    assert TR.as_checkpoint(None, "fp", 8) is None
    ck = TR.as_checkpoint("x.npz", "fp", 4)
    assert (ck.path, ck.fingerprint, ck.every) == ("x.npz", "fp", 4)
    given = TR.RunCheckpoint("y.npz")
    assert TR.as_checkpoint(given, "fp", 4) is given and given.fingerprint == "fp"
