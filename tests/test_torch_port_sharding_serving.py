"""The port's sharded serving on the CPU: ``serve_batch`` over a mesh of
gloo ranks (``torch_dist_workers``) for the three families on the tiny
checkpoints of ``test_torch_port_serving``, multi-host serving in two
processes, and the tiled decode spread over ranks.

The sharded run is held to the port's unsharded one within ``alg_tpu``'s
3e-5 (its sharded-against-single serving tolerance), and to ``alg_tpu``'s
sharded ``serve_batch`` over the same layout within the port's serving
tolerance against ``alg_tpu`` (final latents within 2e-3;
``test_torch_port_serving.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_workers as W
from test_torch_port_serving import ck, _requests  # noqa: F401
from torch_port_common import one_thread  # noqa: F401

def test_tiled_decode_spreads_tiles_over_the_model_group(tmp_path):
    """A 13 x 21 latent in 8-tiles at stride 6 (interior, right, bottom and
    corner shapes): spread over the ranks that hold the same latents it
    equals the sequential decode bit for bit, each rank decoding its share,
    and equals ``alg_tpu``'s mesh-sharded tiled decode of the same toy
    decoder."""
    from alg_tpu.models.vae_tiling import tiled_decode
    from alg_tpu.sharding import make_mesh

    z = np.random.RandomState(1).randn(1, 2, 13, 21, 4).astype(np.float32)
    ranks = W.Ranks(W.decode_spread, 4, tmp_path, z, (2, 1, 2, 1))

    def decode_fn(t):
        up = jnp.repeat(jnp.repeat(t, 2, axis=2), 2, axis=3)
        return jnp.broadcast_to(jnp.tanh(up.sum(-1, keepdims=True)), up.shape[:-1] + (3,))

    mesh = make_mesh(dp=2, sp=2, devices=jax.local_devices(backend="cpu")[:4])
    ref = np.asarray(tiled_decode(decode_fn, jnp.asarray(z), 2, tile_latent=8, stride_latent=6, mesh=mesh))
    for spread, seq, mine, total in ranks.results():
        assert spread.shape == (1, 2, 26, 42, 3)
        np.testing.assert_array_equal(spread, seq)
        assert total == 12 and mine == 6  # 3 x 4 tiles, half on each rank of the sp pair
        np.testing.assert_allclose(spread, ref, atol=1e-6)


LAYOUTS = [("cogvideox", (2, 1, 1, 2), "gather"), ("wan", (1, 1, 2, 2), "ring"), ("hunyuan", (2, 1, 2, 1), "ulysses")]


@pytest.mark.parametrize("family,dims,sp_mode", LAYOUTS,
                         ids=[f"{f}-dp{d[0]}sp{d[2]}tp{d[3]}-{m}" for f, d, m in LAYOUTS])
def test_sharded_serve_batch_matches_unsharded_and_alg_tpu(tmp_path, ck, family, dims, sp_mode):
    """Two requests at their own seeds, dp-split when dp = 2 (each rank
    returns the whole batch), the DiT tensor- and sequence-parallel."""
    from alg_tpu import serving as JS
    from alg_tpu.sharding import make_mesh

    from alg_tpu_torch import serving as TS

    gen = ck.gen_kwargs(family, output_type="latent")
    ranks = W.Ranks(W.serve, int(np.prod(dims)), tmp_path, ck.config(family), _requests(TS), gen, dims, sp_mode)
    with torch.no_grad():
        single = TS.serve_batch(ck.pipe("port", family), _requests(TS), **gen)
    dp, pp, sp, tp = dims
    mesh = make_mesh(dp=dp, sp=sp, tp=tp, devices=jax.local_devices(backend="cpu")[:dp * sp * tp])
    with mesh:
        ref = np.asarray(JS.serve_batch(ck.pipe("jax", family), _requests(JS), mesh=mesh, sp_mode=sp_mode, **gen))
    for coords, out in ranks.results():
        np.testing.assert_allclose(out, np.asarray(single), atol=3e-5)
        np.testing.assert_allclose(out, ref, atol=2e-3)


def test_multihost_serves_each_hosts_block(tmp_path, ck):
    """Two processes, each a host of one rank: each serves its contiguous
    block of three requests (2 + 1) and gets what one process serving the
    three gets for them; the split of 5 and of 1 requests over 2 hosts."""
    from alg_tpu_torch import serving as TS

    gen = ck.gen_kwargs("cogvideox", output_type="latent")
    reqs = _requests(TS) + [TS.BatchRequest(prompt="a third", image=_requests(TS)[0].image, seed=3)]
    ranks = W.Ranks(W.serve_multihost, 2, tmp_path, ck.config("cogvideox"), reqs, gen)
    with torch.no_grad():
        single = np.asarray(TS.serve_batch(ck.pipe("port", "cogvideox"), reqs, **gen))
    (v0, i0, sizes0), (v1, i1, _) = ranks.results()
    assert (i0, i1) == ([0, 1], [2]) and sizes0 == [3, 1]
    np.testing.assert_allclose(np.concatenate([v0, v1]), single, atol=1e-5)


def test_http_batching_worker_leads_the_mesh(tmp_path, ck):
    """The daemon's worker on rank 0 of a dp2 mesh takes three requests as
    one micro-batch, pads it to four for dp and broadcasts it; rank 1
    follows the micro-batch and stops with the worker. The three videos are
    those of an unsharded ``serve_batch`` of the three."""
    from alg_tpu_torch import serving as TS

    gen = ck.gen_kwargs("cogvideox", output_type="latent")
    reqs = _requests(TS) + [TS.BatchRequest(prompt="a third", image=_requests(TS)[0].image, seed=3)]
    ranks = W.Ranks(W.http_mesh, 2, tmp_path, ck.config("cogvideox"), reqs, gen, (2, 1, 1, 1))
    with torch.no_grad():
        single = np.asarray(TS.serve_batch(ck.pipe("port", "cogvideox"), reqs, **gen))
    (errors, videos, batches), followed = ranks.results()
    assert errors == [None] * 3 and batches == [3] and followed == 1
    np.testing.assert_allclose(np.stack(videos), single, atol=1e-5)
