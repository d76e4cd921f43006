"""The port's W8A8 / W4A8 linears (``alg_tpu_torch/ops/quant.py``,
``models.layers.QuantizedLinear``) against ``alg_tpu/ops/quant.py`` on the
CPU, with the same seeded numpy inputs:

* the W8 and W4 quantizers and ``w4_to_int8``: codes and scales bit-equal,
  fp32 and bf16 input, stacked and not;
* ``QuantizedLinear`` against ``quantized_linear``: the int32 accumulators
  bit-equal, the output within 1e-6 of the largest value, ``dx`` against
  ``jax.grad`` through the custom VJP;
* tree quantization: the quantized modules are the quantized leaves, per
  family, with ``modulation`` on and off, w4's int8 fallback included, and
  their codes and scales bit-equal;
* a quantized DiT forward of each family from a JAX tree carried over within
  atol 2e-3, a quantized CogVideoX pipeline above 40 dB;
* ``cli.run --quantize``, ``serve_batch`` and ``serve_cli.run`` against
  ``alg_tpu``'s on small checkpoints whose block linears are wide enough to
  quantize (in and out at least 128), within 2e-3 and above 40 dB;
* ``--lora`` together with ``--quantize`` raises ``alg_tpu``'s ``ValueError``.

From the forward on, each quantized linear call of the port is fed the
input and the output of ``alg_tpu``'s (``torch_port_common.QuantTeacher``,
over ``quant_feed.QuantFeed``), and its own input is held within 1e-4 of the
fed one: two runs of a W8A8 model agree only up to codes at rounding ties,
and a few of those move a 2-step pipeline by 0.1, ``alg_tpu``'s jitted run
against its own op-by-op one too. The bounds are those of the JAX goldens
(``tests/test_quant.py``, ``tests/test_minipipeline_wan_golden.py``)."""

import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

import alg_tpu.cli as JC
import alg_tpu.io.video as JV
from alg_tpu import pipelines as JP
from alg_tpu import serving as JS
from alg_tpu.core.config import load_run_config
from alg_tpu.ops import quant as JQ

import alg_tpu_torch.cli as TC
import alg_tpu_torch.io.video as TV
import alg_tpu_torch.serve_cli as TSC
from alg_tpu_torch import serving as TS
from alg_tpu_torch.core.config import run_config_from_dict
from alg_tpu_torch.io import hf_checkpoint as H
from alg_tpu_torch.io.jax_params import flatten_jax_tree
from alg_tpu_torch.models.layers import QuantizedLinear
from alg_tpu_torch.ops import quant as Q
from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline
from alg_tpu_torch.pipelines.hunyuan import HunyuanVideoPipeline
from alg_tpu_torch.pipelines.wan import WanPipeline

from torch_port_common import QuantTeacher, one_thread, psnr, quant_dit

yaml = pytest.importorskip("yaml")
Image = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(REPO, "assets", "a red double decker bus driving down a street.jpg")
PROMPTS = ("a red double decker bus driving down the street", "the panda")


def _torch_weight(w_in_out: np.ndarray, dtype: str) -> torch.Tensor:
    """A JAX-layout ``[..., in, out]`` array as the port's ``[..., out, in]`` tensor in ``dtype`` (the same
    values the JAX package sees after its own cast)."""
    rounded = np.asarray(jnp.asarray(w_in_out, dtype).astype(jnp.float32))
    return torch.from_numpy(rounded.copy()).to(getattr(torch, dtype)).transpose(-1, -2).contiguous()


# -- the quantizers -------------------------------------------------------------------


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["w8", "w4"])
def test_quantizers_are_bit_equal(mode, dtype, stacked):
    """Codes and scales of ``quantize_kernel`` / ``quantize_kernel_w4``, a layer axis in front or not."""
    shape = (3, 384, 136) if stacked else (256, 200)
    w = (np.random.RandomState(1).randn(*shape) * 0.05).astype(np.float32)
    w[..., 5, 7] = 0.9  # an outlier column entry: its channel's scale is set by it
    w[..., :, 3] = 0.0  # an all-zero output channel: the 1e-12 floor
    wj = jnp.asarray(w, dtype)
    if mode == "w8":
        want = JQ.quantize_kernel(wj)
        got = Q.quantize_kernel(_torch_weight(w, dtype))
        pairs = [(want[0], got[0].transpose(-1, -2)), (np.asarray(want[1])[..., 0, :], got[1])]
    else:
        want = JQ.quantize_kernel_w4(wj)
        got = Q.quantize_kernel_w4(_torch_weight(w, dtype))
        pairs = [(want[0], got[0].transpose(-1, -2)), (want[1], got[1].transpose(-1, -2)),
                 (np.asarray(want[2])[..., 0, :], got[2])]
    for ref, out in pairs:
        ref = np.asarray(ref)
        assert ref.dtype == out.numpy().dtype and ref.shape == tuple(out.shape)
        assert np.array_equal(ref, out.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w4_to_int8_is_bit_equal(dtype):
    w = (np.random.RandomState(2).randn(2, 256, 72) * 0.02).astype(np.float32)
    packed, s4, s8 = JQ.quantize_kernel_w4(jnp.asarray(w, dtype))
    want = np.asarray(JQ.w4_to_int8({"kernel_q4": packed, "w_scale4": s4, "w_scale": s8}))
    got = Q.w4_to_int8(torch.from_numpy(np.asarray(packed).swapaxes(-1, -2).copy()),
                       torch.from_numpy(np.asarray(s4).swapaxes(-1, -2).copy()),
                       torch.from_numpy(np.asarray(s8)[..., 0, :].copy()))
    assert np.array_equal(want, got.transpose(-1, -2).numpy())
    with pytest.raises(ValueError, match="group"):
        Q.quantize_kernel_w4(torch.zeros(8, 200))


# -- the linear ------------------------------------------------------------------------


def _linear_case(mode, dtype, bias, in_dim=384, out_dim=264, rows=(2, 9)):
    rng = np.random.RandomState(3)
    w = (rng.randn(in_dim, out_dim) * 0.05).astype(np.float32)
    b = (rng.randn(out_dim) * 0.1).astype(np.float32)
    x = rng.randn(*rows, in_dim).astype(np.float32)
    x[0, 1] = 0.0  # an all-zero row: the 1e-12 floor of its scale
    jdt = jnp.dtype(dtype)
    node = {"kernel": jnp.asarray(w, jdt), **({"bias": jnp.asarray(b, jdt)} if bias else {})}
    tree = JQ.quantize_transformer_params({"blocks": {"lin": node}}, mode=mode)["blocks"]["lin"]
    lin = nn.Linear(in_dim, out_dim, bias=bias, dtype=getattr(torch, dtype))
    with torch.no_grad():
        lin.weight.copy_(_torch_weight(w, dtype))
        if bias:
            lin.bias.copy_(torch.from_numpy(np.asarray(jnp.asarray(b, jdt).astype(jnp.float32))))
    xt = torch.from_numpy(np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))).to(getattr(torch, dtype))
    return tree, QuantizedLinear.from_linear(lin, mode), jnp.asarray(x, jdt), xt


@jax.jit
def _jax_accumulators(p, x):
    """``_quantized_linear_impl``'s activation quantizer and int32 product, as it computes them."""
    kernel_q = JQ.w4_to_int8(p) if "kernel_q4" in p else p["kernel_q"]
    xf = x.astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-12)
    xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
    return jax.lax.dot_general(xq, kernel_q, (((x.ndim - 1,), (0,)), ((), ())), preferred_element_type=jnp.int32)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["w8", "w4"])
def test_quantized_linear_matches_jax(mode, dtype, bias):
    """Accumulators bit-equal; the output within 1e-6 of the largest value (the epilogue's fp32 products round
    alike, up to XLA's fusion order); no module of the port holds a float weight."""
    tree, ql, xj, xt = _linear_case(mode, dtype, bias)
    assert not hasattr(ql, "weight") and ql.mode == mode and (ql.bias is not None) == bias
    xq, _ = Q.quantize_rows(xt.reshape(-1, xt.shape[-1]))
    acc = Q.int8_matmul(xq, ql.int8_weight()).reshape(xt.shape[:-1] + (ql.out_features,))
    assert acc.dtype == torch.int32
    assert np.array_equal(np.asarray(_jax_accumulators(tree, xj)), acc.numpy())
    want = np.asarray(jax.jit(JQ.quantized_linear)(tree, xj).astype(jnp.float32))
    with torch.no_grad():
        got = ql(xt)
    assert got.dtype == xt.dtype and got.shape == want.shape
    got = got.float().numpy()
    flipped = int(np.sum(got != want))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), f"{flipped} values differ"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["w8", "w4"])
def test_dx_matches_jax_grad(mode, dtype):
    """``dx`` of the QLoRA backward against ``jax.grad`` through ``alg_tpu``'s custom VJP; the weights,
    scales and bias take no gradient."""
    tree, ql, xj, xt = _linear_case(mode, dtype, bias=True)
    g = np.random.RandomState(4).randn(*xt.shape[:-1], ql.out_features).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(JQ.quantized_linear(tree, x).astype(jnp.float32) * g)))(xj)
                      .astype(jnp.float32))
    xg = xt.clone().requires_grad_()
    (ql(xg).float() * torch.from_numpy(g)).sum().backward()
    assert xg.grad.dtype == xt.dtype
    np.testing.assert_allclose(xg.grad.float().numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert ql.bias.grad is None and not any(b.requires_grad for b in ql.buffers())


def test_int8_matmul_has_no_other_route():
    """The CPU product is the plain version; a tensor of another device raises rather than falls back."""
    a = torch.randint(-127, 128, (3, 32), dtype=torch.int8)
    w = torch.randint(-127, 128, (16, 32), dtype=torch.int8)
    assert torch.equal(Q.int8_matmul(a, w), (a.double() @ w.double().t()).to(torch.int32))
    with pytest.raises(RuntimeError, match="no route"):
        Q.int8_matmul(a.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="mode"):
        Q.quantize_transformer_(nn.Module(), mode="w2")


# -- tree quantization --------------------------------------------------------------------


def _quantized_names(named):
    """{module name: "w8" | "w4"} from (state-dict name, tensor) pairs."""
    out = {}
    for name, _ in named:
        path, _, leaf = name.rpartition(".")
        if leaf in ("weight_q", "weight_q4"):
            out[path] = "w8" if leaf == "weight_q" else "w4"
    return out


@pytest.mark.parametrize("modulation", [False, True])
@pytest.mark.parametrize("mode", ["w8", "w4"])
@pytest.mark.parametrize("family", ["cogvideox", "wan", "hunyuan"])
def test_quantized_modules_are_the_quantized_leaves(family, mode, modulation):
    """``quantize_transformer_`` picks the linears ``quantize_transformer_params`` picks, in the same mode (w4
    falls back to int8 where in % 128 != 0), and their codes, scales and biases are bit-equal."""
    cfg, tree, make_port = quant_dit(family)
    qtree = JQ.quantize_transformer_params(tree, modulation=modulation, mode=mode)
    want = dict(flatten_jax_tree(qtree))
    model = Q.quantize_transformer_(make_port(tree), mode=mode, modulation=modulation)
    got = model.state_dict()
    assert _quantized_names(got.items()) == _quantized_names(want.items())
    modes = set(_quantized_names(got.items()).values())
    assert modes == ({"w8", "w4"} if mode == "w4" else {"w8"})  # each config has both kinds of in-dim
    # Wan's blocks modulate through a table: no linear of theirs is a modulation linear
    assert any("norm" in n for n in _quantized_names(got.items())) == (modulation and family != "wan")
    assert set(got) == set(want)
    for name, arr in want.items():
        ref = np.asarray(arr)
        assert np.array_equal(got[name].numpy(), ref.astype(got[name].numpy().dtype)), name
    assert sum(isinstance(m, QuantizedLinear) for m in model.modules()) == len(_quantized_names(want.items()))


def _dit_inputs(family, cfg):
    rng = np.random.RandomState(5)
    t = np.array([999.0, 321.0], np.float32)
    if family == "cogvideox":
        from alg_tpu.models.cogvideox import cogvideox_rope

        cos, sin = cogvideox_rope(cfg, 64, 64, 2)
        return (rng.randn(2, 2, cfg.in_channels, 8, 8).astype(np.float32),
                rng.randn(2, 4, cfg.text_embed_dim).astype(np.float32), t, np.asarray(cos), np.asarray(sin))
    if family == "wan":
        from alg_tpu.models.wan import wan_rope

        cos, sin = wan_rope(cfg, 2, 8, 8)
        return (rng.randn(2, cfg.in_channels, 2, 8, 8).astype(np.float32), t,
                rng.randn(2, 6, cfg.text_dim).astype(np.float32),
                rng.randn(2, 5, cfg.image_dim).astype(np.float32), np.asarray(cos), np.asarray(sin))
    from alg_tpu.models.hunyuan import hunyuan_rope

    cos, sin = hunyuan_rope(cfg, 2, 8, 8)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    return (rng.randn(2, cfg.in_channels, 2, 8, 8).astype(np.float32), t,
            rng.randn(2, 6, cfg.text_embed_dim).astype(np.float32), mask,
            rng.randn(2, cfg.pooled_projection_dim).astype(np.float32), np.full((2,), 6000.0, np.float32),
            np.asarray(cos), np.asarray(sin))


def _jax_forward(family, cfg, params, args):
    if family == "cogvideox":
        from alg_tpu.models.cogvideox import cogvideox_transformer as f
    elif family == "wan":
        from alg_tpu.models.wan import wan_transformer as f
    else:
        from alg_tpu.models.hunyuan import hunyuan_transformer as f
    *inputs, cos, sin = args  # the rope tables stay numpy constants, as the pipelines pass them
    return np.asarray(jax.jit(lambda p, *a: f(p, cfg, *a, cos, sin))(params, *(jnp.asarray(a) for a in inputs)))


@pytest.mark.parametrize("mode", ["w8", "w4"])
@pytest.mark.parametrize("family", ["cogvideox", "wan", "hunyuan"])
def test_quantized_dit_forward_matches_jax(family, mode, monkeypatch):
    """A DiT whose JAX tree was quantized (Hunyuan's with its modulation linears) carried into the port through
    the weights bridge: with each quantized linear fed the JAX package's activation (``QuantTeacher``), every linear
    is called in the same order at the same shape and the forward is within atol 2e-3 of the JAX package's."""
    cfg, tree, make_port = quant_dit(family)
    qtree = JQ.quantize_transformer_params(tree, modulation=family == "hunyuan", mode=mode)
    model = make_port(qtree)
    assert any(isinstance(m, QuantizedLinear) for m in model.modules())
    args = _dit_inputs(family, cfg)
    teacher = QuantTeacher(monkeypatch)
    want = _jax_forward(family, cfg, qtree, args)
    with teacher.feeding(), torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args)).numpy()
    teacher.check()
    assert teacher.fed >= sum(isinstance(m, QuantizedLinear) for m in model.modules())
    assert got.shape == want.shape
    print(f"{family} {mode}: {teacher.report()}")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


# -- small checkpoints through the entry points ------------------------------------------------


def _config(path, **generation):
    return {
        "model": {"path": path, "dtype": "float32", "flow_shift": 7.0, "flow_reverse": False},
        "generation": {"height": 32, "width": 32, "num_frames": 5, "num_inference_steps": 2, "guidance_scale": 6.0,
                       "max_sequence_length": 16, **generation},
        "alg": {"use_low_pass_guidance": True, "lp_filter_type": "down_up", "lp_filter_in_latent": True,
                "lp_blur_sigma": None, "lp_resize_factor": 0.25, "lp_strength_schedule_type": "interval",
                "schedule_interval_start_time": 0.0, "schedule_interval_end_time": 0.5},
        "video": {"fps": 8},
    }


# the tiny checkpoints' DiTs widened so that their block linears quantize (the families' shapes above)
QUANT_COGVIDEOX = {**H.TINY_COGVIDEOX, "transformer": {**H.TINY_COGVIDEOX["transformer"], "num_attention_heads": 3,
                                                        "attention_head_dim": 64, "time_embed_dim": 128}}
QUANT_WAN = {**H.TINY_WAN, "transformer": {**H.TINY_WAN["transformer"], "attention_head_dim": 64, "ffn_dim": 320},
             "text_encoder": {**H.TINY_WAN["text_encoder"], "relative_attention_num_buckets": 32,
                              "relative_attention_max_distance": 128}}  # alg_tpu's loader assumes these (R9)
QUANT_HUNYUAN = {**H.TINY_HUNYUAN, "transformer": {**H.TINY_HUNYUAN["transformer"], "attention_head_dim": 64,
                                                    "mlp_ratio": 2.5, "rope_axes_dim": [16, 24, 24]}}


class _Checkpoints:
    """A small checkpoint of each family, its parsed config, and its YAML file, each made on first use."""

    def __init__(self, root):
        self.root, self.configs = root, {}

    def config(self, family):
        if family not in self.configs:
            name = {"cogvideox": "QuantCogVideoX", "wan": "QuantWan", "hunyuan": "QuantHunyuanVideo"}[family]
            path = os.path.join(self.root, name)
            write = {"cogvideox": H.write_cogvideox, "wan": H.write_wan, "hunyuan": H.write_hunyuan}[family]
            write(path, {"cogvideox": QUANT_COGVIDEOX, "wan": QUANT_WAN, "hunyuan": QUANT_HUNYUAN}[family], seed=3,
                  dtype=torch.float32)
            if family == "cogvideox":
                cfg = _config(path)
            elif family == "wan":
                cfg = _config(path, num_frames=9, guidance_scale=5.0)
                cfg["alg"]["lp_resize_factor"] = 0.5
            else:
                cfg = _config(path, true_cfg_scale=2.0, guidance_scale=1.0)
                cfg["alg"]["lp_resize_factor"] = 0.625
            with open(path + ".yaml", "w") as f:
                yaml.safe_dump(cfg, f)
            self.configs[family] = (cfg, path + ".yaml")
        return self.configs[family]


@pytest.fixture(scope="module")
def ck(tmp_path_factory):
    return _Checkpoints(str(tmp_path_factory.mktemp("quant_ckpts")))


@pytest.fixture
def captured(monkeypatch):
    """The final latents each package's call hands its decode, and the frames its ``write_video`` gets."""
    got = {}

    def keep(cls, key):
        decode = cls.decode_latents

        def kept(self, latents, *args, **kwargs):
            got[f"{key}_latents"] = np.array(latents)
            return decode(self, latents, *args, **kwargs)

        monkeypatch.setattr(cls, "decode_latents", kept)

    for cls in (JP.CogVideoXPipeline, JP.WanPipeline, JP.HunyuanVideoPipeline):
        keep(cls, "jax")
    for cls in (CogVideoXPipeline, WanPipeline, HunyuanVideoPipeline):
        keep(cls, "port")
    for module, key in ((JV, "jax"), (TV, "port")):
        write = module.write_video

        def wrapped(path, frames, fps, _write=write, _key=key):
            got[f"{_key}_frames"] = TV._frames_to_uint8(frames)
            return _write(path, frames, fps)

        monkeypatch.setattr(module, "write_video", wrapped)
        monkeypatch.setattr(module.shutil, "which", lambda name: None)
    return got


def _frames_psnr(a, b):
    return psnr(np.asarray(a, np.float64) / 255, np.asarray(b, np.float64) / 255)


@pytest.mark.parametrize("family,mode", [("cogvideox", "w8"), ("cogvideox", "w4"), ("wan", "w4"), ("hunyuan", "w8")])
def test_cli_run_quantize_matches_alg_tpu(family, mode, ck, captured, tmp_path, monkeypatch):
    """``cli.run --quantize`` against ``alg_tpu.cli.run --quantize`` over the same YAML file, image and flags,
    each quantized linear of the port fed the activation ``alg_tpu``'s got (``QuantTeacher``; every linear found by
    its codes, so both loaders quantized alike): latents within 2e-3, frames above 40 dB."""
    _, config_path = ck.config(family)
    argv = ["--config", config_path, "--image_path", IMAGE, "--prompt", PROMPTS[0], "--quantize", mode]
    teacher = QuantTeacher(monkeypatch)
    JC.run(JC.build_parser().parse_args(argv + ["--output_path", str(tmp_path / "jax.mp4")]))
    load, loaded = TC.load_pipeline, []

    def load_and_keep(*a, **kw):
        loaded.append(load(*a, **kw))
        return loaded[-1]

    monkeypatch.setattr(TC, "load_pipeline", load_and_keep)
    with teacher.feeding():
        TC.run(TC.build_parser().parse_args(argv + ["--output_path", str(tmp_path / "port.mp4"), "--device", "cpu"]))
    modes = {m.mode for m in loaded[0].transformer.modules() if isinstance(m, QuantizedLinear)}
    assert modes == ({"w8", "w4"} if mode == "w4" else {"w8"})
    teacher.check()
    err = np.abs(captured["port_latents"] - captured["jax_latents"]).max()
    assert err <= 2e-3, err
    assert _frames_psnr(captured["port_frames"], captured["jax_frames"]) > 40.0


def _requests(module):
    img = Image.open(IMAGE).convert("RGB").resize((32, 32), resample=Image.LANCZOS)
    return [module.BatchRequest(prompt=p, image=im, negative_prompt="", seed=s)
            for p, im, s in zip(PROMPTS, (img, img.transpose(Image.FLIP_LEFT_RIGHT)), (42, 7))]


@pytest.mark.parametrize("family,mode", [("cogvideox", "w4"), ("wan", "w8"), ("hunyuan", "w4")])
def test_serve_batch_quantized_matches_alg_tpu(family, mode, ck, captured, monkeypatch):
    """``serve_batch`` of two requests over pipelines loaded with ``quantize`` by both packages, the port's
    quantized linears fed ``alg_tpu``'s activations: final latents within 2e-3, frames above 40 dB."""
    config, config_path = ck.config(family)
    cfg = run_config_from_dict(config)
    jpipe = JC.load_pipeline(load_run_config(config_path), quantize=mode)
    tpipe = TC.load_pipeline(cfg, quantize=mode, device="cpu")
    kw = cfg.pipeline_kwargs
    teacher = QuantTeacher(monkeypatch)
    want = np.asarray(JS.serve_batch(jpipe, _requests(JS), **kw, output_type="np"))
    with teacher.feeding():
        got = TS.serve_batch(tpipe, _requests(TS), **kw, output_type="np")
    teacher.check()
    assert captured["port_latents"].shape == captured["jax_latents"].shape and got.shape == want.shape
    np.testing.assert_allclose(captured["port_latents"], captured["jax_latents"], rtol=0, atol=2e-3)
    assert psnr(got, want) > 40.0


def test_quantize_pipeline_matches_jax(ck, monkeypatch):
    """``quantize_pipeline`` over an unquantized load in both packages, one CogVideoX call, the port's linears
    fed ``alg_tpu``'s activations: latents within 2e-3, frames above 40 dB; the port's pipeline is the same
    object with its DiT's block linears replaced."""
    config, config_path = ck.config("cogvideox")
    cfg = run_config_from_dict(config)
    jpipe = JQ.quantize_pipeline(JC.load_pipeline(load_run_config(config_path)), mode="w8")
    tpipe = TC.load_pipeline(cfg, device="cpu")
    assert Q.quantize_pipeline(tpipe, mode="w8") is tpipe
    image = np.asarray(Image.open(IMAGE).convert("RGB").resize((32, 32), resample=Image.LANCZOS))
    kw = dict(cfg.pipeline_kwargs, prompt=PROMPTS[0], seed=42)
    teacher = QuantTeacher(monkeypatch)
    from alg_tpu_torch.pipelines.processing import preprocess_image

    pixels = np.asarray(preprocess_image(image, 32, 32))
    want = np.asarray(jpipe(image=pixels, output_type="np", **kw))
    with teacher.feeding():
        got = tpipe(image=preprocess_image(image, 32, 32), output_type="np", **kw)
    teacher.check()
    assert got.shape == want.shape and psnr(got, want) > 40.0


def test_serve_cli_run_quantize_matches_alg_tpu(ck, captured, tmp_path, monkeypatch):
    """``serve_cli.run --quantize w8`` over a requests file against ``alg_tpu``'s ``serve_cli``, the port's
    linears fed ``alg_tpu``'s activations: one video a request, the batch's final latents within 2e-3 and the
    last video's frames above 40 dB."""
    import alg_tpu.serve_cli as JSC

    _, config_path = ck.config("cogvideox")
    img = tmp_path / "a.png"
    Image.open(IMAGE).convert("RGB").resize((32, 32), resample=Image.LANCZOS).save(img)
    requests = tmp_path / "r.jsonl"
    requests.write_text("".join(f'{{"prompt": "{p}", "image_path": "{img}", "seed": {s}}}\n'
                                for p, s in zip(PROMPTS, (42, 7))))
    argv = ["--config", config_path, "--requests", str(requests), "--quantize", "w8"]
    teacher = QuantTeacher(monkeypatch)
    JSC.main(argv + ["--output_dir", str(tmp_path / "jax")])
    with teacher.feeding():
        written = TSC.run(TSC.build_parser().parse_args(argv + ["--output_dir", str(tmp_path / "port"),
                                                                "--device", "cpu"]))
    teacher.check()
    assert [os.path.basename(p) for p in written] == ["000.avi", "001.avi"]
    assert sorted(os.listdir(tmp_path / "jax")) == ["000.avi", "001.avi"]
    assert captured["port_latents"].shape[0] == 2
    np.testing.assert_allclose(captured["port_latents"], captured["jax_latents"], rtol=0, atol=2e-3)
    assert _frames_psnr(captured["port_frames"], captured["jax_frames"]) > 40.0


def test_lora_with_quantize_raises(ck, tmp_path):
    """``alg_tpu/cli.py``'s refusal, in ``load_pipeline`` under ``cli.run`` and ``serve_cli.run``."""
    config, _ = ck.config("cogvideox")
    cfg = run_config_from_dict(config)
    with pytest.raises(ValueError, match="--lora with --quantize is unsupported"):
        TC.load_pipeline(cfg, quantize="w8", lora=str(tmp_path / "a.npz"), device="cpu")
    args = TSC.build_parser().parse_args(["--config", "-", "--device", "cpu", "--quantize", "w4", "--lora", "a.npz",
                                          "--output_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="--lora with --quantize is unsupported"):
        TSC.run(args, config=config, requests=_requests(TS))
