"""Wan 2.1's tensors in the published checkpoints' layout, for ``benchmark.weights.make_weights``.

The names and shapes are those the program's checkpoint name map reads
(``alg_tpu_torch.io.weights.convert_wan_transformer`` and ``convert_wan_vae``):
diffusers ``WanTransformer3DModel`` (I2V: an image embedder and, in every
block's cross-attention, the image stream's key/value projections) and
``AutoencoderKLWan`` with its down and up blocks as one flat list each,
resnets and resamples in turn. The plain reference reads the same names.

Kinds as in ``benchmark/weights.py``; the AdaLN ``scale_shift_table`` s are
drawn as biases (N(0, 0.02²)), the RMS norms' ``gamma`` and ``weight`` as
norm weights (1 + N(0, 0.1²)).
"""

from __future__ import annotations

from benchmark.weights import Spec, _Spec


def wan_transformer_spec(cfg: dict) -> Spec:
    """diffusers ``WanTransformer3DModel``'s tensors."""
    s = _Spec()
    dim = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    pt, ph, pw = cfg["patch_size"]
    image_dim, ffn = cfg.get("image_dim"), cfg["ffn_dim"]
    s.conv("patch_embedding", cfg["in_channels"], dim, pt, ph, pw)
    ce = "condition_embedder"
    s.linear(f"{ce}.time_embedder.linear_1", dim, cfg["freq_dim"])
    s.linear(f"{ce}.time_embedder.linear_2", dim, dim)
    s.linear(f"{ce}.time_proj", 6 * dim, dim)
    s.linear(f"{ce}.text_embedder.linear_1", dim, cfg["text_dim"])
    s.linear(f"{ce}.text_embedder.linear_2", dim, dim)
    if image_dim is not None:
        s.norm(f"{ce}.image_embedder.norm1", image_dim)
        s.linear(f"{ce}.image_embedder.ff.net.0.proj", image_dim, image_dim)
        s.linear(f"{ce}.image_embedder.ff.net.2", dim, image_dim)
        s.norm(f"{ce}.image_embedder.norm2", dim)
    s.add("scale_shift_table", (1, 2, dim), "b")
    s.linear("proj_out", pt * ph * pw * cfg["out_channels"], dim)
    for i in range(cfg["num_layers"]):
        b = f"blocks.{i}"
        s.add(f"{b}.scale_shift_table", (1, 6, dim), "b")
        for a in ("attn1", "attn2"):
            for nm in ("to_q", "to_k", "to_v", "to_out.0"):
                s.linear(f"{b}.{a}.{nm}", dim, dim)
            s.add(f"{b}.{a}.norm_q.weight", (dim,), "n1")
            s.add(f"{b}.{a}.norm_k.weight", (dim,), "n1")
        if image_dim is not None:
            s.linear(f"{b}.attn2.add_k_proj", dim, dim)
            s.linear(f"{b}.attn2.add_v_proj", dim, dim)
            s.add(f"{b}.attn2.norm_added_k.weight", (dim,), "n1")
        s.norm(f"{b}.norm2", dim)
        s.linear(f"{b}.ffn.net.0.proj", ffn, dim)
        s.linear(f"{b}.ffn.net.2", dim, ffn)
    return s.items


def wan_vae_spec(cfg: dict) -> Spec:
    """``AutoencoderKLWan``'s tensors, encoder and decoder (the program's module holds both)."""
    s = _Spec()
    base, z, n_res = cfg["base_dim"], cfg["z_dim"], cfg["num_res_blocks"]
    down = list(cfg["temperal_downsample"])
    dims = [base * m for m in cfg["dim_mult"]]

    def conv3d(name, cin, cout, kernel=(3, 3, 3)):
        s.conv(name, cin, cout, *kernel)

    def gamma(name, ch, spatial=3):
        s.add(f"{name}.gamma", (ch,) + (1,) * spatial, "n1")

    def resnet(name, cin, cout):
        gamma(f"{name}.norm1", cin)
        conv3d(f"{name}.conv1", cin, cout)
        gamma(f"{name}.norm2", cout)
        conv3d(f"{name}.conv2", cout, cout)
        if cin != cout:
            conv3d(f"{name}.conv_shortcut", cin, cout, (1, 1, 1))

    def mid(prefix, ch):
        resnet(f"{prefix}.resnets.0", ch, ch)
        gamma(f"{prefix}.attentions.0.norm", ch, spatial=2)
        s.conv(f"{prefix}.attentions.0.to_qkv", ch, 3 * ch, 1, 1)
        s.conv(f"{prefix}.attentions.0.proj", ch, ch, 1, 1)
        resnet(f"{prefix}.resnets.1", ch, ch)

    conv3d("encoder.conv_in", 3, dims[0])
    idx, ch = 0, dims[0]
    for i, out in enumerate(dims):
        for _ in range(n_res):
            resnet(f"encoder.down_blocks.{idx}", ch, out)
            ch, idx = out, idx + 1
        if i < len(dims) - 1:
            s.conv(f"encoder.down_blocks.{idx}.resample.1", out, out, 3, 3)
            if down[i]:
                conv3d(f"encoder.down_blocks.{idx}.time_conv", out, out, (3, 1, 1))
            idx += 1
    mid("encoder.mid_block", ch)
    gamma("encoder.norm_out", ch)
    conv3d("encoder.conv_out", ch, 2 * z)
    conv3d("quant_conv", 2 * z, 2 * z, (1, 1, 1))
    conv3d("post_quant_conv", z, z, (1, 1, 1))

    rdims, up = list(reversed(dims)), list(reversed(down))
    conv3d("decoder.conv_in", z, rdims[0])
    mid("decoder.mid_block", rdims[0])
    idx, ch = 0, rdims[0]
    for i, out in enumerate(rdims):
        for j in range(n_res + 1):
            resnet(f"decoder.up_blocks.{idx}", ch if j == 0 else out, out)
            idx += 1
        ch = out
        if i < len(rdims) - 1:
            s.conv(f"decoder.up_blocks.{idx}.resample.1", out, out // 2, 3, 3)
            if up[i]:
                conv3d(f"decoder.up_blocks.{idx}.time_conv", out, 2 * out, (3, 1, 1))
            idx, ch = idx + 1, out // 2
    gamma("decoder.norm_out", ch)
    conv3d("decoder.conv_out", ch, 3)
    return s.items
