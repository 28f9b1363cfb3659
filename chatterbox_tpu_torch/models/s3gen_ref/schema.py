"""Canonical ``s3gen.safetensors`` key→shape schema (a copy of
``chatterbox_tpu/models/s3gen_ref/schema.py``; the module is numpy only).

The one description of the checkpoint keys ``convert.py`` consumes: the
port's tests synthesise structural checkpoints from it, the full-size schema
is frozen in ``chatterbox_tpu_torch/data/checkpoint_manifest.json``, and
``runtime/loader.py`` diffs a real checkpoint against that manifest at load
time, so a mismatch between a real artifact and this schema is one loud log
line.

Weight-normed convs are emitted in the legacy ``weight_g``/``weight_v``
spelling (the published CosyVoice2-family checkpoints use pre-parametrize
torch); the converter (and the manifest diff) also accept the
``parametrizations.weight.original0/1`` spelling.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .config import S3GenRefConfig

Shape = Tuple[int, ...]


def s3gen_checkpoint_schema(cfg: S3GenRefConfig) -> Dict[str, Shape]:
    """Every key of ``s3gen.safetensors`` (for this config) → tensor shape."""
    d: Dict[str, Shape] = {}

    def add(key: str, *shape: int) -> None:
        d[key] = tuple(shape)

    def add_bn(base: str, c: int, affine: bool = True) -> None:
        if affine:
            add(base + ".weight", c)
            add(base + ".bias", c)
        add(base + ".running_mean", c)
        add(base + ".running_var", c)
        add(base + ".num_batches_tracked")

    def add_wn(base: str, out: int, inn: int, k: int) -> None:
        add(base + ".weight_g", out, 1, 1)
        add(base + ".weight_v", out, inn, k)
        add(base + ".bias", out)

    # ------------------------------------------------------------- tokenizer
    tk = cfg.tokenizer
    D = tk.n_state
    add("tokenizer.encoder.conv1.weight", D, tk.n_mels, 3)
    add("tokenizer.encoder.conv1.bias", D)
    add("tokenizer.encoder.conv2.weight", D, D, 3)
    add("tokenizer.encoder.conv2.bias", D)
    add("tokenizer.encoder.positional_embedding", tk.n_audio_ctx, D)
    for i in range(tk.n_layer):
        b = f"tokenizer.encoder.blocks.{i}"
        add(b + ".attn.query.weight", D, D); add(b + ".attn.query.bias", D)
        add(b + ".attn.key.weight", D, D)
        add(b + ".attn.value.weight", D, D); add(b + ".attn.value.bias", D)
        add(b + ".attn.out.weight", D, D); add(b + ".attn.out.bias", D)
        add(b + ".attn_ln.weight", D); add(b + ".attn_ln.bias", D)
        add(b + ".mlp.0.weight", 4 * D, D); add(b + ".mlp.0.bias", 4 * D)
        add(b + ".mlp.2.weight", D, 4 * D); add(b + ".mlp.2.bias", D)
        add(b + ".mlp_ln.weight", D); add(b + ".mlp_ln.bias", D)
    add("tokenizer.quantizer._codebook.project_down.weight", tk.fsq_dim, D)
    add("tokenizer.quantizer._codebook.project_down.bias", tk.fsq_dim)

    # -------------------------------------------------------------- campplus
    sp = cfg.speaker
    m = sp.m_channels
    add("speaker_encoder.head.conv1.weight", m, 1, 3, 3)
    add_bn("speaker_encoder.head.bn1", m)
    for lname in ("layer1", "layer2"):
        for bi in range(2):
            b = f"speaker_encoder.head.{lname}.{bi}"
            add(b + ".conv1.weight", m, m, 3, 3)
            add_bn(b + ".bn1", m)
            add(b + ".conv2.weight", m, m, 3, 3)
            add_bn(b + ".bn2", m)
            if bi == 0:  # stride-2 block has a projection shortcut
                add(b + ".shortcut.0.weight", m, m, 1, 1)
                add_bn(b + ".shortcut.1", m)
    add("speaker_encoder.head.conv2.weight", m, m, 3, 3)
    add_bn("speaker_encoder.head.bn2", m)

    ch = m * (sp.feat_dim // 8)
    add("speaker_encoder.xvector.tdnn.linear.weight", sp.init_channels, ch, 5)
    add_bn("speaker_encoder.xvector.tdnn.nonlinear.batchnorm", sp.init_channels)
    ch = sp.init_channels
    for b_i, (nl, k) in enumerate(zip(sp.num_layers, sp.kernel_sizes)):
        growth, bn_ch = sp.growth_rate, sp.bn_size * sp.growth_rate
        cin = ch
        for li in range(nl):
            base = f"speaker_encoder.xvector.block{b_i + 1}.tdnnd{li + 1}"
            add_bn(base + ".nonlinear1.batchnorm", cin)
            add(base + ".linear1.weight", bn_ch, cin, 1)
            add_bn(base + ".nonlinear2.batchnorm", bn_ch)
            add(base + ".cam_layer.linear_local.weight", growth, bn_ch, k)
            add(base + ".cam_layer.linear1.weight", bn_ch // 2, bn_ch, 1)
            add(base + ".cam_layer.linear1.bias", bn_ch // 2)
            add(base + ".cam_layer.linear2.weight", growth, bn_ch // 2, 1)
            add(base + ".cam_layer.linear2.bias", growth)
            cin += growth
        ch = cin
        add_bn(f"speaker_encoder.xvector.transit{b_i + 1}.nonlinear.batchnorm", ch)
        add(f"speaker_encoder.xvector.transit{b_i + 1}.linear.weight", ch // 2, ch, 1)
        ch //= 2
    add_bn("speaker_encoder.xvector.out_nonlinear.batchnorm", ch)
    add("speaker_encoder.xvector.dense.linear.weight", sp.embedding_size, ch * 2, 1)
    add_bn("speaker_encoder.xvector.dense.nonlinear.batchnorm", sp.embedding_size, affine=False)

    # ------------------------------------------------------------------ flow
    fl = cfg.flow
    E = fl.input_size
    add("flow.input_embedding.weight", fl.vocab_size, E)
    add("flow.spk_embed_affine_layer.weight", fl.output_size, fl.spk_embed_dim)
    add("flow.spk_embed_affine_layer.bias", fl.output_size)
    add("flow.encoder_proj.weight", fl.output_size, E)
    add("flow.encoder_proj.bias", fl.output_size)
    for emb in ("embed", "up_embed"):
        add(f"flow.encoder.{emb}.out.0.weight", E, E)
        add(f"flow.encoder.{emb}.out.0.bias", E)
        add(f"flow.encoder.{emb}.out.1.weight", E)
        add(f"flow.encoder.{emb}.out.1.bias", E)
    add("flow.encoder.pre_lookahead_layer.conv1.weight", E, E, fl.pre_lookahead_len + 1)
    add("flow.encoder.pre_lookahead_layer.conv1.bias", E)
    add("flow.encoder.pre_lookahead_layer.conv2.weight", E, E, 3)
    add("flow.encoder.pre_lookahead_layer.conv2.bias", E)

    def add_conformer(base: str, n: int) -> None:
        dk = E // fl.attention_heads
        for i in range(n):
            b = f"{base}.{i}"
            for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
                add(f"{b}.self_attn.{lin}.weight", E, E)
                add(f"{b}.self_attn.{lin}.bias", E)
            add(f"{b}.self_attn.linear_pos.weight", E, E)
            add(f"{b}.self_attn.pos_bias_u", fl.attention_heads, dk)
            add(f"{b}.self_attn.pos_bias_v", fl.attention_heads, dk)
            add(f"{b}.feed_forward.w_1.weight", fl.linear_units, E)
            add(f"{b}.feed_forward.w_1.bias", fl.linear_units)
            add(f"{b}.feed_forward.w_2.weight", E, fl.linear_units)
            add(f"{b}.feed_forward.w_2.bias", E)
            add(f"{b}.norm_mha.weight", E); add(f"{b}.norm_mha.bias", E)
            add(f"{b}.norm_ff.weight", E); add(f"{b}.norm_ff.bias", E)

    add_conformer("flow.encoder.encoders", fl.num_blocks)
    add("flow.encoder.up_layer.conv.weight", E, E, 2 * fl.up_stride + 1)
    add("flow.encoder.up_layer.conv.bias", E)
    add_conformer("flow.encoder.up_encoders", fl.num_up_blocks)
    add("flow.encoder.after_norm.weight", E); add("flow.encoder.after_norm.bias", E)

    es = "flow.decoder.estimator"
    ch_dec = fl.dec_channels[0]
    tdim = ch_dec * 4
    add(f"{es}.time_mlp.linear_1.weight", tdim, fl.dec_time_dim)
    add(f"{es}.time_mlp.linear_1.bias", tdim)
    add(f"{es}.time_mlp.linear_2.weight", tdim, tdim)
    add(f"{es}.time_mlp.linear_2.bias", tdim)

    def add_resnet(base: str, cin: int, cout: int) -> None:
        add(f"{base}.mlp.1.weight", cout, tdim); add(f"{base}.mlp.1.bias", cout)
        add(f"{base}.block1.block.0.weight", cout, cin, 3); add(f"{base}.block1.block.0.bias", cout)
        add(f"{base}.block1.block.1.weight", cout); add(f"{base}.block1.block.1.bias", cout)
        add(f"{base}.block2.block.0.weight", cout, cout, 3); add(f"{base}.block2.block.0.bias", cout)
        add(f"{base}.block2.block.1.weight", cout); add(f"{base}.block2.block.1.bias", cout)
        add(f"{base}.res_conv.weight", cout, cin, 1); add(f"{base}.res_conv.bias", cout)

    def add_tfs(base: str) -> None:
        inner = fl.dec_num_heads * fl.dec_attention_head_dim
        for j in range(fl.dec_n_blocks):
            b = f"{base}.{j}"
            add(f"{b}.norm1.weight", ch_dec); add(f"{b}.norm1.bias", ch_dec)
            add(f"{b}.attn1.to_q.weight", inner, ch_dec)
            add(f"{b}.attn1.to_k.weight", inner, ch_dec)
            add(f"{b}.attn1.to_v.weight", inner, ch_dec)
            add(f"{b}.attn1.to_out.0.weight", ch_dec, inner)
            add(f"{b}.attn1.to_out.0.bias", ch_dec)
            add(f"{b}.norm3.weight", ch_dec); add(f"{b}.norm3.bias", ch_dec)
            add(f"{b}.ff.net.0.proj.weight", 4 * ch_dec, ch_dec)
            add(f"{b}.ff.net.0.proj.bias", 4 * ch_dec)
            add(f"{b}.ff.net.2.weight", ch_dec, 4 * ch_dec)
            add(f"{b}.ff.net.2.bias", ch_dec)

    add_resnet(f"{es}.down_blocks.0.0", fl.dec_in_channels, ch_dec)
    add_tfs(f"{es}.down_blocks.0.1")
    add(f"{es}.down_blocks.0.2.weight", ch_dec, ch_dec, 3)
    add(f"{es}.down_blocks.0.2.bias", ch_dec)
    for mi in range(fl.dec_num_mid_blocks):
        add_resnet(f"{es}.mid_blocks.{mi}.0", ch_dec, ch_dec)
        add_tfs(f"{es}.mid_blocks.{mi}.1")
    add_resnet(f"{es}.up_blocks.0.0", 2 * ch_dec, ch_dec)
    add_tfs(f"{es}.up_blocks.0.1")
    add(f"{es}.up_blocks.0.2.weight", ch_dec, ch_dec, 3)
    add(f"{es}.up_blocks.0.2.bias", ch_dec)
    add(f"{es}.final_block.block.0.weight", ch_dec, ch_dec, 3)
    add(f"{es}.final_block.block.0.bias", ch_dec)
    add(f"{es}.final_block.block.1.weight", ch_dec)
    add(f"{es}.final_block.block.1.bias", ch_dec)
    add(f"{es}.final_proj.weight", fl.output_size, ch_dec, 1)
    add(f"{es}.final_proj.bias", fl.output_size)

    # ------------------------------------------------------------------ hift
    hf = cfg.hift
    base_ch = hf.base_channels
    nfft2 = hf.istft_n_fft + 2
    add_wn("mel2wav.conv_pre", base_ch, hf.in_channels, 7)
    cum = list(np.cumprod([1] + list(hf.upsample_rates[::-1][:-1])))[::-1]
    for i, (u, k) in enumerate(zip(hf.upsample_rates, hf.upsample_kernel_sizes)):
        cin, cout = base_ch // (2 ** i), base_ch // (2 ** (i + 1))
        # ConvTranspose1d weight layout is [in, out, k]; weight_g norms dim 0
        add(f"mel2wav.ups.{i}.weight_g", cin, 1, 1)
        add(f"mel2wav.ups.{i}.weight_v", cin, cout, k)
        add(f"mel2wav.ups.{i}.bias", cout)
        du = int(cum[i])
        add(f"mel2wav.source_downs.{i}.weight", cout, nfft2, 1 if du == 1 else du * 2)
        add(f"mel2wav.source_downs.{i}.bias", cout)
        sk = hf.source_resblock_kernel_sizes[i]
        for j in range(len(hf.source_resblock_dilation_sizes[i])):
            add_wn(f"mel2wav.source_resblocks.{i}.convs1.{j}", cout, cout, sk)
            add_wn(f"mel2wav.source_resblocks.{i}.convs2.{j}", cout, cout, sk)
            add(f"mel2wav.source_resblocks.{i}.activations1.{j}.alpha", cout)
            add(f"mel2wav.source_resblocks.{i}.activations2.{j}.alpha", cout)
        for j, (k2, dils) in enumerate(zip(hf.resblock_kernel_sizes, hf.resblock_dilation_sizes)):
            n = i * len(hf.resblock_kernel_sizes) + j
            for jj in range(len(dils)):
                add_wn(f"mel2wav.resblocks.{n}.convs1.{jj}", cout, cout, k2)
                add_wn(f"mel2wav.resblocks.{n}.convs2.{jj}", cout, cout, k2)
                add(f"mel2wav.resblocks.{n}.activations1.{jj}.alpha", cout)
                add(f"mel2wav.resblocks.{n}.activations2.{jj}.alpha", cout)
    add_wn("mel2wav.conv_post", nfft2, base_ch // (2 ** len(hf.upsample_rates)), 7)
    cin = hf.in_channels
    for idx in (0, 2, 4, 6, 8):
        add_wn(f"mel2wav.f0_predictor.condnet.{idx}", hf.f0_cond_channels, cin, 3)
        cin = hf.f0_cond_channels
    add("mel2wav.f0_predictor.classifier.weight", 1, hf.f0_cond_channels)
    add("mel2wav.f0_predictor.classifier.bias", 1)
    add("mel2wav.m_source.l_linear.weight", 1, hf.nb_harmonics + 1)
    add("mel2wav.m_source.l_linear.bias", 1)
    add("mel2wav.stft_window", hf.istft_n_fft)
    return d


def synthesize_checkpoint(
    schema: Dict[str, Shape], seed: int = 0, scale: float = 0.05, zeros: bool = False
) -> Dict[str, np.ndarray]:
    """Materialise a checkpoint with exactly this schema (tests).

    ``zeros=True`` fills with zeros/ones instead of random data — fast enough
    to exercise the FULL-SIZE schema (structure is what's under test)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for key, shape in schema.items():
        if key.endswith("num_batches_tracked"):
            out[key] = np.asarray(100, np.int64)
        elif key.endswith("running_var"):
            out[key] = (
                np.ones(shape, np.float32) if zeros
                else (np.abs(rng.standard_normal(shape)) + 0.5).astype(np.float32)
            )
        elif key.endswith("weight_g"):
            out[key] = (
                np.ones(shape, np.float32) if zeros
                else (np.abs(rng.standard_normal(shape)) + 0.1).astype(np.float32)
            )
        elif zeros:
            out[key] = np.zeros(shape, np.float32)
        else:
            out[key] = (rng.standard_normal(shape) * scale).astype(np.float32)
    return out
