"""s3gen.safetensors → the S3Gen ref parameter tree (strict, 1:1; the torch
counterpart of ``chatterbox_tpu/models/s3gen_ref/convert.py``).

Maps every tensor of the checkpoint's key schema (``schema.py``) into the
JAX-layout tree that ``model.s3gen_ref_param_tree`` builds, reporting
anything missing, unused or shape-mismatched, so drift is loud. The filled
tree holds float32 numpy leaves; ``convert.convert_params`` then casts them
to the model's dtype and lays them out for torch, as it does for a random
init.

Weight-norm handling: both the legacy ``weight_g``/``weight_v`` pair and the
``parametrizations.weight.original0/1`` form merge to the materialised
weight g·v/‖v‖ (norm over all dims but 0 — torch's dim=0 convention).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .config import S3GenRefConfig


class CheckpointReader:
    """Tracks key consumption over a raw state-dict."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}
        self.used: set = set()
        self.missing: List[str] = []

    def take(self, key: str) -> Optional[np.ndarray]:
        if key not in self.sd:
            self.missing.append(key)
            return None
        self.used.add(key)
        return self.sd[key]

    def maybe(self, key: str) -> None:
        """Consume a key if present without requiring it (e.g. bn counters)."""
        if key in self.sd:
            self.used.add(key)

    def weight(self, prefix: str) -> Optional[np.ndarray]:
        """Materialised weight: plain, weight_g/v, or parametrized form."""
        if prefix + ".weight_g" in self.sd:
            g = self.take(prefix + ".weight_g")
            v = self.take(prefix + ".weight_v")
        elif prefix + ".parametrizations.weight.original0" in self.sd:
            g = self.take(prefix + ".parametrizations.weight.original0")
            v = self.take(prefix + ".parametrizations.weight.original1")
        else:
            return self.take(prefix + ".weight")
        if g is None or v is None:
            return None
        axes = tuple(range(1, v.ndim))
        norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
        return (g.astype(np.float64) * v / np.maximum(norm, 1e-12)).astype(np.float32)

    def unused(self) -> List[str]:
        return sorted(set(self.sd) - self.used)


def _containers(tree):
    """A copy of a tree's dicts and lists; the leaves are shared."""
    if isinstance(tree, dict):
        return {k: _containers(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_containers(v) for v in tree]
    return tree


class _Assigner:
    def __init__(self, params: Dict):
        # in-place path writes below never mutate the caller's tree
        self.params = _containers(params)
        self.mismatched: List[str] = []

    def put(self, path: List, value: Optional[np.ndarray], transpose=None) -> None:
        if value is None:
            return
        if transpose is not None:
            value = np.transpose(value, transpose)
        node = self.params
        for k in path[:-1]:
            node = node[k]
        leaf = node[path[-1]]
        if tuple(leaf.shape) != tuple(value.shape):
            self.mismatched.append(
                f"{'/'.join(map(str, path))}: model {tuple(leaf.shape)} vs checkpoint {tuple(value.shape)}"
            )
            return
        node[path[-1]] = value


def _bn(a: _Assigner, r: CheckpointReader, base: str, path: List, affine: bool = True) -> None:
    a.put(path + ["mean"], r.take(base + ".running_mean"))
    a.put(path + ["var"], r.take(base + ".running_var"))
    if affine:
        a.put(path + ["w"], r.take(base + ".weight"))
        a.put(path + ["b"], r.take(base + ".bias"))
    r.maybe(base + ".num_batches_tracked")


def _lin(a: _Assigner, r: CheckpointReader, base: str, path: List, bias: bool = True) -> None:
    """torch Linear (out, in) → ours (in, out)."""
    a.put(path + ["w"], r.take(base + ".weight"), transpose=(1, 0))
    if bias:
        a.put(path + ["b"], r.take(base + ".bias"))


def _conv(a: _Assigner, r: CheckpointReader, base: str, path: List, bias: bool = True) -> None:
    """torch Conv1d (out, in, k) → ours (k, in, out); merges weight norm."""
    a.put(path + ["w"], r.weight(base), transpose=(2, 1, 0))
    if bias:
        a.put(path + ["b"], r.take(base + ".bias"))


def _ln(a: _Assigner, r: CheckpointReader, base: str, path: List) -> None:
    a.put(path + ["w"], r.take(base + ".weight"))
    a.put(path + ["b"], r.take(base + ".bias"))


# --------------------------------------------------------------------- parts
def _convert_tokenizer(a: _Assigner, r: CheckpointReader, cfg: S3GenRefConfig) -> None:
    t = ["tokenizer"]
    _conv(a, r, "tokenizer.encoder.conv1", t + ["conv1"])
    _conv(a, r, "tokenizer.encoder.conv2", t + ["conv2"])
    a.put(t + ["pos"], r.take("tokenizer.encoder.positional_embedding"))
    for i in range(cfg.tokenizer.n_layer):
        b = f"tokenizer.encoder.blocks.{i}"
        blk = t + ["blocks", i]
        _lin(a, r, b + ".attn.query", blk + ["attn", "q"])
        _lin(a, r, b + ".attn.key", blk + ["attn", "k"], bias=False)
        _lin(a, r, b + ".attn.value", blk + ["attn", "v"])
        _lin(a, r, b + ".attn.out", blk + ["attn", "out"])
        _ln(a, r, b + ".attn_ln", blk + ["attn_ln"])
        _lin(a, r, b + ".mlp.0", blk + ["mlp1"])
        _lin(a, r, b + ".mlp.2", blk + ["mlp2"])
        _ln(a, r, b + ".mlp_ln", blk + ["mlp_ln"])
    _lin(a, r, "tokenizer.quantizer._codebook.project_down", t + ["fsq"])


def _conv2d(a: _Assigner, r: CheckpointReader, base: str, path: List) -> None:
    """torch Conv2d (out, in, kh, kw) → ours HWIO (kh, kw, in, out)."""
    a.put(path + ["w"], r.take(base + ".weight"), transpose=(2, 3, 1, 0))


def _convert_speaker(a: _Assigner, r: CheckpointReader, cfg: S3GenRefConfig) -> None:
    sp = cfg.speaker
    h = ["speaker", "head"]
    _conv2d(a, r, "speaker_encoder.head.conv1", h + ["conv1"])
    _bn(a, r, "speaker_encoder.head.bn1", h + ["bn1"])
    for lname in ("layer1", "layer2"):
        for bi in range(2):
            b = f"speaker_encoder.head.{lname}.{bi}"
            blk = h + [lname, bi]
            _conv2d(a, r, b + ".conv1", blk + ["conv1"])
            _bn(a, r, b + ".bn1", blk + ["bn1"])
            _conv2d(a, r, b + ".conv2", blk + ["conv2"])
            _bn(a, r, b + ".bn2", blk + ["bn2"])
            if bi == 0:
                _conv2d(a, r, b + ".shortcut.0", blk + ["shortcut", "conv"])
                _bn(a, r, b + ".shortcut.1", blk + ["shortcut", "bn"])
    _conv2d(a, r, "speaker_encoder.head.conv2", h + ["conv2"])
    _bn(a, r, "speaker_encoder.head.bn2", h + ["bn2"])

    xv = ["speaker", "xvector"]
    _conv(a, r, "speaker_encoder.xvector.tdnn.linear", xv + ["tdnn", "conv"], bias=False)
    _bn(a, r, "speaker_encoder.xvector.tdnn.nonlinear.batchnorm", xv + ["tdnn", "bn"])
    for b_i, nl in enumerate(sp.num_layers):
        for li in range(nl):
            base = f"speaker_encoder.xvector.block{b_i + 1}.tdnnd{li + 1}"
            lp = xv + [f"block{b_i + 1}", li]
            _bn(a, r, base + ".nonlinear1.batchnorm", lp + ["bn1"])
            _conv(a, r, base + ".linear1", lp + ["linear1"], bias=False)
            _bn(a, r, base + ".nonlinear2.batchnorm", lp + ["bn2"])
            _conv(a, r, base + ".cam_layer.linear_local", lp + ["cam_local"], bias=False)
            _conv(a, r, base + ".cam_layer.linear1", lp + ["cam_lin1"])
            _conv(a, r, base + ".cam_layer.linear2", lp + ["cam_lin2"])
        tb = f"speaker_encoder.xvector.transit{b_i + 1}"
        _bn(a, r, tb + ".nonlinear.batchnorm", xv + [f"transit{b_i + 1}", "bn"])
        _conv(a, r, tb + ".linear", xv + [f"transit{b_i + 1}", "conv"], bias=False)
    _bn(a, r, "speaker_encoder.xvector.out_nonlinear.batchnorm", xv + ["out_bn"])
    _conv(a, r, "speaker_encoder.xvector.dense.linear", xv + ["dense", "conv"], bias=False)
    _bn(a, r, "speaker_encoder.xvector.dense.nonlinear.batchnorm", xv + ["dense", "bn"], affine=False)


def _convert_conformer_block(a: _Assigner, r: CheckpointReader, base: str, path: List) -> None:
    _lin(a, r, base + ".self_attn.linear_q", path + ["attn", "q"])
    _lin(a, r, base + ".self_attn.linear_k", path + ["attn", "k"])
    _lin(a, r, base + ".self_attn.linear_v", path + ["attn", "v"])
    _lin(a, r, base + ".self_attn.linear_out", path + ["attn", "out"])
    _lin(a, r, base + ".self_attn.linear_pos", path + ["attn", "pos"], bias=False)
    a.put(path + ["attn", "bias_u"], r.take(base + ".self_attn.pos_bias_u"))
    a.put(path + ["attn", "bias_v"], r.take(base + ".self_attn.pos_bias_v"))
    _lin(a, r, base + ".feed_forward.w_1", path + ["ff", "w1"])
    _lin(a, r, base + ".feed_forward.w_2", path + ["ff", "w2"])
    _ln(a, r, base + ".norm_mha", path + ["norm_mha"])
    _ln(a, r, base + ".norm_ff", path + ["norm_ff"])


def _convert_flow(a: _Assigner, r: CheckpointReader, cfg: S3GenRefConfig) -> None:
    fl = cfg.flow
    f = ["flow"]
    a.put(f + ["input_emb"], r.take("flow.input_embedding.weight"))
    _lin(a, r, "flow.spk_embed_affine_layer", f + ["spk_affine"])
    _lin(a, r, "flow.encoder_proj", f + ["encoder_proj"])
    for name, dst in (("embed", "embed"), ("up_embed", "up_embed")):
        _lin(a, r, f"flow.encoder.{name}.out.0", f + ["encoder", dst, "lin"])
        _ln(a, r, f"flow.encoder.{name}.out.1", f + ["encoder", dst, "ln"])
    _conv(a, r, "flow.encoder.pre_lookahead_layer.conv1", f + ["encoder", "lookahead", "conv1"])
    _conv(a, r, "flow.encoder.pre_lookahead_layer.conv2", f + ["encoder", "lookahead", "conv2"])
    for i in range(fl.num_blocks):
        _convert_conformer_block(a, r, f"flow.encoder.encoders.{i}", f + ["encoder", "blocks", i])
    _conv(a, r, "flow.encoder.up_layer.conv", f + ["encoder", "up_conv"])
    for i in range(fl.num_up_blocks):
        _convert_conformer_block(a, r, f"flow.encoder.up_encoders.{i}", f + ["encoder", "up_blocks", i])
    _ln(a, r, "flow.encoder.after_norm", f + ["encoder", "after_norm"])

    es = "flow.decoder.estimator"
    ep = f + ["estimator"]
    _lin(a, r, es + ".time_mlp.linear_1", ep + ["time_mlp", "lin1"])
    _lin(a, r, es + ".time_mlp.linear_2", ep + ["time_mlp", "lin2"])

    def resnet(base: str, path: List) -> None:
        _lin(a, r, base + ".mlp.1", path + ["mlp"])
        _conv(a, r, base + ".block1.block.0", path + ["block1", "conv"])
        _ln(a, r, base + ".block1.block.1", path + ["block1", "gn"])
        _conv(a, r, base + ".block2.block.0", path + ["block2", "conv"])
        _ln(a, r, base + ".block2.block.1", path + ["block2", "gn"])
        _conv(a, r, base + ".res_conv", path + ["res"])

    def tfs(base: str, path: List) -> None:
        for j in range(fl.dec_n_blocks):
            b = f"{base}.{j}"
            p = path + [j]
            _ln(a, r, b + ".norm1", p + ["norm1"])
            _lin(a, r, b + ".attn1.to_q", p + ["to_q"], bias=False)
            _lin(a, r, b + ".attn1.to_k", p + ["to_k"], bias=False)
            _lin(a, r, b + ".attn1.to_v", p + ["to_v"], bias=False)
            _lin(a, r, b + ".attn1.to_out.0", p + ["to_out"])
            _ln(a, r, b + ".norm3", p + ["norm3"])
            _lin(a, r, b + ".ff.net.0.proj", p + ["ff1"])
            _lin(a, r, b + ".ff.net.2", p + ["ff2"])

    resnet(es + ".down_blocks.0.0", ep + ["down", "resnet"])
    tfs(es + ".down_blocks.0.1", ep + ["down", "tf"])
    _conv(a, r, es + ".down_blocks.0.2", ep + ["down", "conv"])
    for mi in range(fl.dec_num_mid_blocks):
        resnet(es + f".mid_blocks.{mi}.0", ep + ["mid", mi, "resnet"])
        tfs(es + f".mid_blocks.{mi}.1", ep + ["mid", mi, "tf"])
    resnet(es + ".up_blocks.0.0", ep + ["up", "resnet"])
    tfs(es + ".up_blocks.0.1", ep + ["up", "tf"])
    _conv(a, r, es + ".up_blocks.0.2", ep + ["up", "conv"])
    _conv(a, r, es + ".final_block.block.0", ep + ["final", "conv"])
    _ln(a, r, es + ".final_block.block.1", ep + ["final", "gn"])
    _conv(a, r, es + ".final_proj", ep + ["proj"])


def _convert_hift(a: _Assigner, r: CheckpointReader, cfg: S3GenRefConfig) -> None:
    hf = cfg.hift
    m = ["mel2wav"]
    _conv(a, r, "mel2wav.conv_pre", m + ["conv_pre"])

    def resblock(base: str, path: List, n: int) -> None:
        for j in range(n):
            _conv(a, r, f"{base}.convs1.{j}", path + ["convs1", j])
            _conv(a, r, f"{base}.convs2.{j}", path + ["convs2", j])
            a.put(path + ["alpha1", j], r.take(f"{base}.activations1.{j}.alpha"))
            a.put(path + ["alpha2", j], r.take(f"{base}.activations2.{j}.alpha"))

    nk = len(hf.resblock_kernel_sizes)
    for i in range(len(hf.upsample_rates)):
        # ConvTranspose1d stores (in, out, k); ours is (k, in, out)
        a.put(m + ["ups", i, "w"], r.weight(f"mel2wav.ups.{i}"), transpose=(2, 0, 1))
        a.put(m + ["ups", i, "b"], r.take(f"mel2wav.ups.{i}.bias"))
        _conv(a, r, f"mel2wav.source_downs.{i}", m + ["source_downs", i])
        resblock(f"mel2wav.source_resblocks.{i}", m + ["source_resblocks", i],
                 len(hf.source_resblock_dilation_sizes[i]))
        for j in range(nk):
            resblock(f"mel2wav.resblocks.{i * nk + j}", m + ["resblocks", i * nk + j],
                     len(hf.resblock_dilation_sizes[j]))
    _conv(a, r, "mel2wav.conv_post", m + ["conv_post"])
    for slot, idx in enumerate((0, 2, 4, 6, 8)):
        _conv(a, r, f"mel2wav.f0_predictor.condnet.{idx}", m + ["f0", "convs", slot])
    _lin(a, r, "mel2wav.f0_predictor.classifier", m + ["f0", "cls"])
    _lin(a, r, "mel2wav.m_source.l_linear", m + ["m_source"])
    a.put(m + ["stft_window"], r.take("mel2wav.stft_window"))


def convert_s3gen_ref(raw: Dict[str, np.ndarray], params: Dict, cfg: S3GenRefConfig) -> Dict:
    """→ {"params", "missing", "unused", "mismatched"} (all lists sorted)."""
    r = CheckpointReader(raw)
    a = _Assigner(params)
    _convert_tokenizer(a, r, cfg)
    _convert_speaker(a, r, cfg)
    _convert_flow(a, r, cfg)
    _convert_hift(a, r, cfg)
    return {
        "params": a.params,
        "missing": sorted(r.missing),
        "unused": r.unused(),
        "mismatched": sorted(a.mismatched),
    }
