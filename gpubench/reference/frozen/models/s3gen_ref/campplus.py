"""CAMPPlus x-vector speaker encoder (torch counterpart of
``chatterbox_tpu/models/s3gen_ref/campplus.py``).

FCM conv2d head (frequency ÷ 8, strides on the frequency axis only) → TDNN
(k5, stride 2) → CAM-dense TDNN blocks (dense growth, context-attention
gates) with transit halvings → masked stats pooling (mean ‖ unbiased std) →
dense → the embedding. Every stage is masked on the valid frames, so a
right-padded batch gives each row's unpadded result. Batch norms run on
their running statistics. Activations take the weights' dtype at the first
conv (the input is cast down, as in the JAX package).
"""
from __future__ import annotations

from typing import Dict


from .config import CampPlusConfig

_SEG_LEN = 100  # CAM context segment pooling length


def campplus_param_tree(cfg: CampPlusConfig, init) -> Dict:
    """The JAX-layout tree, its leaves drawn by ``init`` with the JAX
    package's distributions (2-D conv weights HWIO, as the JAX tree holds
    them; the bridge makes them OIHW)."""
    mk = lambda *shape: init.dense(shape)  # noqa: E731

    def bn(c: int, affine: bool = True) -> Dict:
        p = {"mean": mk(c), "var": mk(c)}
        if affine:
            p["w"], p["b"] = mk(c), mk(c)
        return p

    m = cfg.m_channels
    head = {"conv1": {"w": mk(3, 3, 1, m)}, "bn1": bn(m), "conv2": {"w": mk(3, 3, m, m)},
            "bn2": bn(m)}
    for lname in ("layer1", "layer2"):
        blocks = []
        for bi in range(2):
            blk = {"conv1": {"w": mk(3, 3, m, m)}, "bn1": bn(m),
                   "conv2": {"w": mk(3, 3, m, m)}, "bn2": bn(m)}
            if bi == 0:  # stride-2 block: projection shortcut
                blk["shortcut"] = {"conv": {"w": mk(1, 1, m, m)}, "bn": bn(m)}
            blocks.append(blk)
        head[lname] = blocks

    ch = m * (cfg.feat_dim // 8)
    xv: Dict = {"tdnn": {"conv": {"w": mk(5, ch, cfg.init_channels)}, "bn": bn(cfg.init_channels)}}
    ch = cfg.init_channels
    bn_ch = cfg.bn_size * cfg.growth_rate
    for b_i, (nl, k) in enumerate(zip(cfg.num_layers, cfg.kernel_sizes)):
        layers = []
        for _ in range(nl):
            layers.append({
                "bn1": bn(ch),
                "linear1": {"w": mk(1, ch, bn_ch)},
                "bn2": bn(bn_ch),
                "cam_local": {"w": mk(k, bn_ch, cfg.growth_rate)},
                "cam_lin1": {"w": mk(1, bn_ch, bn_ch // 2), "b": mk(bn_ch // 2)},
                "cam_lin2": {"w": mk(1, bn_ch // 2, cfg.growth_rate), "b": mk(cfg.growth_rate)},
            })
            ch += cfg.growth_rate
        xv[f"block{b_i + 1}"] = layers
        xv[f"transit{b_i + 1}"] = {"bn": bn(ch), "conv": {"w": mk(1, ch, ch // 2)}}
        ch //= 2
    xv["out_bn"] = bn(ch)
    xv["dense"] = {"conv": {"w": mk(1, ch * 2, cfg.embedding_size)},
                   "bn": bn(cfg.embedding_size, affine=False)}
    return {"head": head, "xvector": xv}


