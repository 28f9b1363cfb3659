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

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ...ops.conv import conv1d
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


def _bn(x: torch.Tensor, p: Dict, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm over the last axis, in float32. ``abs(var)``
    changes nothing for a checkpoint (variances are positive) and keeps a
    random-weight model finite."""
    y = (x.float() - p["mean"].float()) * torch.rsqrt(p["var"].float().abs() + eps)
    if "w" in p:
        y = y * p["w"].float() + p["b"].float()
    return y.to(x.dtype)


def _bn2d(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """x: [B, C, F, T], batch norm over C."""
    return _bn(x.movedim(1, -1), p).movedim(-1, 1)


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride_f: int = 1) -> torch.Tensor:
    """x: [B, Cin, F, T], w: OIHW [Cout, Cin, kF, kT]; torch-symmetric
    padding, stride on the frequency axis only."""
    kf, kt = w.shape[2], w.shape[3]
    return F.conv2d(x.to(w.dtype), w, None, (stride_f, 1), ((kf - 1) // 2, (kt - 1) // 2))


def _fcm_head(p: Dict, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, T, F] fbank → [B, T, m·(F/8)] through the 2-D conv head. Invalid
    time columns are zeroed before every conv, so the valid region sees the
    zero padding an unpadded run would."""
    col = valid[:, None, None, :]

    def z(h):
        return torch.where(col, h, 0.0)

    h = x.transpose(1, 2)[:, None]   # [B, 1, F, T]
    h = F.relu(_bn2d(_conv2d(z(h), p["conv1"]["w"]), p["bn1"]))
    for lname in ("layer1", "layer2"):
        for bi, blk in enumerate(p[lname]):
            stride = 2 if bi == 0 else 1
            h = z(h)
            out = F.relu(_bn2d(_conv2d(h, blk["conv1"]["w"], stride), blk["bn1"]))
            out = _bn2d(_conv2d(z(out), blk["conv2"]["w"]), blk["bn2"])
            if "shortcut" in blk:
                sc = _bn2d(_conv2d(h, blk["shortcut"]["conv"]["w"], stride), blk["shortcut"]["bn"])
            else:
                sc = h
            h = F.relu(out + sc)
    h = F.relu(_bn2d(_conv2d(z(h), p["conv2"]["w"], 2), p["bn2"]))
    B, C, F8, T = h.shape
    return h.reshape(B, C * F8, T).transpose(1, 2)   # channel-major, as torch's reshape


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over the valid steps. x: [B, T, C], valid: [B, T] → [B, 1, C]."""
    denom = valid.sum(dim=1).clamp_min(1)[:, None, None]
    return torch.where(valid[:, :, None], x, 0.0).sum(dim=1, keepdim=True) / denom


def _seg_pool(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked segment average pooling (100 steps, the last segment short),
    broadcast back to T."""
    B, T, C = x.shape
    n_seg = -(-T // _SEG_LEN)
    pad = n_seg * _SEG_LEN - T
    xs = F.pad(torch.where(valid[:, :, None], x, 0.0), (0, 0, 0, pad))
    vs = F.pad(valid.to(x.dtype), (0, pad))
    seg_sum = xs.reshape(B, n_seg, _SEG_LEN, C).sum(dim=2)
    seg_cnt = vs.reshape(B, n_seg, _SEG_LEN).sum(dim=2).clamp_min(1.0)
    seg = seg_sum / seg_cnt[:, :, None]
    return seg.repeat_interleave(_SEG_LEN, dim=1)[:, :T]


def _cam_layer(p: Dict, x: torch.Tensor, valid: torch.Tensor, dilation: int) -> torch.Tensor:
    y = conv1d(x, p["cam_local"]["w"], dilation=dilation, padding="SAME_TORCH")
    context = _masked_mean(x, valid) + _seg_pool(x, valid)
    context = F.relu(conv1d(context, p["cam_lin1"]["w"], p["cam_lin1"]["b"]))
    gate = torch.sigmoid(conv1d(context, p["cam_lin2"]["w"], p["cam_lin2"]["b"]))
    return y * gate


def campplus_embed(
    params: Dict,
    cfg: CampPlusConfig,
    fbank: torch.Tensor,               # [B, T, feat_dim] CMN'd kaldi fbank
    valid: Optional[torch.Tensor],     # [B, T] bool, or None for all valid
) -> torch.Tensor:
    """→ [B, embedding_size] speaker embedding."""
    B, T, _ = fbank.shape
    if valid is None:
        valid = torch.ones((B, T), dtype=torch.bool, device=fbank.device)
    fbank = torch.where(valid[:, :, None], fbank, 0.0)
    h = torch.where(valid[:, :, None], _fcm_head(params["head"], fbank, valid), 0.0)

    xv = params["xvector"]
    # TDNN k5 stride 2 (torch padding 2): floor((T + 4 - 5) / 2) + 1 frames
    h = conv1d(h, xv["tdnn"]["conv"]["w"], stride=2, padding="SAME_TORCH")
    h = F.relu(_bn(h, xv["tdnn"]["bn"]))
    valid = valid[:, ::2][:, : h.shape[1]]
    keep = valid[:, :, None]

    for b_i, (_, _, dil) in enumerate(zip(cfg.num_layers, cfg.kernel_sizes, cfg.dilations)):
        for layer in xv[f"block{b_i + 1}"]:
            z = torch.where(keep, F.relu(_bn(h, layer["bn1"])), 0.0)
            z = conv1d(z, layer["linear1"]["w"])
            z = torch.where(keep, F.relu(_bn(z, layer["bn2"])), 0.0)
            h = torch.cat([h, _cam_layer(layer, z, valid, dil)], dim=-1)   # dense growth
        t = xv[f"transit{b_i + 1}"]
        h = conv1d(torch.where(keep, F.relu(_bn(h, t["bn"])), 0.0), t["conv"]["w"])

    h = F.relu(_bn(h, xv["out_bn"]))
    # stats pooling: mean ‖ unbiased std over the valid frames
    n = valid.sum(dim=1).clamp_min(1)[:, None].to(h.dtype)
    mean = _masked_mean(h, valid)[:, 0]
    sq = _masked_mean((h - mean[:, None]).square(), valid)[:, 0]
    var = sq * n / (n - 1.0).clamp_min(1.0)
    stats = torch.cat([mean, var.clamp_min(1e-7).sqrt()], dim=-1)
    d = xv["dense"]
    return _bn(conv1d(stats[:, None], d["conv"]["w"]), d["bn"])[:, 0]
