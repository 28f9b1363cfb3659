"""CFM estimator (causal-UNet ConditionalDecoder, matcha layout) and the
Euler/CFG solver — torch counterpart of the uncached path of
``chatterbox_tpu/models/s3gen_ref/decoder.py``.

Sinusoidal time embedding (scale 1000) → MLP; one down level [resnet →
transformer×n → conv k3], N mid levels, one up level with the skip concat;
final block + 1×1 projection. The transformer blocks' attention is the
flash-MHA kernel K2 (``ops/flash_mha.py``). The prompt cache and the
streaming solver (``pc``/``rc``/``cap`` in the JAX package) are not ported
yet (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.conv import conv1d
from ...ops.flash_mha import flash_mha
from ...ops.nn import layer_norm, linear
from .config import FlowRefConfig

# fixed noise-buffer length (frames): the CFM initial noise at frame t is the
# same whatever the chunk length, so full-overlap re-synthesis of accumulated
# tokens reproduces earlier frames (seam stability)
_NOISE_FRAMES = 2048


def init_estimator_params(init, cfg: FlowRefConfig) -> Dict:
    """JAX-layout tree (convert with ``convert.convert_params``)."""
    ch = cfg.dec_channels[0]
    tdim = ch * 4
    inner = cfg.dec_num_heads * cfg.dec_attention_head_dim
    mk = lambda *shape: init.dense(shape)  # noqa: E731

    def mk_resnet(cin: int):
        return {
            "mlp": {"w": mk(tdim, ch), "b": mk(ch)},
            "block1": {"conv": {"w": mk(3, cin, ch), "b": mk(ch)}, "gn": {"w": mk(ch), "b": mk(ch)}},
            "block2": {"conv": {"w": mk(3, ch, ch), "b": mk(ch)}, "gn": {"w": mk(ch), "b": mk(ch)}},
            "res": {"w": mk(1, cin, ch), "b": mk(ch)},
        }

    def mk_tf():
        return {
            "norm1": {"w": mk(ch), "b": mk(ch)},
            "to_q": {"w": mk(ch, inner)},
            "to_k": {"w": mk(ch, inner)},
            "to_v": {"w": mk(ch, inner)},
            "to_out": {"w": mk(inner, ch), "b": mk(ch)},
            "norm3": {"w": mk(ch), "b": mk(ch)},
            "ff1": {"w": mk(ch, 4 * ch), "b": mk(4 * ch)},
            "ff2": {"w": mk(4 * ch, ch), "b": mk(ch)},
        }

    def mk_level(cin: int):
        return {
            "resnet": mk_resnet(cin),
            "tf": [mk_tf() for _ in range(cfg.dec_n_blocks)],
            "conv": {"w": mk(3, ch, ch), "b": mk(ch)},
        }

    return {
        "time_mlp": {
            "lin1": {"w": mk(cfg.dec_time_dim, tdim), "b": mk(tdim)},
            "lin2": {"w": mk(tdim, tdim), "b": mk(tdim)},
        },
        "down": mk_level(cfg.dec_in_channels),
        "mid": [
            {"resnet": mk_resnet(ch), "tf": [mk_tf() for _ in range(cfg.dec_n_blocks)]}
            for _ in range(cfg.dec_num_mid_blocks)
        ],
        "up": mk_level(2 * ch),
        "final": {"conv": {"w": mk(3, ch, ch), "b": mk(ch)}, "gn": {"w": mk(ch), "b": mk(ch)}},
        "proj": {"w": mk(1, ch, cfg.output_size), "b": mk(cfg.output_size)},
    }


def _group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int = 8,
                eps: float = 1e-5, valid: torch.Tensor | None = None) -> torch.Tensor:
    """torch GroupNorm over [B, T, C], statistics over the valid frames only."""
    B, T, C = x.shape
    g = x.float().reshape(B, T, groups, C // groups)
    if valid is None:
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    else:
        vm = valid[:, :, None, None].float()
        denom = vm.sum(dim=1, keepdim=True).clamp_min(1.0) * (C // groups)
        mean = (g * vm).sum(dim=(1, 3), keepdim=True) / denom
        var = ((g - mean).square() * vm).sum(dim=(1, 3), keepdim=True) / denom
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(B, T, C).to(x.dtype) * w + b


def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x.float())).to(x.dtype)


def _time_embedding(p: Dict, cfg: FlowRefConfig, t: torch.Tensor) -> torch.Tensor:
    """t: [B] in [0, 1] → [B, 4*ch] (sinusoid scale 1000, matcha convention)."""
    half = cfg.dec_time_dim // 2
    freq = torch.exp(torch.as_tensor(np.arange(half) * -(np.log(10000.0) / (half - 1)),
                                     dtype=torch.float32, device=t.device))
    ang = 1000.0 * t.float()[:, None] * freq[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    h = F.silu(linear(emb, p["lin1"]["w"], p["lin1"]["b"]))
    return linear(h, p["lin2"]["w"], p["lin2"]["b"])


def _resnet(p: Dict, x: torch.Tensor, mask: torch.Tensor, valid: torch.Tensor,
            temb: torch.Tensor) -> torch.Tensor:
    xm = x * mask
    h = conv1d(xm, p["block1"]["conv"]["w"], p["block1"]["conv"]["b"], padding="SAME_TORCH")
    h = _mish(_group_norm(h, p["block1"]["gn"]["w"], p["block1"]["gn"]["b"], valid=valid))
    h = h + linear(_mish(temb), p["mlp"]["w"], p["mlp"]["b"])[:, None]
    h = conv1d(h * mask, p["block2"]["conv"]["w"], p["block2"]["conv"]["b"], padding="SAME_TORCH")
    h = _mish(_group_norm(h, p["block2"]["gn"]["w"], p["block2"]["gn"]["b"], valid=valid))
    return h + conv1d(xm, p["res"]["w"], p["res"]["b"])


def _tf_block(p: Dict, cfg: FlowRefConfig, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """DiT-style block without positional encoding; its attention is K2."""
    B, T, C = x.shape
    H, dh = cfg.dec_num_heads, cfg.dec_attention_head_dim
    h = layer_norm(x, p["norm1"]["w"], p["norm1"]["b"])
    heads = lambda w: linear(h, w).reshape(B, T, H, dh).transpose(1, 2).contiguous()  # noqa: E731
    o = flash_mha(heads(p["to_q"]["w"]), heads(p["to_k"]["w"]), heads(p["to_v"]["w"]),
                  valid.contiguous(), scale=float(1.0 / np.sqrt(dh)))
    out = o.transpose(1, 2).reshape(B, T, H * dh)
    x = x + linear(out.to(x.dtype), p["to_out"]["w"], p["to_out"]["b"])
    h = layer_norm(x, p["norm3"]["w"], p["norm3"]["b"])
    h = linear(F.gelu(linear(h, p["ff1"]["w"], p["ff1"]["b"]), approximate="tanh"),
               p["ff2"]["w"], p["ff2"]["b"])
    return x + h


def estimator_forward(
    params: Dict,
    cfg: FlowRefConfig,
    x: torch.Tensor,      # [B, T, M] current sample
    mu: torch.Tensor,     # [B, T, M] encoder output
    spk: torch.Tensor,    # [B, M'] projected speaker embedding
    cond: torch.Tensor,   # [B, T, M] prompt-mel conditioning track
    t: torch.Tensor,      # [B] flow time
    valid: torch.Tensor,  # [B, T] bool
) -> torch.Tensor:
    """One vector-field evaluation → [B, T, M]."""
    B, T, _ = x.shape
    mask = valid[:, :, None].to(x.dtype)
    temb = _time_embedding(params["time_mlp"], cfg, t)
    spk_track = spk[:, None, :].expand(B, T, spk.shape[-1]).to(x.dtype)
    h = torch.cat([x, mu, spk_track, cond], dim=-1)

    def level(h, p_level, with_conv: bool, skip_in=None):
        rn_in = h if skip_in is None else torch.cat([h, skip_in], dim=-1)
        h = _resnet(p_level["resnet"], rn_in, mask, valid, temb)
        for tf in p_level["tf"]:
            h = _tf_block(tf, cfg, h * mask, valid)
        if with_conv:
            out = conv1d(h * mask, p_level["conv"]["w"], p_level["conv"]["b"], padding="SAME_TORCH")
            return out, h
        return h, h

    h, skip = level(h, params["down"], True)
    for m in params["mid"]:
        h, _ = level(h, m, False)
    h, _ = level(h, params["up"], True, skip_in=skip)
    f = params["final"]
    h = conv1d(h * mask, f["conv"]["w"], f["conv"]["b"], padding="SAME_TORCH")
    h = _mish(_group_norm(h, f["gn"]["w"], f["gn"]["b"], valid=valid))
    return conv1d(h * mask, params["proj"]["w"], params["proj"]["b"]) * mask


def _t_span(cfg: FlowRefConfig) -> np.ndarray:
    steps = np.arange(cfg.n_timesteps + 1, dtype=np.float64) / cfg.n_timesteps
    return (1.0 - np.cos(steps * 0.5 * np.pi)).astype(np.float32)


def cfm_noise_frames(n_frames: int) -> int:
    """Frames of initial noise to draw for a ``n_frames`` solve."""
    return max(_NOISE_FRAMES, n_frames)


def cfm_generate(
    params: Dict,
    cfg: FlowRefConfig,
    noise: torch.Tensor,  # [B, ≥T, M] float32 initial noise (frame-stable buffer)
    mu: torch.Tensor,     # [B, T, M]
    spk: torch.Tensor,    # [B, 80]
    cond: torch.Tensor,   # [B, T, M]
    valid: torch.Tensor,  # [B, T]
) -> torch.Tensor:
    """Cosine-warped Euler CFM sampling with CFG (inference_cfg_rate); the
    cond and uncond lanes ride one estimator call per step."""
    B, T, _ = mu.shape
    x = noise[:, :T].float()
    t_span = _t_span(cfg)
    w = cfg.inference_cfg_rate
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    spk2 = torch.cat([spk, torch.zeros_like(spk)])
    cond2 = torch.cat([cond, torch.zeros_like(cond)])
    valid2 = torch.cat([valid, valid])
    for t_i, dt in zip(t_span[:-1], t_span[1:] - t_span[:-1]):
        t = torch.full((2 * B,), float(t_i), dtype=torch.float32, device=mu.device)
        x2 = torch.cat([x, x]).to(mu.dtype)
        v = estimator_forward(params, cfg, x2, mu2, spk2, cond2, t, valid2).float()
        vc, vu = v[:B], v[B:]
        x = x + np.float32(dt) * ((1.0 + w) * vc - w * vu)
    return x.to(mu.dtype)
