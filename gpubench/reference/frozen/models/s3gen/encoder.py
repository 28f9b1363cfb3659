"""S3Gen token encoder: speech tokens (25 Hz) → the mel-rate conditioning
track ``mu`` (50 Hz); torch counterpart of ``chatterbox_tpu/models/s3gen/encoder.py``.

A bidirectional pre-norm transformer (RMSNorm, RoPE, tanh-GELU MLP) over
[prompt tokens | generated tokens], then 2× upsampling (nearest repeat plus a
residual smoothing conv) and a projection to the mel bins. It computes in
the weights' dtype, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ...ops.conv import conv1d
from ...ops.nn import apply_rope, causal_attention, linear, rms_norm, rope_frequencies
from .config import S3GenConfig


def encoder_param_tree(cfg: S3GenConfig, init) -> Dict:
    D, L, Fd = cfg.enc_dim, cfg.enc_layers, cfg.enc_ffn
    return {
        "token_emb": init.dense((cfg.vocab_size + 1, D), 0.02),  # +1: pad id = vocab_size
        "layers": {
            "attn_norm": init.ones((L, D)),
            "mlp_norm": init.ones((L, D)),
            "wq": init.dense((L, D, D)),
            "wk": init.dense((L, D, D)),
            "wv": init.dense((L, D, D)),
            "wo": init.dense((L, D, D)),
            "w1": init.dense((L, D, Fd)),
            "w2": init.dense((L, Fd, D)),
        },
        "final_norm": init.ones((D,)),
        "up_conv": {"w": init.dense((3, D, D)), "b": init.zeros((D,))},
        "out_proj": {"w": init.dense((D, cfg.n_mels)), "b": init.zeros((cfg.n_mels,))},
    }


def bidirectional_block(h: torch.Tensor, lp: Dict, i: int, heads: int, mask: torch.Tensor,
                        cos: torch.Tensor, sin: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """Layer ``i`` of a pre-norm RoPE transformer stack (the S3Gen encoder's
    and S3Tok's): masked bidirectional attention, then a tanh-GELU MLP."""
    B, T, D = h.shape
    Dh = D // heads
    x = rms_norm(h, lp["attn_norm"][i])
    q = apply_rope(linear(x, lp["wq"][i]).reshape(B, T, heads, Dh), cos, sin, positions)
    k = apply_rope(linear(x, lp["wk"][i]).reshape(B, T, heads, Dh), cos, sin, positions)
    v = linear(x, lp["wv"][i]).reshape(B, T, heads, Dh)
    o = causal_attention(q, k, v, mask)
    h = h + linear(o.reshape(B, T, D), lp["wo"][i])
    x = rms_norm(h, lp["mlp_norm"][i])
    return h + linear(F.gelu(linear(x, lp["w1"][i]), approximate="tanh"), lp["w2"][i])


def encode_tokens(
    params: Dict,
    cfg: S3GenConfig,
    tokens: torch.Tensor,     # [B, T] (pad with cfg.vocab_size)
    valid: torch.Tensor,      # [B, T] bool
) -> torch.Tensor:
    """→ mu [B, 2T, n_mels] (mel-rate conditioning track)."""
    B, T = tokens.shape
    h = params["token_emb"][tokens.long()]
    cos, sin = rope_frequencies(cfg.enc_dim // cfg.enc_heads, T, device=h.device)
    positions = torch.arange(T, device=h.device).expand(B, T)
    mask = valid[:, None, :, None] & valid[:, None, None, :]  # [B, 1, T, T]
    for i in range(cfg.enc_layers):
        h = bidirectional_block(h, params["layers"], i, cfg.enc_heads, mask, cos, sin, positions)
    h = rms_norm(h, params["final_norm"])
    # zero pad positions so the smoothing conv can't bleed garbage inward
    h = torch.where(valid[:, :, None], h, 0.0)
    up = h.repeat_interleave(cfg.frames_per_token, dim=1)
    up = up + conv1d(up, params["up_conv"]["w"], params["up_conv"]["b"])
    return linear(up, params["out_proj"]["w"], params["out_proj"]["b"])
