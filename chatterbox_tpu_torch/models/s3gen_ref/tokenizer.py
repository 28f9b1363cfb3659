"""S3TokenizerV2: whisper-style encoder + FSQ quantizer (25 Hz, 3^8 codes);
torch counterpart of ``chatterbox_tpu/models/s3gen_ref/tokenizer.py``.

whisper 128-mel (100 Hz) → conv1 (k3, s2, gelu) → conv2 (k3, s2, gelu) →
+ the sinusoidal positional table (a checkpoint buffer) → pre-norm
transformer (q and v biased, k not) → FSQ: linear(D → 8), tanh, × 0.999,
round half to even → digits {0, 1, 2} → code = Σ digit · 3^d. Masked
throughout, so a right-padded batch tokenizes each valid prefix as alone.
The input is cast to the weights' dtype; scores, softmax and the FSQ run in
float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.conv import conv1d
from ...ops.nn import NEG_INF, layer_norm, linear
from .config import S3TokRefConfig
from .features import whisper_log_mel

# tanh outputs are scaled by (1 - 1e-3) before rounding so the ±1 boundaries
# cannot tie
_FSQ_TANH_SCALE = 1.0 - 1e-3


def _sinusoid_table(n_ctx: int, d: int) -> np.ndarray:
    """Whisper's sinusoidal positional embedding (stored in the checkpoint)."""
    inv = np.exp(-np.log(10000.0) / (d // 2 - 1) * np.arange(d // 2))
    t = np.arange(n_ctx)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def s3tok_ref_param_tree(cfg: S3TokRefConfig, init) -> Dict:
    """The JAX-layout tree, its leaves drawn by ``init`` with the JAX
    package's distributions; the sinusoid table as the checkpoint stores it."""
    mk = lambda *shape: init.dense(shape)  # noqa: E731
    D = cfg.n_state
    blocks = [{
        "attn": {
            "q": {"w": mk(D, D), "b": mk(D)},
            "k": {"w": mk(D, D)},
            "v": {"w": mk(D, D), "b": mk(D)},
            "out": {"w": mk(D, D), "b": mk(D)},
        },
        "attn_ln": {"w": mk(D), "b": mk(D)},
        "mlp1": {"w": mk(D, 4 * D), "b": mk(4 * D)},
        "mlp2": {"w": mk(4 * D, D), "b": mk(D)},
        "mlp_ln": {"w": mk(D), "b": mk(D)},
    } for _ in range(cfg.n_layer)]
    return {
        "conv1": {"w": mk(3, cfg.n_mels, D), "b": mk(D)},
        "conv2": {"w": mk(3, D, D), "b": mk(D)},
        "pos": torch.from_numpy(_sinusoid_table(cfg.n_audio_ctx, D)),
        "blocks": blocks,
        "fsq": {"w": mk(D, cfg.fsq_dim), "b": mk(cfg.fsq_dim)},
    }


def _attention(p: Dict, cfg: S3TokRefConfig, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    B, T, D = x.shape
    H = cfg.n_head
    q = linear(x, p["q"]["w"], p["q"]["b"]).reshape(B, T, H, D // H)
    k = linear(x, p["k"]["w"]).reshape(B, T, H, D // H)
    v = linear(x, p["v"]["w"], p["v"]["b"]).reshape(B, T, H, D // H)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D // H) ** -0.5
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return linear(out.reshape(B, T, D).to(x.dtype), p["out"]["w"], p["out"]["b"])


def s3tok_ref_encode(
    params: Dict,
    cfg: S3TokRefConfig,
    wav16: torch.Tensor,   # [B, L] 16 kHz, right-padded
    lens: torch.Tensor,    # [B] valid sample counts
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder up to the FSQ's input → (z [B, min(L//640, table),
    fsq_dim] float32, valid token counts [B])."""
    mel, n_mel = whisper_log_mel(wav16, lens)                    # [B, Tm, 128] @ 100 Hz
    gelu = lambda h: F.gelu(h, approximate="tanh")  # noqa: E731  (jax.nn.gelu)
    x = gelu(conv1d(mel, params["conv1"]["w"], params["conv1"]["b"], stride=2,
                    padding="SAME_TORCH"))
    x = gelu(conv1d(x, params["conv2"]["w"], params["conv2"]["b"], stride=2,
                    padding="SAME_TORCH"))
    # audio past the positional table cannot be represented: clip to it
    cap = params["pos"].shape[0]
    x = x[:, :cap]
    T = x.shape[1]
    n_tok = (n_mel // 4).clamp_max(cap)
    valid = torch.arange(T, device=x.device)[None, :] < n_tok[:, None]
    x = torch.where(valid[:, :, None], x, 0.0) + params["pos"][:T][None].to(x.dtype)
    for blk in params["blocks"]:
        h = layer_norm(x, blk["attn_ln"]["w"], blk["attn_ln"]["b"])
        x = x + _attention(blk["attn"], cfg, h, valid)
        h = layer_norm(x, blk["mlp_ln"]["w"], blk["mlp_ln"]["b"])
        x = x + linear(gelu(linear(h, blk["mlp1"]["w"], blk["mlp1"]["b"])),
                       blk["mlp2"]["w"], blk["mlp2"]["b"])
    return linear(x, params["fsq"]["w"], params["fsq"]["b"]).float(), n_tok


def fsq_digits(z: torch.Tensor) -> torch.Tensor:
    """FSQ input → digits {0, 1, 2}, rounded in float32 (a bf16 tanh near
    ±0.5 could flip a digit), half to even."""
    return torch.round(torch.tanh(z) * _FSQ_TANH_SCALE) + 1.0


def s3tok_ref_tokenize(
    params: Dict,
    cfg: S3TokRefConfig,
    wav16: torch.Tensor,   # [B, L] 16 kHz, right-padded
    lens: torch.Tensor,    # [B] valid sample counts
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens [B, min(L//640, table)] int64, valid token counts [B])."""
    z, n_tok = s3tok_ref_encode(params, cfg, wav16, lens)
    powers = torch.tensor([float(cfg.fsq_levels ** d) for d in range(cfg.fsq_dim)],
                          device=z.device)
    codes = (fsq_digits(z) * powers).sum(-1).long()
    valid = torch.arange(z.shape[1], device=z.device)[None, :] < n_tok[:, None]
    return torch.where(valid, codes, 0), n_tok
