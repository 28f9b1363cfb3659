"""S3Tok: 16 kHz speech → 25 Hz semantic tokens (codebook 6561 = 3^8), the
DiT architecture's speech tokenizer (torch counterpart of
``chatterbox_tpu/models/s3tok/model.py``).

128-bin log-mel (hop 10 ms, 100 fps) → two stride-2 convs with tanh-GELU
(→ 25 fps) → bidirectional pre-norm RoPE transformer blocks → 8-dim
projection → finite scalar quantization with 3 levels per dim: the token id
is the base-3 digit string. Computes in the weights' dtype, as in the JAX
package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ...ops.conv import conv1d
from ...ops.nn import linear, rms_norm, rope_frequencies
from ...ops.spectral import log_mel_spectrogram
from ..s3gen.encoder import bidirectional_block

S3_SR = 16000


@dataclass(frozen=True)
class S3TokConfig:
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160           # 100 fps
    n_mels: int = 128
    dim: int = 256
    layers: int = 4
    heads: int = 4
    ffn: int = 1024
    fsq_dims: int = 8
    fsq_levels: int = 3      # 3^8 = 6561 codes
    token_rate: int = 25

    @staticmethod
    def tiny() -> "S3TokConfig":
        return S3TokConfig(dim=32, layers=1, heads=2, ffn=64)


def s3tok_param_tree(cfg: S3TokConfig, init) -> Dict:
    """The JAX-layout tree of ``init_s3tok_params``, drawn by ``init``."""
    D, L, Fd = cfg.dim, cfg.layers, cfg.ffn
    return {
        "down1": {"w": init.dense((5, cfg.n_mels, D)), "b": init.zeros((D,))},
        "down2": {"w": init.dense((5, D, D)), "b": init.zeros((D,))},
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
        "fsq_proj": {"w": init.dense((D, cfg.fsq_dims)), "b": init.zeros((cfg.fsq_dims,))},
    }


def s3tok_fsq(params: Dict, cfg: S3TokConfig, wav_16k: torch.Tensor,
              wav_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantizer's input: → (tanh(projection) [B, T25, fsq_dims] in the
    weights' dtype, the valid frames [B, T25])."""
    mel = log_mel_spectrogram(wav_16k, cfg.sample_rate, cfg.n_fft, cfg.hop, cfg.n_mels)
    h = F.gelu(conv1d(mel, params["down1"]["w"], params["down1"]["b"], stride=2),
               approximate="tanh")
    h = F.gelu(conv1d(h, params["down2"]["w"], params["down2"]["b"], stride=2),
               approximate="tanh")
    B, T, _ = h.shape
    cos, sin = rope_frequencies(cfg.dim // cfg.heads, T, device=h.device)
    positions = torch.arange(T, device=h.device).expand(B, T)
    valid = torch.arange(T, device=h.device)[None, :] < (wav_len.long() // (cfg.hop * 4))[:, None]
    mask = valid[:, None, :, None] & valid[:, None, None, :]
    for i in range(cfg.layers):
        h = bidirectional_block(h, params["layers"], i, cfg.heads, mask, cos, sin, positions)
    h = rms_norm(h, params["final_norm"])
    return torch.tanh(linear(h, params["fsq_proj"]["w"], params["fsq_proj"]["b"])), valid


def s3tok_tokenize(params: Dict, cfg: S3TokConfig, wav_16k: torch.Tensor,
                   wav_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] 16 kHz audio and its valid samples → (tokens [B, T25] int64,
    0 past each row's length; token_len [B]). FSQ: round tanh to
    {-1, 0, 1} (half to even, as ``jnp.round``), read as base-3 digits."""
    z, valid = s3tok_fsq(params, cfg, wav_16k, wav_len)
    digits = torch.round(z).long() + 1  # {0, 1, 2}
    powers = cfg.fsq_levels ** torch.arange(cfg.fsq_dims, device=z.device)
    tokens = torch.where(valid, (digits * powers).sum(-1), 0)
    return tokens, wav_len.long() // (cfg.hop * 4)


def drop_invalid_tokens(tokens: torch.Tensor, vocab_size: int = 6561) -> torch.Tensor:
    """Boolean mask of in-codebook tokens (the caller compacts)."""
    return tokens < vocab_size
