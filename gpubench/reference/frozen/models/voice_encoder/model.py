"""VoiceEncoder: the utterance-level speaker embedding of T3's conditioning
(torch counterpart of ``chatterbox_tpu/models/voice_encoder/model.py``).

A GE2E LSTM speaker encoder: 40-bin log-mel → 3-layer LSTM(256) → linear →
relu → L2 norm. Windows of 160 frames at 50 % overlap are embedded, the
windows past the valid samples masked out, and the rest mean-pooled and
renormalised. The LSTM runs as ``torch.lstm`` (gate order i, f, g, o, as in
the JAX scan); the single JAX bias is ``bias_ih`` and ``bias_hh`` is zero.
On the card cuDNN packs the upcast weights (2.6 MB at full size) into its
own layout at every call, and warns once that it does.
Everything computes in float32: the JAX package's float32 mel promotes its
bf16 weights, so the port upcasts them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ...ops.spectral import log_mel_spectrogram


@dataclass(frozen=True)
class VoiceEncoderConfig:
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160
    n_mels: int = 40
    hidden: int = 256
    layers: int = 3
    embed_dim: int = 256
    window_frames: int = 160
    window_hop: int = 80

    @staticmethod
    def tiny() -> "VoiceEncoderConfig":
        return VoiceEncoderConfig(hidden=32, layers=1, embed_dim=32, window_frames=16, window_hop=8)


def voice_encoder_param_tree(cfg: VoiceEncoderConfig, init) -> Dict:
    """The JAX-layout tree, its leaves drawn by ``init``."""
    layers = []
    in_dim = cfg.n_mels
    for _ in range(cfg.layers):
        layers.append({"wx": init.dense((in_dim, 4 * cfg.hidden)),
                       "wh": init.dense((cfg.hidden, 4 * cfg.hidden)),
                       "b": init.zeros((4 * cfg.hidden,))})
        in_dim = cfg.hidden
    return {"lstm": layers, "proj": {"w": init.dense((cfg.hidden, cfg.embed_dim)),
                                     "b": init.zeros((cfg.embed_dim,))}}


def _embed_frames(params: Dict, cfg: VoiceEncoderConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [N, T, n_mels] → normalised embedding of the last step [N, embed_dim]."""
    flat = []
    for layer in params["lstm"]:
        flat += [layer["wx"].float(), layer["wh"].float(), layer["b"].float(),
                 torch.zeros_like(layer["b"], dtype=torch.float32)]
    h0 = mel.new_zeros((cfg.layers, mel.shape[0], cfg.hidden))
    hs, _, _ = torch.lstm(mel, (h0, h0), flat, True, cfg.layers, 0.0, False, False, True)
    emb = F.relu(F.linear(hs[:, -1], params["proj"]["w"].float(), params["proj"]["b"].float()))
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp_min(1e-6)


def voice_embed(
    params: Dict,
    cfg: VoiceEncoderConfig,
    wav_16k: torch.Tensor,
    wav_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, L] → [B, embed_dim] float32: windowed partial embeddings, mean,
    renormalised. ``wav_len`` masks the windows that start past the valid
    samples (a zero-padded clip would pull the mean toward silence)."""
    mel = log_mel_spectrogram(wav_16k.float(), cfg.sample_rate, cfg.n_fft, cfg.hop, cfg.n_mels)
    B, T, M = mel.shape
    W, Hp = cfg.window_frames, cfg.window_hop
    if T < W:
        mel = F.pad(mel, (0, 0, 0, W - T))
        T = W
    windows = mel.unfold(1, W, Hp).transpose(2, 3)   # [B, n_win, W, M]
    n_win = windows.shape[1]
    embs = _embed_frames(params, cfg, windows.reshape(B * n_win, W, M)).reshape(B, n_win, -1)
    if wav_len is not None:
        frame_len = wav_len.long() // cfg.hop
        win = torch.arange(n_win, device=mel.device)[None, :]
        keep = (win * Hp < (frame_len[:, None] - W // 2).clamp_min(1)) | (win == 0)
        w = keep[:, :, None].float()
        mean = (embs * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
    else:
        mean = embs.mean(dim=1)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True).clamp_min(1e-6)
