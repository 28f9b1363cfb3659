"""S3Gen configuration of the DiT architecture (a copy of
``chatterbox_tpu/models/s3gen/config.py``).

S3Gen converts 25 Hz speech tokens to a 24 kHz waveform, conditioned on a
reference voice (prompt tokens + prompt mel + speaker x-vector), in three
stages:

  token encoder (25 Hz → 50 Hz features)
  → conditional flow matching (Euler ODE → 80-bin mel at 50 Hz)
  → vocoder (NSF source-filter + upsampling convs + ISTFT head → 24 kHz).

The estimator is a DiT-style transformer with AdaLN-zero time conditioning,
in place of the reference architecture's UNet; it needs its own weights.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class S3GenConfig:
    sample_rate: int = 24000
    token_rate: int = 25
    mel_rate: int = 50            # 2 mel frames per token
    n_mels: int = 80
    n_fft: int = 1920
    hop: int = 480                # sample_rate / mel_rate

    # token vocabulary (shared with T3 / S3Tokenizer)
    vocab_size: int = 6561

    # encoder (token → mu)
    enc_dim: int = 512
    enc_layers: int = 6
    enc_heads: int = 8
    enc_ffn: int = 2048

    # flow-matching estimator (DiT)
    dit_dim: int = 512
    dit_layers: int = 8
    dit_heads: int = 8
    dit_ffn: int = 2048
    cfm_steps: int = 10
    sigma_min: float = 1e-6
    # classifier-free guidance inside the flow ODE; 0 disables the second
    # estimator pass
    cfm_cfg_rate: float = 0.7

    # speaker embedding
    spk_dim: int = 192

    # vocoder
    voc_channels: int = 512
    upsample_rates: tuple = (8, 5, 3)
    upsample_kernels: tuple = (16, 11, 7)
    resblock_kernels: tuple = (3, 7, 11)
    resblock_dilations: tuple = (1, 3, 5)
    istft_n_fft: int = 16
    istft_hop: int = 4
    num_harmonics: int = 8

    # prompt budget (reference caps: 10 s of 24 kHz mel, 6 s of tokens)
    max_prompt_tokens: int = 150
    max_prompt_mel: int = 300

    @property
    def samples_per_token(self) -> int:
        return (self.mel_rate // self.token_rate) * self.hop  # 960

    @property
    def frames_per_token(self) -> int:
        return self.mel_rate // self.token_rate  # 2

    @staticmethod
    def tiny() -> "S3GenConfig":
        return S3GenConfig(
            enc_dim=32,
            enc_layers=2,
            enc_heads=2,
            enc_ffn=64,
            dit_dim=32,
            dit_layers=2,
            dit_heads=2,
            dit_ffn=64,
            cfm_steps=2,
            voc_channels=16,
            max_prompt_tokens=8,
            max_prompt_mel=16,
        )

    def with_(self, **kw) -> "S3GenConfig":
        return replace(self, **kw)
