"""HiFT-style vocoder of the DiT architecture: mel (50 Hz) → 24 kHz waveform
(torch counterpart of ``chatterbox_tpu/models/s3gen/vocoder.py``).

An F0 predictor drives a harmonic-plus-noise source; the generator upsamples
the mel through transposed-conv stages (8·5·3), injecting the source through
strided convs at each rate, and ends in an ISTFT head (n_fft 16, hop 4,
symmetric Hann window) so a 50 Hz frame gives 480 samples. The source's noise
is an input, and callers pass a cached excitation prefix that overrides the
regenerated one, so a re-synthesised prefix is sample-exact.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.conv import conv1d, conv_transpose1d
from ...ops.spectral import istft
from .config import S3GenConfig


def vocoder_param_tree(cfg: S3GenConfig, init) -> Dict:
    C, M = cfg.voc_channels, cfg.n_mels

    def conv(k, cin, cout, scale=None):
        return {"w": init.dense((k, cin, cout), scale), "b": init.zeros((cout,))}

    stages = []
    ch = C
    for i, (r, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        ch_out = C // (2 ** (i + 1))
        stages.append({
            "up": conv(k, ch, ch_out),       # transposed conv
            "src": conv(7, 1, ch_out),       # source injection at this stage's rate
            "res": [[{"c1": conv(rk, ch_out, ch_out), "c2": conv(rk, ch_out, ch_out)}
                     for _ in cfg.resblock_dilations] for rk in cfg.resblock_kernels],
        })
        ch = ch_out
    return {
        "f0p": {"c1": conv(5, M, 256), "c2": conv(5, 256, 256), "c3": conv(5, 256, 1)},
        "source": {"harm_mix": conv(1, cfg.num_harmonics + 1, 1)},
        "pre": conv(7, M, C),
        "stages": stages,
        # small init: the ISTFT head exponentiates magnitudes, so start quiet
        "post": conv(7, ch, cfg.istft_n_fft + 2, 1e-2),
    }


def predict_f0(params: Dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, M] → f0 [B, T] in Hz (non-negative), in the weights' dtype."""
    p = params["f0p"]
    h = torch.relu(conv1d(mel, p["c1"]["w"], p["c1"]["b"]))
    h = torch.relu(conv1d(h, p["c2"]["w"], p["c2"]["b"]))
    f0 = F.softplus(conv1d(h, p["c3"]["w"], p["c3"]["b"]))
    return f0[..., 0] * 100.0  # softplus units → Hz scale


def make_source(params: Dict, cfg: S3GenConfig, f0: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
    """Harmonic-plus-noise excitation at the sample rate → [B, T·hop].
    ``noise`` [B, ≥T·hop] float32 standard normal. The phase sums f0/sr in
    f0's dtype, as the JAX package does."""
    f0_up = f0.repeat_interleave(cfg.hop, dim=1)  # [B, L]
    phase = 2.0 * math.pi * torch.cumsum(f0_up / cfg.sample_rate, dim=1)
    k = torch.arange(1, cfg.num_harmonics + 1, dtype=torch.float32, device=f0.device)
    harmonics = torch.sin(phase[:, :, None] * k)  # [B, L, H] float32
    voiced = (f0_up > 10.0)[:, :, None]
    n = noise[:, : f0_up.shape[1], None].float()
    exc = torch.cat([torch.where(voiced, 0.1 * harmonics, 0.0),
                     torch.where(voiced, 0.003, 0.1) * n], dim=-1)
    mix = params["source"]["harm_mix"]
    return torch.tanh(conv1d(exc, mix["w"], mix["b"]))[..., 0]


def _resblock(x: torch.Tensor, block, dilations) -> torch.Tensor:
    for unit, d in zip(block, dilations):
        h = conv1d(F.leaky_relu(x, 0.1), unit["c1"]["w"], unit["c1"]["b"], dilation=d)
        x = x + conv1d(F.leaky_relu(h, 0.1), unit["c2"]["w"], unit["c2"]["b"])
    return x


def vocode(params: Dict, cfg: S3GenConfig, mel: torch.Tensor,
           source: torch.Tensor) -> torch.Tensor:
    """mel [B, T, M] and the excitation [B, T·hop] → waveform [B, T·hop],
    clipped to ±1."""
    T = mel.shape[1]
    x = conv1d(mel, params["pre"]["w"], params["pre"]["b"])
    src = source[:, :, None]
    rate = 1
    for stage, r in zip(params["stages"], cfg.upsample_rates):
        x = conv_transpose1d(F.leaky_relu(x, 0.1), stage["up"]["w"], stage["up"]["b"], stride=r)
        rate *= r
        # pool the sample-rate source down to this stage's frame rate
        s = conv1d(src, stage["src"]["w"], stage["src"]["b"], stride=cfg.hop // rate)
        x = x + s[:, : x.shape[1]]
        acc = None
        for block in stage["res"]:
            y = _resblock(x, block, cfg.resblock_dilations)
            acc = y if acc is None else acc + y
        x = acc / len(stage["res"])
    spec_params = conv1d(F.leaky_relu(x, 0.1), params["post"]["w"], params["post"]["b"])
    n_bins = cfg.istft_n_fft // 2 + 1
    log_mag = spec_params[..., :n_bins].clamp(-10.0, 3.0)
    phase = spec_params[..., n_bins: 2 * n_bins]
    spec = torch.exp(log_mag) * torch.exp(1j * phase.float())
    # np.hanning: the symmetric window (torch.hann_window is periodic)
    win = torch.from_numpy(np.hanning(cfg.istft_n_fft).astype(np.float32)).to(mel.device)
    wav = istft(spec, cfg.istft_n_fft, cfg.istft_hop, win, center=False)
    return wav[:, : T * cfg.hop].clamp(-1.0, 1.0)
