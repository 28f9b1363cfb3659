"""Feature front ends of the S3Gen ref stack (torch counterpart of
``chatterbox_tpu/models/s3gen_ref/features.py``).

Three extractors, batch and valid-length masked so a padded batch gives its
valid prefix's features:

* ``hifigan_log_mel``: 24 kHz HiFiGAN mel (n_fft 1920, hop 480, 80 slaney
  bins, magnitude, natural log, 1e-5 floor, reflect-padded center=False
  frames), the flow decoder's prompt mel.
* ``whisper_log_mel``: 16 kHz whisper front end (n_fft 400, hop 160, 128
  bins, power, log10, clamp to the valid frames' max − 8, (x + 4) / 4, the
  final frame dropped), the S3TokenizerV2 input.
* ``kaldi_fbank``: torchaudio-kaldi 80-bin fbank (snip-edges framing,
  per-frame DC removal, pre-emphasis 0.97 with the first sample duplicated,
  povey window, FFT padded to 512, Nyquist bank zeroed, natural log, masked
  CMN), the CAMPPlus input.

Frames come from ``unfold`` and an explicit ``torch.fft.rfft``: ``torch.stft``'s
padding and window conventions differ from each of these.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.spectral import mel_matrix

_KALDI_EPS = 1.1920928955078125e-07  # torchaudio.compliance.kaldi.EPSILON


def _hann_periodic(n: int, device) -> torch.Tensor:
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)
    return torch.from_numpy(w).to(device)


def _mask_wav(wav: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(wav.shape[1], device=wav.device)[None, :]
    return torch.where(idx < lens[:, None], wav, 0.0)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]


def reflect_tail(wav: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Fill the padding past each row's valid length with the reflection of
    its tail: sample i ≥ len reads 2·len − 2 − i (librosa/torch "reflect"),
    so a frame that crosses the valid end sees what it would on the
    true-length, reflect-padded waveform."""
    idx = torch.arange(wav.shape[1], device=wav.device)[None, :]
    refl = (2 * lens.long()[:, None] - 2 - idx).clamp(0, wav.shape[1] - 1)
    return torch.where(idx < lens[:, None], wav, torch.gather(wav, 1, refl))


def hifigan_log_mel(wav24: torch.Tensor) -> torch.Tensor:
    """[B, L] 24 kHz → [B, L//480, 80] natural-log mel (floor 1e-5)."""
    n_fft, hop, n_mels = 1920, 480, 80
    x = _reflect_pad(wav24.float(), (n_fft - hop) // 2)
    frames = x.unfold(-1, n_fft, hop) * _hann_periodic(n_fft, x.device)
    mag = torch.fft.rfft(frames, n=n_fft, dim=-1).abs()
    return torch.log((mag @ mel_matrix(24000, n_fft, n_mels, 0.0, 8000.0, x.device).T)
                     .clamp_min(1e-5))


def whisper_log_mel(wav16: torch.Tensor, lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] 16 kHz → ([B, L//160, 128], valid frame counts). Padded frames
    are zeroed and left out of the max, so tokens do not depend on padding."""
    n_fft, hop, n_mels = 400, 160, 128
    x = _reflect_pad(_mask_wav(wav16.float(), lens), n_fft // 2)
    n_out = wav16.shape[1] // hop  # whisper drops the last of the 1 + L//160 frames
    frames = x.unfold(-1, n_fft, hop)[:, :n_out] * _hann_periodic(n_fft, x.device)
    power = torch.fft.rfft(frames, n=n_fft, dim=-1).abs().square()
    mel = power @ mel_matrix(16000, n_fft, n_mels, 0.0, 8000.0, x.device).T
    log_spec = torch.log10(mel.clamp_min(1e-10))
    n_frames = torch.minimum(lens.long() // hop, torch.tensor(n_out, device=lens.device))
    valid = (torch.arange(n_out, device=x.device)[None, :] < n_frames[:, None])[:, :, None]
    vmax = torch.where(valid, log_spec, -torch.inf).amax(dim=(1, 2), keepdim=True)
    log_spec = (torch.maximum(log_spec, vmax - 8.0) + 4.0) / 4.0
    return torch.where(valid, log_spec, 0.0), n_frames


@lru_cache(maxsize=2)
def _kaldi_mel_banks(n_bins: int, padded: int, sr: int, low: float, high: float) -> np.ndarray:
    """Kaldi mel filterbank [n_bins, padded//2+1]: triangles in the mel
    domain, no area normalisation, the Nyquist bin excluded."""

    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    mel_low, mel_high = mel(low), mel(high)
    mel_delta = (mel_high - mel_low) / (n_bins + 1)
    bin_mels = mel(sr / padded * np.arange(padded // 2 + 1))
    banks = np.zeros((n_bins, padded // 2 + 1))
    for i in range(n_bins):
        left, center, right = (mel_low + d * mel_delta for d in (i, i + 1, i + 2))
        up = (bin_mels - left) / (center - left)
        down = (right - bin_mels) / (right - center)
        banks[i] = np.maximum(0.0, np.minimum(up, down))
    banks[:, -1] = 0.0
    return banks.astype(np.float32)


def kaldi_fbank(wav16: torch.Tensor, lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] 16 kHz → ([B, 1+(L-400)//160, 80] CMN'd log fbank, valid frame
    counts max(1 + (len − 400)//160, 0))."""
    frame_len, hop, padded, n_bins = 400, 160, 512, 80
    frames = _mask_wav(wav16.float(), lens).unfold(-1, frame_len, hop)   # snip edges
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)        # first sample doubled
    frames = frames - 0.97 * prev
    n = np.arange(frame_len)
    povey = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (frame_len - 1))) ** 0.85
    frames = frames * torch.from_numpy(povey.astype(np.float32)).to(frames.device)
    power = torch.fft.rfft(frames, n=padded, dim=-1).abs().square()
    banks = torch.from_numpy(_kaldi_mel_banks(n_bins, padded, 16000, 20.0, 8000.0)).to(frames.device)
    fb = torch.log((power @ banks.T).clamp_min(_KALDI_EPS))
    n_frames = (1 + (lens.long() - frame_len).div(hop, rounding_mode="floor")).clamp_min(0)
    valid = (torch.arange(fb.shape[1], device=fb.device)[None, :] < n_frames[:, None])[:, :, None]
    denom = valid.sum(dim=1, keepdim=True).clamp_min(1)
    mean = torch.where(valid, fb, 0.0).sum(dim=1, keepdim=True) / denom
    return torch.where(valid, fb - mean, 0.0), n_frames
