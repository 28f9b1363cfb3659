"""STFT, inverse STFT and the mel spectrogram as ``chatterbox_tpu.ops.spectral``
defines them: centered reflect-padded frames, a caller-given window, an
overlap-add inverse normalised by the summed squared window (not
``torch.stft``'s defaults), and a slaney mel filterbank built on the host."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def frame_signal(x: torch.Tensor, frame_len: int, hop: int, center: bool = True) -> torch.Tensor:
    """Slice [B, L] into overlapping frames [B, N, frame_len]."""
    if center:
        pad = frame_len // 2
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(-1, frame_len, hop)


def stft(x: torch.Tensor, n_fft: int, hop: int, win: torch.Tensor, center: bool = True) -> torch.Tensor:
    """[B, L] → complex [B, N, n_fft//2+1]."""
    frames = frame_signal(x, n_fft, hop, center) * win
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[B, N, frame_len] → [B, (N-1)*hop + frame_len]; frame_len % hop == 0.
    Strip j of every frame lands at offset j*hop: r shifted adds."""
    B, N, Fl = frames.shape
    if Fl % hop:
        raise ValueError("overlap_add requires frame_len divisible by hop")
    r = Fl // hop
    out = frames.new_zeros((B, (N - 1) * hop + Fl))
    strips = frames.reshape(B, N, r, hop)
    for j in range(r):
        out[:, j * hop: j * hop + N * hop] += strips[:, :, j, :].reshape(B, N * hop)
    return out


def istft(
    spec: torch.Tensor,
    n_fft: int,
    hop: int,
    win: torch.Tensor,
    length: int | None = None,
    center: bool = True,
) -> torch.Tensor:
    """complex [B, N, n_fft//2+1] → [B, L] with window-square normalisation;
    ``center`` drops the first n_fft//2 samples so stft→istft is aligned."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    x = overlap_add(frames, hop)
    N = spec.shape[1]
    wsq = overlap_add((win * win).expand(1, N, n_fft), hop)
    x = x / wsq.clamp_min(1e-8)
    if center:
        x = x[:, n_fft // 2:]
    if length is not None:
        x = x[:, :length]
    return x


@lru_cache(maxsize=8)
def _mel_matrix(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-style mel filterbank [n_mels, n_fft//2+1] (area-normalised)."""

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        log_mel = 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / np.log(6.4) * 27.0
        return np.where(f >= 1000.0, log_mel, 3 * f / 200.0)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_bins)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lower, center, upper = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lower) / max(center - lower, 1e-9)
        down = (upper - fft_freqs) / max(upper - center, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down)) * 2.0 / max(upper - lower, 1e-9)
    return fb.astype(np.float32)


def mel_matrix(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
               device) -> torch.Tensor:
    """``_mel_matrix`` as a float32 tensor on ``device``."""
    return torch.from_numpy(_mel_matrix(sr, n_fft, n_mels, fmin, fmax)).to(device)


def log_mel_spectrogram(
    x: torch.Tensor,
    sr: int,
    n_fft: int,
    hop: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    log_offset: float = 1e-5,
) -> torch.Tensor:
    """[B, L] waveform → [B, N, n_mels] natural-log mel spectrogram of the
    magnitude spectrum (centered frames, symmetric Hann window)."""
    fmax = fmax or sr / 2
    win = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(x.device, x.dtype)
    mag = stft(x, n_fft, hop, win).abs()
    mel = mag @ mel_matrix(sr, n_fft, n_mels, fmin, fmax, x.device).T
    return torch.log(mel.clamp_min(log_offset))
