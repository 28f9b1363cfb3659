"""Audio quality / parity metrics (the port's copy of
``chatterbox_tpu/audio/quality.py``).

MCD (mel-cepstral distortion, frame-truncated alignment: no DTW) and
log-spectral distance between two waveforms, in numpy only, so a test or an
offline evaluation can compare a WAV of either package with the other's.
"""
from __future__ import annotations

import numpy as np

from ..ops.spectral import _mel_matrix


def _mel_spectrogram_np(x: np.ndarray, sr: int, n_fft: int, hop: int, n_mels: int) -> np.ndarray:
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[idx] * np.hanning(n_fft)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1))
    mel = spec @ _mel_matrix(sr, n_fft, n_mels, 0.0, sr / 2).T
    return np.log(np.maximum(mel, 1e-5))


def _mfcc(x: np.ndarray, sr: int, n_mfcc: int = 13, n_fft: int = 1024, hop: int = 256,
          n_mels: int = 40) -> np.ndarray:
    logmel = _mel_spectrogram_np(x, sr, n_fft, hop, n_mels)
    # DCT-II, orthonormal
    n = n_mels
    k = np.arange(n_mfcc)[:, None]
    m = np.arange(n)[None, :]
    dct = np.cos(np.pi * k * (2 * m + 1) / (2 * n)) * np.sqrt(2.0 / n)
    dct[0] /= np.sqrt(2.0)
    return logmel @ dct.T  # [frames, n_mfcc]


def mel_cepstral_distortion(ref: np.ndarray, hyp: np.ndarray, sr: int, n_mfcc: int = 13) -> float:
    """MCD in dB between two waveforms (frame-truncated alignment, c0 dropped;
    standard 10*sqrt(2)/ln(10) scaling)."""
    if len(ref) == 0 or len(hyp) == 0:
        return float("inf")
    a = _mfcc(np.asarray(ref, np.float64), sr, n_mfcc)
    b = _mfcc(np.asarray(hyp, np.float64), sr, n_mfcc)
    n = min(len(a), len(b))
    if n == 0:
        return float("inf")
    diff = a[:n, 1:] - b[:n, 1:]
    dist = np.sqrt((diff**2).sum(axis=1))
    return float((10.0 * np.sqrt(2.0) / np.log(10.0)) * dist.mean())


def log_spectral_distance(ref: np.ndarray, hyp: np.ndarray, sr: int, n_fft: int = 1024,
                          hop: int = 256) -> float:
    """RMS log-spectral distance in dB."""
    a = _mel_spectrogram_np(np.asarray(ref, np.float64), sr, n_fft, hop, 80)
    b = _mel_spectrogram_np(np.asarray(hyp, np.float64), sr, n_fft, hop, 80)
    n = min(len(a), len(b))
    d = (a[:n] - b[:n]) * (20.0 / np.log(10.0))
    return float(np.sqrt((d**2).mean()))
