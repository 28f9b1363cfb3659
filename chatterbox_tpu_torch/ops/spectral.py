"""STFT and inverse STFT as ``chatterbox_tpu.ops.spectral`` defines them:
centered reflect-padded frames, a caller-given window, and an overlap-add
inverse normalised by the summed squared window (not ``torch.stft``'s
defaults)."""
from __future__ import annotations

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
