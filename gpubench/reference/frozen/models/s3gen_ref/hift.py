"""HiFT vocoder: mel → NSF source-filter → ISTFT (torch counterpart of
``chatterbox_tpu/models/s3gen_ref/hift.py``).

ConvRNN f0 predictor → harmonic-plus-noise NSF source (SineGen with
frame-rate phase integration) → upsampling stack (transposed convs, Snake
resblocks) with the source injected per stage through STFT-domain down-convs
→ 16/4 ISTFT head. ``make_source`` takes its random draws (the initial
harmonic phases and the additive noise) as tensors, so a test can hand it the
JAX package's numbers.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.conv import conv1d, conv_transpose1d
from ...ops.nn import linear
from ...ops.spectral import istft, stft
from .config import HiFTConfig


def _upsample_total(cfg: HiFTConfig) -> int:
    r = 1
    for u in cfg.upsample_rates:
        r *= u
    return r * cfg.istft_hop


def _source_down_rates(cfg: HiFTConfig) -> List[int]:
    rates = [1] + list(cfg.upsample_rates[::-1][:-1])
    return [int(r) for r in np.cumprod(rates)[::-1]]


def init_hift_params(init, cfg: HiFTConfig) -> Dict:
    """JAX-layout tree (convert with ``convert.convert_params``)."""
    nfft2 = cfg.istft_n_fft + 2
    mk = lambda *shape: init.dense(shape)  # noqa: E731

    def mk_resblock(c: int, k: int, dils) -> Dict:
        return {
            "convs1": [{"w": mk(k, c, c), "b": mk(c)} for _ in dils],
            "convs2": [{"w": mk(k, c, c), "b": mk(c)} for _ in dils],
            "alpha1": [mk(c) for _ in dils],
            "alpha2": [mk(c) for _ in dils],
        }

    base = cfg.base_channels
    ups, sdowns, sres, res = [], [], [], []
    cum = _source_down_rates(cfg)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cin, cout = base // (2 ** i), base // (2 ** (i + 1))
        ups.append({"w": mk(k, cin, cout), "b": mk(cout)})
        du = cum[i]
        sdowns.append({"w": mk(1 if du == 1 else du * 2, nfft2, cout), "b": mk(cout)})
        sres.append(mk_resblock(cout, cfg.source_resblock_kernel_sizes[i],
                                cfg.source_resblock_dilation_sizes[i]))
        for k2, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            res.append(mk_resblock(cout, k2, dils))
    f0_convs = []
    cin = cfg.in_channels
    for _ in range(5):
        f0_convs.append({"w": mk(3, cin, cfg.f0_cond_channels), "b": mk(cfg.f0_cond_channels)})
        cin = cfg.f0_cond_channels
    n = cfg.istft_n_fft
    window = torch.as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n),
                             dtype=torch.float32, device=init.device)
    return {
        "conv_pre": {"w": mk(7, cfg.in_channels, base), "b": mk(base)},
        "ups": ups,
        "source_downs": sdowns,
        "source_resblocks": sres,
        "resblocks": res,
        "conv_post": {"w": mk(7, base // (2 ** len(cfg.upsample_rates)), nfft2), "b": mk(nfft2)},
        "f0": {"convs": f0_convs, "cls": {"w": mk(cfg.f0_cond_channels, 1), "b": mk(1)}},
        "m_source": {"w": mk(cfg.nb_harmonics + 1, 1), "b": mk(1)},
        "stft_window": window,
    }


def hift_receptive_margin(cfg: HiFTConfig) -> int:
    """Conservative one-sided receptive field of the mel→wav stack, in output
    samples. Every op in ``hift_decode`` is local (convs, transposed convs,
    STFT/ISTFT windows), so a waveform sample further than this from a window
    edge equals the full-length computation's sample: the basis of the
    tail-windowed vocoder (``model.s3gen_ref_inference_tail``). A bound, not
    tight: parallel branches' spans are summed."""
    total_up = _upsample_total(cfg)
    hop = cfg.istft_hop

    def rb_span(k: int, dils) -> int:
        # sequential dilated conv pairs: one-sided span in steps
        return sum(((k - 1) // 2) * d + (k - 1) // 2 for d in dils)

    rf = 3 * total_up  # conv_pre k7 at the mel rate
    cum = _source_down_rates(cfg)
    rate_in = total_up
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        rate_out = rate_in // u
        rf += (-(-k // u) + 1) * rate_in                       # transposed conv
        rf += max(
            (rb_span(kk, dd) for kk, dd in zip(
                cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)),
            default=0,
        ) * rate_out                                            # main resblocks
        du = cum[i]
        rf += cfg.istft_n_fft                                   # source STFT
        rf += (2 * du if du > 1 else 1) * hop                   # source down conv
        rf += rb_span(cfg.source_resblock_kernel_sizes[i],
                      cfg.source_resblock_dilation_sizes[i]) * rate_out
        rate_in = rate_out
    rf += rate_in                    # final-stage reflection pad
    rf += 3 * hop                    # conv_post k7 at the ISTFT frame rate
    rf += cfg.istft_n_fft            # ISTFT window
    return rf


def _snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a = alpha.float()
    x32 = x.float()
    return (x32 + torch.sin(a * x32) ** 2 / (a + 1e-9)).to(x.dtype)


def _resblock(p: Dict, x: torch.Tensor, dils) -> torch.Tensor:
    for j, d in enumerate(dils):
        xt = _snake(x, p["alpha1"][j])
        xt = conv1d(xt, p["convs1"][j]["w"], p["convs1"][j]["b"], dilation=d, padding="SAME_TORCH")
        xt = _snake(xt, p["alpha2"][j])
        xt = conv1d(xt, p["convs2"][j]["w"], p["convs2"][j]["b"], padding="SAME_TORCH")
        x = x + xt
    return x


def predict_f0(params: Dict, cfg: HiFTConfig, mel: torch.Tensor) -> torch.Tensor:
    """ConvRNNF0Predictor: [B, F, 80] mel → [B, F] f0 (Hz, ≥ 0)."""
    h = mel
    for c in params["f0"]["convs"]:
        h = F.elu(conv1d(h, c["w"], c["b"], padding="SAME_TORCH"))
    f0 = linear(h, params["f0"]["cls"]["w"], params["f0"]["cls"]["b"])[..., 0]
    return f0.float().abs()


def _interp_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """torch F.interpolate(mode='linear', align_corners=False) over axis 1,
    written out as the JAX package does (same index and weight arithmetic)."""
    T = x.shape[1]
    pos = (np.arange(out_len) + 0.5) * (T / out_len) - 0.5
    lo = np.clip(np.floor(pos).astype(np.int64), 0, T - 1)
    hi = np.clip(lo + 1, 0, T - 1)
    frac = np.clip(pos - np.floor(pos), 0.0, 1.0).astype(np.float32)
    frac = np.where(pos < 0, 0.0, frac).astype(np.float32)
    dev = x.device
    lo_t, hi_t = torch.as_tensor(lo, device=dev), torch.as_tensor(hi, device=dev)
    fr = torch.as_tensor(frac, device=dev)[None, :, None]
    return x[:, lo_t] * (1.0 - fr) + x[:, hi_t] * fr


def make_source(params: Dict, cfg: HiFTConfig, f0: torch.Tensor, rand_ini: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
    """NSF harmonic-plus-noise source. f0 [B, F] → [B, F·up].

    rand_ini [B, H]: uniform initial phases (the fundamental's is forced to 0);
    noise [B, F·up, H]: standard normal draws, scaled here by the
    voiced/unvoiced amplitude."""
    up = _upsample_total(cfg)
    B, Fr = f0.shape
    L = Fr * up
    H = cfg.nb_harmonics + 1
    f0_up = f0.repeat_interleave(up, dim=1)
    fn = f0_up[:, :, None] * torch.arange(1, H + 1, dtype=torch.float32, device=f0.device)
    rad = torch.remainder(fn / cfg.sample_rate, 1.0)
    rand_ini = rand_ini.float().clone()
    rand_ini[:, 0] = 0.0
    rad[:, 0, :] += rand_ini
    rad_frame = _interp_linear(rad, Fr)
    phase = torch.cumsum(rad_frame, dim=1) * 2.0 * np.pi
    phase = _interp_linear(phase * up, L)
    sines = torch.sin(phase)
    uv = (f0_up > cfg.nsf_voiced_threshold).float()[:, :, None]
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    sine_waves = sines * cfg.nsf_alpha * uv + noise_amp * noise.float()
    har = torch.tanh(linear(sine_waves, params["m_source"]["w"], params["m_source"]["b"]))
    return har[..., 0]


def hift_decode(params: Dict, cfg: HiFTConfig, mel: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """[B, F, 80] mel + [B, F·up] excitation → [B, F·up] waveform."""
    n_fft, hop = cfg.istft_n_fft, cfg.istft_hop
    win = params["stft_window"].float()
    s_spec = stft(source.float(), n_fft, hop, win)
    s_stft = torch.cat([s_spec.real, s_spec.imag], dim=-1).to(mel.dtype)

    x = conv1d(mel, params["conv_pre"]["w"], params["conv_pre"]["b"], padding="SAME_TORCH")
    cum = _source_down_rates(cfg)
    nk = len(cfg.resblock_kernel_sizes)
    for i, u in enumerate(cfg.upsample_rates):
        x = F.leaky_relu(x, cfg.lrelu_slope)
        x = conv_transpose1d(x, params["ups"][i]["w"], params["ups"][i]["b"], stride=u)
        if i == len(cfg.upsample_rates) - 1:
            # reflection pad (1, 0): aligns the final stage with the source
            # STFT frame count
            x = torch.cat([x[:, 1:2], x], dim=1)
        du = cum[i]
        sd = params["source_downs"][i]
        if du == 1:
            si = conv1d(s_stft, sd["w"], sd["b"])
        else:
            pad = du // 2
            si = conv1d(F.pad(s_stft, (0, 0, pad, pad)), sd["w"], sd["b"], stride=du, padding="VALID")
        si = _resblock(params["source_resblocks"][i], si, cfg.source_resblock_dilation_sizes[i])
        x = x + si
        acc = None
        for j in range(nk):
            r = _resblock(params["resblocks"][i * nk + j], x, cfg.resblock_dilation_sizes[j])
            acc = r if acc is None else acc + r
        x = acc / nk
    x = F.leaky_relu(x, 0.01)
    x = conv1d(x, params["conv_post"]["w"], params["conv_post"]["b"], padding="SAME_TORCH")
    x = x.float()
    mag = torch.exp(x[..., : n_fft // 2 + 1].clamp_max(float(np.log(1e2))))
    phase = torch.sin(x[..., n_fft // 2 + 1:])
    wav = istft(torch.polar(mag, phase), n_fft, hop, win, length=source.shape[1])
    return wav.clamp(-cfg.audio_limit, cfg.audio_limit)
