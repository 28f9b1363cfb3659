"""The plain reference of the ``dit`` configuration: Chatterbox's T3 with the
repo's DiT redesign of S3Gen and its S3Tok tokenizer, in float32 PyTorch,
one request at a time. T3's check, the text, the slices, the noise and the
stitching are ``chatterbox_ref``'s; this module gives the voice and the
synthesis of a slice.

The voice is the neutral default voice (the DiT ignores ``conds.pt``): two
seconds of silence through S3Tok, the VoiceEncoder and the DiT's x-vector.
S3Tok's finite scalar quantiser rounds tanh(z) to {-1, 0, 1}: a digit whose
tanh lies within bf16's error of ±0.5 may round either way, and one digit
moves a prompt token. So the reference takes the program's prompt tokens as
given (``OBSERVE``: the harness records what the engine's S3Tok call
returned at set-up) and checks that stage by itself: every decisive digit,
one whose float32 tanh lies more than ``DECISIVE`` from ±0.5, must be the
program's (``s3tok_digits``: the count that differ, limit 0). Everything
after, the T3 lanes, the x-vector, the prompt mel and the DiT's conditioning
dict, it works out again.

A slice re-synthesises the chunk's accumulated tokens (full overlap, no
prompt cache, no streaming state), padded to the engine's bucket with the
masked pad token so the noise is drawn at the program's shapes; its f0,
excitation and audio are checked from the program's mel, f0 and source as
``chatterbox_ref`` checks them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import chatterbox_ref as base
from .chatterbox_ref import Sizes, _dc, compare, t3_lanes  # noqa: F401
from .frozen.models.s3gen import model as dm
from .frozen.models.s3gen.config import S3GenConfig
from .frozen.models.s3tok.model import S3TokConfig, s3tok_fsq, s3tok_param_tree
from .frozen.models.t3 import model as t3m
from .frozen.models.t3.config import T3Config
from .frozen.models.voice_encoder.model import (VoiceEncoderConfig, voice_embed,
                                                voice_encoder_param_tree)
from .frozen.models.s3gen.vocoder import _resblock as _dit_resblock
from .frozen.ops.conv import conv1d, conv_transpose1d
from .frozen.ops.spectral import istft, log_mel_spectrogram

S3_SR = 16000
DECISIVE = 0.06   # a digit is decisive when |tanh| is this far from 0.5
OBSERVE = {"voice_tokens": ("chatterbox_tpu_torch.runtime.engine", "s3tok_tokenize")}
_MODEL = "chatterbox_tpu_torch.models.s3gen.model"
CAPTURE = {"mel_source": (_MODEL, "s3gen_mel_and_source",
                          [("out", 0), ("out", 1), ("arg", 5), ("arg", 6)]),
           "f0": (_MODEL, "predict_f0", [("out", None)]),
           "post": ("chatterbox_tpu_torch.models.s3gen.vocoder", "conv1d", [("out", None)])}


@dataclasses.dataclass(frozen=True)
class DitSizes(Sizes):
    s3tok: Optional[S3TokConfig] = None
    voice: Optional[Dict] = None


def sizes(config: Dict, max_new_tokens: int) -> DitSizes:
    m = config["model"]
    return DitSizes(_dc(T3Config, m["t3"]), _dc(S3GenConfig, m["s3gen"]),
                    _dc(VoiceEncoderConfig, m["ve"]), m["engine"]["text_bucket"], max_new_tokens,
                    _dc(S3TokConfig, m["s3tok"]), config["voice"])


def param_trees(sz: DitSizes, init) -> Dict:
    """As the program's trees, but the flow's AdaLN-zero modulation and its
    output projection, which start at zero for training, are drawn like every
    other matrix: at zero the flow returns its initial noise whatever its
    layers compute, and the audio would not show them."""
    s3gen = dm.s3gen_param_tree(sz.s3, init)
    flow = s3gen["flow"]
    flow["layers"]["ada_w"] = init.dense(tuple(flow["layers"]["ada_w"].shape))
    flow["out_proj"]["w"] = init.dense(tuple(flow["out_proj"]["w"].shape))
    return {"t3": t3m.t3_param_tree(sz.t3, init), "s3gen": s3gen,
            "s3tok": s3tok_param_tree(sz.s3tok, init),
            "ve": voice_encoder_param_tree(sz.ve, init)}


def write_conds(path, seed: int, sz) -> None:
    """The DiT serves the neutral voice: no ``conds.pt``."""


def estimator_evals(sz: DitSizes) -> int:
    return sz.s3.cfm_steps


def flop_rates(raw: Dict) -> Dict[str, float]:
    from ..roofline import dit_flop_rates
    return dit_flop_rates(raw)


def job_positions(sz: DitSizes, token_len: int, new_len: int):
    """(tokens the encoder runs over, frames the flow solves) of one job:
    every slice re-solves the prompt and all the chunk's tokens."""
    n = sz.s3.max_prompt_tokens + token_len
    return n, n * sz.s3.frames_per_token


def reflect_tail(wav: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The padding past each row's valid length read as the reflection of
    its tail (sample i ≥ len reads 2·len − 2 − i)."""
    idx = torch.arange(wav.shape[1], device=wav.device)[None, :]
    refl = (2 * lens.long()[:, None] - 2 - idx).clamp(0, wav.shape[1] - 1)
    return torch.where(idx < lens[:, None], wav, torch.gather(wav, 1, refl))


def digits(tokens: torch.Tensor, levels: int, dims: int) -> torch.Tensor:
    """Base-``levels`` digits of FSQ tokens → [..., dims] in {-1, 0, 1}."""
    powers = levels ** torch.arange(dims, device=tokens.device)
    return (tokens.long()[..., None] // powers) % levels - 1


class Reference(base.Reference):
    PARTS = ("t3", "s3gen", "s3tok", "ve")

    def _voice(self, conds_path, observed: Dict):
        sz, p, dev = self.sz, self.params, self.device
        n24, n16 = (int(sz.voice["neutral_seconds"] * r) for r in (sz.s3.sample_rate, S3_SR))
        wav24, wav16 = torch.zeros((1, n24), device=dev), torch.zeros((1, n16), device=dev)
        len24, len16 = torch.tensor([n24], device=dev), torch.tensor([n16], device=dev)
        z, valid = s3tok_fsq(p["s3tok"], sz.s3tok, wav16, len16)
        self.z = z.float()
        pw = sz.s3tok.fsq_levels ** torch.arange(sz.s3tok.fsq_dims, device=dev)
        own = torch.where(valid, ((torch.round(self.z).long() + 1) * pw).sum(-1), 0)
        self.own_tokens = own
        tok_len = len16.long() // (sz.s3tok.hop * 4)
        self.tok_len = int(tok_len[0])
        tokens = own
        self.observed_tokens = None
        if "voice_tokens" in observed and not self.control:
            tokens = self.observed_tokens = observed["voice_tokens"][0].to(dev).long()
        spk = voice_embed(p["ve"], sz.ve, wav16, len16)
        emo = torch.tensor([float(sz.voice["exaggeration"])], device=dev)
        lanes = t3_lanes(p["t3"], sz.t3, spk, tokens, tok_len, emo)
        P = sz.t3.speech_cond_prompt_len
        prompt = F.pad(tokens[:, :P], (0, max(0, P - tokens.shape[1])))
        fbank = log_mel_spectrogram(wav16, S3_SR, 400, 160, 80)
        s3c = sz.s3
        ref = dm.s3gen_embed_ref(p["s3gen"], s3c, reflect_tail(wav24, len24), fbank,
                                 prompt[:, : s3c.max_prompt_tokens],
                                 tok_len.clamp_max(s3c.max_prompt_tokens), fbank_len=len16 // 160)
        mel = ref["prompt_mel"]
        ref["prompt_mel"] = F.pad(mel, (0, 0, 0, s3c.max_prompt_mel - mel.shape[1]))
        return lanes, ref

    def decisive_mismatch(self, tokens: torch.Tensor) -> int:
        """Decisive digits of the float32 tanh that ``tokens`` round the
        other way."""
        cfg = self.sz.s3tok
        n = min(tokens.shape[1], self.z.shape[1], self.tok_len)
        want = torch.round(self.z[:, :n])
        got = digits(tokens[:, :n].to(self.device), cfg.fsq_levels, cfg.fsq_dims)
        decisive = (self.z[:, :n].abs() - 0.5).abs() > DECISIVE
        return int(((want != got) & decisive).sum())

    def voice_check(self, control=None) -> Dict[str, float]:
        """``s3tok_digits``: the decisive digits that the program's prompt
        tokens (the control's own, with ``control``) round the other way."""
        tokens = control.own_tokens if control is not None else self.observed_tokens
        return {} if tokens is None else {"s3tok_digits": float(self.decisive_mismatch(tokens))}

    def _chunk_state(self):
        return None

    def _noise(self, T: int, gen):
        return dm.draw_noise(self.sz.s3, 1, T, gen, self.device)

    def _own_mel(self, acc: List[int], n_new: int, T: int, noise, state):
        """A slice re-solves the chunk's accumulated tokens, padded to the
        engine's bucket with the masked pad token."""
        s3c, dev = self.sz.s3, self.device
        tokens = torch.full((1, T), s3c.vocab_size, dtype=torch.long, device=dev)
        tokens[0, : len(acc)] = torch.tensor(acc, device=dev)
        mel, _ = dm.s3gen_mel_and_source(self.params["s3gen"], s3c, tokens,
                                         torch.tensor([len(acc)], device=dev), self.gen_ref,
                                         torch.zeros((1, T * s3c.samples_per_token), device=dev),
                                         torch.tensor([0], device=dev), noise)
        return mel[0], None

    def _f0(self, mel):
        return dm.predict_f0(self.params["s3gen"]["vocoder"], mel[None])[0]

    def _source(self, f0, noise, job: Dict):
        """The excitation from the program's f0. The DiT sums its phase in
        f0's dtype, bf16, where a running sum of 10⁵ terms rounds by the
        order the scan adds them; so the sum runs over a batch of the
        program's shape, the job in its own row (the others zero)."""
        B, row = job["rows"], job["row"]
        f0_b = f0.new_zeros((B, f0.shape[0]))
        f0_b[row] = f0
        nz = noise["source"]
        nz_b = nz.new_zeros((B, nz.shape[1]))
        nz_b[row] = nz[0]
        return dm.make_source(self.params["s3gen"]["vocoder"], self.sz.s3, f0_b, nz_b)[row]

    def _post(self, mel, source):
        """The DiT vocoder up to its last conv (``vocode``'s body) → the
        ISTFT head's input [frames, n_fft + 2]."""
        p, cfg = self.params["s3gen"]["vocoder"], self.sz.s3
        mel, source = mel[None].float(), source[None].float()
        x = conv1d(mel, p["pre"]["w"], p["pre"]["b"])
        src, rate = source[:, :, None], 1
        for stage, r in zip(p["stages"], cfg.upsample_rates):
            x = conv_transpose1d(F.leaky_relu(x, 0.1), stage["up"]["w"], stage["up"]["b"], stride=r)
            rate *= r
            s = conv1d(src, stage["src"]["w"], stage["src"]["b"], stride=cfg.hop // rate)
            x = x + s[:, : x.shape[1]]
            acc = None
            for block in stage["res"]:
                y = _dit_resblock(x, block, cfg.resblock_dilations)
                acc = y if acc is None else acc + y
            x = acc / len(stage["res"])
        return conv1d(F.leaky_relu(x, 0.1), p["post"]["w"], p["post"]["b"])[0]

    def _spectrum(self, post):
        n = self.sz.s3.istft_n_fft // 2 + 1
        return (torch.exp(post[..., :n].clamp(-10.0, 3.0))
                * torch.exp(1j * post[..., n: 2 * n].float()))

    def _window(self, start: int, tail_len: int, T: int):
        """The DiT vocodes the whole chunk; the tail is a slice of it."""
        return 0, T, start

    def _from_spectrum(self, z, n_samples: int):
        cfg = self.sz.s3
        win = torch.from_numpy(np.hanning(cfg.istft_n_fft).astype(np.float32)).to(z.device)
        wav = istft(z[None], cfg.istft_n_fft, cfg.istft_hop, win, center=False)[0]
        return wav[:n_samples].clamp(-1.0, 1.0)

    def _served(self, job: Dict):
        mel, source, cache, clen = job["mel_source"]
        return mel, job["f0"][0], cache, int(clen), source

    def _fpt(self) -> int:
        return self.sz.s3.frames_per_token
