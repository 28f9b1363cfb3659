"""S3Gen of the DiT architecture: parameters, the reference-voice embedding
and chunk inference (torch counterpart of ``chatterbox_tpu/models/s3gen/model.py``).

* prompt tokens and mel sit in fixed-size windows, LEFT-packed so the
  [pad | prompt | generated] track has no interior gaps;
* one call runs encoder → CFM Euler solve → vocoder;
* the vocoder excitation (``source``) is returned and accepted as the
  streaming continuity cache (the reference's ``cache_source``).

Every random draw enters through ``noise`` (``draw_noise``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops.spectral import log_mel_spectrogram
from .config import S3GenConfig
from .encoder import encode_tokens, encoder_param_tree
from .flow import cfm_generate, flow_param_tree
from .vocoder import make_source, predict_f0, vocode, vocoder_param_tree
from .xvector import xvector_embed, xvector_param_tree

# CFM noise buffer (frames): a chunk-independent length, so a generator
# seeded the same way gives frame t the same noise on every slice
NOISE_FRAMES = 2048


def s3gen_param_tree(cfg: S3GenConfig, init) -> Dict:
    """The JAX-layout tree of ``init_s3gen_params``, its leaves drawn by
    ``init`` in the order encoder, flow, vocoder, x-vector."""
    return {
        "encoder": encoder_param_tree(cfg, init),
        "flow": flow_param_tree(cfg, init),
        "vocoder": vocoder_param_tree(cfg, init),
        "xvector": xvector_param_tree(cfg, init),
    }


def draw_noise(cfg: S3GenConfig, batch: int, n_tokens: int, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """The random inputs of one ``s3gen_inference`` call: the CFM initial
    noise first, in a buffer of max(NOISE_FRAMES, (P + T)·fpt) frames, so a
    generator seeded the same way gives frame t the same noise on every
    slice of a chunk; then the source noise [batch, T·spt]. (The JAX package
    draws ``normal(key, (B, (P + T)·fpt, M))``, whose frames shift with T.)"""
    frames = max(NOISE_FRAMES, (cfg.max_prompt_tokens + n_tokens) * cfg.frames_per_token)
    g = dict(generator=generator, device=device)
    return {"cfm": torch.randn((batch, frames, cfg.n_mels), **g),
            "source": torch.randn((batch, n_tokens * cfg.samples_per_token), **g)}


def s3gen_embed_ref(
    params: Dict,
    cfg: S3GenConfig,
    ref_wav_24k: torch.Tensor,    # [B, L24] (≤ 10 s)
    fbank_16k: torch.Tensor,      # [B, Tf, 80] log-mel of the 16 kHz reference
    prompt_tokens: torch.Tensor,  # [B, P'] from the speech tokenizer
    prompt_len: torch.Tensor,     # [B]
    fbank_len: Optional[torch.Tensor] = None,  # [B] valid fbank frames
) -> Dict:
    """The conditioning dict of a voice: spk_emb [B, spk_dim] (the weights'
    dtype), prompt_tokens [B, P] (padded with vocab_size) and prompt_len,
    prompt_mel [B, ≤ max_prompt_mel, M] float32 and prompt_mel_len."""
    mel = log_mel_spectrogram(ref_wav_24k, cfg.sample_rate, cfg.n_fft, cfg.hop, cfg.n_mels)
    mel = mel[:, : cfg.max_prompt_mel]
    pm_len = (prompt_len.long() * cfg.frames_per_token).clamp_max(mel.shape[1])
    fb_valid = None
    if fbank_len is not None:
        fb_valid = (torch.arange(fbank_16k.shape[1], device=fbank_16k.device)[None, :]
                    < fbank_len[:, None])
    P = cfg.max_prompt_tokens
    tokens = F.pad(prompt_tokens[:, :P].long(), (0, max(0, P - prompt_tokens.shape[1])),
                   value=cfg.vocab_size)
    return {
        "spk_emb": xvector_embed(params["xvector"], fbank_16k, fb_valid),
        "prompt_tokens": tokens,
        "prompt_len": prompt_len.long().clamp_max(P),
        "prompt_mel": mel,
        "prompt_mel_len": pm_len,
    }


def _left_pack_prompt(cfg: S3GenConfig, prompt_tokens: torch.Tensor, prompt_len: torch.Tensor,
                      tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[pad | prompt | generated], the prompt right-aligned against the
    generated tokens so the valid region is contiguous → (tokens [B, P+T],
    the prompt window's validity [B, P])."""
    P = prompt_tokens.shape[1]
    off = (P - prompt_len.long())[:, None]
    j = torch.arange(P, device=tokens.device)[None, :]
    packed = torch.gather(prompt_tokens.long(), 1, (j - off).clamp(0, P - 1).expand(len(off), P))
    valid_prompt = j >= off
    packed = torch.where(valid_prompt, packed, cfg.vocab_size)
    return torch.cat([packed, tokens.long()], dim=1), valid_prompt


def s3gen_mel_and_source(
    params: Dict,
    cfg: S3GenConfig,
    tokens: torch.Tensor,        # [B, T] generated tokens, right-padded with vocab_size
    token_len: torch.Tensor,     # [B]
    ref: Dict,                   # s3gen_embed_ref(...)
    source_cache: torch.Tensor,  # [B, T·spt] excitation prefix (zeros past cache_len)
    cache_len: torch.Tensor,     # [B] valid samples in source_cache
    noise: Dict[str, torch.Tensor],  # draw_noise(...)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder → CFM → the generated frames' mel [B, T·fpt, M] (float32,
    zero past token_len) and the excitation [B, T·spt], whose first
    cache_len samples are source_cache's."""
    B, T = tokens.shape
    P, fpt, M = cfg.max_prompt_tokens, cfg.frames_per_token, cfg.n_mels
    dev = tokens.device
    full_tokens, valid_prompt = _left_pack_prompt(cfg, ref["prompt_tokens"], ref["prompt_len"],
                                                  tokens)
    gen_valid = torch.arange(T, device=dev)[None, :] < token_len[:, None]
    valid_tokens = torch.cat([valid_prompt, gen_valid], dim=1)
    mu = encode_tokens(params["encoder"], cfg, full_tokens, valid_tokens)  # [B, 2(P+T), M]
    frame_valid = valid_tokens.repeat_interleave(fpt, dim=1)

    # the prompt mel, right-aligned against the generated frames
    Pm = P * fpt
    pm = ref["prompt_mel"]
    pm = F.pad(pm, (0, 0, 0, max(0, Pm - pm.shape[1])))[:, :Pm]
    offf = (Pm - ref["prompt_mel_len"].long().clamp_max(Pm))[:, None]
    jf = torch.arange(Pm, device=dev)[None, :]
    packed_mel = torch.gather(pm, 1, (jf - offf).clamp(0, Pm - 1)[:, :, None].expand(B, Pm, M))
    prompt_frame_flag = (jf >= offf)[:, :, None]
    packed_mel = torch.where(prompt_frame_flag, packed_mel, 0.0).to(mu.dtype)
    cond = torch.cat([packed_mel, mu.new_zeros((B, T * fpt, M))], dim=1)
    flag = torch.cat([prompt_frame_flag.to(mu.dtype), mu.new_zeros((B, T * fpt, 1))], dim=1)

    mel_full = cfm_generate(params["flow"], cfg, noise["cfm"], mu, cond, flag, ref["spk_emb"],
                            frame_valid)
    # zero invalid frames so the vocoder convs see silence, not pad garbage
    mel_gen = torch.where(frame_valid[:, Pm:, None], mel_full[:, Pm:], 0.0)

    f0 = predict_f0(params["vocoder"], mel_gen)
    source = make_source(params["vocoder"], cfg, f0, noise["source"])
    L = T * cfg.samples_per_token
    use_cache = torch.arange(L, device=dev)[None, :] < cache_len[:, None]
    return mel_gen, torch.where(use_cache, source_cache[:, :L], source)


def s3gen_inference(
    params: Dict,
    cfg: S3GenConfig,
    tokens: torch.Tensor,
    token_len: torch.Tensor,
    ref: Dict,
    source_cache: torch.Tensor,
    cache_len: torch.Tensor,
    noise: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming chunk (``s3gen_mel_and_source``'s arguments) → (wav
    [B, T·spt], new source cache [B, T·spt]). The valid output is the first
    token_len·spt samples of each row."""
    mel_gen, source = s3gen_mel_and_source(params, cfg, tokens, token_len, ref, source_cache,
                                           cache_len, noise)
    return vocode(params["vocoder"], cfg, mel_gen, source), source
