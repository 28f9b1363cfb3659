"""S3Gen, reference architecture (a frozen copy of the port's
``models/s3gen_ref/model.py``, the parts the reference runs): the parameter
tree, the noise draw, the encoder over [prompt | generated] tokens, the
per-voice CFM prompt prefill, a streaming slice's flow and the excitation
with its source cache.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ...ops.nn import linear
from .config import S3GenRefConfig
from .decoder import (
    cfm_generate_streaming,
    cfm_noise_frames,
    cfm_prompt_prefill,
    init_estimator_params,
    init_stream_state,
)
from .campplus import campplus_param_tree
from .hift import (
    _upsample_total,
    init_hift_params,
    make_source,
    predict_f0,
)
from .tokenizer import s3tok_ref_param_tree
from .upsample_encoder import init_upsample_encoder_params, upsample_encode

MEL_HOP_24K = 480  # HiFiGAN mel hop at 24 kHz (50 frames/s)


def s3gen_ref_param_tree(cfg: S3GenRefConfig, init) -> Dict:
    """The JAX-layout tree, its leaves drawn by ``init``. The voice
    embedding's subtrees (``tokenizer``, ``speaker``) are drawn after the
    flow and the vocoder, so those stay the same at a given seed."""
    mk = lambda *shape: init.dense(shape)  # noqa: E731
    fl = cfg.flow
    return {
        "flow": {
            "input_emb": mk(fl.vocab_size, fl.input_size),
            "spk_affine": {"w": mk(fl.spk_embed_dim, fl.output_size), "b": mk(fl.output_size)},
            "encoder_proj": {"w": mk(fl.input_size, fl.output_size), "b": mk(fl.output_size)},
            "encoder": init_upsample_encoder_params(init, fl),
            "estimator": init_estimator_params(init, fl),
        },
        "mel2wav": init_hift_params(init, cfg.hift),
        "tokenizer": s3tok_ref_param_tree(cfg.tokenizer, init),
        "speaker": campplus_param_tree(cfg.speaker, init),
    }


def draw_noise(cfg: S3GenRefConfig, batch: int, n_tokens: int, generator: torch.Generator,
               device, stream: bool = False) -> Dict[str, torch.Tensor]:
    """The random inputs of one ``s3gen_ref_inference`` call. Drawn in a
    fixed order with the CFM buffer first at a length independent of the
    chunk (for chunks up to its 2048 frames), so a generator seeded the same
    way gives frame t the same initial noise on every slice of a chunk.
    ``stream``: the buffer of a streaming slice, always 2048 frames (later
    positions clip to its last frame, as in the JAX package)."""
    fpt = cfg.flow.up_stride
    frames = 0 if stream else (cfg.max_prompt_tokens + n_tokens) * fpt
    H = cfg.hift.nb_harmonics + 1
    L = n_tokens * fpt * _upsample_total(cfg.hift)
    g = dict(generator=generator, device=device)
    return {
        "cfm": torch.randn((batch, cfm_noise_frames(frames), cfg.flow.output_size), **g),
        "rand_ini": torch.rand((batch, H), **g),
        "nsf": torch.randn((batch, L, H), **g),
    }


def _left_pack(buf: torch.Tensor, valid_len: torch.Tensor, fill=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right-align the valid prefix of a right-padded buffer: [v|pad] → [pad|v].
    buf: [B, P] or [B, P, C] → (packed buffer, [B, P] valid mask)."""
    B, P = buf.shape[:2]
    off = (P - valid_len.long())[:, None]
    j = torch.arange(P, device=buf.device)[None, :]
    src = (j - off).clamp(0, P - 1)
    mask = j >= off
    if buf.dim() == 3:
        packed = torch.gather(buf, 1, src[:, :, None].expand(B, P, buf.shape[2]))
        packed = torch.where(mask[:, :, None], packed, fill)
    else:
        packed = torch.where(mask, torch.gather(buf, 1, src), fill)
    return packed, mask


def _spk_track(params: Dict, ref: Dict) -> torch.Tensor:
    """Normalised speaker embedding → 80-d estimator conditioning track."""
    e = ref["spk_emb"]
    spk_n = e * torch.rsqrt(e.float().square().sum(-1, keepdim=True) + 1e-12).to(e.dtype)
    return linear(spk_n, params["flow"]["spk_affine"]["w"], params["flow"]["spk_affine"]["b"])


def _packed_prompt_mel(cfg: S3GenRefConfig, ref: Dict, dtype) -> torch.Tensor:
    Pm = cfg.max_prompt_tokens * cfg.flow.up_stride
    pm = ref["prompt_mel"][:, :Pm]
    pm_len = ref["prompt_mel_len"].clamp_max(Pm)
    packed, _ = _left_pack(pm.to(dtype), pm_len)
    return packed


def _encode_mu(params: Dict, cfg: S3GenRefConfig, tokens: torch.Tensor,
               token_len: torch.Tensor, ref: Dict, tp_group=None):
    """Encoder over [pad | prompt | generated] → (mu [B, (P+T)·fpt, 80],
    valid_f [B, (P+T)·fpt], spk [B, 80])."""
    T = tokens.shape[1]
    fl = cfg.flow
    P = cfg.max_prompt_tokens
    packed_prompt, prompt_mask = _left_pack(ref["prompt_tokens"], ref["prompt_len"].clamp_max(P))
    full = torch.cat([packed_prompt.long(), tokens.long()], dim=1)
    gen_valid = torch.arange(T, device=tokens.device)[None, :] < token_len[:, None]
    valid = torch.cat([prompt_mask, gen_valid], dim=1)
    emb = params["flow"]["input_emb"][full.clamp(0, fl.vocab_size - 1)]
    emb = torch.where(valid[:, :, None], emb, 0.0)
    h, valid_f = upsample_encode(params["flow"]["encoder"], fl, emb, valid, tp_group)
    mu = linear(h, params["flow"]["encoder_proj"]["w"], params["flow"]["encoder_proj"]["b"])
    return mu, valid_f, _spk_track(params, ref)


def _source_with_cache(params: Dict, cfg: S3GenRefConfig, mel_gen: torch.Tensor,
                       source_cache: torch.Tensor, cache_len: torch.Tensor,
                       rand_ini: torch.Tensor, nsf_noise: torch.Tensor) -> torch.Tensor:
    """HiFT excitation with continuity (reference cache_source contract)."""
    f0 = predict_f0(params["mel2wav"], cfg.hift, mel_gen)
    source = make_source(params["mel2wav"], cfg.hift, f0, rand_ini, nsf_noise)
    L = source.shape[1]
    idx = torch.arange(L, device=source.device)[None, :]
    return torch.where(idx < cache_len[:, None], source_cache[:, :L].to(source.dtype), source)


def s3gen_ref_prompt_prefill(params: Dict, cfg: S3GenRefConfig, ref: Dict,
                             noise: torch.Tensor, tp_group=None) -> Dict:
    """The per-voice CFM prompt cache: the prompt-only encoder, then the
    capturing CFM solve (``decoder.cfm_prompt_prefill``), once per voice.
    ``noise`` ([B, ≥Pm, 80] float32) is the prompt's initial noise, drawn
    from a FIXED seed, so the cache serves every request of the voice."""
    fl = cfg.flow
    P = cfg.max_prompt_tokens
    packed_prompt, prompt_mask = _left_pack(ref["prompt_tokens"], ref["prompt_len"].clamp_max(P))
    emb = params["flow"]["input_emb"][packed_prompt.long().clamp(0, fl.vocab_size - 1)]
    emb = torch.where(prompt_mask[:, :, None], emb, 0.0)
    h, valid_f = upsample_encode(params["flow"]["encoder"], fl, emb, prompt_mask, tp_group)
    mu_p = linear(h, params["flow"]["encoder_proj"]["w"], params["flow"]["encoder_proj"]["b"])
    return cfm_prompt_prefill(params["flow"]["estimator"], fl, noise, mu_p, _spk_track(params, ref),
                              _packed_prompt_mel(cfg, ref, mu_p.dtype), valid_f, tp_group)


def init_s3gen_stream_state(cfg: S3GenRefConfig, cfm_cache: Dict, window: int,
                            cap_tokens: int) -> Dict:
    """A fresh per-chunk streaming state (batch 1): the CFM context
    (``decoder.init_stream_state``) and the frozen mel buffer of
    ``cap_tokens`` tokens the vocoder reads. Nothing updates a state in
    place, so one template serves every request of a voice."""
    mel = torch.zeros((1, cap_tokens * cfg.flow.up_stride, cfg.flow.output_size),
                      dtype=torch.float32, device=cfm_cache["pv"].device)
    return {"cfm": init_stream_state(cfg.flow, cfm_cache, window, batch=1), "mel": mel}


def s3gen_ref_flow_streaming(
    params: Dict,
    cfg: S3GenRefConfig,
    tokens: torch.Tensor,        # [B, T] ACCUMULATED chunk tokens, right-padded
    token_len: torch.Tensor,     # [B] valid tokens (old + new)
    new_len: torch.Tensor,       # [B] NEW tokens this slice (suffix of the valid ones)
    ref: Dict,
    noise_cfm: torch.Tensor,     # the chunk's CFM noise buffer (draw_noise(stream=True))
    rstate: Dict,                # init_s3gen_stream_state / the previous slice
    new_block_tokens: int,       # upper bound on new_len
    cfm_cache: Dict,             # the per-voice prompt cache ("step" mode)
    tp_group=None,
) -> Tuple[torch.Tensor, Dict]:
    """The flow of a streaming slice → (mel_gen [B, T·fpt, 80] float32: the
    frozen earlier frames and this slice's new ones, new state). See
    ``s3gen_ref_inference_streaming``."""
    B, T = tokens.shape
    fl = cfg.flow
    fpt = fl.up_stride
    Pm = cfg.max_prompt_tokens * fpt
    TgF = new_block_tokens * fpt
    mu, _, spk = _encode_mu(params, cfg, tokens, token_len, ref, tp_group)
    M = mu.shape[2]
    dev = mu.device
    # the NEW frames' mu, right-packed into the block
    total = token_len.to(dev).long() * fpt
    new = new_len.to(dev).long() * fpt
    old = total - new
    j = torch.arange(TgF, device=dev)[None, :]
    idx = (Pm + old[:, None] + (j - (TgF - new[:, None]))).clamp(0, mu.shape[1] - 1)
    mu_new = torch.gather(mu, 1, idx[:, :, None].expand(B, TgF, M))
    mel_new, new_cfm = cfm_generate_streaming(params["flow"]["estimator"], fl, noise_cfm,
                                              mu_new, spk, new, cfm_cache, rstate["cfm"],
                                              tp_group)
    # write the new frames into the frozen-mel buffer: only rows [old, total)
    # change, by a gather and a select
    buf = rstate["mel"]
    jj = torch.arange(buf.shape[1], device=dev)[None, :]
    is_new = (jj >= old[:, None]) & (jj < total[:, None])
    bsrc = (jj - old[:, None] + (TgF - new[:, None])).clamp(0, TgF - 1)
    gathered = torch.gather(mel_new.to(buf.dtype), 1, bsrc[:, :, None].expand(B, buf.shape[1], M))
    buf = torch.where(is_new[:, :, None], gathered, buf)
    return buf[:, : T * fpt], {"cfm": new_cfm, "mel": buf}


