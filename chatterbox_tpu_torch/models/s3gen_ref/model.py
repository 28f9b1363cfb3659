"""S3Gen (reference architecture) chunk inference — torch counterpart of
``chatterbox_tpu/models/s3gen_ref/model.py``.

``s3gen_ref_inference(tokens, ref, cache_source, noise) → (wav, source)``:
the left-packed [pad | prompt | generated] token track through the
upsample-conformer encoder, the CFM Euler solve with CFG, then the HiFT
vocoder with the excitation-prefix continuity contract (the cached source
overrides the new one over ``cache_len`` samples). Every random draw enters
through ``noise`` (``draw_noise`` makes one from a torch.Generator).
``s3gen_ref_inference_tail`` is the same chunk with the vocoder run only on
a receptive-field window around each row's emitted tail (exact). Both take
an optional per-voice CFM prompt cache (``s3gen_ref_prompt_prefill``), with
which the CFM solves the generated frames only.
``s3gen_ref_inference_streaming`` solves only a slice's new frames against
the prompt cache and the request's frozen earlier frames
(``init_s3gen_stream_state``); ``stack_stream_states`` and
``split_stream_state`` batch and unbatch those states.
``s3gen_ref_embed_ref(wav24, wav16) → ref`` builds the conditioning dict
from reference audio: prompt tokens (S3TokenizerV2), prompt mel (the HiFiGAN
front end) and the CAMPPlus x-vector, in fixed right-padded windows (mel
frames = up_stride × prompt tokens); ``conds.pt`` gives the same dict for
the snapshot's default voice.

Tensor parallelism: every entry point takes an optional ``tp_group``, with
``params`` this rank's shard (``parallel.shard_s3gen_ref_params``): the
conformer encoder and the CFM estimator run sharded and every rank gets the
same mel; the tokenizer, CAMPPlus and HiFT are replicated and run as
without a group. ``s3gen_ref_flow`` and ``s3gen_ref_flow_streaming`` stop
after the flow (the mel, and a streaming slice's new state): a rank whose
audio nobody reads runs those and skips the vocoder.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ...convert import convert_params
from ...ops.initializers import DenseInit
from ...ops.nn import linear
from .config import S3GenRefConfig
from .decoder import (
    STATE_LANE_AXIS,
    cfm_generate,
    cfm_generate_cached,
    cfm_generate_streaming,
    cfm_noise_frames,
    cfm_prompt_prefill,
    init_estimator_params,
    init_stream_state,
)
from .campplus import campplus_embed, campplus_param_tree
from .features import hifigan_log_mel, kaldi_fbank, reflect_tail
from .hift import (
    _upsample_total,
    hift_decode,
    hift_receptive_margin,
    init_hift_params,
    make_source,
    predict_f0,
)
from .tokenizer import s3tok_ref_param_tree, s3tok_ref_tokenize
from .upsample_encoder import init_upsample_encoder_params, upsample_encode

MEL_HOP_24K = 480  # HiFiGAN mel hop at 24 kHz (50 frames/s)


def init_s3gen_ref_params(cfg: S3GenRefConfig, generator: torch.Generator, device,
                          dtype=torch.float32) -> Dict:
    """Random parameters with the JAX package's distributions."""
    return convert_params(s3gen_ref_param_tree(cfg, DenseInit(generator, device)), device, dtype)


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


def s3gen_ref_embed_ref(
    params: Dict,
    cfg: S3GenRefConfig,
    wav24: torch.Tensor,      # [B, L24] 24 kHz reference audio, right-padded
    wav24_len: torch.Tensor,  # [B]
    wav16: torch.Tensor,      # [B, L16] the same audio at 16 kHz
    wav16_len: torch.Tensor,  # [B]
) -> Dict:
    """The voice's conditioning dict: spk_emb [B, 192] (the weights' dtype),
    prompt_tokens [B, P] and prompt_len, prompt_mel [B, Pm, 80] (float32)
    and prompt_mel_len; lengths and tokens int64."""
    # the padding past a short prompt holds its reflected tail: the last
    # frame's window reaches up to (n_fft - hop) / 2 samples past the valid
    # end, where the reference extractor sees reflected audio, not zeros
    mel = hifigan_log_mel(reflect_tail(wav24, wav24_len))          # [B, F, 80]
    Pm, P = cfg.max_prompt_mel, cfg.max_prompt_tokens
    mel = F.pad(mel, (0, 0, 0, max(0, Pm - mel.shape[1])))[:, :Pm]
    mel_len = (wav24_len.long() // MEL_HOP_24K).clamp_max(Pm)

    tokens, tok_len = s3tok_ref_tokenize(params["tokenizer"], cfg.tokenizer, wav16, wav16_len)
    tokens = F.pad(tokens, (0, max(0, P - tokens.shape[1])))[:, :P]
    # alignment rule: prompt mel frames == up_stride × prompt tokens
    tok_len = torch.minimum(tok_len, mel_len // cfg.flow.up_stride).clamp_max(P)
    mel_len = tok_len * cfg.flow.up_stride

    fb, fb_len = kaldi_fbank(wav16, wav16_len)
    fb_valid = torch.arange(fb.shape[1], device=fb.device)[None, :] < fb_len[:, None]
    mel_valid = torch.arange(Pm, device=mel.device)[None, :] < mel_len[:, None]
    return {
        "spk_emb": campplus_embed(params["speaker"], cfg.speaker, fb, fb_valid),
        "prompt_tokens": tokens,
        "prompt_len": tok_len,
        "prompt_mel": torch.where(mel_valid[:, :, None], mel, 0.0),
        "prompt_mel_len": mel_len,
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


def s3gen_ref_flow(params: Dict, cfg: S3GenRefConfig, tokens: torch.Tensor,
                   token_len: torch.Tensor, ref: Dict, noise_cfm: torch.Tensor,
                   cfm_cache: Dict | None = None, tp_group=None) -> torch.Tensor:
    """Encoder → CFM mel → mel_gen [B, T·fpt, 80] float32, zero past each
    row's valid frames. With ``cfm_cache`` the CFM solves only the generated
    frames against the frozen prompt context; the encoder still sees
    [prompt | generated], so ``mu`` is unchanged."""
    B, T = tokens.shape
    fl = cfg.flow
    Pm = cfg.max_prompt_tokens * fl.up_stride
    mu, valid_f, spk = _encode_mu(params, cfg, tokens, token_len, ref, tp_group)
    est = params["flow"]["estimator"]
    if cfm_cache is not None:
        mel_gen = cfm_generate_cached(est, fl, noise_cfm, mu[:, Pm:], spk, valid_f[:, Pm:],
                                      cfm_cache, tp_group)
    else:
        packed_mel = _packed_prompt_mel(cfg, ref, mu.dtype)
        cond = torch.cat([packed_mel, packed_mel.new_zeros(
            (B, T * fl.up_stride, packed_mel.shape[2]))], dim=1)
        mel_gen = cfm_generate(est, fl, noise_cfm, mu, spk, cond, valid_f, tp_group)[:, Pm:]
    mel_gen = torch.where(valid_f[:, Pm:, None], mel_gen, 0.0)
    # the mel→wav stack runs in float32 whatever the flow's activation dtype
    return mel_gen.float()


def _mel_and_source(params: Dict, cfg: S3GenRefConfig, tokens: torch.Tensor,
                    token_len: torch.Tensor, ref: Dict, source_cache: torch.Tensor,
                    cache_len: torch.Tensor, noise: Dict[str, torch.Tensor],
                    cfm_cache: Dict | None = None, tp_group=None):
    """``s3gen_ref_flow`` → NSF excitation → (mel_gen [B, T·fpt, 80] f32,
    source [B, T·spt])."""
    mel_gen = s3gen_ref_flow(params, cfg, tokens, token_len, ref, noise["cfm"], cfm_cache,
                             tp_group)
    source = _source_with_cache(params, cfg, mel_gen, source_cache, cache_len,
                                noise["rand_ini"], noise["nsf"])
    return mel_gen, source


def s3gen_ref_inference(
    params: Dict,
    cfg: S3GenRefConfig,
    tokens: torch.Tensor,        # [B, T] generated speech tokens, right-padded
    token_len: torch.Tensor,     # [B]
    ref: Dict,                   # conditioning dict (runtime/loader.py)
    source_cache: torch.Tensor,  # [B, T*samples_per_token] excitation prefix
    cache_len: torch.Tensor,     # [B] valid samples in source_cache
    noise: Dict[str, torch.Tensor],  # draw_noise(...)
    cfm_cache: Dict | None = None,   # s3gen_ref_prompt_prefill(...)
    tp_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming chunk → (wav [B, T·spt], new_source_cache [B, T·spt])."""
    mel_gen, source = _mel_and_source(params, cfg, tokens, token_len, ref, source_cache,
                                      cache_len, noise, cfm_cache, tp_group)
    return hift_decode(params["mel2wav"], cfg.hift, mel_gen, source), source


def s3gen_ref_inference_tail(
    params: Dict,
    cfg: S3GenRefConfig,
    tokens: torch.Tensor,        # [B, T] generated speech tokens, right-padded
    token_len: torch.Tensor,     # [B]
    ref: Dict,
    source_cache: torch.Tensor,  # [B, T*samples_per_token] excitation prefix
    cache_len: torch.Tensor,     # [B] valid samples in source_cache
    noise: Dict[str, torch.Tensor],
    start: torch.Tensor,         # [B] first wanted output sample (0 ≤ · ≤ T·spt − tail_len)
    tail_len: int,               # samples returned per row
    cfm_cache: Dict | None = None,
    tp_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk inference that vocodes only a window around the emitted tail →
    (wav_tail [B, tail_len] == full wav[:, start:start+tail_len],
    new_source_cache [B, T·spt]).

    Full-overlap serving re-synthesises the chunk's accumulated tokens every
    slice but emits only the new tail. The encoder and the CFM are
    bidirectional, but the mel→wav stack is local, so vocoding
    [start − margin, start + tail + margin] reproduces the emitted samples
    (margin = ``hift_receptive_margin``) at a vocoder cost that stays constant
    per slice."""
    mel_gen, source = _mel_and_source(params, cfg, tokens, token_len, ref, source_cache,
                                      cache_len, noise, cfm_cache, tp_group)
    return _vocode_tail_window(params, cfg, mel_gen, source, start, tail_len), source


def _rows(x: torch.Tensor, first: torch.Tensor, width: int) -> torch.Tensor:
    """Per-row window x[b, first[b] : first[b] + width] (along axis 1)."""
    idx = first.long()[:, None] + torch.arange(width, device=x.device)
    if x.dim() == 3:
        idx = idx[:, :, None].expand(-1, -1, x.shape[2])
    return torch.gather(x, 1, idx)


def _vocode_tail_window(params: Dict, cfg: S3GenRefConfig, mel_gen: torch.Tensor,
                        source: torch.Tensor, start: torch.Tensor, tail_len: int) -> torch.Tensor:
    """Vocode each row's receptive-field window → wav[:, start:start+tail_len]
    (see ``s3gen_ref_inference_tail``). Windows are whole tokens, so the mel
    and the source stay in step."""
    fpt = cfg.flow.up_stride
    spt = cfg.samples_per_token
    T = source.shape[1] // spt
    margin_tok = -(-hift_receptive_margin(cfg.hift) // spt) + 1
    tail_tok = -(-tail_len // spt)
    win_tok = min(T, tail_tok + 2 * margin_tok)
    start = start.long()
    w0_tok = (start // spt - margin_tok).clamp(0, T - win_tok)  # [B]
    mel_w = _rows(mel_gen, w0_tok * fpt, win_tok * fpt)
    src_w = _rows(source, w0_tok * spt, win_tok * spt)
    wav_w = hift_decode(params["mel2wav"], cfg.hift, mel_w, src_w)
    # the JAX slice clamps its start into the window; so does this one
    off = (start - w0_tok * spt).clamp(0, win_tok * spt - tail_len)
    return _rows(wav_w, off, tail_len)


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


def stack_stream_states(states: List[Dict]) -> Dict:
    """Batch-1 streaming states → one state of batch len(states): CFG lanes
    [c×B, u×B], a few copies for the whole tree."""
    if len(states) == 1:
        return states[0]
    cfm = {}
    for key, first in states[0]["cfm"].items():
        parts = [s["cfm"][key] for s in states]
        ax = STATE_LANE_AXIS.get(key)
        cfm[key] = torch.cat(parts) if ax is None else torch.stack(parts, ax + 1).flatten(ax, ax + 1)
    return {"cfm": cfm, "mel": torch.cat([s["mel"] for s in states])}


def split_stream_state(state: Dict, B: int) -> List[Dict]:
    """``stack_stream_states``' inverse (views, no copies)."""
    if B == 1:
        return [state]
    out = []
    for i in range(B):
        cfm = {}
        for key, a in state["cfm"].items():
            ax = STATE_LANE_AXIS.get(key)
            cfm[key] = a[i:i + 1] if ax is None else a.unflatten(ax, (2, B)).select(ax + 1, i)
        out.append({"cfm": cfm, "mel": state["mel"][i:i + 1]})
    return out


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


def s3gen_ref_inference_streaming(
    params: Dict,
    cfg: S3GenRefConfig,
    tokens: torch.Tensor,        # [B, T] ACCUMULATED chunk tokens, right-padded
    token_len: torch.Tensor,     # [B] valid tokens (old + new)
    new_len: torch.Tensor,       # [B] NEW tokens this slice (suffix of the valid ones)
    ref: Dict,
    source_cache: torch.Tensor,  # [B, T·spt] excitation prefix
    cache_len: torch.Tensor,     # [B] valid samples in source_cache
    noise: Dict[str, torch.Tensor],  # draw_noise(...) from the chunk's seed, every slice
    start: torch.Tensor,         # [B] first wanted output sample
    tail_len: int,               # samples returned per row
    rstate: Dict,                # init_s3gen_stream_state / the previous slice
    new_block_tokens: int,       # upper bound on new_len
    cfm_cache: Dict,             # the per-voice prompt cache ("step" mode)
    tp_group=None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Streaming full-overlap slice → (wav_tail [B, tail_len], new source
    cache [B, T·spt], new state).

    The CFM solves only the slice's new frames, right-packed in a block of
    ``new_block_tokens`` tokens, against the frozen prompt and earlier
    frames (``cfm_generate_streaming``); earlier frames' mel comes from the
    state's frozen buffer. The encoder still re-encodes the accumulated
    track (exact ``mu``), and excitation and tail vocoding keep their
    contracts. A chunk's first slice equals ``s3gen_ref_inference_tail`` with
    the same cache and noise up to float32 summation order; later slices are
    the JAX package's one-way deviation."""
    mel_gen, new_state = s3gen_ref_flow_streaming(params, cfg, tokens, token_len, new_len, ref,
                                                  noise["cfm"], rstate, new_block_tokens,
                                                  cfm_cache, tp_group)
    source = _source_with_cache(params, cfg, mel_gen, source_cache, cache_len,
                                noise["rand_ini"], noise["nsf"])
    wav_tail = _vocode_tail_window(params, cfg, mel_gen, source, start, tail_len)
    return wav_tail, source, new_state
