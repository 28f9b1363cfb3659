"""T3 (a frozen copy of the port's ``models/t3/model.py``, the parts the
reference runs): the parameter tree, the conditioning prefix (speaker,
perceiver-resampled prompt, emotion) and the backbone over a whole
sequence with a causal mask. No KV cache, no decode loop, no sampler, no
tensor parallelism.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops.nn import (
    apply_rope,
    causal_attention,
    layer_norm,
    linear,
    rms_norm,
    rope_frequencies,
)
from ...parallel.tp import copy_to_tp, row_parallel
from .config import T3Config

Params = Dict
_LAYER_KEYS = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


# ------------------------------------------------------------------ init


def t3_param_tree(cfg: T3Config, init) -> Params:
    """The JAX-layout tree, its leaves drawn by ``init`` (``DenseInit`` or
    ``ShapeInit``)."""
    D, L = cfg.hidden_size, cfg.num_layers
    Hq, Hk, Dh, Fi = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.intermediate_size
    dense, zeros, ones = init.dense, init.zeros, init.ones
    params: Params = {
        "text_emb": dense((cfg.text_vocab_size, D), 0.02),
        "speech_emb": dense((cfg.speech_vocab_size, D), 0.02),
        "text_pos": dense((cfg.max_text_tokens + 2, D), 0.02),
        "speech_pos": dense((cfg.max_speech_tokens + 2, D), 0.02),
        "speech_head": {"w": dense((D, cfg.speech_vocab_size)), "b": zeros((cfg.speech_vocab_size,))},
        "text_head": {"w": dense((D, cfg.text_vocab_size)), "b": zeros((cfg.text_vocab_size,))},
        "cond": {
            "spkr": {"w": dense((cfg.speaker_embed_dim, D)), "b": zeros((D,))},
            "emotion": {"w": dense((1, D)), "b": zeros((D,))},
        },
        "backbone": {
            "layers": {
                "attn_norm": ones((L, D)),
                "mlp_norm": ones((L, D)),
                "wq": dense((L, D, Hq * Dh)),
                "wk": dense((L, D, Hk * Dh)),
                "wv": dense((L, D, Hk * Dh)),
                "wo": dense((L, Hq * Dh, D)),
                "w_gate": dense((L, D, Fi)),
                "w_up": dense((L, D, Fi)),
                "w_down": dense((L, Fi, D)),
            },
            "final_norm": ones((D,)),
        },
    }
    if cfg.use_perceiver_resampler:
        N = cfg.perceiver_latents
        lin = lambda: {"w": dense((D, D)), "b": zeros((D,))}  # noqa: E731
        params["cond"]["perceiver"] = {
            "query": dense((N, D), math.sqrt(3.0 / N)),
            "attn": {"norm_w": ones((D,)), "norm_b": zeros((D,)),
                     "wq": lin(), "wk": lin(), "wv": lin(), "wo": lin()},
        }
    return params


def _layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    layers = params["backbone"]["layers"]
    return {k: layers[k][i] for k in _LAYER_KEYS}


# ---------------------------------------------------------------- conditioning
def _perceiver_attn_block(p: Params, heads: int, x_q, x_kv,
                          kv_valid: Optional[torch.Tensor] = None):
    """Shared-LayerNorm residual attention block (Chatterbox perceiver)."""
    B, Sq, D = x_q.shape
    Dh = D // heads
    xqn = layer_norm(x_q, p["norm_w"], p["norm_b"])
    xkn = layer_norm(x_kv, p["norm_w"], p["norm_b"])
    q = linear(xqn, p["wq"]["w"], p["wq"]["b"]).reshape(B, Sq, heads, Dh)
    k = linear(xkn, p["wk"]["w"], p["wk"]["b"]).reshape(B, -1, heads, Dh)
    v = linear(xkn, p["wv"]["w"], p["wv"]["b"]).reshape(B, -1, heads, Dh)
    Sk = k.shape[1]
    if kv_valid is None:
        mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=x_q.device)
    else:
        mask = kv_valid[:, None, None, :].expand(B, 1, Sq, Sk)
    o = causal_attention(q, k, v, mask=mask)
    return x_q + linear(o.reshape(B, Sq, D), p["wo"]["w"], p["wo"]["b"])


def perceiver_resample(p: Params, cfg: T3Config, prompt_emb: torch.Tensor,
                       prompt_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, P, D] prompt embeddings → [B, N, D] latents: one shared block,
    cross (queries → prompt) then self."""
    B = prompt_emb.shape[0]
    q = p["query"][None].expand(B, *p["query"].shape).to(prompt_emb.dtype)
    pre = _perceiver_attn_block(p["attn"], cfg.perceiver_heads, q, prompt_emb, prompt_valid)
    return _perceiver_attn_block(p["attn"], cfg.perceiver_heads, pre, pre)


def _cat(xs, dim):
    """Concatenate with JAX's type promotion (torch.cat wants one dtype)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.cat([x.to(dt) for x in xs], dim=dim)


def cond_embeddings(
    params: Params,
    cfg: T3Config,
    speaker_emb: torch.Tensor,     # [B, speaker_embed_dim]
    prompt_tokens: torch.Tensor,   # [B, speech_cond_prompt_len] int
    emotion_adv: torch.Tensor,     # [B] exaggeration scalar
    prompt_len: Optional[torch.Tensor] = None,  # [B] valid prompt token counts
) -> torch.Tensor:
    """Conditioning prefix [B, C, D]: [speaker] + resampled prompt + [emotion]."""
    c = params["cond"]
    spk = linear(speaker_emb, c["spkr"]["w"], c["spkr"]["b"])[:, None, :]
    prompt = params["speech_emb"][prompt_tokens.long()]
    P = prompt_tokens.shape[1]
    valid = None
    if prompt_len is not None:
        valid = torch.arange(P, device=prompt.device)[None, :] < prompt_len[:, None]
    if cfg.use_perceiver_resampler:
        prompt = perceiver_resample(c["perceiver"], cfg, prompt, valid)
    elif valid is not None:
        prompt = torch.where(valid[:, :, None], prompt, 0.0)
    emo = linear(emotion_adv[:, None], c["emotion"]["w"], c["emotion"]["b"])[:, None, :]
    return _cat([spk, prompt, emo], 1)


# ---------------------------------------------------------------- backbone
def _maybe_repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, Hk, Dh] → [B, S, n_heads, Dh] (each kv head repeated for its
    query heads)."""
    if k.shape[2] == n_heads:
        return k
    return k.repeat_interleave(n_heads // k.shape[2], dim=2)


def _local_heads(params: Params, cfg: T3Config) -> Tuple[int, int]:
    """(query heads, kv heads) of this rank's shard of the backbone."""
    layers = params["backbone"]["layers"]
    return layers["wq"].shape[1] // cfg.head_dim, layers["wk"].shape[1] // cfg.head_dim


def _mlp(x, lp, tp_group):
    """SwiGLU with the gate/up rows column-parallel and w_down row-parallel."""
    x = copy_to_tp(x, tp_group)
    g = F.silu(linear(x, lp["w_gate"]))
    return row_parallel(g * linear(x, lp["w_up"]), lp["w_down"], None, tp_group)


def _backbone_prefill(params: Params, cfg: T3Config, h: torch.Tensor, valid: torch.Tensor, *,
                      collect_kv: bool = True, remat: bool = False, tp_group=None):
    """All layers over [B, S, D] → (hidden, k_all, v_all [L, B, S, Hk, Dh]),
    Hk this rank's kv heads under ``tp_group``.

    ``collect_kv=False`` stacks no K/V and returns (hidden, None, None): the
    training pass decodes nothing from it. ``remat=True`` runs each layer
    under ``torch.utils.checkpoint`` so the backward pass recomputes the
    layer's activations instead of keeping every layer's alive. The layer
    reads its weights from the stacked tree, outside its explicit inputs:
    only the non-reentrant form gives those weights their gradients. Under
    ``tp_group`` every rank recomputes its collectives in the same order."""
    B, S, _ = h.shape
    Dh = cfg.head_dim
    Hq, Hk = _local_heads(params, cfg)
    cos, sin = rope_frequencies(Dh, cfg.max_seq_len, cfg.rope_theta, h.device)
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    mask = causal[None, None] & valid[:, None, None, :]

    def layer(h, i):
        lp = _layer(params, i)
        x = copy_to_tp(rms_norm(h, lp["attn_norm"], cfg.rms_eps), tp_group)
        q = apply_rope(linear(x, lp["wq"]).reshape(B, S, Hq, Dh), cos, sin, positions)
        k = apply_rope(linear(x, lp["wk"]).reshape(B, S, Hk, Dh), cos, sin, positions)
        v = linear(x, lp["wv"]).reshape(B, S, Hk, Dh)
        o = causal_attention(q, _maybe_repeat_kv(k, Hq), _maybe_repeat_kv(v, Hq), mask)
        h = h + row_parallel(o.reshape(B, S, -1), lp["wo"], None, tp_group)
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], cfg.rms_eps), lp, tp_group)
        return (h, k, v) if collect_kv else h

    ks, vs = [], []
    for i in range(cfg.num_layers):
        out = layer(h, i)
        if collect_kv:
            h, k, v = out
            ks.append(k)
            vs.append(v)
        else:
            h = out
    h = rms_norm(h, params["backbone"]["final_norm"], cfg.rms_eps)
    if collect_kv:
        return h, torch.stack(ks), torch.stack(vs)
    return h, None, None


# ---------------------------------------------------------------- prefill
def _left_pack_prefix(params: Params, cfg: T3Config, cond: torch.Tensor,
                      text_tokens: torch.Tensor, text_len: torch.Tensor):
    """[pad(T_pad - t_len) | cond | text] → (h [B, P, D], valid [B, P], pad [B])."""
    T_pad = text_tokens.shape[1]
    P = cond.shape[1] + T_pad
    dev = cond.device
    text_emb = params["text_emb"][text_tokens.long()]
    if cfg.learned_pos_emb:
        text_emb = text_emb + params["text_pos"][:T_pad][None]
    packed = _cat([cond, text_emb], 1)
    pad = (T_pad - text_len).to(torch.int32)
    j = torch.arange(P, device=dev)[None, :]
    src = (j - pad[:, None]).clamp(0, P - 1)
    h = torch.gather(packed, 1, src[:, :, None].expand(-1, -1, packed.shape[2]))
    valid = j >= pad[:, None]
    h = torch.where(valid[:, :, None], h, 0.0)
    return h, valid, pad


# ---------------------------------------------------------------- decode


# ---------------------------------------------------------------- training
