"""T3: llama-style autoregressive text → speech-token decoder (torch
counterpart of ``chatterbox_tpu/models/t3/model.py``).

Parameters are the JAX package's nested dict in torch layouts
(``convert.py``); the backbone's per-layer weights stay stacked on a leading
layer axis. Rows are LEFT-padded, ``[pad | cond | text]``, and every request
runs two CFG lanes (cond, uncond). A decode slice is a Python loop of steps
with sampling, CFG, the repetition penalty and EOS on the device: the host
sees one result per slice.

KV cache (the port's layout): ``k``/``v`` ``[L, B, Hk, S, Dh]`` in the params
dtype or int8, with float32 scales ``[L, B, Hk, S]`` for int8, so one layer's
slice is contiguous for the decode-attention kernel. ``t3_decode_slice``
writes the cache and the decode state IN PLACE (JAX donates and rebuilds
them; here the tensors are updated where they lie).

Tensor parallelism (``parallel/``): ``_backbone_prefill``,
``_backbone_decode_step``, ``t3_prefill(_raw)``, ``t3_decode_slice`` and
``t3_forward_train`` take an optional ``tp_group``. Each rank then holds its
shard of the backbone's projections (``parallel.shard_params``) and runs its
local heads: head counts come from the shard's shapes, never from
``cfg.num_heads``, and each rank's KV cache holds its ``Hk/tp`` heads (the
int8 scales are per token and head, so quantising stays shard-local).
``copy_to_tp`` precedes the column-parallel products and ``reduce_from_tp``
follows the row-parallel ones (``parallel.tp.row_parallel``: the partial
products are summed in float32), so every rank holds the same residual stream,
the same logits and, with the counter-based sampler, the same tokens. With
no group both operators are the identity and the numbers are the unsharded
ones. A sharded run and an unsharded one sum their products in other
orders: in float32 they take the same tokens, in bf16 a near-tie of the
sampler's scores can part them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ...convert import convert_params
from ...ops.decode_attention import decode_attention
from ...ops.initializers import DenseInit
from ...ops.nn import (
    NEG_INF,
    apply_rope,
    causal_attention,
    layer_norm,
    linear,
    rms_norm,
    rope_frequencies,
)
from ...ops.sampling import counter_gumbel, top_p_filter
from ...parallel.tp import copy_to_tp, row_parallel
from .config import T3Config

Params = Dict
_LAYER_KEYS = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


# ------------------------------------------------------------------ init
def init_t3_params(cfg: T3Config, generator: torch.Generator, device,
                   dtype=torch.float32) -> Params:
    """Random init with the JAX package's distributions, built in the JAX
    layout and converted."""
    return convert_params(t3_param_tree(cfg, DenseInit(generator, device)), device, dtype)


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
        if remat:
            out = torch.utils.checkpoint.checkpoint(layer, h, i, use_reentrant=False)
        else:
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


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token-per-head int8: x [..., Dh] → (int8, scale [...])."""
    x32 = x.float()
    scale = x32.abs().amax(-1).clamp_min(1e-8) / 127.0
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _backbone_decode_step(
    params: Params,
    cfg: T3Config,
    h: torch.Tensor,      # [B, 1, D]
    cache: Dict,
    s_view: Optional[int] = None,
    tp_group=None,
) -> torch.Tensor:
    """One decode step through all layers; attends each layer's cached
    ``[start, pos)`` plus the current token, then writes the token's k/v into
    the cache at ``pos`` (in place). Returns the final hidden [B, 1, D].
    Under ``tp_group`` the rank attends its own heads (K1 at H/tp heads)."""
    B = h.shape[0]
    Dh = cfg.head_dim
    Hq, Hk = _local_heads(params, cfg)
    start, pos = cache["start"], cache["pos"]
    quantized = "k_scale" in cache
    cos, sin = rope_frequencies(Dh, cfg.max_seq_len, cfg.rope_theta, h.device)
    positions = pos.long()[:, None]
    lanes = torch.arange(B, device=h.device)
    write_at = pos.long()
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        x = copy_to_tp(rms_norm(h, lp["attn_norm"], cfg.rms_eps), tp_group)
        q = apply_rope(linear(x, lp["wq"]).reshape(B, 1, Hq, Dh), cos, sin, positions)
        k = apply_rope(linear(x, lp["wk"]).reshape(B, 1, Hk, Dh), cos, sin, positions)
        v = linear(x, lp["wv"]).reshape(B, 1, Hk, Dh)
        kc, vc = cache["k"][i], cache["v"][i]
        ksc = cache["k_scale"][i] if quantized else None
        vsc = cache["v_scale"][i] if quantized else None
        o = decode_attention(q[:, 0].contiguous(), kc, vc, k[:, 0].contiguous(),
                             v[:, 0].contiguous(), start, pos, ksc, vsc, s_view=s_view)
        # this step's k/v join the cache after attention (it is the self-term)
        if quantized:
            kq, ks = _quantize_kv(k[:, 0])
            vq, vs = _quantize_kv(v[:, 0])
            kc[lanes, :, write_at] = kq
            vc[lanes, :, write_at] = vq
            ksc[lanes, :, write_at] = ks
            vsc[lanes, :, write_at] = vs
        else:
            kc[lanes, :, write_at] = k[:, 0]
            vc[lanes, :, write_at] = v[:, 0]
        h = h + row_parallel(o.reshape(B, 1, -1), lp["wo"], None, tp_group)
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], cfg.rms_eps), lp, tp_group)
    return rms_norm(h, params["backbone"]["final_norm"], cfg.rms_eps)


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


def t3_prefill_raw(params: Params, cfg: T3Config, cond, text_tokens, text_len, tp_group=None):
    """Prefix through the backbone → (k_all, v_all [L, B, P, Hk, Dh], pad [B])."""
    h, valid, pad = _left_pack_prefix(params, cfg, cond, text_tokens, text_len)
    h = h.to(params["text_emb"].dtype)
    _, k_all, v_all = _backbone_prefill(params, cfg, h, valid, tp_group=tp_group)
    return k_all, v_all, pad


def t3_prefill(params: Params, cfg: T3Config, cond: torch.Tensor,
               text_tokens: torch.Tensor, text_len: torch.Tensor, tp_group=None) -> Dict:
    """Prefill → a per-request cache grown to the decode budget
    (S = P + 1 + max_speech_tokens), in the port's layout (under
    ``tp_group``, this rank's kv heads)."""
    B = cond.shape[0]
    P = cond.shape[1] + text_tokens.shape[1]
    k_all, v_all, pad = t3_prefill_raw(params, cfg, cond, text_tokens, text_len, tp_group)
    S_max = P + 1 + cfg.max_speech_tokens
    # [L, B, P, Hk, Dh] → [L, B, Hk, P, Dh], zero-padded along S
    to_cache = lambda x: F.pad(x.permute(0, 1, 3, 2, 4), (0, 0, 0, S_max - P)).contiguous()  # noqa: E731
    to_scales = lambda s: F.pad(s.permute(0, 1, 3, 2), (0, S_max - P)).contiguous()  # noqa: E731
    cache = {"start": pad, "pos": torch.full((B,), P, dtype=torch.int32, device=cond.device)}
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _quantize_kv(k_all)
        vq, vs = _quantize_kv(v_all)
        cache.update(k=to_cache(kq), v=to_cache(vq), k_scale=to_scales(ks), v_scale=to_scales(vs))
    else:
        cache.update(k=to_cache(k_all), v=to_cache(v_all))
    return cache


# ---------------------------------------------------------------- decode
def make_decode_state(cfg: T3Config, seeds, temperature, top_p, cfg_weight,
                      rep_penalty, device) -> Dict:
    """Decode state for R = len(seeds) requests. Row r samples with noise
    from (seeds[r], its own step) only (``counter_gumbel``), so its tokens do
    not depend on the other rows or on which row it occupies."""
    R = len(seeds)
    vec = lambda x: torch.full((R,), float(x), dtype=torch.float32, device=device)  # noqa: E731
    return {
        "last_token": torch.full((R,), cfg.start_speech_token, dtype=torch.int64, device=device),
        "step": torch.zeros((R,), dtype=torch.int64, device=device),
        "done": torch.zeros((R,), dtype=torch.bool, device=device),
        "token_counts": torch.zeros((R, cfg.speech_vocab_size), dtype=torch.int32, device=device),
        "seed": torch.as_tensor([int(x) & 0x7FFFFFFF for x in seeds], dtype=torch.int64,
                                device=device),
        "temperature": vec(temperature),
        "top_p": vec(top_p),
        "cfg_weight": vec(cfg_weight),
        "rep_penalty": vec(rep_penalty),
    }


def _invalid_token_mask(cfg: T3Config, device) -> torch.Tensor:
    """Logit mask forbidding non-code, non-stop ids (BOS, unused specials)."""
    ids = torch.arange(cfg.speech_vocab_size, device=device)
    allowed = (ids < cfg.num_speech_codes) | (ids == cfg.stop_speech_token)
    return torch.where(allowed, 0.0, NEG_INF)


def t3_decode_slice(
    params: Params,
    cfg: T3Config,
    cache: Dict,
    state: Dict,
    n_steps: int,
    s_view: Optional[int] = None,
    gumbel: Optional[torch.Tensor] = None,   # [n_steps, R, V] injected noise
    tp_group=None,
) -> torch.Tensor:
    """Generate ``n_steps`` speech tokens → tokens [R, n_steps] (a device
    tensor). ``cache`` and ``state`` advance in place. Lanes are
    [r0-cond, r0-uncond, r1-cond, …]; finished requests re-emit the stop
    token and do not advance. ``s_view`` (≥ max(pos) + n_steps) bounds the
    plain attention's read; the kernel bounds each row at its own pos.
    ``gumbel`` replaces the counter-based draws of ``state["seed"]`` (tests).
    Under ``tp_group`` every rank gets the same logits (the speech head is
    replicated) and draws the same noise, so every rank takes the same
    tokens."""
    R = state["last_token"].shape[0]
    dev = state["last_token"].device
    token_mask = _invalid_token_mask(cfg, dev)
    rows = torch.arange(R, device=dev)
    tokens = []
    for t in range(n_steps):
        active_lanes = (~state["done"]).repeat_interleave(2)
        tok_lanes = state["last_token"].repeat_interleave(2)
        step_lanes = state["step"].repeat_interleave(2).clamp(0, cfg.max_speech_tokens + 1)
        h = params["speech_emb"][tok_lanes][:, None, :]
        if cfg.learned_pos_emb:
            h = h + params["speech_pos"][step_lanes][:, None, :]
        hidden = _backbone_decode_step(params, cfg, h, cache, s_view, tp_group)
        cache["pos"] += active_lanes.to(torch.int32)
        logits = linear(hidden[:, 0], params["speech_head"]["w"], params["speech_head"]["b"]).float()
        pair = logits.reshape(R, 2, -1)
        w = state["cfg_weight"][:, None]
        guided = pair[:, 0] + w * (pair[:, 0] - pair[:, 1]) + token_mask[None]
        rp = state["rep_penalty"][:, None]
        guided = torch.where(state["token_counts"] > 0,
                             torch.where(guided > 0, guided / rp, guided * rp), guided)
        noise = gumbel[t] if gumbel is not None else counter_gumbel(
            state["seed"], state["step"], guided.shape[-1])
        filtered = top_p_filter(guided / state["temperature"][:, None].clamp_min(1e-4),
                                state["top_p"])
        sampled = (filtered + noise).argmax(-1)
        greedy = guided.argmax(-1)
        token = torch.where(state["temperature"] <= 0.0, greedy, sampled)
        token = torch.where(state["done"], cfg.stop_speech_token, token)
        active = ~state["done"]
        state["token_counts"][rows, token] += active.to(torch.int32)
        state["done"] |= token == cfg.stop_speech_token
        state["step"] += active.to(torch.int64)
        state["last_token"] = token
        tokens.append(token)
    return torch.stack(tokens, dim=1)


# ---------------------------------------------------------------- training
def t3_forward_train(
    params: Params,
    cfg: T3Config,
    cond: torch.Tensor,           # [B, C, D]
    text_tokens: torch.Tensor,    # [B, T]
    speech_tokens: torch.Tensor,  # [B, S] target speech tokens (BOS-shifted inputs)
    text_len: Optional[torch.Tensor] = None,  # [B] valid text lengths
    remat: bool = True,
    tp_group=None,
) -> torch.Tensor:
    """Teacher-forced forward pass → speech logits [B, S, V_speech] float32.

    Input: ``[pad | cond | text]`` left-packed as serving's prefill packs it
    (so the RoPE distance from the last text token to speech BOS is the
    same in training and inference), then BOS and ``speech[:-1]``. The
    hidden state takes the params' dtype, as serving's prefill does.
    ``remat=True`` (default) recomputes each layer in the backward pass;
    no K/V is stacked. ``tp_group``: this rank's shard of the backbone, as
    in ``_backbone_prefill``; the logits are the same on every rank."""
    B, T = text_tokens.shape
    S = speech_tokens.shape[1]
    dev = cond.device
    bos = torch.full((B, 1), cfg.start_speech_token, dtype=torch.long, device=dev)
    speech_in = torch.cat([bos, speech_tokens[:, :-1].long()], 1)
    speech_emb = params["speech_emb"][speech_in]
    if cfg.learned_pos_emb:
        speech_emb = speech_emb + params["speech_pos"][:S][None]
    if text_len is None:
        text_len = torch.full((B,), T, dtype=torch.int32, device=dev)
    prefix, prefix_valid, _ = _left_pack_prefix(params, cfg, cond, text_tokens, text_len)
    h = torch.cat([prefix, speech_emb.to(prefix.dtype)], 1).to(params["text_emb"].dtype)
    valid = torch.cat([prefix_valid, torch.ones((B, S), dtype=torch.bool, device=dev)], 1)
    hidden, _, _ = _backbone_prefill(params, cfg, h, valid, collect_kv=False, remat=remat,
                                     tp_group=tp_group)
    return linear(hidden[:, cond.shape[1] + T:], params["speech_head"]["w"],
                  params["speech_head"]["b"]).float()
