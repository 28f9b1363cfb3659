"""UpsampleConformerEncoder: the flow's token encoder (torch counterpart of
``chatterbox_tpu/models/s3gen_ref/upsample_encoder.py``).

Linear embed (×√D, ESPnet rel-pos convention) → pre-lookahead conv → N
conformer blocks (rel-pos self-attention with pos_bias_u/v, SiLU FFN,
pre-norm) → nearest ×2 upsample + causal k5 conv → second embed → M blocks →
final LayerNorm. The relative-position term uses the ESPnet pad-and-shift
form (pure pad/reshape/slice), as the JAX package does.

Tensor parallelism (``parallel/sharding.py``): under ``tp_group`` a
conformer attention whose q/k/v/pos rows and ``bias_u``/``bias_v`` hold
this rank's heads attends over those heads (counted from the shard's
shapes) and sums ``out`` over the group (``parallel.tp.row_parallel``); a
feed-forward whose ``w1`` holds a shard of the units sums ``w2`` the same
way. A block left whole by the rules runs as without a group.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.conv import conv1d
from ...ops.nn import NEG_INF, layer_norm, linear
from ...parallel.tp import row_parallel
from .config import FlowRefConfig


@lru_cache(maxsize=32)
def _rel_pos_table_np(T: int, d: int) -> np.ndarray:
    """[2T-1, d] sinusoid table, ascending in relative distance r = k-(T-1)."""
    r = (np.arange(2 * T - 1) - (T - 1))[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d, 2) * -(np.log(10000.0) / d))
    table = np.zeros((2 * T - 1, d))
    table[:, 0::2] = np.sin(r * div)
    table[:, 1::2] = np.cos(r * div)
    return table.astype(np.float32)


def init_conformer_block(init, D: int, H: int, units: int) -> Dict:
    mk = lambda *shape: init.dense(shape)  # noqa: E731
    dk = D // H
    return {
        "attn": {
            "q": {"w": mk(D, D), "b": mk(D)},
            "k": {"w": mk(D, D), "b": mk(D)},
            "v": {"w": mk(D, D), "b": mk(D)},
            "out": {"w": mk(D, D), "b": mk(D)},
            "pos": {"w": mk(D, D)},
            "bias_u": mk(H, dk),
            "bias_v": mk(H, dk),
        },
        "norm_mha": {"w": mk(D), "b": mk(D)},
        "ff": {"w1": {"w": mk(D, units), "b": mk(units)}, "w2": {"w": mk(units, D), "b": mk(D)}},
        "norm_ff": {"w": mk(D), "b": mk(D)},
    }


def init_upsample_encoder_params(init, cfg: FlowRefConfig) -> Dict:
    """JAX-layout tree (convert with ``convert.convert_params``)."""
    E = cfg.input_size
    mk = lambda *shape: init.dense(shape)  # noqa: E731
    embed = lambda: {"lin": {"w": mk(E, E), "b": mk(E)}, "ln": {"w": mk(E), "b": mk(E)}}  # noqa: E731
    block = lambda: init_conformer_block(init, E, cfg.attention_heads, cfg.linear_units)  # noqa: E731
    return {
        "embed": embed(),
        "lookahead": {
            "conv1": {"w": mk(cfg.pre_lookahead_len + 1, E, E), "b": mk(E)},
            "conv2": {"w": mk(3, E, E), "b": mk(E)},
        },
        "blocks": [block() for _ in range(cfg.num_blocks)],
        "up_conv": {"w": mk(2 * cfg.up_stride + 1, E, E), "b": mk(E)},
        "up_embed": embed(),
        "up_blocks": [block() for _ in range(cfg.num_up_blocks)],
        "after_norm": {"w": mk(E), "b": mk(E)},
    }


def _rel_pos_attention(p: Dict, cfg: FlowRefConfig, x: torch.Tensor,
                       valid: torch.Tensor, tp_group=None) -> torch.Tensor:
    """scores[i,j] = ((q_i+u)·k_j + (q_i+v)·pos[(T-1)+(i-j)]) / √dk, keys
    masked, over this shard's heads."""
    B, T, E = x.shape
    dk = E // cfg.attention_heads
    H = p["bias_u"].shape[0]
    group = tp_group if H < cfg.attention_heads else None
    q = linear(x, p["q"]["w"], p["q"]["b"]).reshape(B, T, H, dk)
    k = linear(x, p["k"]["w"], p["k"]["b"]).reshape(B, T, H, dk)
    v = linear(x, p["v"]["w"], p["v"]["b"]).reshape(B, T, H, dk)
    table = torch.as_tensor(_rel_pos_table_np(T, E), dtype=x.dtype, device=x.device)
    pos = linear(table, p["pos"]["w"]).reshape(2 * T - 1, H, dk)
    qu = q + p["bias_u"][None, None]
    qv = q + p["bias_v"][None, None]
    ac = torch.einsum("bihd,bjhd->bhij", qu.float(), k.float())
    # bd[i, j] = qv_i · pos[(T-1) + (i-j)] by the ESPnet pad-and-shift trick
    bd_full = torch.einsum("bihd,khd->bhik", qv.float(), pos.flip(0).float())
    x_p = F.pad(bd_full, (1, 0)).reshape(B, H, 2 * T, T)[:, :, 1:]
    bd = x_p.reshape(B, H, T, 2 * T - 1)[..., :T]
    scores = (ac + bd) / np.sqrt(dk)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhij,bjhd->bihd", probs.float(), v.float())
    return row_parallel(out.reshape(B, T, H * dk).to(x.dtype), p["out"]["w"], p["out"]["b"],
                        group)


def _conformer_stack(blocks: List[Dict], cfg: FlowRefConfig, x: torch.Tensor,
                     valid: torch.Tensor, tp_group=None) -> torch.Tensor:
    for blk in blocks:
        h = layer_norm(x, blk["norm_mha"]["w"], blk["norm_mha"]["b"])
        x = x + _rel_pos_attention(blk["attn"], cfg, h, valid, tp_group)
        h = layer_norm(x, blk["norm_ff"]["w"], blk["norm_ff"]["b"])
        ff = blk["ff"]
        group = tp_group if ff["w1"]["w"].shape[0] < cfg.linear_units else None
        h = row_parallel(F.silu(linear(h, ff["w1"]["w"], ff["w1"]["b"])), ff["w2"]["w"],
                         ff["w2"]["b"], group)
        x = x + h
    return x


def _embed(p: Dict, x: torch.Tensor, keep_dtype: bool = False) -> torch.Tensor:
    """LinearNoSubsampling + the rel-pos encoder's ×√D input scale.

    This is where the JAX flow turns float32 with bfloat16 weights: it
    multiplies by an ``np.float32`` scale, which JAX promotes and torch would
    not. The explicit upcast reproduces that, so the whole downstream flow
    (and the flash-MHA kernel) sees float32. ``keep_dtype``
    (cfg.bf16_activations) scales in the chain's own dtype instead."""
    h = layer_norm(linear(x, p["lin"]["w"], p["lin"]["b"]), p["ln"]["w"], p["ln"]["b"])
    scale = float(np.sqrt(h.shape[-1]))
    if keep_dtype:
        return h * scale
    return h.float() * np.float32(scale)


def upsample_encode(params: Dict, cfg: FlowRefConfig, x: torch.Tensor,
                    valid: torch.Tensor, tp_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, E] embedded tokens (invalid positions zeroed), valid [B, T]
    → ([B, T*up_stride, E], upsampled valid mask). ``tp_group``: the
    conformer blocks hold this rank's shard (every rank gets the same
    output)."""
    vm = valid[:, :, None]
    x = torch.where(vm, _embed(params["embed"], x, cfg.bf16_activations), 0.0)
    la = params["lookahead"]
    h = F.pad(x, (0, 0, 0, cfg.pre_lookahead_len))
    h = F.leaky_relu(conv1d(h, la["conv1"]["w"], la["conv1"]["b"], padding="VALID"), 0.01)
    h = conv1d(h, la["conv2"]["w"], la["conv2"]["b"], padding="CAUSAL")
    x = torch.where(vm, x + h, 0.0)

    x = _conformer_stack(params["blocks"], cfg, x, valid, tp_group)

    s = cfg.up_stride
    x = torch.where(vm, x, 0.0)
    up = F.pad(x.repeat_interleave(s, dim=1), (0, 0, 2 * s, 0))
    up = conv1d(up, params["up_conv"]["w"], params["up_conv"]["b"], padding="VALID")
    valid_up = valid.repeat_interleave(s, dim=1)
    up = torch.where(valid_up[:, :, None],
                     _embed(params["up_embed"], up, cfg.bf16_activations), 0.0)
    up = _conformer_stack(params["up_blocks"], cfg, up, valid_up, tp_group)
    up = layer_norm(up, params["after_norm"]["w"], params["after_norm"]["b"])
    return up, valid_up
