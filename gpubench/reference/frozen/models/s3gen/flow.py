"""Conditional flow matching mel decoder of the DiT architecture: a DiT
estimator with AdaLN-zero time conditioning and a cosine-scheduled Euler
solve (torch counterpart of ``chatterbox_tpu/models/s3gen/flow.py``).

The flow computes in float32 whatever the weights' dtype: the initial noise
is float32 and ``linear`` promotes, as ``jnp.concatenate`` and ``jnp.dot``
do in the JAX package. The initial noise is an input.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ...ops.nn import causal_attention, layer_norm, linear
from .config import S3GenConfig


def flow_param_tree(cfg: S3GenConfig, init) -> Dict:
    D, L, Fd = cfg.dit_dim, cfg.dit_layers, cfg.dit_ffn
    M = cfg.n_mels
    return {
        "in_proj": {"w": init.dense((3 * M + 1, D)), "b": init.zeros((D,))},
        "time_mlp": {
            "w1": init.dense((256, D)), "b1": init.zeros((D,)),
            "w2": init.dense((D, D)), "b2": init.zeros((D,)),
        },
        "spk_proj": {"w": init.dense((cfg.spk_dim, D)), "b": init.zeros((D,))},
        "layers": {
            "norm1_w": init.ones((L, D)), "norm1_b": init.zeros((L, D)),
            "norm2_w": init.ones((L, D)), "norm2_b": init.zeros((L, D)),
            # AdaLN-zero modulation: 6 gates per layer from the time embedding
            "ada_w": init.zeros((L, D, 6 * D)),
            "ada_b": init.zeros((L, 6 * D)),
            "wq": init.dense((L, D, D)), "wk": init.dense((L, D, D)),
            "wv": init.dense((L, D, D)), "wo": init.dense((L, D, D)),
            "w1": init.dense((L, D, Fd)), "w2": init.dense((L, Fd, D)),
        },
        "out_norm_w": init.ones((D,)),
        "out_norm_b": init.zeros((D,)),
        "out_proj": {"w": init.zeros((D, M)), "b": init.zeros((M,))},
    }


def _time_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Sinusoidal embedding of the ODE time t ∈ [0, 1] → [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def estimator(
    params: Dict,
    cfg: S3GenConfig,
    x_t: torch.Tensor,         # [B, T, M] current noisy mel
    mu: torch.Tensor,          # [B, T, M] encoder features
    cond_mel: torch.Tensor,    # [B, T, M] prompt mel (zeros outside the prompt)
    prompt_flag: torch.Tensor, # [B, T, 1] 1.0 on prompt frames
    spk: torch.Tensor,         # [B, spk_dim]
    t: torch.Tensor,           # [B] ODE time
    valid: torch.Tensor,       # [B, T] frame validity
) -> torch.Tensor:
    """The flow vector field v(x_t, t) → [B, T, M] float32."""
    B, T, M = x_t.shape
    D, H = cfg.dit_dim, cfg.dit_heads
    Dh = D // H
    h = linear(torch.cat([x_t, mu, cond_mel, prompt_flag], dim=-1),  # promotes, as in JAX
               params["in_proj"]["w"], params["in_proj"]["b"])
    tm = params["time_mlp"]
    c = F.silu(linear(_time_embedding(t), tm["w1"], tm["b1"]))
    c = linear(c, tm["w2"], tm["b2"])
    c = c + linear(spk, params["spk_proj"]["w"], params["spk_proj"]["b"])
    c = F.silu(c)  # [B, D]
    mask = valid[:, None, :, None] & valid[:, None, None, :]
    lp = params["layers"]
    for i in range(cfg.dit_layers):
        ada = linear(c, lp["ada_w"][i], lp["ada_b"][i])  # [B, 6D]
        shift1, scale1, gate1, shift2, scale2, gate2 = ada[:, None].chunk(6, dim=-1)
        x = layer_norm(h, lp["norm1_w"][i], lp["norm1_b"][i])
        x = x * (1 + scale1) + shift1
        q = linear(x, lp["wq"][i]).reshape(B, T, H, Dh)
        k = linear(x, lp["wk"][i]).reshape(B, T, H, Dh)
        v = linear(x, lp["wv"][i]).reshape(B, T, H, Dh)
        o = causal_attention(q, k, v, mask)  # bidirectional
        h = h + gate1 * linear(o.reshape(B, T, D), lp["wo"][i])
        x = layer_norm(h, lp["norm2_w"][i], lp["norm2_b"][i])
        x = x * (1 + scale2) + shift2
        h = h + gate2 * linear(F.gelu(linear(x, lp["w1"][i]), approximate="tanh"), lp["w2"][i])
    h = layer_norm(h, params["out_norm_w"], params["out_norm_b"])
    return linear(h, params["out_proj"]["w"], params["out_proj"]["b"]).float()


def cfm_generate(
    params: Dict,
    cfg: S3GenConfig,
    noise: torch.Tensor,        # [B, ≥T, M] float32 initial noise
    mu: torch.Tensor,           # [B, T, M]
    cond_mel: torch.Tensor,     # [B, T, M]
    prompt_flag: torch.Tensor,  # [B, T, 1]
    spk: torch.Tensor,          # [B, spk_dim]
    valid: torch.Tensor,        # [B, T]
) -> torch.Tensor:
    """Euler-integrate the flow ODE from ``noise[:, :T]`` to the mel
    [B, T, M] on the cosine schedule. With ``cfg.cfm_cfg_rate`` r > 0 each
    step stacks the conditional and the unconditional (zeroed conditioning)
    passes into one estimator call of batch 2B and takes
    v = (1 + r)·v_cond − r·v_uncond."""
    B, T, _ = mu.shape
    x = noise[:, :T].float()
    i = torch.arange(cfg.cfm_steps + 1, dtype=torch.float32, device=mu.device) / cfg.cfm_steps
    ts = 1.0 - torch.cos(i * math.pi / 2.0)
    dts = ts[1:] - ts[:-1]
    r = cfg.cfm_cfg_rate
    if r > 0:
        mu, cond_mel, prompt_flag, spk = (torch.cat([a, torch.zeros_like(a)])
                                          for a in (mu, cond_mel, prompt_flag, spk))
        valid = torch.cat([valid, valid])
    for s in range(cfg.cfm_steps):
        xin = torch.cat([x, x]) if r > 0 else x
        v = estimator(params, cfg, xin, mu, cond_mel, prompt_flag, spk,
                      ts[s].expand(xin.shape[0]), valid)
        if r > 0:
            v = (1.0 + r) * v[:B] - r * v[B:]
        x = x + dts[s] * v
    return x
