"""Core neural ops shared by all models (torch counterparts of
``chatterbox_tpu.ops.nn``).

Linear weights are stored the torch way, ``[out, in]``. The mixed-precision
contract is the JAX package's: products accumulate in float32, a result takes
its input's dtype, and a float32 activation times a bfloat16 weight computes
in float32 (JAX promotes there; the cast below makes torch do the same).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .precision import round_input

NEG_INF = -1e9  # large-negative mask value (finite: safe for softmax in bf16)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, w.dtype)
    if b is not None:
        dt = torch.promote_types(dt, b.dtype)
    y = F.linear(round_input(x.to(dt)), w.to(dt), None if b is None else b.to(dt))
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * weight


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    g = F.silu(linear(x, w_gate))
    return linear(g * linear(x, w_up), w_down)


# ----------------------------------------------------------------------- RoPE
def rope_frequencies(
    head_dim: int, max_len: int, theta: float = 10000.0, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_len, head_dim//2], float32."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate q/k. x: [B, S, H, Dh]; positions: [B, S] absolute positions."""
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------------------------ attention
def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full (prefill) attention. q,k,v: [B, S, H, Dh]; mask: [B, 1, Sq, Sk]
    additive or boolean (True = attend). Causal by default."""
    Sq, Sk, Dh = q.shape[1], k.shape[1], q.shape[3]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / Dh ** 0.5)
    if mask is None:
        causal = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril(Sk - Sq)
        scores = scores.masked_fill(~causal, NEG_INF)
    elif mask.dtype == torch.bool:
        scores = scores.masked_fill(~mask, NEG_INF)
    else:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
