"""On-device token sampling: repetition penalty, top-p, temperature
(torch counterparts of ``chatterbox_tpu.ops.sampling``).

The random draw enters as a tensor (Gumbel noise), so the tests can feed the
JAX package's own ``jax.random.gumbel`` numbers to both sides:
``jax.random.categorical(key, logits)`` is ``argmax(logits + gumbel(key))``.
"""
from __future__ import annotations

import torch

from .nn import NEG_INF


def apply_repetition_penalty(
    logits: torch.Tensor, token_counts: torch.Tensor, penalty
) -> torch.Tensor:
    """CTRL-style penalty on every token already generated (counts > 0).
    ``penalty`` is a float or a tensor broadcastable to ``logits``."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(token_counts > 0, penalized, logits)


def top_p_filter(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Mask logits outside the nucleus without a sort: the threshold
    t* = max{t : mass{e >= t} >= top_p} found by 30 bisection passes over the
    unnormalised softmax masses (``chatterbox_tpu.ops.sampling.top_p_filter``
    documents why it equals the sort-based filter). The argmax and its ties
    always survive. ``top_p`` is a float or a tensor of ``logits.shape[:-1]``."""
    p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device).expand(logits.shape[:-1])
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    e_max = e.amax(-1)
    target = p * e.sum(-1)
    lo = torch.zeros_like(target)
    hi = e_max * 1.000001 + 1e-30
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        mass = torch.where(e >= mid[..., None], e, 0.0).sum(-1)
        ge = mass >= target
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    keep = (e >= lo[..., None]) | (e >= e_max[..., None])
    return torch.where(keep, logits, NEG_INF)


_M32 = 0xFFFFFFFF


def counter_gumbel(seed: torch.Tensor, step: torch.Tensor, vocab: int) -> torch.Tensor:
    """Standard Gumbel noise [R, vocab] (the noise ``sample_token`` takes)
    from a counter-based hash of (seed[r], step[r], vocab index).

    Row r's draws depend on its own seed and step only, never on the other
    rows, which is what the JAX package gets from one key per slot folded
    with the step. A few vectorised integer ops on the whole [R, vocab]
    block: no generator state, no per-row launches. ``seed`` is int64 in
    [0, 2^31), ``step`` int64 ≥ 0. Every multiply stays below 2^63 (a 32-bit
    value times a constant below 2^31), so no signed overflow occurs."""
    idx = torch.arange(vocab, dtype=torch.int64, device=seed.device)
    h = ((seed * 0x9E3779B1 + step * 0x85EBCA77)[:, None] + idx) & _M32
    for mul, shift in ((0x7FEB352D, 15), (0x2C1B3C6D, 16), (0x297A2D39, 15)):
        h = h ^ (h >> 16)
        h = (h * mul) & _M32
        h = h ^ (h >> shift)
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))   # (0, 1), 24 bits
    return -torch.log(-torch.log(u))


def sample_token(
    logits: torch.Tensor,     # [B, V]
    gumbel: torch.Tensor,     # [B, V] standard Gumbel noise
    temperature=1.0,
    top_p=1.0,
) -> torch.Tensor:
    """Token ids [B]: argmax where temperature <= 0, else a draw from the
    top-p-filtered, temperature-scaled distribution (Gumbel-max)."""
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    greedy = logits.argmax(-1)
    scaled = logits.float() / temperature.clamp_min(1e-4)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device).clamp_max(1.0)
    sampled = (top_p_filter(scaled, top_p) + gumbel).argmax(-1)
    return torch.where(temperature <= 0.0, greedy, sampled)
