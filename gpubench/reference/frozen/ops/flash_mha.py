"""K2's plain versions under the kernel wrappers' names, so the frozen
decoder calls them where the program launches ``csrc/flash_mha.cu`` and
``csrc/flash_mha_context.cu``: softmax over the valid keys in float32, a
row whose keys are all masked returns 0."""
from __future__ import annotations

from typing import Optional

import torch

from .nn import NEG_INF


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, Tq, dh], k/v [B, H, Tk, dh], valid [B, Tk] → [B, H, Tq, dh]
    in q's dtype."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    kmask = valid[:, None, None, :]
    s = s.masked_fill(~kmask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(kmask, torch.exp(s - m), 0.0)
    out = torch.einsum("bhij,bhjd->bhid", p, v.float()) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


def flash_mha_context(q, k_own, v_own, k_prompt, v_prompt, k_ring, v_ring, valid,
                      scale: Optional[float] = None) -> torch.Tensor:
    """``flash_mha`` over the float32 concatenation [prompt | ring | own];
    the prompt's Bp rows serve lane b from row b // (B2 // Bp)."""
    B2 = q.shape[0]
    lanes = lambda x: x.repeat_interleave(B2 // x.shape[0], dim=0)  # noqa: E731
    parts = [(lanes(k_prompt), lanes(v_prompt))]
    if k_ring is not None:
        parts.append((k_ring, v_ring))
    parts.append((k_own, v_own))
    k = torch.cat([kp.float() for kp, _ in parts], dim=2)
    v = torch.cat([vp.float() for _, vp in parts], dim=2)
    return flash_mha(q, k, v, valid, scale)
