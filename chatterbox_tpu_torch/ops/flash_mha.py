"""K2: bidirectional multi-head attention with a key-validity mask.

Replaces ``chatterbox_tpu/ops/pallas_mha.py::flash_mha`` (kernel
``_mha_kernel``), which runs every transformer block of every CFM estimator
evaluation on the uncached path and in the per-voice prompt prefill.
Semantics: softmax(q·kᵀ·scale) over the valid keys, float32 accumulation; a
query row whose keys are all masked returns 0 (not the uniform average a
plain masked softmax gives).

Two forms. The self form (q, k, v share one length T; ``flash_mha``) runs
the uncached path and the per-voice prompt prefill. The context form
(``flash_mha_context``) runs every cached and streaming estimator
evaluation: Tq new frames over three key segments read where they lie, the
voice prompt's and the request's ring in the weights' dtype and the frames'
own (the JAX package computes it as a plain einsum over their
concatenation, ``decoder.py:280-298``). ``flash_mha`` still takes Tq ≠ Tk
over one concatenated buffer (``csrc/flash_mha.cu``, the earlier design of
the context form); the model no longer calls it so.

``flash_mha`` and ``flash_mha_context`` are the wrappers the model calls:
on CPU tensors they run ``flash_mha_plain`` / ``flash_mha_context_plain``;
on CUDA tensors they launch ``csrc/flash_mha.cu`` /
``csrc/flash_mha_context.cu`` or raise. It also raises for a CUDA tensor when ``CHATTERBOX_FLASH`` is set
to anything but "1" (``flash_enabled``, read at each call as the JAX
package's ``decoder._flash_active`` reads it, where it picks the einsum
route): the port never sends CUDA tensors to the plain version.
``launches`` counts kernel launches per input dtype, the context form under
``<dtype>_ctx`` (q's dtype).

The kernel multiplies on the tensor cores (``mma.sync`` m16n8k16, bf16 in,
float32 accumulation), under this precision contract:

- bfloat16 inputs: bf16 products, P rounded to bf16 for P·V, f32 sums;
- float32 inputs ("bf16x3"): every operand x of Q·Kᵀ and P·V is split into
  ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, and each product is taken as
  hi·hi + hi·lo + lo·hi with f32 accumulation. Emulated on the CPU at the
  batched path's shapes (B = 32, H = 8, T = 628, dh = 64, randn inputs) it
  stays within 2e-5 of ``flash_mha_plain`` (9.0e-6); one-pass bf16 or TF32
  would not (tests/test_torch_flash_mha.py).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from . import _build
from .nn import NEG_INF

launches = {"float32": 0, "bfloat16": 0, "float32_ctx": 0, "bfloat16_ctx": 0}

_DTYPE_CODE = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}
_HEAD_DIMS = (32, 64, 128)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def flash_enabled() -> bool:
    """``CHATTERBOX_FLASH`` as ``chatterbox_tpu/models/s3gen_ref/decoder.py``
    reads it: only "1", the default, keeps K2 on; any other value ("0",
    "true", "") turns it off."""
    return os.environ.get("CHATTERBOX_FLASH", "1") == "1"


def launches_kernel(device: torch.device) -> bool:
    """Whether ``flash_mha`` launches K2 for tensors on ``device``: a CUDA
    device does, a CPU device takes the plain version. A CUDA device with
    ``flash_enabled()`` false, or another device type, raises."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {device}")
    if not flash_enabled():
        raise _build.refuse_knob("CHATTERBOX_FLASH", "K2 (flash_mha)")
    return True


def flash_mha_plain(
    q: torch.Tensor,      # [B, H, Tq, dh]
    k: torch.Tensor,      # [B, H, Tk, dh]
    v: torch.Tensor,
    valid: torch.Tensor,  # [B, Tk] bool key validity
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version (float32 math) → [B, H, Tq, dh] in q's dtype."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    kmask = valid[:, None, None, :]
    s = s.masked_fill(~kmask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(kmask, torch.exp(s - m), 0.0)
    out = torch.einsum("bhij,bhjd->bhid", p, v.float()) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


def flash_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """→ [B, H, Tq, dh]. CPU tensors take the plain version; CUDA tensors
    launch the kernel, which masks the ragged Tq and Tk edges itself (no
    padding)."""
    if not launches_kernel(q.device):
        return flash_mha_plain(q, k, v, valid, scale)
    if q.dim() != 4:
        raise ValueError(f"q must be [B,H,Tq,dh], got {tuple(q.shape)}")
    B, H, Tq, dh = q.shape
    Tk = k.shape[2] if k.dim() == 4 else -1
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} not supported {_HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, H, Tk, dh) or Tk < 1 or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)}/{t.dtype} does not fit q "
                             f"{tuple(q.shape)}/{q.dtype} (want [B, H, Tk, dh])")
    if tuple(valid.shape) != (B, Tk) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool [B, Tk], got {tuple(valid.shape)}/{valid.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scale is None:
        scale = 1.0 / dh ** 0.5
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_mha_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
            B, H, Tq, Tk, dh, _DTYPE_CODE[q.dtype], ctypes.c_float(scale),
            ctypes.c_void_p(stream),
        )
    _build.check(err, "flash_mha")
    launches[str(q.dtype).removeprefix("torch.") + ("_ctx" if Tk != Tq else "")] += 1
    return out


# the context form's (q, context) dtype pairs: float32 activations over bf16
# or float32 weights, or bf16 throughout (CHATTERBOX_FLOW_BF16=1)
_CTX_PAIRS = ((torch.float32, torch.bfloat16), (torch.float32, torch.float32),
              (torch.bfloat16, torch.bfloat16))


def _check_context(q, k_own, v_own, k_prompt, v_prompt, k_ring, v_ring, valid) -> None:
    """Raise unless the context form's arguments fit each other (the same
    checks on the CPU as on the card)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B2, H, Tq, dh], got {tuple(q.shape)}")
    B2, H, Tq, dh = q.shape
    for name, t in (("k_own", k_own), ("v_own", v_own)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)}/{t.dtype} must match q "
                             f"{tuple(q.shape)}/{q.dtype}")
    if k_prompt.dim() != 4:
        raise ValueError(f"k_prompt must be [Bp, H, P, dh], got {tuple(k_prompt.shape)}")
    Bp, P = k_prompt.shape[0], k_prompt.shape[2]
    if Bp not in (B2, 2) or B2 % Bp or tuple(k_prompt.shape) != (Bp, H, P, dh):
        raise ValueError(f"k_prompt {tuple(k_prompt.shape)} does not fit q {tuple(q.shape)} "
                         "(want [B2 or 2, H, P, dh])")
    if (k_ring is None) != (v_ring is None):
        raise ValueError("k_ring and v_ring must both be given or both be None")
    ctx = [("k_prompt", k_prompt), ("v_prompt", v_prompt)]
    W = 0
    if k_ring is not None:
        W = k_ring.shape[2] if k_ring.dim() == 4 else -1
        if tuple(k_ring.shape) != (B2, H, W, dh):
            raise ValueError(f"k_ring {tuple(k_ring.shape)} does not fit q {tuple(q.shape)} "
                             "(want [B2, H, W, dh])")
        ctx += [("k_ring", k_ring), ("v_ring", v_ring)]
    for name, t in ctx:
        ref = k_prompt if name.endswith("prompt") else k_ring
        if t.shape != ref.shape or t.dtype != k_prompt.dtype:
            raise ValueError(f"{name} {tuple(t.shape)}/{t.dtype} does not fit k_prompt "
                             f"{tuple(k_prompt.shape)}/{k_prompt.dtype} (and k_ring's shape)")
    if (q.dtype, k_prompt.dtype) not in _CTX_PAIRS:
        raise ValueError(f"dtype pair (q {q.dtype}, context {k_prompt.dtype}) not supported: "
                         f"{[(str(a), str(b)) for a, b in _CTX_PAIRS]}")
    if tuple(valid.shape) != (B2, P + W + Tq) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool [B2, P + W + Tq] = [{B2}, {P + W + Tq}], got "
                         f"{tuple(valid.shape)}/{valid.dtype}")
    for name, t in (("q", q), ("k_own", k_own), ("v_own", v_own), *ctx, ("valid", valid)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _prompt_lanes(x: torch.Tensor, B2: int) -> torch.Tensor:
    """[Bp, H, P, dh] prompt → [B2, H, P, dh]: lane b takes row b // (B2 // Bp)
    (Bp = 2: the [cond × B, uncond × B] lanes of a batch-1 voice)."""
    return x.repeat_interleave(B2 // x.shape[0], dim=0)


def flash_mha_context_plain(
    q: torch.Tensor,         # [B2, H, Tq, dh]
    k_own: torch.Tensor,     # [B2, H, Tq, dh]
    v_own: torch.Tensor,
    k_prompt: torch.Tensor,  # [Bp, H, P, dh], Bp = B2 or 2
    v_prompt: torch.Tensor,
    k_ring: Optional[torch.Tensor],  # [B2, H, W, dh] or None (W = 0)
    v_ring: Optional[torch.Tensor],
    valid: torch.Tensor,     # [B2, P + W + Tq] bool: [prompt | ring | own] key validity
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version: ``flash_mha_plain`` over the float32
    concatenation [prompt | ring | own] → [B2, H, Tq, dh] in q's dtype."""
    B2 = q.shape[0]
    parts = [(_prompt_lanes(k_prompt, B2), _prompt_lanes(v_prompt, B2))]
    if k_ring is not None:
        parts.append((k_ring, v_ring))
    parts.append((k_own, v_own))
    k = torch.cat([kp.float() for kp, _ in parts], dim=2)
    v = torch.cat([vp.float() for _, vp in parts], dim=2)
    return flash_mha_plain(q, k, v, valid, scale)


def flash_mha_context(
    q: torch.Tensor,
    k_own: torch.Tensor,
    v_own: torch.Tensor,
    k_prompt: torch.Tensor,
    v_prompt: torch.Tensor,
    k_ring: Optional[torch.Tensor],
    v_ring: Optional[torch.Tensor],
    valid: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K2's context form → [B2, H, Tq, dh] in q's dtype: softmax over the
    valid keys of [prompt | ring | own], each segment read where it lies.
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/flash_mha_context.cu`` (dh = 64) or raise. The argument checks
    are the same on both."""
    kernel = launches_kernel(q.device)
    _check_context(q, k_own, v_own, k_prompt, v_prompt, k_ring, v_ring, valid)
    if not kernel:
        return flash_mha_context_plain(q, k_own, v_own, k_prompt, v_prompt, k_ring, v_ring,
                                       valid, scale)
    B2, H, Tq, dh = q.shape
    if dh != 64:
        raise ValueError(f"flash_mha_context: head dim {dh} not supported on the card (64)")
    if scale is None:
        scale = 1.0 / dh ** 0.5
    W = 0 if k_ring is None else k_ring.shape[2]
    ring = (0, 0) if k_ring is None else (k_ring.data_ptr(), v_ring.data_ptr())
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_mha_context_launch(
            q.data_ptr(), k_own.data_ptr(), v_own.data_ptr(), k_prompt.data_ptr(),
            v_prompt.data_ptr(), *ring, valid.data_ptr(), out.data_ptr(),
            B2, k_prompt.shape[0], H, Tq, k_prompt.shape[2], W, dh,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_prompt.dtype], ctypes.c_float(scale),
            ctypes.c_void_p(stream),
        )
    _build.check(err, "flash_mha_context")
    launches[str(q.dtype).removeprefix("torch.") + "_ctx"] += 1
    return out
