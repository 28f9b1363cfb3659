"""K2: bidirectional multi-head attention with a key-validity mask.

Replaces ``chatterbox_tpu/ops/pallas_mha.py::flash_mha`` (kernel
``_mha_kernel``), which runs every transformer block of every CFM estimator
evaluation on the uncached path and in the per-voice prompt prefill.
Semantics: softmax(q·kᵀ·scale) over the valid keys, float32 accumulation; a
query row whose keys are all masked returns 0 (not the uniform average a
plain masked softmax gives).

Two forms: the self form (q, k, v share one length T) and the context form
(Tq queries over Tk keys), which every cached and streaming estimator
evaluation runs over its [prompt | ring | own] keys (the JAX package computes
that one as a plain einsum, ``decoder.py:280-298``).

``flash_mha`` is the wrapper the model calls: on a CPU tensor it runs
``flash_mha_plain``; on a CUDA tensor it launches ``csrc/flash_mha.cu`` or
raises. It also raises for a CUDA tensor when ``CHATTERBOX_FLASH`` is set
to anything but "1" (``flash_enabled``, read at each call as the JAX
package's ``decoder._flash_active`` reads it, where it picks the einsum
route): the port never sends CUDA tensors to the plain version.
``launches`` counts kernel launches per input dtype, the context form under
``<dtype>_ctx``.

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
