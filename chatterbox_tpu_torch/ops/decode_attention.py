"""K1: single-query decode attention over the T3 KV cache.

Replaces ``chatterbox_tpu/ops/pallas_attention_v3.py::paired_decode_attention``
(its ``_kernel`` bf16 body and ``_kernel_int8`` body). For each lane b and
query head h (kv head h // G — GQA shares a kv head, the cache is never
repeated) it attends q[b, h] to the cached keys in ``[start[b], pos[b])`` and
folds the current token's unquantised k/v in as a self-term before
normalising. With an int8 cache the per-token float32 scales multiply the
scores and the probabilities ("scale-factoring"), so no dequantised cache is
ever written.

Layout is the port's: one layer's cache is ``[B, Hk, S, Dh]`` (a contiguous
slice of the ``[L, B, Hk, S, Dh]`` cache) with scales ``[B, Hk, S]``. The
TPU's paired ``[B, Hk/2, S, 128]`` layout existed only to fill 128 lanes.

``decode_attention`` is the wrapper the model calls: on a CPU tensor it runs
``decode_attention_plain``; on a CUDA tensor it launches
``csrc/decode_attention.cu`` or raises. It also raises for a CUDA tensor
when ``CHATTERBOX_PALLAS`` is set to anything but "1" (``pallas_enabled``,
read at each call as the JAX package reads it, where it picks the XLA
route): the port never sends CUDA tensors to the plain version. The kernel
is split-S flash decoding:
one block per (slice of ``slice_rows()`` = 256 cache rows, kv head, lane)
writes a partial (max, sum, accumulator) into float32 scratch that the
wrapper allocates, and a second kernel folds the partials and the self-term.
The slice count comes from S, never from ``pos``: nothing is read back to
the host. ``launches`` counts wrapper calls that launched the kernel (one per
call, whatever the CUDA launches inside) per cache body ("native" =
float/bf16 cache, "int8").
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from . import _build
from .nn import NEG_INF

launches = {"native": 0, "int8": 0}

_DTYPE_CODE = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16,
               torch.int8: _build.DTYPE_I8}
_HEAD_DIMS = (32, 64, 128)
_GROUPS = (1, 2, 4)   # query heads per kv head with a compiled body


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def pallas_enabled() -> bool:
    """``CHATTERBOX_PALLAS`` as ``chatterbox_tpu/ops/pallas_attention_v3.py``
    reads it: only "1", the default, keeps K1 on; any other value ("0",
    "true", "") turns it off."""
    return os.environ.get("CHATTERBOX_PALLAS", "1") == "1"


def launches_kernel(device: torch.device) -> bool:
    """Whether ``decode_attention`` launches K1 for tensors on ``device``:
    a CUDA device does, a CPU device takes the plain version. A CUDA device
    with ``pallas_enabled()`` false, or another device type, raises."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {device}")
    if not pallas_enabled():
        raise _build.refuse_knob("CHATTERBOX_PALLAS", "K1 (decode_attention)")
    return True


def decode_attention_plain(
    q: torch.Tensor,        # [B, H, Dh]
    k_cache: torch.Tensor,  # [B, Hk, S, Dh] (int8 when scales are given)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,    # [B, Hk, Dh] current token (unquantised)
    v_new: torch.Tensor,
    start: torch.Tensor,    # [B] int32 first valid cache index
    pos: torch.Tensor,      # [B] int32 filled length (current token at pos)
    k_scale: Optional[torch.Tensor] = None,  # [B, Hk, S] float32
    v_scale: Optional[torch.Tensor] = None,
    s_view: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version (float32 math) → [B, H, Dh] in q's dtype.
    ``s_view`` bounds the read to the first s_view entries (≥ max(pos))."""
    B, H, Dh = q.shape
    Hk = k_cache.shape[1]
    G = H // Hk
    S = k_cache.shape[2] if s_view is None else min(s_view, k_cache.shape[2])
    scale = 1.0 / Dh ** 0.5
    qg = q.float().reshape(B, Hk, G, Dh)
    kc = k_cache[:, :, :S].float()
    vc = v_cache[:, :, :S].float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, kc)
    if k_scale is not None:
        s = s * k_scale[:, :, None, :S]
    s = s * scale
    idx = torch.arange(S, device=q.device)
    valid = (idx >= start[:, None, None, None]) & (idx < pos[:, None, None, None])
    s = s.masked_fill(~valid, NEG_INF)
    s_self = torch.einsum("bhgd,bhd->bhg", qg, k_new.float())[..., None] * scale
    m = torch.maximum(s.amax(-1, keepdim=True), s_self)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    p_self = torch.exp(s_self - m)
    denom = p.sum(-1, keepdim=True) + p_self
    if v_scale is not None:
        p = p * v_scale[:, :, None, :S]
    num = torch.einsum("bhgk,bhkd->bhgd", p, vc) + p_self * v_new.float()[:, :, None, :]
    out = num / denom.clamp_min(1e-30)
    return out.reshape(B, H, Dh).to(q.dtype)


def _check_cuda_args(q, k_cache, v_cache, k_new, v_new, start, pos, k_scale, v_scale):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be [B,H,Dh] and the cache [B,Hk,S,Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, H, Dh = q.shape
    _, Hk, S, _ = k_cache.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    quantized = k_scale is not None
    if (v_scale is not None) != quantized:
        raise ValueError("k_scale and v_scale come together")
    want_cache = torch.int8 if quantized else q.dtype
    if k_cache.dtype != want_cache or v_cache.dtype != want_cache:
        raise ValueError(f"cache dtype {k_cache.dtype} must be {want_cache}")
    if Dh not in _HEAD_DIMS or H % Hk or H // Hk not in _GROUPS:
        raise ValueError(f"unsupported heads: H={H} Hk={Hk} Dh={Dh}")
    shapes = {
        "k_cache": (k_cache, (B, Hk, S, Dh)), "v_cache": (v_cache, (B, Hk, S, Dh)),
        "k_new": (k_new, (B, Hk, Dh)), "v_new": (v_new, (B, Hk, Dh)),
        "start": (start, (B,)), "pos": (pos, (B,)),
    }
    if quantized:
        shapes.update(k_scale=(k_scale, (B, Hk, S)), v_scale=(v_scale, (B, Hk, S)))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    for name, t in (("start", start), ("pos", pos)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32")
    if quantized and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("scales must be float32")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")


@functools.cache
def slice_rows() -> int:
    """Cache rows per block of the CUDA kernel (builds the library)."""
    return _build.library().decode_attention_slice_rows()


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    start: torch.Tensor,
    pos: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    s_view: Optional[int] = None,
) -> torch.Tensor:
    """→ [B, H, Dh]. CPU tensors take the plain version; CUDA tensors launch
    the kernel (which bounds each row at its own pos, so ``s_view`` only
    bounds the plain version's read)."""
    if not launches_kernel(q.device):
        return decode_attention_plain(q, k_cache, v_cache, k_new, v_new, start, pos,
                                      k_scale, v_scale, s_view)
    _check_cuda_args(q, k_cache, v_cache, k_new, v_new, start, pos, k_scale, v_scale)
    B, H, Dh = q.shape
    _, Hk, S, _ = k_cache.shape
    out = torch.empty_like(q)
    quantized = k_scale is not None
    lib = _build.library()
    n_slice = -(-S // slice_rows())
    scratch = torch.empty(B * Hk * n_slice * (H // Hk) * (Dh + 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            start.data_ptr(), pos.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            B, H, Hk, S, Dh, _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
            ctypes.c_float(1.0 / Dh ** 0.5), ctypes.c_void_p(stream),
        )
    _build.check(err, "decode_attention")
    launches["int8" if quantized else "native"] += 1
    return out
