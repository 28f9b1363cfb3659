"""K3: decode attention with the cache streamed through a copy pipeline.

Replaces ``chatterbox_tpu/ops/pallas_attention_v3.py::
paired_decode_attention_pipelined`` (kernel ``_pipelined_kernel``). It
computes exactly K1's float body: for lane b and query head h (kv head
h // G), softmax over the cached keys in ``[start[b], pos[b])`` plus the
current token's k/v as a self-term, on a bf16 or f32 cache (no int8 scales).
Its plain version is K1's ``decode_attention_plain`` without scales.

What the TPU design was for: a copy engine that runs ahead of the math.
One program walked the batch rows and kept ``n_buf - 1`` rows' cache copies
in flight in a VMEM ring. On Hopper (``csrc/decode_attention_pipelined.cu``)
the Tensor Memory Accelerator plays that part inside K1's split-S grid: one
block per (slice of ``slice_rows()`` cache rows, kv head, lane) reads only
its slice's part of ``[start, pos)``. That part of K (and of V) is one
contiguous run of bytes, so one thread streams it through a ring of
shared-memory stages of ``tile_rows(Dh, dtype)`` rows with one 1-D bulk copy
for K and one for V per stage, each stage completing on an mbarrier. Every
block writes a partial (max, sum, accumulator) into float32 scratch that the
wrapper allocates, and K1's combine kernel folds the partials and the
self-term. Nothing is read back to the host.

No serving path calls it (the JAX package's decode calls K1); ``chip_smoke.py``
holds it against its plain version at the batched decoder's shapes, on windows
at and across its slice and tile edges, at the other head shapes and on a live
decoder cache. On a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises. ``launches`` counts wrapper calls
that launched the kernel (one per call, whatever the CUDA launches inside).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .decode_attention import decode_attention_plain

launches = {"native": 0}

_DTYPE_CODE = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}
_HEAD_DIMS = (32, 64, 128)
_MAX_G_TIMES_DH = 512


def reset_launches() -> None:
    launches["native"] = 0


def _check_cuda_args(q, k_cache, v_cache, k_new, v_new, start, pos):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be [B,H,Dh] and the cache [B,Hk,S,Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, H, Dh = q.shape
    _, Hk, S, _ = k_cache.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    if Dh not in _HEAD_DIMS or H % Hk or (H // Hk) * Dh > _MAX_G_TIMES_DH:
        raise ValueError(f"unsupported heads: H={H} Hk={Hk} Dh={Dh}")
    shapes = {
        "q": (q, (B, H, Dh)), "k_cache": (k_cache, (B, Hk, S, Dh)),
        "v_cache": (v_cache, (B, Hk, S, Dh)), "k_new": (k_new, (B, Hk, Dh)),
        "v_new": (v_new, (B, Hk, Dh)), "start": (start, (B,)), "pos": (pos, (B,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("k_new", k_new),
                    ("v_new", v_new)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    for name, t in (("start", start), ("pos", pos)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32")
    # a bulk copy starts and ends on 16 bytes: so must the cache
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


@functools.cache
def slice_rows() -> int:
    """Cache rows per block of the CUDA kernel (builds the library)."""
    return _build.library().decode_attention_pipelined_slice_rows()


@functools.cache
def stages() -> int:
    """Stages of the CUDA kernel's copy ring."""
    return _build.library().decode_attention_pipelined_stages()


@functools.cache
def tile_rows(dh: int, dtype: torch.dtype) -> int:
    """Cache rows per ring stage of the CUDA kernel at head dim ``dh``."""
    return _build.library().decode_attention_pipelined_tile_rows(dh, _DTYPE_CODE[dtype])


def decode_attention_pipelined(
    q: torch.Tensor,        # [B, H, Dh]
    k_cache: torch.Tensor,  # [B, Hk, S, Dh] bf16 or f32 (q's dtype)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,    # [B, Hk, Dh] current token
    v_new: torch.Tensor,
    start: torch.Tensor,    # [B] int32 first valid cache index
    pos: torch.Tensor,      # [B] int32 filled length
    s_view: Optional[int] = None,
) -> torch.Tensor:
    """→ [B, H, Dh] in q's dtype. CPU tensors take the plain version (whose
    read ``s_view`` bounds); CUDA tensors launch the kernel, which bounds
    each row at its own pos."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, k_new, v_new, start, pos,
                                      s_view=s_view)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_pipelined: unsupported device {q.device}")
    _check_cuda_args(q, k_cache, v_cache, k_new, v_new, start, pos)
    B, H, Dh = q.shape
    _, Hk, S, _ = k_cache.shape
    out = torch.empty_like(q)
    lib = _build.library()
    n_slice = -(-S // slice_rows())
    scratch = torch.empty(B * Hk * n_slice * (H // Hk) * (Dh + 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_pipelined_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), start.data_ptr(), pos.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, H, Hk, S, Dh, _DTYPE_CODE[q.dtype],
            ctypes.c_float(1.0 / Dh ** 0.5), ctypes.c_void_p(stream),
        )
    _build.check(err, "decode_attention_pipelined")
    launches["native"] += 1
    return out
