"""Peaks, the least time of a kernel's work, and the model FLOPs of a
window: the yardstick of the roofline and MFU metrics.

The bound arithmetic is a frozen copy of ``chip_smoke.py``'s ``bound``,
``decode_bound`` and ``ctx_bound``, fed with what a spy recorded at each
call site (shapes, and the device tensors of windows and key masks, cloned
without a host sync and read after the window closes).

The FLOPs of the model are counted from the weights a step multiplies and
the positions it runs: 2 × the weights of every matrix and conv a position
passes through, for each position. Counted: T3 (prefill and decode, both
CFG lanes, the backbone and the speech head), the S3Gen encoder (at the
token rate before its upsampling, twice that after), and the CFM
estimator (each new mel frame, both lanes, every Euler step and the
streaming context's clean evaluation; not its time-embedding projections,
which run once per evaluation). Not counted: attention's products
over the keys and HiFT. So ``mfu`` is a lower bound of the work done.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense: bytes/s of HBM3, ops/s by input type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 495e12, torch.bfloat16: 989e12, torch.int8: 1979e12}
BF16_PEAK_FLOPS = 989e12


def bound(bytes_moved: float, ops: float, dtype) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations") for the work of one call."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_bound(q_shape, q_elem: int, q_dtype, cache_dtype, rows: int, Hk: int,
                 scales: bool) -> Tuple[float, str]:
    """Bound of one decode-attention call (K1): each [start, pos) row of K
    and V (and its f32 scales) read once, q / the current k, v read once, the
    output written once; 4 ops per (row + self-term, head, Dh). ``rows`` is
    Σ max(pos − start, 0) over the lanes."""
    B, H, Dh = q_shape
    elem = torch.tensor([], dtype=cache_dtype).element_size()
    moved = (2 * rows * Hk * Dh * elem + (2 * rows * Hk * 4 if scales else 0)
             + (2 * B * H * Dh + 2 * B * Hk * Dh) * q_elem + 8 * B)
    ops = 4.0 * (rows + B) * H * Dh
    return bound(moved, ops, cache_dtype if cache_dtype == torch.int8 else q_dtype)


def ctx_bound(q_shape, q_elem: int, q_dtype, kp_rows: int, P: int, W: int, c_elem: int,
              valid: torch.Tensor) -> Tuple[float, str]:
    """The context form's (K2) least time over the bytes its segments hold:
    q read and out written once; K and V at the valid keys only, the
    prompt's once per row it holds (``kp_rows`` rows: two for all lanes of a
    voice); the key mask. ``valid`` [B2, P + W + Tq]."""
    B2, H, Tq, dh = q_shape
    rows = valid[:, :P].unflatten(0, (kp_rows, B2 // kp_rows)).any(1)
    kv = 2 * H * dh
    moved = (2 * B2 * H * Tq * dh * q_elem + kv * int(valid[:, P + W:].sum()) * q_elem
             + kv * (int(rows.sum()) + int(valid[:, P:P + W].sum())) * c_elem + valid.numel())
    ops = 4.0 * dh * H * Tq * int(valid.sum())
    return bound(moved, ops, q_dtype)


# ------------------------------------------------------------------ FLOPs
# two-dimensional leaves that no position multiplies: T3's norm weights
# stacked over layers, the conformer's attention biases
_NOT_MATRICES = ("attn_norm", "mlp_norm", "bias_u", "bias_v")


def _weights(tree, skip=()) -> int:
    """Elements of the matrices and conv kernels (≥ 2 dims) under ``tree``,
    leaving out the subtrees whose key is in ``skip`` or ``_NOT_MATRICES``."""
    skip = tuple(skip) + _NOT_MATRICES
    if isinstance(tree, dict):
        return sum(_weights(v, skip) for k, v in tree.items() if k not in skip)
    if isinstance(tree, (list, tuple)):
        return sum(_weights(v, skip) for v in tree)
    shape = getattr(tree, "shape", ())
    return math.prod(shape) if len(shape) >= 2 else 0


def flop_rates(raw: Dict) -> Dict[str, float]:
    """FLOPs per position of each counted part, from the JAX-layout tree
    (shapes only): ``t3_token`` per lane, ``enc_token`` (a token before the
    upsampling and its two frames after), ``est_frame`` per lane and
    evaluation: the time embedding's projections run once per evaluation,
    not per frame, and are left out)."""
    t3 = raw["t3"]
    enc = raw["s3gen"]["flow"]["encoder"]
    pre = _weights({k: enc[k] for k in ("embed", "lookahead", "blocks")})
    post = _weights({k: enc[k] for k in ("up_conv", "up_embed", "up_blocks")})
    est = raw["s3gen"]["flow"]["estimator"]
    return {"t3_token": 2.0 * (_weights(t3["backbone"]) + _weights(t3["speech_head"])),
            "enc_token": 2.0 * (pre + 2 * (post + _weights(raw["s3gen"]["flow"]["encoder_proj"]))),
            "est_frame": 2.0 * _weights(est, skip=("time_mlp", "mlp"))}


def dit_flop_rates(raw: Dict) -> Dict[str, float]:
    """``flop_rates`` for the DiT: its encoder's blocks at the token rate,
    the upsampling conv and the output projection at two frames a token;
    the flow's projections and blocks per frame (not its time MLP and AdaLN
    modulation, which run once per evaluation)."""
    t3 = raw["t3"]
    enc = raw["s3gen"]["encoder"]
    pre = _weights({k: v for k, v in enc.items() if k not in ("up_conv", "out_proj", "token_emb")})
    post = _weights({k: enc[k] for k in ("up_conv", "out_proj")})
    flow = raw["s3gen"]["flow"]
    return {"t3_token": 2.0 * (_weights(t3["backbone"]) + _weights(t3["speech_head"])),
            "enc_token": 2.0 * (pre + 2 * post),
            "est_frame": 2.0 * _weights(flow, skip=("time_mlp", "ada_w", "spk_proj"))}


def window_flops(rates: Dict[str, float], t3_tokens: int, prefill_tokens: int,
                 s3_jobs: Iterable[Tuple[int, int]], n_evals: int) -> float:
    """FLOPs of the window's work: T3 tokens decoded and prefilled (per
    lane), and per S3Gen job (tokens the encoder ran over, frames the flow
    solved) with ``n_evals`` evaluations per solve over both CFG lanes."""
    total = rates["t3_token"] * (t3_tokens + prefill_tokens)
    for enc_tokens, frames in s3_jobs:
        total += rates["enc_token"] * enc_tokens
        total += rates["est_frame"] * 2 * n_evals * frames
    return total
