"""1-D convolution helpers in the NTC layout (torch counterparts of
``chatterbox_tpu.ops.conv``).

Weights are stored the torch way: ``conv1d`` takes ``[Cout, Cin/groups, K]``
and ``conv_transpose1d`` takes ``[Cin, Cout, K]``. Activations stay
``[B, T, C]`` at the public functions so the port compares like with like
against the JAX package. As there, the weights define the compute precision
(the input is cast to the weight dtype) and the bias is added after the
product is rounded to that dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .precision import round_input


def _same_pads(T: int, K: int, stride: int, dilation: int):
    """XLA's "SAME" rule: output ceil(T/stride), the odd pad on the right."""
    k_eff = (K - 1) * dilation + 1
    out = -(-T // stride)
    total = max((out - 1) * stride + k_eff - T, 0)
    return total // 2, total - total // 2


def conv1d(
    x: torch.Tensor,            # [B, T, Cin]
    w: torch.Tensor,            # [Cout, Cin/groups, K]
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    dilation: int = 1,
    padding: str = "SAME",      # "SAME" | "VALID" | "CAUSAL" | "SAME_TORCH"
    groups: int = 1,
) -> torch.Tensor:
    K = w.shape[-1]
    x = round_input(x.to(w.dtype)).transpose(1, 2)
    if padding == "CAUSAL":
        lo, hi = (K - 1) * dilation, 0
    elif padding == "SAME_TORCH":
        lo = hi = (K - 1) // 2 * dilation
    elif padding == "SAME":
        lo, hi = _same_pads(x.shape[-1], K, stride, dilation)
    elif padding == "VALID":
        lo = hi = 0
    else:
        raise ValueError(f"unknown padding {padding!r}")
    if lo or hi:
        x = F.pad(x, (lo, hi))
    y = F.conv1d(x, w, None, stride, 0, dilation, groups).transpose(1, 2)
    if b is not None:
        y = y + b
    return y


def conv_transpose1d(
    x: torch.Tensor,            # [B, T, Cin]
    w: torch.Tensor,            # [Cin, Cout, K]
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
) -> torch.Tensor:
    """Transposed conv with output length T*stride (HiFiGAN-style upsampling,
    pad (K-stride)//2 on the left, the rest on the right)."""
    K = w.shape[-1]
    T = x.shape[1]
    lo = (K - stride) // 2
    y = F.conv_transpose1d(round_input(x.to(w.dtype)).transpose(1, 2), w, None, stride)
    y = y[:, :, lo: lo + T * stride].transpose(1, 2)
    if b is not None:
        y = y + b
    return y
