"""Parameter bridge: JAX-layout pytrees → the port's parameters.

The JAX package stores parameters as nested dicts/lists with numpy (or jax)
leaves; the port keeps the same nesting and key names, so a path in one tree
names its counterpart in the other. Only the layouts of weights differ:

* linear ``{"w": [in, out]}`` (``chatterbox_tpu/ops/nn.py`` ``linear``) →
  torch ``[out, in]``;
* the T3 backbone's layer-stacked projections ``wq wk wv wo w_gate w_up
  w_down`` ``[L, in, out]`` → ``[L, out, in]``;
* conv ``{"w": [K, Cin, Cout]}`` (``chatterbox_tpu/ops/conv.py``, NTC) →
  torch ``[Cout, Cin, K]``;
* transposed conv (the HiFT ``ups`` stages) ``[K, Cin, Cout]`` → torch
  ``[Cin, Cout, K]``. The JAX ``conv_transpose1d`` flips its kernel to
  emulate torch's convolution, so here the weight is transposed, not flipped;
* 2-D conv (CAMPPlus's head) HWIO ``[kH, kW, Cin, Cout]`` → torch OIHW
  ``[Cout, Cin, kH, kW]``;
* the VoiceEncoder's LSTM weights ``wx`` / ``wh`` ``[in, 4H]`` → torch's
  ``weight_ih`` / ``weight_hh`` layout ``[4H, in]``.

Every other leaf (embeddings, norms, biases, buffers) is copied as is.
``convert_params`` also accepts torch leaves, which is how the port's own
initialisers build JAX-layout trees and convert them.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

_STACKED_LINEAR = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})
_LINEAR = frozenset({"w", "wx", "wh"})


def _leaf(x: Any, key: str, parents: tuple, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.array(x)
        if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch view
            a = a.astype(np.float32)
        t = torch.from_numpy(a)
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    if key in _LINEAR and t.dim() == 2:
        t = t.t()
    elif key == "w" and t.dim() == 3:
        t = t.permute(1, 2, 0) if "ups" in parents else t.permute(2, 1, 0)
    elif key == "w" and t.dim() == 4:
        t = t.permute(3, 2, 0, 1)
    elif key in _STACKED_LINEAR and t.dim() == 3:
        t = t.transpose(1, 2)
    return t.contiguous().to(device)


def convert_params(tree: Any, device, dtype=None, _key: str = "", _parents: tuple = ()):
    """Convert a JAX-layout parameter tree (dict / list nesting, array
    leaves) into the port's layout on ``device`` (no default: the caller
    names the device, the CPU included). ``dtype`` (optional) casts
    floating-point leaves."""
    if isinstance(tree, dict):
        return {k: convert_params(v, device, dtype, k, _parents + (_key,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [convert_params(v, device, dtype, _key, _parents + (_key,)) for v in tree]
    return _leaf(tree, _key, _parents, device, dtype)
