"""Parameter bridge: JAX-layout pytrees → the port's parameters.

The JAX package stores parameters as nested dicts/lists with numpy (or jax)
leaves; the port keeps the same nesting and key names, so a path in one tree
names its counterpart in the other. Only the layouts of weights differ:

* linear ``{"w": [in, out]}`` (``chatterbox_tpu/ops/nn.py`` ``linear``) →
  torch ``[out, in]``;
* the layer-stacked projections ``[L, in, out]`` → ``[L, out, in]``: the
  T3 backbone's ``wq wk wv wo w_gate w_up w_down``, and the DiT stack's
  MLPs ``w1 w2`` (its encoder, flow and S3Tok) and AdaLN modulation
  ``ada_w``;
* the DiT flow's time MLP ``w1 w2`` ``[in, out]`` → ``[out, in]``, as a
  linear;
* conv ``{"w": [K, Cin, Cout]}`` (``chatterbox_tpu/ops/conv.py``, NTC) →
  torch ``[Cout, Cin, K]``;
* transposed conv (the HiFT ``ups`` stages, the DiT vocoder's stage ``up``)
  ``[K, Cin, Cout]`` → torch ``[Cin, Cout, K]``. The JAX
  ``conv_transpose1d`` flips its kernel to emulate torch's convolution, so
  here the weight is transposed, not flipped;
* 2-D conv (CAMPPlus's head) HWIO ``[kH, kW, Cin, Cout]`` → torch OIHW
  ``[Cout, Cin, kH, kW]``;
* the VoiceEncoder's LSTM weights ``wx`` / ``wh`` ``[in, 4H]`` → torch's
  ``weight_ih`` / ``weight_hh`` layout ``[4H, in]``.

Every other leaf (embeddings, norms, biases, buffers) is copied as is.
``convert_params`` also accepts torch leaves, which is how the port's own
initialisers build JAX-layout trees and convert them. ``unconvert_params``
is its inverse, which the native checkpoint writer uses.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

_STACKED_LINEAR = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                             "w1", "w2", "ada_w"})
_LINEAR = frozenset({"w", "wx", "wh", "w1", "w2"})


def _perm(key: str, parents: tuple, ndim: int):
    """The permutation that takes a JAX-layout leaf to the port's layout
    (None: the leaf is copied as is)."""
    if key in _LINEAR and ndim == 2:
        return (1, 0)
    if key == "w" and ndim == 3:
        return (1, 2, 0) if "ups" in parents or parents[-1:] == ("up",) else (2, 1, 0)
    if key == "w" and ndim == 4:
        return (3, 2, 0, 1)
    if key in _STACKED_LINEAR and ndim == 3:
        return (0, 2, 1)
    return None


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
    perm = _perm(key, parents, t.dim())
    if perm is not None:
        t = t.permute(perm)
    return t.contiguous().to(device)


def _walk(tree: Any, fn, key: str = "", parents: tuple = ()):
    """``fn(leaf, key, parents)`` over a dict / list nesting; ``key`` is the
    leaf's own dict key, or its list's, and ``parents`` the keys above."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, k, parents + (key,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, key, parents + (key,)) for v in tree]
    return fn(tree, key, parents)


def convert_params(tree: Any, device, dtype=None):
    """Convert a JAX-layout parameter tree (dict / list nesting, array
    leaves) into the port's layout on ``device`` (no default: the caller
    names the device, the CPU included). ``dtype`` (optional) casts
    floating-point leaves."""
    return _walk(tree, lambda x, key, parents: _leaf(x, key, parents, device, dtype))


def unconvert_params(tree: Any):
    """The inverse of ``convert_params``: the port's parameter tree → the
    JAX layout, as contiguous torch tensors on the same device and in the
    same dtype."""
    def leaf(t: torch.Tensor, key: str, parents: tuple) -> torch.Tensor:
        perm = _perm(key, parents, t.dim())
        if perm is not None:
            t = t.permute(tuple(perm.index(i) for i in range(len(perm))))
        return t.contiguous()

    return _walk(tree, leaf)
