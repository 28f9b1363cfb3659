"""Seeded random weights, made on the device in a few large draws.

A configuration's reference module builds its JAX-layout parameter tree
with an ``init`` object (``dense(shape, scale)``, ``zeros``, ``ones``), the
interface the models' ``*_param_tree`` functions take. ``BulkInit`` hands
out placeholders for the dense leaves and fills them all from one
``torch.randn`` on a generator seeded from ``--seed``: N(0, 1) · scale, with
scale = 1/√fan_in unless the tree names one (fan_in the second-to-last
dimension, the last for a vector), the distributions the models were built
with. Norms and biases come out as ones and zeros, and buffers the tree
computes (an STFT window) in the same dtype, as the program serves them.
The same seed gives the same tree, leaf for leaf, on any run; the program
and the reference each convert it to their own layouts.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

# draws are split so no single call allocates more than this many elements
_DRAW_CHUNK = 1 << 28


class _Dense:
    __slots__ = ("shape", "scale")

    def __init__(self, shape, scale):
        self.shape, self.scale = tuple(shape), scale


class BulkInit:
    def __init__(self, device, dtype: torch.dtype):
        self.device, self.dtype = torch.device(device), dtype
        self.pending: List[_Dense] = []

    def dense(self, shape, scale: Optional[float] = None) -> _Dense:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        leaf = _Dense(shape, scale if scale is not None else 1.0 / math.sqrt(fan_in))
        self.pending.append(leaf)
        return leaf

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=self.dtype, device=self.device)

    def fill(self, tree, seed: int):
        """The tree with every placeholder drawn, in tree order, from one
        stream of N(0, 1) on a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        total = sum(math.prod(p.shape) for p in self.pending)
        parts = []
        for off in range(0, total, _DRAW_CHUNK):
            parts.append(torch.randn(min(_DRAW_CHUNK, total - off), generator=gen,
                                     device=self.device, dtype=torch.float32).to(self.dtype))
        flat = torch.cat(parts) if len(parts) > 1 else parts[0]
        del parts
        values: Dict[int, torch.Tensor] = {}
        off = 0
        for p in self.pending:
            n = math.prod(p.shape)
            values[id(p)] = flat[off:off + n].view(p.shape).mul(p.scale)
            off += n
        del flat

        def walk(x):
            if isinstance(x, dict):
                return {k: walk(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [walk(v) for v in x]
            if isinstance(x, _Dense):
                return values[id(x)]
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                return x.to(self.dtype)   # a buffer the tree computed (a window)
            return x

        return walk(tree)


def make_tree(trees: Callable, seed: int, device, dtype: torch.dtype = torch.bfloat16):
    """``trees(init)`` → the JAX-layout tree, drawn from ``seed`` on
    ``device`` in ``dtype`` (the type the configuration serves in)."""
    init = BulkInit(device, dtype)
    with torch.inference_mode():
        return init.fill(trees(init), seed)
