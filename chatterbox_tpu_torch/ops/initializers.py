"""Random parameter initialisation on the device from a seeded generator.

Same distributions as ``chatterbox_tpu/ops/initializers.py``: ``dense``
draws N(0, 1) · scale with scale = 1/√fan_in by default, fan_in being the
second-to-last dimension of the JAX-layout shape (the last for a vector).
The ``*_param_tree`` functions build JAX-layout trees with this (or with
``ShapeInit``, for a template) and ``convert.convert_params`` turns them into
the port's layouts, so structure and layouts come from one place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


class DenseInit:
    """Draws JAX-layout float32 tensors on ``device`` from ``generator``."""

    def __init__(self, generator: torch.Generator, device):
        self.generator = generator
        self.device = device

    def dense(self, shape, scale: Optional[float] = None) -> torch.Tensor:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(tuple(shape), generator=self.generator, device=self.device)
        return x * scale

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(tuple(shape), device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(tuple(shape), device=self.device)


class ShapeInit:
    """Stands in for ``DenseInit`` where only a tree's structure is wanted:
    every drawn leaf is a meta tensor (shape and dtype, no storage, no
    random draw), so a full-size template costs nothing. Buffers that init
    functions compute from the config (a window, a sinusoid table) stay real
    CPU tensors."""

    device = torch.device("cpu")

    def dense(self, shape, scale: Optional[float] = None) -> torch.Tensor:
        return torch.empty(tuple(shape), device="meta")

    def zeros(self, shape) -> torch.Tensor:
        return self.dense(shape)

    ones = zeros


def make_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
