"""Megatron's two tensor-parallel operators, with the gradients that make
a sharded backward pass equal the unsharded one.

A column-parallel product (each rank holds some output features: q/k/v
heads, the MLP's gate and up rows) reads the full activation and writes a
shard; a row-parallel product (each rank holds some input features: ``wo``,
``w_down``) reads a shard and writes a partial sum. So:

* ``copy_to_tp`` goes before each column-parallel product: identity
  forward; the backward all-reduces, because every rank's shard of the
  product contributes to the gradient of the one replicated input.
* ``reduce_from_tp`` goes after each row-parallel product: the forward
  all-reduces the partial sums; the backward is the identity, because the
  reduced output's gradient is the same on every rank and each partial sum
  takes it whole.

``torch.distributed.nn.functional.all_reduce`` is not ``reduce_from_tp``: it
all-reduces in its backward too, which multiplies the gradient of every
row-parallel product by the tp size.

With ``group=None`` both are the identity, so the unsharded model runs the
same operations as before. ``row_parallel`` and ``row_parallel_conv`` are a
row-parallel linear and conv1d: each rank's partial product stays float32
through the all-reduce, and the sum is cast once and takes the bias once,
so a bf16 result differs from the unsharded product by float32 summation
order, not by rounding each partial first. Both models use them (T3's
``wo`` / ``w_down``; S3Gen-ref's conformer ``out`` / ``ff.w2``, the CFM
estimator's ``to_out`` / ``ff2`` and its resnets' ``block2``). ``collectives`` counts the all-reduces these
operators issue and the bytes they reduce (``reset_collectives`` /
``read_collectives``), forward and backward alike.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.conv import conv1d
from ..ops.nn import linear

collectives = {"all_reduce": 0, "bytes": 0}


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


def read_collectives() -> dict:
    return dict(collectives)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` → a new tensor (``x`` is left as it is)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    collectives["all_reduce"] += 1
    collectives["bytes"] += out.numel() * out.element_size()
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Identity forward, all-reduce backward (before a column-parallel
    product)."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """All-reduce forward, identity backward (after a row-parallel
    product)."""
    return x if group is None else _ReduceFromTP.apply(x, group)


def row_parallel(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``linear(x, w, b)`` for a row-parallel weight ``[out, in/tp]``, summed
    over ``group`` (no group: ``linear`` itself)."""
    if group is None:
        return linear(x, w, b)
    y = reduce_from_tp(linear(x.float(), w), group)
    return (y if b is None else y + b.float()).to(x.dtype)


def row_parallel_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                      group: Optional[dist.ProcessGroup], padding: str) -> torch.Tensor:
    """``conv1d(x, w, b, padding=padding)`` for a weight ``[Cout, Cin/tp, K]``
    split on its input channels, summed over ``group``. As ``conv1d`` does,
    the input is cast to the weight's dtype and the bias added to the sum
    rounded to it."""
    if group is None:
        return conv1d(x, w, b, padding=padding)
    y = reduce_from_tp(conv1d(x.to(w.dtype), w.float(), padding=padding), group).to(w.dtype)
    return y if b is None else y + b
