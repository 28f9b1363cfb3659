"""The tensor-parallel operators the frozen models name, without a group:
the reference runs on one device, so each is its plain product."""
from __future__ import annotations

from ..ops.conv import conv1d
from ..ops.nn import linear


def copy_to_tp(x, group=None):
    return x


def row_parallel(x, w, b, group=None):
    return linear(x, w, b)


def row_parallel_conv(x, w, b, group=None, padding="same"):
    return conv1d(x, w, b, padding=padding)
