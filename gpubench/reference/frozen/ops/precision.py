"""The control's precision switch: inside ``fp8_inputs()`` every matrix
product of the frozen models (``linear``, ``conv1d``, ``conv_transpose1d``)
takes its input rounded to float8 e4m3 with one scale per tensor, as the
control's weights are (``reference.chatterbox_ref.quantize_fp8``). Outside
it, nothing changes."""
from __future__ import annotations

import contextlib

import torch

_ON = [False]


@contextlib.contextmanager
def fp8_inputs():
    _ON[0] = True
    try:
        yield
    finally:
        _ON[0] = False


def round_input(x: torch.Tensor) -> torch.Tensor:
    if not _ON[0] or not x.is_floating_point():
        return x
    scale = x.detach().abs().amax().float().clamp_min(1e-12) / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
