"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

JAX stays on the CPU (tests/conftest.py); data crosses between the two
packages as numpy arrays. torch's intra-op threads are capped because the
suite runs in several worker processes at once.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(2)


def to_np(x) -> np.ndarray:
    """A jax array or torch tensor → float32/int numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def to_t(x, dtype=None) -> torch.Tensor:
    """numpy / jax array → CPU torch tensor (a copy)."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def jax_tree_to_np(tree):
    """A JAX pytree → the same nesting with numpy leaves."""
    import jax

    return jax.tree.map(np.asarray, tree)
