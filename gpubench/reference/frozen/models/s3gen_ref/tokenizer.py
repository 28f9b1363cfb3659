"""S3TokenizerV2: whisper-style encoder + FSQ quantizer (25 Hz, 3^8 codes);
torch counterpart of ``chatterbox_tpu/models/s3gen_ref/tokenizer.py``.

whisper 128-mel (100 Hz) → conv1 (k3, s2, gelu) → conv2 (k3, s2, gelu) →
+ the sinusoidal positional table (a checkpoint buffer) → pre-norm
transformer (q and v biased, k not) → FSQ: linear(D → 8), tanh, × 0.999,
round half to even → digits {0, 1, 2} → code = Σ digit · 3^d. Masked
throughout, so a right-padded batch tokenizes each valid prefix as alone.
The input is cast to the weights' dtype; scores, softmax and the FSQ run in
float32.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import S3TokRefConfig

# tanh outputs are scaled by (1 - 1e-3) before rounding so the ±1 boundaries
# cannot tie
_FSQ_TANH_SCALE = 1.0 - 1e-3


def _sinusoid_table(n_ctx: int, d: int) -> np.ndarray:
    """Whisper's sinusoidal positional embedding (stored in the checkpoint)."""
    inv = np.exp(-np.log(10000.0) / (d // 2 - 1) * np.arange(d // 2))
    t = np.arange(n_ctx)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def s3tok_ref_param_tree(cfg: S3TokRefConfig, init) -> Dict:
    """The JAX-layout tree, its leaves drawn by ``init`` with the JAX
    package's distributions; the sinusoid table as the checkpoint stores it."""
    mk = lambda *shape: init.dense(shape)  # noqa: E731
    D = cfg.n_state
    blocks = [{
        "attn": {
            "q": {"w": mk(D, D), "b": mk(D)},
            "k": {"w": mk(D, D)},
            "v": {"w": mk(D, D), "b": mk(D)},
            "out": {"w": mk(D, D), "b": mk(D)},
        },
        "attn_ln": {"w": mk(D), "b": mk(D)},
        "mlp1": {"w": mk(D, 4 * D), "b": mk(4 * D)},
        "mlp2": {"w": mk(4 * D, D), "b": mk(D)},
        "mlp_ln": {"w": mk(D), "b": mk(D)},
    } for _ in range(cfg.n_layer)]
    return {
        "conv1": {"w": mk(3, cfg.n_mels, D), "b": mk(D)},
        "conv2": {"w": mk(3, D, D), "b": mk(D)},
        "pos": torch.from_numpy(_sinusoid_table(cfg.n_audio_ctx, D)),
        "blocks": blocks,
        "fsq": {"w": mk(D, cfg.fsq_dim), "b": mk(cfg.fsq_dim)},
    }


