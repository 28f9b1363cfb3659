"""Speaker x-vector embedder of the DiT architecture (torch counterpart of
``chatterbox_tpu/models/s3gen/xvector.py``): a dilated TDNN over 80-bin
16 kHz log-mels with length-masked statistics pooling → a unit-norm
192-d embedding, in the weights' dtype."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ...ops.conv import conv1d
from ...ops.nn import linear
from .config import S3GenConfig


def xvector_param_tree(cfg: S3GenConfig, init, n_mels: int = 80) -> Dict:
    C = 512
    return {
        "c1": {"w": init.dense((5, n_mels, C)), "b": init.zeros((C,))},
        "c2": {"w": init.dense((3, C, C)), "b": init.zeros((C,))},
        "c3": {"w": init.dense((3, C, C)), "b": init.zeros((C,))},
        "c4": {"w": init.dense((1, C, C * 3)), "b": init.zeros((C * 3,))},
        "out": {"w": init.dense((C * 6, cfg.spk_dim)), "b": init.zeros((cfg.spk_dim,))},
    }


def xvector_embed(params: Dict, fbank: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fbank [B, T, n_mels] → [B, spk_dim]; ``valid`` [B, T] masks the
    pooled frames (None: all)."""
    h = torch.relu(conv1d(fbank, params["c1"]["w"], params["c1"]["b"]))
    h = h + torch.relu(conv1d(h, params["c2"]["w"], params["c2"]["b"], dilation=2))
    h = h + torch.relu(conv1d(h, params["c3"]["w"], params["c3"]["b"], dilation=3))
    h = torch.relu(conv1d(h, params["c4"]["w"], params["c4"]["b"]))
    if valid is None:
        valid = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
    w = valid[:, :, None].to(h.dtype)
    n = w.sum(dim=1).clamp_min(1.0)
    mean = (h * w).sum(dim=1) / n
    var = (h.square() * w).sum(dim=1) / n - mean.square()
    stats = torch.cat([mean, var.clamp_min(1e-6).sqrt()], dim=-1)
    emb = linear(stats, params["out"]["w"]) + params["out"]["b"]
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp_min(1e-6)
