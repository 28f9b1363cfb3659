"""Default-voice loading: ``conds.pt`` → normalised fields (torch counterpart
of ``chatterbox_tpu.runtime.loader.load_default_conds``).

Checkpoint loading (``t3_cfg.safetensors``, ``s3gen.safetensors``) is not
ported yet (ROADMAP.md Queue 1 item 8).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


def _np(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float() if x.is_floating_point() else x.detach().cpu()
        x = x.numpy()
    return np.asarray(x, dtype)


def _first_int(x, default: int) -> int:
    return int(np.asarray(_np(x, np.int64)).reshape(-1)[0]) if x is not None else default


def load_default_conds(path: Path) -> Optional[Dict]:
    """Read ``conds.pt`` — the snapshot's baked-in default voice.

    Format: ``torch.save({"t3": T3Cond.__dict__, "gen": {...}})`` where the
    T3 part holds ``speaker_emb`` [1, 256], ``cond_prompt_speech_tokens``
    [1, ≤150] and ``emotion_adv`` [1, 1, 1], and ``gen`` is the S3Gen
    ``embed_ref`` dict (``prompt_token``/``prompt_token_len``/
    ``prompt_feat`` [1, 2n, 80]/``prompt_feat_len``/``embedding`` [1, 192]).
    Returns the same normalised numpy fields as the JAX loader, or None when
    the file is absent. Loaded with ``weights_only=True`` (tensors and plain
    containers only)."""
    path = Path(path)
    if not path.exists():
        return None
    raw = torch.load(path, map_location="cpu", weights_only=True)
    t3, gen = raw["t3"], raw["gen"]
    tokens = np.atleast_2d(_np(t3["cond_prompt_speech_tokens"], np.int32))
    feat = _np(gen["prompt_feat"], np.float32)
    if feat.ndim == 2:
        feat = feat[None]
    gtok = np.atleast_2d(_np(gen["prompt_token"], np.int32))
    emo = t3.get("emotion_adv")
    return {
        "speaker_emb": np.atleast_2d(_np(t3["speaker_emb"], np.float32)),
        "prompt_speech_tokens": tokens,
        "emotion_adv": float(_np(emo, np.float32).reshape(-1)[0]) if emo is not None else 0.5,
        "prompt_token": gtok,
        "prompt_token_len": _first_int(gen.get("prompt_token_len"), gtok.shape[1]),
        "prompt_feat": feat,
        "prompt_feat_len": _first_int(gen.get("prompt_feat_len"), feat.shape[1]),
        "embedding": np.atleast_2d(_np(gen["embedding"], np.float32)),
    }
