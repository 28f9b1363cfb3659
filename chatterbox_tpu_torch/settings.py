"""Environment settings for the port (no pydantic).

The variable names, types and defaults of ``chatterbox_tpu.config``: the
server's ``AppSettings`` (``HOST``, ``PORT``, ``API_KEY``, ``MODEL_PATH``,
``MAX_DECODE_SLOTS`` …) and the ``TTS_``-prefixed ``TTSSettings``, whose
fields are also the HTTP layer's per-request defaults (a request parameter
wins over the environment, which wins over the coded default). Names are
case-insensitive; values come from a ``.env`` file in the working
directory, overridden by the process environment. Booleans read "1", "true",
"yes" or "on"; lists read JSON or comma-separated text. Defaults follow the
JAX package: 16 decode slots (``MAX_DECODE_SLOTS=1`` serves per request),
the CFM prompt cache in "step" mode and streaming CFM on.
Every setting the JAX package reads is ported, serving under
``CHATTERBOX_TP`` included (``runtime/tp_serving.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Dict, List, Optional


def _read_env_file(path: str) -> Dict[str, str]:
    """Parse a minimal KEY=VALUE .env file (no interpolation)."""
    out: Dict[str, str] = {}
    if not os.path.isfile(path):
        return out
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            out[key.strip()] = value.strip().strip("'\"")
    return out


def _parse(tp, raw: str):
    if tp is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if tp == List[str]:
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return [s.strip() for s in raw.split(",") if s.strip()]
    if tp in (str, Optional[str]):
        return raw
    return tp(raw)


def _fill(cls, prefix: str):
    source = {**_read_env_file(".env"), **os.environ}
    env = {k.upper(): v for k, v in source.items()}
    types = typing.get_type_hints(cls)
    values = {}
    for f in dataclasses.fields(cls):
        raw = env.get((prefix + f.name).upper())
        if raw is not None:
            values[f.name] = _parse(types[f.name], raw)
    return cls(**values)


@dataclasses.dataclass(frozen=True)
class AppSettings:
    """Server and infrastructure settings (``chatterbox_tpu.config.AppConfig``)."""

    HOST: str = "0.0.0.0"
    PORT: int = 8000
    DEBUG: bool = False
    LOG_LEVEL: str = "INFO"
    VOICES_DIR: str = "voices/"                    # user-uploaded voices
    PRELOADED_VOICES_DIR: str = "preloaded-voices/"
    MODEL_PATH: str = "models"
    API_KEY: Optional[str] = None                  # required by the server, not the library
    CORS_ORIGINS: List[str] = dataclasses.field(default_factory=lambda: ["*"])
    CONCURRENT_REQUESTS_PER_WORKER: int = 0        # 0: as many as MAX_DECODE_SLOTS
    WORKERS_PER_DEVICE: int = 1
    MAX_DECODE_SLOTS: int = 16
    DTYPE_POLICY: str = "bfloat16"
    KV_CACHE_DTYPE: str = "native"


@dataclasses.dataclass(frozen=True)
class TTSSettings:
    """Per-request synthesis defaults (``chatterbox_tpu.config.TTSConfig``),
    read with the ``TTS_`` prefix."""

    VOICE_EXAGGERATION_FACTOR: float = 0.5  # a cloned or neutral voice's exaggeration
    CFG_GUIDANCE_WEIGHT: float = 0.5
    SYNTHESIS_TEMPERATURE: float = 0.8
    TEXT_PROCESSING_CHUNK_SIZE: int = 150
    AUDIO_TOKENS_PER_SLICE: int = 35   # also the batched decoder's slice length
    REMOVE_LEADING_MILLISECONDS: int = 0
    REMOVE_TRAILING_MILLISECONDS: int = 0
    CHUNK_OVERLAP_STRATEGY: str = "full"  # "full" | "zero"
    CROSSFADE_DURATION_MILLISECONDS: int = 30
    SPEECH_TOKEN_QUEUE_MAX_SIZE: int = 2
    PCM_CHUNK_QUEUE_MAX_SIZE: int = 3


def get_settings() -> AppSettings:
    return _fill(AppSettings, "")


def get_tts_config() -> TTSSettings:
    return _fill(TTSSettings, "TTS_")
