"""Environment settings for the port (no pydantic).

Reads the same environment variable names as ``chatterbox_tpu.config``
(``MODEL_PATH``, ``MAX_DECODE_SLOTS``, ``TTS_*`` …, case-insensitive), from
the process environment only. Defaults follow the JAX package: 16 decode
slots (``MAX_DECODE_SLOTS=1`` serves per request), the CFM prompt cache in
"step" mode and streaming CFM on. ``check_supported`` raises
``NotImplementedError`` naming the ROADMAP.md item when a path the port does
not have yet is asked for (progressive slices), instead of quietly ignoring
it.
"""
from __future__ import annotations

import dataclasses
import os
import typing


def _fill(cls, prefix: str):
    env = {k.upper(): v for k, v in os.environ.items()}
    types = typing.get_type_hints(cls)
    values = {}
    for f in dataclasses.fields(cls):
        raw = env.get((prefix + f.name).upper())
        if raw is not None:
            values[f.name] = types[f.name](raw)
    return cls(**values)


@dataclasses.dataclass(frozen=True)
class AppSettings:
    MODEL_PATH: str = "models"
    VOICES_DIR: str = "voices/"                    # user-uploaded voices
    PRELOADED_VOICES_DIR: str = "preloaded-voices/"
    CONCURRENT_REQUESTS_PER_WORKER: int = 0
    MAX_DECODE_SLOTS: int = 16
    DTYPE_POLICY: str = "bfloat16"
    KV_CACHE_DTYPE: str = "native"


@dataclasses.dataclass(frozen=True)
class TTSSettings:
    """The ``TTS_*`` settings the engine reads (the per-request defaults of
    the JAX package's HTTP layer arrive with the app factory)."""

    VOICE_EXAGGERATION_FACTOR: float = 0.5  # a cloned or neutral voice's exaggeration
    SPEECH_TOKEN_QUEUE_MAX_SIZE: int = 2
    PCM_CHUNK_QUEUE_MAX_SIZE: int = 3
    AUDIO_TOKENS_PER_SLICE: int = 35   # the batched decoder's slice length


def get_settings() -> AppSettings:
    return _fill(AppSettings, "")


def get_tts_config() -> TTSSettings:
    return _fill(TTSSettings, "TTS_")


# (env name, port default, value(s) that ask for a path the port lacks, item)
_UNPORTED = (
    ("CHATTERBOX_PROGRESSIVE_SLICES", "0", ("1",),
     "ROADMAP.md Queue 1 item 7 (progressive slices ride the streaming ladder)"),
)


def check_supported() -> None:
    """Raise for a setting that selects a path the port does not have yet."""
    for name, default, unported, item in _UNPORTED:
        value = os.environ.get(name, default).lower()
        if value in unported:
            raise NotImplementedError(f"{name}={value}: not ported yet — {item}")
