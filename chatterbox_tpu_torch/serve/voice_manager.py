"""Voice file store (copy of ``chatterbox_tpu/serve/voice_manager.py`` on
the port's settings).

User uploads live in ``VOICES_DIR``, shipped voices in
``PRELOADED_VOICES_DIR``; a user file shadows a preloaded one of the same
name; a ``voice_id`` is a bare filename (anything with a path in it is
refused); a duplicate upload raises ``FileExistsError``; only user voices
can be deleted.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

from ..settings import get_settings


class VoiceManager:
    def __init__(self, voices_dir: Optional[str] = None, preloaded_voices_dir: Optional[str] = None):
        cfg = get_settings()
        self.voices_dir = Path(voices_dir or cfg.VOICES_DIR)
        self.preloaded_voices_dir = Path(preloaded_voices_dir or cfg.PRELOADED_VOICES_DIR)
        self.voices_dir.mkdir(parents=True, exist_ok=True)
        self.preloaded_voices_dir.mkdir(parents=True, exist_ok=True)

    def list_voices(self) -> List[str]:
        names = set()
        for directory in (self.voices_dir, self.preloaded_voices_dir):
            if directory.is_dir():
                names.update(p.name for p in directory.iterdir() if p.is_file())
        return sorted(names)

    def get_voice_path(self, voice_id: str) -> Optional[str]:
        if not voice_id or os.path.basename(voice_id) != voice_id:  # no path traversal
            return None
        for directory in (self.voices_dir, self.preloaded_voices_dir):
            path = directory / voice_id
            if path.exists():
                return str(path)
        return None

    def voice_exists(self, voice_id: str) -> bool:
        return self.get_voice_path(voice_id) is not None

    def save_voice(self, voice_id: str, file_contents: bytes) -> str:
        if os.path.basename(voice_id) != voice_id:
            raise ValueError(f"Invalid voice id: {voice_id!r}")
        if self.voice_exists(voice_id):
            raise FileExistsError(f"Voice '{voice_id}' already exists.")
        path = self.voices_dir / voice_id
        path.write_bytes(file_contents)
        return str(path)

    def delete_voice(self, voice_id: str) -> None:
        path = self.voices_dir / voice_id
        if os.path.basename(voice_id) != voice_id or not path.exists():
            raise FileNotFoundError(f"Voice '{voice_id}' not found in user directory.")
        path.unlink()
