"""Register a reference WAV as a clonable voice (the counterpart of
``scripts/clone_voice.py``): "cloning" a voice copies the WAV into the
voices directory (``VOICES_DIR``); the engine computes its conditioning at
its first request and caches it per voice id.

    python -m chatterbox_tpu_torch.scripts.clone_voice path/to/speaker.wav [voice_id]
"""
from __future__ import annotations

import os
import shutil
import sys

from ..settings import get_settings


def clone_voice(wav_path: str, voice_id: str | None = None) -> str:
    if not os.path.isfile(wav_path):
        raise FileNotFoundError(wav_path)
    voice_id = voice_id or os.path.basename(wav_path)
    if os.path.basename(voice_id) != voice_id:
        raise ValueError(f"Invalid voice id: {voice_id!r}")
    voices_dir = get_settings().VOICES_DIR
    os.makedirs(voices_dir, exist_ok=True)
    dest = os.path.join(voices_dir, voice_id)
    if os.path.exists(dest):
        raise FileExistsError(f"Voice '{voice_id}' already exists.")
    shutil.copyfile(wav_path, dest)
    return dest


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        sys.exit(1)
    dest = clone_voice(argv[0], argv[1] if len(argv) > 1 else None)
    print(f"Voice registered at {dest}")


if __name__ == "__main__":
    main()
