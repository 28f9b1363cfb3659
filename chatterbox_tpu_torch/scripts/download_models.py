"""Fetch the pretrained Chatterbox checkpoint into MODEL_PATH (the
counterpart of ``scripts/download_models.py``): the HF snapshot of
ResembleAI/chatterbox (``ve.safetensors``, ``t3_cfg.safetensors``,
``s3gen.safetensors``, ``tokenizer.json``, ``conds.pt``), which
``runtime/loader.py`` reads. Needs network access and ``huggingface_hub``.

    python -m chatterbox_tpu_torch.scripts.download_models [TARGET_DIR]
"""
from __future__ import annotations

import os
import sys

from ..settings import get_settings

REPO_ID = "ResembleAI/chatterbox"


def download_models(target_dir: str | None = None) -> str:
    target_dir = target_dir or get_settings().MODEL_PATH
    try:
        from huggingface_hub import snapshot_download
    except ImportError as exc:
        raise SystemExit(
            "huggingface_hub is not installed in this environment; fetch the "
            f"snapshot of {REPO_ID} elsewhere and place it at {target_dir}."
        ) from exc
    os.makedirs(target_dir, exist_ok=True)
    path = snapshot_download(repo_id=REPO_ID, local_dir=target_dir)
    print(f"Models downloaded to {path}")
    return path


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    download_models(argv[0] if argv else None)


if __name__ == "__main__":
    main()
