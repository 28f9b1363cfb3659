"""Regenerate ``chatterbox_tpu_torch/data/checkpoint_manifest.json`` (the
counterpart of ``scripts/gen_manifest.py``).

The manifest freezes the full-size key → shape schema of the three
reference safetensors files (``runtime/manifest.py``); the loader diffs a
model directory against it. Any schema change must re-run this.

    python -m chatterbox_tpu_torch.scripts.gen_manifest
"""
from __future__ import annotations

import json

from ..runtime import manifest as schema


def main(argv=None) -> None:
    manifest = schema.build_full_manifest()
    path = schema.MANIFEST_PATH
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    for name, keys in manifest.items():
        print(f"{name}: {len(keys)} keys")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
