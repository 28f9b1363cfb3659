"""A seeded model directory, for running the engine with no checkpoint.

The real weights cannot be fetched where the port is measured, so the bench
and ``chip_smoke.py`` boot from files written here: the three reference
safetensors files (``t3_cfg``, ``ve``, ``s3gen``) with every key of the
schema and ``synthesize_checkpoint``'s seeded values, a seeded ``conds.pt``
in the reference format, and a small ``tokenizer.json``. With the default
configs the files are full size (2,792 keys, 2.98 GiB); the same seeds give
the same bytes on every run.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import torch

from ..models.s3gen_ref import S3GenRefConfig
from ..models.s3gen_ref.schema import s3gen_checkpoint_schema, synthesize_checkpoint
from ..models.t3 import T3Config
from ..models.voice_encoder import VoiceEncoderConfig
from .manifest import t3_checkpoint_schema, ve_checkpoint_schema
from .safetensors_io import save_file

# the files' values: synthesize_checkpoint(schema, seed=CHECKPOINT_SEED + i)
# for the i-th file, in the order t3_cfg, ve, s3gen
CHECKPOINT_SEED = 0
CONDS_SEED = 7

# a tokenizer.json from a small vocabulary and merge list (the format
# scripts/train_tokenizer.py writes; merges as "a b" strings, as older files
# hold them): the port's BPE reader gives TOKENIZER_IDS for
# TOKENIZER_SENTENCE, which tests/test_torch_tokenizer.py holds to the
# `tokenizers` package's ids for the same file
TOKENIZER_SPECIALS = ("[STOP]", "[UNK]", "[SPACE]")
TOKENIZER_MERGES = (("t", "h"), ("th", "e"), ("i", "n"), ("in", "g"), ("e", "r"),
                    ("a", "n"), ("an", "d"), ("o", "n"), ("r", "e"), ("e", "s"),
                    ("o", "u"), ("a", "t"), ("e", "n"), ("o", "r"), ("s", "t"),
                    ("h", "e"), ("q", "u"), ("qu", "i"), ("c", "k"), ("l", "l"))
TOKENIZER_SENTENCE = "The quick brown fox, 42 things! Hello?"
TOKENIZER_IDS = [51, 2, 67, 68, 2, 4, 20, 17, 25, 16, 2, 8, 17, 26, 40, 2, 33, 31, 2, 50, 53,
                 21, 41, 2, 65, 69, 17, 42]


def write_conds(path: Path, seed: int = CONDS_SEED, spk_dim: int = 256) -> None:
    """A seeded default voice in the reference conds.pt format (full size:
    a 150-token T3 prompt, a 250-token / 500-frame S3Gen prompt, which the
    engine cuts to its config's windows). ``spk_dim``: the T3 speaker
    embedding's width (256 at full size)."""
    g = torch.Generator().manual_seed(seed)
    t3 = {
        "speaker_emb": torch.randn((1, spk_dim), generator=g),
        "cond_prompt_speech_tokens": torch.randint(0, 6561, (1, 150), generator=g),
        "emotion_adv": 0.5 * torch.ones(1, 1, 1),
    }
    gen = {
        "prompt_token": torch.randint(0, 6561, (1, 250), generator=g),
        "prompt_token_len": torch.tensor([250]),
        "prompt_feat": torch.randn((1, 500, 80), generator=g) * 2.0 - 6.0,
        "prompt_feat_len": torch.tensor([500]),
        "embedding": torch.randn((1, 192), generator=g),
    }
    torch.save({"t3": t3, "gen": gen}, path)


def write_tokenizer_json(path: Path) -> None:
    tokens = list(TOKENIZER_SPECIALS) + list("abcdefghijklmnopqrstuvwxyz0123456789.,!?'-:;\"()")
    tokens += [a + b for a, b in TOKENIZER_MERGES]
    vocab = {t: i for i, t in enumerate(tokens)}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, t in enumerate(TOKENIZER_SPECIALS)],
        "normalizer": None, "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None,
        "decoder": None,
        "model": {"type": "BPE", "dropout": None, "unk_token": "[UNK]",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": [f"{a} {b}" for a, b in TOKENIZER_MERGES]},
    }
    path.write_text(json.dumps(spec, indent=2))


def write_reference_checkpoint(model_dir: Path, t3: Optional[T3Config] = None,
                               ve: Optional[VoiceEncoderConfig] = None,
                               s3gen: Optional[S3GenRefConfig] = None) -> dict:
    """The three reference safetensors files from the port's schemas (every
    key of the manifest, seeded values; full size unless smaller configs are
    given), a seeded conds.pt and a tokenizer.json in ``model_dir`` → per
    file its keys, values and bytes; the total bytes; the seconds spent
    drawing the values and writing them."""
    t3, ve, s3gen = t3 or T3Config(), ve or VoiceEncoderConfig(), s3gen or S3GenRefConfig()
    files = {"t3_cfg.safetensors": t3_checkpoint_schema(t3),
             "ve.safetensors": ve_checkpoint_schema(ve),
             "s3gen.safetensors": s3gen_checkpoint_schema(s3gen)}
    info, synth_s, write_s = {}, 0.0, 0.0
    for i, (name, schema) in enumerate(files.items()):
        t0 = time.perf_counter()
        raw = synthesize_checkpoint(schema, seed=CHECKPOINT_SEED + i)
        t1 = time.perf_counter()
        save_file(raw, model_dir / name)
        synth_s, write_s = synth_s + t1 - t0, write_s + time.perf_counter() - t1
        info[name] = {"keys": len(raw), "values": int(sum(v.size for v in raw.values())),
                      "bytes": (model_dir / name).stat().st_size}
        del raw
    write_conds(model_dir / "conds.pt", spk_dim=t3.speaker_embed_dim)
    write_tokenizer_json(model_dir / "tokenizer.json")
    return {"files": info, "bytes": sum(f["bytes"] for f in info.values()), "synth_s": synth_s,
            "write_s": write_s}
