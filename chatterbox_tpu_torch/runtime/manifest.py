"""Canonical checkpoint key manifests and the load-time diff (a copy of
``chatterbox_tpu/runtime/manifest.py``; the module is numpy only).

The reference snapshot has four weight artifacts: ``t3_cfg.safetensors``,
``ve.safetensors``, ``s3gen.safetensors`` and ``conds.pt``.

* ``t3_checkpoint_schema`` / ``ve_checkpoint_schema`` (here) and
  ``s3gen_checkpoint_schema`` (``models/s3gen_ref/schema.py``) give the
  expected key→shape map of each artifact;
* ``chatterbox_tpu_torch/data/checkpoint_manifest.json`` freezes the
  full-size schemas (the same file as the JAX package's, which
  ``scripts/gen_manifest.py`` writes);
* ``diff_against_manifest`` compares a real file's key/shape set with the
  manifest, and ``load_reference_checkpoint`` logs the result at load time.

Known-unmapped prefixes (documented, not silent):

* ``tfmr.embed_tokens.`` / ``tfmr.rotary_emb.`` — the HF LlamaModel inside
  T3 persists its (unused) token-embedding table and sometimes rotary
  buffers; T3 feeds inputs_embeds, so these are never consumed.

The perceiver resampler is mapped: ``cond_enc.perceiver.*`` follows the
public Chatterbox ``Perceiver`` (``pre_attention_query`` and one shared
``attn`` block).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

Shape = Tuple[int, ...]

MANIFEST_PATH = Path(__file__).resolve().parent.parent / "data" / "checkpoint_manifest.json"

# Real-checkpoint keys that are expected to exist but are deliberately not
# consumed by the converters (see module docstring).
KNOWN_UNMAPPED_PREFIXES = (
    "tfmr.embed_tokens.",
    "tfmr.rotary_emb.",
)

# The reference checkpoint's learned-position tables cover its TRAINING
# budgets (max_text_tokens 2048 / max_speech_tokens 4096, +2 specials —
# public Chatterbox T3 config); serving never indexes past our smaller
# budgets (the reference decode cap is 1000 tokens per chunk),
# so conversion takes the table's row prefix. The manifest records the
# checkpoint-side (full) row counts.
T3_CKPT_TEXT_POS_ROWS = 2050
T3_CKPT_SPEECH_POS_ROWS = 4098


def t3_checkpoint_schema(cfg) -> Dict[str, Shape]:
    """``t3_cfg.safetensors`` key→shape map (T3 module state-dict names:
    tfmr.* for the HF LlamaModel, cond_enc.* for the conditioning encoder —
    the names convert_t3 consumes)."""
    D = cfg.hidden_size
    d: Dict[str, Shape] = {
        "text_emb.weight": (cfg.text_vocab_size, D),
        "speech_emb.weight": (cfg.speech_vocab_size, D),
        "text_pos_emb.emb.weight": (T3_CKPT_TEXT_POS_ROWS, D),
        "speech_pos_emb.emb.weight": (T3_CKPT_SPEECH_POS_ROWS, D),
        "text_head.weight": (cfg.text_vocab_size, D),
        "text_head.bias": (cfg.text_vocab_size,),
        "speech_head.weight": (cfg.speech_vocab_size, D),
        "speech_head.bias": (cfg.speech_vocab_size,),
        "tfmr.norm.weight": (D,),
        "cond_enc.spkr_enc.weight": (D, cfg.speaker_embed_dim),
        "cond_enc.spkr_enc.bias": (D,),
        "cond_enc.emotion_adv_fc.weight": (D, 1),
        "cond_enc.emotion_adv_fc.bias": (D,),
    }
    if cfg.use_perceiver_resampler:
        # public Chatterbox Perceiver: query bank stored [1, N, D]; one
        # shared AttentionBlock2 (LayerNorm + 4 biased linears)
        d["cond_enc.perceiver.pre_attention_query"] = (1, cfg.perceiver_latents, D)
        d["cond_enc.perceiver.attn.norm.weight"] = (D,)
        d["cond_enc.perceiver.attn.norm.bias"] = (D,)
        for lin in ("to_q", "to_k", "to_v", "proj_out"):
            d[f"cond_enc.perceiver.attn.{lin}.weight"] = (D, D)
            d[f"cond_enc.perceiver.attn.{lin}.bias"] = (D,)
    for i in range(cfg.num_layers):
        b = f"tfmr.layers.{i}."
        d[b + "self_attn.q_proj.weight"] = (cfg.num_heads * cfg.head_dim, D)
        d[b + "self_attn.k_proj.weight"] = (cfg.num_kv_heads * cfg.head_dim, D)
        d[b + "self_attn.v_proj.weight"] = (cfg.num_kv_heads * cfg.head_dim, D)
        d[b + "self_attn.o_proj.weight"] = (D, cfg.num_heads * cfg.head_dim)
        d[b + "mlp.gate_proj.weight"] = (cfg.intermediate_size, D)
        d[b + "mlp.up_proj.weight"] = (cfg.intermediate_size, D)
        d[b + "mlp.down_proj.weight"] = (D, cfg.intermediate_size)
        d[b + "input_layernorm.weight"] = (D,)
        d[b + "post_attention_layernorm.weight"] = (D,)
    return d


def ve_checkpoint_schema(cfg) -> Dict[str, Shape]:
    """``ve.safetensors`` key→shape map (torch LSTM + proj state-dict)."""
    d: Dict[str, Shape] = {}
    in_dim = cfg.n_mels
    for i in range(cfg.layers):
        d[f"lstm.weight_ih_l{i}"] = (4 * cfg.hidden, in_dim)
        d[f"lstm.weight_hh_l{i}"] = (4 * cfg.hidden, cfg.hidden)
        d[f"lstm.bias_ih_l{i}"] = (4 * cfg.hidden,)
        d[f"lstm.bias_hh_l{i}"] = (4 * cfg.hidden,)
        in_dim = cfg.hidden
    d["proj.weight"] = (cfg.embed_dim, cfg.hidden)
    d["proj.bias"] = (cfg.embed_dim,)
    return d


def build_full_manifest() -> Dict[str, Dict[str, List[int]]]:
    """The full-size manifest for all three safetensors artifacts."""
    from ..models.s3gen_ref import S3GenRefConfig
    from ..models.s3gen_ref.schema import s3gen_checkpoint_schema
    from ..models.t3 import T3Config
    from ..models.voice_encoder import VoiceEncoderConfig

    return {
        "t3_cfg.safetensors": {k: list(v) for k, v in t3_checkpoint_schema(T3Config()).items()},
        "ve.safetensors": {k: list(v) for k, v in ve_checkpoint_schema(VoiceEncoderConfig()).items()},
        "s3gen.safetensors": {
            k: list(v) for k, v in s3gen_checkpoint_schema(S3GenRefConfig()).items()
        },
    }


def load_manifest() -> Optional[Dict[str, Dict[str, List[int]]]]:
    if not MANIFEST_PATH.exists():
        return None
    with open(MANIFEST_PATH) as f:
        return json.load(f)


def _normalize_wn(key: str) -> str:
    """Fold the two torch weight-norm spellings onto one canonical name."""
    return key.replace(
        ".parametrizations.weight.original0", ".weight_g"
    ).replace(".parametrizations.weight.original1", ".weight_v")


def diff_against_manifest(
    actual: Dict[str, Shape], expected: Dict[str, List[int]]
) -> Dict[str, List[str]]:
    """Compare a real checkpoint's {key: shape} against the manifest.

    → {"unexpected": [...], "missing": [...], "shape_mismatch": [...],
       "known_unmapped": [...]} (sorted; shapes rendered into the strings).
    Weight-norm spelling differences are not reported (both accepted)."""
    exp = {_normalize_wn(k): tuple(v) for k, v in expected.items()}
    act = {}
    for k, v in actual.items():
        act[_normalize_wn(k)] = tuple(v)
    unexpected, mismatched, known = [], [], []
    for k, shape in sorted(act.items()):
        if k in exp:
            # weight_g shapes differ between spellings (torch parametrize
            # stores original0 as [out] not [out,1,1]) — compare loosely on
            # element count for *_g leaves
            if shape != exp[k] and not (
                k.endswith("weight_g")
                and int(np.prod(shape or (1,))) == int(np.prod(exp[k] or (1,)))
            ):
                mismatched.append(f"{k}: file {shape} vs manifest {exp[k]}")
        elif any(k.startswith(p) for p in KNOWN_UNMAPPED_PREFIXES):
            known.append(k)
        else:
            unexpected.append(k)
    missing = sorted(set(exp) - set(act))
    return {
        "unexpected": unexpected,
        "missing": missing,
        "shape_mismatch": mismatched,
        "known_unmapped": known,
    }


def log_manifest_diff(name: str, actual: Dict[str, Shape]) -> Optional[Dict[str, List[str]]]:
    """One loud log line per artifact at load time → the diff (None when the
    manifest has no entry for ``name``; never raises)."""
    from ..logging_config import log

    try:
        manifest = load_manifest()
        if manifest is None or name not in manifest:
            return None
        diff = diff_against_manifest(actual, manifest[name])
        n_ok = len(actual) - sum(len(v) for v in diff.values())
        if not (diff["unexpected"] or diff["missing"] or diff["shape_mismatch"]):
            log.info(
                "%s matches the canonical manifest (%d keys%s)", name, len(actual),
                f", {len(diff['known_unmapped'])} known-unmapped" if diff["known_unmapped"] else "",
            )
        else:
            log.warning(
                "%s DIFFERS from the canonical manifest: %d unexpected %s | "
                "%d missing %s | %d shape mismatches %s (%d keys matched)",
                name,
                len(diff["unexpected"]), diff["unexpected"][:10],
                len(diff["missing"]), diff["missing"][:10],
                len(diff["shape_mismatch"]), diff["shape_mismatch"][:10],
                n_ok,
            )
        return diff
    except Exception:
        log.warning("manifest diff for %s failed", name, exc_info=True)
        return None
