"""Checkpoint loading: the reference snapshot's files → the port's parameters
(torch counterpart of ``chatterbox_tpu/runtime/loader.py``).

The reference serving stack loads ``t3_cfg.safetensors``, ``ve.safetensors``,
``s3gen.safetensors``, ``tokenizer.json`` and ``conds.pt`` from one model
directory. The converters fill the JAX-layout tree of each model, exactly as
the JAX package's do, and ``convert.convert_params`` then casts it and lays
it out for torch, so the bridge that the parity tests hold is the one place
where layouts change:

* T3: the llama backbone maps 1:1 (q/k/v/o, gate/up/down stacked over the
  layers, norms, embeddings, heads, the Perceiver); the learned position
  tables are cut to the row prefix the model uses;
* VoiceEncoder: the LSTM and its projection map 1:1;
* S3Gen (ref): ``models/s3gen_ref/convert.py`` maps the tokenizer, CAMPPlus,
  the conformer and CFM flow and HiFT, with both weight-norm spellings.
  With ``s3gen_arch="dit"`` ``s3gen.safetensors`` is not loaded (a warning
  says so): the DiT stack and S3Tok have no reference weights and keep the
  random init.

Files are read by ``safetensors_io`` (no ``safetensors`` package needed). A
file that is present but unreadable raises; a tensor the files lack keeps
the random init the engine would have drawn at its seed, with a warning, as
in the JAX loader. ``conds.pt`` is read with ``torch.load(weights_only=True)``.

``load_params`` is the engine's whole lookup (a native checkpoint, the
reference files, else the seeded random init); the followers of a
tensor-parallel engine (``runtime/tp_serving.py``) call it too, so every
rank builds the same weights.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..convert import convert_params
from ..logging_config import log
from ..models.s3gen import s3gen_param_tree
from ..models.s3gen_ref.convert import convert_s3gen_ref
from ..models.s3gen_ref.model import s3gen_ref_param_tree
from ..models.s3tok import s3tok_param_tree
from ..models.t3.model import t3_param_tree
from ..models.voice_encoder.model import voice_encoder_param_tree
from ..ops.initializers import DenseInit, ShapeInit, make_generator
from .manifest import log_manifest_diff
from .safetensors_io import load_file


def param_trees(engine_cfg, init) -> Dict:
    """The JAX-layout trees of the engine's models, drawn by ``init`` in the
    order the engine draws them: T3, S3Gen, VoiceEncoder for the ref arch;
    T3, S3Gen, S3Tok, VoiceEncoder for the DiT."""
    if engine_cfg.s3gen_arch == "ref":
        return {"t3": t3_param_tree(engine_cfg.t3, init),
                "s3gen": s3gen_ref_param_tree(engine_cfg.s3gen_ref, init),
                "ve": voice_encoder_param_tree(engine_cfg.ve, init)}
    return {"t3": t3_param_tree(engine_cfg.t3, init),
            "s3gen": s3gen_param_tree(engine_cfg.s3gen, init),
            "s3tok": s3tok_param_tree(engine_cfg.s3tok, init),
            "ve": voice_encoder_param_tree(engine_cfg.ve, init)}


def _is_unset(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_meta


def _unset_paths(tree, prefix: str = "") -> list:
    """'/'-joined paths of the template leaves no file filled."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _unset_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _unset_paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]] if _is_unset(tree) else []


def _fill_unset(tree, init_tree):
    """Each unset leaf of ``tree`` replaced by its counterpart in ``init_tree``."""
    if isinstance(tree, dict):
        return {k: _fill_unset(v, init_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_fill_unset(v, w) for v, w in zip(tree, init_tree)]
    return init_tree if _is_unset(tree) else tree


def _assign(dst: Dict, path: list, value: np.ndarray, report: list, row_prefix: bool = False) -> None:
    node = dst
    for k in path[:-1]:
        node = node[k]
    leaf = node[path[-1]]
    if row_prefix and value.shape[1:] == tuple(leaf.shape[1:]) and value.shape[0] >= leaf.shape[0]:
        # checkpoint table longer than our budget → take the row prefix
        # (learned position tables: the checkpoint covers training budgets of
        # 2048 text / 4096 speech positions; serving never indexes past our
        # smaller ones)
        value = value[: leaf.shape[0]]
    if tuple(leaf.shape) != tuple(value.shape):
        report.append(f"shape mismatch at {'/'.join(map(str, path))}: {tuple(leaf.shape)} vs {value.shape}")
        return
    node[path[-1]] = value


def convert_t3(raw: Dict[str, np.ndarray], params: Dict,
               used: Optional[set] = None, report_out: Optional[list] = None) -> Dict:
    """Map HF-Llama-style T3 tensors into the stacked-layer JAX-layout tree
    (filled in place and returned; casting is the bridge's).

    ``used`` (optional set) collects every checkpoint key consumed and
    ``report_out`` (optional list) the shape-mismatch reports."""
    report: list = [] if report_out is None else report_out
    if used is None:
        used = set()
    L = params["backbone"]["layers"]["wq"].shape[0]

    def stack(fmt: str, transpose: bool = True) -> Optional[np.ndarray]:
        mats = []
        for i in range(L):
            key = fmt.format(i=i)
            if key not in raw:
                return None
            m = raw[key]
            used.add(key)
            mats.append(m.T if transpose and m.ndim == 2 else m)
        return np.stack(mats)

    prefixes = ["tfmr.layers.{i}.", "t3.tfmr.layers.{i}.", "model.layers.{i}."]
    for pre in prefixes:
        wq = stack(pre + "self_attn.q_proj.weight")
        if wq is None:
            continue
        mapping = {
            ("backbone", "layers", "wq"): wq,
            ("backbone", "layers", "wk"): stack(pre + "self_attn.k_proj.weight"),
            ("backbone", "layers", "wv"): stack(pre + "self_attn.v_proj.weight"),
            ("backbone", "layers", "wo"): stack(pre + "self_attn.o_proj.weight"),
            ("backbone", "layers", "w_gate"): stack(pre + "mlp.gate_proj.weight"),
            ("backbone", "layers", "w_up"): stack(pre + "mlp.up_proj.weight"),
            ("backbone", "layers", "w_down"): stack(pre + "mlp.down_proj.weight"),
            ("backbone", "layers", "attn_norm"): stack(pre + "input_layernorm.weight", transpose=False),
            ("backbone", "layers", "mlp_norm"): stack(pre + "post_attention_layernorm.weight", transpose=False),
        }
        for path, value in mapping.items():
            if value is not None:
                _assign(params, list(path), value, report)
        break

    flat_map = {
        "text_emb.weight": ("text_emb",),
        "speech_emb.weight": ("speech_emb",),
        "text_head.weight": ("text_head", "w"),
        "text_head.bias": ("text_head", "b"),
        "speech_head.weight": ("speech_head", "w"),
        "speech_head.bias": ("speech_head", "b"),
        "text_pos_emb.emb.weight": ("text_pos",),
        "speech_pos_emb.emb.weight": ("speech_pos",),
        "tfmr.norm.weight": ("backbone", "final_norm"),
        "cond_enc.spkr_enc.weight": ("cond", "spkr", "w"),
        "cond_enc.spkr_enc.bias": ("cond", "spkr", "b"),
        "cond_enc.emotion_adv_fc.weight": ("cond", "emotion", "w"),
        "cond_enc.emotion_adv_fc.bias": ("cond", "emotion", "b"),
    }
    if "perceiver" in params["cond"]:
        # public Chatterbox Perceiver state-dict (one shared AttentionBlock2
        # applied cross then self — models/t3/model.py perceiver_resample)
        flat_map.update({
            "cond_enc.perceiver.pre_attention_query": ("cond", "perceiver", "query"),
            "cond_enc.perceiver.attn.norm.weight": ("cond", "perceiver", "attn", "norm_w"),
            "cond_enc.perceiver.attn.norm.bias": ("cond", "perceiver", "attn", "norm_b"),
            "cond_enc.perceiver.attn.to_q.weight": ("cond", "perceiver", "attn", "wq", "w"),
            "cond_enc.perceiver.attn.to_q.bias": ("cond", "perceiver", "attn", "wq", "b"),
            "cond_enc.perceiver.attn.to_k.weight": ("cond", "perceiver", "attn", "wk", "w"),
            "cond_enc.perceiver.attn.to_k.bias": ("cond", "perceiver", "attn", "wk", "b"),
            "cond_enc.perceiver.attn.to_v.weight": ("cond", "perceiver", "attn", "wv", "w"),
            "cond_enc.perceiver.attn.to_v.bias": ("cond", "perceiver", "attn", "wv", "b"),
            "cond_enc.perceiver.attn.proj_out.weight": ("cond", "perceiver", "attn", "wo", "w"),
            "cond_enc.perceiver.attn.proj_out.bias": ("cond", "perceiver", "attn", "wo", "b"),
        })
    for key, path in flat_map.items():
        for candidate in (key, "t3." + key):
            if candidate in raw:
                used.add(candidate)
                v = raw[candidate]
                if v.ndim == 2 and path[-1] in ("w",):
                    v = v.T
                if path[-1] == "query" and v.ndim == 3 and v.shape[0] == 1:
                    v = v[0]  # checkpoint stores the query bank as [1, N, D]
                _assign(params, list(path), v, report,
                        row_prefix=path[-1] in ("text_pos", "speech_pos"))
                break
    if report:
        log.warning("T3 conversion: %d tensors left at init:\n  %s", len(report), "\n  ".join(report[:20]))
    return params


def convert_voice_encoder(raw: Dict[str, np.ndarray], params: Dict,
                          used: Optional[set] = None, report_out: Optional[list] = None) -> Dict:
    """Map the torch LSTM + projection state-dict into the JAX-layout tree
    (the two LSTM biases summed, as the JAX loader does)."""
    report: list = [] if report_out is None else report_out
    if used is None:
        used = set()
    for i, layer in enumerate(params["lstm"]):
        for src, dst in (
            (f"lstm.weight_ih_l{i}", "wx"),
            (f"lstm.weight_hh_l{i}", "wh"),
        ):
            if src in raw:
                used.add(src)
                _assign({"x": layer}, ["x", dst], raw[src].T, report)
        bias = None
        if f"lstm.bias_ih_l{i}" in raw:
            used.add(f"lstm.bias_ih_l{i}")
            bias = raw[f"lstm.bias_ih_l{i}"]
            if f"lstm.bias_hh_l{i}" in raw:
                used.add(f"lstm.bias_hh_l{i}")
                bias = bias + raw[f"lstm.bias_hh_l{i}"]
        if bias is not None:
            _assign({"x": layer}, ["x", "b"], bias, report)
    if "proj.weight" in raw:
        used.add("proj.weight")
        _assign(params, ["proj", "w"], raw["proj.weight"].T, report)
    if "proj.bias" in raw:
        used.add("proj.bias")
        _assign(params, ["proj", "b"], raw["proj.bias"], report)
    if report:
        log.warning("VoiceEncoder conversion issues: %s", report)
    return params


def load_reference_checkpoint(model_dir: Path, engine_cfg, dtype, device, seed: int = 0,
                              report: Optional[Dict] = None) -> Optional[Dict]:
    """Load what the model directory holds → the port's parameters on
    ``device`` in ``dtype``, or None when it holds none of the three files.
    Under the DiT arch ``s3gen.safetensors`` counts as found but is not
    read (``report["skipped"]`` names it).

    Leaves the files do not fill keep the random init that
    ``TTSEngine(seed=seed)`` draws on ``device``, and a warning names them.
    ``report`` (optional dict) receives, per file, its key count and bytes,
    the manifest diff, and the mismatched, missing and unused lists; then
    the load's wall seconds and total bytes."""
    t0 = time.perf_counter()
    report = {} if report is None else report
    trees = param_trees(engine_cfg, ShapeInit())
    files: Dict[str, Dict] = {}

    def read(name: str) -> Optional[Dict[str, np.ndarray]]:
        path = Path(model_dir) / name
        if not path.exists():
            return None
        raw = load_file(path)
        diff = log_manifest_diff(name, {k: v.shape for k, v in raw.items()})
        files[name] = {"keys": len(raw), "bytes": path.stat().st_size,
                       "manifest": {k: len(v) for k, v in (diff or {}).items()}}
        return raw

    for name, model, convert in (("t3_cfg.safetensors", "t3", convert_t3),
                                 ("ve.safetensors", "ve", convert_voice_encoder)):
        raw = read(name)
        if raw is None:
            continue
        used, mismatched = set(), []
        trees[model] = convert(raw, trees[model], used=used, report_out=mismatched)
        files[name].update(mismatched=mismatched, missing=_unset_paths(trees[model]),
                           unused=sorted(set(raw) - used))
        log.info("Loaded %s weights from %s", model, Path(model_dir) / name)
    s3_file = Path(model_dir) / "s3gen.safetensors"
    if engine_cfg.s3gen_arch != "ref" and s3_file.exists():
        log.warning("s3gen.safetensors found, but s3gen_arch='dit' serves the DiT redesign, "
                    "which has its own weights; set CHATTERBOX_S3GEN_ARCH=ref to serve the "
                    "pretrained stack.")
        report["skipped"] = [s3_file.name]
    raw = read(s3_file.name) if engine_cfg.s3gen_arch == "ref" else None
    if raw is not None:
        result = convert_s3gen_ref(raw, trees["s3gen"], engine_cfg.s3gen_ref)
        trees["s3gen"] = result["params"]
        files["s3gen.safetensors"].update({k: result[k] for k in ("mismatched", "missing", "unused")})
        n_bad = len(result["mismatched"]) + len(result["missing"]) + len(result["unused"])
        if n_bad:
            log.warning(
                "S3Gen conversion incomplete: %d mismatched, %d missing, %d unused. "
                "First issues: %s", len(result["mismatched"]), len(result["missing"]),
                len(result["unused"]),
                (result["mismatched"] + result["missing"] + result["unused"])[:10])
        else:
            log.info("Loaded S3Gen weights from %s (clean conversion)", Path(model_dir) / "s3gen.safetensors")
    if not files and not report.get("skipped"):
        return None
    unset = _unset_paths(trees)
    if unset:
        log.warning("%d parameter tensors are not in %s and keep their random init (seed %d): %s",
                    len(unset), model_dir, seed, unset[:10])
        with torch.inference_mode():
            trees = _fill_unset(trees, param_trees(
                engine_cfg, DenseInit(make_generator(seed, device), device)))
    with torch.inference_mode():
        params = convert_params(trees, device, dtype)
    report.update(files=files, seconds=time.perf_counter() - t0,
                  bytes=sum(f["bytes"] for f in files.values()))
    return params


def load_params(model_dir: Path, engine_cfg, dtype, device, seed: int,
                report: Dict) -> Dict:
    """The weights as the JAX engine finds them in ``model_dir``: a native
    checkpoint, else the reference safetensors (``t3_cfg.safetensors``
    present), else a random init on ``device`` from a generator seeded with
    ``seed`` → the port's parameters; ``report`` receives what was loaded
    and the load's wall and bytes."""
    from .checkpoint import is_native_checkpoint, load_checkpoint

    model_dir = Path(model_dir)
    t0 = time.perf_counter()
    if is_native_checkpoint(model_dir):
        params = load_checkpoint(model_dir, engine_cfg, dtype, device)
        report.update(seconds=time.perf_counter() - t0, bytes=sum(
            f.stat().st_size for f in model_dir.glob("*.safetensors")))
        log.info("Loaded native checkpoint from %s", model_dir)
        return params
    params = None
    if (model_dir / "t3_cfg.safetensors").exists():
        params = load_reference_checkpoint(model_dir, engine_cfg, dtype, device, seed, report)
    if params is None:
        log.info("No checkpoint at %s — random-init weights on %s (seed %d)", model_dir,
                 device, seed)
        with torch.inference_mode():
            # drawn in this order, so T3 and S3Gen stay the same at a seed
            trees = param_trees(engine_cfg, DenseInit(make_generator(seed, device), device))
            params = convert_params(trees, device, dtype)
    return params


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
    containers only), which refuses pickled globals as the JAX package's
    own reader does."""
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
