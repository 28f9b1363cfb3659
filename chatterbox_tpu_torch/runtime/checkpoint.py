"""Native checkpoint format: save and load the engine's own parameters (torch
counterpart of ``chatterbox_tpu/runtime/checkpoint.py``).

The files are the JAX package's: one safetensors file per model
(``t3``, ``s3gen``, ``ve``, and ``s3tok`` under the DiT arch), float32,
its keys the '/'-joined paths of the JAX-layout tree (list nodes use
numeric segments), and
``chatterbox_tpu.json`` recording the format, the models, the S3Gen arch and
the configs. So the JAX package reads what the port writes and the port
reads what the JAX package writes: the writer turns the port's layouts back
with ``convert.unconvert_params``, the reader forward with
``convert.convert_params``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ..convert import convert_params, unconvert_params
from ..ops.initializers import ShapeInit
from .loader import param_trees
from .safetensors_io import load_file, save_file

NATIVE_MANIFEST = "chatterbox_tpu.json"
FORMAT = "chatterbox_tpu/v1"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray], prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten_into(v, flat, f"{prefix}{i}/") for i, v in enumerate(template)]
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing tensor {key}")
    value = flat[key]
    if tuple(value.shape) != tuple(template.shape):
        raise ValueError(f"{key}: checkpoint shape {value.shape} != model {tuple(template.shape)}")
    return value


def save_checkpoint(path, params: Dict, engine_cfg) -> None:
    """Write ``params`` (the port's layout, any device and dtype) as a native
    checkpoint: float32 JAX-layout files and the manifest."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    for name, tree in params.items():
        with torch.inference_mode():
            flat = _flatten(unconvert_params(tree))
            host = {k: v.float().cpu().numpy() for k, v in flat.items()}
        save_file(host, path / f"{name}.safetensors")
    configs = {"t3": dataclasses.asdict(engine_cfg.t3), "ve": dataclasses.asdict(engine_cfg.ve)}
    if engine_cfg.s3gen_arch == "ref":
        configs["s3gen"] = dataclasses.asdict(engine_cfg.s3gen_ref)
    else:
        configs["s3gen"] = dataclasses.asdict(engine_cfg.s3gen)
        configs["s3tok"] = dataclasses.asdict(engine_cfg.s3tok)
    manifest = {
        "format": FORMAT,
        "models": sorted(params.keys()),
        "s3gen_arch": engine_cfg.s3gen_arch,
        "configs": configs,
    }
    (path / NATIVE_MANIFEST).write_text(json.dumps(manifest, indent=2))


def is_native_checkpoint(path) -> bool:
    return (Path(path) / NATIVE_MANIFEST).exists()


def load_checkpoint(path, engine_cfg, dtype, device) -> Dict:
    """Load a native checkpoint, shape-checked against the configs' trees,
    into the port's layout on ``device`` in ``dtype``. A checkpoint of
    another S3Gen arch than the config's raises ValueError."""
    path = Path(path)
    manifest = json.loads((path / NATIVE_MANIFEST).read_text())
    arch = manifest.get("s3gen_arch", "dit")
    if arch != engine_cfg.s3gen_arch:
        raise ValueError(
            f"checkpoint was saved with s3gen_arch={arch!r} but the engine is "
            f"configured for {engine_cfg.s3gen_arch!r} (set CHATTERBOX_S3GEN_ARCH={arch})")
    templates = param_trees(engine_cfg, ShapeInit())
    trees = {name: _unflatten_into(template, load_file(path / f"{name}.safetensors"))
             for name, template in templates.items()}
    with torch.inference_mode():
        return convert_params(trees, device, dtype)
