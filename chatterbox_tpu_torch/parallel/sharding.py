"""T3's tensor-parallel rules and the batch split over ``dp`` (the port's
counterpart of ``chatterbox_tpu/parallel/sharding.py``).

Megatron-style: the attention q/k/v and the MLP's gate and up projections
split their output features over ``tp`` (column parallel), the attention
out-projection and the MLP's down projection their input features (row
parallel), so one all-reduce follows each of the two per block
(``tp.reduce_from_tp``). Everything else is replicated: the embeddings and
heads (the speech vocabulary, 8194, does not divide), the norms, the
conditioning and its perceiver.

A spec here is the dim a leaf splits on, in the port's layout: the stacked
projections are ``[L, out, in]`` (``F.linear``'s ``[out, in]`` per layer,
``convert.py``), so a column-parallel leaf splits dim 1 and a row-parallel
leaf dim 2, where the JAX package's ``[L, in, out]`` leaves carry
``P(None, None, tp)`` and ``P(None, tp, None)``. ``None`` is replicated.
Rank (d, t) of the mesh holds shard t of every split leaf.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.t3.config import T3Config
from .mesh import AXES

COLUMN, ROW = 1, 2   # the split dims of a stacked [L, out, in] projection


def t3_param_specs() -> Dict:
    """The split dim of each T3 leaf (``None``: replicated), in the
    structure of ``init_t3_params``; the perceiver subtree, when the
    parameters have one, is replicated."""
    return {
        "backbone": {
            "layers": {"attn_norm": None, "mlp_norm": None,
                       "wq": COLUMN, "wk": COLUMN, "wv": COLUMN, "wo": ROW,
                       "w_gate": COLUMN, "w_up": COLUMN, "w_down": ROW},
            "final_norm": None,
        },
    }


def _match_tree(params, specs, path=""):
    """{path: split dim} for every leaf of ``params``, the rule table's
    missing entries replicated."""
    if isinstance(params, dict):
        return {k: v for key, sub in params.items() for k, v in _match_tree(
            sub, specs.get(key) if isinstance(specs, dict) else None, f"{path}{key}/").items()}
    return {path[:-1]: specs if isinstance(specs, int) else None}


def param_split_dims(params: Dict) -> Dict[str, Optional[int]]:
    """{"backbone/layers/wq": 1, …, "text_emb": None, …}: every leaf's
    split dim by its path."""
    return _match_tree(params, t3_param_specs())


def _map_leaves(params, fn, path=""):
    if isinstance(params, dict):
        return {k: _map_leaves(v, fn, f"{path}{k}/") for k, v in params.items()}
    return fn(path[:-1], params)


def tp_group(mesh: DeviceMesh) -> Optional[dist.ProcessGroup]:
    """This rank's tensor-parallel group, or None when tp is 1 (the model
    then issues no collective)."""
    return mesh.get_group(AXES.tp) if mesh[AXES.tp].size() > 1 else None


def dp_group(mesh: DeviceMesh) -> Optional[dist.ProcessGroup]:
    """This rank's data-parallel group, or None when dp is 1."""
    return mesh.get_group(AXES.dp) if mesh[AXES.dp].size() > 1 else None


def check_tp(cfg: T3Config, tp: int) -> None:
    """Raise ``ValueError``, naming the leaf, when tp does not divide T3's
    query heads, kv heads or MLP width."""
    for leaf, count, what in (("backbone/layers/wq", cfg.num_heads, "query heads"),
                              ("backbone/layers/wk", cfg.num_kv_heads, "kv heads"),
                              ("backbone/layers/w_gate", cfg.intermediate_size, "MLP width")):
        if count % tp:
            raise ValueError(f"{leaf}: {count} {what} do not split over tp={tp}")


def shard_params(params: Dict, mesh: DeviceMesh, cfg: T3Config) -> Dict:
    """This rank's shard of a full T3 tree (every rank holds the same full
    tree): split leaves narrowed to shard ``t`` of ``tp``, contiguous;
    replicated leaves as they are."""
    tp, t = mesh[AXES.tp].size(), mesh.get_local_rank(AXES.tp)
    check_tp(cfg, tp)
    dims = param_split_dims(params)

    def leaf(path, x):
        dim = dims[path]
        if dim is None or tp == 1:
            return x
        n = x.shape[dim]
        if n % tp:
            raise ValueError(f"{path}: dim {dim} of {tuple(x.shape)} does not split over tp={tp}")
        return x.narrow(dim, t * (n // tp), n // tp).contiguous()

    return _map_leaves(params, leaf)


def unshard_params(params: Dict, mesh: DeviceMesh) -> Dict:
    """The full tree back from every rank's shards (a collective: every
    rank calls it and every rank gets the full tree, detached). Each shard
    is written at its offset in zeros and the tp group sums them, which is
    exact."""
    tp, t = mesh[AXES.tp].size(), mesh.get_local_rank(AXES.tp)
    dims, group = param_split_dims(params), tp_group(mesh)

    def leaf(path, x):
        x = x.detach()
        dim = dims[path]
        if dim is None or group is None:
            return x.clone()
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * tp
        full = torch.zeros(shape, dtype=x.dtype, device=x.device)
        full.narrow(dim, t * n, n).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    return _map_leaves(params, leaf)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a batch: the leading dim split into dp equal
    parts, part ``d`` for the rank's dp index (the JAX package's
    ``batch_sharding``, ``P("dp")``); the ranks of one tp group get the
    same rows."""
    dp, d = mesh[AXES.dp].size(), mesh.get_local_rank(AXES.dp)
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % dp:
            raise ValueError(f"batch['{k}']: {B} rows do not split over dp={dp}")
        out[k] = v[d * (B // dp):(d + 1) * (B // dp)]
    return out
