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

S3Gen-ref (``s3gen_ref_param_specs``, the counterpart of the JAX package's
rules of the same name): the flow's conformer blocks (attention q/k/v/pos
and the feed-forward's w1 column parallel, ``out`` and ``w2`` row parallel,
``bias_u``/``bias_v`` on their head dim) and the CFM estimator (each
transformer block's to_q/k/v and ff1 column, to_out and ff2 row; each
resnet's time-MLP and ``block1`` conv column, ``block2`` row). A linear
weight is ``[out, in]`` and a conv weight ``[Cout, Cin, k]`` here, so a
column-parallel leaf splits dim 0 and a row-parallel one dim 1. The tokenizer,
CAMPPlus, HiFT and every other leaf are replicated. Where the JAX package
falls back to replication leaf by leaf when a dim does not divide (XLA still
computes the right answer), a rank's forward here is written for whole
blocks, so the port decides per block (``S3GEN_BLOCKS``): one conformer
attention, one feed-forward, one transformer block's attention or its
feed-forward, one resnet. A block shards only if every split leaf in it
divides and its heads (or GroupNorm groups, for a resnet: ``block1``'s
GroupNorm then normalises groups/tp groups per rank) divide too; otherwise
it is replicated and runs with no collective.
"""
from __future__ import annotations

import re
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
    missing entries replicated; a list's items are keyed by their index."""
    if isinstance(params, (dict, list)):
        items = params.items() if isinstance(params, dict) else enumerate(params)

        def sub_spec(key):
            if isinstance(specs, dict):
                return specs.get(key)
            return specs[key] if isinstance(specs, list) and key < len(specs) else None

        return {k: v for key, sub in items
                for k, v in _match_tree(sub, sub_spec(key), f"{path}{key}/").items()}
    return {path[:-1]: specs if isinstance(specs, int) else None}


def param_split_dims(params: Dict) -> Dict[str, Optional[int]]:
    """{"backbone/layers/wq": 1, …, "text_emb": None, …}: every leaf's
    split dim by its path."""
    return _match_tree(params, t3_param_specs())


def _map_leaves(params, fn, path=""):
    if isinstance(params, dict):
        return {k: _map_leaves(v, fn, f"{path}{k}/") for k, v in params.items()}
    if isinstance(params, list):
        return [_map_leaves(v, fn, f"{path}{i}/") for i, v in enumerate(params)]
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


def _narrow(params: Dict, dims: Dict[str, Optional[int]], tp: int, t: int) -> Dict:
    """Shard ``t`` of ``tp`` of every split leaf (contiguous); replicated
    leaves as they are."""
    def leaf(path, x):
        dim = dims[path]
        if dim is None or tp == 1:
            return x
        n = x.shape[dim]
        if n % tp:
            raise ValueError(f"{path}: dim {dim} of {tuple(x.shape)} does not split over tp={tp}")
        return x.narrow(dim, t * (n // tp), n // tp).contiguous()

    return _map_leaves(params, leaf)


def _gather(params: Dict, dims: Dict[str, Optional[int]],
            group: Optional[dist.ProcessGroup]) -> Dict:
    """The full tree back from every rank's shards (a collective over
    ``group``): each shard is written at its offset in zeros and the group
    sums them, which is exact. Leaves come back detached."""
    tp, t = (1, 0) if group is None else (group.size(), group.rank())

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


def shard_t3_params(params: Dict, cfg: T3Config, tp: int, t: int) -> Dict:
    """Shard ``t`` of ``tp`` of a full T3 tree (``check_tp`` first)."""
    check_tp(cfg, tp)
    return _narrow(params, param_split_dims(params), tp, t)


def shard_params(params: Dict, mesh: DeviceMesh, cfg: T3Config) -> Dict:
    """This rank's shard of a full T3 tree (every rank holds the same full
    tree): split leaves narrowed to shard ``t`` of ``tp``, contiguous;
    replicated leaves as they are."""
    return shard_t3_params(params, cfg, mesh[AXES.tp].size(), mesh.get_local_rank(AXES.tp))


def unshard_params(params: Dict, mesh: DeviceMesh) -> Dict:
    """The full tree back from every rank's shards (a collective: every
    rank calls it and every rank gets the full tree, detached). Each shard
    is written at its offset in zeros and the tp group sums them, which is
    exact."""
    return _gather(params, param_split_dims(params), tp_group(mesh))


# ------------------------------------------------------------- S3Gen-ref
OUT, IN = 0, 1   # the split dims of a linear [out, in] or a conv [Cout, Cin, k]
# block1's GroupNorm groups (decoder._group_norm's default)
GN_GROUPS = 8


def _conformer_specs() -> Dict:
    col = {"w": OUT, "b": OUT}
    return {"attn": {"q": col, "k": col, "v": col, "out": {"w": IN, "b": None},
                     "pos": {"w": OUT}, "bias_u": OUT, "bias_v": OUT},
            "ff": {"w1": col, "w2": {"w": IN, "b": None}}}


def _tf_specs() -> Dict:
    return {"to_q": {"w": OUT}, "to_k": {"w": OUT}, "to_v": {"w": OUT},
            "to_out": {"w": IN, "b": None},
            "ff1": {"w": OUT, "b": OUT}, "ff2": {"w": IN, "b": None}}


def _resnet_specs() -> Dict:
    return {"mlp": {"w": OUT, "b": OUT}, "block1": {"conv": {"w": OUT, "b": OUT}},
            "block2": {"conv": {"w": IN, "b": None}}}


def s3gen_ref_param_specs(cfg) -> Dict:
    """The split dim of each S3Gen-ref leaf that the rules split (``None``
    or absent: replicated), in the structure of ``init_s3gen_ref_params``
    and the port's layout; the JAX package's ``s3gen_ref_param_specs``
    transposed."""
    fl = cfg.flow

    def level():
        return {"resnet": _resnet_specs(), "tf": [_tf_specs() for _ in range(fl.dec_n_blocks)]}

    return {"flow": {
        "encoder": {"blocks": [_conformer_specs() for _ in range(fl.num_blocks)],
                    "up_blocks": [_conformer_specs() for _ in range(fl.num_up_blocks)]},
        "estimator": {"down": level(), "mid": [level() for _ in range(fl.dec_num_mid_blocks)],
                      "up": level()},
    }}


# The blocks a rank's forward shards whole: a leaf's block is the first
# pattern its path matches, and the block shards where every count the
# config gives it divides by tp (its split dims, and its heads or groups).
S3GEN_BLOCKS = (
    ("conformer attention", re.compile(r"^flow/encoder/(up_)?blocks/\d+/attn/"),
     lambda fl: (fl.input_size, fl.attention_heads)),
    ("conformer feed-forward", re.compile(r"^flow/encoder/(up_)?blocks/\d+/ff/"),
     lambda fl: (fl.linear_units,)),
    ("estimator attention", re.compile(r"^flow/estimator/.*/tf/\d+/to_"),
     lambda fl: (fl.dec_num_heads * fl.dec_attention_head_dim, fl.dec_num_heads)),
    ("estimator feed-forward", re.compile(r"^flow/estimator/.*/tf/\d+/ff"),
     lambda fl: (4 * fl.dec_channels[0],)),
    ("resnet", re.compile(r"^flow/estimator/.*/resnet/"),
     lambda fl: (fl.dec_channels[0], GN_GROUPS)),
)


def s3gen_ref_block_shards(cfg, tp: int) -> Dict[str, bool]:
    """{block kind: whether its blocks shard at ``tp``} (``S3GEN_BLOCKS``)."""
    return {kind: all(n % tp == 0 for n in counts(cfg.flow)) for kind, _, counts in S3GEN_BLOCKS}


def s3gen_ref_split_dims(params: Dict, cfg, tp: int) -> Dict[str, Optional[int]]:
    """{path: split dim} of every S3Gen-ref leaf at ``tp``: the rules'
    dims, replicated (None) in every block that does not shard whole."""
    shards = s3gen_ref_block_shards(cfg, tp)

    def block_shards(path: str) -> bool:
        return next((shards[kind] for kind, pattern, _ in S3GEN_BLOCKS if pattern.match(path)),
                    False)

    return {path: dim if dim is not None and block_shards(path) else None
            for path, dim in _match_tree(params, s3gen_ref_param_specs(cfg)).items()}


def shard_s3gen_ref_params(params: Dict, cfg, tp: int, t: int) -> Dict:
    """Shard ``t`` of ``tp`` of a full S3Gen-ref tree (the blocks that do
    not divide stay whole)."""
    return _narrow(params, s3gen_ref_split_dims(params, cfg, tp), tp, t)


def unshard_s3gen_ref_params(params: Dict, cfg, group: Optional[dist.ProcessGroup]) -> Dict:
    """``shard_s3gen_ref_params``' inverse over ``group`` (a collective:
    every rank gets the full tree, detached)."""
    tp = 1 if group is None else group.size()
    return _gather(params, s3gen_ref_split_dims(params, cfg, tp), group)


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
