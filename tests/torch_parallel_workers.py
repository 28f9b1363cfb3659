"""Rank functions for tests/test_torch_parallel.py, run by
``chatterbox_tpu_torch.parallel.launch`` in spawned processes. This module
imports no JAX, so a rank's process starts with torch and the port alone;
data crosses as numpy arrays."""
from __future__ import annotations

import numpy as np
import torch

from chatterbox_tpu_torch import parallel
from chatterbox_tpu_torch.models.t3 import model as tm
from chatterbox_tpu_torch.parallel import (AXES, make_mesh, shard_batch, shard_params, tp,
                                           tp_group, unshard_params)
from chatterbox_tpu_torch.parallel.sharding import _map_leaves
from chatterbox_tpu_torch.training import adamw, make_train_step


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def forward_and_step(rank, cfg, params, batch, dp: int, tp_size: int, lr: float) -> dict:
    """On a (dp, tp) mesh: the rank's ``t3_forward_train`` logits for its dp
    rows; then one adamw step from ``params`` on ``batch`` (recomputation
    on) → the loss, the gradient norm, the full gradients and the full
    parameters after the step (``unshard_params``), and the collectives
    the step issued."""
    torch.set_num_threads(1)
    mesh = make_mesh(dp, tp_size, rank.devices)
    full, batch = _tensors(params), _tensors(batch)
    local, rows = shard_params(full, mesh, cfg), shard_batch(batch, mesh)
    with torch.no_grad():
        cond = tm.cond_embeddings(local, cfg, rows["speaker_emb"], rows["prompt_tokens"],
                                  rows["emotion"])
        logits = tm.t3_forward_train(local, cfg, cond, rows["text_tokens"],
                                     rows["speech_tokens"], remat=False,
                                     tp_group=tp_group(mesh))
    init, step = make_train_step(cfg, adamw(lr), mesh=mesh)
    state = init(full)
    tp.reset_collectives()
    state, m = step(state, batch)
    collectives = tp.read_collectives()
    grads = unshard_params(_map_leaves(state["params"], lambda path, p: p.grad), mesh)
    return {"logits": logits.numpy(), "dp_index": mesh.get_local_rank(AXES.dp),
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": _numpy(grads), "params": _numpy(unshard_params(state["params"], mesh)),
            "collectives": collectives}


def decode(rank, cfg, params, inputs: dict, tp_size: int, n_steps: int,
           dtype=torch.float32) -> dict:
    """A tensor-parallel prefill and one ``n_steps`` decode slice (weights in
    ``dtype``, the cache in ``cfg.kv_cache_dtype``) → the tokens, the
    cache's kv heads and the slice's all-reduces."""
    torch.set_num_threads(1)
    mesh = make_mesh(1, tp_size, rank.devices)
    local = shard_params(_map_leaves(_tensors(params), lambda path, x: x.to(dtype)), mesh, cfg)
    x = _tensors(inputs)
    with torch.inference_mode():
        cond = tm.cond_embeddings(local, cfg, x["speaker_emb"], x["prompt_tokens"], x["emotion"])
        cache = tm.t3_prefill(local, cfg, cond, x["text_tokens"], x["text_len"],
                              tp_group=tp_group(mesh))
        state = tm.make_decode_state(cfg, inputs["seeds"], 0.8, 0.95, 0.5, 1.2, "cpu")
        tp.reset_collectives()
        tokens = tm.t3_decode_slice(local, cfg, cache, state, n_steps, tp_group=tp_group(mesh))
    return {"tokens": tokens.numpy(), "kv_heads": cache["k"].shape[2],
            "k_dtype": str(cache["k"].dtype), "collectives": tp.read_collectives()}


def mesh_shapes(rank):
    """The shapes make_mesh gives on 4 ranks, and its ValueError."""
    shapes = {"dp2_tp2": parallel.make_mesh(dp=2, tp=2).shape,
              "default": parallel.make_mesh().shape,
              "dp4": parallel.make_mesh(dp=4).shape}
    try:
        parallel.make_mesh(dp=3, tp=3)
    except ValueError as e:
        shapes["dp3_tp3"] = str(e)
    mesh = parallel.make_mesh(dp=2, tp=2)
    shapes["coords"] = (mesh.get_local_rank("dp"), mesh.get_local_rank("tp"))
    return shapes


def fail_on_rank_1(rank):
    if rank.rank == 1:
        raise RuntimeError("rank one fails")
    torch.distributed.barrier()   # rank 0 would wait here for ever
    return rank.rank
