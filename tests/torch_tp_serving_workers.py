"""Rank functions for tests/test_torch_tp_serving.py, run by
``chatterbox_tpu_torch.parallel.launch`` in spawned processes. This module
imports no JAX, so a rank's process starts with torch and the port alone;
data crosses as numpy arrays."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from chatterbox_tpu_torch import parallel
from chatterbox_tpu_torch.models.s3gen_ref import model as tmodel


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def s3gen_calls(rank, cfg, params, ref, tokens, noise, prompt_noise, stream_noise, slices,
                tail_len: int, window: int) -> dict:
    """S3Gen-ref's serving calls on this rank's shard at tp = world size
    (no group at world size 1): the uncached and the prompt-cached chunk
    inference, the prompt prefill, and a chunk streamed in ``slices`` (new
    token counts) → every rank's outputs, the K/V its prompt cache and its
    last streaming ring hold, its shard's sizes, and whether
    ``unshard_s3gen_ref_params`` gives back every leaf."""
    tp = rank.world_size
    group = None
    if tp > 1:
        torch.set_num_threads(1)
        group = dist.group.WORLD
    full = _tensors(params)
    p = parallel.shard_s3gen_ref_params(full, cfg, tp, rank.rank)
    ref, tokens = _tensors(ref), _tensors(tokens)
    noise, prompt_noise = _tensors(noise), _tensors(prompt_noise)
    stream_noise = _tensors(stream_noise)
    B, T = tokens.shape
    spt = cfg.samples_per_token
    src, clen = torch.zeros((B, T * spt)), torch.zeros((B,), dtype=torch.long)
    tlen = torch.full((B,), T)
    out = {}
    with torch.inference_mode():
        out["wav"], out["src"] = (x.numpy() for x in tmodel.s3gen_ref_inference(
            p, cfg, tokens, tlen, ref, src, clen, noise, tp_group=group))
        cache = tmodel.s3gen_ref_prompt_prefill(p, cfg, ref, prompt_noise, tp_group=group)
        out["cache_k"] = cache["est"]["k"].numpy()
        out["cached_wav"], _ = (x.numpy() for x in tmodel.s3gen_ref_inference(
            p, cfg, tokens, tlen, ref, src, clen, noise, cfm_cache=cache, tp_group=group))
        state = tmodel.init_s3gen_stream_state(cfg, cache, window, T)
        total, tails = 0, []
        for n in slices:
            total += n
            start = torch.tensor([min((total - n) * spt, T * spt - tail_len)])
            tail, src, state = tmodel.s3gen_ref_inference_streaming(
                p, cfg, tokens, torch.tensor([total]), torch.tensor([n]), ref, src,
                torch.tensor([(total - n) * spt]), stream_noise, start, tail_len, state, max(slices),
                cache, tp_group=group)
            tails.append(tail.numpy())
        out["stream_tails"] = np.stack(tails)
        out["stream_mel"] = state["mel"].numpy()
        out["ring_k"] = state["cfm"]["k"].numpy()
    gathered = parallel.sharding._map_leaves(
        parallel.unshard_s3gen_ref_params(p, cfg, group), lambda path, x: x)
    flat_full = {}
    parallel.sharding._map_leaves(full, lambda path, x: flat_full.setdefault(path, x))
    out["unsharded_equal"] = {}
    parallel.sharding._map_leaves(gathered, lambda path, x: out["unsharded_equal"].setdefault(
        path, bool(torch.equal(x, flat_full[path]))))
    est = p["flow"]["estimator"]["down"]
    out["shapes"] = {"to_q": tuple(est["tf"][0]["to_q"]["w"].shape),
                     "block2": tuple(est["resnet"]["block2"]["conv"]["w"].shape),
                     "q": tuple(p["flow"]["encoder"]["blocks"][0]["attn"]["q"]["w"].shape)}
    return out
