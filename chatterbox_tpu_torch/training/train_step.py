"""T3 training step, teacher-forced speech-token cross entropy (torch
counterpart of ``chatterbox_tpu/training/train_step.py``).

The state holds trainable copies of the T3 tree's leaves and a torch
optimizer over them. ``adamw`` and ``adam`` build optimizers with optax's
update rules and defaults, so a step here takes the parameters where
``optax.adamw`` / ``optax.adam`` take them.

Over a (dp, tp) mesh (``parallel/``, one process per rank) the step is the
single-device step computed in parts: each rank holds its tensor-parallel
shard of T3 and the dp share of each batch's rows; the loss divides by the
whole batch's target count (numerator and count summed over dp, as the JAX
loss divides by ``speech_mask.sum()`` of the whole batch, not a mean of
per-replica means), the gradients are summed over dp, and the gradient norm
counts every element of the logical tree once.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..convert import _walk
from ..models.t3.config import T3Config
from ..models.t3.model import cond_embeddings, t3_forward_train
from ..parallel.sharding import (dp_group, param_split_dims, shard_batch, shard_params,
                                 tp_group)

# a factory over the trainable leaves → the optimizer that updates them
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def t3_nll_sum(params: Dict, cfg: T3Config, batch: Dict, remat: bool = True,
               tp_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the masked negative log-likelihood summed over the batch's target
    tokens, their count): ``t3_loss``'s numerator and denominator."""
    cond = cond_embeddings(params, cfg, batch["speaker_emb"], batch["prompt_tokens"],
                           batch["emotion"])
    logits = t3_forward_train(params, cfg, cond, batch["text_tokens"], batch["speech_tokens"],
                              text_len=batch.get("text_len"), remat=remat, tp_group=tp_group)
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, batch["speech_tokens"].long()[..., None])[..., 0]
    mask = batch["speech_mask"].float()
    return -(ll * mask).sum(), mask.sum()


def t3_loss(params: Dict, cfg: T3Config, batch: Dict, remat: bool = True) -> torch.Tensor:
    """Masked CE over speech tokens. batch: speaker_emb [B, spk],
    prompt_tokens [B, P], emotion [B], text_tokens [B, T], text_len [B]
    (optional), speech_tokens [B, S], speech_mask [B, S]. ``remat`` as in
    ``t3_forward_train`` (on, as in JAX; off to measure what it saves)."""
    nll, count = t3_nll_sum(params, cfg, batch, remat)
    return nll / count.clamp_min(1.0)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every element of every tensor, in float32
    (``optax.global_norm``)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerFactory:
    """``optax.adamw`` with its defaults (weight decay 1e-4, where torch's
    AdamW defaults to 1e-2), decaying every leaf in one group as optax does
    with no mask: the update is ``-lr·(m̂/(√v̂+eps) + wd·p)``, which torch's
    ``p·(1-lr·wd)`` then Adam step equals in exact arithmetic."""
    return lambda leaves: torch.optim.AdamW(leaves, lr=lr, betas=(b1, b2), eps=eps,
                                            weight_decay=weight_decay)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> OptimizerFactory:
    """``optax.adam`` with its defaults: no weight decay."""
    return lambda leaves: torch.optim.Adam(leaves, lr=lr, betas=(b1, b2), eps=eps)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place (as it is with no group)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _sum_grads_over(grads: List[torch.Tensor], group) -> None:
    """Sum the gradients over ``group`` in place, as one flat buffer."""
    if group is None:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_train_step(cfg: T3Config, optimizer: OptimizerFactory, remat: bool = True,
                    mesh=None):
    """→ (init_state, train_step). ``init_state(params)`` copies the T3 tree
    into trainable leaves and builds ``optimizer`` over them;
    ``train_step(state, batch)`` → (state, {"loss", "grad_norm"}), the
    gradient's norm taken before the update. ``remat``: ``t3_loss``'s.

    ``mesh`` (a ``parallel.make_mesh`` DeviceMesh; every rank calls both
    functions with the same arguments): ``init_state`` takes the full tree
    and keeps this rank's shard (``parallel.shard_params``), and
    ``train_step`` takes the whole batch and trains on this rank's dp rows.
    Loss and gradient norm are the whole batch's on every rank."""
    tp_g = dp_g = None
    if mesh is not None:
        tp_g, dp_g = tp_group(mesh), dp_group(mesh)

    def init_state(params: Dict) -> Dict:
        if mesh is not None:
            params = shard_params(params, mesh, cfg)
        # the engine's parameters are inference tensors, which autograd
        # cannot use: train ordinary copies
        with torch.inference_mode(False):
            trained = _walk(params, lambda x, key, parents: x.detach().clone().requires_grad_(True))
        leaves = _leaves(trained)
        # the leaves tp splits (their squares are summed over tp for the norm)
        split = [d is not None for d in param_split_dims(trained).values()]
        return {"params": trained, "leaves": leaves, "split": split,
                "optimizer": optimizer(leaves), "step": 0}

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        leaves = state["leaves"]
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        with torch.inference_mode(False):
            with torch.enable_grad():
                for p in leaves:
                    p.grad = None
                nll, count = t3_nll_sum(state["params"], cfg, batch, remat, tp_g)
                count = _sum_over(count.detach(), dp_g).clamp_min(1.0)
                (nll / count).backward()
            # a leaf outside the loss (text_head) gets a zero gradient, as in
            # JAX: the optimizer then still decays it and moves its moments
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in leaves]
            _sum_grads_over(grads, dp_g)
            loss = _sum_over(nll.detach(), dp_g) / count
            if tp_g is None:
                gnorm = global_norm(grads)
            else:
                # a split leaf's squares summed over tp, a replicated one's once
                sq = [g.float().square().sum() for g in grads]
                split = torch.stack([q for q, s in zip(sq, state["split"]) if s]).sum()
                whole = torch.stack([q for q, s in zip(sq, state["split"]) if not s]).sum()
                gnorm = (_sum_over(split, tp_g) + whole).sqrt()
            state["optimizer"].step()
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return init_state, train_step
