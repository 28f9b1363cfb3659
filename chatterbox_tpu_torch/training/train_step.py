"""T3 training step, teacher-forced speech-token cross entropy (torch
counterpart of ``chatterbox_tpu/training/train_step.py``).

The state holds trainable copies of the T3 tree's leaves and a torch
optimizer over them. ``adamw`` and ``adam`` build optimizers with optax's
update rules and defaults, so a step here takes the parameters where
``optax.adamw`` / ``optax.adam`` take them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..convert import _walk
from ..models.t3.config import T3Config
from ..models.t3.model import cond_embeddings, t3_forward_train

# a factory over the trainable leaves → the optimizer that updates them
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def t3_loss(params: Dict, cfg: T3Config, batch: Dict, remat: bool = True) -> torch.Tensor:
    """Masked CE over speech tokens. batch: speaker_emb [B, spk],
    prompt_tokens [B, P], emotion [B], text_tokens [B, T], text_len [B]
    (optional), speech_tokens [B, S], speech_mask [B, S]. ``remat`` as in
    ``t3_forward_train`` (on, as in JAX; off to measure what it saves)."""
    cond = cond_embeddings(params, cfg, batch["speaker_emb"], batch["prompt_tokens"],
                           batch["emotion"])
    logits = t3_forward_train(params, cfg, cond, batch["text_tokens"], batch["speech_tokens"],
                              text_len=batch.get("text_len"), remat=remat)
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, batch["speech_tokens"].long()[..., None])[..., 0]
    mask = batch["speech_mask"].float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


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


def make_train_step(cfg: T3Config, optimizer: OptimizerFactory, remat: bool = True):
    """→ (init_state, train_step). ``init_state(params)`` copies the T3 tree
    into trainable leaves and builds ``optimizer`` over them;
    ``train_step(state, batch)`` → (state, {"loss", "grad_norm"}), the
    gradient's norm taken before the update. ``remat``: ``t3_loss``'s."""

    def init_state(params: Dict) -> Dict:
        # the engine's parameters are inference tensors, which autograd
        # cannot use: train ordinary copies
        with torch.inference_mode(False):
            trained = _walk(params, lambda x, key, parents: x.detach().clone().requires_grad_(True))
        leaves = _leaves(trained)
        return {"params": trained, "leaves": leaves, "optimizer": optimizer(leaves), "step": 0}

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        leaves = state["leaves"]
        with torch.inference_mode(False):
            with torch.enable_grad():
                for p in leaves:
                    p.grad = None
                loss = t3_loss(state["params"], cfg, batch, remat=remat)
                loss.backward()
            # a leaf outside the loss (text_head) gets a zero gradient, as in
            # JAX: the optimizer then still decays it and moves its moments
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            gnorm = global_norm([p.grad for p in leaves])
            state["optimizer"].step()
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return init_state, train_step
