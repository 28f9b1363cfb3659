"""T3 training in the port against the JAX package, on the CPU in float32.

The T3 config is tests/test_parallel_training.py's; both sides start from
the JAX init (``init_t3_params``), bridged by ``convert.convert_params``, and
take the same batch, drawn from a seed with numpy (ragged text and speech).
Held: ``t3_forward_train``'s logits with and without ``text_len``;
``t3_loss`` and every gradient leaf, the JAX gradients carried into the
port's layouts by the same bridge (a pure permutation); recomputation
against none (JAX's own remat test, ported); three optimizer steps against
``optax.adamw`` / ``optax.adam`` (loss, gradient norm and every parameter
after each step, ``text_head`` included, which takes no part in the loss
and is only decayed); the loss falling over 5 steps; and serving's prefill
untouched by the new keywords.
"""
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tree_to_np, to_np

import jax
import optax

from chatterbox_tpu.models.t3 import T3Config as JT3Config
from chatterbox_tpu.models.t3 import init_t3_params as jinit_t3
from chatterbox_tpu.models.t3 import model as jm
from chatterbox_tpu.training import make_train_step as jmake_train_step
from chatterbox_tpu.training import t3_loss as jt3_loss
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.models.t3 import model as tm
from chatterbox_tpu_torch.models.t3.config import T3Config
from chatterbox_tpu_torch.training import adam, adamw, make_train_step, t3_loss
from chatterbox_tpu_torch.training.train_step import global_norm

WIDTHS = dict(hidden_size=128, num_heads=8, num_kv_heads=8, head_dim=16,
              intermediate_size=256, max_text_tokens=16, max_speech_tokens=32)
JCFG = JT3Config.tiny().with_(**WIDTHS)
CFG = T3Config.tiny().with_(**WIDTHS)
B, T, S = 4, 8, 16
# float32 on both sides, which differ in summation order only: logits and
# the loss agree to ~1e-6 relative. Each gradient (and Adam moment) leaf is
# held within GRAD_REL of its largest magnitude plus GRAD_FLOOR of the
# largest gradient in the tree: some gradients are zero in exact arithmetic
# and rounding noise on each side (the perceiver's key bias shifts every
# score of a row alike, so the softmax cancels it: ~1e-9 here).
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-6
# Adam normalises each element's step to about lr, so an element whose
# gradient is small against its leaf's largest carries a larger relative
# error into its step (measured: 0.046 lr at most, in w_up, over three
# steps); after each step every parameter is held within PARAM_LR_MULT · lr
# of JAX's. An element whose gradient was rounding noise (below GRAD_FLOOR
# of the tree's largest) at a step may step either way on either side: each
# such step adds NOISE_STEP_LR_MULT · lr to its bound (|m̂/√v̂| ≤ 1.004 over
# three steps at optax's betas, twice for the two sides).
LR = 1e-3
PARAM_LR_MULT = 0.1
NOISE_STEP_LR_MULT = 2.01


def _batch(seed: int, text_len: bool = True):
    """Inputs as the batcher gives them: int32 tokens, float32 rest."""
    rng = np.random.default_rng(seed)
    t_len = rng.integers(3, T + 1, B).astype(np.int32)
    text = rng.integers(1, CFG.text_vocab_size, (B, T)).astype(np.int32)
    text[np.arange(T)[None, :] >= t_len[:, None]] = 0
    s_len = rng.integers(4, S + 1, B)
    speech = rng.integers(0, CFG.num_speech_codes, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < s_len[:, None]).astype(np.float32)
    speech[mask == 0] = 0
    batch = {
        "speaker_emb": rng.standard_normal((B, CFG.speaker_embed_dim)).astype(np.float32),
        "prompt_tokens": rng.integers(0, CFG.num_speech_codes,
                                      (B, CFG.speech_cond_prompt_len)).astype(np.int32),
        "emotion": np.full((B,), 0.5, np.float32),
        "text_tokens": text,
        "speech_tokens": speech,
        "speech_mask": mask,
    }
    if text_len:
        batch["text_len"] = t_len
    return batch


def _zeros_batch():
    """tests/test_parallel_training.py's batch."""
    return {
        "speaker_emb": np.zeros((B, CFG.speaker_embed_dim), np.float32),
        "prompt_tokens": np.zeros((B, CFG.speech_cond_prompt_len), np.int32),
        "emotion": np.full((B,), 0.5, np.float32),
        "text_tokens": np.zeros((B, T), np.int32),
        "speech_tokens": np.ones((B, S), np.int32),
        "speech_mask": np.ones((B, S), np.float32),
    }


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _assert_leaves_close(port, want, atol_of):
    """Every leaf of the port's tree against ``want`` (the port's layout),
    within ``atol_of(want_leaf)``."""
    port, want = _flat(port), _flat(want)
    assert port.keys() == want.keys()
    for k, w in want.items():
        w = to_np(w).astype(np.float64)
        np.testing.assert_allclose(to_np(port[k]), w, rtol=0, atol=atol_of(w), err_msg=k)


def _grad_atol(tree):
    """GRAD_REL of each leaf's largest magnitude, plus GRAD_FLOOR of the
    tree's largest."""
    top = max(np.abs(to_np(x)).max() for x in _flat(tree).values())
    return lambda w: GRAD_REL * np.abs(w).max() + GRAD_FLOOR * top


@pytest.fixture(scope="module")
def jparams():
    """The JAX init as numpy leaves."""
    return jax_tree_to_np(jinit_t3(jax.random.PRNGKey(0), JCFG))


def _port(jp):
    return convert_params(jp, "cpu")


_jvalue_and_grad = jax.jit(jax.value_and_grad(lambda p, b: jt3_loss(p, JCFG, b)))


def _jforward(jp, batch):
    def fwd(p, b):
        cond = jm.cond_embeddings(p, JCFG, b["speaker_emb"], b["prompt_tokens"], b["emotion"])
        return jm.t3_forward_train(p, JCFG, cond, b["text_tokens"], b["speech_tokens"],
                                   text_len=b.get("text_len"))

    return np.asarray(jax.jit(fwd)(jp, batch))


@pytest.mark.parametrize("with_text_len", [True, False])
def test_forward_train_logits(jparams, with_text_len):
    batch = _batch(1, text_len=with_text_len)
    want = _jforward(jparams, batch)
    p, b = _port(jparams), _t(batch)
    cond = tm.cond_embeddings(p, CFG, b["speaker_emb"], b["prompt_tokens"], b["emotion"])
    got = tm.t3_forward_train(p, CFG, cond, b["text_tokens"], b["speech_tokens"],
                              text_len=b.get("text_len"))
    assert got.dtype == torch.float32 and got.shape == (B, S, CFG.speech_vocab_size)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=LOGIT_TOL)


def _port_value_and_grad(p, batch, remat=True):
    for x in _flat(p).values():
        x.requires_grad_(True)
    loss = t3_loss(p, CFG, batch, remat=remat)
    loss.backward()
    grads = {k: (x.grad if x.grad is not None else torch.zeros_like(x))
             for k, x in _flat(p).items()}
    return loss.detach(), grads


def test_loss_and_grads(jparams):
    batch = _batch(2)
    jl, jg = _jvalue_and_grad(jparams, batch)
    loss, grads = _port_value_and_grad(_port(jparams), _t(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    want = convert_params(jax_tree_to_np(jg), "cpu")
    _assert_leaves_close(grads, _flat(want), _grad_atol(want))
    # text_head takes no part in the loss: its gradient is zero on both sides
    assert not np.abs(to_np(want["text_head"]["w"])).any()
    assert float(global_norm(list(grads.values()))) == pytest.approx(
        float(optax.global_norm(jg)), rel=LOSS_RTOL)


def test_remat_forward_and_grads_match(jparams):
    """The port's counterpart of tests/test_parallel_training.py's remat
    test: recomputation changes neither the loss nor any gradient."""
    batch = _t(_batch(3))
    l0, g0 = _port_value_and_grad(_port(jparams), batch, remat=False)
    l1, g1 = _port_value_and_grad(_port(jparams), batch, remat=True)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    assert g0.keys() == g1.keys()
    for k in g0:
        np.testing.assert_allclose(to_np(g0[k]), to_np(g1[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    # and every layer's weights got a gradient through the checkpointed layer
    for k in ("backbone/layers/wq", "backbone/layers/w_down", "backbone/layers/attn_norm"):
        assert np.abs(to_np(g1[k])).min(axis=tuple(range(1, g1[k].dim()))).all(), k


OPTIMIZERS = {
    "adamw": (lambda: adamw(LR), lambda: optax.adamw(LR)),
    # a decay large enough that text_head's decay-only path shows plainly
    "adamw_wd0.1": (lambda: adamw(LR, weight_decay=0.1), lambda: optax.adamw(LR, weight_decay=0.1)),
    "adam": (lambda: adam(LR), lambda: optax.adam(LR)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_steps_match_optax(jparams, name):
    port_opt, jax_opt = OPTIMIZERS[name]
    jinit, jstep = jmake_train_step(JCFG, jax_opt())
    jstate, jstep = jinit(jparams), jax.jit(jstep)
    init, step = make_train_step(CFG, port_opt())
    with torch.inference_mode():   # as the engine hands them over
        state = init(_port(jparams))
    head0 = state["params"]["text_head"]["w"].detach().clone()
    noise_steps = None
    for i in range(3):
        batch = _batch(10 + i)
        grads = convert_params(jax_tree_to_np(_jvalue_and_grad(jstate["params"], batch)[1]), "cpu")
        jstate, jm_ = jstep(jstate, batch)
        state, m = step(state, _t(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm_["grad_norm"]), rtol=LOSS_RTOL)
        got = _flat(state["params"])
        assert len(state["leaves"]) == len(got)
        _assert_leaves_close({k: x.grad for k, x in got.items()}, _flat(grads), _grad_atol(grads))
        adam_state = jstate["opt_state"][0]
        for slot, moment in (("exp_avg", adam_state.mu), ("exp_avg_sq", adam_state.nu)):
            want = convert_params(jax_tree_to_np(moment), "cpu")
            port = {k: state["optimizer"].state[x][slot] for k, x in got.items()}
            _assert_leaves_close(port, _flat(want), _grad_atol(want))
        top = max(float(g.abs().max()) for g in _flat(grads).values())
        noise = {k: (g.abs() < GRAD_FLOOR * top).numpy() for k, g in _flat(grads).items()}
        noise_steps = noise if noise_steps is None else {
            k: noise_steps[k] + noise[k] for k in noise}
        want = _flat(convert_params(jax_tree_to_np(jstate["params"]), "cpu"))
        for k, w in want.items():
            atol = LR * (PARAM_LR_MULT + NOISE_STEP_LR_MULT * noise_steps[k])
            err = np.abs(to_np(got[k]).astype(np.float64) - to_np(w))
            assert (err <= atol).all(), (k, float((err / atol).max()))
    assert state["step"] == int(jstate["step"]) == 3
    head = state["params"]["text_head"]["w"].detach()
    want_head = convert_params(jax_tree_to_np(jstate["params"]["text_head"]), "cpu")["w"]
    if name == "adam":
        assert torch.equal(head, head0)
    else:   # decay only: p · (1 - lr·wd)^3, to float32 rounding
        wd = 0.1 if name == "adamw_wd0.1" else 1e-4
        np.testing.assert_allclose(to_np(head), to_np(head0) * (1 - LR * wd) ** 3,
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(to_np(head), to_np(want_head), rtol=1e-6, atol=1e-12)
        assert not torch.equal(head, head0)


def test_train_step_decreases_loss(jparams):
    """tests/test_parallel_training.py's loss-falls test, ported."""
    init, step = make_train_step(CFG, adam(1e-3))
    state, batch = init(_port(jparams)), _t(_zeros_batch())
    losses = []
    for _ in range(5):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_prefill_unchanged_by_training_keywords(jparams):
    """Serving's prefill: ``t3_prefill_raw`` against JAX's, and the
    backbone's defaults bitwise equal to collect_kv/remat spelled out;
    collect_kv=False and remat=True leave the hidden state bitwise equal."""
    p, batch = _port(jparams), _batch(4)
    b = _t(batch)
    cond = tm.cond_embeddings(p, CFG, b["speaker_emb"], b["prompt_tokens"], b["emotion"])
    k, v, pad = tm.t3_prefill_raw(p, CFG, cond, b["text_tokens"], b["text_len"])
    jcond = jm.cond_embeddings(jparams, JCFG, batch["speaker_emb"], batch["prompt_tokens"],
                               batch["emotion"])
    jk, jv, jpad = jax.jit(jm.t3_prefill_raw, static_argnums=1)(
        jparams, JCFG, jcond, batch["text_tokens"], batch["text_len"])
    np.testing.assert_array_equal(to_np(pad), np.asarray(jpad))
    np.testing.assert_allclose(to_np(k), np.asarray(jk), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(to_np(v), np.asarray(jv), rtol=0, atol=LOGIT_TOL)

    h, valid, _ = tm._left_pack_prefix(p, CFG, cond, b["text_tokens"], b["text_len"])
    base = tm._backbone_prefill(p, CFG, h, valid)
    spelled = tm._backbone_prefill(p, CFG, h, valid, collect_kv=True, remat=False)
    assert torch.equal(base[1], k) and torch.equal(base[2], v)
    for x, y in zip(base, spelled):
        assert torch.equal(x, y)
    for kw in (dict(collect_kv=False), dict(collect_kv=False, remat=True), dict(remat=True)):
        out = tm._backbone_prefill(p, CFG, h, valid, **kw)
        assert torch.equal(out[0], base[0]), kw
        if kw.get("collect_kv", True):
            assert torch.equal(out[1], base[1]) and torch.equal(out[2], base[2])
        else:
            assert out[1] is None and out[2] is None
