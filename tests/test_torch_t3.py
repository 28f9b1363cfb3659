"""T3 parity: chatterbox_tpu_torch.models.t3 against chatterbox_tpu.models.t3.

Both packages get the same parameters (the JAX init, converted by
chatterbox_tpu_torch.convert) and the same inputs. The JAX side decodes on
the paired cache layout, so its attention runs the Pallas decode kernel K1
(interpret mode off the TPU); the port runs its K1 wrapper, which on CPU
tensors is the plain version. Everything is float32.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_helpers import jax_tree_to_np, to_np, to_t

from chatterbox_tpu.models.t3 import model as jm
from chatterbox_tpu.models.t3.config import T3Config as JT3Config
from chatterbox_tpu.ops import sampling as jsampling
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.models.t3 import model as tm
from chatterbox_tpu_torch.models.t3.config import T3Config
from chatterbox_tpu_torch.ops import sampling as tsampling

# float32 end to end; the two sides differ only in summation order, so
# activations agree to ~1e-6 relative and 1e-4 absolute is a loose bound
ACT_TOL = 1e-4
SLICE = 6


def _jit(fn):
    """jit with the config (argument 1) static: one compile instead of many
    eager op dispatches keeps the JAX side fast."""
    return jax.jit(fn, static_argnums=(1,))


@pytest.fixture(scope="module")
def setup():
    jcfg = JT3Config.tiny()
    jparams = jm.init_t3_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert_params(jax_tree_to_np(jparams), "cpu")
    rng = np.random.default_rng(0)
    spk = rng.standard_normal((1, jcfg.speaker_embed_dim)).astype(np.float32)
    prompt = rng.integers(0, jcfg.num_speech_codes, (1, jcfg.speech_cond_prompt_len)).astype(np.int32)
    plen = np.array([4], np.int32)
    exag = np.array([0.5], np.float32)
    text = np.zeros((2, 8), np.int32)
    text[:, :5] = [255, 9, 10, 11, 0]
    tlen = np.full((2,), 5, np.int32)
    return jcfg, jparams, tparams, spk, prompt, plen, exag, text, tlen


def _lanes(setup):
    jcfg, jparams, tparams, spk, prompt, plen, exag, _, _ = setup
    j_cond = _jit(jm.cond_embeddings)(jparams, jcfg, jnp.asarray(spk), jnp.asarray(prompt),
                                jnp.asarray(exag), jnp.asarray(plen))
    j_unc = _jit(jm.cond_embeddings)(jparams, jcfg, jnp.zeros_like(spk), jnp.asarray(prompt),
                               jnp.zeros_like(exag), jnp.asarray(plen))
    t_cfg = T3Config.tiny()
    t_cond = tm.cond_embeddings(tparams, t_cfg, to_t(spk), to_t(prompt), to_t(exag), to_t(plen))
    t_unc = tm.cond_embeddings(tparams, t_cfg, torch.zeros(spk.shape), to_t(prompt),
                               torch.zeros(exag.shape), to_t(plen))
    return jnp.concatenate([j_cond, j_unc]), torch.cat([t_cond, t_unc])


def test_config_is_a_copy():
    assert T3Config().__dict__ == JT3Config().__dict__
    assert T3Config.tiny().__dict__ == JT3Config.tiny().__dict__


def test_cond_embeddings_match(setup):
    j_lanes, t_lanes = _lanes(setup)
    np.testing.assert_allclose(to_np(t_lanes), to_np(j_lanes), atol=ACT_TOL, rtol=ACT_TOL)


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_prefill_cache_matches(setup, kv):
    jcfg, jparams, tparams, *_, text, tlen = setup
    j_lanes, t_lanes = _lanes(setup)
    jcache = _jit(jm.t3_prefill)(jparams, jcfg.with_(kv_cache_dtype=kv), j_lanes,
                           jnp.asarray(text), jnp.asarray(tlen))
    tcache = tm.t3_prefill(tparams, T3Config.tiny().with_(kv_cache_dtype=kv), t_lanes,
                           to_t(text), to_t(tlen))
    np.testing.assert_array_equal(to_np(tcache["start"]), to_np(jcache["start"]))
    np.testing.assert_array_equal(to_np(tcache["pos"]), to_np(jcache["pos"]))
    # JAX [L, B, S, Hk, Dh] seq-major → the port's [L, B, Hk, S, Dh]
    jk = to_np(jcache["k"]).transpose(0, 1, 3, 2, 4)
    if kv == "int8":
        # values one rounding step apart where x/scale lands on .5 in one
        # package and not the other; the dequantised caches agree closely
        jks = to_np(jcache["k_scale"]).transpose(0, 1, 3, 2)
        deq_j = jk.astype(np.float32) * jks[..., None]
        deq_t = to_np(tcache["k"]).astype(np.float32) * to_np(tcache["k_scale"])[..., None]
        np.testing.assert_allclose(deq_t, deq_j, atol=ACT_TOL + 1.0 / 127 * np.abs(jks).max())
        np.testing.assert_allclose(to_np(tcache["k_scale"]), jks, atol=1e-6, rtol=1e-4)
    else:
        np.testing.assert_allclose(to_np(tcache["k"]), jk, atol=ACT_TOL, rtol=ACT_TOL)
        np.testing.assert_allclose(to_np(tcache["v"]),
                                   to_np(jcache["v"]).transpose(0, 1, 3, 2, 4),
                                   atol=ACT_TOL, rtol=ACT_TOL)


def _jax_slices(jcfg, jparams, j_lanes, text, tlen, temperature, n_slices):
    cache = _jit(jm.t3_prefill)(jparams, jcfg, j_lanes, jnp.asarray(text), jnp.asarray(tlen))
    state = jm.make_decode_state(jax.random.PRNGKey(3), jcfg, 1, temperature, 0.95, 0.5, 1.2)
    out = []
    for _ in range(n_slices):
        toks, cache, state = jm.t3_decode_slice(jparams, jcfg, cache, state, SLICE, 256)
        out.append(np.asarray(toks))
    return np.concatenate(out, axis=1), state


def _jax_gumbel(jcfg, n_steps):
    """The noise JAX's decode slice draws: per slot key folded with the step
    (valid while no request has finished)."""
    slot = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    return np.stack([
        np.asarray(jax.random.gumbel(jax.random.fold_in(slot, t), (jcfg.speech_vocab_size,)))[None]
        for t in range(n_steps)
    ])


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decode_slices_match(setup, kv, temperature):
    """Token ids over two decode slices, greedy and sampled (the JAX
    package's own Gumbel noise handed to the port), JAX on the paired layout
    (Pallas K1, interpret) against the port's K1 path."""
    jcfg, jparams, tparams, *_, text, tlen = setup
    j_lanes, t_lanes = _lanes(setup)
    jcfg = jcfg.with_(kv_cache_dtype=kv, kv_cache_layout="paired")
    want, jstate = _jax_slices(jcfg, jparams, j_lanes, text, tlen, temperature, 2)
    assert not bool(np.asarray(jstate["done"]).any()), "noise replay assumes no EOS"

    tcfg = T3Config.tiny().with_(kv_cache_dtype=kv)
    tcache = tm.t3_prefill(tparams, tcfg, t_lanes, to_t(text), to_t(tlen))
    tstate = tm.make_decode_state(tcfg, [0], temperature, 0.95, 0.5, 1.2, "cpu")
    gumbel = to_t(_jax_gumbel(jcfg, 2 * SLICE))
    got = torch.cat([
        tm.t3_decode_slice(tparams, tcfg, tcache, tstate, SLICE, 256,
                           gumbel=gumbel[i * SLICE:(i + 1) * SLICE])
        for i in range(2)
    ], dim=1)
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(to_np(tstate["step"]), np.asarray(jstate["step"]))
    np.testing.assert_array_equal(to_np(tstate["token_counts"]), np.asarray(jstate["token_counts"]))


def test_top_p_filter_and_repetition_penalty_match():
    """The sort-free top-p bisection and the repetition penalty on the same
    logits: exact. (top_p = 1.0 is left out: there the nucleus edge is the
    vocabulary's tail, where a float32 sum's rounding decides membership in
    either package.)"""
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 8194)) * 3).astype(np.float32)
    counts = rng.integers(0, 2, (3, 8194)).astype(np.int32)
    for top_p in (0.5, 0.95, np.array([0.3, 0.8, 0.99], np.float32)):
        want = np.asarray(jsampling.top_p_filter(jnp.asarray(logits), top_p))
        got = to_np(tsampling.top_p_filter(to_t(logits), torch.as_tensor(top_p)))
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jsampling.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(counts), 1.2))
    got = to_np(tsampling.apply_repetition_penalty(to_t(logits), to_t(counts), 1.2))
    np.testing.assert_allclose(got, want, rtol=1e-7)


def test_sample_token_with_injected_gumbel():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((4, 512)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jsampling.sample_token(key, jnp.asarray(logits), 0.7, 0.9))
    g = np.asarray(jax.random.gumbel(key, logits.shape))
    got = to_np(tsampling.sample_token(to_t(logits), to_t(g), 0.7, 0.9))
    np.testing.assert_array_equal(got, want)
    greedy = to_np(tsampling.sample_token(to_t(logits), to_t(g), 0.0, 0.9))
    np.testing.assert_array_equal(greedy, logits.argmax(-1))
