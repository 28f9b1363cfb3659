"""S3Gen ref parity: chatterbox_tpu_torch.models.s3gen_ref against
chatterbox_tpu.models.s3gen_ref on S3GenRefConfig.tiny().

Same parameters (the JAX init, converted), same inputs, and the JAX
package's own random draws (CFM initial noise, HiFT initial phases and NSF
noise) handed to the port. In the estimator test the JAX side runs its
transformer blocks through the Pallas flash-MHA kernel K2 in interpret mode
(the decoder's test hook); the port's K2 wrapper runs its plain version on
CPU tensors. (The end-to-end test lets JAX take its XLA attention, equal to
K2 wherever a lane has a valid key, which keeps the test fast.) Everything
is float32.
"""
from dataclasses import asdict

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_port_helpers import (
    conditioned_s3gen_params,
    jax_s3gen_noise,
    jax_tree_to_np,
    to_np,
    to_t,
)

from chatterbox_tpu.models.s3gen_ref import decoder as jdec
from chatterbox_tpu.models.s3gen_ref import hift as jhift
from chatterbox_tpu.models.s3gen_ref import model as jmodel
from chatterbox_tpu.models.s3gen_ref import upsample_encoder as jenc
from chatterbox_tpu.models.s3gen_ref.config import S3GenRefConfig as JCfg
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.models.s3gen_ref import decoder as tdec
from chatterbox_tpu_torch.models.s3gen_ref import hift as thift
from chatterbox_tpu_torch.models.s3gen_ref import model as tmodel
from chatterbox_tpu_torch.models.s3gen_ref import upsample_encoder as tenc
from chatterbox_tpu_torch.models.s3gen_ref.config import S3GenRefConfig

# float32 on both sides; differences are summation order (~1e-6 relative
# per op), so every module and the whole chain are held at 1e-4. The HiFT
# parameters are conditioned (torch_port_helpers.conditioned_s3gen_params) so
# the waveform does not sit on the clip, and the tests assert that no
# compared sample is clipped.
MODULE_TOL = 1e-4


def _assert_unclipped(wav, limit):
    peak = float(np.abs(wav).max())
    assert 1e-3 < peak < limit, f"waveform peak {peak}: silent or clipped at {limit}"


def _jit(fn):
    """jit with the config (argument 1) static: one compile instead of
    hundreds of eager op dispatches keeps the JAX side fast."""
    return jax.jit(fn, static_argnums=(1,))


@pytest.fixture(scope="module")
def params():
    jcfg = JCfg.tiny()
    jp = conditioned_s3gen_params(jmodel.init_s3gen_ref_params(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, jp, convert_params(jax_tree_to_np(jp), "cpu")


@pytest.fixture
def flash_interpret(monkeypatch):
    monkeypatch.setattr(jdec, "_FLASH_INTERPRET", True)


def test_configs_are_copies():
    assert asdict(S3GenRefConfig()) == asdict(JCfg())
    assert asdict(S3GenRefConfig.tiny()) == asdict(JCfg.tiny())


def test_upsample_encode_matches(params):
    jcfg, jp, tp = params
    fl = jcfg.flow
    rng = np.random.default_rng(1)
    B, T = 2, 13
    x = rng.standard_normal((B, T, fl.input_size)).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, 9:] = False
    x[~valid] = 0.0
    want, wv = _jit(jenc.upsample_encode)(jp["flow"]["encoder"], fl, jnp.asarray(x), jnp.asarray(valid))
    got, gv = tenc.upsample_encode(tp["flow"]["encoder"], S3GenRefConfig.tiny().flow,
                                   to_t(x), to_t(valid))
    np.testing.assert_array_equal(to_np(gv), np.asarray(wv))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=MODULE_TOL, rtol=MODULE_TOL)


def test_estimator_forward_matches(params, flash_interpret):
    """One vector-field evaluation; the JAX side reaches K2 (interpret)."""
    jcfg, jp, tp = params
    fl = jcfg.flow
    rng = np.random.default_rng(2)
    B, T, M = 2, 37, fl.output_size
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, mu, cond, spk = arr(B, T, M), arr(B, T, M), arr(B, T, M), arr(B, M)
    t = np.array([0.1, 0.7], np.float32)
    valid = np.ones((B, T), bool)
    valid[0, 30:] = False
    want = _jit(jdec.estimator_forward)(jp["flow"]["estimator"], fl, *map(jnp.asarray, (x, mu, spk, cond, t, valid)))
    got = tdec.estimator_forward(tp["flow"]["estimator"], S3GenRefConfig.tiny().flow,
                                 *map(to_t, (x, mu, spk, cond, t, valid)))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=MODULE_TOL, rtol=MODULE_TOL)


def test_make_source_matches_with_jax_noise(params):
    jcfg, jp, tp = params
    hc = jcfg.hift
    rng = np.random.default_rng(3)
    f0 = np.abs(rng.standard_normal((2, 12)) * 150).astype(np.float32)
    f0[0, :3] = 0.0  # unvoiced frames
    key = jax.random.PRNGKey(4)
    want = _jit(jhift.make_source)(jp["mel2wav"], hc, jnp.asarray(f0), key)
    k_ini, k_noise = jax.random.split(key)
    H = hc.nb_harmonics + 1
    L = 12 * thift._upsample_total(hc)
    rand_ini = np.asarray(jax.random.uniform(k_ini, (2, H)))
    noise = np.asarray(jax.random.normal(k_noise, (2, L, H)))
    got = thift.make_source(tp["mel2wav"], S3GenRefConfig.tiny().hift, to_t(f0),
                            to_t(rand_ini), to_t(noise))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=MODULE_TOL, rtol=MODULE_TOL)


def test_hift_decode_matches(params):
    jcfg, jp, tp = params
    hc = jcfg.hift
    rng = np.random.default_rng(4)
    Fr = 10
    mel = rng.standard_normal((2, Fr, hc.in_channels)).astype(np.float32)
    src = (rng.standard_normal((2, Fr * thift._upsample_total(hc))) * 0.1).astype(np.float32)
    want = _jit(jhift.hift_decode)(jp["mel2wav"], hc, jnp.asarray(mel), jnp.asarray(src))
    got = thift.hift_decode(tp["mel2wav"], S3GenRefConfig.tiny().hift, to_t(mel), to_t(src))
    _assert_unclipped(np.asarray(want), hc.audio_limit)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=MODULE_TOL, rtol=MODULE_TOL)


@pytest.mark.parametrize("cache_len", [0, 100])
def test_s3gen_ref_inference_end_to_end(params, cache_len):
    """Tokens → waveform through encoder, CFM (K2) and HiFT, with JAX's
    noise; ``cache_len`` > 0 exercises the excitation-prefix override."""
    jcfg, jp, tp = params
    rng = np.random.default_rng(5)
    B, T = 1, 11
    spt = jcfg.samples_per_token
    tokens = rng.integers(0, jcfg.flow.vocab_size, (B, T)).astype(np.int32)
    tlen = np.array([9], np.int32)
    ref = {
        "spk_emb": rng.standard_normal((B, 192)).astype(np.float32),
        "prompt_tokens": rng.integers(0, 6561, (B, jcfg.max_prompt_tokens)).astype(np.int32),
        "prompt_len": np.array([6], np.int32),
        "prompt_mel": rng.standard_normal((B, jcfg.max_prompt_mel, 80)).astype(np.float32),
        "prompt_mel_len": np.array([12], np.int32),
    }
    src = (rng.standard_normal((B, T * spt)) * 0.05).astype(np.float32)
    clen = np.array([cache_len], np.int32)
    key = jax.random.PRNGKey(11)
    want_w, want_s = _jit(jmodel.s3gen_ref_inference)(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(tlen), jax.tree.map(jnp.asarray, ref),
        jnp.asarray(src), jnp.asarray(clen), key)
    got_w, got_s = tmodel.s3gen_ref_inference(
        tp, S3GenRefConfig.tiny(), to_t(tokens), to_t(tlen), {k: to_t(v) for k, v in ref.items()},
        to_t(src), to_t(clen), jax_s3gen_noise(jcfg, key, B, T))
    assert got_w.shape == (B, T * spt)
    assert np.isfinite(to_np(got_w)).all()
    np.testing.assert_allclose(to_np(got_s), np.asarray(want_s), atol=MODULE_TOL, rtol=MODULE_TOL)
    _assert_unclipped(np.asarray(want_w), jcfg.hift.audio_limit)
    np.testing.assert_allclose(to_np(got_w), np.asarray(want_w), atol=MODULE_TOL, rtol=MODULE_TOL)
