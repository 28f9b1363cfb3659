"""The port's DiT S3Gen stack and S3Tok against the JAX package on the CPU.

Both packages get the same numpy leaves (``init_s3gen_params`` /
``init_s3tok_params`` at ``tiny()``, bridged by ``convert.convert_params``),
the same seeded inputs and JAX's own random draws (``normal(key, …)`` for
the CFM noise, ``normal(fold_in(key, 1), …)`` for the source noise), passed
to the port as inputs. The DiT parameters are conditioned
(``torch_port_helpers.conditioned_dit_params``: the AdaLN-zero leaves drawn,
the vocoder's resblocks scaled), else the flow would return its noise and
the waveform would sit on the clip. Each float output is held within a
stated share of its largest magnitude; S3Tok's tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import conditioned_dit_params, jax_tree_to_np, to_np, to_t

from chatterbox_tpu.models.s3gen import S3GenConfig as JS3GenConfig
from chatterbox_tpu.models.s3gen import encoder as jenc
from chatterbox_tpu.models.s3gen import flow as jflow
from chatterbox_tpu.models.s3gen import model as jmodel
from chatterbox_tpu.models.s3gen import vocoder as jvoc
from chatterbox_tpu.models.s3gen import xvector as jxv
from chatterbox_tpu.models.s3gen import init_s3gen_params
from chatterbox_tpu.models.s3tok import S3TokConfig as JS3TokConfig
from chatterbox_tpu.models.s3tok import drop_invalid_tokens as jdrop
from chatterbox_tpu.models.s3tok import init_s3tok_params, s3tok_tokenize as jtokenize
from chatterbox_tpu_torch.convert import convert_params, unconvert_params
from chatterbox_tpu_torch.models.s3gen import S3GenConfig, draw_noise, encoder, flow, vocoder
from chatterbox_tpu_torch.models.s3gen import model, xvector
from chatterbox_tpu_torch.models.s3gen.model import s3gen_param_tree
from chatterbox_tpu_torch.models.s3tok import (
    S3TokConfig,
    drop_invalid_tokens,
    s3tok_fsq,
    s3tok_param_tree,
    s3tok_tokenize,
)
from chatterbox_tpu_torch.ops.initializers import DenseInit, ShapeInit

CFG, JCFG = S3GenConfig.tiny(), JS3GenConfig.tiny()
TOK_CFG, JTOK_CFG = S3TokConfig.tiny(), JS3TokConfig.tiny()
B, T = 2, 6
SPT = CFG.samples_per_token
# float32 tolerances, as shares of the output's largest magnitude
REL = 1e-5            # encoder, estimator, CFM, x-vector, f0, vocoder
# the excitation and the wav made from it: the phase is a float32 cumsum
# over T·960 = 5760 samples, summed in another order, and the 8th
# harmonic's argument reaches ~1e3 rad, where a float32 ulp is 6e-5 rad
REL_SOURCE = 1e-3
# bfloat16 weights in both packages: the encoder's mu within 2 % of its peak
# (a few bf16 ulps), the float32 flow's mel within 5 %, the wav (excitation
# pinned, see test_s3gen_inference_bf16) within 5 %
REL_BF16 = (0.02, 0.05, 0.05)


def _close(got, want, rel):
    got = to_np(got).astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6), (err, np.abs(want).max())
    return err


@pytest.fixture(scope="module")
def jparams():
    return conditioned_dit_params(jax_tree_to_np(init_s3gen_params(jax.random.PRNGKey(0), JCFG)))


@pytest.fixture(scope="module")
def tparams(jparams):
    return convert_params(jparams, "cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {
        "tokens": rng.integers(0, CFG.vocab_size, (B, T)),
        "token_len": np.array([T, 4]),
        "wav24": (rng.standard_normal((B, 24000)) * 0.1).astype(np.float32),
        "fbank": rng.standard_normal((B, 50, 80)).astype(np.float32),
        "fbank_len": np.array([50, 30]),
        "prompt": rng.integers(0, CFG.vocab_size, (B, CFG.max_prompt_tokens)),
        "prompt_len": np.array([5, CFG.max_prompt_tokens]),
    }


@pytest.fixture(scope="module")
def refs(jparams, tparams, inputs):
    """The voice dict of both packages, from the same inputs."""
    x = inputs
    jref = jmodel.s3gen_embed_ref(jparams, JCFG, jnp.asarray(x["wav24"]), jnp.asarray(x["fbank"]),
                                  jnp.asarray(x["prompt"]), jnp.asarray(x["prompt_len"]),
                                  fbank_len=jnp.asarray(x["fbank_len"]))
    tref = model.s3gen_embed_ref(tparams, CFG, to_t(x["wav24"]), to_t(x["fbank"]),
                                 to_t(x["prompt"]), to_t(x["prompt_len"]),
                                 fbank_len=to_t(x["fbank_len"]))
    return jref, tref


def _jax_noise(key, n_tokens):
    """JAX's draws in s3gen_inference, in the port's noise-dict form."""
    frames = (CFG.max_prompt_tokens + n_tokens) * CFG.frames_per_token
    return {"cfm": to_t(jax.random.normal(key, (B, frames, CFG.n_mels), jnp.float32)),
            "source": to_t(jax.random.normal(jax.random.fold_in(key, 1),
                                             (B, n_tokens * SPT, 1), jnp.float32))[..., 0]}


def _valid(lens, n):
    return np.arange(n)[None, :] < np.asarray(lens)[:, None]


# ------------------------------------------------------------------ modules
def test_encode_tokens(jparams, tparams, inputs):
    tokens = inputs["tokens"].copy()
    valid = _valid(inputs["token_len"], T)
    tokens[~valid] = CFG.vocab_size
    want = jenc.encode_tokens(jparams["encoder"], JCFG, jnp.asarray(tokens), jnp.asarray(valid))
    got = encoder.encode_tokens(tparams["encoder"], CFG, to_t(tokens), to_t(valid))
    assert got.shape == (B, 2 * T, CFG.n_mels)
    _close(got, want, REL)


def _flow_inputs(seed=1, n=12):
    rng = np.random.default_rng(seed)
    M = CFG.n_mels
    flag = np.zeros((B, n, 1), np.float32)
    flag[:, :4] = 1.0
    return dict(mu=rng.standard_normal((B, n, M)).astype(np.float32),
                cond=(rng.standard_normal((B, n, M)) * flag).astype(np.float32), flag=flag,
                spk=rng.standard_normal((B, CFG.spk_dim)).astype(np.float32),
                valid=_valid([n, n - 3], n))


def test_estimator(jparams, tparams):
    f = _flow_inputs()
    x = np.random.default_rng(2).standard_normal(f["mu"].shape).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    want = jflow.estimator(jparams["flow"], JCFG, *(jnp.asarray(a) for a in (
        x, f["mu"], f["cond"], f["flag"], f["spk"], t, f["valid"])))
    got = flow.estimator(tparams["flow"], CFG, *(to_t(a) for a in (
        x, f["mu"], f["cond"], f["flag"], f["spk"], t, f["valid"])))
    assert got.dtype == torch.float32
    _close(got, want, REL)
    assert np.abs(np.asarray(want)).max() > 0.1  # the conditioned flow does work


@pytest.mark.parametrize("cfg_rate", [0.7, 0.0])
def test_cfm_generate(jparams, tparams, cfg_rate):
    """The cosine-scheduled Euler solve, with classifier-free guidance (the
    two passes stacked into one batch of 2B) and without."""
    f = _flow_inputs()
    jcfg, cfg = JCFG.with_(cfm_cfg_rate=cfg_rate), CFG.with_(cfm_cfg_rate=cfg_rate)
    key = jax.random.PRNGKey(3)
    want = jflow.cfm_generate(jparams["flow"], jcfg, key, *(jnp.asarray(f[k]) for k in (
        "mu", "cond", "flag", "spk", "valid")))
    noise = to_t(jax.random.normal(key, f["mu"].shape, jnp.float32))
    got = flow.cfm_generate(tparams["flow"], cfg, noise, *(to_t(f[k]) for k in (
        "mu", "cond", "flag", "spk", "valid")))
    _close(got, want, REL)
    assert np.abs(np.asarray(want) - to_np(noise)).max() > 0.1


@pytest.mark.parametrize("masked", [False, True])
def test_xvector_embed(jparams, tparams, inputs, masked):
    valid = _valid(inputs["fbank_len"], 50) if masked else None
    want = jxv.xvector_embed(jparams["xvector"], jnp.asarray(inputs["fbank"]),
                             None if valid is None else jnp.asarray(valid))
    got = xvector.xvector_embed(tparams["xvector"], to_t(inputs["fbank"]),
                                None if valid is None else to_t(valid))
    _close(got, want, REL)
    np.testing.assert_allclose(np.linalg.norm(to_np(got), axis=-1), 1.0, atol=1e-5)


def _mel(seed=4, n=2 * T):
    return np.random.default_rng(seed).standard_normal((B, n, CFG.n_mels)).astype(np.float32)


def test_predict_f0(jparams, tparams):
    want = jvoc.predict_f0(jparams["vocoder"], jnp.asarray(_mel()))
    got = vocoder.predict_f0(tparams["vocoder"], to_t(_mel()))
    _close(got, want, REL)


def test_make_source(jparams, tparams):
    """The harmonic-plus-noise excitation from the same f0 and JAX's noise,
    within REL_SOURCE at this length (2T frames, 5760 samples)."""
    f0 = np.array(jvoc.predict_f0(jparams["vocoder"], jnp.asarray(_mel())))
    f0[1, 4:] = 0.0  # an unvoiced stretch (f0 ≤ 10 Hz: noise only)
    key = jax.random.PRNGKey(6)
    want = jvoc.make_source(jparams["vocoder"], JCFG, jnp.asarray(f0), key)
    noise = to_t(jax.random.normal(key, (B, f0.shape[1] * CFG.hop, 1), jnp.float32))[..., 0]
    got = vocoder.make_source(tparams["vocoder"], CFG, to_t(f0), noise)
    assert got.shape == (B, f0.shape[1] * CFG.hop)
    _close(got, want, REL_SOURCE)


def test_vocode(jparams, tparams):
    """mel + excitation → waveform; the conditioned vocoder leaves no sample
    on the ±1 clip, so agreement is not the clip's."""
    src = np.tanh(np.random.default_rng(5).standard_normal((B, 2 * T * CFG.hop))).astype(np.float32)
    want = jvoc.vocode(jparams["vocoder"], JCFG, jnp.asarray(_mel()), jnp.asarray(src))
    got = vocoder.vocode(tparams["vocoder"], CFG, to_t(_mel()), to_t(src))
    assert (np.abs(np.asarray(want)) >= 1.0).mean() == 0.0
    _close(got, want, REL)


def test_s3gen_embed_ref(refs):
    jref, tref = refs
    assert set(jref) == set(tref)
    for k in ("prompt_tokens", "prompt_len", "prompt_mel_len"):
        np.testing.assert_array_equal(to_np(tref[k]), np.asarray(jref[k]))
    _close(tref["spk_emb"], jref["spk_emb"], REL)
    _close(tref["prompt_mel"], jref["prompt_mel"], REL)


def test_s3gen_inference(jparams, tparams, inputs, refs):
    """The chunk end to end, two rows of different lengths, the second with
    a cached excitation prefix: the wav and the new source cache."""
    jref, tref = refs
    key = jax.random.PRNGKey(5)
    cache = np.zeros((B, T * SPT), np.float32)
    cache[1, : 2 * SPT] = np.tanh(np.random.default_rng(7).standard_normal(2 * SPT))
    clen = np.array([0, 2 * SPT])
    jw, js = jmodel.s3gen_inference(jparams, JCFG, jnp.asarray(inputs["tokens"]),
                                    jnp.asarray(inputs["token_len"]), jref, jnp.asarray(cache),
                                    jnp.asarray(clen), key)
    tw, ts = model.s3gen_inference(tparams, CFG, to_t(inputs["tokens"]),
                                   to_t(inputs["token_len"]), tref, to_t(cache), to_t(clen),
                                   _jax_noise(key, T))
    assert tw.shape == ts.shape == (B, T * SPT)
    assert (np.abs(np.asarray(jw)) >= 1.0).mean() == 0.0
    _close(tw, jw, REL_SOURCE)
    _close(ts, js, REL_SOURCE)
    np.testing.assert_array_equal(to_np(ts)[1, : 2 * SPT], cache[1, : 2 * SPT])


def test_s3gen_inference_bf16(jparams, inputs):
    """bfloat16 weights in both packages. The dtypes follow JAX's (the flow
    and the outputs float32, mu and the x-vector bf16). The encoder's mu and
    the flow's mel are held within REL_BF16; the excitation's phase is a
    bf16 cumsum whose rounding order differs (JAX's scan against torch's
    float32 accumulation), so the wav is held with one excitation pinned as
    the cache over the whole chunk."""
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    tp = convert_params(jparams, "cpu", torch.bfloat16)
    x = inputs
    jref = jmodel.s3gen_embed_ref(jp, JCFG, jnp.asarray(x["wav24"]), jnp.asarray(x["fbank"]),
                                  jnp.asarray(x["prompt"]), jnp.asarray(x["prompt_len"]))
    tref = model.s3gen_embed_ref(tp, CFG, to_t(x["wav24"]), to_t(x["fbank"]), to_t(x["prompt"]),
                                 to_t(x["prompt_len"]))
    assert tref["spk_emb"].dtype == torch.bfloat16 and jref["spk_emb"].dtype == jnp.bfloat16
    full, vp = jmodel._left_pack_prompt(JCFG, jref["prompt_tokens"], jref["prompt_len"],
                                        jnp.asarray(x["tokens"]))
    valid = jnp.concatenate([vp, jnp.asarray(_valid(x["token_len"], T))], axis=1)
    jmu = jenc.encode_tokens(jp["encoder"], JCFG, full, valid)
    tmu = encoder.encode_tokens(tp["encoder"], CFG, to_t(np.asarray(full)), to_t(np.asarray(valid)))
    assert tmu.dtype == torch.bfloat16 and jmu.dtype == jnp.bfloat16
    _close(tmu, jmu, REL_BF16[0])
    f = _flow_inputs()
    key = jax.random.PRNGKey(3)
    jmel = jflow.cfm_generate(jp["flow"], JCFG, key, jnp.asarray(f["mu"], jnp.bfloat16),
                              *(jnp.asarray(f[k]) for k in ("cond", "flag")),
                              jnp.asarray(f["spk"], jnp.bfloat16), jnp.asarray(f["valid"]))
    tmel = flow.cfm_generate(tp["flow"], CFG, to_t(jax.random.normal(key, f["mu"].shape)),
                             to_t(f["mu"], torch.bfloat16), to_t(f["cond"]), to_t(f["flag"]),
                             to_t(f["spk"], torch.bfloat16), to_t(f["valid"]))
    assert tmel.dtype == torch.float32 and jmel.dtype == jnp.float32
    _close(tmel, jmel, REL_BF16[1])

    key = jax.random.PRNGKey(5)
    L = T * SPT
    src = np.tanh(np.random.default_rng(8).standard_normal((B, L))).astype(np.float32)
    full_cache = jnp.full((B,), L, jnp.int32)
    jw, js = jmodel.s3gen_inference(jp, JCFG, jnp.asarray(x["tokens"]),
                                    jnp.asarray(x["token_len"]), jref, jnp.asarray(src),
                                    full_cache, key)
    tw, ts = model.s3gen_inference(tp, CFG, to_t(x["tokens"]), to_t(x["token_len"]), tref,
                                   to_t(src), to_t(np.asarray(full_cache)),
                                   _jax_noise(key, T))
    assert tw.dtype == ts.dtype == torch.float32 and jw.dtype == js.dtype == jnp.float32
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    assert np.isfinite(to_np(tw)).all() and (np.abs(np.asarray(jw)) >= 1.0).mean() == 0.0
    _close(tw, jw, REL_BF16[2])


# ------------------------------------------------ the JAX package's contracts
def test_source_cache_prefix_exact(tparams, refs):
    """Counterpart of tests/test_s3gen.py::test_s3gen_source_cache_prefix_exact:
    re-synthesising accumulated tokens reuses the cached excitation prefix
    bit for bit, and the same call is deterministic."""
    _, tref = refs
    ref = {k: v[:1] for k, v in tref.items()}
    gen = torch.Generator().manual_seed(7)
    noise4 = draw_noise(CFG, 1, 4, gen, "cpu")
    t4 = torch.tensor([[1, 2, 3, 4]])
    _, src4 = model.s3gen_inference(tparams, CFG, t4, torch.tensor([4]), ref,
                                    torch.zeros((1, 4 * SPT)), torch.tensor([0]), noise4)
    t6 = torch.tensor([[1, 2, 3, 4, 5, 6]])
    cache = torch.zeros((1, 6 * SPT))
    cache[:, : 4 * SPT] = src4
    gen.manual_seed(7)
    noise6 = draw_noise(CFG, 1, 6, gen, "cpu")
    wav6, src6 = model.s3gen_inference(tparams, CFG, t6, torch.tensor([6]), ref, cache,
                                       torch.tensor([4 * SPT]), noise6)
    assert torch.equal(src6[0, : 4 * SPT], src4[0])
    assert torch.isfinite(wav6).all()
    wav6b, _ = model.s3gen_inference(tparams, CFG, t6, torch.tensor([6]), ref, cache,
                                     torch.tensor([4 * SPT]), noise6)
    assert torch.equal(wav6, wav6b)


def test_pad_content_invariance(tparams, refs):
    """Counterpart of tests/test_s3gen.py::test_s3gen_pad_content_invariance:
    what sits in the padded tail of a bucket does not reach the valid
    output."""
    _, tref = refs
    ref = {k: v[:1] for k, v in tref.items()}
    noise = draw_noise(CFG, 1, 6, torch.Generator().manual_seed(9), "cpu")
    outs = []
    for row in ([7, 8, 9, 0, 0, 0], [7, 8, 9, 123, 456, 789]):
        w, _ = model.s3gen_inference(tparams, CFG, torch.tensor([row]), torch.tensor([3]), ref,
                                     torch.zeros((1, 6 * SPT)), torch.tensor([0]), noise)
        outs.append(w[0, : 3 * SPT])
    assert torch.equal(outs[0], outs[1])


def test_draw_noise_is_chunk_stable():
    """A generator seeded the same way gives the CFM's frame t the same
    noise whatever the chunk's length (the buffer does not depend on it)."""
    a = draw_noise(CFG, 1, 4, torch.Generator().manual_seed(3), "cpu")
    b = draw_noise(CFG, 1, 40, torch.Generator().manual_seed(3), "cpu")
    assert a["cfm"].shape == b["cfm"].shape == (1, model.NOISE_FRAMES, CFG.n_mels)
    assert torch.equal(a["cfm"], b["cfm"])
    assert a["source"].shape == (1, 4 * SPT) and b["source"].shape == (1, 40 * SPT)


# --------------------------------------------------------------- S3Tok
@pytest.fixture(scope="module")
def tok_params():
    jp = jax_tree_to_np(init_s3tok_params(jax.random.PRNGKey(0), JTOK_CFG))
    return jp, convert_params(jp, "cpu")


def test_s3tok_tokens_exact(tok_params):
    """Tokens and lengths exactly equal at float32, over three lengths; no
    FSQ input sits on a rounding boundary, so the equality is not luck."""
    jp, tp = tok_params
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal((3, 32000)) * 0.1).astype(np.float32)
    lens = np.array([32000, 16000, 7000])
    jt, jl = jtokenize(jp, JTOK_CFG, jnp.asarray(wav), jnp.asarray(lens))
    tt, tl = s3tok_tokenize(tp, TOK_CFG, to_t(wav), to_t(lens))
    np.testing.assert_array_equal(to_np(tt), np.asarray(jt))
    np.testing.assert_array_equal(to_np(tl), np.asarray(jl))
    assert to_np(tl).tolist() == [50, 25, 10]
    z, valid = s3tok_fsq(tp, TOK_CFG, to_t(wav), to_t(lens))
    assert np.abs(np.abs(to_np(z)[to_np(valid)]) - 0.5).min() > 1e-6
    assert (to_np(tt) < 6561).all() and (to_np(tt)[~to_np(valid)] == 0).all()


def test_drop_invalid_tokens():
    toks = np.array([[0, 6560, 6561, 7000]])
    np.testing.assert_array_equal(to_np(drop_invalid_tokens(to_t(toks))),
                                  np.asarray(jdrop(jnp.asarray(toks))))


# --------------------------------------------------------------- the bridge
@pytest.mark.parametrize("which", ["s3gen", "s3tok"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bridge_round_trip(jparams, tok_params, which, dtype):
    """convert_params then unconvert_params gives the JAX leaves back, and
    the port's own tree builders lay out the shapes the bridge produces
    (the DiT's stacked w1/w2, ada_w, the time MLP and the vocoder's
    transposed convs included)."""
    tree = jparams if which == "s3gen" else tok_params[0]
    conv = convert_params(tree, "cpu", dtype)
    back = unconvert_params(conv)
    want, got = jax.tree.leaves(tree), jax.tree.leaves(back)
    assert len(want) == len(got) > 10
    for a, b in zip(want, got):
        np.testing.assert_array_equal(to_np(b), np.asarray(jnp.asarray(a, jnp.bfloat16)
                                                           if dtype == torch.bfloat16 else a,
                                                           np.float32))
    build = s3gen_param_tree if which == "s3gen" else s3tok_param_tree
    cfg = CFG if which == "s3gen" else TOK_CFG
    template = convert_params(build(cfg, ShapeInit()), "meta")
    assert [t.shape for t in jax.tree.leaves(template)] == [t.shape for t in jax.tree.leaves(conv)]
    drawn = build(cfg, DenseInit(torch.Generator().manual_seed(0), "cpu"))
    assert [tuple(t.shape) for t in jax.tree.leaves(drawn)] == [np.shape(a) for a in want]
