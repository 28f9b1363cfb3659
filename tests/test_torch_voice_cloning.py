"""Voice cloning parity: the port's front ends, S3TokenizerV2, CAMPPlus, the
VoiceEncoder, ``s3gen_ref_embed_ref`` and the engine's ``_cond_fn`` against
the JAX package's, on S3GenRefConfig.tiny() / VoiceEncoderConfig.tiny() /
EngineConfig.tiny_ref().

Parameters come from one JAX init, carried across by ``convert_params``;
inputs are made with numpy from a seed. Everything is float32 unless a test
says otherwise: differences are summation order, so each output is held
within REL of its largest magnitude (``assert_trees_close``), and tokens and
lengths are held exactly.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from torch_port_helpers import assert_trees_close, jax_tree_to_np, to_np, to_t

from chatterbox_tpu.models.s3gen_ref import campplus as jcamp
from chatterbox_tpu.models.s3gen_ref import features as jfeat
from chatterbox_tpu.models.s3gen_ref import model as jmodel
from chatterbox_tpu.models.s3gen_ref import tokenizer as jtok
from chatterbox_tpu.models.s3gen_ref.config import S3GenRefConfig as JCfg
from chatterbox_tpu.models.t3 import init_t3_params as jinit_t3
from chatterbox_tpu.models.voice_encoder import VoiceEncoderConfig as JVECfg
from chatterbox_tpu.models.voice_encoder import init_voice_encoder_params as jinit_ve
from chatterbox_tpu.models.voice_encoder import voice_embed as jvoice_embed
from chatterbox_tpu.ops import spectral as jspec
from chatterbox_tpu.runtime.engine import EngineConfig as JEngineConfig
from chatterbox_tpu.runtime.engine import TTSEngine as JTTSEngine
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.models.s3gen_ref import campplus as tcamp
from chatterbox_tpu_torch.models.s3gen_ref import features as tfeat
from chatterbox_tpu_torch.models.s3gen_ref import model as tmodel
from chatterbox_tpu_torch.models.s3gen_ref import tokenizer as ttok
from chatterbox_tpu_torch.models.s3gen_ref.config import S3GenRefConfig
from chatterbox_tpu_torch.models.voice_encoder import VoiceEncoderConfig
from chatterbox_tpu_torch.models.voice_encoder import voice_embed
from chatterbox_tpu_torch.ops import spectral as tspec
from chatterbox_tpu_torch.runtime import engine as teng

# float32 on both sides: each output within REL of its largest magnitude
REL = 1e-4
CFG = S3GenRefConfig.tiny()
VEC = VoiceEncoderConfig.tiny()


def speechlike(rng, B: int, L: int) -> np.ndarray:
    """Noise under a slow envelope plus a few harmonics: [B, L] float32."""
    t = np.arange(L) / 16000.0
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6, (B, 1)))
    tone = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6, (B, 1))) / k
               for k, f in enumerate((140.0, 280.0, 420.0), 1))
    return ((0.05 * rng.standard_normal((B, L)) + 0.2 * tone) * env).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_s3gen_ref_params(jax.random.PRNGKey(0), JCfg.tiny())


@pytest.fixture(scope="module")
def tparams(jparams):
    return convert_params(jax_tree_to_np(jparams), "cpu")


@pytest.fixture(scope="module")
def ve_params():
    jp = jinit_ve(jax.random.PRNGKey(1), JVECfg.tiny())
    return jp, convert_params(jax_tree_to_np(jp), "cpu")


# ----------------------------------------------------------------- front ends
def test_reflect_tail_matches():
    rng = np.random.default_rng(0)
    wav = rng.standard_normal((3, 2048)).astype(np.float32)
    lens = np.array([2048, 1003, 17])
    want = jfeat.reflect_tail(jnp.asarray(wav), jnp.asarray(lens))
    got = tfeat.reflect_tail(to_t(wav), to_t(lens))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_hifigan_log_mel_matches():
    wav = speechlike(np.random.default_rng(1), 2, 24000)
    assert_trees_close(jfeat.hifigan_log_mel(jnp.asarray(wav)), tfeat.hifigan_log_mel(to_t(wav)),
                       REL)


def test_whisper_log_mel_matches_ragged():
    """Ragged lengths: the clamp's max runs over each row's valid frames only
    and the padded frames are zero."""
    wav = speechlike(np.random.default_rng(2), 3, 16000)
    lens = np.array([16000, 9123, 4000])
    jmel, jn = jfeat.whisper_log_mel(jnp.asarray(wav), jnp.asarray(lens))
    tmel, tn = tfeat.whisper_log_mel(to_t(wav), to_t(lens))
    assert tmel.shape == (3, 100, 128)
    np.testing.assert_array_equal(to_np(tn), np.asarray(jn))
    assert_trees_close(jmel, tmel, REL)
    assert (to_np(tmel)[2, 25:] == 0).all()


def test_kaldi_fbank_matches_ragged():
    wav = speechlike(np.random.default_rng(3), 3, 16000)
    lens = np.array([16000, 7777, 300])   # the last row has no whole frame
    jfb, jn = jfeat.kaldi_fbank(jnp.asarray(wav), jnp.asarray(lens))
    tfb, tn = tfeat.kaldi_fbank(to_t(wav), to_t(lens))
    assert tfb.shape == (3, 98, 80)
    np.testing.assert_array_equal(to_np(tn), np.asarray(jn))
    assert to_np(tn).tolist() == [98, 47, 0]
    assert_trees_close(jfb, tfb, REL)


def test_log_mel_spectrogram_matches():
    """The VoiceEncoder's front end: symmetric Hann window, magnitude."""
    wav = speechlike(np.random.default_rng(4), 2, 8000)
    np.testing.assert_array_equal(tspec._mel_matrix(16000, 400, 40, 0.0, 8000.0),
                                  jspec._mel_matrix(16000, 400, 40, 0.0, 8000.0))
    assert_trees_close(jspec.log_mel_spectrogram(jnp.asarray(wav), 16000, 400, 160, 40),
                       tspec.log_mel_spectrogram(to_t(wav), 16000, 400, 160, 40), REL)


# ------------------------------------------------------------------ tokenizer
def test_tokenize_matches(jparams, tparams):
    wav = speechlike(np.random.default_rng(5), 2, 16000)
    lens = np.array([16000, 8000])
    jt, jn = jtok.s3tok_ref_tokenize(jparams["tokenizer"], JCfg.tiny().tokenizer,
                                     jnp.asarray(wav), jnp.asarray(lens))
    tt, tn = ttok.s3tok_ref_tokenize(tparams["tokenizer"], CFG.tokenizer, to_t(wav), to_t(lens))
    assert tt.shape == (2, 25) and to_np(tn).tolist() == [25, 12]
    np.testing.assert_array_equal(to_np(tn), np.asarray(jn))
    np.testing.assert_array_equal(to_np(tt), np.asarray(jt))
    assert len(np.unique(to_np(tt))) > 4   # not a constant code


def test_tokenize_padding_invariance(tparams):
    """The valid prefix's tokens do not depend on the padding; audio past the
    positional table (64 tokens here) is clipped."""
    w = speechlike(np.random.default_rng(6), 1, 8000)[0]
    out = []
    for pad in (1600, 8000, 50000):
        t, n = ttok.s3tok_ref_tokenize(tparams["tokenizer"], CFG.tokenizer,
                                       to_t(np.pad(w, (0, pad))[None]), torch.tensor([8000]))
        out.append((to_np(t)[0, :12], int(n[0]), t.shape[1]))
    assert [o[1] for o in out] == [12, 12, 12]
    assert out[2][2] == CFG.tokenizer.n_audio_ctx
    for toks, _, _ in out[1:]:
        np.testing.assert_array_equal(toks, out[0][0])


# ------------------------------------------------------------------ CAMPPlus
@pytest.mark.parametrize("masked", [False, True])
def test_campplus_matches(jparams, tparams, masked):
    rng = np.random.default_rng(7)
    fb = rng.standard_normal((2, 230, 80)).astype(np.float32)
    valid = np.arange(230)[None, :] < np.array([[230], [117]]) if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else to_t(valid)
    want = jcamp.campplus_embed(jparams["speaker"], JCfg.tiny().speaker, jnp.asarray(fb), jv)
    got = tcamp.campplus_embed(tparams["speaker"], CFG.speaker, to_t(fb), tv)
    assert got.shape == (2, 192)
    assert_trees_close(want, got, REL)
    if masked:   # the padded row equals its unpadded self
        alone = tcamp.campplus_embed(tparams["speaker"], CFG.speaker, to_t(fb[1:, :117]), None)
        np.testing.assert_allclose(to_np(got)[1], to_np(alone)[0], rtol=0,
                                   atol=REL * (1 + np.abs(to_np(alone)).max()))


@pytest.mark.parametrize("k", [3, 1])
def test_convert_hwio_conv2d_matches_jax(jparams, tparams, k):
    """The param bridge's 4-D case: a CAMPPlus HWIO kernel (3x3, and the 1x1
    shortcut) converted to OIHW gives F.conv2d JAX's conv_general_dilated
    result, at stride 1 and 2 on the frequency axis."""
    blk = jparams["speaker"]["head"]["layer1"][0]
    tblk = tparams["speaker"]["head"]["layer1"][0]
    jw = blk["conv1"]["w"] if k == 3 else blk["shortcut"]["conv"]["w"]
    tw = tblk["conv1"]["w"] if k == 3 else tblk["shortcut"]["conv"]["w"]
    m = jw.shape[2]
    assert jw.shape == (k, k, m, m) and tw.shape == (m, m, k, k)
    x = np.random.default_rng(8).standard_normal((2, 20, 33, m)).astype(np.float32)  # NHWC
    for stride in (1, 2):
        want = jcamp._conv2d(jnp.asarray(x), jw, stride)
        got = F.conv2d(to_t(x).permute(0, 3, 1, 2), tw, None, (stride, 1), ((k - 1) // 2,) * 2)
        assert_trees_close(want, got.permute(0, 2, 3, 1), REL)


# ----------------------------------------------------------------- VoiceEncoder
@pytest.mark.parametrize("with_len", [False, True])
def test_voice_embed_matches(ve_params, with_len):
    jp, tp = ve_params
    wav = speechlike(np.random.default_rng(9), 2, 6000)
    lens = np.array([6000, 2500])
    jl = jnp.asarray(lens) if with_len else None
    tl = to_t(lens) if with_len else None
    want = jvoice_embed(jp, JVECfg.tiny(), jnp.asarray(wav), jl)
    got = voice_embed(tp, VEC, to_t(wav), tl)
    assert got.shape == (2, 32) and got.dtype == torch.float32
    assert_trees_close(want, got, REL)
    if with_len:   # the windows past row 1's samples are left out
        alone = voice_embed(tp, VEC, to_t(wav[1:, :2500]))
        assert not np.allclose(to_np(got)[1], to_np(voice_embed(tp, VEC, to_t(wav[1:])))[0])
        assert np.abs(to_np(alone)[0] - to_np(got)[1]).max() < 0.2


def test_voice_embed_bf16_params_run_in_float32(ve_params):
    """With bf16 weights the JAX VoiceEncoder computes in float32 (its f32
    mel promotes them); the port upcasts the weights and agrees at f32."""
    jp, _ = ve_params
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp16 = convert_params(jax_tree_to_np(jp16), "cpu", torch.bfloat16)
    assert tp16["lstm"][0]["wx"].dtype == torch.bfloat16
    wav = speechlike(np.random.default_rng(10), 1, 6000)
    want = jvoice_embed(jp16, JVECfg.tiny(), jnp.asarray(wav), jnp.asarray([6000]))
    got = voice_embed(tp16, VEC, to_t(wav), torch.tensor([6000]))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert_trees_close(want, got, REL)


# ------------------------------------------------------------------ embed_ref
def test_embed_ref_matches(jparams, tparams):
    """A 0.9 s prompt in 1 s buffers: the reflected tail, the token and mel
    windows and the alignment rule (mel frames = 2 x tokens)."""
    rng = np.random.default_rng(11)
    w16 = speechlike(rng, 1, 16000)
    w24 = speechlike(rng, 1, 24000)
    l16, l24 = np.array([14400]), np.array([21600])
    w16[:, 14400:] = 0
    w24[:, 21600:] = 0
    want = jmodel.s3gen_ref_embed_ref(jparams, JCfg.tiny(), jnp.asarray(w24), jnp.asarray(l24),
                                      jnp.asarray(w16), jnp.asarray(l16))
    got = tmodel.s3gen_ref_embed_ref(tparams, CFG, to_t(w24), to_t(l24), to_t(w16), to_t(l16))
    assert sorted(got) == sorted(want)
    for key in ("prompt_tokens", "prompt_len", "prompt_mel_len"):
        np.testing.assert_array_equal(to_np(got[key]), np.asarray(want[key]))
        assert got[key].dtype == torch.int64
    assert int(got["prompt_mel_len"][0]) == 2 * int(got["prompt_len"][0])
    assert got["prompt_mel"].dtype == torch.float32
    assert_trees_close({k: want[k] for k in ("spk_emb", "prompt_mel")},
                       {k: got[k] for k in ("spk_emb", "prompt_mel")}, REL)


def test_port_init_has_the_jax_tree(tparams):
    """The port's random init draws the same tree as the converted JAX init:
    keys, shapes and dtypes, the voice-embedding subtrees included."""
    port = tmodel.init_s3gen_ref_params(CFG, torch.Generator().manual_seed(0), "cpu")
    assert list(port)[-2:] == ["tokenizer", "speaker"]
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.shape, tparams))
    got = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.shape, port))
    assert got == want


# ------------------------------------------------------------- the whole _cond_fn
@pytest.fixture(scope="module")
def engines():
    """Both engines' conditioning functions on the same parameters."""
    jcfg = JEngineConfig.tiny_ref()
    k = jax.random.split(jax.random.PRNGKey(3), 3)
    jp = {"t3": jinit_t3(k[0], jcfg.t3), "s3gen": jmodel.init_s3gen_ref_params(k[1], jcfg.s3gen_ref),
          "ve": jinit_ve(k[2], jcfg.ve)}
    jeng = JTTSEngine.__new__(JTTSEngine)
    jeng.cfg, jeng._jit_cache = jcfg, {}
    tp = {name: convert_params(jax_tree_to_np(tree), "cpu") for name, tree in jp.items()}
    return jeng._jit_cond(), jp, tp


@pytest.mark.parametrize("voice", ["cloned", "neutral"])
def test_cond_fn_matches_jax_jit_cond(engines, voice):
    """``_cond_fn`` against the JAX engine's ``_jit_cond`` (lanes and the ref
    dict): a cloned voice (2.5 s of 22.05 kHz audio through the port's
    reference_inputs: resampled, padded to 10 s, the T3 prompt at ≤ 6 s) and
    the neutral voice (2 s of zeros)."""
    jcond, jp, tp = engines
    if voice == "cloned":
        wav = speechlike(np.random.default_rng(12), 1, 55125)[0] * 1.5
        inputs = teng.reference_inputs(wav, 22050)
        assert inputs[0].shape == (1, teng.DEC_COND_LEN) and int(inputs[1][0]) == 60000
        assert int(inputs[3][0]) == int(inputs[4][0]) == 40000
    else:
        inputs = teng.neutral_inputs()
    exag = np.array([0.5], np.float32)
    jl, jref = jcond(jp, *(jnp.asarray(to_np(x)) for x in inputs), jnp.asarray(exag))
    tl, tref = teng._cond_fn(tp, teng.EngineConfig.tiny_ref(), *inputs, to_t(exag))
    assert tl.shape == jl.shape == (2, 6, 64) and tl.dtype == torch.float32
    assert_trees_close(jl, tl, REL)
    for key in ("prompt_tokens", "prompt_len", "prompt_mel_len"):
        np.testing.assert_array_equal(to_np(tref[key]), np.asarray(jref[key]))
    assert_trees_close({k: jref[k] for k in ("spk_emb", "prompt_mel")},
                       {k: tref[k] for k in ("spk_emb", "prompt_mel")}, REL)
