"""The port's engine with the DiT S3Gen stack (``EngineConfig.tiny()``, the
JAX package's default arch) on the CPU, against the JAX engine.

Both engines serve the same parameters (the JAX engine's random init,
bridged: T3, the DiT S3Gen, S3Tok and the VoiceEncoder) from a MODEL_PATH
that holds a ``conds.pt``, which the DiT ignores with a warning: both build
the neutral default voice. Greedy requests go to both on the per-request
path (MAX_DECODE_SLOTS=1) and the batched path (MAX_DECODE_SLOTS=4, three
concurrent requests); the WAVs must hold the same number of samples (the
noise differs, so the samples are not compared; the modules' numerics are
held by tests/test_torch_s3gen_dit.py). The conditionals of the neutral and
of a cloned voice are held to the JAX engine's ``_jit_cond`` (``dit``
branch); ``CHATTERBOX_TINY_MODEL`` picks the config the JAX engine picks;
zero overlap, empty text and cancellation behave as in tests/test_engine.py.
"""
import asyncio
import logging

import numpy as np
import pytest
import torch

from torch_port_helpers import assert_trees_close, jax_tree_to_np, to_np, write_conds

from chatterbox_tpu.config import reset_config_cache
from chatterbox_tpu.runtime import CancellationToken as JToken
from chatterbox_tpu.runtime import EngineConfig as JEngineConfig
from chatterbox_tpu.runtime import TTSEngine as JTTSEngine
from chatterbox_tpu_torch.audio.pcm import write_wav
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.runtime import engine as teng_mod
from chatterbox_tpu_torch.runtime.cancellation import CancellationToken
from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine

# float32 conditionals: each within REL of its largest magnitude
REL = 1e-4

REQUEST = dict(
    text="Hello there. This is a test of the port.",
    output_format="wav",
    voice_id=None,
    cfg_guidance_weight=0.5,
    synthesis_temperature=0.0,   # greedy: both engines take the same tokens
    text_processing_chunk_size=20,
    audio_tokens_per_slice=8,
    remove_trailing_milliseconds=0,
    remove_leading_milliseconds=0,
    chunk_overlap_strategy="full",
    crossfade_duration_milliseconds=10,
    request_id="dit-parity",
)
ZERO = dict(chunk_overlap_strategy="zero", request_id="dit-zero")
BATCHED = [
    dict(text="Hello there. This is a test of the port.", request_id="dit-batched-0"),
    dict(text="A short one.", request_id="dit-batched-1"),
    dict(text="Three requests share the decoder.", request_id="dit-batched-2"),
]
VOICE = "dit-voice.wav"


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_engine_dit")
    (tmp / "models").mkdir()
    write_conds(tmp / "models" / "conds.pt", spk_dim=32)
    rng = np.random.default_rng(21)
    t = np.arange(55125) / 22050.0
    wav = 0.3 * np.sin(2 * np.pi * 150.0 * t) + 0.03 * rng.standard_normal(t.size)
    (tmp / "voices").mkdir()
    write_wav(str(tmp / "voices" / VOICE), wav, 22050)
    mp = pytest.MonkeyPatch()
    for k, v in {"MODEL_PATH": str(tmp / "models"), "VOICES_DIR": str(tmp / "voices"),
                 "PRELOADED_VOICES_DIR": str(tmp / "preloaded"), "MAX_DECODE_SLOTS": "1",
                 "CHATTERBOX_PRECOMPILE": "0"}.items():
        mp.setenv(k, v)
    for k in ("CHATTERBOX_S3GEN_ARCH", "CHATTERBOX_TINY_MODEL", "CHATTERBOX_CFM_PROMPT_CACHE"):
        mp.delenv(k, raising=False)
    reset_config_cache()
    yield tmp
    mp.undo()
    reset_config_cache()


async def _collect(engine, token, **kw):
    out = b""
    async for chunk in engine.stream(**{**REQUEST, **kw}, cancellation_token=token):
        out += chunk
    return out


def _converted(jeng):
    return {k: convert_params(jax_tree_to_np(v), "cpu") for k, v in jeng.params.items()}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture(scope="module")
def per_request(env):
    """Both engines on the per-request path: a full-overlap and a
    zero-overlap request, then a voice cloned by prepare_conditionals. The
    JAX engine resamples with scipy too (its native resampler off)."""
    import chatterbox_tpu.native as jnative

    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "resample_poly", lambda *a: None)
    records = _Records()
    logging.getLogger().addHandler(records)
    try:
        jeng = JTTSEngine(JEngineConfig.tiny(), seed=3)
        asyncio.run(jeng.ainit())
        jwavs = [asyncio.run(_collect(jeng, JToken(), **kw)) for kw in ({}, ZERO)]
        jeng.prepare_conditionals(str(env / "voices" / VOICE))
        teng = TTSEngine(EngineConfig.tiny(), seed=3, device="cpu", params=_converted(jeng))
        n0 = len(records.messages)
        asyncio.run(teng.ainit())
        warnings = records.messages[n0:]
        twavs = [asyncio.run(_collect(teng, CancellationToken(), **kw)) for kw in ({}, ZERO)]
        teng.prepare_conditionals(str(env / "voices" / VOICE))
        jconds = {k: jeng.voice_cache[k] for k in ("default", VOICE)}
        jeng.shutdown()
    finally:
        logging.getLogger().removeHandler(records)
        mp.undo()
    return jwavs, twavs, teng, jconds, warnings


@pytest.fixture(scope="module")
def batched(env):
    """Both engines on the batched path, at a 24-token decode cap per chunk
    (fewer S3Gen buckets for the JAX engine to compile)."""
    import dataclasses

    cfg, jcfg = (dataclasses.replace(c.tiny(), max_new_tokens=24)
                 for c in (EngineConfig, JEngineConfig))
    mp = pytest.MonkeyPatch()
    mp.setenv("MAX_DECODE_SLOTS", "4")
    reset_config_cache()

    async def serve(engine, token_cls):
        return await asyncio.gather(*[_collect(engine, token_cls(), **kw) for kw in BATCHED])

    try:
        jeng = JTTSEngine(jcfg, seed=3)
        asyncio.run(jeng.ainit())
        jwavs = asyncio.run(serve(jeng, JToken))
        teng = TTSEngine(cfg, seed=3, device="cpu", params=_converted(jeng))
        jeng.shutdown()
        asyncio.run(teng.ainit())
        twavs = asyncio.run(serve(teng, CancellationToken))
        teng.shutdown()
    finally:
        mp.undo()
        reset_config_cache()
    return jwavs, twavs, teng


def _assert_same_length(jwav, twav):
    assert twav[:4] == b"RIFF" and twav[:44] == jwav[:44]
    assert len(twav) == len(jwav) > 44
    pcm = np.frombuffer(twav[44:], dtype="<i2")
    assert np.abs(pcm).max() > 0


def _check_samples_follow_tokens(wav, stats, teng, fade_ms):
    """Full overlap synthesises (kept tokens + the EOS code) × samples per
    token per chunk; each crossfaded seam merges fade_len samples."""
    spt = teng.cfg.gen.samples_per_token
    assert stats["synth_samples"] == sum(n + 1 for n in stats["t3_tokens"]) * spt, stats
    seams, rest = divmod(stats["synth_samples"] - stats["samples"],
                         int(teng.sr * fade_ms / 1000))
    assert rest == 0 and 0 <= seams < stats["slices"], stats
    assert (len(wav) - 44) // 2 == stats["samples"]


@pytest.mark.parametrize("overlap", ["full", "zero"])
def test_dit_per_request_matches_jax_sample_count(per_request, overlap):
    jwavs, twavs, teng, *_ = per_request
    i = 0 if overlap == "full" else 1
    _assert_same_length(jwavs[i], twavs[i])
    assert teng.cfg.s3gen_arch == "dit" and teng.s3gen_scheduler is None
    stats = teng.request_stats[REQUEST["request_id"] if i == 0 else ZERO["request_id"]]
    assert stats["chunks"] >= 2 and stats["streamed"] == 0
    if overlap == "full":
        _check_samples_follow_tokens(twavs[0], stats, teng,
                                     REQUEST["crossfade_duration_milliseconds"])


def test_dit_batched_matches_jax_sample_counts(batched):
    """Three concurrent greedy requests through both engines' batched paths:
    equal WAV lengths, request by request; the DiT batches without the
    prompt cache, streaming CFM or the tail vocoder."""
    jwavs, twavs, teng = batched
    for kw, jwav, twav in zip(BATCHED, jwavs, twavs):
        _assert_same_length(jwav, twav)
        stats = teng.request_stats[kw["request_id"]]
        _check_samples_follow_tokens(twav, stats, teng, REQUEST["crossfade_duration_milliseconds"])
        assert stats["streamed"] == 0
    assert teng._cfm_cache_mode() == "0" and not teng._cfm_cache_lru


def _assert_conds_close(jconds, tconds):
    """The T3 lanes and the ref dict's floats within REL of their largest
    magnitude, tokens and lengths exactly; the port's prompt mel is the JAX
    one padded with zero frames to the static window."""
    assert_trees_close(jconds.t3_cond_lanes, tconds.t3_cond_lanes, REL)
    for key in ("prompt_tokens", "prompt_len", "prompt_mel_len"):
        np.testing.assert_array_equal(to_np(tconds.gen_ref[key]),
                                      np.asarray(jconds.gen_ref[key]))
    jmel = np.asarray(jconds.gen_ref["prompt_mel"])
    tmel = to_np(tconds.gen_ref["prompt_mel"])
    assert not tmel[:, jmel.shape[1]:].any()
    assert_trees_close({"spk": jconds.gen_ref["spk_emb"], "mel": jmel},
                       {"spk": tconds.gen_ref["spk_emb"], "mel": tmel[:, : jmel.shape[1]]}, REL)


def test_dit_ignores_conds_and_builds_the_neutral_voice(per_request):
    """conds.pt is in MODEL_PATH: the DiT engine warns, as the JAX engine
    does, and serves the neutral voice, equal to the JAX engine's and to
    ``_cond_fn`` on 2 s of zeros."""
    _, _, teng, jconds, warnings = per_request
    assert any("conds.pt found but s3gen_arch='dit'" in m for m in warnings), warnings
    conds = teng.voice_cache["default"]
    _assert_conds_close(jconds["default"], conds)
    want = teng_mod._cond_fn(teng.params, teng.cfg, *teng_mod.neutral_inputs(),
                             torch.tensor([0.5]))
    assert torch.equal(conds.t3_cond_lanes, want[0])
    assert all(torch.equal(conds.gen_ref[k], v) for k, v in want[1].items())


def test_dit_prepare_conditionals_matches_jax(per_request):
    """A voice cloned from the store: S3Tok tokens, the x-vector, the prompt
    mel and the T3 lanes as the JAX engine's ``_jit_cond`` gives them."""
    _, _, teng, jconds, _ = per_request
    _assert_conds_close(jconds[VOICE], teng.voice_cache[VOICE])
    assert int(teng.voice_cache[VOICE].gen_ref["prompt_len"][0]) > 0


@pytest.mark.parametrize("arch", [None, "dit", "ref"])
def test_tiny_model_env_picks_the_jax_config(env, monkeypatch, arch):
    """CHATTERBOX_TINY_MODEL=1 serves tiny() (the DiT) unless
    CHATTERBOX_S3GEN_ARCH=ref, which serves tiny_ref(), as in the JAX engine;
    the engine draws the DiT's trees (S3Tok included) or the ref's."""
    monkeypatch.setenv("CHATTERBOX_TINY_MODEL", "1")
    if arch is not None:
        monkeypatch.setenv("CHATTERBOX_S3GEN_ARCH", arch)
    jeng, teng = JTTSEngine(), TTSEngine(device="cpu")
    assert teng.cfg.s3gen_arch == jeng.cfg.s3gen_arch == (arch or "dit")
    assert teng.cfg == (EngineConfig.tiny_ref() if arch == "ref" else EngineConfig.tiny())
    teng._init_models()
    want = {"t3", "s3gen", "ve"} | ({"s3tok"} if arch != "ref" else set())
    assert set(teng.params) == want


def test_dit_full_config_follows_the_env(monkeypatch):
    """EngineConfig.full() under CHATTERBOX_S3GEN_ARCH=dit: the published
    widths of the DiT and S3Tok, no ref config; "ref" is the default."""
    monkeypatch.setenv("CHATTERBOX_S3GEN_ARCH", "dit")
    cfg = EngineConfig.full()
    jcfg = JEngineConfig.full()
    assert cfg.s3gen_arch == "dit" and cfg.s3gen_ref is None and cfg.gen is cfg.s3gen
    import dataclasses
    assert dataclasses.asdict(cfg.s3gen) == dataclasses.asdict(jcfg.s3gen)
    assert dataclasses.asdict(cfg.s3tok) == dataclasses.asdict(jcfg.s3tok)
    monkeypatch.delenv("CHATTERBOX_S3GEN_ARCH")
    assert EngineConfig.full().s3gen_arch == "ref"


@pytest.fixture(scope="module")
def tiny_engine(per_request):
    return per_request[2]


def test_dit_empty_text(tiny_engine):
    assert asyncio.run(_collect(tiny_engine, CancellationToken(), text="   ",
                                request_id="dit-empty")) == b""


def test_dit_cancellation(tiny_engine):
    """Cancelling after the first chunk of PCM ends the stream early."""
    async def run():
        token = CancellationToken()
        received = []
        async for chunk in tiny_engine.stream(
                **{**REQUEST, "text": "One sentence. " * 10, "output_format": "raw_pcm",
                   "synthesis_temperature": 0.8, "text_processing_chunk_size": 30,
                   "request_id": "dit-cancel"}, cancellation_token=token):
            received.append(chunk)
            token.cancel()
        return received

    received = asyncio.run(run())
    assert len(received) >= 1
    assert tiny_engine.request_stats["dit-cancel"]["chunks"] > len(
        tiny_engine.request_stats["dit-cancel"]["t3_tokens"])
