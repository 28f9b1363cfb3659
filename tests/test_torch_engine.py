"""The port's engine end to end on the CPU, against the JAX engine.

Both engines serve EngineConfig.tiny_ref() with the same parameters (the JAX
engine's random init, converted) and the same seeded default voice
(``conds.pt`` in a temporary MODEL_PATH) on both serving paths: per request
(MAX_DECODE_SLOTS=1) and batched (MAX_DECODE_SLOTS=4: the continuous-batching
decoder and the S3Gen micro-batcher); first with the CFM prompt cache off
(CHATTERBOX_CFM_PROMPT_CACHE=0, the uncached path), then with the JAX
package's defaults (the prompt cache in "step" mode, and streaming CFM on
the batched path). Both engines' serving metrics (``runtime.metrics``) are
compared too, and so are their voices: the neutral default voice when
``conds.pt`` is absent, and a voice cloned from a WAV of the voice store,
served on both paths. Greedy requests are sent to both with the arguments the HTTP
handler passes; the WAVs must be valid and hold the same number of samples
(the noise differs — threefry against the port's generators — so the samples
themselves are not compared; the modules' numerics are held by the other
test_torch_* files).
"""
import asyncio

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
from chatterbox_tpu_torch.runtime.loader import load_default_conds

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
    request_id="port-parity",
)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_engine")
    (tmp / "models").mkdir()
    write_conds(tmp / "models" / "conds.pt", spk_dim=32)
    mp = pytest.MonkeyPatch()
    for k, v in {"MODEL_PATH": str(tmp / "models"), "VOICES_DIR": str(tmp / "voices"),
                 "PRELOADED_VOICES_DIR": str(tmp / "preloaded"), "MAX_DECODE_SLOTS": "1",
                 "CHATTERBOX_CFM_PROMPT_CACHE": "0"}.items():
        mp.setenv(k, v)
    reset_config_cache()
    yield tmp
    mp.undo()
    reset_config_cache()


async def _collect(engine, token, **kw):
    out = b""
    async for chunk in engine.stream(**{**REQUEST, **kw}, cancellation_token=token):
        out += chunk
    return out


@pytest.fixture(scope="module")
def served(env):
    jeng = JTTSEngine(JEngineConfig.tiny_ref(), seed=3)
    asyncio.run(jeng.ainit())
    jwav = asyncio.run(_collect(jeng, JToken()))
    params = {k: convert_params(jax_tree_to_np(jeng.params[k]), "cpu") for k in ("t3", "s3gen")}
    jeng.shutdown()
    teng = TTSEngine(EngineConfig.tiny_ref(), seed=3, device="cpu", params=params)
    asyncio.run(teng.ainit())
    twav = asyncio.run(_collect(teng, CancellationToken()))
    return jwav, twav, teng


# three concurrent greedy requests for the batched path: one spans two chunks
BATCHED = [
    dict(text="Hello there. This is a test of the port.", request_id="batched-0"),
    dict(text="A short one.", request_id="batched-1"),
    dict(text="Three requests share the decoder.", request_id="batched-2"),
]


async def _collect_concurrently(engine, token_cls):
    return await asyncio.gather(*[_collect(engine, token_cls(), **kw) for kw in BATCHED])


@pytest.fixture(scope="module")
def served_batched(env):
    mp = pytest.MonkeyPatch()
    mp.setenv("MAX_DECODE_SLOTS", "4")
    mp.setenv("CHATTERBOX_PRECOMPILE", "0")
    reset_config_cache()
    try:
        jeng = JTTSEngine(JEngineConfig.tiny_ref(), seed=3)
        asyncio.run(jeng.ainit())
        jwavs = asyncio.run(_collect_concurrently(jeng, JToken))
        params = {k: convert_params(jax_tree_to_np(jeng.params[k]), "cpu") for k in ("t3", "s3gen")}
        jeng.shutdown()
        teng = TTSEngine(EngineConfig.tiny_ref(), seed=3, device="cpu", params=params)
        asyncio.run(teng.ainit())
        twavs = asyncio.run(_collect_concurrently(teng, CancellationToken))
        seen = (teng.decoder.max_active_seen, teng.s3gen_scheduler.max_batch_seen)
        teng.shutdown()
    finally:
        mp.undo()
        reset_config_cache()
    return jwavs, twavs, teng, seen


def test_greedy_request_matches_jax_engine_sample_count(served):
    jwav, twav, _ = served
    assert twav[:4] == b"RIFF" and twav[8:12] == b"WAVE"
    assert twav[:44] == jwav[:44]
    assert len(twav) > 44
    assert len(twav) == len(jwav)
    pcm = np.frombuffer(twav[44:], dtype="<i2")
    assert np.abs(pcm).max() > 0


def _check_samples_follow_tokens(wav, stats, teng, fade_ms):
    assert len(stats["t3_tokens"]) == stats["chunks"]
    spt = teng.cfg.gen.samples_per_token
    assert stats["synth_samples"] == sum(n + 1 for n in stats["t3_tokens"]) * spt, stats
    fade = int(teng.sr * fade_ms / 1000)
    seams, rest = divmod(stats["synth_samples"] - stats["samples"], fade)
    assert rest == 0 and 0 <= seams < stats["slices"], stats
    assert (len(wav) - 44) // 2 == stats["samples"]


def test_samples_follow_tokens(served):
    """Full overlap synthesises (kept tokens + the appended EOS code) ×
    samples per token for every text chunk; each crossfaded seam then merges
    fade_len samples of two slices into one."""
    _, twav, teng = served
    stats = teng.request_stats[REQUEST["request_id"]]
    assert stats["chunks"] >= 2
    _check_samples_follow_tokens(twav, stats, teng, REQUEST["crossfade_duration_milliseconds"])


def test_batched_requests_match_jax_engine_sample_counts(served_batched):
    """Three concurrent greedy requests through both engines' batched paths:
    equal WAV lengths, request by request, and the port really batched."""
    jwavs, twavs, teng, (max_active, max_batch) = served_batched
    for jwav, twav in zip(jwavs, twavs):
        assert twav[:44] == jwav[:44]
        assert len(twav) == len(jwav) > 44
        assert np.abs(np.frombuffer(twav[44:], dtype="<i2")).max() > 0
    assert teng.request_stats["batched-0"]["chunks"] >= 2
    assert max_active >= 2 and max_batch >= 1, (max_active, max_batch)


def test_batched_samples_follow_tokens(served_batched):
    _, twavs, teng, _ = served_batched
    for kw, twav in zip(BATCHED, twavs):
        stats = teng.request_stats[kw["request_id"]]
        _check_samples_follow_tokens(twav, stats, teng, REQUEST["crossfade_duration_milliseconds"])
        assert stats["t3_steps"] > 0 and stats["t3_s"] > 0


def test_default_voice_fields(env):
    raw = load_default_conds(env / "models" / "conds.pt")
    assert raw["speaker_emb"].shape == (1, 32)
    assert raw["prompt_feat"].shape == (1, 14, 80)
    assert raw["prompt_feat_len"] == 14 and raw["prompt_token_len"] == 6
    assert raw["emotion_adv"] == pytest.approx(0.5)


def test_unported_settings_raise(env, monkeypatch):
    """The CFM prompt cache (every mode), streaming CFM, the bounded
    re-synthesis window and now progressive slices are all accepted."""
    for name, value in (("CHATTERBOX_CFM_STREAM", "1"), ("CHATTERBOX_CFM_PROMPT_CACHE", "step"),
                        ("CHATTERBOX_CFM_PROMPT_CACHE", "static"),
                        ("CHATTERBOX_OVERLAP_WINDOW_TOKENS", "64")):
        monkeypatch.setenv(name, value)
        TTSEngine(EngineConfig.tiny_ref(), device="cpu")
    eng = TTSEngine(EngineConfig.tiny_ref(), device="cpu")
    assert eng._cfm_cache_mode() == "static" and eng.overlap_window == 64
    monkeypatch.setenv("CHATTERBOX_PROGRESSIVE_SLICES", "1")
    TTSEngine(EngineConfig.tiny_ref(), device="cpu")
    assert teng_mod._progressive_enabled()


def test_default_settings_are_the_jax_packages(monkeypatch):
    """With nothing set, both engines serve the CFM prompt cache in "step"
    mode; "0" turns it off in both."""
    from chatterbox_tpu.runtime.engine import TTSEngine as J

    monkeypatch.delenv("CHATTERBOX_CFM_PROMPT_CACHE", raising=False)
    jeng = J.__new__(J)
    jeng.cfg = JEngineConfig.tiny_ref()
    teng = TTSEngine.__new__(TTSEngine)
    teng.cfg = EngineConfig.tiny_ref()
    assert teng._cfm_cache_mode() == jeng._cfm_cache_mode() == "step"
    monkeypatch.setenv("CHATTERBOX_CFM_PROMPT_CACHE", "0")
    assert teng._cfm_cache_mode() == jeng._cfm_cache_mode() == "0"


def _metrics_delta(before, after):
    """Requests, tokens and the stages that ran between two snapshots."""
    stages = {n for n, v in after["stages"].items()
              if v["count"] > before["stages"].get(n, {"count": 0})["count"]}
    return (after["requests"]["total"] - before["requests"]["total"],
            after["tokens_generated"] - before["tokens_generated"], stages)


def _serve_defaults(slots: str, **env):
    """Both engines with the JAX package's S3Gen defaults (prompt cache,
    streaming CFM), or those with ``env`` set on top, at
    MAX_DECODE_SLOTS=``slots``: the three BATCHED requests concurrently →
    (jax wavs, port wavs, port engine, jax metrics delta, port metrics
    delta)."""
    from chatterbox_tpu.runtime.metrics import metrics as jmetrics
    from chatterbox_tpu_torch.runtime.metrics import metrics as tmetrics

    mp = pytest.MonkeyPatch()
    mp.delenv("CHATTERBOX_CFM_PROMPT_CACHE", raising=False)
    mp.delenv("CHATTERBOX_CFM_STREAM", raising=False)
    mp.setenv("MAX_DECODE_SLOTS", slots)
    mp.setenv("CHATTERBOX_PRECOMPILE", "0")
    for name, value in env.items():
        mp.setenv(name, value)
    reset_config_cache()
    try:
        jeng = JTTSEngine(JEngineConfig.tiny_ref(), seed=3)
        asyncio.run(jeng.ainit())
        m0 = jmetrics.snapshot()
        jwavs = asyncio.run(_collect_concurrently(jeng, JToken))
        jdelta = _metrics_delta(m0, jmetrics.snapshot())
        params = {k: convert_params(jax_tree_to_np(jeng.params[k]), "cpu") for k in ("t3", "s3gen")}
        jeng.shutdown()
        teng = TTSEngine(EngineConfig.tiny_ref(), seed=3, device="cpu", params=params)
        asyncio.run(teng.ainit())
        m0 = tmetrics.snapshot()
        twavs = asyncio.run(_collect_concurrently(teng, CancellationToken))
        tdelta = _metrics_delta(m0, tmetrics.snapshot())
        # ainit built the default voice's prompt cache, which served the requests
        assert list(teng._cfm_cache_lru) == ["default"]
        teng.shutdown()
    finally:
        mp.undo()
        reset_config_cache()
    return jwavs, twavs, teng, jdelta, tdelta


@pytest.fixture(scope="module")
def served_defaults(env):
    return _serve_defaults("4")


@pytest.fixture(scope="module")
def served_defaults_per_request(env):
    return _serve_defaults("1")


@pytest.mark.parametrize("path", ["batched", "per_request"])
def test_default_serving_matches_jax_sample_counts(request, path):
    """With no S3Gen setting, the batched path serves the prompt cache and
    streaming CFM (each chunk's slices after the first solve only their new
    tokens), the per-request path the prompt cache alone, in both engines:
    equal WAV lengths, request by request."""
    jwavs, twavs, teng, _, _ = request.getfixturevalue(
        "served_defaults" if path == "batched" else "served_defaults_per_request")
    for kw, jwav, twav in zip(BATCHED, jwavs, twavs):
        assert twav[:44] == jwav[:44]
        assert len(twav) == len(jwav) > 44
        assert np.abs(np.frombuffer(twav[44:], dtype="<i2")).max() > 0
        stats = teng.request_stats[kw["request_id"]]
        _check_samples_follow_tokens(twav, stats, teng, REQUEST["crossfade_duration_milliseconds"])
        assert stats["fallbacks"] == 0
        if path == "batched":
            assert stats["streamed"] == stats["slices"] > 0
        else:
            assert stats["streamed"] == 0


# a bounded re-synthesis window of 12 tokens: with 8-token slices, every
# slice from the third on drops left context (streaming, which never drops,
# is off so that the batched path re-solves too)
WINDOW = {"CHATTERBOX_OVERLAP_WINDOW_TOKENS": "12", "CHATTERBOX_CFM_STREAM": "0"}


@pytest.mark.parametrize("path", ["batched", "per_request"])
def test_overlap_window_matches_jax_sample_counts(env, path):
    """CHATTERBOX_OVERLAP_WINDOW_TOKENS on both paths (prompt cache on):
    slices drop left context and the port emits the JAX engine's WAV
    lengths, request by request, with every slice's samples following its
    tokens (a misaligned window would cut or repeat audio). The batched
    path's excitation row is shifted by the drop in the scheduler
    (tests/test_torch_s3gen_scheduler.py::test_state_roundtrip_and_shift)."""
    jwavs, twavs, teng, _, _ = _serve_defaults("4" if path == "batched" else "1", **WINDOW)
    assert teng.overlap_window == 12
    for kw, jwav, twav in zip(BATCHED, jwavs, twavs):
        assert twav[:44] == jwav[:44]
        assert len(twav) == len(jwav) > 44
        stats = teng.request_stats[kw["request_id"]]
        _check_samples_follow_tokens(twav, stats, teng, REQUEST["crossfade_duration_milliseconds"])
        assert stats["streamed"] == 0
    assert sum(teng.request_stats[kw["request_id"]]["window_drops"] for kw in BATCHED) > 0


@pytest.mark.parametrize("path", ["batched", "per_request"])
def test_engine_records_metrics_like_jax(request, path):
    """The engine records what the JAX engine records: one record_request
    per request, the tokens of every slice, and the same host and device
    stages (s3gen_prep_host, s3gen_stitch_host and, batched, the decoder's
    and the micro-batcher's stages with s3gen_stack_host; per request,
    s3gen_single_device)."""
    *_, jdelta, tdelta = request.getfixturevalue(
        "served_defaults" if path == "batched" else "served_defaults_per_request")
    assert tdelta == jdelta
    assert tdelta[0] == len(BATCHED) and tdelta[1] > 0
    want = {"s3gen_prep_host", "s3gen_stitch_host"}
    want |= ({"s3gen_stack_host", "s3gen_device", "t3_decode_device", "t3_prefill_device"}
             if path == "batched" else {"s3gen_single_device"})
    assert tdelta[2] == want


def _assert_conds_close(jconds, tconds):
    """The port's conditionals against the JAX engine's: the T3 lanes and the
    ref dict's floats within REL of their largest magnitude, tokens and
    lengths exactly."""
    assert_trees_close(jconds.t3_cond_lanes, tconds.t3_cond_lanes, REL)
    for key in ("prompt_tokens", "prompt_len", "prompt_mel_len"):
        np.testing.assert_array_equal(to_np(tconds.gen_ref[key]),
                                      np.asarray(jconds.gen_ref[key]))
    assert_trees_close({k: jconds.gen_ref[k] for k in ("spk_emb", "prompt_mel")},
                       {k: tconds.gen_ref[k] for k in ("spk_emb", "prompt_mel")}, REL)


def _converted(jeng):
    return {k: convert_params(jax_tree_to_np(jeng.params[k]), "cpu") for k in ("t3", "s3gen", "ve")}


def test_neutral_default_voice_matches_jax(env, monkeypatch, tmp_path):
    """With no conds.pt both engines start and build the neutral default
    voice from 2 s of zeros: the same conditionals."""
    monkeypatch.setenv("MODEL_PATH", str(tmp_path))
    reset_config_cache()
    jeng = JTTSEngine(JEngineConfig.tiny_ref(), seed=3)
    asyncio.run(jeng.ainit())
    teng = TTSEngine(EngineConfig.tiny_ref(), seed=3, device="cpu", params=_converted(jeng))
    asyncio.run(teng.ainit())
    assert teng.get_initialization_status()["state"] == "ready"
    _assert_conds_close(jeng.voice_cache["default"], teng.voice_cache["default"])
    jeng.shutdown()


def test_unreadable_conds_falls_back_to_neutral(env, monkeypatch, tmp_path, caplog):
    """An unreadable conds.pt is reported and the neutral voice serves."""
    (tmp_path / "conds.pt").write_bytes(b"not a torch archive")
    monkeypatch.setenv("MODEL_PATH", str(tmp_path))
    eng = TTSEngine(EngineConfig.tiny_ref(), device="cpu")
    eng._init_models()
    with caplog.at_level("WARNING"):
        conds = eng._default_conditionals()
    assert "Failed to read" in caplog.text and "neutral default voice" in caplog.text
    want = teng_mod._cond_fn(eng.params, eng.cfg, *teng_mod.neutral_inputs(), torch.tensor([0.5]))
    assert torch.equal(conds.t3_cond_lanes, want[0])
    assert all(torch.equal(conds.gen_ref[k], v) for k, v in want[1].items())


VOICE = "clone-me.wav"


def _write_voice(env) -> str:
    """A seeded 2.5 s voice at 22.05 kHz (16-bit) in the user voice store."""
    rng = np.random.default_rng(21)
    t = np.arange(55125) / 22050.0
    wav = (0.3 * np.sin(2 * np.pi * 150.0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t))
           + 0.03 * rng.standard_normal(t.size))
    (env / "voices").mkdir(exist_ok=True)
    path = env / "voices" / VOICE
    write_wav(str(path), wav, 22050)
    return str(path)


@pytest.fixture(scope="module")
def cloned(env):
    """Both engines on the per-request path with the prompt cache ("step"):
    the voice cloned by prepare_conditionals, then one greedy request in it.
    The JAX engine resamples with scipy too (its native resampler off)."""
    import chatterbox_tpu.native as jnative

    path = _write_voice(env)
    mp = pytest.MonkeyPatch()
    mp.delenv("CHATTERBOX_CFM_PROMPT_CACHE", raising=False)
    mp.setattr(jnative, "resample_poly", lambda *a: None)
    reset_config_cache()
    try:
        jeng = JTTSEngine(JEngineConfig.tiny_ref(), seed=3)
        asyncio.run(jeng.ainit())
        jeng.prepare_conditionals(path)
        jwav = asyncio.run(_collect(jeng, JToken(), voice_id=VOICE, request_id="cloned"))
        teng = TTSEngine(EngineConfig.tiny_ref(), seed=3, device="cpu", params=_converted(jeng))
        asyncio.run(teng.ainit())
        teng.prepare_conditionals(path)
        tconds = teng.voice_cache[VOICE]
        teng.voice_cache.pop(VOICE)   # the request clones it again through the voice store
        twav = asyncio.run(_collect(teng, CancellationToken(), voice_id=VOICE, request_id="cloned"))
        jconds = jeng.voice_cache[VOICE]
        jeng.shutdown()
    finally:
        mp.undo()
        reset_config_cache()
    return jconds, tconds, jwav, twav, teng


def test_prepare_conditionals_matches_jax(cloned):
    jconds, tconds, *_ = cloned
    _assert_conds_close(jconds, tconds)


def test_cloned_voice_serves_like_jax_per_request(cloned):
    """stream(voice_id=...) clones the voice from the store, builds its own
    CFM prompt cache and serves the JAX engine's sample count."""
    _, tconds, jwav, twav, teng = cloned
    assert twav[:44] == jwav[:44] and len(twav) == len(jwav) > 44
    assert np.abs(np.frombuffer(twav[44:], dtype="<i2")).max() > 0
    assert list(teng._cfm_cache_lru) == ["default", VOICE]
    _assert_conds_close(tconds, teng.voice_cache[VOICE])
    stats = teng.request_stats["cloned"]
    _check_samples_follow_tokens(twav, stats, teng, REQUEST["crossfade_duration_milliseconds"])


def test_cloned_voice_dtypes_match_default_voice(cloned):
    """A cloned voice's ref dict has the dtypes of the conds.pt voice's, so
    the S3Gen micro-batcher can stack the two: one batched call with a job
    of each runs."""
    from chatterbox_tpu_torch.runtime.s3gen_scheduler import S3GenScheduler, _Job

    *_, teng = cloned
    default, voice = teng.voice_cache["default"].gen_ref, teng.voice_cache[VOICE].gen_ref
    assert {k: (v.dtype, v.shape) for k, v in default.items()} == \
        {k: (v.dtype, v.shape) for k, v in voice.items()}
    sched = S3GenScheduler(teng.params["s3gen"], teng.cfg.s3gen_ref, state_tokens=64)
    toks = np.full(16, teng.cfg.s3gen_ref.vocab_size, np.int64)
    toks[:10] = np.arange(10) * 37
    jobs = [_Job(toks, 10, ref, None, 0, seed, 0, 0, None) for seed, ref in enumerate((default, voice))]
    with torch.inference_mode():
        tails, *_ = sched._run_batch(jobs)
    assert tails.shape[0] == 2 and np.isfinite(tails).all()


def test_cloned_voice_batched_like_jax(env):
    """The batched path with the S3Gen defaults (prompt cache, streaming
    CFM): three concurrent requests, two in the cloned voice and one in the
    default voice; both engines give the same sample counts, request by
    request, and the cloned voice gets its own prompt cache."""
    import chatterbox_tpu.native as jnative

    _write_voice(env)
    reqs = [dict(kw, voice_id=v) for kw, v in zip(BATCHED, [VOICE, None, VOICE])]
    mp = pytest.MonkeyPatch()
    mp.delenv("CHATTERBOX_CFM_PROMPT_CACHE", raising=False)
    mp.setenv("MAX_DECODE_SLOTS", "4")
    mp.setattr(jnative, "resample_poly", lambda *a: None)
    reset_config_cache()

    async def serve(engine, token_cls):
        return await asyncio.gather(*[_collect(engine, token_cls(), **kw) for kw in reqs])

    try:
        jeng = JTTSEngine(JEngineConfig.tiny_ref(), seed=3)
        asyncio.run(jeng.ainit())
        jwavs = asyncio.run(serve(jeng, JToken))
        teng = TTSEngine(EngineConfig.tiny_ref(), seed=3, device="cpu", params=_converted(jeng))
        jeng.shutdown()
        asyncio.run(teng.ainit())
        twavs = asyncio.run(serve(teng, CancellationToken))
        lru = list(teng._cfm_cache_lru)
        teng.shutdown()
    finally:
        mp.undo()
        reset_config_cache()
    for kw, jwav, twav in zip(reqs, jwavs, twavs):
        assert twav[:44] == jwav[:44] and len(twav) == len(jwav) > 44
        stats = teng.request_stats[kw["request_id"]]
        assert stats["streamed"] == stats["slices"] > 0
    assert lru == ["default", VOICE]


@pytest.fixture
def tiny_engine(env):
    eng = TTSEngine(EngineConfig.tiny_ref(), device="cpu")
    asyncio.run(eng.ainit())
    return eng


@pytest.mark.parametrize("voice_id", ["no-such-voice.wav", "../models/conds.pt", "/etc/hostname"])
def test_unknown_voice_raises(tiny_engine, voice_id):
    with pytest.raises(FileNotFoundError, match="not found"):
        asyncio.run(_collect(tiny_engine, CancellationToken(), voice_id=voice_id))
    assert voice_id not in tiny_engine.voice_cache


def test_clear_voice_cache_drops_the_voice(env, tiny_engine, monkeypatch):
    """clear_voice_cache drops the voice's conditionals, its CFM prompt cache
    and its streaming template; the next use clones it again."""
    monkeypatch.setenv("CHATTERBOX_CFM_PROMPT_CACHE", "step")
    eng = tiny_engine
    path = _write_voice(env)
    eng.prepare_conditionals(path)
    cache = eng._cfm_cache_for(VOICE, eng.voice_cache[VOICE])
    eng._stream_state0(VOICE, cache)
    assert VOICE in eng._cfm_cache_lru and VOICE in eng._stream0
    eng.clear_voice_cache(VOICE)
    assert VOICE not in eng.voice_cache and VOICE not in eng._cfm_cache_lru
    assert VOICE not in eng._stream0
    asyncio.run(eng._get_conds(VOICE, "again"))
    assert VOICE in eng.voice_cache


def test_no_cuda_and_no_device_raises(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTSEngine(EngineConfig.tiny_ref())
