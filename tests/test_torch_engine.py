"""The port's engine end to end on the CPU, against the JAX engine.

Both engines serve EngineConfig.tiny_ref() with the same parameters (the JAX
engine's random init, converted) and the same seeded default voice
(``conds.pt`` in a temporary MODEL_PATH), with no CFM prompt cache, on both
serving paths: per request (MAX_DECODE_SLOTS=1) and batched
(MAX_DECODE_SLOTS=4: the continuous-batching decoder and the S3Gen
micro-batcher). Greedy requests are sent to both with the arguments the HTTP
handler passes; the WAVs must be valid and hold the same number of samples
(the noise differs — threefry against the port's generators — so the samples
themselves are not compared; the modules' numerics are held by the other
test_torch_* files).
"""
import asyncio

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tree_to_np

from chatterbox_tpu.config import reset_config_cache
from chatterbox_tpu.runtime import CancellationToken as JToken
from chatterbox_tpu.runtime import EngineConfig as JEngineConfig
from chatterbox_tpu.runtime import TTSEngine as JTTSEngine
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.runtime.cancellation import CancellationToken
from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine
from chatterbox_tpu_torch.runtime.loader import load_default_conds

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


def write_conds(path, spk_dim, n_prompt=6, n_feat=14, seed=7):
    """A seeded conds.pt in the reference format."""
    rng = np.random.default_rng(seed)
    t3 = {
        "speaker_emb": torch.tensor(rng.standard_normal((1, spk_dim)), dtype=torch.float32),
        "cond_prompt_speech_tokens": torch.tensor(rng.integers(0, 6561, (1, n_prompt))),
        "emotion_adv": 0.5 * torch.ones(1, 1, 1),
    }
    gen = {
        "prompt_token": torch.tensor(rng.integers(0, 6561, (1, n_prompt))),
        "prompt_token_len": torch.tensor([n_prompt]),
        "prompt_feat": torch.tensor(rng.standard_normal((1, n_feat, 80)), dtype=torch.float32),
        "prompt_feat_len": None,
        "embedding": torch.tensor(rng.standard_normal((1, 192)), dtype=torch.float32),
    }
    torch.save({"t3": t3, "gen": gen}, path)


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
    monkeypatch.setenv("CHATTERBOX_CFM_STREAM", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 6"):
        TTSEngine(EngineConfig.tiny_ref(), device="cpu")
    monkeypatch.setenv("CHATTERBOX_CFM_STREAM", "0")
    monkeypatch.setenv("CHATTERBOX_CFM_PROMPT_CACHE", "step")
    with pytest.raises(NotImplementedError, match="prompt cache"):
        TTSEngine(EngineConfig.tiny_ref(), device="cpu")
    monkeypatch.setenv("CHATTERBOX_CFM_PROMPT_CACHE", "0")
    monkeypatch.setenv("CHATTERBOX_OVERLAP_WINDOW_TOKENS", "64")
    with pytest.raises(NotImplementedError, match="re-synthesis window"):
        TTSEngine(EngineConfig.tiny_ref(), device="cpu")


def test_missing_conds_names_voice_cloning(env, monkeypatch, tmp_path):
    monkeypatch.setenv("MODEL_PATH", str(tmp_path))
    eng = TTSEngine(EngineConfig.tiny_ref(), device="cpu")
    with pytest.raises(FileNotFoundError, match="voice cloning"):
        asyncio.run(eng.ainit())
    assert eng.get_initialization_status()["state"] == "error"


def test_no_cuda_and_no_device_raises(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTSEngine(EngineConfig.tiny_ref())
