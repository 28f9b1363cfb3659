"""The port's engine end to end on the CPU, against the JAX engine.

Both engines serve EngineConfig.tiny_ref() with the same parameters (the JAX
engine's random init, converted) and the same seeded default voice
(``conds.pt`` in a temporary MODEL_PATH), on the per-request path the port
implements (MAX_DECODE_SLOTS=1, no CFM prompt cache). A greedy request is
sent to both with the arguments the HTTP handler passes; the WAVs must be
valid and hold the same number of samples (the noise differs — threefry
against Philox — so the samples themselves are not compared; the modules'
numerics are held by the other test_torch_* files).
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


async def _collect(engine, token):
    out = b""
    async for chunk in engine.stream(**REQUEST, cancellation_token=token):
        out += chunk
    return out


@pytest.fixture(scope="module")
def served(env):
    jeng = JTTSEngine(JEngineConfig.tiny_ref(), seed=3)
    asyncio.run(jeng.ainit())
    jwav = asyncio.run(_collect(jeng, JToken()))
    params = {k: convert_params(jax_tree_to_np(jeng.params[k])) for k in ("t3", "s3gen")}
    jeng.shutdown()
    teng = TTSEngine(EngineConfig.tiny_ref(), seed=3, device="cpu", params=params)
    asyncio.run(teng.ainit())
    twav = asyncio.run(_collect(teng, CancellationToken()))
    return jwav, twav, teng


def test_greedy_request_matches_jax_engine_sample_count(served):
    jwav, twav, _ = served
    assert twav[:4] == b"RIFF" and twav[8:12] == b"WAVE"
    assert twav[:44] == jwav[:44]
    assert len(twav) > 44
    assert len(twav) == len(jwav)
    pcm = np.frombuffer(twav[44:], dtype="<i2")
    assert np.abs(pcm).max() > 0


def test_samples_follow_tokens(served):
    """Full overlap synthesises (kept tokens + the appended EOS code) ×
    samples per token for every text chunk; each crossfaded seam then merges
    fade_len samples of two slices into one."""
    _, twav, teng = served
    stats = teng.request_stats[REQUEST["request_id"]]
    assert stats["chunks"] >= 2 and len(stats["t3_tokens"]) == stats["chunks"]
    spt = teng.cfg.gen.samples_per_token
    assert stats["synth_samples"] == sum(n + 1 for n in stats["t3_tokens"]) * spt, stats
    fade = int(teng.sr * REQUEST["crossfade_duration_milliseconds"] / 1000)
    seams, rest = divmod(stats["synth_samples"] - stats["samples"], fade)
    assert rest == 0 and 0 <= seams < stats["slices"], stats
    assert (len(twav) - 44) // 2 == stats["samples"]


def test_default_voice_fields(env):
    raw = load_default_conds(env / "models" / "conds.pt")
    assert raw["speaker_emb"].shape == (1, 32)
    assert raw["prompt_feat"].shape == (1, 14, 80)
    assert raw["prompt_feat_len"] == 14 and raw["prompt_token_len"] == 6
    assert raw["emotion_adv"] == pytest.approx(0.5)


def test_unported_settings_raise(env, monkeypatch):
    monkeypatch.setenv("MAX_DECODE_SLOTS", "4")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 4"):
        TTSEngine(EngineConfig.tiny_ref(), device="cpu")
    monkeypatch.setenv("MAX_DECODE_SLOTS", "1")
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
