"""The port's engine against the JAX engine end to end, WAV against WAV, on
the CPU.

Both engines serve the same greedy requests, with the HTTP handler's
arguments, in the default voice (the seeded ``conds.pt``; the DiT builds the
neutral voice), from the same parameters: the JAX engine's random init, its
S3Gen conditioned as the CPU tests condition it (HiFT's output conv,
``conditioned_s3gen_params``; the DiT's AdaLN-zero leaves and vocoder
resblocks, ``conditioned_dit_params``) in both packages, since a random
vocoder turns 1e-7 of mel into 3e-2 of waveform. Four cases:
``EngineConfig.tiny_ref()`` (the main path) and ``tiny()`` (the DiT), each on
the per-request path (MAX_DECODE_SLOTS=1) and the batched one
(MAX_DECODE_SLOTS=4, two concurrent requests), with the serving defaults (the
CFM prompt cache in "step" mode, streaming CFM on the batched path), and
queues that hold every slice of a request (``QUEUE_ROOM``).

The port draws its noise through two hooks, ``engine._draw_noise`` and
``engine._prompt_noise``; the test replaces them on the port's engine with
the JAX engine's own draws: the key
``fold_in(fold_in(PRNGKey(1234), _stable_seed(request_id)), chunk_idx)`` of
``chatterbox_tpu/runtime/engine.py``, and from it the CFM, HiFT and NSF draws
of the ref S3Gen (``jax_s3gen_noise``) or the DiT's flow and source draws;
the prompt cache's noise is JAX's ``PRNGKey(777)`` buffer (``prompt_noise``).
The hook finds the request and chunk from the seed the port's engine gives
the generator.
Nothing in either package changes.

Held: equal sample counts; MCD and LSD (``chatterbox_tpu_torch.audio.quality``)
of each port WAV against its JAX WAV at no more than YARDSTICK_SHARE of the
yardstick, the MCD / LSD between two JAX runs of the same request under two
noise keys (another request id: greedy tokens do not depend on it), and
under MCD_DB / LSD_DB; the first ISTFT frame of PCM within FRAME_TOL, and
the whole waveform within WAVE_TOL. Measured on the CPU: MCD 0.0009-0.0011
dB and LSD 0.0005-0.0006 dB (ref), 0.0027-0.0032 and 0.0019-0.0022 dB (DiT),
against yardsticks of 11.0-19.6 / 6.1-6.8 dB (ref) and 6.2-6.6 / 3.9-4.1 dB
(DiT); every sample of the ref WAVs within one PCM16 step, the DiT's within
17 (its excitation integrates a phase, where float order shows).
"""
import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import (conditioned_dit_params, conditioned_s3gen_params,
                                jax_s3gen_noise, jax_tree_to_np, prompt_noise, to_t,
                                write_conds)

import jax
import jax.numpy as jnp

from chatterbox_tpu.config import reset_config_cache
from chatterbox_tpu.runtime import CancellationToken as JToken
from chatterbox_tpu.runtime import EngineConfig as JEngineConfig
from chatterbox_tpu.runtime import TTSEngine as JTTSEngine
from chatterbox_tpu.runtime.engine import _stable_seed as jstable_seed
from chatterbox_tpu_torch.audio.quality import log_spectral_distance, mel_cepstral_distortion
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.runtime import engine as teng_mod
from chatterbox_tpu_torch.runtime.cancellation import CancellationToken
from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine

REQUEST = dict(output_format="wav", voice_id=None, cfg_guidance_weight=0.5,
               synthesis_temperature=0.0,   # greedy: both engines take the same tokens
               text_processing_chunk_size=20, audio_tokens_per_slice=8,
               remove_trailing_milliseconds=0, remove_leading_milliseconds=0,
               chunk_overlap_strategy="full", crossfade_duration_milliseconds=10)
TEXTS = ["Hello there. This is a test of the port.", "A short one."]
MAX_CHUNKS = 8
# room in both engines' token and PCM queues for every slice of a request.
# A producer that ends waits 10 s for room for its end marker, then drops
# the oldest queued slice to make room (both engines do so by design); on a
# loaded host the JAX engine's consumer can stall that long while XLA
# compiles an S3Gen bucket, and one request then came out a slice short
# (1132 bytes against 1164). With room the marker never waits.
QUEUE_ROOM = 64
# parity at no more than this share of the two-key JAX yardstick, and under
# these absolute bounds (dB)
YARDSTICK_SHARE = 0.1
MCD_DB = 0.05
LSD_DB = 0.05
PCM_STEP = 1.0 / 32768.0
ISTFT_FRAME = 16              # istft_n_fft of both tiny vocoders
FRAME_TOL = 2 * PCM_STEP
WAVE_TOL = {"ref": 2 * PCM_STEP, "dit": 64 * PCM_STEP}


def _ids(prefix: str, n: int):
    return [f"{prefix}-{i}" for i in range(n)]


def _jax_key(request_id: str, chunk_idx: int):
    base = jax.random.fold_in(jax.random.PRNGKey(1234), jstable_seed(request_id))
    return jax.random.fold_in(base, chunk_idx)


def _dit_noise(jcfg, key, B, T, frames):
    """JAX's draws in the DiT's s3gen_inference, the CFM buffer padded to the
    port's ``frames`` (it reads the first (P + T)·fpt)."""
    n = (jcfg.max_prompt_tokens + T) * jcfg.frames_per_token
    cfm = jax.random.normal(key, (B, n, jcfg.n_mels), jnp.float32)
    src = jax.random.normal(jax.random.fold_in(key, 1), (B, T * jcfg.samples_per_token, 1))
    return {"cfm": torch.nn.functional.pad(to_t(cfm), (0, 0, 0, frames - n)),
            "source": to_t(src)[..., 0]}


def _inject_jax_noise(engine, jcfg, request_ids) -> dict:
    """Replace the port engine's noise draw (and the prompt cache's) by the
    JAX engine's for ``request_ids`` → the draws made, counted as they run."""
    calls = {"draws": 0, "prompt": 0}
    port_draw = engine._draw_noise
    seeds = {((1234 * 1_000_003 + teng_mod._stable_seed(rid)) & 0x7FFFFFFF) + c: (rid, c)
             for rid in request_ids for c in range(MAX_CHUNKS)}
    assert len(seeds) == len(request_ids) * MAX_CHUNKS

    def draw(cfg, batch, T, generator, device, **kw):
        rid, chunk = seeds[generator.initial_seed()]
        want = port_draw(cfg, batch, T, generator, device, **kw)   # shapes only
        key = _jax_key(rid, chunk)
        if engine.cfg.s3gen_arch == "ref":
            got = jax_s3gen_noise(jcfg.s3gen_ref, key, batch, T)
        else:
            got = _dit_noise(jcfg.s3gen, key, batch, T, want["cfm"].shape[1])
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        calls["draws"] += 1
        return got

    engine._draw_noise = draw
    port_prompt_noise = engine._prompt_noise

    def jax_prompt_noise():
        noise = port_prompt_noise()   # the shape only
        jnoise = prompt_noise(engine.cfg.s3gen_ref.flow.output_size)
        assert jnoise.shape == noise.shape
        calls["prompt"] += 1
        return jnoise

    engine._prompt_noise = jax_prompt_noise
    return calls


async def _serve(engine, token_cls, request_ids):
    async def one(text, rid):
        out = b""
        async for chunk in engine.stream(text=text, request_id=rid,
                                         cancellation_token=token_cls(), **REQUEST):
            out += chunk
        return out

    return await asyncio.gather(*[one(t, r) for t, r in zip(TEXTS, request_ids)])


def _pcm(wav: bytes) -> np.ndarray:
    assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"
    return np.frombuffer(wav[44:], "<i2").astype(np.float32) / 32768.0


CASES = {"ref-per_request": ("ref", 1), "ref-batched": ("ref", 4),
         "dit-per_request": ("dit", 1), "dit-batched": ("dit", 4)}


@pytest.fixture(scope="module", params=list(CASES))
def served(request, tmp_path_factory):
    """→ (arch, the JAX WAVs, the JAX WAVs under other noise keys, the port's
    WAVs, the port's request stats, its injected draws, the sample rate)."""
    arch, slots = CASES[request.param]
    n = 1 if slots == 1 else len(TEXTS)
    tmp = tmp_path_factory.mktemp("engine_parity")
    (tmp / "models").mkdir()
    write_conds(tmp / "models" / "conds.pt", spk_dim=32)
    mp = pytest.MonkeyPatch()
    for k, v in {"MODEL_PATH": str(tmp / "models"), "VOICES_DIR": str(tmp / "voices"),
                 "PRELOADED_VOICES_DIR": str(tmp / "preloaded"), "MAX_DECODE_SLOTS": str(slots),
                 "CHATTERBOX_PRECOMPILE": "0", "TTS_SPEECH_TOKEN_QUEUE_MAX_SIZE": str(QUEUE_ROOM),
                 "TTS_PCM_CHUNK_QUEUE_MAX_SIZE": str(QUEUE_ROOM)}.items():
        mp.setenv(k, v)
    for k in ("CHATTERBOX_S3GEN_ARCH", "CHATTERBOX_TINY_MODEL", "CHATTERBOX_CFM_PROMPT_CACHE",
              "CHATTERBOX_CFM_STREAM"):
        mp.delenv(k, raising=False)
    reset_config_cache()
    cfg, jcfg = ((c.tiny_ref() if arch == "ref" else c.tiny()) for c in (EngineConfig,
                                                                           JEngineConfig))
    if slots > 1:   # a decode cap per chunk: fewer S3Gen buckets for JAX to compile
        cfg, jcfg = (dataclasses.replace(c, max_new_tokens=24) for c in (cfg, jcfg))
    try:
        jeng = JTTSEngine(jcfg, seed=3)
        init_models = jeng._init_models

        def init_and_condition():
            init_models()
            s3 = jax_tree_to_np(jeng.params["s3gen"])
            s3 = (conditioned_s3gen_params(s3, jcfg.s3gen_ref) if arch == "ref"
                  else conditioned_dit_params(s3))
            jeng.params["s3gen"] = jax.tree.map(jnp.asarray, s3)

        jeng._init_models = init_and_condition
        asyncio.run(jeng.ainit())
        jwavs = asyncio.run(_serve(jeng, JToken, _ids("parity", n)))
        yard = asyncio.run(_serve(jeng, JToken, _ids("yardstick", n)))
        params = {k: convert_params(jax_tree_to_np(v), "cpu") for k, v in jeng.params.items()}
        jeng.shutdown()
        teng = TTSEngine(cfg, seed=3, device="cpu", params=params)
        calls = _inject_jax_noise(teng, jcfg, _ids("parity", n))
        asyncio.run(teng.ainit())
        twavs = asyncio.run(_serve(teng, CancellationToken, _ids("parity", n)))
        stats = [teng.request_stats[r] for r in _ids("parity", n)]
        teng.shutdown()
    finally:
        mp.undo()
        reset_config_cache()
    return arch, jwavs, yard, twavs, stats, calls, cfg.gen.sample_rate


def test_served_the_case_with_jax_noise(served):
    """Sample counts equal; every S3Gen call drew JAX's noise; the ref
    batched path streamed, and the ref paths built the prompt cache from
    JAX's prompt noise."""
    arch, jwavs, yard, twavs, stats, calls, sr = served
    for j, y, t in zip(jwavs, yard, twavs):
        assert len(t) == len(j) == len(y) > 44
    assert calls["draws"] >= sum(len(st["slice_tokens"]) for st in stats) > 0
    assert calls["prompt"] == (1 if arch == "ref" else 0)
    batched = len(stats) > 1
    assert all((st["streamed"] > 0) == (arch == "ref" and batched) for st in stats)


def test_wav_parity_against_two_key_yardstick(served):
    arch, jwavs, yard, twavs, stats, calls, sr = served
    for j, y, t in zip(jwavs, yard, twavs):
        j, y, t = _pcm(j), _pcm(y), _pcm(t)
        mcd, lsd = mel_cepstral_distortion(j, t, sr), log_spectral_distance(j, t, sr)
        yard_mcd, yard_lsd = mel_cepstral_distortion(j, y, sr), log_spectral_distance(j, y, sr)
        assert mcd <= min(MCD_DB, YARDSTICK_SHARE * yard_mcd), (mcd, yard_mcd)
        assert lsd <= min(LSD_DB, YARDSTICK_SHARE * yard_lsd), (lsd, yard_lsd)


def test_samples_agree(served):
    arch, jwavs, yard, twavs, stats, calls, sr = served
    for j, t in zip(jwavs, twavs):
        j, t = _pcm(j), _pcm(t)
        assert np.abs(j).max() > 10 * PCM_STEP   # not silence
        np.testing.assert_allclose(t[:ISTFT_FRAME], j[:ISTFT_FRAME], rtol=0, atol=FRAME_TOL)
        np.testing.assert_allclose(t, j, rtol=0, atol=WAVE_TOL[arch])
