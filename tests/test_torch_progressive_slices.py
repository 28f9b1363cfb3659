"""Progressive slices (``CHATTERBOX_PROGRESSIVE_SLICES=1``) in the port,
against the JAX engine: the growth rule over the whole snap ladder, and a
greedy request on the batched defaults (streaming CFM) cut into the JAX
engine's slices. Both engines serve EngineConfig.tiny_ref() with the same
parameters (the JAX engine's random init, converted) and the same seeded
default voice."""
import asyncio

import pytest

from torch_port_helpers import jax_tree_to_np, spy_slices, write_conds

from chatterbox_tpu.config import reset_config_cache
from chatterbox_tpu.runtime import CancellationToken as JToken
from chatterbox_tpu.runtime import EngineConfig as JEngineConfig
from chatterbox_tpu.runtime import TTSEngine as JTTSEngine
from chatterbox_tpu.runtime import engine as jeng_mod
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.runtime import engine as teng_mod
from chatterbox_tpu_torch.runtime.cancellation import CancellationToken
from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine
from chatterbox_tpu_torch.runtime.s3gen_scheduler import MAX_TAIL_TOKENS, STREAM_BLOCK_SNAP

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
    request_id="progressive",
)


@pytest.mark.parametrize("cap", [16, 64, 210, 1000])
def test_next_slice_target_matches_jax(cap):
    """Progressive growth over the whole snap ladder, for every slice size,
    equals the JAX engine's, and every target fits the streaming block
    ladder and the emitted tail with its EOS code."""
    assert teng_mod.SLICE_SIZE_SNAP == jeng_mod.SLICE_SIZE_SNAP
    assert teng_mod.PROGRESSIVE_SLICE_CAP == jeng_mod.PROGRESSIVE_SLICE_CAP
    for slice_size in teng_mod.SLICE_SIZE_SNAP:
        for cur in sorted(set(teng_mod.SLICE_SIZE_SNAP) | {1, 3, 7, cap}):
            got = teng_mod._next_slice_target(cur, slice_size, cap)
            assert got == jeng_mod._next_slice_target(cur, slice_size, cap), (cur, slice_size)
            if cur <= teng_mod.PROGRESSIVE_SLICE_CAP:
                assert got + 1 <= min(MAX_TAIL_TOKENS, STREAM_BLOCK_SNAP[-1])


async def _collect(engine, token):
    out = b""
    async for chunk in engine.stream(**REQUEST, cancellation_token=token):
        out += chunk
    return out


def test_progressive_slices_match_jax(tmp_path, monkeypatch):
    """On the batched defaults (streaming CFM): a three-chunk greedy request
    is cut into the JAX engine's slice sizes, chunk by chunk; later slices
    grow past the requested size, every slice streams, and the sample count
    is the JAX engine's."""
    (tmp_path / "models").mkdir()
    write_conds(tmp_path / "models" / "conds.pt", spk_dim=32)
    for k, v in {"MODEL_PATH": str(tmp_path / "models"), "VOICES_DIR": str(tmp_path / "voices"),
                 "PRELOADED_VOICES_DIR": str(tmp_path / "preloaded"), "MAX_DECODE_SLOTS": "4",
                 "CHATTERBOX_PRECOMPILE": "0", "CHATTERBOX_PROGRESSIVE_SLICES": "1"}.items():
        monkeypatch.setenv(k, v)
    for k in ("CHATTERBOX_CFM_PROMPT_CACHE", "CHATTERBOX_CFM_STREAM"):
        monkeypatch.delenv(k, raising=False)
    reset_config_cache()
    try:
        jeng = JTTSEngine(JEngineConfig.tiny_ref(), seed=3)
        asyncio.run(jeng.ainit())
        jslices = spy_slices(jeng)
        jwav = asyncio.run(_collect(jeng, JToken()))
        params = {k: convert_params(jax_tree_to_np(jeng.params[k]), "cpu")
                  for k in ("t3", "s3gen", "ve")}
        jeng.shutdown()
        teng = TTSEngine(EngineConfig.tiny_ref(), seed=3, device="cpu", params=params)
        asyncio.run(teng.ainit())
        tslices = spy_slices(teng)
        twav = asyncio.run(_collect(teng, CancellationToken()))
        teng.shutdown()
    finally:
        reset_config_cache()
    rid = REQUEST["request_id"]
    sizes = [len(t) for t in tslices[rid]]
    stats = teng.request_stats[rid]
    assert sizes == [len(t) for t in jslices[rid]] == stats["slice_tokens"]
    assert stats["chunks"] >= 2 and max(sizes) > REQUEST["audio_tokens_per_slice"]
    assert stats["fallbacks"] == 0 and stats["streamed"] == stats["slices"] > 0
    assert twav[:44] == jwav[:44] and len(twav) == len(jwav) > 44
