"""Checkpoint loading in the port, against the JAX package.

* the safetensors reader and writer (``runtime/safetensors_io.py``) against
  ``safetensors`` in both directions, byte for byte, and on malformed files;
* the converters (T3, VoiceEncoder, S3Gen ref) against the JAX ones on the
  same synthetic checkpoints, built from the key/shape schemas as the JAX
  package's own tests build theirs: every leaf bitwise equal after the
  bridge (``convert.convert_params``) in float32 and bfloat16, the same
  consumed keys and the same drift reports;
* the manifest, its diff and the full-size schemas;
* ``unconvert_params`` as the bridge's inverse, and native checkpoints
  written by either package read by the other;
* engines booted from a model directory: the port's against the JAX
  engine's on the same files, a partial checkpoint, and the faults that
  must raise.
"""
import asyncio
import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tree_to_np, spy_slices, write_conds

import jax
import jax.numpy as jnp

from chatterbox_tpu.config import reset_config_cache
from chatterbox_tpu.models.s3gen_ref import init_s3gen_ref_params as jinit_s3gen
from chatterbox_tpu.models.s3gen_ref.convert import convert_s3gen_ref as jconvert_s3gen
from chatterbox_tpu.models.t3 import init_t3_params as jinit_t3
from chatterbox_tpu.models.voice_encoder import init_voice_encoder_params as jinit_ve
from chatterbox_tpu.runtime import CancellationToken as JToken
from chatterbox_tpu.runtime import EngineConfig as JEngineConfig
from chatterbox_tpu.runtime import TTSEngine as JTTSEngine
from chatterbox_tpu.runtime import checkpoint as jckpt
from chatterbox_tpu.runtime import loader as jloader
from chatterbox_tpu.runtime import manifest as jmanifest
from chatterbox_tpu.models.s3gen_ref import schema as jschema
from chatterbox_tpu_torch.convert import convert_params, unconvert_params
from chatterbox_tpu_torch.models.s3gen_ref import schema
from chatterbox_tpu_torch.models.s3gen_ref.convert import convert_s3gen_ref
from chatterbox_tpu_torch.ops.initializers import ShapeInit
from chatterbox_tpu_torch.runtime import checkpoint as ckpt
from chatterbox_tpu_torch.runtime import manifest
from chatterbox_tpu_torch.runtime.cancellation import CancellationToken
from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine
from chatterbox_tpu_torch.runtime.loader import (
    convert_t3,
    convert_voice_encoder,
    load_reference_checkpoint,
    param_trees,
)
from chatterbox_tpu_torch.runtime.safetensors_io import load_file, read_header, save_file

CFG = EngineConfig.tiny_ref()
JCFG = JEngineConfig.tiny_ref()
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


# ------------------------------------------------------------- safetensors
def _every_dtype() -> dict:
    rng = np.random.default_rng(0)
    return {
        "f64": rng.standard_normal((3, 2)),
        "f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
        "f16": rng.standard_normal(5).astype(np.float16),
        "i64": rng.integers(-2**40, 2**40, (4,)),
        "i32": rng.integers(-2**20, 2**20, (2, 2)).astype(np.int32),
        "i16": rng.integers(-300, 300, (3,)).astype(np.int16),
        "i8": rng.integers(-100, 100, (6,)).astype(np.int8),
        "u8": rng.integers(0, 255, (2, 1)).astype(np.uint8),
        "bool": rng.integers(0, 2, (3,)).astype(bool),
        "scalar": np.asarray(7, np.int64),
        "empty": np.zeros((0, 4), np.float32),
        "unicode-ключ": np.arange(3, dtype=np.float32),
    }


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)


def test_safetensors_roundtrip_with_reference_package(tmp_path):
    """The port's files are the package's files byte for byte (the package
    orders __metadata__ keys at random, so one key there), and each side
    reads the other's, every dtype, an empty tensor and __metadata__ included."""
    from safetensors import safe_open
    from safetensors.numpy import load_file as st_load
    from safetensors.numpy import save_file as st_save

    tensors = _every_dtype()
    st_save(tensors, str(tmp_path / "theirs.safetensors"), metadata={"format": "np"})
    save_file(tensors, tmp_path / "ours.safetensors", metadata={"format": "np"})
    assert (tmp_path / "ours.safetensors").read_bytes() == (tmp_path / "theirs.safetensors").read_bytes()
    meta = {"format": "np", "note": "ünï"}
    st_save(tensors, str(tmp_path / "theirs.safetensors"), metadata=meta)
    save_file(tensors, tmp_path / "ours.safetensors", metadata=meta)
    _assert_same(load_file(tmp_path / "theirs.safetensors"), tensors)
    _assert_same(st_load(str(tmp_path / "ours.safetensors")), tensors)
    assert read_header(tmp_path / "theirs.safetensors")[0]["__metadata__"] == meta
    with safe_open(str(tmp_path / "ours.safetensors"), "np") as fh:
        assert fh.metadata() == meta
    save_file({}, tmp_path / "none.safetensors")
    assert load_file(tmp_path / "none.safetensors") == {}


def test_safetensors_bf16_widened_exactly(tmp_path):
    from safetensors.torch import save_file as st_save_torch

    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    st_save_torch({"w": x, "e": torch.zeros(0, dtype=torch.bfloat16)}, str(tmp_path / "bf16.safetensors"))
    got = load_file(tmp_path / "bf16.safetensors")
    assert got["w"].dtype == np.float32 and got["e"].shape == (0,)
    np.testing.assert_array_equal(got["w"], x.float().numpy())


def _header_file(path, header: dict, data: bytes) -> None:
    blob = json.dumps(header).encode()
    path.write_bytes(len(blob).to_bytes(8, "little") + blob + data)


@pytest.mark.parametrize("fault", ["header_past_file", "overlap", "unknown_dtype", "truncated"])
def test_safetensors_malformed_raises_naming_the_tensor(tmp_path, fault):
    p = tmp_path / "bad.safetensors"
    if fault == "header_past_file":
        p.write_bytes((10_000).to_bytes(8, "little") + b"{}")
        match = "runs past the file"
    elif fault == "overlap":
        _header_file(p, {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
                         "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, bytes(12))
        match = "'b' overlaps tensor 'a'"
    elif fault == "unknown_dtype":
        _header_file(p, {"w": {"dtype": "F8_E9M9", "shape": [1], "data_offsets": [0, 1]}}, bytes(1))
        match = "'w': unknown dtype"
    else:
        _header_file(p, {"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, bytes(10))
        match = "'w': offsets .* run past"
    with pytest.raises(ValueError, match=match):
        load_file(p)


# ------------------------------------------------------------ converters
def _synth(schema_fn, cfg, seed):
    return jschema.synthesize_checkpoint(schema_fn(cfg), seed=seed)


def _assert_leaves_equal(jax_tree, params, dtype) -> None:
    """The JAX tree through the bridge against the port's parameters, leaf
    by leaf: same count, dtype and bits."""
    want = jax.tree.leaves(convert_params(jax_tree_to_np(jax_tree), "cpu", dtype))
    got = jax.tree.leaves(params)
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        assert a.dtype == b.dtype == dtype or not a.is_floating_point()
        assert torch.equal(a, b)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_convert_t3_matches_jax(jdt, tdt):
    """Every T3 leaf equal after the bridge; the position tables are the
    checkpoint tables' row prefix; the same keys consumed."""
    raw = _synth(jmanifest.t3_checkpoint_schema, JCFG.t3, 1)
    jused, jrep, used, rep = set(), [], set(), []
    jp = jloader.convert_t3(raw, jinit_t3(jax.random.PRNGKey(0), JCFG.t3, jdt), jdt,
                            used=jused, report_out=jrep)
    tp = convert_t3(raw, param_trees(CFG, ShapeInit())["t3"], used=used, report_out=rep)
    _assert_leaves_equal(jp, convert_params(tp, "cpu", tdt), tdt)
    assert used == jused == set(raw) and rep == jrep == []
    rows = CFG.t3.max_speech_tokens + 2
    assert raw["speech_pos_emb.emb.weight"].shape[0] > rows
    np.testing.assert_array_equal(tp["speech_pos"], raw["speech_pos_emb.emb.weight"][:rows])


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_convert_voice_encoder_matches_jax(jdt, tdt):
    raw = _synth(jmanifest.ve_checkpoint_schema, JCFG.ve, 2)
    jused, used = set(), set()
    jp = jloader.convert_voice_encoder(raw, jinit_ve(jax.random.PRNGKey(0), JCFG.ve, jdt), jdt,
                                       used=jused)
    tp = convert_voice_encoder(raw, param_trees(CFG, ShapeInit())["ve"], used=used)
    _assert_leaves_equal(jp, convert_params(tp, "cpu", tdt), tdt)
    assert used == jused == set(raw)


def _parametrized_spelling(raw: dict) -> dict:
    """The same checkpoint with torch's parametrize weight-norm spelling."""
    out = {}
    for k, v in raw.items():
        if k.endswith(".weight_g"):
            out[k.replace(".weight_g", ".parametrizations.weight.original0")] = v
        elif k.endswith(".weight_v"):
            out[k.replace(".weight_v", ".parametrizations.weight.original1")] = v
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("spelling", ["weight_g", "parametrizations"])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_convert_s3gen_ref_matches_jax(jdt, tdt, spelling):
    raw = _synth(jschema.s3gen_checkpoint_schema, JCFG.s3gen_ref, 3)
    if spelling == "parametrizations":
        raw = _parametrized_spelling(raw)
    want = jconvert_s3gen(raw, jinit_s3gen(jax.random.PRNGKey(0), JCFG.s3gen_ref, jdt), JCFG.s3gen_ref)
    got = convert_s3gen_ref(raw, param_trees(CFG, ShapeInit())["s3gen"], CFG.s3gen_ref)
    _assert_leaves_equal(want["params"], convert_params(got["params"], "cpu", tdt), tdt)
    for k in ("missing", "unused", "mismatched"):
        assert got[k] == want[k] == [], k


def test_drift_reports_match_jax():
    """A wrong shape, a missing key and a stray key: both packages report
    them alike and leave the leaf unfilled."""
    raw = _synth(jmanifest.t3_checkpoint_schema, JCFG.t3, 4)
    raw["text_head.bias"] = raw["text_head.bias"][:-1]
    jrep, rep = [], []
    jloader.convert_t3(raw, jinit_t3(jax.random.PRNGKey(0), JCFG.t3), jnp.float32, report_out=jrep)
    tp = convert_t3(raw, param_trees(CFG, ShapeInit())["t3"], report_out=rep)
    assert rep == jrep and len(rep) == 1 and "text_head/b" in rep[0]
    assert tp["text_head"]["b"].is_meta

    raw = _synth(jschema.s3gen_checkpoint_schema, JCFG.s3gen_ref, 5)
    raw["flow.encoder_proj.bias"] = raw["flow.encoder_proj.bias"][:-2]
    del raw["mel2wav.stft_window"]
    raw["stray.weight"] = np.zeros(3, np.float32)
    want = jconvert_s3gen(raw, jinit_s3gen(jax.random.PRNGKey(0), JCFG.s3gen_ref), JCFG.s3gen_ref)
    got = convert_s3gen_ref(raw, param_trees(CFG, ShapeInit())["s3gen"], CFG.s3gen_ref)
    for k in ("missing", "unused", "mismatched"):
        assert got[k] == want[k] and len(got[k]) == 1, (k, got[k])


# -------------------------------------------------------------- manifest
def test_manifest_matches_schemas_and_jax_data_file():
    on_disk = manifest.load_manifest()
    assert on_disk == manifest.build_full_manifest() == jmanifest.load_manifest()
    assert sum(len(v) for v in on_disk.values()) == 2792


DIFF_CASES = [
    ({"a.weight": (4, 2), "b.parametrizations.weight.original0": (4,),
      "b.parametrizations.weight.original1": (4, 2, 3), "tfmr.embed_tokens.weight": (8, 8),
      "surprise.weight": (3,)},
     {"a.weight": [4, 2], "b.weight_g": [4, 1, 1], "b.weight_v": [4, 2, 3], "gone.weight": [1]}),
    ({"a.weight": (4, 3), "b.weight_g": (2, 1, 1), "tfmr.rotary_emb.inv_freq": (16,)},
     {"a.weight": [4, 2], "b.weight_g": [4, 1, 1]}),
]


@pytest.mark.parametrize("i", range(len(DIFF_CASES)))
def test_diff_against_manifest_matches_jax(i):
    actual, expected = DIFF_CASES[i]
    got = manifest.diff_against_manifest(actual, expected)
    assert got == jmanifest.diff_against_manifest(actual, expected)
    assert any(got.values())


def _zeros(schema_map: dict) -> dict:
    """Zero tensors of a schema as views of one scalar (no memory)."""
    return {k: np.broadcast_to(np.float32(0), shape) for k, shape in schema_map.items()}


def test_full_size_conversion_clean():
    """The full-size schemas convert with nothing missing, unused or
    mismatched, into the shapes of the full-size trees."""
    full = EngineConfig.full()
    trees = param_trees(full, ShapeInit())
    raw = _zeros(manifest.ve_checkpoint_schema(full.ve))
    used, rep = set(), []
    convert_voice_encoder(raw, trees["ve"], used=used, report_out=rep)
    assert used == set(raw) and rep == []
    raw = _zeros(schema.s3gen_checkpoint_schema(full.s3gen_ref))
    result = convert_s3gen_ref(raw, trees["s3gen"], full.s3gen_ref)
    assert result["missing"] == result["unused"] == result["mismatched"] == []
    raw = _zeros(manifest.t3_checkpoint_schema(full.t3))
    used, rep = set(), []
    tree = convert_t3(raw, trees["t3"], used=used, report_out=rep)
    assert used == set(raw) and rep == []
    assert tree["backbone"]["layers"]["w_gate"].shape == (30, 1024, 4096)


# ----------------------------------------------------------------- native
def _jax_params(dtype=jnp.float32) -> dict:
    k = jax.random.split(jax.random.PRNGKey(11), 3)
    return {"t3": jinit_t3(k[0], JCFG.t3, dtype), "s3gen": jinit_s3gen(k[1], JCFG.s3gen_ref, dtype),
            "ve": jinit_ve(k[2], JCFG.ve, dtype)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unconvert_params_inverts_the_bridge(dtype):
    tree = jax_tree_to_np(_jax_params())
    back = unconvert_params(convert_params(tree, "cpu", dtype))
    want, got = jax.tree.leaves(tree), jax.tree.leaves(back)
    assert len(want) == len(got) > 300
    for a, b in zip(want, got):
        assert tuple(b.shape) == a.shape and b.dtype == dtype and b.is_contiguous()
        assert torch.equal(b, torch.from_numpy(np.array(a)).to(dtype))


def test_native_checkpoint_written_by_jax_loads_in_port(tmp_path):
    params = _jax_params()
    jckpt.save_checkpoint(tmp_path, params, JCFG)
    assert ckpt.is_native_checkpoint(tmp_path)
    got = ckpt.load_checkpoint(tmp_path, CFG, torch.float32, "cpu")
    _assert_leaves_equal(params, got, torch.float32)


def test_native_checkpoint_written_by_port_loads_in_jax(tmp_path):
    """The port writes the JAX package's manifest and files: the JAX loader
    reads them back to the original leaves."""
    params = _jax_params()
    ckpt.save_checkpoint(tmp_path / "port", convert_params(jax_tree_to_np(params), "cpu"), CFG)
    jckpt.save_checkpoint(tmp_path / "jax", params, JCFG)
    assert (tmp_path / "port" / ckpt.NATIVE_MANIFEST).read_text() == \
        (tmp_path / "jax" / jckpt.NATIVE_MANIFEST).read_text()
    got = jckpt.load_checkpoint(tmp_path / "port", JCFG, jnp.float32)
    for name in params:
        want_leaves, got_leaves = jax.tree.leaves(params[name]), jax.tree.leaves(got[name])
        assert len(want_leaves) == len(got_leaves)
        for a, b in zip(want_leaves, got_leaves):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# ---------------------------------------------------------------- engines
REQUEST = dict(
    text="Hello there. A loaded model speaks.",
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
    request_id="loaded",
)


def _write_reference_dir(path) -> None:
    """A tiny reference model directory: the three safetensors files from
    the schemas (seeded values) and a seeded conds.pt."""
    path.mkdir(parents=True, exist_ok=True)
    for name, fn, cfg, seed in (
            ("t3_cfg.safetensors", jmanifest.t3_checkpoint_schema, JCFG.t3, 21),
            ("ve.safetensors", jmanifest.ve_checkpoint_schema, JCFG.ve, 22),
            ("s3gen.safetensors", jschema.s3gen_checkpoint_schema, JCFG.s3gen_ref, 23)):
        save_file(_synth(fn, cfg, seed), path / name)
    write_conds(path / "conds.pt", spk_dim=JCFG.t3.speaker_embed_dim)


def _serve(engine, token):
    async def go():
        data = b""
        async for chunk in engine.stream(**REQUEST, cancellation_token=token):
            data += chunk
        return data

    return asyncio.run(go())


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """A reference directory, the JAX engine served from it, and a native
    checkpoint of what the JAX engine loaded."""
    tmp = tmp_path_factory.mktemp("model_dirs")
    _write_reference_dir(tmp / "reference")
    mp = pytest.MonkeyPatch()
    for k, v in {"MODEL_PATH": str(tmp / "reference"), "VOICES_DIR": str(tmp / "voices"),
                 "PRELOADED_VOICES_DIR": str(tmp / "preloaded"), "MAX_DECODE_SLOTS": "1",
                 "CHATTERBOX_CFM_PROMPT_CACHE": "0"}.items():
        mp.setenv(k, v)
    reset_config_cache()
    jeng = JTTSEngine(JEngineConfig.tiny_ref(), seed=3)
    asyncio.run(jeng.ainit())
    slices = spy_slices(jeng)
    jwav = _serve(jeng, JToken())
    jckpt.save_checkpoint(tmp / "native", jeng.params, JCFG)
    (tmp / "native" / "conds.pt").write_bytes((tmp / "reference" / "conds.pt").read_bytes())
    loaded = jax_tree_to_np(jeng.params)
    jeng.shutdown()
    yield tmp, jwav, slices, loaded
    mp.undo()
    reset_config_cache()


@pytest.mark.parametrize("kind", ["reference", "native"])
def test_engine_boots_from_model_dir_like_jax(model_dirs, monkeypatch, kind):
    """The port's engine on the CPU boots from the directory, holds the JAX
    engine's loaded weights bit for bit, and serves a greedy request with
    the JAX engine's tokens, slice by slice, and its sample count."""
    tmp, jwav, jslices, loaded = model_dirs
    monkeypatch.setenv("MODEL_PATH", str(tmp / kind))
    eng = TTSEngine(EngineConfig.tiny_ref(), seed=3, device="cpu")
    asyncio.run(eng.ainit())
    for name in ("t3", "s3gen", "ve"):
        _assert_leaves_equal(loaded[name], eng.params[name], torch.float32)
    if kind == "reference":
        files = eng.load_report["files"]
        assert sorted(files) == ["s3gen.safetensors", "t3_cfg.safetensors", "ve.safetensors"]
        for f in files.values():
            assert f["mismatched"] == f["missing"] == f["unused"] == [], f
    slices = spy_slices(eng)
    wav = _serve(eng, CancellationToken())
    eng.shutdown()
    assert slices == jslices and sum(map(len, slices["loaded"])) > 0
    assert wav[:44] == jwav[:44] and len(wav) == len(jwav) > 44


def test_partial_checkpoint_keeps_the_random_init(tmp_path, monkeypatch, caplog):
    """A directory with only t3_cfg.safetensors: T3 is loaded, S3Gen and the
    VoiceEncoder keep the random init the engine draws at its seed, and a
    warning says so."""
    save_file(_synth(jmanifest.t3_checkpoint_schema, JCFG.t3, 6), tmp_path / "t3_cfg.safetensors")
    with caplog.at_level("WARNING"):
        params = load_reference_checkpoint(tmp_path, CFG, torch.float32, "cpu", seed=5)
    assert "keep their random init" in caplog.text
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "empty"))
    rand = TTSEngine(CFG, seed=5, device="cpu")
    rand._init_models()
    for name in ("s3gen", "ve"):
        for a, b in zip(jax.tree.leaves(params[name]), jax.tree.leaves(rand.params[name])):
            assert torch.equal(a, b)
    assert not torch.equal(params["t3"]["text_emb"], rand.params["t3"]["text_emb"])
    assert load_reference_checkpoint(tmp_path / "empty", CFG, torch.float32, "cpu") is None


@pytest.mark.parametrize("fault", ["malformed", "dit_checkpoint", "dit_setting"])
def test_engine_refuses_what_it_cannot_load(tmp_path, monkeypatch, fault):
    """A present but unreadable t3_cfg.safetensors raises from ainit (no
    random init over it); so does a native checkpoint of the DiT stack under
    a ref config, with the JAX loader's ValueError. CHATTERBOX_S3GEN_ARCH=dit
    is no fault: it builds the DiT config at the published widths."""
    monkeypatch.setenv("MODEL_PATH", str(tmp_path))
    monkeypatch.setenv("MAX_DECODE_SLOTS", "1")
    if fault == "dit_setting":
        monkeypatch.setenv("CHATTERBOX_S3GEN_ARCH", "dit")
        eng = TTSEngine(device="cpu")
        assert eng.cfg.s3gen_arch == JEngineConfig.full().s3gen_arch == "dit"
        assert eng.cfg.gen is eng.cfg.s3gen and eng.cfg.s3gen_ref is None
        assert eng.cfg.s3gen.dit_layers == 8 and eng.cfg.s3tok.layers == 4
        return
    if fault == "malformed":
        (tmp_path / "t3_cfg.safetensors").write_bytes((1 << 40).to_bytes(8, "little") + b"{}")
        err, match = ValueError, "runs past the file"
    else:
        (tmp_path / ckpt.NATIVE_MANIFEST).write_text(json.dumps({"format": "chatterbox_tpu/v1",
                                                                "s3gen_arch": "dit"}))
        err, match = ValueError, "saved with s3gen_arch='dit' but the engine is configured for 'ref'"
        with pytest.raises(err, match=match):
            jckpt.load_checkpoint(tmp_path, JCFG, jnp.float32)
    eng = TTSEngine(EngineConfig.tiny_ref(), device="cpu")
    with pytest.raises(err, match=match):
        asyncio.run(eng.ainit())
    assert eng.get_initialization_status()["state"] == "error" and eng.params is None


DIT_CFG, DIT_JCFG = EngineConfig.tiny(), JEngineConfig.tiny()


def _jax_dit_params() -> dict:
    from chatterbox_tpu.models.s3gen import init_s3gen_params
    from chatterbox_tpu.models.s3tok import init_s3tok_params

    k = jax.random.split(jax.random.PRNGKey(12), 4)
    return {"t3": jinit_t3(k[0], DIT_JCFG.t3), "s3gen": init_s3gen_params(k[1], DIT_JCFG.s3gen),
            "s3tok": init_s3tok_params(k[2], DIT_JCFG.s3tok), "ve": jinit_ve(k[3], DIT_JCFG.ve)}


def test_native_dit_checkpoint_round_trip(tmp_path, monkeypatch):
    """The DiT arch's native checkpoint (t3, s3gen, s3tok, ve): what the JAX
    package writes loads in the port bit for bit, the port writes the JAX
    package's manifest and files, and an engine boots from them."""
    params = _jax_dit_params()
    jckpt.save_checkpoint(tmp_path / "jax", params, DIT_JCFG)
    got = ckpt.load_checkpoint(tmp_path / "jax", DIT_CFG, torch.float32, "cpu")
    assert sorted(got) == ["s3gen", "s3tok", "t3", "ve"]
    _assert_leaves_equal(params, got, torch.float32)
    ckpt.save_checkpoint(tmp_path / "port", got, DIT_CFG)
    assert (tmp_path / "port" / ckpt.NATIVE_MANIFEST).read_text() == \
        (tmp_path / "jax" / jckpt.NATIVE_MANIFEST).read_text()
    back = jckpt.load_checkpoint(tmp_path / "port", DIT_JCFG, jnp.float32)
    for name in params:
        for a, b in zip(jax.tree.leaves(params[name]), jax.tree.leaves(back[name])):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    with pytest.raises(ValueError, match="saved with s3gen_arch='dit'"):
        ckpt.load_checkpoint(tmp_path / "port", CFG, torch.float32, "cpu")
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "port"))
    eng = TTSEngine(DIT_CFG, device="cpu")
    eng._init_models()
    _assert_leaves_equal(params, eng.params, torch.float32)


BLOCKED = ("aiohttp", "pydantic", "safetensors", "tokenizers", "jax", "chatterbox_tpu")


def test_port_loads_and_serves_without_server_packages(model_dirs, tmp_path):
    """What a GPU machine lacks is not needed to import the port, load a
    model directory and run the engine: a fresh interpreter with aiohttp,
    pydantic, safetensors, tokenizers, JAX and the JAX package blocked boots
    the engine from the reference directory on the CPU."""
    import subprocess
    import sys

    tmp = model_dirs[0]
    code = f"""
import asyncio, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import chatterbox_tpu_torch
from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine
from chatterbox_tpu_torch.runtime import checkpoint, loader, safetensors_io
eng = TTSEngine(EngineConfig.tiny_ref(), device="cpu")
asyncio.run(eng.ainit())
checkpoint.save_checkpoint({str(tmp_path)!r}, eng.params, eng.cfg)
assert checkpoint.is_native_checkpoint({str(tmp_path)!r})
assert eng.load_report["files"]["t3_cfg.safetensors"]["unused"] == []
assert not any(m in sys.modules and sys.modules[m] is not None for m in {BLOCKED!r})
print("ok", eng.get_initialization_status()["state"])
"""
    env = {**os.environ, "MODEL_PATH": str(tmp / "reference"), "MAX_DECODE_SLOTS": "1",
           "PYTHONPATH": os.pathsep.join(p for p in sys.path if p)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["ok", "ready"]


def test_port_reads_tokenizer_json_without_tokenizers(tmp_path):
    """A model directory with a trained tokenizer.json: a fresh interpreter
    with `tokenizers` (and the rest of BLOCKED) blocked boots the DiT engine
    from it on the CPU, and its tokenizer gives `tokenizers`' ids."""
    import subprocess
    import sys

    from tokenizers import Tokenizer

    from torch_port_helpers import train_tokenizer_json

    model_dir = tmp_path / "model"
    model_dir.mkdir()
    tok = train_tokenizer_json(model_dir)
    text = "Hello, quick voice! 123 streaming?"
    want = Tokenizer.from_file(tok).encode(text.lower().replace(" ", "[SPACE]")).ids
    code = f"""
import asyncio, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine
eng = TTSEngine(EngineConfig.tiny(), device="cpu")
asyncio.run(eng.ainit())
assert eng.tokenizer.is_pretrained
print(eng.tokenizer.text_to_tokens({text!r})[0].tolist())
print("ok", eng.get_initialization_status()["state"])
"""
    env = {**os.environ, "MODEL_PATH": str(model_dir), "MAX_DECODE_SLOTS": "1",
           "PYTHONPATH": os.pathsep.join(p for p in sys.path if p)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "ok ready"
    assert json.loads(lines[-2]) == want
