"""The port's training data path and entry point against the JAX package,
on the CPU at ``EngineConfig.tiny()`` (the DiT arch, float32).

* ``T3FeatureExtractor`` against JAX's on the same weights (the JAX
  engine's random init, bridged) and 16 kHz WAVs written here, so neither
  side resamples: S3Tok's tokens and the text ids equal, the speaker
  embedding within SPK_TOL, on a long clip (prompt from the tail) and a
  short one (the half split);
* the ref arch has no S3Tok: the port refuses at construction, naming
  CHATTERBOX_S3GEN_ARCH=dit, where JAX's extractor fails with KeyError;
* ``make_batches`` equal to JAX's array for array (values and dtypes) over
  two shuffle seeds, with a ragged tail dropped and a clip cut at
  ``max_speech``; ``load_manifest`` on blank and tab-less lines;
* end to end: the JAX engine's params saved as a native checkpoint, then
  ``scripts/train_t3.py`` and ``python -m
  chatterbox_tpu_torch.training.train_t3`` with the same flags, each in its
  own process: their checkpoints' T3 leaves agree to stated multiples of
  lr, every other leaf bitwise equal; ``--tp 3`` raises (it does not divide
  the tiny T3's 4 heads).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_port_helpers import jax_tree_to_np, to_np

from chatterbox_tpu.config import reset_config_cache
from chatterbox_tpu.models.tokenizer import TextTokenizer as JTextTokenizer
from chatterbox_tpu.runtime import EngineConfig as JEngineConfig
from chatterbox_tpu.runtime import TTSEngine as JTTSEngine
from chatterbox_tpu.runtime import checkpoint as jckpt
from chatterbox_tpu.training import data as jdata
from chatterbox_tpu_torch.audio.pcm import write_wav
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.models.tokenizer import TextTokenizer
from chatterbox_tpu_torch.runtime.engine import EngineConfig
from chatterbox_tpu_torch.runtime.safetensors_io import load_file
from chatterbox_tpu_torch.training import data
from chatterbox_tpu_torch.training import train_t3

REPO = Path(__file__).resolve().parents[1]
CFG, JCFG = EngineConfig.tiny(), JEngineConfig.tiny()
# the VoiceEncoder's LSTM in float32 on both sides: summation order only
SPK_TOL = 1e-5
# 3 steps of adamw at the scripts' lr 1e-5. Both featurize the same clips
# to the same tokens, so the runs differ in rounding only. An element whose
# gradient is rounding noise (the perceiver's key bias, which the softmax
# cancels) may step either way, about lr per step on each side: every
# element is held within CKPT_LR_MULT · lr = 2 · 3 · 1.004 lr (measured
# 1.00 lr, in that bias), and all but CKPT_LOOSE_SHARE of them within
# CKPT_TIGHT_LR_MULT · lr (measured: 99.99 % within 0.003 lr, 5.7e-5 of
# them beyond 0.01 lr).
LR = 1e-5
CKPT_LR_MULT = 6.03
CKPT_TIGHT_LR_MULT = 0.01
CKPT_LOOSE_SHARE = 1e-3
TEXTS = ["Hello world.", "The quick brown fox.", "A port of the trainer.",
         "Streaming speech, one token at a time."]


def _clip(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    f0 = 120.0 + 40.0 * rng.random()
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The JAX engine's tiny params (numpy), their native checkpoint, and a
    manifest of four 16 kHz clips (two long, two short)."""
    tmp = tmp_path_factory.mktemp("torch_training_data")
    empty, model = tmp / "empty", tmp / "model"
    empty.mkdir()
    mp = pytest.MonkeyPatch()
    mp.setenv("MODEL_PATH", str(empty))
    mp.delenv("CHATTERBOX_S3GEN_ARCH", raising=False)
    reset_config_cache()
    try:
        jeng = JTTSEngine(JCFG, seed=5)
        jeng._init_models()
        jckpt.save_checkpoint(model, jeng.params, jeng.cfg)
        jparams = jax_tree_to_np(jeng.params)
    finally:
        mp.undo()
        reset_config_cache()
    wavs = []
    for i, seconds in enumerate((0.8, 0.3, 1.0, 0.36)):
        path = tmp / f"clip{i}.wav"
        write_wav(str(path), _clip(seconds, i), 16000)
        wavs.append(str(path))
    manifest = tmp / "manifest.tsv"
    manifest.write_text("".join(f"{w}\t{t}\n" for w, t in zip(wavs, TEXTS)))
    return {"tmp": tmp, "jparams": jparams, "model": model, "wavs": wavs, "manifest": manifest}


@pytest.mark.parametrize("clip", [0, 1], ids=["long_clip", "short_clip"])
def test_feature_extractor_matches_jax(env, clip):
    jp = env["jparams"]
    port_params = {k: convert_params(v, "cpu") for k, v in jp.items()}
    jx = jdata.T3FeatureExtractor(jp, JCFG, JTextTokenizer(None, JCFG.t3.text_vocab_size))
    px = data.T3FeatureExtractor(port_params, CFG, TextTokenizer(None, CFG.t3.text_vocab_size))
    want = jx.extract(env["wavs"][clip], TEXTS[clip])
    got = px.extract(env["wavs"][clip], TEXTS[clip])
    P = CFG.t3.speech_cond_prompt_len
    n = len(want.speech_tokens) + (P if clip == 0 else 0)
    assert (n > 2 * P) == (clip == 0)   # the branch this clip is meant to take
    for field in ("text_tokens", "speech_tokens", "prompt_tokens"):
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == np.int32 and w.dtype == np.int32, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.speaker_emb.dtype == np.float32
    np.testing.assert_allclose(got.speaker_emb, np.asarray(want.speaker_emb), rtol=0, atol=SPK_TOL)


def test_ref_arch_has_no_s3tok(env):
    """Under the ref arch the params hold no S3Tok: the port refuses at
    construction and names the setting; JAX's extractor fails at its first
    clip with KeyError."""
    jp = {k: v for k, v in env["jparams"].items() if k != "s3tok"}
    port_params = {k: convert_params(v, "cpu") for k, v in jp.items()}
    with pytest.raises(ValueError, match="CHATTERBOX_S3GEN_ARCH=dit"):
        data.T3FeatureExtractor(port_params, EngineConfig.tiny_ref(),
                                TextTokenizer(None, CFG.t3.text_vocab_size))
    jx = jdata.T3FeatureExtractor(jp, JEngineConfig.tiny_ref(),
                                  JTextTokenizer(None, JCFG.t3.text_vocab_size))
    with pytest.raises(KeyError):
        jx.extract(env["wavs"][0], TEXTS[0])


def _examples(n: int, seed: int):
    rng = np.random.default_rng(seed)
    c = CFG.t3
    out = []
    for i in range(n):
        s_len = c.max_speech_tokens + 5 if i == 1 else int(rng.integers(1, 40))
        out.append(data.Example(
            text_tokens=rng.integers(0, c.text_vocab_size, int(rng.integers(3, 20))).astype(np.int32),
            speech_tokens=rng.integers(0, c.num_speech_codes, s_len).astype(np.int32),
            speaker_emb=rng.standard_normal(c.speaker_embed_dim).astype(np.float32),
            prompt_tokens=rng.integers(0, c.num_speech_codes, c.speech_cond_prompt_len).astype(np.int32),
        ))
    return out


@pytest.mark.parametrize("seed,max_speech", [(0, None), (7, 24)])
def test_make_batches_matches_jax(seed, max_speech):
    examples = _examples(5, seed)
    jex = [jdata.Example(**vars(e)) for e in examples]
    want = list(jdata.make_batches(jex, JCFG.t3, 2, max_speech=max_speech, exaggeration=0.7,
                                   shuffle_seed=seed))
    got = list(data.make_batches(examples, CFG.t3, 2, max_speech=max_speech, exaggeration=0.7,
                                 shuffle_seed=seed, device="cpu"))
    assert len(got) == len(want) == 2   # 5 examples: the ragged fifth is dropped
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            wk = np.asarray(w[k])
            assert g[k].device.type == "cpu"
            assert to_np(g[k]).dtype == wk.dtype, k
            np.testing.assert_array_equal(to_np(g[k]), wk, err_msg=k)


def test_load_manifest_matches_jax(tmp_path):
    path = tmp_path / "m.tsv"
    path.write_text("a.wav\thello\n\nno tab here\nb.wav\ttwo\ttabs\n\nc.wav\t\n", encoding="utf-8")
    got = data.load_manifest(str(path))
    assert got == jdata.load_manifest(str(path))
    assert got == [("a.wav", "hello"), ("b.wav", "two\ttabs"), ("c.wav", "")]


def _leaves(directory: Path) -> dict:
    return {name: load_file(directory / f"{name}.safetensors")
            for name in json.loads((directory / jckpt.NATIVE_MANIFEST).read_text())["models"]}


def test_train_scripts_agree(env):
    """Both entry points train from the same checkpoint, each in its own
    process; the T3 leaves agree (CKPT_LR_MULT, CKPT_TIGHT_LR_MULT) and
    moved, the rest are bitwise the loaded ones."""
    tmp = env["tmp"]
    flags = [str(env["manifest"]), "--tiny", "--cpu", "--steps", "3", "--batch", "2"]
    proc_env = {**os.environ, "MODEL_PATH": str(env["model"]), "JAX_PLATFORMS": "cpu",
                "OMP_NUM_THREADS": "2", "PYTHONPATH": str(REPO)}
    proc_env.pop("CHATTERBOX_S3GEN_ARCH", None)
    procs = {
        "jax": subprocess.Popen([sys.executable, "scripts/train_t3.py", *flags,
                                 "--out", str(tmp / "out-jax")], cwd=REPO, env=proc_env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "port": subprocess.Popen([sys.executable, "-m", "chatterbox_tpu_torch.training.train_t3",
                                  *flags, "--out", str(tmp / "out-port")], cwd=REPO, env=proc_env,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
    }
    logs = {k: p.communicate(timeout=240)[0] for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}:\n{logs[k][-3000:]}"
        assert "step 1: loss=" in logs[k], logs[k][-3000:]
    init, jout, pout = (_leaves(d) for d in (env["model"], tmp / "out-jax", tmp / "out-port"))
    assert init.keys() == jout.keys() == pout.keys()
    err = np.concatenate([np.abs(pout["t3"][k] - jout["t3"][k]).ravel() for k in init["t3"]])
    assert (err > CKPT_TIGHT_LR_MULT * LR).mean() <= CKPT_LOOSE_SHARE
    for name in init:
        assert init[name].keys() == jout[name].keys() == pout[name].keys()
        for key in init[name]:
            j, p = jout[name][key], pout[name][key]
            if name != "t3":
                assert np.array_equal(p, init[name][key]) and np.array_equal(j, p), (name, key)
                continue
            np.testing.assert_allclose(p, j, rtol=0, atol=CKPT_LR_MULT * LR, err_msg=key)
    moved = [k for k in init["t3"] if np.abs(pout["t3"][k] - init["t3"][k]).max() > 0.5 * LR]
    assert "speech_head/w" in moved and "backbone/layers/wq" in moved, moved


def test_tensor_parallel_flag_raises(env, tmp_path, monkeypatch):
    """``--tp`` trains over a mesh now (tests/test_torch_parallel.py); a tp
    that does not divide T3's heads raises before any rank starts."""
    monkeypatch.setenv("CHATTERBOX_TINY_MODEL", "1")   # what --tiny sets, undone after
    with pytest.raises(ValueError, match="4 query heads do not split over tp=3"):
        train_t3.main([str(env["manifest"]), "--out", str(tmp_path / "out"), "--tiny", "--tp", "3"])
