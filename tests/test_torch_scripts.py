"""The port's quality study and entry points, against the JAX package's
scripts, on the CPU at the tiny configs.

* ``quality_study``'s variant lists against ``scripts/quality_study.py``'s
  (read by path), and the one stated mapping: a knob at anything but "1"
  becomes the plain-version swap of its kernel (``common.kernel_swap``);
* ``quality_salvage`` against ``scripts/quality_salvage.py`` on the same
  seeded WAVs (rows within the 0.001 of their rounding, the merge rule, the
  JAX result files refused);
* a ``--tiny`` study in child processes: a knob that changes the output
  (MCD > 0) and the control (``prompt_cache_step`` is the default: the same
  request in two fresh processes gives the same WAV, MCD 0.0);
* ``run_variant`` with CHATTERBOX_PALLAS=0: K1's plain version swapped in,
  K2 left at its call site, both in the sidecar;
* ``parity_check`` (the pinned environment, the swap unless
  CHATTERBOX_PALLAS=1, MCD 0 against its own WAV, exit 1 over the
  threshold, a 16 kHz reference resampled);
* ``export_checkpoint`` read back by both packages' ``load_checkpoint``,
  the same files under CHATTERBOX_TP=2 and no follower started;
* ``gen_manifest``'s bytes against both checked-in manifests;
* ``clone_voice`` against the JAX script case by case;
* ``demo_synthesis`` on the CPU, and its refusal with no CUDA device;
* ``download_models`` with ``snapshot_download`` replaced (no network).
"""
import asyncio
import importlib.util
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch's threads)

from chatterbox_tpu_torch.audio import pcm
from chatterbox_tpu_torch.audio.pcm import read_wav, write_wav
from chatterbox_tpu_torch.models.s3gen_ref import decoder
from chatterbox_tpu_torch.models.t3 import model as t3_model
from chatterbox_tpu_torch.ops.decode_attention import decode_attention_plain
from chatterbox_tpu_torch.ops.flash_mha import flash_mha_context_plain, flash_mha_plain
from chatterbox_tpu_torch.runtime import checkpoint as ckpt
from chatterbox_tpu_torch.runtime import manifest, tp_serving
from chatterbox_tpu_torch.runtime.engine import TTSEngine
from chatterbox_tpu_torch.scripts import (clone_voice, common, demo_synthesis, download_models,
                                          export_checkpoint, gen_manifest, parity_check,
                                          quality_salvage, quality_study, run_variant)

REPO = Path(__file__).resolve().parents[1]
# what scripts/parity_check.py pins (its lines 58-63), CHATTERBOX_PALLAS aside
PARITY_PINS = {"CHATTERBOX_S3GEN_ARCH": "ref", "CHATTERBOX_KV": "native",
               "KV_CACHE_DTYPE": "native", "CHATTERBOX_CFM_PROMPT_CACHE": "0",
               "CHATTERBOX_CFM_STREAM": "0", "CHATTERBOX_PROGRESSIVE_SLICES": "0"}
# every variable a script here sets in its own process
SET_BY_SCRIPTS = {"CHATTERBOX_TINY_MODEL", "CHATTERBOX_FORCE_CPU", "CHATTERBOX_S3GEN_ARCH",
                  "CHATTERBOX_MAX_NEW_TOKENS", "STUDY_TEXT", "STUDY_SLICE", "CHATTERBOX_KV",
                  "KV_CACHE_DTYPE", "CHATTERBOX_CFM_PROMPT_CACHE", "CHATTERBOX_CFM_STREAM",
                  "CHATTERBOX_PROGRESSIVE_SLICES", "CHATTERBOX_PALLAS", "CHATTERBOX_FLASH",
                  "CHATTERBOX_TP"}


def _jax_script(name: str):
    """``scripts/<name>.py`` of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def env(tmp_path, monkeypatch):
    """A model directory with no checkpoint (random init), voice stores and
    the temporary directory under ``tmp_path``, two threads per child
    process; every variable the scripts set restored after the test."""
    for k in SET_BY_SCRIPTS:
        monkeypatch.delenv(k, raising=False)
    for k, v in {"MODEL_PATH": str(tmp_path / "no-model"), "VOICES_DIR": str(tmp_path / "voices"),
                 "PRELOADED_VOICES_DIR": str(tmp_path / "preloaded"), "TMPDIR": str(tmp_path),
                 "OMP_NUM_THREADS": "2", "MAX_DECODE_SLOTS": "16"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))   # read once per process
    monkeypatch.chdir(tmp_path)
    return tmp_path


# ------------------------------------------------------------ the study's lists
def test_variant_lists_are_the_jax_studys():
    jax_study = _jax_script("quality_study")
    assert quality_study.VARIANTS == jax_study.VARIANTS
    assert quality_study.TINY_VARIANTS == jax_study.TINY_VARIANTS
    assert quality_study.TEXT == jax_study.TEXT
    # the stated mapping: only reference_exact turns a kernel off, K1 alone
    swaps = {name: common.kernel_swap(dict(e)) for name, e in jax_study.VARIANTS}
    assert swaps.pop("reference_exact") == ("decode_attention",)
    assert set(swaps.values()) == {()}
    assert {common.kernel_swap(dict(e)) for _, e in jax_study.TINY_VARIANTS} == {()}


@pytest.mark.parametrize("knobs, swapped", [
    ({}, ()),
    ({"CHATTERBOX_PALLAS": "1", "CHATTERBOX_FLASH": "1"}, ()),
    ({"CHATTERBOX_PALLAS": "0"}, ("decode_attention",)),
    ({"CHATTERBOX_FLASH": "0"}, ("flash_mha",)),
    ({"CHATTERBOX_PALLAS": "true", "CHATTERBOX_FLASH": ""}, ("decode_attention", "flash_mha")),
])
def test_kernel_swap_reads_the_knobs_as_the_wrappers_do(knobs, swapped):
    e = {"OTHER": "x", **knobs}
    assert common.kernel_swap(e) == swapped
    assert e == {"OTHER": "x"}   # both knobs gone from the child's environment


@pytest.mark.parametrize("value", ["1", "0", "true", "", None])   # None: unset
def test_kernel_swap_swaps_what_jax_turns_off(monkeypatch, value):
    """A kernel is swapped exactly where the JAX package turns its Pallas
    kernel off under the same value (``pallas_enabled``, and the flash
    kernel's env rule with the TPU as the backend)."""
    import jax

    from chatterbox_tpu.models.s3gen_ref import decoder as jdec
    from chatterbox_tpu.ops import pallas_attention_v3 as jpav3

    monkeypatch.setattr(jdec, "_FLASH_INTERPRET", False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")   # the rule, not the backend
    for knob in common.KERNEL_KNOBS.values():
        if value is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, value)
    jax_off = {"decode_attention": not jpav3.pallas_enabled(), "flash_mha": not jdec._flash_active()}
    e = {k: v for k, v in os.environ.items() if k in common.KERNEL_KNOBS.values()}
    assert set(common.kernel_swap(e)) == {k for k, off in jax_off.items() if off}
    assert e == {}


@pytest.mark.parametrize("kernels", [("decode_attention",), ("flash_mha",),
                                     ("decode_attention", "flash_mha"), ()])
def test_plain_attention_swaps_each_kernel_alone(kernels):
    wrappers = t3_model.decode_attention, decoder.flash_mha
    with common.plain_attention(kernels):
        assert (t3_model.decode_attention is decode_attention_plain) == ("decode_attention" in kernels)
        assert (decoder.flash_mha is flash_mha_plain) == ("flash_mha" in kernels)
    assert (t3_model.decode_attention, decoder.flash_mha) == wrappers
    with common.plain_attention():   # the default: both
        assert t3_model.decode_attention is decode_attention_plain
        assert decoder.flash_mha is flash_mha_plain
    with pytest.raises(ValueError, match="no kernel"):
        with common.plain_attention(("conv",)):
            pass


def test_plain_attention_swaps_both_k2_forms():
    """K2's knob swaps its self form and its context form together, and
    only under the "flash_mha" name."""
    wrapper = decoder.flash_mha_context
    with common.plain_attention(("decode_attention",)):
        assert decoder.flash_mha_context is wrapper
    with common.plain_attention(("flash_mha",)):
        assert decoder.flash_mha_context is flash_mha_context_plain
        assert decoder.flash_mha is flash_mha_plain
    assert decoder.flash_mha_context is wrapper


# ------------------------------------------------------------ salvage
def _seeded_wavs(d: Path, sr: int = 24000) -> None:
    g = np.random.default_rng(5)
    t = np.arange(int(0.8 * sr)) / sr
    base = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * g.standard_normal(t.size)
    d.mkdir(parents=True, exist_ok=True)
    write_wav(str(d / "default.wav"), base.astype(np.float32), sr)
    write_wav(str(d / "noisy.wav"), (base + 0.05 * g.standard_normal(t.size)).astype(np.float32), sr)
    write_wav(str(d / "shorter.wav"), base[: int(0.6 * sr)].astype(np.float32), sr)
    write_wav(str(d / "other.wav"), (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32), sr)
    (d / "noisy.json").write_text("{}")   # a sidecar: not a row


def _run_jax_salvage(wav_dir: Path, out: Path, monkeypatch) -> dict:
    monkeypatch.setattr(sys, "argv", ["quality_salvage.py", str(wav_dir), "--out", str(out)])
    _jax_script("quality_salvage").main()
    return json.loads(out.read_text())


def test_salvage_rows_match_the_jax_script(tmp_path, monkeypatch, capsys):
    wav_dir = tmp_path / "study"
    _seeded_wavs(wav_dir)
    want = _run_jax_salvage(wav_dir, tmp_path / "jax.json", monkeypatch)
    quality_salvage.main([str(wav_dir), "--out", str(tmp_path / "port.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    assert {k: v for k, v in got.items() if k != "variants"} == \
        {k: v for k, v in want.items() if k != "variants"}
    assert list(got["variants"]) == list(want["variants"]) == ["noisy", "other", "shorter"]
    for name, row in want["variants"].items():
        for k, v in row.items():
            assert abs(got["variants"][name][k] - v) <= 1e-3 + 1e-9, (name, k)
    assert got["variants"]["other"]["mcd_db"] > got["variants"]["noisy"]["mcd_db"] > 0


def test_salvage_merge_rule_matches_the_jax_script(tmp_path, monkeypatch):
    """An existing report with the same baseline keeps its other rows; one
    with another baseline is replaced: the same in both packages."""
    wav_dir = tmp_path / "study"
    _seeded_wavs(wav_dir)
    first = _run_jax_salvage(wav_dir, tmp_path / "base.json", monkeypatch)
    same = {**first, "variants": {"from_before": {"mcd_db": 1.0, "lsd_db": 2.0, "audio_s": 0.8},
                                  "noisy": {"mcd_db": -1.0, "lsd_db": -1.0, "audio_s": -1.0}}}
    other = {**same, "default_audio_s": first["default_audio_s"] + 1}
    for label, prev in (("same", same), ("other", other)):
        for who in ("jax", "port"):
            (tmp_path / f"{label}_{who}.json").write_text(json.dumps(prev))
        want = _run_jax_salvage(wav_dir, tmp_path / f"{label}_jax.json", monkeypatch)
        quality_salvage.main([str(wav_dir), "--out", str(tmp_path / f"{label}_port.json")])
        got = json.loads((tmp_path / f"{label}_port.json").read_text())
        assert list(got["variants"]) == list(want["variants"])
        assert ("from_before" in got["variants"]) == (label == "same")
        assert got["variants"]["noisy"]["mcd_db"] > 0   # the new row replaced the old
        if label == "same":
            assert got["variants"]["from_before"] == want["variants"]["from_before"]


@pytest.mark.parametrize("name", common.JAX_RESULTS)
def test_jax_result_files_are_refused(tmp_path, name):
    wav_dir = tmp_path / "study"
    _seeded_wavs(wav_dir)
    with pytest.raises(SystemExit, match=name):
        quality_salvage.main([str(wav_dir), "--out", str(tmp_path / name)])
    with pytest.raises(SystemExit, match=name):
        quality_study.main(["--tiny", "--out", name])
    assert not (tmp_path / name).exists()


def test_salvage_needs_a_default(tmp_path):
    with pytest.raises(SystemExit, match="no default.wav"):
        quality_salvage.main([str(tmp_path), "--out", str(tmp_path / "r.json")])


def test_salvage_default_out_is_the_ports(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(common, "OUT_DIR", tmp_path / "chiprun_out")
    wav_dir = tmp_path / "study"
    _seeded_wavs(wav_dir)
    quality_salvage.main([str(wav_dir)])
    saved = json.loads((tmp_path / "chiprun_out" / "quality_study_torch.json").read_text())
    assert saved == json.loads(capsys.readouterr().out)
    assert set(saved["variants"]) == {"noisy", "other", "shorter"}


# ------------------------------------------------------------ the study itself
def test_tiny_study_in_child_processes(env, monkeypatch, capsys):
    """Two variants plus default, each a fresh process on the CPU: the CFM
    step count changes the WAV; prompt_cache_step sets the default, so the
    same request in two processes must give the same WAV."""
    monkeypatch.setenv("CHATTERBOX_MAX_NEW_TOKENS", "24")
    out = env / "study.json"
    quality_study.main(["--tiny", "--only", "prompt_cache_step,cfm_steps_4", "--out", str(out)])
    report = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == report
    assert report["tiny"] is True and report["text_chars"] == len(quality_study.TEXT)
    assert report["default_audio_s"] > 0
    rows = report["variants"]
    assert list(rows) == ["cfm_steps_4", "prompt_cache_step"]
    assert rows["cfm_steps_4"]["mcd_db"] > 0
    assert rows["prompt_cache_step"] == {"mcd_db": 0.0, "lsd_db": 0.0,
                                         "audio_s": report["default_audio_s"]}
    (study,) = env.glob("quality_study_*")
    for name in ("default", "cfm_steps_4", "prompt_cache_step"):
        record = json.loads((study / f"{name}.json").read_text())
        assert record["device"] == "cpu" and record["plain"] == []
        assert record["max_new_tokens"] == 64   # the tiny config's cap, as in the JAX engine
        data = (study / f"{name}.wav").read_bytes()
        fade = int(record["sample_rate"] * 30 / 1000)
        assert common.check_wav(name, data, record["request_stats"], record["sample_rate"],
                                record["samples_per_token"], fade) > 0
        # the CPU takes the plain versions: no kernel launched
        assert not any(n for k in record["launches"].values() for n in k.values())
    # a second --only run merges into the same report (same baseline)
    quality_study.main(["--tiny", "--only", "flow_prompt_4", "--out", str(out)])
    merged = json.loads(out.read_text())
    assert list(merged["variants"]) == ["cfm_steps_4", "prompt_cache_step", "flow_prompt_4"]


def test_study_without_tiny_needs_a_card(env, monkeypatch, capsys):
    """Without --tiny a child runs on the CUDA device; with none it fails,
    naming it, and with default failed there is no report."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(SystemExit) as exc:
        quality_study.main(["--only", "default", "--out", str(env / "study.json")])
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert "default FAILED" in err and "no CUDA device" in err
    assert not (env / "study.json").exists()


def test_run_variant_maps_pallas_off_to_the_swap(env, monkeypatch):
    """reference_exact's environment on the tiny config: K1's plain version
    at its call site (the wrapper there is never called), K2 left on (its
    wrapper runs: the uncached path's self form), the knob gone from the
    environment, the swap in the sidecar."""
    k2_calls = []

    def k1_wrapper(*a, **kw):
        raise AssertionError("K1's wrapper ran under CHATTERBOX_PALLAS=0")

    def k2_wrapper(*a, **kw):
        k2_calls.append(a[0].shape)
        return flash_mha_plain(*a, **kw)

    monkeypatch.setattr(t3_model, "decode_attention", k1_wrapper)
    monkeypatch.setattr(decoder, "flash_mha", k2_wrapper)
    monkeypatch.setenv("CHATTERBOX_TINY_MODEL", "1")
    monkeypatch.setenv("CHATTERBOX_FORCE_CPU", "1")
    monkeypatch.setenv("CHATTERBOX_MAX_NEW_TOKENS", "24")
    study = env / "study"
    study.mkdir()
    knobs = dict(quality_study.VARIANTS)["reference_exact"]
    run_variant.main([str(study), "reference_exact", *[f"{k}={v}" for k, v in knobs.items()]])
    assert "CHATTERBOX_PALLAS" not in os.environ
    assert os.environ["CHATTERBOX_CFM_STREAM"] == "0"
    assert t3_model.decode_attention is k1_wrapper and decoder.flash_mha is k2_wrapper
    assert k2_calls
    record = json.loads((study / "reference_exact.json").read_text())
    assert record["plain"] == ["decode_attention"]
    assert record["request_stats"]["streamed"] == 0   # no streaming CFM
    assert read_wav(str(study / "reference_exact.wav"))[1] == record["sample_rate"]
    with pytest.raises(SystemExit):
        run_variant.main([str(study), "x", "NOT_A_PAIR"])


# ------------------------------------------------------------ parity_check
def _parity(args, capsys) -> tuple:
    with pytest.raises(SystemExit) as exc:
        parity_check.main(args)
    return exc.value.code, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_parity_check_on_the_cpu(env, monkeypatch, capsys):
    monkeypatch.setenv("CHATTERBOX_TINY_MODEL", "1")
    monkeypatch.setenv("CHATTERBOX_FORCE_CPU", "1")
    monkeypatch.setenv("CHATTERBOX_MAX_NEW_TOKENS", "24")
    k1_calls, resampled = [], []

    def k1_wrapper(*a, **kw):
        k1_calls.append(1)
        return decode_attention_plain(*a, **kw)

    real_resample = pcm.resample

    def spy_resample(x, orig, target):
        resampled.append((orig, target))
        return real_resample(x, orig, target)

    monkeypatch.setattr(t3_model, "decode_attention", k1_wrapper)
    monkeypatch.setattr(pcm, "resample", spy_resample)
    text = quality_study.TEXT
    a, b = env / "a.wav", env / "b.wav"
    # the port's own WAV: --ref is the --out just written
    rc, first = _parity(["--text", text, "--ref", str(a), "--out", str(a),
                         "--seed-request-id", "quality-study"], capsys)
    assert rc == 0 and first["mcd_db"] == 0.0
    # pinned as the JAX script pins; the swap in force: K1's wrapper unused
    assert {k: os.environ.get(k) for k in PARITY_PINS} == PARITY_PINS
    assert "CHATTERBOX_PALLAS" not in os.environ and not k1_calls
    assert t3_model.decode_attention is k1_wrapper

    rc, same = _parity(["--text", text, "--ref", str(a), "--out", str(b),
                        "--seed-request-id", "quality-study"], capsys)
    assert rc == 0 and same["mcd_db"] == 0.0 and same["lsd_db"] == 0.0 and same["pass"]
    assert b.read_bytes() == a.read_bytes()

    rc, other = _parity(["--text", text, "--ref", str(a), "--out", str(b),
                         "--mcd-threshold", "0.0"], capsys)   # request id "parity-check"
    assert rc == 1 and other["mcd_db"] > 0 and other["pass"] is False

    # a 16 kHz reference is resampled to the engine's rate; CHATTERBOX_PALLAS=1
    # keeps K1's wrapper at its call site
    wav, sr = read_wav(str(a))
    ref16 = env / "ref16.wav"
    write_wav(str(ref16), real_resample(wav, sr, 16000), 16000)
    monkeypatch.setenv("CHATTERBOX_PALLAS", "1")
    rc, r16 = _parity(["--text", text, "--ref", str(ref16), "--out", str(b),
                       "--seed-request-id", "quality-study", "--mcd-threshold", "1e9"], capsys)
    assert resampled == [(16000, sr)]
    assert rc == 0 and abs(r16["ref_s"] - r16["hyp_s"]) <= 0.01 and np.isfinite(r16["mcd_db"])
    assert k1_calls
    assert b.read_bytes() == a.read_bytes()


# ------------------------------------------------------------ export_checkpoint
def _flat_np(tree) -> dict:
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v, dtype=np.float32)
            for k, v in ckpt._flatten(tree).items()}


def test_export_checkpoint_reads_back_in_both_packages(env, monkeypatch):
    import jax.numpy as jnp

    from chatterbox_tpu.runtime import EngineConfig as JEngineConfig
    from chatterbox_tpu.runtime import checkpoint as jckpt
    from chatterbox_tpu_torch.convert import unconvert_params

    monkeypatch.setenv("CHATTERBOX_TINY_MODEL", "1")
    out = env / "export"
    export_checkpoint.main([str(out), "--tiny", "--cpu"])
    engine = TTSEngine(device="cpu")
    engine._init_models()
    want = {name: _flat_np(unconvert_params(tree)) for name, tree in engine.params.items()}

    got = ckpt.load_checkpoint(out, engine.cfg, torch.float32, "cpu")
    assert set(got) == set(want) == {"t3", "s3gen", "s3tok", "ve"}
    for name, tree in got.items():
        flat = {k: v.numpy() for k, v in ckpt._flatten(tree).items()}
        port_flat = {k: v.numpy() for k, v in ckpt._flatten(engine.params[name]).items()}
        assert flat.keys() == port_flat.keys()
        for k in flat:
            np.testing.assert_array_equal(flat[k], port_flat[k], err_msg=f"{name}/{k}")
    jgot = jckpt.load_checkpoint(out, JEngineConfig.tiny(), jnp.float32)
    for name, tree in jgot.items():
        flat = _flat_np(tree)
        assert flat.keys() == want[name].keys(), name
        for k in flat:
            np.testing.assert_array_equal(flat[k], want[name][k], err_msg=f"{name}/{k}")

    # CHATTERBOX_TP=2: the same files, written with no follower
    def no_follower(*a, **kw):
        raise AssertionError("export started a tensor-parallel follower")

    monkeypatch.setattr(tp_serving.TPGroup, "__init__", no_follower)
    monkeypatch.setenv("CHATTERBOX_TP", "2")
    out2 = env / "export-tp2"
    export_checkpoint.main([str(out2), "--tiny", "--cpu"])
    assert not multiprocessing.active_children()
    assert sorted(p.name for p in out2.iterdir()) == sorted(p.name for p in out.iterdir())
    for p in out.iterdir():
        assert (out2 / p.name).read_bytes() == p.read_bytes(), p.name


def test_export_checkpoint_needs_a_device_or_cpu(env, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_checkpoint.main([str(env / "x"), "--tiny"])
    assert not (env / "x").exists()


# ------------------------------------------------------------ gen_manifest
def test_gen_manifest_writes_both_checked_in_files(tmp_path, monkeypatch, capsys):
    path = tmp_path / "data" / "checkpoint_manifest.json"
    monkeypatch.setattr(manifest, "MANIFEST_PATH", path)
    gen_manifest.main([])
    got = path.read_bytes()
    assert got == (REPO / "chatterbox_tpu_torch" / "data" / "checkpoint_manifest.json").read_bytes()
    assert got == (REPO / "chatterbox_tpu" / "data" / "checkpoint_manifest.json").read_bytes()
    out = capsys.readouterr().out
    assert f"wrote {path}" in out and "t3_cfg.safetensors:" in out


# ------------------------------------------------------------ clone_voice
def _outcome(fn, *args):
    try:
        dest = fn(*args)
    except (FileNotFoundError, FileExistsError, ValueError) as exc:
        return type(exc).__name__, str(exc)
    return "copied", Path(dest).name, Path(dest).read_bytes()


def test_clone_voice_matches_the_jax_script(tmp_path, monkeypatch):
    from chatterbox_tpu.config import reset_config_cache

    jax_clone = _jax_script("clone_voice")
    wav = tmp_path / "speaker.wav"
    write_wav(str(wav), np.zeros(2400, np.float32), 24000)
    cases = [(str(wav),), (str(wav),), (str(wav), "named.wav"), (str(wav), "../escape.wav"),
             (str(wav), "a/b.wav"), (str(tmp_path / "missing.wav"),)]
    outcomes = {}
    for who, fn in (("jax", jax_clone.clone_voice), ("port", clone_voice.clone_voice)):
        monkeypatch.setenv("VOICES_DIR", str(tmp_path / f"voices-{who}"))
        reset_config_cache()
        outcomes[who] = [_outcome(fn, *c) for c in cases]
    reset_config_cache()
    assert outcomes["port"] == outcomes["jax"]
    assert [o[0] for o in outcomes["port"]] == ["copied", "FileExistsError", "copied", "ValueError",
                                                "ValueError", "FileNotFoundError"]


def test_clone_voice_main(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("VOICES_DIR", str(tmp_path / "voices"))
    wav = tmp_path / "speaker.wav"
    write_wav(str(wav), np.zeros(2400, np.float32), 24000)
    clone_voice.main([str(wav), "v1.wav"])
    assert capsys.readouterr().out.strip() == f"Voice registered at {tmp_path / 'voices' / 'v1.wav'}"
    with pytest.raises(SystemExit) as exc:
        clone_voice.main([])
    assert exc.value.code == 1


# ------------------------------------------------------------ demo_synthesis
def test_demo_synthesis_on_the_cpu(env, capsys):
    out = env / "demo.wav"
    demo_synthesis.main(["--cpu", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("init: ") and lines[1].startswith("TTFA: ")
    assert lines[-1] == f"wrote {out}"
    wav, sr = read_wav(str(out))
    assert sr == 24000 and wav.size > 0
    assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3


def test_demo_synthesis_without_a_device_fails():
    """In a fresh process with no CUDA device and no --cpu: a non-zero exit
    that names the device."""
    e = {k: v for k, v in os.environ.items() if k not in SET_BY_SCRIPTS}
    e.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2",
             PYTHONPATH=os.pathsep.join(filter(None, (str(REPO), e.get("PYTHONPATH")))))
    proc = subprocess.run([sys.executable, "-m", "chatterbox_tpu_torch.scripts.demo_synthesis",
                           "--out", os.devnull], env=e, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "TTFA" not in proc.stdout


# ------------------------------------------------------------ download_models
def test_download_models_calls_snapshot_download(tmp_path, monkeypatch, capsys):
    import huggingface_hub

    calls = []

    def fake(**kw):
        calls.append(kw)
        return kw["local_dir"]

    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake)
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "models"))
    download_models.main([])
    assert calls == [{"repo_id": "ResembleAI/chatterbox", "local_dir": str(tmp_path / "models")}]
    assert (tmp_path / "models").is_dir()
    assert capsys.readouterr().out.strip() == f"Models downloaded to {tmp_path / 'models'}"
    download_models.main([str(tmp_path / "elsewhere")])
    assert calls[-1]["local_dir"] == str(tmp_path / "elsewhere")


def test_download_models_without_huggingface_hub(tmp_path, monkeypatch):
    from chatterbox_tpu.config import reset_config_cache

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "models"))
    reset_config_cache()
    jax_download = _jax_script("download_models")
    messages = []
    for fn in (jax_download.download_models, download_models.download_models):
        with pytest.raises(SystemExit) as exc:
            fn()
        messages.append(str(exc.value.code))
    reset_config_cache()
    assert messages[0] == messages[1]
    assert "huggingface_hub is not installed" in messages[1]
    assert not (tmp_path / "models").exists()
