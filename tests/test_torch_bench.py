"""The port's bench entry points on the CPU at the tiny configs.

``serve_bench``, ``bench`` and ``ttfa_trace`` run in process with
``--device cpu --tiny`` (EngineConfig.tiny_ref(); 2 decode slots, 8 tokens
per chunk): their rows, the capacity sweep's stop rule on made-up RTFs, the
percentile helper against numpy, bench's last line and what it reads, the
A/B driver's turn order and medians (its subprocess call replaced), the TTFA
timeline, and ``runtime.synthetic``'s model directory booting the engine.
No timing is held here: a CPU run measures nothing about the card.
"""
import asyncio
import json
import math
import os
import statistics
import subprocess

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (caps torch's threads)

from chatterbox_tpu_torch.audio.pcm import make_wav_header
from chatterbox_tpu_torch.models.s3gen_ref import S3GenRefConfig
from chatterbox_tpu_torch.models.t3 import T3Config
from chatterbox_tpu_torch.models.voice_encoder import VoiceEncoderConfig
from chatterbox_tpu_torch.runtime import synthetic
from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine
from chatterbox_tpu_torch.scripts import ab, bench, common, serve_bench, ttfa_trace

WAVE_FIELDS = {"streams", "realtime_streams", "ttfa_p50_ms", "ttfa_p99_ms", "rtf_p50", "rtf_max",
               "audio_s_total", "wall_s", "aggregate_x", "stages", "arch", "max_new_tokens",
               "device"}
CPU_TINY = ["--device", "cpu", "--tiny"]


@pytest.fixture
def env(tmp_path, monkeypatch):
    """Every variable the entry points set, restored after the test."""
    for k, v in {"MAX_DECODE_SLOTS": "2", "CHATTERBOX_MAX_NEW_TOKENS": "8",
                 "CHATTERBOX_S3GEN_ARCH": "ref", "MODEL_PATH": str(tmp_path / "unused"),
                 "VOICES_DIR": str(tmp_path / "voices"),
                 "PRELOADED_VOICES_DIR": str(tmp_path / "preloaded"),
                 "CONCURRENT_REQUESTS_PER_WORKER": "0", "BENCH_S3_BATCH": "2"}.items():
        monkeypatch.setenv(k, v)
    for k in ("CHATTERBOX_PALLAS", "CHATTERBOX_FLASH", "CHATTERBOX_CFM_PROMPT_CACHE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _rows(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _check_wave(row: dict) -> None:
    assert WAVE_FIELDS <= set(row), row
    assert 0 <= row["realtime_streams"] <= row["streams"]
    for k in ("ttfa_p50_ms", "ttfa_p99_ms", "rtf_p50", "rtf_max", "audio_s_total", "wall_s",
              "aggregate_x"):
        assert math.isfinite(row[k]) and row[k] > 0, (k, row)
    assert row["ttfa_p50_ms"] <= row["ttfa_p99_ms"] and row["rtf_p50"] <= row["rtf_max"]
    assert row["arch"] == "ref" and row["max_new_tokens"] == 8 and row["device"] == "cpu"
    assert {"t3_decode_device", "s3gen_device"} <= set(row["stages"])


def test_serve_bench_waves(env, capsys):
    out = env / "sb.json"
    serve_bench.main([*CPU_TINY, "--streams", "2", "--warmup-waves", "1", "--out", str(out)])
    rows = _rows(capsys.readouterr().out)
    assert [r["mode"] for r in rows] == ["cold_start", "wave", "wave"]
    assert rows[0]["source"] == "random init, seed 0" and rows[0]["ainit_s"] > 0
    assert [r["overlap"] for r in rows[1:]] == ["full", "zero"]
    assert all(r["attention"] == "kernels" for r in rows)
    for r in rows[1:]:
        _check_wave(r)
        assert r["streams"] == 2
    saved = json.loads(out.read_text())
    assert saved["results"] == rows and saved["partial"] is False and saved["tiny"] is True


def test_serve_bench_capacity_sweep(env, capsys, monkeypatch):
    """Two sizes; nothing keeps real time on the CPU, so the sweep stops
    after the first wave and the capacity is 0 (no profiled wave: the busy
    share is the GPU's). Run with --plain-attention: the plain versions
    stand in at the model's two call sites (the wrappers there, here
    replaced by ones that fail, are never called) and are put back after."""
    from chatterbox_tpu_torch.models.s3gen_ref import decoder
    from chatterbox_tpu_torch.models.t3 import model as t3_model

    def wrapper_called(*a, **kw):
        raise AssertionError("a kernel's wrapper ran under --plain-attention")

    monkeypatch.setattr(t3_model, "decode_attention", wrapper_called)
    monkeypatch.setattr(decoder, "flash_mha", wrapper_called)
    out = env / "sb.json"
    serve_bench.main([*CPU_TINY, "--capacity", "--streams-list", "1,2", "--overlap", "full",
                      "--warmup-waves", "0", "--plain-attention", "--out", str(out)])
    assert t3_model.decode_attention is decoder.flash_mha is wrapper_called
    rows = _rows(capsys.readouterr().out)
    assert all(r["attention"] == "plain" for r in rows)
    assert [r["mode"] for r in rows] == ["cold_start", "capacity_wave", "capacity"]
    _check_wave(rows[1])
    assert rows[1]["streams"] == 1 and rows[1]["realtime_streams"] == 0
    assert rows[2]["capacity_streams"] == {"full": 0}


def _fake_wave(rtfs_by_size):
    async def wave(n):
        results = [{"ttfa_s": 0.5, "rtf": r, "audio_s": 1.0} for r in rtfs_by_size[n]]
        return common.wave_row(results, 2.0, {})
    return wave


@pytest.mark.parametrize("rtfs, ran, capacity", [
    ({1: [0.5], 4: [0.6] * 4, 8: [0.9] * 8}, [1, 4, 8], 8),
    ({1: [0.5], 4: [0.6, 0.7, 0.8, 1.0], 8: [0.2] * 8}, [1, 4], 1),
    ({1: [1.3], 4: [0.6] * 4, 8: [0.2] * 8}, [1], 0),
    ({1: [0.99], 4: [0.5, 0.5, 0.5, 0.5], 8: [0.5] * 7 + [1.5]}, [1, 4, 8], 4),
])
def test_capacity_stop_rule(rtfs, ran, capacity):
    """Upward until the first wave in which a stream had RTF ≥ 1; the
    capacity is the largest wave before it."""
    rows, cap = asyncio.run(serve_bench.capacity_sweep([1, 4, 8], _fake_wave(rtfs)))
    assert [r["streams"] for r in rows] == ran and cap == capacity
    for r in rows:
        assert r["realtime_streams"] == sum(x < 1 for x in rtfs[r["streams"]]) <= r["streams"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 16, 24, 32, 99, 100, 101])
def test_percentile_index_rule(n):
    """serve_bench's p99 rule (element min(n - 1, int(0.99·n)) of the sorted
    values) is numpy's "higher" percentile at these sizes; p50 is the
    median."""
    v = np.random.default_rng(n).standard_normal(n).tolist()
    for q in (0.5, 0.9, 0.99):
        assert common.percentile(v, q) == sorted(v)[min(n - 1, int(q * n))] \
            == np.percentile(v, 100 * q, method="higher")
    row = common.wave_row([{"ttfa_s": t, "rtf": 2.0, "audio_s": 1.0} for t in v], 1.0, {})
    assert row["ttfa_p50_ms"] == round(1e3 * statistics.median(v), 1)
    assert row["ttfa_p99_ms"] == round(1e3 * np.percentile(v, 99, method="higher"), 1)


def _sweep_file(path, **over):
    desc = {"tiny": False, "arch": "ref", "max_new_tokens": 140, "device": "NVIDIA H100 80GB HBM3"}
    wave = {"mode": "capacity_wave", "overlap": "full", "streams": 1, "realtime_streams": 0,
            "rtf_p50": 2.5, "ttfa_p50_ms": 900.0, "aggregate_x": 0.4, **desc}
    rows = [wave, {**wave, "mode": "profiled", "streams": 16, "rtf_p50": 4.1, "aggregate_x": 1.2},
            {"mode": "capacity", "capacity_streams": {"full": 0, "zero": 0}, **desc}]
    path.write_text(json.dumps({**desc, **over, "measured_at": "t", "results": rows}))
    return desc


@pytest.mark.parametrize("change, measured", [
    ({}, True), ({"device": "cpu"}, False), ({"arch": "dit"}, False),
    ({"max_new_tokens": 35}, False), ({"tiny": True}, False),
])
def test_bench_headline_labels(tmp_path, change, measured):
    """MEASURED only from a capacity sweep of this card, arch, decode cap and
    size, with the best RTF and the overload throughput beside it; else
    ANALYTIC. The value is the full mode's capacity, vs_baseline over 16."""
    path = tmp_path / "torch_serve_bench.json"
    desc = _sweep_file(path, **change)
    want = {k: v for k, v in desc.items() if k != "tiny"}
    derived = {"streams": 3, "rtf_single": 0.8, "ttfa_ms": 700.0}
    line = bench.headline(want, derived, bench.load_measured(path, desc))
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "concurrent_realtime_streams_per_chip"
    if measured:
        assert line["value"] == 0 and line["vs_baseline"] == 0.0
        assert "MEASURED" in line["unit"] and "best rtf_p50=2.5 at 1 streams" in line["unit"]
        assert "overload=1.2x realtime" in line["unit"] and "analytic=3" in line["unit"]
    else:
        assert line["value"] == 3 and line["vs_baseline"] == round(3 / 16, 3)
        assert "ANALYTIC" in line["unit"]
    assert bench.load_measured(tmp_path / "absent.json", desc) is None


def test_bench_run_never_reads_tpu_results(env, capsys):
    """A capacity sweep in ./serve_bench_results.json (the TPU's file) is
    not read: the last line is the analytic figure; the file cannot be an
    output either."""
    _sweep_file(env / common.TPU_RESULTS, device="cpu", tiny=True, max_new_tokens=8)
    bench.main([*CPU_TINY, "--out", str(env / "none.json")])
    rows = _rows(capsys.readouterr().out)
    stages, last = rows[-2], rows[-1]
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert "ANALYTIC" in last["unit"] and last["value"] == stages["analytic"]["streams"]
    for k in ("prefill", "slice_1", "slice_2", "s3gen_B1", "s3gen_B2"):
        assert stages[k]["host_ms"] > 0 and "event_ms" not in stages[k]   # no device time on a CPU
    with pytest.raises(SystemExit, match=common.TPU_RESULTS):
        bench.main([*CPU_TINY, "--out", common.TPU_RESULTS])


def test_bench_needs_a_device_or_the_cpu(env, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--tiny", "--out", str(env / "x.json")])


def test_ab_turn_order_and_medians(tmp_path, monkeypatch, capsys):
    calls = []

    def fake_run(cmd, env, cwd, stdout, text):
        arm = env["ARM"]
        turn = sum(1 for c in calls if c[0] == arm)
        calls.append((arm, cwd, env.get("PYTHONPATH", ""), cmd))
        rtf = {"A": [2.0, 3.0, 2.5], "B": [4.0, 4.5, 6.0]}[arm][turn]
        row = {"mode": "wave", "overlap": "full", "streams": 16, "rtf_p50": rtf, "stages": {}}
        return subprocess.CompletedProcess(cmd, 0, stdout="log line\n" + json.dumps(row) + "\n")

    monkeypatch.setattr(ab.subprocess, "run", fake_run)
    monkeypatch.setenv("PYTHONPATH", "")
    out = tmp_path / "ab.json"
    ab.main(["--arm", "A:ARM=A", "--arm", f"B:ARM=B,--plain-attention:{tmp_path}",
             "--turns", "3", "--out", str(out), "--", "--streams", "16", "--overlap", "full"])
    assert [c[0] for c in calls] == ["A", "B"] * 3
    assert all(c[1] is None for c in calls if c[0] == "A")
    assert all(c[1] == str(tmp_path) and c[2].startswith(str(tmp_path)) for c in calls if c[0] == "B")
    assert calls[0][3][-4:-2] == ["--overlap", "full"] and calls[0][3][2].endswith("serve_bench")
    assert all(("--plain-attention" in c[3]) == (c[0] == "B") for c in calls)
    summary = _rows(capsys.readouterr().out)[-1]
    rtf = summary["fields"]["rtf_p50"]
    assert summary["ab"] == "mode=wave/overlap=full/streams=16"
    assert rtf["A"] == {"median": 2.5, "spread": 1.0, "values": [2.0, 3.0, 2.5]}
    assert rtf["B"] == {"median": 4.5, "spread": 2.0, "values": [4.0, 4.5, 6.0]}
    assert json.loads(out.read_text())["order"] == ["A", "B"] * 3
    for bad in ("", ":X=1", "A:X"):
        with pytest.raises(ValueError):
            ab.parse_arm(bad)


@pytest.mark.parametrize("load", [0, 1])
def test_ttfa_trace_timeline(env, capsys, load):
    """Unloaded, the row breaks the TTFA down by stage; behind a background
    request the events are every stream's, so it gives the TTFA alone."""
    out = env / "trace.json"
    ttfa_trace.main([*CPU_TINY, "--warmups", "1" if not load else "0", "--load", str(load),
                     "--load-settle-s", "0.5", "--out", str(out)])
    row = _rows(capsys.readouterr().out)[-1]
    assert "timeline" not in row and row["ttfa_audio_s"] >= row["first_body_s"] > 0
    assert row["background_load"] == load
    timeline = json.loads(out.read_text())[-1]["timeline"]
    marks = {e["stage"]: e["end_s"] for e in timeline if e["stage"].startswith("client")}
    assert marks["client_first_audio_byte"] >= marks["client_first_body_byte"] > 0
    stages = [e for e in timeline if not e["stage"].startswith("client")]
    assert {"t3_prefill_device", "t3_decode_device", "s3gen_device"} <= {e["stage"] for e in stages}
    if load:
        assert row["timeline_of"] == "every stream"
        assert "pre_ttfa_stage_ms" not in row and "unaccounted_ms" not in row
        return
    assert row["timeline_of"] == "this request"
    assert all(0 <= e["start_s"] <= e["end_s"] for e in stages)
    assert row["pre_ttfa_stage_ms"] and math.isfinite(row["unaccounted_ms"])


def test_synthetic_model_directory_boots(tmp_path, env, capsys):
    """The writer's files at the tiny configs boot EngineConfig.tiny_ref():
    three files read clean, the default voice from conds.pt, the
    tokenizer.json's ids; then serve_bench's --write-model-dir boots the
    same way and reports the load."""
    model = tmp_path / "model"
    model.mkdir()
    info = synthetic.write_reference_checkpoint(model, T3Config.tiny(), VoiceEncoderConfig.tiny(),
                                                S3GenRefConfig.tiny())
    assert set(info["files"]) == {"t3_cfg.safetensors", "ve.safetensors", "s3gen.safetensors"}
    assert info["bytes"] == sum((model / f).stat().st_size for f in info["files"])
    os.environ["MODEL_PATH"] = str(model)
    engine = TTSEngine(EngineConfig.tiny_ref(), device="cpu")
    asyncio.run(engine.ainit())
    try:
        report = engine.load_report
        assert set(report["files"]) == set(info["files"])
        for f in report["files"].values():
            assert not (f["mismatched"] or f["missing"] or f["unused"]), f
        assert engine.tokenizer.is_pretrained
        assert engine.tokenizer.text_to_tokens(synthetic.TOKENIZER_SENTENCE)[0].tolist() \
            == synthetic.TOKENIZER_IDS
        assert engine.voice_cache["default"].t3_cond_lanes.shape[0] == 2
    finally:
        engine.shutdown()
    serve_bench.main([*CPU_TINY, "--write-model-dir", str(tmp_path / "written"), "--streams", "1",
                      "--overlap", "full", "--warmup-waves", "0", "--out", str(tmp_path / "sb.json")])
    cold, wave = _rows(capsys.readouterr().out)
    assert cold["source"] == "model directory" and cold["load_s"] > 0 and cold["load_gb_s"] > 0
    assert cold["written_bytes"] == info["bytes"]
    _check_wave(wave)


def test_codes_outside_s3gen_vocab_are_counted(env, monkeypatch):
    """A sampled code that S3Gen's vocabulary lacks (T3's is larger) is
    dropped before synthesis, as in the JAX engine; the request's record
    counts it (``dropped_codes``), and the WAV check holds the sample count
    to the codes S3Gen saw, and fails without that count."""
    import types

    from chatterbox_tpu_torch.runtime.scheduler import BatchedT3Decoder

    decode_chunk = BatchedT3Decoder.decode_chunk

    async def one_bad_code(self, *a, **kw):
        # each chunk's fifth code: its first slice (the 3-token look-ahead)
        # keeps 3 codes and needs no padding
        seen = 0
        async for row in decode_chunk(self, *a, **kw):
            if seen <= 4 < seen + len(row):
                row = row.copy()
                row[4 - seen] = 7000
            seen += len(row)
            yield row

    monkeypatch.setattr(BatchedT3Decoder, "decode_chunk", one_bad_code)
    args = types.SimpleNamespace(device="cpu", tiny=True, model_dir=None, write_model_dir=None)

    async def go():
        engine, _ = await common.boot_engine(args, env, 1)
        try:
            r = await common.timed_request(engine, "bad-code", "full")
            return r, dict(engine.request_stats["bad-code"])
        finally:
            engine.shutdown()

    r, stats = asyncio.run(go())
    assert stats["dropped_codes"] == stats["chunks"] == 2 and r["audio_s"] > 0
    gen = EngineConfig.tiny_ref().gen
    spt, sr = gen.samples_per_token, gen.sample_rate
    assert stats["synth_samples"] == (sum(n + 1 for n in stats["t3_tokens"]) - 2) * spt
    wav = make_wav_header(sr, 1, 16) + np.full(stats["samples"], 1000, "<i2").tobytes()
    fade = int(sr * common.request_args("full")["crossfade_duration_milliseconds"] / 1000)
    assert common.check_wav("bad-code", wav, stats, sr, spt, fade) == stats["samples"] / sr
    with pytest.raises(AssertionError, match="synthesised"):
        common.check_wav("bad-code", wav, {**stats, "dropped_codes": 0}, sr, spt, fade)
