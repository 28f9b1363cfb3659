#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (chatterbox_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script exits
non-zero without printing the final line:

1. the machine: GPU name and power limit (nvidia-smi), torch/CUDA versions,
   TF32 switched off for matmuls and cuDNN (float32 means float32 here);
2. build: nvcc compiles chatterbox_tpu_torch/csrc/*.cu for sm_90a;
3. kernels against their plain PyTorch versions at main-path shapes
   (max-abs error against a stated tolerance, median CUDA-event times);
4. serve: EngineConfig.full() (int8 KV cache, random weights from a seed, a
   seeded conds.pt as the default voice, CHATTERBOX_MAX_NEW_TOKENS=140), three
   requests through engine.stream(..., output_format="wav") with the HTTP
   handler's arguments; each WAV is checked (RIFF header, sample count
   against the tokens produced, finite, not silent) and the kernels' launch
   counters must have risen during the run;
5. native KV: one full-width T3 prefill and decode slice with a bf16 cache
   must launch the kernel's bf16 body;
6. the kernels' JSON summary, the GPU line, then the final JSON line.
"""
from __future__ import annotations

import asyncio
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

KERNELS = {
    "decode_attention": {
        "source": "chatterbox_tpu_torch/csrc/decode_attention.cu",
        "replaces": "chatterbox_tpu/ops/pallas_attention_v3.py:191",
    },
    "flash_mha": {
        "source": "chatterbox_tpu_torch/csrc/flash_mha.cu",
        "replaces": "chatterbox_tpu/ops/pallas_mha.py:85",
    },
}
# Both sides compute in float32. A float32 output differs by summation order
# only; a bfloat16 output is each side's float32 result rounded to bf16, so
# the two may sit one bf16 step apart (2^-7 relative, |out| < 2 here).
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
TEXTS = [
    "Hello from the port. This request runs on one graphics card.",
    "The quick brown fox jumps over the lazy dog, while the patient engineer "
    "watches the kernels compile. Streaming speech should start quickly and "
    "keep ahead of playback. A second text chunk begins somewhere around here.",
    "Random weights speak no language, but the pipeline still has to hold together.",
]
# engine.stream's arguments besides text and request id, as the HTTP handler
# passes them for a default-voice WAV request
REQUEST = dict(output_format="wav", voice_id=None, cfg_guidance_weight=0.5,
               synthesis_temperature=0.8, text_processing_chunk_size=150,
               audio_tokens_per_slice=35, remove_trailing_milliseconds=0,
               remove_leading_milliseconds=0, chunk_overlap_strategy="full",
               crossfade_duration_milliseconds=30)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> tuple[float, float]:
    """(device ms, call ms) of one call. Device: the kernels the call
    launches, summed by torch.profiler and averaged over ``iters`` calls.
    Call: the median CUDA-event time around one call on an idle GPU, which
    also holds the host's dispatch (for a wrapper: its checks and the ctypes
    launch), since the GPU waits for it after the first event."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    if device_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return device_us / 1e3 / iters, statistics.median(times)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.1e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def check_decode_attention(results: dict) -> None:
    from chatterbox_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    B, H, Hk, S, Dh = 2, 16, 16, 1300, 64
    # (start, pos) per lane: left-pad offsets > 0; depths at, and one key
    # past, a 64-key tile boundary; a deep row near the end of the cache
    windows = [((5, 17), (65, 129)), ((0, 33), (64, 640)), ((31, 12), (1299, 700))]
    worst = {}
    for q_dtype, cache in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                           (torch.bfloat16, "int8")):
        for (s0, s1), (p0, p1) in windows:
            rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
            q = rnd(B, H, Dh).to(q_dtype)
            kn, vn = rnd(B, Hk, Dh).to(q_dtype), rnd(B, Hk, Dh).to(q_dtype)
            k, v = rnd(B, Hk, S, Dh), rnd(B, Hk, S, Dh)
            ks = vs = None
            if cache == "int8":
                ks = k.abs().amax(-1).clamp_min(1e-8) / 127.0
                vs = v.abs().amax(-1).clamp_min(1e-8) / 127.0
                k = torch.round(k / ks[..., None]).clamp(-127, 127).to(torch.int8)
                v = torch.round(v / vs[..., None]).clamp(-127, 127).to(torch.int8)
            else:
                k, v = k.to(q_dtype), v.to(q_dtype)
            start = torch.tensor([s0, s1], dtype=torch.int32, device=dev)
            pos = torch.tensor([p0, p1], dtype=torch.int32, device=dev)
            s_view = min(S, ((max(p0, p1) + 1 + 255) // 256) * 256)
            args = (q, k, v, kn, vn, start, pos, ks, vs)
            got = da.decode_attention(*args)
            want = da.decode_attention_plain(*args, s_view=s_view)
            err = compare(f"decode_attention[{cache}] start={s0},{s1} pos={p0},{p1}",
                          got, want, TOL[q_dtype])
            worst[cache] = max(worst.get(cache, 0.0), err)
        # time the middle window (a typical decode depth)
        (s0, s1), (p0, p1) = windows[1]
        start = torch.tensor([s0, s1], dtype=torch.int32, device=dev)
        pos = torch.tensor([p0, p1], dtype=torch.int32, device=dev)
        args = (q, k, v, kn, vn, start, pos, ks, vs)
        s_view = min(S, ((max(p0, p1) + 1 + 255) // 256) * 256)
        ms, call_ms = time_ms(lambda: da.decode_attention(*args))
        plain_ms, plain_call_ms = time_ms(lambda: da.decode_attention_plain(*args, s_view=s_view))
        print(f"  decode_attention[{cache}] B={B} H={H} S={S} pos={p0},{p1}: device ms "
              f"kernel {ms:.4f}, plain {plain_ms:.4f}; per call {call_ms:.4f}, "
              f"{plain_call_ms:.4f}", flush=True)
        results[cache] = {"max_abs_err": worst[cache], "ms": ms, "plain_ms": plain_ms,
                          "call_ms": call_ms, "plain_call_ms": plain_call_ms,
                          "tol": TOL[q_dtype]}


def check_flash_mha(results: dict) -> None:
    from chatterbox_tpu_torch.ops import flash_mha as fm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    B, H, dh = 2, 8, 64
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        worst, timing = 0.0, {}
        for T in (1012, 2500):
            q, k, v = (torch.randn((B, H, T, dh), generator=g, device=dev).to(dtype) for _ in range(3))
            valid = torch.ones((B, T), dtype=torch.bool, device=dev)
            valid[0, T - 37:] = False          # padded tail
            if T == 1012:
                valid[1] = False               # a lane whose keys are all masked
            else:
                valid[1, :100] = False
            got = fm.flash_mha(q, k, v, valid, scale=0.125)
            want = fm.flash_mha_plain(q, k, v, valid, scale=0.125)
            worst = max(worst, compare(f"flash_mha[{name}] T={T}", got, want, TOL[dtype]))
            if T == 1012:
                zero = got[1].float().abs().max().item()
                if zero != 0.0:
                    raise AssertionError(f"flash_mha[{name}]: all-masked lane gave {zero}, not 0")
            ms, call_ms = time_ms(lambda: fm.flash_mha(q, k, v, valid, scale=0.125))
            plain_ms, plain_call_ms = time_ms(lambda: fm.flash_mha_plain(q, k, v, valid, scale=0.125))
            print(f"  flash_mha[{name}] B={B} H={H} T={T} dh={dh}: device ms kernel {ms:.4f}, "
                  f"plain {plain_ms:.4f}; per call {call_ms:.4f}, {plain_call_ms:.4f}", flush=True)
            timing[T] = {"ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
                         "plain_call_ms": plain_call_ms}
        results[name] = {"max_abs_err": worst, **timing[1012], "T2500": timing[2500],
                         "tol": TOL[dtype]}


def write_conds(path: Path, seed: int = 7) -> None:
    """A seeded default voice in the reference conds.pt format (full size:
    a 150-token T3 prompt, a 250-token / 500-frame S3Gen prompt)."""
    g = torch.Generator().manual_seed(seed)
    t3 = {
        "speaker_emb": torch.randn((1, 256), generator=g),
        "cond_prompt_speech_tokens": torch.randint(0, 6561, (1, 150), generator=g),
        "emotion_adv": 0.5 * torch.ones(1, 1, 1),
    }
    gen = {
        "prompt_token": torch.randint(0, 6561, (1, 250), generator=g),
        "prompt_token_len": torch.tensor([250]),
        "prompt_feat": torch.randn((1, 500, 80), generator=g) * 2.0 - 6.0,
        "prompt_feat_len": torch.tensor([500]),
        "embedding": torch.randn((1, 192), generator=g),
    }
    torch.save({"t3": t3, "gen": gen}, path)


def check_wav(i: int, data: bytes, stats: dict, sr: int, spt: int, fade: int) -> float:
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE" or data[36:40] != b"data":
        raise AssertionError(f"request {i}: no RIFF/WAVE header")
    channels, rate, _, _, bits = struct.unpack("<HLLHH", data[22:36])
    if (channels, rate, bits) != (1, sr, 16):
        raise AssertionError(f"request {i}: header says {channels} ch, {rate} Hz, {bits} bit")
    pcm = np.frombuffer(data[44:], dtype="<i2")
    if pcm.size != stats["samples"]:
        raise AssertionError(f"request {i}: {pcm.size} samples in the WAV, engine emitted {stats['samples']}")
    want = sum(n + 1 for n in stats["t3_tokens"]) * spt  # + the EOS code per chunk
    if stats["synth_samples"] != want:
        raise AssertionError(f"request {i}: synthesised {stats['synth_samples']} samples, "
                             f"tokens {stats['t3_tokens']} give {want}")
    seams, rest = divmod(stats["synth_samples"] - stats["samples"], fade)
    if rest or not 0 <= seams < stats["slices"]:
        raise AssertionError(f"request {i}: crossfade accounting off ({stats})")
    wav = pcm.astype(np.float32) / 32768.0
    if not np.isfinite(wav).all() or np.abs(wav).max() < 1e-3:
        raise AssertionError(f"request {i}: silent or non-finite audio")
    return pcm.size / sr


async def serve(model_dir: Path) -> dict:
    from chatterbox_tpu_torch.ops import decode_attention as da
    from chatterbox_tpu_torch.ops import flash_mha as fm
    from chatterbox_tpu_torch.runtime.cancellation import CancellationToken
    from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine

    cfg = EngineConfig.full()
    print(f"  config: T3 {cfg.t3.num_layers}x{cfg.t3.hidden_size} H={cfg.t3.num_heads} "
          f"kv={cfg.t3.kv_cache_dtype}, S3Gen conformer {cfg.s3gen_ref.flow.input_size} "
          f"({cfg.s3gen_ref.flow.num_blocks}+{cfg.s3gen_ref.flow.num_up_blocks} blocks), "
          f"HiFT {cfg.s3gen_ref.hift.base_channels}, params {cfg.param_dtype}, "
          f"max_new_tokens {cfg.max_new_tokens}", flush=True)
    t0 = time.perf_counter()
    engine = TTSEngine(cfg, seed=0)
    await engine.ainit()
    torch.cuda.synchronize()
    print(f"  ainit {time.perf_counter() - t0:.2f} s on {engine.device}", flush=True)
    spt = cfg.gen.samples_per_token
    fade = int(engine.sr * REQUEST["crossfade_duration_milliseconds"] / 1000)
    da.reset_launches()
    fm.reset_launches()
    for i, text in enumerate(TEXTS):
        rid = f"smoke-{i}"
        data = b""
        async for chunk in engine.stream(text=text, request_id=rid,
                                         cancellation_token=CancellationToken(), **REQUEST):
            data += chunk
        stats = engine.request_stats[rid]
        audio_s = check_wav(i, data, stats, engine.sr, spt, fade)
        print(f"  request {i}: {stats['chunks']} chunk(s), tokens {stats['t3_tokens']}, "
              f"{audio_s:.2f} s audio, TTFA {stats['ttfa_s']:.3f} s, wall {stats['wall_s']:.3f} s, "
              f"RTF {stats['wall_s'] / audio_s:.3f}; T3 {stats['t3_s']:.2f} s for "
              f"{stats['t3_steps']} steps ({1e3 * stats['t3_s'] / stats['t3_steps']:.1f} ms/step "
              f"incl. prefill), S3Gen {stats['s3gen_s']:.2f} s for {stats['slices']} calls",
              flush=True)
    launches = {"decode_attention": dict(da.launches), "flash_mha": dict(fm.launches)}
    print(f"  launches during serving: {launches}", flush=True)
    if not any(s["chunks"] >= 2 for s in engine.request_stats.values()):
        raise AssertionError("no request spanned two text chunks")
    if da.launches["int8"] == 0 or fm.launches["float32"] == 0:
        raise AssertionError(f"the main path did not run both kernels: {launches}")

    print("== 5. native (bf16) KV cache at full width", flush=True)
    from chatterbox_tpu_torch.models.t3 import make_decode_state, t3_decode_slice, t3_prefill

    t3c = cfg.t3.with_(kv_cache_dtype="native")
    lanes = engine.voice_cache["default"].t3_cond_lanes
    text = torch.zeros((2, 32), dtype=torch.long, device=engine.device)
    text[:, :20] = torch.randint(1, 700, (20,), device=engine.device)
    before = da.launches["native"]
    with torch.inference_mode():
        cache = t3_prefill(engine.params["t3"], t3c, lanes, text,
                           torch.full((2,), 20, device=engine.device))
        gen = torch.Generator(device=engine.device).manual_seed(5)
        state = make_decode_state(t3c, 1, 0.8, 0.95, 0.5, 1.2, gen, engine.device)
        toks = t3_decode_slice(engine.params["t3"], t3c, cache, state, 8)
    torch.cuda.synchronize()
    rose = da.launches["native"] - before
    if cache["k"].dtype != torch.bfloat16 or rose == 0:
        raise AssertionError(f"native KV: cache {cache['k'].dtype}, bf16-body launches {rose}")
    if not ((toks >= 0) & (toks < t3c.speech_vocab_size)).all():
        raise AssertionError("native KV: tokens out of range")
    print(f"  native KV: prefill + 8-step slice, tokens {toks[0].tolist()}, "
          f"bf16-body launches {rose}", flush=True)
    engine.shutdown()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import chatterbox_tpu_torch  # noqa: F401  (fails outside a checkout)
    from chatterbox_tpu_torch.ops import _build

    print("== 1. machine", flush=True)
    print(f"  {gpu_line()}", flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    print("== 2. build", flush=True)
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"  {info.get('command', info['path'])}", flush=True)
    print(f"  built in {info['seconds']:.2f} s (cached: {info['cached']}); "
          f"loaded after {time.perf_counter() - t0:.2f} s", flush=True)
    if info.get("log"):
        print("  " + info["log"].strip().replace("\n", "\n  "), flush=True)

    print("== 3. kernels against their plain versions", flush=True)
    k1, k2 = {}, {}
    check_decode_attention(k1)
    check_flash_mha(k2)

    print("== 4. serve (EngineConfig.full, int8 KV)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = Path(tmp) / "models"
        model_dir.mkdir()
        write_conds(model_dir / "conds.pt")
        os.environ.update(MODEL_PATH=str(model_dir), CHATTERBOX_MAX_NEW_TOKENS="140",
                          CHATTERBOX_KV="int8")
        launches = asyncio.run(serve(model_dir))

    print("== 6. summary", flush=True)
    # ms / plain_ms: device time per call; call_ms: with the host's dispatch
    summary = {"kernels": [
        dict(name="decode_attention", route="cuda", **KERNELS["decode_attention"],
             launches=launches["decode_attention"]["int8"], body="int8", **k1["int8"],
             other_bodies={"bfloat16": k1["bfloat16"], "float32": k1["float32"]}),
        dict(name="flash_mha", route="cuda", **KERNELS["flash_mha"],
             launches=launches["flash_mha"]["float32"], body="float32", **k2["float32"],
             other_bodies={"bfloat16": k2["bfloat16"]}),
    ]}
    print(gpu_line(), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
