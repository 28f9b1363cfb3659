#!/usr/bin/env python3
"""Where the time goes in the port's serving path, on one GPU.

    python3 chip_profile.py [--out chiprun_out/chip_profile.json]

The configuration is chip_smoke.py's per-request phase: EngineConfig.full()
with an int8 KV cache, random weights from seed 0, the seeded conds.pt as the
default voice, CHATTERBOX_MAX_NEW_TOKENS=140, MAX_DECODE_SLOTS=1, TF32 off. After one warm-up request it
measures, each figure on its own line:

1. T3 alone: the prefill of the first request's text, then 35-step decode
   slices. Host wall per step is the median of 3 slices, unprofiled; device
   time per step and K1's share of it come from one slice under
   torch.profiler (CUDA activity only, so the host path is barely slowed).
2. S3Gen alone at T = 35 and 140 tokens (plus the 250-token prompt), as the
   S3Gen producer calls it: host wall per call (median of 3) and device time
   per call with K2's share (one call under the profiler).
3. One 1-chunk request through engine.stream: TTFA, wall, RTF and the host
   wall of each producer, unprofiled; then the same request again under the
   profiler, whose device time over the unprofiled wall is the device's busy
   share. The same request id gives the same tokens and noise, so both runs
   do the same device work.

The 12 kernels with the most device time in each profiled phase are printed,
and every number goes to --out as JSON.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import REQUEST, TEXTS, gpu_line, write_conds

# the CUDA kernels of each wrapper, matched in the profiler's kernel names
# (K1 launches a slice kernel and a combine kernel per call)
KERNELS = {"K1": ("decode_slice_kernel", "decode_combine_kernel"), "K2": ("flash_mha_kernel",)}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev):
    """(host seconds, result) of one call, the device drained on both ends."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return time.perf_counter() - t0, out


def profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


def kernel_rows(prof) -> dict:
    """{kernel name: (device µs, calls)} from a finished profiler."""
    rows = {e.key: (e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0}
    if not rows:
        raise RuntimeError("torch.profiler recorded no device time")
    return rows


def device_kernels(fn, dev):
    """Run fn under torch.profiler → (kernel_rows, result)."""
    with profiler() as prof:
        out = fn()
        sync(dev)
    return kernel_rows(prof), out


def summarize(name: str, rows: dict, per: int = 1) -> dict:
    """Print and return the total, the K1/K2 shares and the top kernels."""
    total = sum(us for us, _ in rows.values())
    share = {k: sum(us for key, (us, _) in rows.items() if any(n in key for n in names)) / total
             for k, names in KERNELS.items()}
    calls = {k: sum(c for key, (_, c) in rows.items() if any(n in key for n in names))
             for k, names in KERNELS.items()}
    print(f"  {name}: device {total / 1e3 / per:.3f} ms per unit ({per} units); "
          f"K1 {100 * share['K1']:.1f} % ({calls['K1']} calls), K2 {100 * share['K2']:.1f} % "
          f"({calls['K2']} calls)", flush=True)
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]
    for key, (us, n) in top:
        print(f"    {100 * us / total:5.1f} %  {us / 1e3:9.3f} ms  {n:6d}x  {key[:100]}", flush=True)
    return {"device_ms": total / 1e3, "units": per, "device_ms_per_unit": total / 1e3 / per,
            "share": share, "calls": calls,
            "top": [{"kernel": k, "device_ms": us / 1e3, "calls": n} for k, (us, n) in top]}


def profile_t3(engine, out: dict) -> None:
    from chatterbox_tpu_torch.models.t3 import make_decode_state, t3_decode_slice, t3_prefill
    from chatterbox_tpu_torch.runtime.engine import _bucket

    t3p, t3c, dev = engine.params["t3"], engine.cfg.t3, engine.device
    ids = engine.tokenizer.text_to_tokens(TEXTS[0])[0]
    ids = np.concatenate([[t3c.start_text_token], ids[: t3c.max_text_tokens - 2],
                          [t3c.stop_text_token]]).astype(np.int64)
    T_pad = _bucket(len(ids), engine.cfg.text_bucket, t3c.max_text_tokens)
    text = np.zeros((2, T_pad), np.int64)
    text[:, : len(ids)] = ids
    lanes = engine.voice_cache["default"].t3_cond_lanes
    with torch.inference_mode():
        prefill = lambda: t3_prefill(t3p, t3c, lanes, torch.as_tensor(text, device=dev),  # noqa: E731
                                     torch.full((2,), len(ids), device=dev))
        prefill_s, cache = timed(prefill, dev)
        state = make_decode_state(t3c, [3], 0.8, 0.95, 0.5, 1.2, dev)
        pos0, n, produced = t3c.cond_len + T_pad, 35, 0
        walls = []

        def one_slice():
            nonlocal produced
            s_view = min(pos0 + 1 + t3c.max_speech_tokens,
                         ((pos0 + produced + n + 1 + 255) // 256) * 256)
            toks = t3_decode_slice(t3p, t3c, cache, state, n, s_view)
            produced += n
            return toks.cpu()

        one_slice()  # warm
        for _ in range(3):
            walls.append(timed(one_slice, dev)[0])
        rows, _ = device_kernels(one_slice, dev)
    step_ms = 1e3 * statistics.median(walls) / n
    print(f"  T3 prefill {1e3 * prefill_s:.1f} ms; 35-step slice host wall "
          f"{[round(1e3 * w, 1) for w in walls]} ms → {step_ms:.2f} ms per step", flush=True)
    out["t3"] = {"prefill_ms": 1e3 * prefill_s, "slice_wall_ms": [1e3 * w for w in walls],
                 "step_wall_ms": step_ms, **summarize("T3 decode, per step", rows, per=n)}
    out["t3"]["device_busy"] = out["t3"]["device_ms_per_unit"] / step_ms


def profile_s3gen(engine, out: dict) -> None:
    from chatterbox_tpu_torch.models.s3gen_ref import draw_noise, s3gen_ref_inference

    s3p, s3c, dev = engine.params["s3gen"], engine.gen_cfg, engine.device
    ref = engine.voice_cache["default"].gen_ref
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    for T in (35, 140):
        tokens = torch.as_tensor(rng.integers(0, s3c.vocab_size, (1, T)), device=dev)

        def call():
            gen.manual_seed(1)
            w, _ = s3gen_ref_inference(
                s3p, s3c, tokens, torch.tensor([T], device=dev), ref,
                torch.zeros((1, T * s3c.samples_per_token), device=dev),
                torch.tensor([0], device=dev), draw_noise(s3c, 1, T, gen, dev))
            return w.float().cpu()

        with torch.inference_mode():
            call()  # warm
            walls = [timed(call, dev)[0] for _ in range(3)]
            rows, _ = device_kernels(call, dev)
        wall_ms = 1e3 * statistics.median(walls)
        print(f"  S3Gen T={T}: host wall {[round(1e3 * w, 1) for w in walls]} ms", flush=True)
        rec = {"wall_ms": [1e3 * w for w in walls], **summarize(f"S3Gen T={T}, per call", rows)}
        rec["device_busy"] = rec["device_ms"] / wall_ms
        out[f"s3gen_T{T}"] = rec


async def profile_request(engine, out: dict) -> None:
    from chatterbox_tpu_torch.runtime.cancellation import CancellationToken

    async def request(rid: str) -> dict:
        async for _ in engine.stream(text=TEXTS[0], request_id=rid,
                                     cancellation_token=CancellationToken(), **REQUEST):
            pass
        return dict(engine.request_stats[rid])

    await request("profile-warm")
    stats = await request("profile-request")
    audio_s = stats["samples"] / engine.sr
    print(f"  request (1 chunk, {stats['t3_tokens']} tokens, {audio_s:.2f} s audio): "
          f"TTFA {stats['ttfa_s']:.3f} s, wall {stats['wall_s']:.3f} s, "
          f"RTF {stats['wall_s'] / audio_s:.3f}; T3 {stats['t3_s']:.2f} s for {stats['t3_steps']} "
          f"steps ({1e3 * stats['t3_s'] / stats['t3_steps']:.1f} ms/step), S3Gen "
          f"{stats['s3gen_s']:.2f} s for {stats['slices']} calls", flush=True)
    with profiler() as prof:
        prof_stats = await request("profile-request")
        sync(engine.device)
    rec = {"stats": stats, "profiled_wall_s": prof_stats["wall_s"],
           **summarize("request, whole", kernel_rows(prof))}
    rec["device_busy"] = rec["device_ms"] / 1e3 / stats["wall_s"]
    print(f"  device busy {rec['device_ms'] / 1e3:.3f} s of the unprofiled wall "
          f"{stats['wall_s']:.3f} s = {100 * rec['device_busy']:.1f} % "
          f"(profiled wall {prof_stats['wall_s']:.3f} s)", flush=True)
    out["request"] = rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/chip_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"gpu": gpu_line(), "torch": torch.__version__, "cuda": torch.version.cuda}
    print(out["gpu"], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        write_conds(Path(tmp) / "conds.pt")
        os.environ.update(MODEL_PATH=tmp, CHATTERBOX_MAX_NEW_TOKENS="140", CHATTERBOX_KV="int8",
                          MAX_DECODE_SLOTS="1")

        async def run():
            engine = TTSEngine(EngineConfig.full(), seed=0)
            await engine.ainit()
            print("== request", flush=True)
            await profile_request(engine, out)
            print("== T3 alone", flush=True)
            profile_t3(engine, out)
            print("== S3Gen alone", flush=True)
            profile_s3gen(engine, out)
            engine.shutdown()

        asyncio.run(run())
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
