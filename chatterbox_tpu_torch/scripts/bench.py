"""Stage micro-measurements and the headline serving metric (the counterpart
of ``bench.py``).

    python -m chatterbox_tpu_torch.scripts.bench
    python -m chatterbox_tpu_torch.scripts.bench --device cpu --tiny   # CPU, tiny config

On serve_bench's engine (``common.boot_engine``: ``EngineConfig.full()``,
int8 KV, MAX_DECODE_SLOTS slots, the S3Gen arch CHATTERBOX_S3GEN_ARCH names,
"ref" unless set) it times, each as the mean host wall of ``REPEATS`` calls
that end in a synchronise, their CUDA-event span, and one call's device
busy time under torch.profiler (the last two on the GPU only):

- T3 prefill of TEXT's first chunk into one slot of the batched decoder;
- one SLICE-token decode slice with 1 slot active, and with every slot;
- one S3Gen chunk of 2·SLICE tokens through the arch's chunk inference (the
  per-request path's call, with the default voice's CFM prompt cache where
  the engine keeps one) at batch 1 and at each batch in BENCH_S3_BATCH
  (default "4,8,16").

From these it derives bench.py's analytic streams figure: a stream needs one
decode slice and one S3Gen chunk per SLICE tokens (1.4 s of audio), the slots
share the slice, and the chunks batch. It prints the measurements as one
JSON row, then a last line in bench.py's shape: ``{"metric":
"concurrent_realtime_streams_per_chip", "value", "unit", "vs_baseline"}``.
The value is the capacity that ``serve_bench --capacity`` measured, when
``--out`` holds such a sweep from this card, arch, decode cap and size (the
unit says MEASURED, with the best RTF and the audio seconds per wall second
beside it); otherwise the analytic figure (the unit says ANALYTIC). There is
no fallback: without a CUDA device and without ``--device cpu`` it raises,
and a failure mid-run exits non-zero.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import common

SLICE = 35      # tokens per decode slice (the serving default)
REPEATS = 3
BASELINE_STREAMS = 16.0


def timed(fn, device: torch.device, repeats: int = REPEATS) -> dict:
    """One warm call, then ``repeats`` calls → their mean host wall (ms) up
    to a synchronise; on the GPU also their mean CUDA-event span (ms, the
    device's timeline between the first launch and the last, idle gaps
    included) and one more call's device busy ms under torch.profiler."""
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    fn()
    sync()
    out = {}
    if cuda:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    if cuda:
        b.record()
    sync()
    out["host_ms"] = round(1e3 * (time.perf_counter() - t0) / repeats, 3)
    if cuda:
        out["event_ms"] = round(a.elapsed_time(b) / repeats, 3)
        with common.profiler() as prof:
            fn()
            sync()
        out["device_busy_ms"] = round(common.device_ms(prof)[1], 3)
    return out


def text_lanes(engine, text: str):
    """A text chunk's T3 input as the engine builds it → (lanes [2, T_pad], length)."""
    from ..runtime.engine import _bucket

    t3c = engine.cfg.t3
    ids = engine.tokenizer.text_to_tokens(text)[0]
    ids = np.concatenate([[t3c.start_text_token], ids[: t3c.max_text_tokens - 2],
                          [t3c.stop_text_token]]).astype(np.int64)
    T_pad = _bucket(len(ids), engine.cfg.text_bucket, t3c.max_text_tokens)
    lanes = np.zeros((2, T_pad), np.int64)
    lanes[:, : len(ids)] = ids
    return lanes, len(ids)


@torch.inference_mode()
def measure_t3(engine) -> dict:
    """Prefill into one slot; one SLICE-step slice with one slot, then with
    every slot, active (idle slots re-emit EOS inside the batch)."""
    from ..text import split_text_into_chunks

    dec = engine.decoder
    lanes = engine.voice_cache["default"].t3_cond_lanes
    chunk = split_text_into_chunks(
        common.TEXT, common.request_args("full")["text_processing_chunk_size"])[0]
    text, n = text_lanes(engine, chunk)

    def insert(slot: int) -> None:
        dec.insert(slot, lanes, text, n, 0.8, 0.95, 0.5, 1.2, seed=slot)

    def view() -> int:
        # the plain attention (CHATTERBOX_PALLAS=0) reads this many rows; the
        # kernel stops at each row's own pos
        need = int(dec.cache["pos"].max()) + SLICE * (REPEATS + 2) + 1
        return min(dec.cfg.max_seq_len, -(-need // 256) * 256)

    out = {"prefill": timed(lambda: insert(0), engine.device)}
    v = view()
    out["slice_1"] = timed(lambda: dec.run_slice(SLICE, v), engine.device)
    for slot in range(dec.n_slots):
        insert(slot)
    v = view()
    out[f"slice_{dec.n_slots}"] = timed(lambda: dec.run_slice(SLICE, v), engine.device)
    for slot in range(dec.n_slots):
        dec.finish(slot)
    return out


@torch.inference_mode()
def measure_s3gen(engine, batches) -> dict:
    """One chunk of 2·SLICE tokens through the arch's chunk inference at
    batch 1 and at each of ``batches``, in the default voice."""
    cfg, dev = engine.gen_cfg, engine.device
    conds = engine.voice_cache["default"]
    cache = engine._cfm_cache_for("default", conds)
    T = 2 * SLICE
    out = {}
    for B in [1, *batches]:
        g = torch.Generator(device=dev).manual_seed(3)
        tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev)
        tlen = torch.full((B,), T, dtype=torch.int64, device=dev)
        ref = {k: torch.cat([v] * B) for k, v in conds.gen_ref.items()}
        src = torch.zeros((B, T * cfg.samples_per_token), device=dev)
        clen = torch.zeros((B,), dtype=torch.int64, device=dev)
        noise = engine._draw_noise(cfg, B, T, g, dev)
        out[f"s3gen_B{B}"] = timed(
            lambda: engine._infer(engine.params["s3gen"], tokens, tlen, ref, src, clen, noise,
                                  cache), dev)
    return out


def analytic(n_slots: int, token_rate: int, t3: dict, s3: dict) -> dict:
    """bench.py's derivation, from the host walls: a stream's RTF alone,
    its TTFA, and the streams one card keeps in real time alone and batched."""
    chunk_audio_s = SLICE / token_rate
    prefill_s = t3["prefill"]["host_ms"] / 1e3
    slice_s = t3["slice_1"]["host_ms"] / 1e3
    batched_slice_s = t3[f"slice_{n_slots}"]["host_ms"] / 1e3
    chunk_s = s3["s3gen_B1"]["host_ms"] / 1e3
    per_stream_s = min(s3[k]["host_ms"] / 1e3 / int(k.removeprefix("s3gen_B")) for k in s3)
    rtf_single = token_rate / (SLICE / slice_s) + chunk_s / chunk_audio_s
    batched = int(min(n_slots, max(0.0, (chunk_audio_s - batched_slice_s) / per_stream_s)))
    single = int(math.floor(1.0 / rtf_single)) if rtf_single < 1 else 0
    return {"rtf_single": round(rtf_single, 4),
            "ttfa_ms": round(1e3 * (prefill_s + slice_s + chunk_s), 1),
            "s3gen_per_stream_ms": round(1e3 * per_stream_s, 3),
            "streams_single": single, "streams_batched": batched,
            "streams": max(single, batched)}


def load_measured(path: Path, want: dict) -> Optional[dict]:
    """The capacity sweep in serve_bench's output ``path`` when it was
    measured here: the same device, arch, decode cap and size (``want``) →
    its capacity, its best full-overlap wave by RTF p50, and the most audio
    seconds per wall second over its full-overlap waves (over the
    all-real-time ones when there are any); None otherwise."""
    try:
        data = json.loads(path.read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        return None
    if any(data.get(k) != v for k, v in want.items()):
        return None
    rows = data.get("results", [])
    cap = next((r["capacity_streams"] for r in rows if r.get("mode") == "capacity"), None)
    waves = [r for r in rows if r.get("mode") in ("capacity_wave", "profiled")
             and r.get("overlap") == "full"]
    if cap is None or not waves:
        return None
    held = [r for r in waves if r["realtime_streams"] == r["streams"]]
    best = min(waves, key=lambda r: r["rtf_p50"])
    return {"measured_at": data.get("measured_at"), "capacity": cap,
            "best_rtf_p50": best["rtf_p50"], "best_rtf_streams": best["streams"],
            "ttfa_p50_ms": best["ttfa_p50_ms"],
            "aggregate_x": max(r["aggregate_x"] for r in held or waves),
            "aggregate_all_realtime": bool(held)}


def headline(desc: dict, derived: dict, measured: Optional[dict]) -> dict:
    """The last line, in bench.py's shape."""
    where = f"{desc['device']}, arch={desc['arch']}, max_new_tokens={desc['max_new_tokens']}"
    if measured is not None:
        value = measured["capacity"].get("full", 0)
        cap = "/".join(f"{k}:{v}" for k, v in sorted(measured["capacity"].items()))
        agg = ("aggregate" if measured["aggregate_all_realtime"] else "overload") + \
            f"={measured['aggregate_x']}x realtime"
        unit = (f"streams MEASURED by serve_bench --capacity at {measured['measured_at']} ({where}; "
                f"capacity={cap}; best rtf_p50={measured['best_rtf_p50']} at "
                f"{measured['best_rtf_streams']} streams, ttfa_p50={measured['ttfa_p50_ms']}ms; "
                f"{agg}; analytic={derived['streams']})")
    else:
        value = derived["streams"]
        unit = (f"streams ANALYTIC from the stage times, no capacity sweep from this card "
                f"({where}; rtf_single={derived['rtf_single']}, ttfa_ms={derived['ttfa_ms']})")
    return {"metric": "concurrent_realtime_streams_per_chip", "value": value, "unit": unit,
            "vs_baseline": round(value / BASELINE_STREAMS, 3)}


async def run(args) -> dict:
    out_path = common.check_out_path(args.out)
    batches = [int(b) for b in os.environ.get("BENCH_S3_BATCH", "4,8,16").split(",") if b]
    with tempfile.TemporaryDirectory() as tmp:
        engine, cold = await common.boot_engine(args, Path(tmp), 1)
        try:
            if engine.decoder is None:
                raise SystemExit("the bench measures the batched decoder: MAX_DECODE_SLOTS > 1")
            desc, n_slots = common.describe(engine), engine.decoder.n_slots
            t3 = measure_t3(engine)
            s3 = measure_s3gen(engine, batches)
            derived = analytic(n_slots, engine.gen_cfg.token_rate, t3, s3)
        finally:
            engine.shutdown()
    print(json.dumps({"mode": "stages", "slice_tokens": SLICE, "slots": n_slots, **t3, **s3,
                      "analytic": derived, "cold_start": cold, **desc}), flush=True)
    sys.stderr.write(f"analytic: {derived}\n")
    measured = load_measured(out_path, {"tiny": args.tiny, **desc})
    return headline(desc, derived, measured)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_engine_args(ap)
    ap.add_argument("--out", default=str(common.OUT_DIR / "torch_serve_bench.json"),
                    help="serve_bench's output, read for a measured capacity")
    line = asyncio.run(run(ap.parse_args(argv)))
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
