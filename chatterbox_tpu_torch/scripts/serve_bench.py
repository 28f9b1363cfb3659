"""Measured serving benchmark: waves of concurrent requests through the
in-process engine (the counterpart of ``scripts/serve_bench.py``, which
sends them to the JAX server over HTTP). The port's server answers over
HTTP on the card too (``serve/web.py``); this bench drives the engine in
process, so its times hold no socket or HTTP framing.

    python -m chatterbox_tpu_torch.scripts.serve_bench [--streams 16] [--capacity] [--churn]
    python -m chatterbox_tpu_torch.scripts.serve_bench --device cpu --tiny   # CPU, tiny config

The engine is ``EngineConfig.full()`` (int8 KV, MAX_DECODE_SLOTS=16, the
S3Gen serving defaults, bf16 weights from seed 0 and a seeded
``conds.pt``), in the S3Gen arch CHATTERBOX_S3GEN_ARCH names ("ref" unless
set), each chunk decoding at most CHATTERBOX_MAX_NEW_TOKENS (140 unless
set: random weights rarely emit EOS). ``--model-dir`` boots from a model
directory, ``--write-model-dir`` writes a seeded one first.
``--plain-attention`` runs K1's and K2's plain versions in their place
(``common.plain_attention``): the kernels-off arm of an A/B.
``--warmup-waves`` waves of WARMUP_STREAMS requests (fewer when every wave
is smaller) in each overlap mode run first: eager PyTorch compiles
nothing, so a warm-up only has to touch each path once. Then, as rows (JSON lines on stdout, and the whole run in
``--out``):

- ``cold_start``: ainit's wall, the kernels' build within it (0 when a
  build of these sources exists), and the load's wall and GB/s from a
  model directory;
- default: one wave of ``--streams`` requests per overlap mode;
- ``--capacity``: waves of each size in ``--streams-list`` upward per
  overlap mode, stopping at the first wave in which a stream missed real
  time (RTF ≥ 1); a ``capacity`` row gives the largest all-real-time wave
  per mode; then a ``profiled`` wave at the full mode's capacity (16 when it
  is 0) under torch.profiler, CUDA activity only, for the device's busy
  share and its top kernels (the timed waves run without the profiler,
  which stretches the host clock; not on the CPU);
- ``--churn``: ``--streams`` short requests (CHATTERBOX_MAX_NEW_TOKENS 75
  unless set) sent ``--churn-stagger-ms`` apart: the cost of the
  first-audio gate (CHATTERBOX_FIRST_AUDIO_GATE, named in the row).

A wave row holds ``streams, realtime_streams, ttfa_p50_ms, ttfa_p99_ms,
rtf_p50, rtf_max, audio_s_total, wall_s, aggregate_x, stages`` (the stage
times of ``runtime.metrics`` over the wave), and every row its arch, decode
cap and device, and whether the attention ran on the kernels or the plain
versions. Any failed request fails the run.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import os
import sys
import tempfile
from pathlib import Path
from typing import Awaitable, Callable, List, Tuple

import torch

from . import common

OVERLAPS = ("full", "zero")
PROFILE_STREAMS = 16   # the profiled wave's size when no wave kept real time
WARMUP_STREAMS = 4


async def capacity_sweep(sizes: List[int], wave: Callable[[int], Awaitable[dict]]
                         ) -> Tuple[List[dict], int]:
    """``wave(n)`` for each size upward, stopping after the first wave in
    which a stream missed real time → (the rows, the largest size whose
    every stream kept real time; 0 for none)."""
    rows, capacity = [], 0
    for n in sizes:
        row = await wave(n)
        rows.append(row)
        if row["realtime_streams"] < row["streams"]:
            break
        capacity = n
    return rows, capacity


async def profiled_wave(engine, n: int, overlap: str) -> dict:
    """One wave under torch.profiler (CUDA activity): its row with the
    device's busy share of the wave's wall and its top kernels."""
    with common.profiler() as prof:
        row = await common.run_wave(engine, n, overlap, f"profiled-{n}")
        torch.cuda.synchronize(engine.device)
    summed, busy, kernels, n_device = common.device_ms(prof, top=8)
    return {"mode": "profiled", **row, "device_summed_s": round(summed / 1e3, 3),
            "device_busy_s": round(busy / 1e3, 3),
            "busy_share": round(busy / 1e3 / row["wall_s"], 4),
            "device_activities": n_device, "top_kernels": kernels}


async def run(args) -> None:
    with common.plain_attention() if args.plain_attention else contextlib.nullcontext():
        await measure(args)


async def measure(args) -> None:
    sizes = [int(s) for s in args.streams_list.split(",")]
    overlaps = OVERLAPS if args.overlap == "both" else (args.overlap,)
    if args.churn:
        os.environ.setdefault("CHATTERBOX_MAX_NEW_TOKENS", "75")
    max_streams = max(sizes + [PROFILE_STREAMS]) if args.capacity else args.streams
    with tempfile.TemporaryDirectory() as tmp:
        engine, cold = await common.boot_engine(args, Path(tmp), max_streams)
        try:
            desc = {**common.describe(engine),
                    "attention": "plain" if args.plain_attention else "kernels"}
            rows = common.Rows(common.check_out_path(args.out), {"tiny": args.tiny, **desc})
            rows.add({**cold, **desc})
            n_warm = min(WARMUP_STREAMS, max(sizes) if args.capacity else args.streams)
            for w in range(args.warmup_waves):
                for overlap in overlaps:
                    r = await common.run_wave(engine, n_warm, overlap, f"warmup{w}")
                    sys.stderr.write(f"warm-up wave {w} ({overlap}): {r['wall_s']:.1f} s wall, "
                                     f"{r['audio_s_total']:.1f} s audio\n")
            if args.capacity:
                capacity = {}
                for overlap in overlaps:
                    async def wave(n, overlap=overlap):
                        row = await common.run_wave(engine, n, overlap, f"capacity-{overlap}-{n}")
                        return rows.add({"mode": "capacity_wave", **row, **desc})

                    _, capacity[overlap] = await capacity_sweep(sizes, wave)
                rows.add({"mode": "capacity", "capacity_streams": capacity, **desc})
                if engine.device.type == "cuda":
                    n = capacity[overlaps[0]] or PROFILE_STREAMS
                    rows.add({**await profiled_wave(engine, n, overlaps[0]), **desc})
            elif args.churn:
                row = await common.run_wave(engine, args.streams, "full", "churn",
                                            stagger_s=args.churn_stagger_ms / 1e3)
                rows.add({"mode": "churn", "stagger_ms": args.churn_stagger_ms,
                          "first_audio_gate": os.environ.get("CHATTERBOX_FIRST_AUDIO_GATE", "1"),
                          **row, **desc})
            else:
                for overlap in overlaps:
                    row = await common.run_wave(engine, args.streams, overlap, f"wave-{overlap}")
                    rows.add({"mode": "wave", **row, **desc})
            rows.close()
        finally:
            engine.shutdown()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_engine_args(ap)
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--warmup-waves", type=int, default=2)
    ap.add_argument("--overlap", choices=("both", *OVERLAPS), default="both")
    ap.add_argument("--capacity", action="store_true",
                    help="sweep --streams-list upward per overlap mode")
    ap.add_argument("--streams-list", default="1,4,8,16,24,32")
    ap.add_argument("--churn", action="store_true",
                    help="staggered short requests: the first-audio gate's cost")
    ap.add_argument("--churn-stagger-ms", type=float, default=200.0)
    ap.add_argument("--plain-attention", action="store_true",
                    help="K1's and K2's plain versions in their place (an A/B's kernels-off arm)")
    ap.add_argument("--out", default=str(common.OUT_DIR / "torch_serve_bench.json"))
    asyncio.run(run(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
