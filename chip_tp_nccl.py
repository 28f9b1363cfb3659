#!/usr/bin/env python3
"""Serve under CHATTERBOX_TP with one card per rank (NCCL), on a machine
with four NVIDIA GPUs:

    python3 chip_tp_nccl.py

EngineConfig.full() (ref, bf16, int8 KV, 16 slots, random weights from
seed 0, a seeded conds.pt) at tp = 1 on cuda:0, tp = 2 on cuda:0-1 and
tp = 4 on cuda:0-3 (K1 at 8 and 4 heads per rank, K2 at 4 and 2): each
serves the same 4 one-chunk requests (``chip_smoke.TP_SERVE_NEW_TOKENS``
tokens) twice, concurrently, the launch counts of every rank set to 0
before the first wave and the default voice's prompt cache rebuilt.
Reported per engine: ainit wall, each wave's wall (the second one warm),
every rank's K1 / K2 launches, whether each follower's token digest equals
rank 0's, and the tokens against tp = 1. Held: the backend is NCCL, every
follower's digest equals rank 0's, and every rank launched K1 and both K2
forms. Walls print beside the card's name and power limit; they are
tensor-parallel walls over NVLink, from one run.
"""
import asyncio
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs
from chatterbox_tpu_torch.runtime.synthetic import write_conds
from chatterbox_tpu_torch.scripts.common import gpu_line

TEXTS = [cs.TEXTS[0], cs.TEXTS[2], f"Parallel. {cs.TEXTS[0]}", f"Parallel. {cs.TEXTS[2]}"]


async def start(tp: int, dtype: str):
    from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine

    os.environ["CHATTERBOX_TP"] = str(tp)
    try:
        t0 = time.perf_counter()
        engine = TTSEngine(EngineConfig.full(dtype), seed=0)   # cuda:0 … cuda:tp-1
        await engine.ainit()
        torch.cuda.synchronize()
    finally:
        del os.environ["CHATTERBOX_TP"]
    return engine, time.perf_counter() - t0


async def run(dtype: str) -> dict:
    out, first = {}, None
    for tp in (1, 2, 4):
        engine, boot = await start(tp, dtype)
        try:
            if tp > 1:
                cs.reset_launches()
                engine.tp.follower_stats(reset_launches=True)
                cs.build_voice_cache(engine)
            wave = await cs.tp_serve(engine, TEXTS, f"tp={tp} {dtype}")
            warm = await cs.tp_serve(engine, TEXTS, f"tp={tp} {dtype}, second wave")
            rec = {"ainit_s": boot, "wave_s": wave["wall_s"], "warm_wave_s": warm["wall_s"]}
            if tp > 1:
                gc.collect()
                lead, followers = engine.calls.stats(), engine.tp.follower_stats()
                rec.update(backend=engine.tp.backend, digests_equal=all(
                    (f["token_digest"], f["token_calls"]) == (lead["token_digest"],
                                                              lead["token_calls"])
                    for f in followers),
                    launches=[cs.read_launches()] + [f["launches"] for f in followers])
            first = first or wave
            rec["vs_tp1"] = cs.token_diff(first, wave)
            out[tp] = rec
            print(f"  tp={tp} {dtype}: {json.dumps(rec)}", flush=True)
        finally:
            engine.shutdown()
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    return out


def main() -> int:
    if torch.cuda.device_count() < 4:
        print("chip_tp_nccl: needs 4 CUDA devices", file=sys.stderr)
        return 2
    print(gpu_line(), f"x{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = Path(tmp) / "models"
        model_dir.mkdir()
        write_conds(model_dir / "conds.pt")
        os.environ.update(MODEL_PATH=str(model_dir), CHATTERBOX_KV="int8", MAX_DECODE_SLOTS="16",
                          CHATTERBOX_MAX_NEW_TOKENS=cs.TP_SERVE_NEW_TOKENS,
                          VOICES_DIR=str(Path(tmp) / "voices"))
        res = asyncio.run(run("bfloat16"))
    bad = [f"tp={tp}" for tp, x in res.items() if tp > 1 and (
        x["backend"] != "nccl" or not x["digests_equal"] or any(
            r["decode_attention"]["int8"] == 0 or r["flash_mha"]["float32"] == 0
            or r["flash_mha"]["float32_ctx"] == 0 for r in x["launches"]))]
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": not bad, "failed": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
