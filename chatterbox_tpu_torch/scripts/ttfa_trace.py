"""One request's timeline: where does its first-audio latency go? (The
counterpart of ``scripts/ttfa_trace.py``, on the in-process engine.)

    python -m chatterbox_tpu_torch.scripts.ttfa_trace [--warmups 2] [--load N]
    python -m chatterbox_tpu_torch.scripts.ttfa_trace --device cpu --tiny   # CPU, tiny config

The engine is serve_bench's (``common.boot_engine``). After ``--warmups``
single requests it traces one request (full overlap): every ``metrics.record_stage`` event
while it runs, stamped in seconds from the request's start as [start → end]
spans, beside the first body byte (the WAV header) and the first audio byte.
With ``--load N`` the request is sent ``--load-settle-s`` after N background
requests, so the trace is the loaded TTFA. The stage events carry no request
id, and the batched stages serve every stream at once, so under load the
timeline holds every stream's events and the row gives the TTFA, not its
breakdown: ``pre_ttfa_stage_ms`` (the stage sums up to the first audio
byte) and ``unaccounted_ms`` (the TTFA they leave) are only in an unloaded
trace. It prints the timeline, then one JSON line without it; the row with
the timeline is appended to ``--out``.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import tempfile
import time
from pathlib import Path

from ..runtime.metrics import metrics
from . import common

OVERLAP = "full"   # the serving default


async def trace_request(engine) -> tuple:
    """One request with every stage event recorded → (its timed_request
    result, the events as (end s, stage, duration s), sorted)."""
    events = []
    real_record = metrics.record_stage
    t_req0 = time.perf_counter()

    def traced_record(name, dt_s, items=1):
        events.append((time.perf_counter() - t_req0, name, dt_s))
        return real_record(name, dt_s, items=items)

    metrics.record_stage = traced_record
    try:
        r = await common.timed_request(engine, "ttfa-trace", OVERLAP, events=events)
    finally:
        metrics.record_stage = real_record
    return r, sorted(events)


def summarize(r: dict, events: list, load: int) -> dict:
    """The trace's row: TTFA, wall, audio, the timeline and whose events it
    holds; unloaded, also the stage sums up to the first audio byte and the
    TTFA those sums leave unaccounted."""
    row = {
        "mode": "ttfa_trace", "overlap": OVERLAP, "background_load": load,
        "ttfa_audio_s": round(r["ttfa_s"], 4), "first_body_s": round(r["first_body_s"], 4),
        "wall_s": round(r["wall_s"], 3), "audio_s": round(r["audio_s"], 3),
        "timeline_of": "every stream" if load else "this request",
    }
    if not load:
        pre = {}
        for t_end, name, dur in events:
            if t_end <= r["ttfa_s"] + 1e-6:
                pre[name] = pre.get(name, 0.0) + dur
        accounted = sum(v for k, v in pre.items() if not k.startswith("client"))
        row.update(pre_ttfa_stage_ms={k: round(v * 1e3, 1) for k, v in pre.items()},
                   unaccounted_ms=round((r["ttfa_s"] - accounted) * 1e3, 1))
    row["timeline"] = [{"start_s": round(t - d, 4), "end_s": round(t, 4), "stage": name,
                        "dur_ms": round(d * 1e3, 2)} for t, name, d in events]
    return row


async def run(args) -> None:
    out = common.check_out_path(args.out)
    with tempfile.TemporaryDirectory() as tmp:
        engine, cold = await common.boot_engine(args, Path(tmp), 1 + args.load)
        try:
            for i in range(args.warmups):
                r = await common.timed_request(engine, f"ttfa-warmup-{i}", OVERLAP)
                print(f"warm-up {i}: ttfa {r['ttfa_s']:.3f} s, wall {r['wall_s']:.2f} s, "
                      f"audio {r['audio_s']:.2f} s", flush=True)
            load = [asyncio.create_task(common.timed_request(engine, f"ttfa-load-{i}", OVERLAP))
                    for i in range(args.load)]
            if load:
                await asyncio.sleep(args.load_settle_s)
            r, events = await trace_request(engine)
            await asyncio.gather(*load)
            row = {**summarize(r, events, args.load), "cold_start": cold,
                   **common.describe(engine), "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S")}
        finally:
            engine.shutdown()
    print(f"\n--- timeline of {row['timeline_of']} (s after the traced request's start; "
          "[start → end] of each span) ---")
    for ev in row["timeline"]:
        mark = "  <== TTFA" if ev["stage"] == "client_first_audio_byte" else ""
        print(f"  [{ev['start_s']:8.3f} → {ev['end_s']:8.3f}] {ev['stage']:28s} "
              f"({ev['dur_ms']:8.1f} ms){mark}")
    print(json.dumps({k: v for k, v in row.items() if k != "timeline"}), flush=True)
    rows = json.loads(out.read_text()) if out.exists() else []
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows + [row], indent=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_engine_args(ap)
    ap.add_argument("--warmups", type=int, default=2)
    ap.add_argument("--load", type=int, default=0,
                    help="N background requests in flight around the traced one")
    ap.add_argument("--load-settle-s", type=float, default=3.0)
    ap.add_argument("--out", default=str(common.OUT_DIR / "torch_ttfa_trace.json"))
    asyncio.run(run(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
