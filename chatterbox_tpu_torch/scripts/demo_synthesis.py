"""Synthesize a WAV end to end with the engine (the counterpart of
``scripts/demo_synthesis.py``): the tiny random-weight model unless
``--full-model``; a real checkpoint when MODEL_PATH points at one.

    python -m chatterbox_tpu_torch.scripts.demo_synthesis --cpu --out demo.wav \\
        [--text "..."] [--full-model] [--format wav] [--voice VOICE_ID]

It runs on the CUDA device, or on the CPU with ``--cpu``; with neither it
fails, naming the missing device. It prints ainit's wall, then the time to
the first chunk, the total and the bytes, and logs the request's record
(``request_stats``) as one JSON object.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import tempfile
import time

from ..logging_config import configure_logging
from ..runtime.cancellation import CancellationToken
from ..runtime.engine import TTSEngine

log = logging.getLogger(__name__)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "demo.wav"))
    ap.add_argument("--text", default="Hello from the TPU native chatterbox rebuild. "
                                      "This is streaming synthesis.")
    ap.add_argument("--format", default="wav")
    ap.add_argument("--voice", default=None)
    ap.add_argument("--full-model", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    if not args.full_model:
        os.environ.setdefault("CHATTERBOX_TINY_MODEL", "1")
    configure_logging(tag="DEMO")
    engine = TTSEngine(device="cpu" if args.cpu else None)

    async def run():
        t0 = time.time()
        await engine.ainit()
        print(f"init: {time.time()-t0:.1f}s")
        out = b""
        t0 = time.time()
        first = None
        async for chunk in engine.stream(
            text=args.text,
            output_format=args.format,
            voice_id=args.voice,
            cfg_guidance_weight=0.5,
            synthesis_temperature=0.8,
            text_processing_chunk_size=50,
            audio_tokens_per_slice=8 if not args.full_model else 35,
            remove_trailing_milliseconds=0,
            remove_leading_milliseconds=0,
            chunk_overlap_strategy="full",
            crossfade_duration_milliseconds=30,
            request_id="demo",
            cancellation_token=CancellationToken(),
        ):
            if first is None and chunk:
                first = time.time() - t0
            out += chunk
        print(f"TTFA: {first:.3f}s, total: {time.time()-t0:.3f}s, bytes: {len(out)}")
        log.info("request_stats %s", json.dumps(engine.request_stats["demo"]))
        with open(args.out, "wb") as fh:
            fh.write(out)
        print(f"wrote {args.out}")

    asyncio.run(run())
    engine.shutdown()


if __name__ == "__main__":
    main()
