"""Waveform parity against a reference WAV (the engine half of
``scripts/parity_check.py``).

The reference half is a recipe, since neither the reference runtime nor the
pretrained snapshot is in the repo:

1. On a machine with the reference stack (``pip install chatterbox-tts`` or
   the reference repo's Docker image) and the HF snapshot, synthesize with a
   fixed seed and save::

       curl -o ref.wav 'http://<reference>/tts/generate?text=...&format=wav'

2. Here, with the snapshot in MODEL_PATH::

       python -m chatterbox_tpu_torch.scripts.parity_check --text "..." --ref ref.wav \\
           [--voice VOICE_ID] [--out hyp.wav]

   which synthesizes the same text through the port's engine (the
   checkpoint-compatible ref S3Gen arch, on the CUDA device; the CPU when
   CHATTERBOX_FORCE_CPU=1) and prints MCD / LSD between the two waveforms
   as one JSON line, the reference resampled to the engine's rate.

Parity measures conversion fidelity only, so the serving deviations are
pinned off: native KV cache, no CFM prompt cache, no streaming CFM, no
progressive slices, and K1's plain version in place of the kernel
(``common.kernel_swap``) unless CHATTERBOX_PALLAS=1.

Exit code 0 iff MCD <= --mcd-threshold (default 8.0 dB: identical
pipelines land far below 1 dB, different samplers of one checkpoint a few dB).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--text", required=True)
    ap.add_argument("--ref", required=True, help="reference WAV to compare against")
    ap.add_argument("--voice", default=None)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "parity_hyp.wav"))
    ap.add_argument("--mcd-threshold", type=float, default=8.0)
    ap.add_argument("--seed-request-id", default="parity-check",
                    help="request id (seeds sampling deterministically)")
    args = ap.parse_args(argv)

    os.environ.setdefault("CHATTERBOX_S3GEN_ARCH", "ref")
    os.environ["CHATTERBOX_KV"] = "native"
    os.environ.setdefault("KV_CACHE_DTYPE", "native")
    os.environ["CHATTERBOX_CFM_PROMPT_CACHE"] = "0"
    os.environ["CHATTERBOX_CFM_STREAM"] = "0"
    os.environ["CHATTERBOX_PROGRESSIVE_SLICES"] = "0"
    os.environ.setdefault("CHATTERBOX_PALLAS", "0")

    from ..audio.pcm import read_wav, resample
    from ..audio.quality import log_spectral_distance, mel_cepstral_distortion
    from . import common, quality_study

    with common.plain_attention(common.kernel_swap(os.environ)):
        data, _ = asyncio.run(quality_study.synthesize(args.text, request_id=args.seed_request_id,
                                                       voice_id=args.voice))
    with open(args.out, "wb") as f:
        f.write(data)

    hyp, sr_h = read_wav(args.out)
    ref, sr_r = read_wav(args.ref)
    if sr_r != sr_h:
        ref = resample(ref, sr_r, sr_h)
    mcd = mel_cepstral_distortion(ref, hyp, sr_h)
    lsd = log_spectral_distance(ref, hyp, sr_h)
    result = {
        "mcd_db": round(float(mcd), 3),
        "lsd_db": round(float(lsd), 3),
        "threshold_db": args.mcd_threshold,
        "ref_s": round(len(ref) / sr_h, 2),
        "hyp_s": round(len(hyp) / sr_h, 2),
        "pass": bool(mcd <= args.mcd_threshold),
    }
    print(json.dumps(result))
    sys.exit(0 if result["pass"] else 1)


if __name__ == "__main__":
    main()
