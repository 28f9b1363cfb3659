"""Synthesize one quality-study variant into an existing study directory
(the counterpart of ``scripts/run_variant.sh``), so the default baseline is
not synthesized again for each variant; ``quality_salvage`` then scores the
directory.

    python -m chatterbox_tpu_torch.scripts.run_variant WAV_DIR NAME [ENV=VAL ...]

The ``ENV=VAL`` pairs are set before the engine is built, over the study's
defaults (the ref arch, CHATTERBOX_MAX_NEW_TOKENS 250 unless set, the
study's text unless STUDY_TEXT is set). It writes ``WAV_DIR/NAME.wav`` and
its sidecar ``WAV_DIR/NAME.json`` through ``quality_study.run_child``,
which maps CHATTERBOX_PALLAS / CHATTERBOX_FLASH to the plain-version swap
(``common.kernel_swap``). It is also the child process of every variant
``quality_study`` runs.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

from . import quality_study


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("wav_dir")
    ap.add_argument("name")
    ap.add_argument("env", nargs="*", metavar="ENV=VAL")
    args = ap.parse_args(argv)
    for kv in args.env:
        key, sep, value = kv.partition("=")
        if not sep or not key:
            ap.error(f"not ENV=VAL: {kv!r}")
        os.environ[key] = value
    os.environ.setdefault("STUDY_TEXT", quality_study.TEXT)
    os.environ["CHATTERBOX_S3GEN_ARCH"] = "ref"
    os.environ.setdefault("CHATTERBOX_MAX_NEW_TOKENS", quality_study.DEFAULT_NEW_TOKENS)
    quality_study.run_child(Path(args.wav_dir) / f"{args.name}.wav")
    print(f"variant {args.name} rc=0")


if __name__ == "__main__":
    main()
