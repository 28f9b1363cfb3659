"""Score quality-study rows from a study directory (the counterpart of
``scripts/quality_salvage.py``): a run that was cut, or one filled variant by
variant with ``run_variant``.

    python -m chatterbox_tpu_torch.scripts.quality_salvage WAV_DIR [--tiny] [--out chiprun_out/quality_study_torch.json]

MCD / LSD of every ``*.wav`` in WAV_DIR against its ``default.wav`` (the
sidecars are not read), merged into ``--out`` under the study's schema and
merge rule (``quality_study.merge_into``: an earlier report of another
baseline is refused, not overwritten). ``--tiny`` labels the rows as a
``--tiny`` study's. The JAX package's result files
(``quality_study_results*.json``) are refused as outputs.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from . import common, quality_study


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("wav_dir")
    ap.add_argument("--out", default=str(common.OUT_DIR / "quality_study_torch.json"))
    ap.add_argument("--text-chars", type=int, default=96)
    ap.add_argument("--tiny", action="store_true", help="the WAVs are a --tiny study's")
    args = ap.parse_args(argv)
    out = common.check_out_path(args.out)

    wav_dir = Path(args.wav_dir)
    if not (wav_dir / "default.wav").exists():
        raise SystemExit(f"no default.wav in {wav_dir}; nothing to compare against")
    report = quality_study.score(wav_dir, args.text_chars, tiny=args.tiny)
    print(json.dumps(report, indent=1))
    quality_study.merge_into(out, report)


if __name__ == "__main__":
    main()
