"""The readings a cell's correctness limits are set from: for each seed, one
run of the cell (its window at the cell's own load, at the length given),
the program's numbers against the reference, and the control's, the
reference in the next lower precision put in the program's place over the
same requests (``reference.<config>.quantize_fp8``).

    python -m gpubench.calibrate --workload <name> --seconds <s> --seeds <n>,<n>,...

One process: each seed boots the engine anew. Prints one JSON line per
seed, then the largest program reading and the smallest control reading
of each number. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys

from . import manifest, run


def readings(cell, seeds, seconds: float, device: str):
    rows = []
    for seed in seeds:
        _, checks, notes = asyncio.run(run.run_cell(cell, seed, seconds, False, device, control=True))
        rows.append({"seed": seed, "program": {**{k: v for k, (v, _) in checks.items()},
                                               **notes.get("not_compared", {})},
                     "control": notes.get("control", {}), "sample": notes.get("sample"),
                     "faults": notes.get("faults"), "check_s": notes.get("check_s"),
                     "e2e": notes.get("e2e"), "window_work": notes.get("window_work"),
                     "setup_s": notes.get("setup_s")})
        print(json.dumps(rows[-1], default=str), flush=True)
    names = rows[0]["program"].keys()
    summary = {k: {"program_max": max(r["program"][k] for r in rows),
                   "control_min": min((r["control"][k] for r in rows if k in r["control"]),
                                      default=None)} for k in names}
    print(json.dumps({"summary": summary}), flush=True)
    return rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gpubench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    run.set_cache_dirs(manifest.ROOT)
    readings(manifest.cell(args.workload), [int(s) for s in args.seeds.split(",")], args.seconds,
             "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
