"""The capacity sweep of an open-loop cell: the same window at each of a few
arrival rates, in one process, without the reference. For each rate it
prints the requests due and finished, TTFA's median and 95th percentile,
the admission wait (the client's TTFA less the engine's own) of the
window's first and second halves, and how late the generator ran. A rate
is sustained when the second half's admission wait is not above the
first's by more than the first's own size: the backlog does not grow.

    python -m gpubench.sweep --workload <name> --seconds <s> --seed <n> --rates 0.4,0.6,0.8

Used once to fix a mix's ``rate_per_s``; not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys

from . import manifest, run, stats


def halves(records, t_open: float, t_close: float):
    mid = 0.5 * (t_open + t_close)
    out = []
    for lo, hi in ((t_open, mid), (mid, t_close)):
        waits = [r.first_audio - r.due - r.stats["ttfa_s"] for r in records
                 if lo <= r.due < hi and r.first_audio is not None and r.stats
                 and r.stats.get("ttfa_s") is not None]
        out.append(stats.median(waits) if waits else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gpubench.sweep: no CUDA device", file=sys.stderr)
        return 2
    run.set_cache_dirs(manifest.ROOT)
    cell = manifest.cell(args.workload)
    captured = {}
    drive = run.drive

    async def keep(*a, **kw):
        out = await drive(*a, **kw)
        captured["run"] = out
        return out

    run.drive = keep
    for rate in (float(r) for r in args.rates.split(",")):
        result, _, notes = asyncio.run(run.run_cell(cell, args.seed, args.seconds, False, "cuda",
                                                    rate=rate, check=False))
        r = captured["run"]
        first, second = halves(r["records"], r["t_open"], r["t_close"])
        print(json.dumps({"rate": rate, "e2e": notes["e2e"], "late_s": notes["late_s"],
                          "admit_wait_s": [first, second],
                          "sustained": first is not None and second is not None
                          and second <= 2 * first + 0.05,
                          "window_work": notes["window_work"]}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
