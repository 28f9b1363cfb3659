"""Run serve_bench for two or more environments in interleaved turns.

    python -m chatterbox_tpu_torch.scripts.ab --arm kernels: --arm plain:--plain-attention \\
        --turns 3 -- --streams 16 --overlap full

Each ``--arm NAME:ITEM,ITEM[:PYTHONPATH]`` names an environment. An ITEM is
``ENV=VALUE``, a variable set on top of this process's, or a serve_bench
flag (``--plain-attention``) given to this arm alone. PYTHONPATH optionally
names another checkout to run (its path becomes the child's working
directory and PYTHONPATH, so ``-m`` finds that checkout's package: parent
against change). Every turn runs
``python -m chatterbox_tpu_torch.scripts.serve_bench`` once per arm, in a
fresh process, in the order the arms were given: A B A B … Host walls
spread by up to half between runs of the same code, so one pair of runs
says little. The arguments after ``--`` go to serve_bench (its mode).

It prints each run's rows as they come, then, for every row the runs share
(by mode, overlap and streams) and every number in it, each arm's values,
median and spread (max − min) over the turns, one JSON line per row. All of
it is written to ``--out``; each run's own output goes beside it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

from . import common

KEY_FIELDS = ("mode", "overlap", "streams")


def parse_arm(spec: str) -> dict:
    """"NAME:ITEM,ITEM[:PYTHONPATH]" → {"name", "env", "flags", "pythonpath"}."""
    name, _, rest = spec.partition(":")
    items, _, pythonpath = rest.partition(":")
    env, flags = {}, []
    for a in filter(None, items.split(",")):
        k, eq, v = a.partition("=")
        if a.startswith("--"):
            flags.append(a)
        elif not eq or not k:
            raise ValueError(f"--arm {spec!r}: {a!r} is neither ENV=VALUE nor a --flag")
        else:
            env[k] = v
    if not name:
        raise ValueError(f"--arm {spec!r}: no name")
    return {"name": name, "env": env, "flags": flags, "pythonpath": pythonpath or None}


def run_once(arm: dict, args: List[str], out: Path) -> List[dict]:
    """One serve_bench run in a fresh process with the arm's environment
    and flags → the JSON rows it printed. A run that fails stops the A/B."""
    env = {**os.environ, **arm["env"]}
    cwd = None
    if arm["pythonpath"]:
        cwd = arm["pythonpath"]
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [cwd, env.get("PYTHONPATH")]))
    cmd = [sys.executable, "-m", "chatterbox_tpu_torch.scripts.serve_bench", *args, *arm["flags"],
           "--out", str(out)]
    proc = subprocess.run(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"arm {arm['name']}: {' '.join(cmd)} exited {proc.returncode}")
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def row_key(row: dict) -> str:
    return "/".join(f"{k}={row[k]}" for k in KEY_FIELDS if k in row)


def summarize(runs: Dict[str, List[List[dict]]]) -> List[dict]:
    """{arm: [rows of turn 0, rows of turn 1, …]} → per row key, per numeric
    field, per arm: its values over the turns, their median and spread."""
    keys: Dict[str, None] = {}
    for turns in runs.values():
        for rows in turns:
            for r in rows:
                keys.setdefault(row_key(r))
    out = []
    for key in keys:
        fields: Dict[str, Dict] = {}
        for arm, turns in runs.items():
            matched = [r for rows in turns for r in rows if row_key(r) == key]
            for r in matched:
                for f, v in r.items():
                    if isinstance(v, (int, float)) and not isinstance(v, bool) \
                            and f not in KEY_FIELDS:
                        fields.setdefault(f, {}).setdefault(arm, []).append(v)
        out.append({"ab": key, "fields": {
            f: {arm: {"median": statistics.median(vals), "spread": max(vals) - min(vals),
                      "values": vals} for arm, vals in by_arm.items()}
            for f, by_arm in fields.items()}})
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", action="append", required=True, type=parse_arm)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--out", default=str(common.OUT_DIR / "torch_ab.json"))
    args = ap.parse_args(argv[:split])
    bench_args = argv[split + 1:]
    if len(args.arm) < 2 and args.turns < 2:
        raise SystemExit("an A/B needs two arms or two turns")
    out = common.check_out_path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    runs: Dict[str, List[List[dict]]] = {a["name"]: [] for a in args.arm}
    order = []
    for turn in range(args.turns):
        for arm in args.arm:
            t0 = time.perf_counter()
            rows = run_once(arm, bench_args,
                            out.with_name(f"{out.stem}.{arm['name']}.{turn}.json"))
            runs[arm["name"]].append(rows)
            order.append(arm["name"])
            for r in rows:
                print(json.dumps({"arm": arm["name"], "turn": turn, **r}), flush=True)
            sys.stderr.write(f"turn {turn} arm {arm['name']}: {time.perf_counter() - t0:.1f} s\n")
    summary = summarize(runs)
    for s in summary:
        print(json.dumps(s), flush=True)
    out.write_text(json.dumps({"arms": args.arm, "turns": args.turns, "order": order,
                               "args": bench_args, "runs": runs,
                               "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
