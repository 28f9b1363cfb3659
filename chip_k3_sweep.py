#!/usr/bin/env python3
"""K3's build constants swept on one GPU: slice rows, tile bytes, ring stages.

    python3 chip_k3_sweep.py [--reps 2] [--out chiprun_out/chip_k3_sweep.json]

Each variant is ``chatterbox_tpu_torch/csrc/decode_attention_pipelined.cu``
with ``kSlice`` (128, 256, 512), ``kTileBytes`` (8 and 16 KB) and ``kStages``
(2, 3, 4) replaced, built by nvcc into a library of its own under
``chatterbox_tpu_torch/build/k3_sweep/`` (one nvcc per variant, all started
together). One more variant keeps the committed constants and leaves out the
combine launch: its time beside the committed variant's is the combine's
share of a call (its output is not checked). Every other variant is checked
against the plain version, then all are timed in turns, ``--reps`` times
(device ms per call, as ``chip_smoke.py`` times a kernel), in bf16 and f32 at
32 lanes, H = Hk = 16, S = 1280, Dh = 64, on two window mixes:
``chip_smoke.py``'s batched decode windows (mean 595.8 rows) and windows of
0 to 111-202 rows (as phase 6's live cache). Every number goes to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

SRC = Path(__file__).resolve().parent / "chatterbox_tpu_torch" / "csrc"
KERNEL = "decode_attention_pipelined.cu"


def constants(src: str) -> dict:
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kSlice", "kTileBytes", "kStages")}


def variant_sources() -> dict[str, tuple[int, str]]:
    """name → (slice rows, source) for every variant."""
    src = (SRC / KERNEL).read_text()
    committed = constants(src)
    out = {}
    for sl, tb, st in itertools.product((128, 256, 512), (8192, 16384), (2, 3, 4)):
        v = src
        for k, val in (("kSlice", sl), ("kTileBytes", tb), ("kStages", st)):
            v = re.sub(rf"constexpr int {k} = \d+;", f"constexpr int {k} = {val};", v)
        mark = " (committed)" if (sl, tb, st) == tuple(committed.values()) else ""
        out[f"slice {sl}, tile {tb // 1024} KB, {st} stages{mark}"] = (sl, v)
    combine = re.search(r"  if \(n_chunk == 1\)\n    return launch_combine.*?\);\n.*?\);\n",
                        src, re.S).group(0)
    out["committed without the combine"] = (committed["kSlice"],
                                            src.replace(combine, "  return 0;\n"))
    return out


def build(variants: dict, build_dir: Path) -> dict[str, ctypes.CDLL]:
    from chatterbox_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    flags = [f for f in _build.FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for i, (name, (_, src)) in enumerate(variants.items()):
        d = build_dir / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / KERNEL).write_text(src)
        for hdr in SRC.glob("*.cuh"):
            (d / hdr.name).write_text(hdr.read_text())
        cmd = [nvcc, *flags, "-shared", "-o", str(d / "k3.so"), str(d / KERNEL)]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-4000:]}")
        lib = ctypes.CDLL(str(d / "k3.so"))
        lib.decode_attention_pipelined_launch.argtypes = _build._SIGNATURES[
            "decode_attention_pipelined_launch"]
        libs[name] = lib
    return libs


def make_call(lib, slice_rows: int, args):
    q, k, v, kn, vn, start, pos = args
    B, H, Dh = q.shape
    Hk, S = k.shape[1], k.shape[2]
    code = 1 if q.dtype == torch.bfloat16 else 0
    out = torch.empty_like(q)
    scratch = torch.empty(B * Hk * -(-S // slice_rows) * (H // Hk) * (Dh + 2), device=q.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.decode_attention_pipelined_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kn.data_ptr(), vn.data_ptr(),
            start.data_ptr(), pos.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, H, Hk, S,
            Dh, code, ctypes.c_float(Dh ** -0.5), ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/chip_k3_sweep.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k3_sweep: no GPU", file=sys.stderr)
        return 2
    from chatterbox_tpu_torch.ops import decode_attention as da

    gpu = cs.gpu_line()
    print(gpu, flush=True)
    variants = variant_sources()
    t0 = time.perf_counter()
    libs = build(variants, SRC.parent / "build" / "k3_sweep")
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    S, H, Dh = 1280, 16, 64
    windows = {"batched": cs.batched_windows(dev, S)}
    short = np.random.default_rng(9).integers(111, 203, cs.LANES)
    windows["111-202 rows"] = (torch.zeros(cs.LANES, dtype=torch.int32, device=dev),
                               torch.as_tensor(short, dtype=torch.int32, device=dev))
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).removeprefix("torch.")
        rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
        q, kn, vn = rnd(cs.LANES, H, Dh), rnd(cs.LANES, H, Dh), rnd(cs.LANES, H, Dh)
        k, v = rnd(cs.LANES, H, S, Dh), rnd(cs.LANES, H, S, Dh)
        for wn, (start, pos) in windows.items():
            args = (q, k, v, kn, vn, start, pos)
            want = da.decode_attention_plain(*args)
            calls = {n: make_call(libs[n], sl, args) for n, (sl, _) in variants.items()}
            errs = {n: cs.compare(f"{n} {dn} {wn}", c(), want, cs.TOL[dtype], show=False)
                    for n, c in calls.items() if "without" not in n}
            times = {n: [] for n in calls}
            for rep in range(a.reps):
                for n in (list(calls) if rep % 2 == 0 else list(calls)[::-1]):
                    times[n].append(cs.queued_ms(calls[n], 30))
            print(f"{dn}, {wn} windows: device ms per call, {a.reps} runs in turns "
                  f"(max_abs_err ≤ {max(errs.values()):.3e}, tol {cs.TOL[dtype]:.1e})", flush=True)
            for n, ts in sorted(times.items(), key=lambda kv: min(kv[1])):
                print(f"  {n}: {', '.join(f'{t:.4f}' for t in ts)}", flush=True)
                results.append({"dtype": dn, "windows": wn, "variant": n, "ms": ts,
                                "max_abs_err": errs.get(n)})
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps({"gpu": gpu, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
