"""What the port's measuring entry points share: the request they send and
how it is timed and checked, the engine they boot, percentiles, stage-time
deltas, the profiler's device time, the plain-attention swap, and where
their rows go.

A request is sent the way the HTTP handler sends it (``serve/api.py``): its
text and overlap mode, every other argument from the ``TTS_*`` settings. Its
TTFA is the wall from the call to ``engine.stream`` to the first PCM byte
past the 44-byte WAV header (the engine's own ``stats["ttfa_s"]`` plus any
wait for admission); its RTF is its wall over the seconds of audio returned.
Every WAV is checked (``check_wav``). The engine runs in this process (the
GPU machine has no aiohttp) on the CUDA device, or on the CPU only when
``--device cpu`` asks for it.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import os
import re
import statistics
import struct
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import _build
from ..ops.decode_attention import decode_attention_plain
from ..ops.flash_mha import flash_mha_context_plain, flash_mha_plain
from ..runtime.cancellation import CancellationToken
from ..runtime.engine import EngineConfig, TTSEngine
from ..runtime.metrics import metrics
from ..runtime.synthetic import write_conds, write_reference_checkpoint
from ..settings import get_tts_config

REPO = Path(__file__).resolve().parents[2]
OUT_DIR = REPO / "chiprun_out"
# the JAX package's serving results (the TPU's numbers): never read or written here
TPU_RESULTS = "serve_bench_results.json"
# every result file of the JAX package's scripts: never an output here
JAX_RESULTS = (TPU_RESULTS, "quality_study_results.json", "quality_study_results_r4.json")
# each kernel swapped by ``plain_attention``, and the knob that turns it off
KERNEL_KNOBS = {"decode_attention": "CHATTERBOX_PALLAS", "flash_mha": "CHATTERBOX_FLASH"}

# scripts/serve_bench.py's request text (two text chunks at the default chunk size)
TEXT = (
    "The quick brown fox jumps over the lazy dog while the orchestra plays "
    "a long and winding melody that never quite resolves, keeping every "
    "listener waiting for the final chord."
)
WAV_HEADER_BYTES = 44
# the random weights' seed, as chip_smoke.py's
SEED = 0
# random weights rarely emit EOS: every chunk decodes up to this cap unless
# CHATTERBOX_MAX_NEW_TOKENS says otherwise
DEFAULT_NEW_TOKENS = "140"


def request_args(overlap: str) -> dict:
    """``engine.stream``'s arguments besides text, request id and token, as
    the HTTP handler passes them for a WAV request that names its text and
    ``chunk_overlap_strategy`` only."""
    cfg = get_tts_config()
    return dict(output_format="wav", voice_id=None,
                cfg_guidance_weight=cfg.CFG_GUIDANCE_WEIGHT,
                synthesis_temperature=cfg.SYNTHESIS_TEMPERATURE,
                text_processing_chunk_size=cfg.TEXT_PROCESSING_CHUNK_SIZE,
                audio_tokens_per_slice=cfg.AUDIO_TOKENS_PER_SLICE,
                remove_trailing_milliseconds=cfg.REMOVE_TRAILING_MILLISECONDS,
                remove_leading_milliseconds=cfg.REMOVE_LEADING_MILLISECONDS,
                chunk_overlap_strategy=overlap,
                crossfade_duration_milliseconds=cfg.CROSSFADE_DURATION_MILLISECONDS)


def percentile(values, q: float) -> float:
    """scripts/serve_bench.py's index rule: the sorted values' element at
    min(n - 1, int(q·n))."""
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def check_wav(i, data: bytes, stats: dict, sr: int, spt: int, fade: int) -> float:
    """A streamed WAV against its request's record (RIFF header, sample
    count against the tokens produced, less the codes S3Gen drops as
    outside its vocabulary, the crossfade's seams, finite, not silent) →
    its seconds of audio."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE" or data[36:40] != b"data":
        raise AssertionError(f"request {i}: no RIFF/WAVE header")
    channels, rate, _, _, bits = struct.unpack("<HLLHH", data[22:36])
    if (channels, rate, bits) != (1, sr, 16):
        raise AssertionError(f"request {i}: header says {channels} ch, {rate} Hz, {bits} bit")
    pcm = np.frombuffer(data[44:], dtype="<i2")
    if pcm.size != stats["samples"]:
        raise AssertionError(f"request {i}: {pcm.size} samples in the WAV, "
                             f"engine emitted {stats['samples']}")
    # + the EOS code per chunk, - the codes outside S3Gen's vocabulary
    want = (sum(n + 1 for n in stats["t3_tokens"]) - stats["dropped_codes"]) * spt
    if stats["synth_samples"] != want:
        raise AssertionError(f"request {i}: synthesised {stats['synth_samples']} samples, "
                             f"tokens {stats['t3_tokens']} less {stats['dropped_codes']} "
                             f"dropped codes give {want}")
    seams, rest = divmod(stats["synth_samples"] - stats["samples"], fade)
    if rest or not 0 <= seams < stats["slices"]:
        raise AssertionError(f"request {i}: crossfade accounting off ({stats})")
    wav = pcm.astype(np.float32) / 32768.0
    if not np.isfinite(wav).all() or np.abs(wav).max() < 1e-3:
        raise AssertionError(f"request {i}: silent or non-finite audio")
    return pcm.size / sr


async def timed_request(engine, rid: str, overlap: str, events: Optional[list] = None) -> dict:
    """One TEXT request through ``engine.stream``, its WAV checked → its
    TTFA, first body byte, wall, audio seconds and RTF. ``events`` gets
    (seconds after the call, "client_first_body_byte" /
    "client_first_audio_byte", 0.0)."""
    t0 = time.perf_counter()
    first_body = first_audio = None
    data = bytearray()
    async for chunk in engine.stream(text=TEXT, request_id=rid,
                                     cancellation_token=CancellationToken(),
                                     **request_args(overlap)):
        if chunk and first_body is None:
            first_body = time.perf_counter() - t0
            if events is not None:
                events.append((first_body, "client_first_body_byte", 0.0))
        data += chunk
        if first_audio is None and len(data) > WAV_HEADER_BYTES:
            first_audio = time.perf_counter() - t0
            if events is not None:
                events.append((first_audio, "client_first_audio_byte", 0.0))
    wall = time.perf_counter() - t0
    stats = engine.request_stats[rid]
    fade = int(engine.sr * request_args(overlap)["crossfade_duration_milliseconds"] / 1000)
    audio_s = check_wav(rid, bytes(data), stats, engine.sr, engine.cfg.gen.samples_per_token, fade)
    return {"ttfa_s": first_audio, "first_body_s": first_body, "wall_s": wall,
            "audio_s": audio_s, "rtf": wall / audio_s, "chunks": stats["chunks"]}


def stage_delta(before: Dict, after: Dict) -> Dict:
    """The stage times of ``runtime.metrics`` accumulated between two
    snapshots' "stages" → {stage: {time_s, count, items}}, stages that ran."""
    out = {}
    for name, s1 in after.items():
        s0 = before.get(name, {"time_s": 0.0, "count": 0, "items": 0})
        if s1["count"] != s0["count"]:
            out[name] = {"time_s": round(s1["time_s"] - s0["time_s"], 3),
                         "count": s1["count"] - s0["count"], "items": s1["items"] - s0["items"]}
    return out


def wave_row(results: List[dict], wall_s: float, stages: Dict) -> dict:
    """A wave's requests → the row: real-time streams (RTF < 1), TTFA p50
    and p99 (serve_bench's rules: the median, and ``percentile``), RTF p50
    and max, seconds of audio, the wave's wall, audio seconds per wall
    second, the stage deltas."""
    ttfas = [r["ttfa_s"] for r in results]
    rtfs = [r["rtf"] for r in results]
    audio = sum(r["audio_s"] for r in results)
    return {"streams": len(results), "realtime_streams": sum(1 for x in rtfs if x < 1.0),
            "ttfa_p50_ms": round(1e3 * statistics.median(ttfas), 1),
            "ttfa_p99_ms": round(1e3 * percentile(ttfas, 0.99), 1),
            "rtf_p50": round(statistics.median(rtfs), 4), "rtf_max": round(max(rtfs), 4),
            "audio_s_total": round(audio, 3), "wall_s": round(wall_s, 3),
            "aggregate_x": round(audio / wall_s, 4), "stages": stages}


async def run_wave(engine, n: int, overlap: str, tag: str, stagger_s: float = 0.0) -> dict:
    """``n`` concurrent requests (the i-th sent ``i·stagger_s`` after the
    first) → ``wave_row``, with the overlap mode."""
    before = metrics.snapshot()["stages"]

    async def one(i: int) -> dict:
        if stagger_s:
            await asyncio.sleep(i * stagger_s)
        return await timed_request(engine, f"{tag}-{i}", overlap)

    t0 = time.perf_counter()
    results = await asyncio.gather(*[one(i) for i in range(n)])
    wall = time.perf_counter() - t0
    return {"overlap": overlap, **wave_row(results, wall, stage_delta(before, metrics.snapshot()["stages"]))}


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


def device_ms(prof, top: int = 0) -> tuple:
    """(summed, busy) ms of the device activity (kernels, copies, fills) a
    finished profiler saw: the sum of their durations, and the union of
    their intervals; with ``top``, also the ``top`` kernel names (template
    arguments dropped) by summed ms, as [(name, ms, launches)], and the
    count of all device activities. Read from
    the raw trace events in one pass: key_averages() takes minutes over the
    hundreds of thousands of kernels of a serving run."""
    spans, by = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.start_ns(), e.end_ns())
        spans.append(span)
        if top:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name())
            name = re.split(r"[<(]", name, maxsplit=1)[0].strip()[:60]
            ms, n = by.get(name, (0.0, 0))
            by[name] = (ms + (span[1] - span[0]) / 1e6, n + 1)
    if not spans:
        raise RuntimeError("torch.profiler recorded no device time")
    spans.sort()
    summed = sum(b - a for a, b in spans)
    busy, (lo, hi) = 0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    out = (summed / 1e6, (busy + hi - lo) / 1e6)
    if top:
        kernels = sorted(((k, round(ms, 3), n) for k, (ms, n) in by.items()), key=lambda r: -r[1])
        out += (kernels[:top], len(spans))
    return out


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


# ------------------------------------------------------------------ engine
def add_engine_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; by default the CUDA device, and none is an error")
    ap.add_argument("--tiny", action="store_true",
                    help="EngineConfig.tiny_ref() (or tiny() under CHATTERBOX_S3GEN_ARCH=dit)")
    ap.add_argument("--model-dir", help="boot from this model directory (MODEL_PATH)")
    ap.add_argument("--write-model-dir",
                    help="write a seeded reference model directory here, then boot from it")


def engine_config(tiny: bool) -> EngineConfig:
    """The bench's config: ``EngineConfig.full()`` (int8 KV, bf16 params,
    the S3Gen arch CHATTERBOX_S3GEN_ARCH names, "ref" unless set, as
    bench.py measures), or with ``tiny`` the tiny config of that arch; the
    per-chunk decode cap from CHATTERBOX_MAX_NEW_TOKENS (140 unless set)."""
    os.environ.setdefault("CHATTERBOX_S3GEN_ARCH", "ref")
    os.environ.setdefault("CHATTERBOX_MAX_NEW_TOKENS", DEFAULT_NEW_TOKENS)
    if not tiny:
        return EngineConfig.full()
    cfg = EngineConfig.tiny_ref() if os.environ["CHATTERBOX_S3GEN_ARCH"] == "ref" else EngineConfig.tiny()
    return dataclasses.replace(cfg, max_new_tokens=min(int(os.environ["CHATTERBOX_MAX_NEW_TOKENS"]),
                                                       cfg.max_new_tokens))


async def boot_engine(args, workdir: Path, max_streams: int) -> tuple:
    """The engine ``args`` ask for, initialised → (engine, its cold-start
    row). Its weights: the model directory given or written, else a random
    init from ``SEED`` beside a seeded conds.pt (the ref arch's default
    voice) in ``workdir``. At most ``max_streams`` requests are in flight."""
    cfg = engine_config(args.tiny)
    os.environ.setdefault("VOICES_DIR", str(workdir / "voices"))
    os.environ.setdefault("PRELOADED_VOICES_DIR", str(workdir / "preloaded-voices"))
    os.environ.setdefault("CONCURRENT_REQUESTS_PER_WORKER", str(max_streams))
    row = {"mode": "cold_start"}
    if args.write_model_dir:
        model_dir = Path(args.write_model_dir)
        model_dir.mkdir(parents=True, exist_ok=True)
        sizes = ({} if not args.tiny else
                 dict(t3=cfg.t3, ve=cfg.ve, s3gen=EngineConfig.tiny_ref().s3gen_ref))
        written = write_reference_checkpoint(model_dir, **sizes)
        row.update(written_bytes=written["bytes"], write_s=round(written["write_s"], 3),
                   synth_s=round(written["synth_s"], 3))
    elif args.model_dir:
        model_dir = Path(args.model_dir)
    else:
        model_dir = workdir / "model"
        model_dir.mkdir(parents=True, exist_ok=True)
        if cfg.s3gen_arch == "ref":
            write_conds(model_dir / "conds.pt", spk_dim=cfg.t3.speaker_embed_dim)
    os.environ["MODEL_PATH"] = str(model_dir)
    t0 = time.perf_counter()
    engine = TTSEngine(cfg, seed=SEED, device=args.device)
    await engine.ainit()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    report = engine.load_report
    # ainit builds the CUDA kernels when no build of these sources exists yet
    build = _build.build_info if engine.device.type == "cuda" else {}
    row.update(source="model directory" if report else f"random init, seed {SEED}",
               ainit_s=round(time.perf_counter() - t0, 3),
               kernel_build_s=round(build["seconds"], 3) if build else None,
               load_s=round(report["seconds"], 3) if report else None,
               load_bytes=report.get("bytes"),
               load_gb_s=round(report["bytes"] / report["seconds"] / 1e9, 3) if report else None)
    return engine, row


@contextlib.contextmanager
def plain_attention(kernels=tuple(KERNEL_KNOBS)):
    """The plain versions of ``kernels`` ("decode_attention" for K1,
    "flash_mha" for K2, both of its forms; both kernels by default) in place
    of their wrappers at their call sites (the T3 decode step's attention,
    the ref CFM estimator's) while the block runs: serve_bench's ``--plain-attention``,
    the kernels-off arm of an A/B, and a study variant's knobs
    (``kernel_swap``). The wrappers stay as they are, so nothing in a
    server's environment can take serving off the kernels."""
    from ..models.s3gen_ref import decoder
    from ..models.t3 import model as t3_model

    sites = {"decode_attention": [(t3_model, "decode_attention", decode_attention_plain)],
             "flash_mha": [(decoder, "flash_mha", flash_mha_plain),
                           (decoder, "flash_mha_context", flash_mha_context_plain)]}
    unknown = set(kernels) - set(sites)
    if unknown:
        raise ValueError(f"plain_attention: no kernel {sorted(unknown)}")
    swaps = [site for name in kernels for site in sites[name]]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    for mod, attr, plain in swaps:
        setattr(mod, attr, plain)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def kernel_swap(env) -> tuple:
    """A run's ``CHATTERBOX_PALLAS`` / ``CHATTERBOX_FLASH`` → the kernels
    whose plain versions ``plain_attention`` must swap in: a knob at
    anything but "1" names its kernel, as ``pallas_enabled`` and
    ``flash_enabled`` read it. Both knobs are removed from ``env`` (the
    environment the engine will see): left at "0" they would make the
    kernel's CUDA calls raise, and the swap is the port's one plain route."""
    return tuple(name for name, knob in KERNEL_KNOBS.items() if env.pop(knob, "1") != "1")


def describe(engine) -> dict:
    """What every row names: the arch, the decode cap, the device."""
    return {"arch": engine.cfg.s3gen_arch, "max_new_tokens": engine.cfg.max_new_tokens,
            "device": device_name(engine.device)}


# ------------------------------------------------------------------ output
def check_out_path(path: str) -> Path:
    out = Path(path)
    if out.name in JAX_RESULTS:
        raise SystemExit(f"{out.name} holds the JAX package's TPU results; "
                         "the port writes its rows elsewhere")
    return out


class Rows:
    """Rows printed as JSON lines to stdout as they come, and the whole run
    written to ``path`` after each (``partial`` until ``close``)."""

    def __init__(self, path: Path, header: dict):
        self.path, self.header, self.rows = path, header, []

    def add(self, row: dict) -> dict:
        print(json.dumps(row), flush=True)
        self.rows.append(row)
        self._write(partial=True)
        return row

    def close(self) -> None:
        self._write(partial=False)

    def _write(self, partial: bool) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps({**self.header, "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
                                   "partial": partial, "results": self.rows}, indent=1))
        os.replace(tmp, self.path)
