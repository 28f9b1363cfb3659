"""One run of one benchmark cell of the port (``chatterbox_tpu_torch``).

    python -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration file (``gpubench/configs/``) states the engine,
its sizes and its precision; its traffic file (``gpubench/traffic/``) the
loop. Set-up makes the weights and the default voice from ``--seed`` on the
card, boots ``TTSEngine`` in this process with them, and starts the loop;
after the mix's warm-up the window opens and lasts ``--seconds``. Every
request calls ``TTSEngine.stream`` as the HTTP handler does
(``serve/api.py``: the ``TTS_*`` defaults, the default voice), except that
every few requests decode greedily (``traffic.py``).

Closed loop: each client sends its next request when the last one ends;
after the window a request in flight is followed to its first audio only,
but for the few the reference will judge, followed to their end.
Open loop: requests are due on a schedule and timed from when they were
due; every request due in the window is followed to its end.

With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (the window under torch.profiler, CUDA
activity). Then the window's work is judged: the program's state is freed
and the plain reference (``gpubench/reference/``) recomputes a seeded sample
of the finished requests from the same weights and voice, and each number
it compares is printed beside its limit, last on standard error and last in
the result. The result is the last line of standard output.

``run_cell``'s ``rate``, ``check`` and ``control`` serve ``sweep.py`` and
``calibrate.py``; a benchmark run uses none of them.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import gc
import json
import math
import os
import random
import sys
import tempfile
import time
import zlib
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

T_PROCESS = time.perf_counter()

from . import manifest, stats, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "chatterbox_tpu")
CHECK_LAST = "checks"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def set_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernel library builds into ``chatterbox_tpu_torch/build``)."""
    cache = root / "gpubench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def request_args(settings, overlap: str, greedy: bool) -> Dict:
    """``engine.stream``'s arguments besides text, id and token, as the
    HTTP handler passes them for a WAV request naming its text only."""
    return dict(output_format="wav", voice_id=None,
                cfg_guidance_weight=settings.CFG_GUIDANCE_WEIGHT,
                synthesis_temperature=0.0 if greedy else settings.SYNTHESIS_TEMPERATURE,
                text_processing_chunk_size=settings.TEXT_PROCESSING_CHUNK_SIZE,
                audio_tokens_per_slice=settings.AUDIO_TOKENS_PER_SLICE,
                remove_trailing_milliseconds=settings.REMOVE_TRAILING_MILLISECONDS,
                remove_leading_milliseconds=settings.REMOVE_LEADING_MILLISECONDS,
                chunk_overlap_strategy=overlap,
                crossfade_duration_milliseconds=settings.CROSSFADE_DURATION_MILLISECONDS)


@dataclasses.dataclass
class Record:
    req: traffic.Request
    rid: str
    args: Dict
    due: float                       # perf_counter seconds
    first_audio: Optional[float] = None
    end: Optional[float] = None
    finished: bool = False           # streamed to its end
    failed: Optional[str] = None
    arrivals: List = dataclasses.field(default_factory=list)   # (t, PCM bytes)
    wav: bytes = b""
    stats: Optional[Dict] = None
    chunks: Optional[List] = None    # served tokens per text chunk


class Chooser:
    """The requests the reference will judge, chosen as they are sent, so
    that the harness keeps the S3Gen captures of those alone: the first
    request with the longest text, the first greedy one with the longest
    text, and the first ``n`` sent after the window opened whose index the
    seed flags (one in ``FLAG_EVERY``). ``sample`` gives them in that
    order, ``n`` in all. ``on_keep`` / ``on_drop`` are told of each request
    that becomes or stops being a candidate."""

    FLAG_EVERY = 4

    def __init__(self, n: int, seed: int, on_keep, on_drop):
        self.n, self.seed, self.on_keep, self.on_drop = n, seed, on_keep, on_drop
        self.longest: Optional[Record] = None
        self.greedy: Optional[Record] = None
        self.flagged: List[Record] = []
        self.window_open = False

    def flag(self, index: int) -> bool:
        return random.Random((self.seed ^ 0x5EED) * 1_000_003 + index).random() < 1 / self.FLAG_EVERY

    def candidates(self) -> List[Record]:
        out: List[Record] = []
        for r in (self.longest, self.greedy, *self.flagged):
            if r is not None and r not in out:
                out.append(r)
        return out

    def offer(self, rec: Record) -> None:
        before = {r.rid for r in self.candidates()}
        size = len(rec.req.text)
        if self.longest is None or size > len(self.longest.req.text):
            self.longest = rec
        if rec.req.greedy and (self.greedy is None or size > len(self.greedy.req.text)):
            self.greedy = rec
        if self.window_open and len(self.flagged) < self.n and self.flag(rec.req.index):
            self.flagged.append(rec)
        after = {r.rid for r in self.candidates()}
        for rid in after - before:
            self.on_keep(rid)
        for rid in before - after:
            self.on_drop(rid)

    def sample(self) -> List[Record]:
        return [r for r in self.candidates() if not r.failed][: self.n]


def chunk_seed_base(rid: str) -> int:
    """The engine's S3Gen noise seed of a request's first text chunk (the
    request id's CRC-32 over the base 1234); chunk i's is this plus i."""
    return (1234 * 1_000_003 + (zlib.crc32(rid.encode()) & 0x7FFFFFFF)) & 0x7FFFFFFF


class Spies:
    """Records at the program's call sites, without a host sync: the
    tokens each text chunk's decode yielded, every decode slice's and
    S3Gen call's host span, every admission's width, what the reference's
    ``CAPTURE`` names of each batched S3Gen call (its stages' inputs and
    outputs), and (traced runs) K1's and K2's call shapes with their
    windows and key masks. Of the captures only the rows of the jobs of
    requests the ``Chooser`` keeps are kept, copied to the host once the
    call has returned (its audio is on the host by then, so the copy
    waits on nothing); the rest are freed with the call."""

    MAX_CHUNKS = 64

    def __init__(self, engine, trace: bool, capture: Dict):
        import threading

        self.local = threading.local()
        self.keep: Dict[int, str] = {}          # chunk seed base → request id
        self.kept: Dict[str, List[Dict]] = {}   # request id → its jobs, as they ran
        self.tokens: Dict[int, List] = {}
        self.slices: List = []
        self.calls: List = []
        self.prefills: List = []
        self.k1: List = []
        self.k2: List = []
        self._undo = []
        dec, sched = engine.decoder, engine.s3gen_scheduler
        spies = self
        decode_chunk, run_slice, insert = dec.decode_chunk, dec.run_slice, dec.insert
        run_batch = sched._run_batch

        def spy_decode_chunk(*a, stats=None, **kw):
            rows: List = []
            spies.tokens.setdefault(id(stats), []).append(rows)

            async def gen():
                async for row in decode_chunk(*a, stats=stats, **kw):
                    rows.append(row)
                    yield row
            return gen()

        def spy_run_slice(n_steps, s_view):
            active = len(dec._queues)
            t0, w0 = time.perf_counter(), time.time_ns()
            out = run_slice(n_steps, s_view)
            spies.slices.append((t0, time.perf_counter(), w0, time.time_ns(), n_steps, active))
            return out

        def spy_insert(slot, cond_lanes, text, *a, **kw):
            t0 = time.perf_counter()
            out = insert(slot, cond_lanes, text, *a, **kw)
            spies.prefills.append((t0, time.perf_counter(), int(cond_lanes.shape[1] + text.shape[1])))
            return out

        def spy_run_batch(jobs):
            t0, w0 = time.perf_counter(), time.time_ns()
            batch: Dict = {}
            spies.local.batch = batch
            try:
                out = run_batch(jobs)
            finally:
                spies.local.batch = None
            spies._keep_rows(jobs, out, batch)
            spies.calls.append((t0, time.perf_counter(), w0, time.time_ns(),
                                [(j.token_len, j.new_len if j.rstate is not None else j.token_len)
                                 for j in jobs]))
            return out

        for obj, name, fn in ((dec, "decode_chunk", spy_decode_chunk), (dec, "run_slice", spy_run_slice),
                              (dec, "insert", spy_insert), (sched, "_run_batch", spy_run_batch)):
            setattr(obj, name, fn)
            self._undo.append((obj, name))
        self._captures(capture)
        if trace:
            self._kernel_spies()

    def want(self, rid: str) -> None:
        self.keep[chunk_seed_base(rid)] = rid
        self.kept.setdefault(rid, [])

    def drop(self, rid: str) -> None:
        self.keep.pop(chunk_seed_base(rid), None)
        self.kept.pop(rid, None)

    def _keep_rows(self, jobs, out, batch: Dict) -> None:
        """The jobs of kept requests, each with its row of the call's
        captures, on the host."""
        def row_of(x, row):
            if hasattr(x, "dim"):
                return (x[row] if x.dim() else x).detach().cpu()
            return x

        for row, j in enumerate(jobs):
            for base, rid in list(self.keep.items()):   # the loop's thread may drop one meanwhile
                ci, kept = j.seed - base, self.kept.get(rid)
                if 0 <= ci < self.MAX_CHUNKS and kept is not None:
                    kept.append({
                        "chunk": ci, "seed": j.seed, "token_len": j.token_len,
                        "new_len": j.new_len, "prev_rel": j.prev_rel, "tokens": np.array(j.tokens),
                        "start": out[1][row], "tail": np.array(out[0][row]), "row": row,
                        "rows": len(jobs), **{k: [row_of(x, row) for x in v] for k, v in batch.items()}})

    def _captures(self, capture: Dict):
        """Wrap each program function ``capture`` names ({key: (module,
        function, picks)}, a pick ("arg", i) or ("out", i), i None for the
        whole output) to keep what it picks, in the record of the batched
        S3Gen call it runs in; the last call of a batch wins. The call's
        record lives until the call returns (``_keep_rows``)."""
        import importlib

        spies = self
        self._modules = getattr(self, "_modules", [])
        for key, (mod_name, fn_name, picks) in capture.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)

            def spy(*a, _fn=fn, _key=key, _picks=picks, **kw):
                out = _fn(*a, **kw)
                batch = getattr(spies.local, "batch", None)
                if batch is not None:
                    got = []
                    for where, i in _picks:
                        x = a[i] if where == "arg" else (out if i is None else out[i])
                        got.append(x.detach() if hasattr(x, "detach") else x)
                    batch[_key] = got
                return out
            setattr(mod, fn_name, spy)
            self._modules.append((mod, fn_name, fn))

    def _kernel_spies(self):
        from chatterbox_tpu_torch.models.s3gen_ref import decoder as ref_decoder
        from chatterbox_tpu_torch.models.t3 import model as t3_model

        k1, k2 = t3_model.decode_attention, getattr(ref_decoder, "flash_mha_context", None)
        spies = self

        def spy_k1(q, k_cache, v_cache, k_new, v_new, start, pos, k_scale=None, v_scale=None,
                   s_view=None):
            if spies.recording:
                spies.k1.append((tuple(q.shape), q.element_size(), q.dtype, k_cache.dtype,
                                 k_cache.shape[1], k_scale is not None,
                                 (pos - start).clamp_min(0).sum()))
            return k1(q, k_cache, v_cache, k_new, v_new, start, pos, k_scale, v_scale, s_view)

        def spy_k2(q, k_own, v_own, k_prompt, v_prompt, k_ring, v_ring, valid, scale=None):
            if spies.recording:
                spies.k2.append((tuple(q.shape), q.element_size(), q.dtype, k_prompt.shape[0],
                                 k_prompt.shape[2], 0 if k_ring is None else k_ring.shape[2],
                                 k_prompt.element_size(), valid.clone()))
            return k2(q, k_own, v_own, k_prompt, v_prompt, k_ring, v_ring, valid, scale)

        self.recording = False
        self._modules.append((t3_model, "decode_attention", k1))
        t3_model.decode_attention = spy_k1
        if k2 is not None:
            ref_decoder.flash_mha_context = spy_k2
            self._modules.append((ref_decoder, "flash_mha_context", k2))

    def close(self):
        for obj, name in self._undo:
            obj.__dict__.pop(name, None)
        for mod, name, fn in getattr(self, "_modules", []):
            setattr(mod, name, fn)


class Profiler:
    """torch.profiler over CUDA activity: started before the window in its
    warm-up state (CUPTI's start-up falls outside the window), active from
    ``open()`` to ``close()``; the device events come back as
    (name, start ns, end ns)."""

    def __init__(self):
        import torch

        self.events = None

        def ready(p):
            self.events = [(e.name(), e.start_ns(), e.end_ns())
                           for e in p.profiler.kineto_results.events()
                           if e.device_type() == torch.autograd.DeviceType.CUDA]

        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=ready)
        self.prof.start()

    def open(self):
        self.prof.step()

    def close(self):
        self.prof.step()
        self.prof.stop()
        if self.events is None:
            raise RuntimeError("torch.profiler returned no trace")
        if not self.events:
            raise RuntimeError("torch.profiler recorded no device activity")


def host_reading() -> Dict:
    """The host's CPU counters (``/proc/stat``'s first line, in clock
    ticks) and this process's CPU seconds, to see what else ran on the
    host during the window."""
    import resource

    out: Dict = {"load1": os.getloadavg()[0]}
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out["process_cpu_s"] = ru.ru_utime + ru.ru_stime
    try:
        with open("/proc/stat") as f:
            out["ticks"] = [int(x) for x in f.readline().split()[1:]]
    except OSError:
        pass
    return out


def host_window(a: Dict, b: Dict, window_s: float) -> Dict:
    """What the host did between two ``host_reading``s: its load, the
    shares of its CPU time that were busy and stolen by the hypervisor,
    and the cores this process used."""
    out = {"load1_open": a["load1"], "load1_close": b["load1"], "cores": os.cpu_count(),
           "process_cores": (b["process_cpu_s"] - a["process_cpu_s"]) / window_s}
    if "ticks" in a and "ticks" in b:
        d = [y - x for x, y in zip(a["ticks"], b["ticks"])]
        total = sum(d) or 1
        idle = d[3] + (d[4] if len(d) > 4 else 0)
        out["host_busy_share"] = 1.0 - idle / total
        out["steal_share"] = d[7] / total if len(d) > 7 else None
    try:
        with open("/proc/cpuinfo") as f:
            out["cpu"] = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")),
                              None)
    except OSError:
        pass
    return out


def program_config(config: Dict, max_new_tokens: int):
    """The engine's configuration as the deployment builds it (the preset
    the file names, under the file's environment), with the mix's decode
    cap; every size the file states must be the program's own."""
    from chatterbox_tpu_torch.runtime.engine import EngineConfig

    model = config["model"]
    cfg = getattr(EngineConfig, model["engine"]["preset"])()
    cfg = dataclasses.replace(cfg, max_new_tokens=max_new_tokens)
    got = dataclasses.asdict(cfg)
    for part, want in model.items():
        have = got[part] if part != "engine" else got
        for key, value in want.items():
            if key == "preset":
                continue
            if json.loads(json.dumps(have[key])) != value:
                raise RuntimeError(f"configuration: {part}.{key} is {have[key]!r} in the program, "
                                   f"{value!r} in the file")
    return cfg


def observe(ref):
    """Wrap each program function the reference's ``OBSERVE`` names
    ({key: (module, function)}) to keep its first return value → a call
    that unwraps them and gives {key: the value, on the CPU}."""
    import importlib

    seen, undo = {}, []
    for key, (mod_name, fn_name) in getattr(ref, "OBSERVE", {}).items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def spy(*a, _fn=fn, _key=key, **kw):
            out = _fn(*a, **kw)
            seen.setdefault(_key, tuple(x.detach().cpu() if hasattr(x, "detach") else x
                                        for x in (out if isinstance(out, tuple) else (out,))))
            return out
        setattr(mod, fn_name, spy)
        undo.append((mod, fn_name, fn))

    def done():
        for mod, name, fn in undo:
            setattr(mod, name, fn)
        return seen
    return done


# ------------------------------------------------------------------ the loop
async def drive(engine, settings, cell: Dict, seed: int, seconds: float, rate: Optional[float],
                spies: Spies, on_open, on_close) -> Dict:
    """The cell's traffic through ``engine.stream`` → the records, the
    window's bounds (perf_counter) and the sample the reference will judge
    (``Chooser``). When the window closes, a closed loop follows the
    sample's requests still in flight to their end; an open loop follows
    every request to its end."""
    from chatterbox_tpu_torch.runtime.cancellation import CancellationToken

    mix = dict(cell["traffic"])
    if rate is not None:
        mix["rate_per_s"] = rate
    warm = mix["warmup_s"]
    overlap = mix["overlap"]
    t_loop = time.perf_counter()
    t_open, t_close = t_loop + warm, t_loop + warm + seconds
    records: List[Record] = []
    closing = asyncio.Event()
    follow: set = set()
    chooser = Chooser(cell["config"]["check"]["requests"], seed, spies.want, spies.drop)

    async def one(req: traffic.Request, due: float) -> Record:
        rec = Record(req, f"req{req.index}", request_args(settings, overlap, req.greedy), due)
        records.append(rec)
        chooser.offer(rec)
        token = CancellationToken()
        data = bytearray()
        gen = engine.stream(text=req.text, request_id=rec.rid, cancellation_token=token, **rec.args)
        try:
            async for chunk in gen:
                t = time.perf_counter()
                if chunk:
                    before = max(0, len(data) - stats.WAV_HEADER_BYTES)
                    data += chunk
                    after = max(0, len(data) - stats.WAV_HEADER_BYTES)
                    if after > before:
                        rec.arrivals.append((t, after - before))
                        if rec.first_audio is None:
                            rec.first_audio = t
                if (mix["loop"] == "closed" and closing.is_set() and rec.first_audio is not None
                        and rec.rid not in follow):
                    token.cancel()
                    break
            else:
                rec.finished = True
        except Exception as exc:  # a failed request counts against the run
            rec.failed = f"{type(exc).__name__}: {exc}"
        finally:
            await gen.aclose()
        rec.end = time.perf_counter()
        rec.wav = bytes(data)
        rec.stats = engine.request_stats.get(rec.rid)
        if rec.stats is not None:
            rec.chunks = [[int(t) for row in rows for t in row]
                          for rows in spies.tokens.pop(id(rec.stats), [])]
        return rec

    async def window():
        await asyncio.sleep(max(0.0, t_open - time.perf_counter()))
        on_open()
        chooser.window_open = True
        await asyncio.sleep(max(0.0, t_close - time.perf_counter()))
        on_close()
        follow.update(r.rid for r in chooser.candidates())
        closing.set()

    win = asyncio.create_task(window())
    if mix["loop"] == "closed":
        reqs = iter(traffic.requests(mix, seed, count=100_000))

        async def client(c: int):
            await asyncio.sleep(c * mix.get("start_stagger_s", 0.0))
            while not closing.is_set():
                await one(next(reqs), time.perf_counter())

        await asyncio.gather(*[client(c) for c in range(mix["clients"])], win)
        late = []
    else:
        tasks, late = [], []
        for req in traffic.requests(mix, seed, warmup_s=warm, seconds=seconds):
            due = t_loop + req.due_s
            await asyncio.sleep(max(0.0, due - time.perf_counter()))
            late.append(time.perf_counter() - due)
            tasks.append(asyncio.create_task(one(req, due)))
        await win
        await asyncio.gather(*tasks)
    sample = [r for r in chooser.sample() if r.finished]
    return {"records": records, "t_open": t_open, "t_close": t_close, "late": late, "mix": mix,
            "sample": sample, "kept": spies.kept}


# ------------------------------------------------------------------ metrics
def end_to_end(run: Dict, sr: int, memory_peak: int = 0) -> Dict:
    """The window's end-to-end numbers from the client's side, and the
    device memory the window's work held at its peak (0: not read)."""
    t_open, t_close = run["t_open"], run["t_close"]
    recs = run["records"]
    due = [r for r in recs if t_open <= r.due < t_close]
    inf = math.inf

    def ttfa(r):
        return (r.first_audio - r.due) * 1e3 if r.first_audio is not None and not r.failed else inf

    def rtf(r):
        if not r.finished or r.failed or not r.stats or not r.stats.get("samples"):
            return inf
        return (r.end - r.due) / (r.stats["samples"] / sr)

    arrivals = [a for r in recs for a in r.arrivals]
    out = {"attempted": len(due), "failed": sum(1 for r in due if r.failed or r.first_audio is None),
           "audio_s_per_s": stats.audio_rate(arrivals, t_open, t_close, sr)}
    if memory_peak:
        out["memory_peak_gb"] = memory_peak / 1e9
    if due:
        t = [ttfa(r) for r in due]
        out["ttfa_p50_ms"] = stats.median(t)
        out["ttfa_p95_ms"], out["ttfa_n"], out["ttfa_beyond_p95"] = stats.percentile(t, 0.95)
        if run["mix"]["loop"] == "open":
            out["rtf_p50"] = stats.median([rtf(r) for r in due])
    return out


def layer_context(run: Dict, spies: Spies, stage_delta: Dict, engine_info: Dict,
                  trace: Optional[Dict]) -> Dict:
    """What the per-layer readers read (``gpubench/metrics/``)."""
    t_open, t_close = run["t_open"], run["t_close"]
    inside = lambda t0: t_open <= t0 < t_close  # noqa: E731
    return {"window_s": t_close - t_open, "t_open": t_open, "t_close": t_close,
            "records": [r for r in run["records"] if inside(r.due)],
            "arrivals": [a for r in run["records"] for a in r.arrivals],
            "slices": [s for s in spies.slices if inside(s[0])],
            "calls": [c for c in spies.calls if inside(c[0])],
            "prefills": [p for p in spies.prefills if inside(p[0])],
            "stages": stage_delta, "engine": engine_info, "trace": trace,
            "k1": spies.k1, "k2": spies.k2, "sr": engine_info["sr"]}


def read_trace(events, spies: Spies, t_open_ns: int, t_close_ns: int) -> Dict:
    """Device busy time, kernel sums and idle time of the traced window.
    Each gap between device activities is labelled with the harness's host
    spans open at its middle (a T3 decode slice, an S3Gen call, both, or
    neither: the host between calls), and the idle seconds are summed by
    label."""
    import re

    spans = [(a, b) for _, a, b in events]
    lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    busy_ns = stats.interval_union(spans)
    by: Dict[str, float] = {}
    for name, a, b in events:
        short = re.sub(r"^void |\(anonymous namespace\)::", "", name)
        short = re.split(r"[<(]", short, maxsplit=1)[0].strip()[:60]
        by[short] = by.get(short, 0.0) + (b - a) / 1e9
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    host = ([("t3_slice", s[2], s[3]) for s in spies.slices]
            + [("s3gen_call", c[2], c[3]) for c in spies.calls])
    aligned = lo >= t_open_ns - 5e9 and hi <= t_close_ns + 5e9
    idle: Dict[str, float] = {}
    for (_, b0), (a1, _) in zip(merged, merged[1:]):
        mid = (b0 + a1) // 2
        label = "unaligned clocks"
        if aligned:
            open_spans = sorted({n for n, s0, s1 in host if s0 <= mid < s1})
            label = "+".join(open_spans) if open_spans else "host between calls"
        idle[label] = idle.get(label, 0.0) + (a1 - b0) / 1e9
    return {"busy_s": busy_ns / 1e9, "span_s": (hi - lo) / 1e9, "by_name": by,
            "device_ops": sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda r: -r[1])[:10]}


# ------------------------------------------------------------------ the run
async def run_cell(cell: Dict, seed: int, seconds: float, trace: bool, device: str,
                   rate: Optional[float] = None, check: bool = True, control: bool = False) -> tuple:
    """→ (result dict, the compared numbers {name: (value, limit)}, notes).
    ``control``: the notes also hold the control's numbers (``judge``)."""
    import torch

    t_setup: Dict[str, float] = {}
    config, mix = cell["config"], cell["traffic"]
    ref = manifest.reference(config)
    os.environ.update({k: str(v) for k, v in config["env"].items()})
    os.environ["CHATTERBOX_MAX_NEW_TOKENS"] = str(mix["max_new_tokens"])
    with tempfile.TemporaryDirectory(prefix="gpubench-") as tmp:
        tmp = Path(tmp)
        for d in ("model", "voices", "preloaded-voices"):
            (tmp / d).mkdir()
        os.environ.update(MODEL_PATH=str(tmp / "model"), VOICES_DIR=str(tmp / "voices"),
                          PRELOADED_VOICES_DIR=str(tmp / "preloaded-voices"))
        from chatterbox_tpu_torch.convert import convert_params
        from chatterbox_tpu_torch.runtime.engine import TTSEngine
        from chatterbox_tpu_torch.runtime.metrics import metrics
        from chatterbox_tpu_torch.settings import get_tts_config

        from . import weights

        t_setup["imports"] = time.perf_counter()
        prec = config["precision"]
        if device != "cpu":
            for flag, want in (("matmul_allow_tf32", torch.backends.cuda.matmul.allow_tf32),
                               ("cudnn_allow_tf32", torch.backends.cudnn.allow_tf32)):
                if prec[flag] != want:
                    raise RuntimeError(f"precision: {flag} is {want}, the configuration states "
                                       f"{prec[flag]}")
        cfg = program_config(config, mix["max_new_tokens"])
        sz = ref.sizes(config, mix["max_new_tokens"])
        dtype = getattr(torch, config["model"]["engine"]["param_dtype"])
        wseed = seed & 0x7FFFFFFFFFFF
        raw = weights.make_tree(lambda init: ref.param_trees(sz, init), wseed, device, dtype)
        params = convert_params(raw, device, dtype)
        rates = ref.flop_rates(raw)
        del raw
        conds_path = tmp / "model" / "conds.pt"
        ref.write_conds(conds_path, wseed, sz)
        if device != "cpu":
            torch.cuda.synchronize()
        t_setup["weights"] = time.perf_counter()
        engine = TTSEngine(cfg, seed=seed & 0x7FFFFFFF, device=device, params=params)
        del params
        observed = observe(ref)
        await engine.ainit()
        observed = observed()
        t_setup["ainit"] = time.perf_counter()
        spies = Spies(engine, trace, getattr(ref, "CAPTURE", {}) if check else {})
        settings = get_tts_config()
        prof = Profiler() if trace else None
        marks: Dict = {}
        stage0: Dict = {}

        def on_open():
            marks["host_open"] = host_reading()
            marks["open"] = time.perf_counter()
            marks["open_ns"] = time.time_ns()
            stage0.update(metrics.snapshot()["stages"])
            if device != "cpu":
                torch.cuda.reset_peak_memory_stats()
            if prof is not None:
                prof.open()
                spies.recording = True

        def on_close():
            if prof is not None:
                spies.recording = False
                prof.close()
            marks["close_ns"] = time.time_ns()
            marks["host_close"] = host_reading()
            marks["stages"] = metrics.snapshot()["stages"]

        run = await drive(engine, settings, cell, seed, seconds, rate, spies, on_open, on_close)
        setup = {"imports": t_setup["imports"] - T_PROCESS,
                 "weights": t_setup["weights"] - t_setup["imports"],
                 "ainit": t_setup["ainit"] - t_setup["weights"],
                 "warmup": run["t_open"] - t_setup["ainit"]}
        setup_s = run["t_open"] - T_PROCESS
        stage_delta = {k: {f: v[f] - stage0.get(k, {}).get(f, 0) for f in ("time_s", "count", "items")}
                       for k, v in marks["stages"].items()}
        memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        info = {"sr": engine.sr, "spt": engine.gen_cfg.samples_per_token,
                "n_evals": ref.estimator_evals(sz),
                "flop_rates": rates, "cond_len": cfg.t3.cond_len}
        spies.close()
        engine.shutdown()
        del engine
        gc.collect()
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

        e2e = end_to_end(run, info["sr"], memory_peak)
        trace_info = None
        if trace:
            trace_info = read_trace(prof.events, spies, marks["open_ns"], marks["close_ns"])
        ctx = layer_context(run, spies, stage_delta, info, trace_info)
        ctx["jobs"] = [ref.job_positions(sz, tok, new) for c in ctx["calls"] for tok, new in c[4]]

        # judge the window's work
        t_check = time.perf_counter()
        checks, notes = judge(run, ref, sz, conds_path, seed, wseed, device, dtype, config, info,
                              check, control, observed)
        check_s = time.perf_counter() - t_check

    names = cell["per_layer"] if trace else cell["end_to_end"]
    metrics_out = {}
    for m in names:
        if trace:
            value = manifest.metric_reader(m["name"], cell["root"] / "gpubench")(ctx)
        else:
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
        if value is None:
            continue
        metrics_out[m["name"]] = {"value": value, "unit": m["unit"]}
    finite = all(math.isfinite(v["value"]) for v in metrics_out.values())
    correct = (finite and e2e["failed"] == 0
               and all(v <= lim for v, lim in checks.values()) and not notes.get("faults"))
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name() if device != "cpu" else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    if trace:
        dev["busy_s"] = trace_info["busy_s"]
        dev["window_s"] = ctx["window_s"]
    result = {"correct": bool(correct), "attempted": e2e["attempted"], "failed": e2e["failed"],
              "metrics": {k: {"value": (v["value"] if math.isfinite(v["value"]) else 1e300),
                              "unit": v["unit"]} for k, v in metrics_out.items()},
              "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": trace_info["device_ops"],
                               "idle_gaps": trace_info["idle_gaps"]}
    sl, calls = ctx["slices"], ctx["calls"]
    notes["window_work"] = {
        "slices": len(sl), "steps": sum(x[4] for x in sl), "slice_wall_s": sum(x[1] - x[0] for x in sl),
        "slots_mean": sum(x[5] for x in sl) / max(1, len(sl)), "s3gen_calls": len(calls),
        "s3gen_jobs": sum(len(c[4]) for c in calls), "s3gen_wall_s": sum(c[1] - c[0] for c in calls),
        "prefills": len(ctx["prefills"]), "requests_due": len(ctx["records"])}
    notes["host"] = host_window(marks["host_open"], marks["host_close"], ctx["window_s"])
    notes.update(setup_s=setup_s, setup_split_s=setup, check_s=check_s, e2e=e2e,
                 late_s=_late(run["late"]), precision={k: v for k, v in config["precision"].items()})
    return result, checks, notes


def _late(late: List[float]) -> Dict:
    if not late:
        return {}
    p95, n, _ = stats.percentile(late, 0.95)
    return {"n": n, "median": stats.median(late), "p95": p95, "max": max(late)}


def jobs_by_request(sample: List[Record], kept: Dict[str, List[Dict]],
                    device: str) -> Dict[str, List[List[Dict]]]:
    """Each sampled request's S3Gen jobs in the order they ran, per text
    chunk (a job's noise seed is the engine's chunk seed,
    ``chunk_seed_base`` plus the chunk's index), each with its rows of
    the call's captures, on ``device``."""
    out: Dict[str, List[List[Dict]]] = {r.rid: [[] for _ in (r.chunks or [])] for r in sample}
    for r in sample:
        for job in kept.get(r.rid, []):
            if job["chunk"] < len(out[r.rid]):
                out[r.rid][job["chunk"]].append(
                    {k: [x.to(device) if hasattr(x, "to") else x for x in v]
                     if isinstance(v, list) else v for k, v in job.items()})
    return out


def judge(run: Dict, ref, sz, conds_path, seed: int, wseed: int, device: str, dtype, config: Dict,
          info: Dict, check: bool, control: bool = False, observed: Optional[Dict] = None) -> tuple:
    """The structural check of every finished request, then the reference
    over the sample ``drive`` followed to its end → ({name: (value, limit)},
    notes). With ``control`` the reference in the next lower precision is
    put in the program's place over the same sample, and its numbers go
    into ``notes["control"]``."""
    from . import weights

    finished = [r for r in run["records"] if r.finished and not r.failed]
    faults = []
    pcm = {}
    for r in finished:
        fade = int(info["sr"] * r.args["crossfade_duration_milliseconds"] / 1000)
        try:
            pcm[r.rid] = stats.check_wav(r.wav, r.stats, info["sr"], info["spt"], fade)
        except AssertionError as exc:
            faults.append(f"{r.rid}: {exc}")
    sample = [r for r in run["sample"] if r.finished and not r.failed]
    notes = {"finished": len(finished), "faults": faults}
    if not check:
        return {}, notes
    if not sample:
        return {"sampled_requests_finished": (0.0, -1.0)}, notes
    raw = weights.make_tree(lambda init: ref.param_trees(sz, init), wseed, device, dtype)
    reference = ref.Reference(sz, raw, conds_path, device, observed=observed)
    lower = ref.Reference(sz, raw, conds_path, device, control=True) if control else None
    del raw
    jobs = jobs_by_request(sample, run["kept"], device)
    numbers = ref.compare(reference, sample, pcm, config["check"], jobs)
    if lower is not None:
        notes["control"] = ref.compare(reference, sample, pcm, config["check"], jobs,
                                       control=lower)
    notes["sample"] = [{"rid": r.rid, "greedy": r.req.greedy, "chunks": len(r.chunks),
                        "tokens": sum(len(c) for c in r.chunks),
                        "audio_s": r.stats["samples"] / info["sr"]} for r in sample]
    skip = config["check"].get("not_compared", [])
    notes["not_compared"] = {k: v for k, v in numbers.items() if k in skip}
    # a number without a limit in the configuration fails
    return {k: (v, config["limits"].get(k, -1.0)) for k, v in numbers.items()
            if k not in skip}, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = manifest.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"gpubench: the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    set_cache_dirs(manifest.ROOT)
    result, checks, notes = asyncio.run(run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                                 "cuda"))
    bad = forbidden_modules()
    if bad:
        log(f"gpubench: forbidden modules loaded in this process: {bad}")
        return 3
    print(json.dumps({"notes": notes}, default=str), flush=True)
    result[CHECK_LAST] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
