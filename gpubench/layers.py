"""The arithmetic behind the per-layer metrics. Each metric's own reader
(``gpubench/metrics/<name>.py``) picks one of these; a reader that finds
nothing to read in the run returns None and the metric is left out.

``ctx`` (``run.layer_context``) holds the window's requests, the host spans
of its T3 decode slices (start, end, wall-clock start and end in ns, steps,
active slots) and S3Gen calls (…, the jobs' accumulated and new tokens), its
admissions, the engine's stage-time deltas, the trace's reading and K1's and
K2's recorded calls."""
from __future__ import annotations

from typing import Dict, Optional

from . import roofline, stats


def audio_s_per_s(ctx: Dict) -> Optional[float]:
    """PCM seconds that reached the clients in the window, over its length
    (every request's stream, as the untraced run's ``end_to_end`` counts)."""
    if not ctx["arrivals"]:
        return None
    return stats.audio_rate(ctx["arrivals"], ctx["t_open"], ctx["t_close"], ctx["sr"])


def t3_step_ms(ctx: Dict) -> Optional[float]:
    """Host wall per T3 decode step: the slices' walls over their steps."""
    steps = sum(s[4] for s in ctx["slices"])
    return 1e3 * sum(s[1] - s[0] for s in ctx["slices"]) / steps if steps else None


def t3_slots_mean(ctx: Dict) -> Optional[float]:
    """Active decode slots per slice, over the window's slices."""
    sl = ctx["slices"]
    return sum(s[5] for s in sl) / len(sl) if sl else None


def s3gen_call_ms(ctx: Dict) -> Optional[float]:
    """Host wall per batched S3Gen call (the engine's ``s3gen_device``
    stage over the window)."""
    st = ctx["stages"].get("s3gen_device")
    return 1e3 * st["time_s"] / st["count"] if st and st["count"] else None


def s3gen_jobs_mean(ctx: Dict) -> Optional[float]:
    """Jobs per batched S3Gen call (the stage's items over its count)."""
    st = ctx["stages"].get("s3gen_device")
    return st["items"] / st["count"] if st and st["count"] else None


def ttfa_p50_ms(ctx: Dict) -> Optional[float]:
    """Median over the window's requests of the client's time from due to
    the first PCM byte past the header; a request that failed or gave no
    audio counts as infinitely late."""
    recs = ctx["records"]
    if not recs:
        return None
    return stats.median([1e3 * (r.first_audio - r.due) if r.first_audio is not None and not r.failed
                         else float("inf") for r in recs])


def admit_wait_ms(ctx: Dict) -> Optional[float]:
    """Median over the window's requests of the client's TTFA less the
    engine's own ``ttfa_s`` (which starts once the request is admitted)."""
    waits = [1e3 * (r.first_audio - r.due - r.stats["ttfa_s"]) for r in ctx["records"]
             if r.first_audio is not None and r.stats and r.stats.get("ttfa_s") is not None]
    return stats.median(waits) if waits else None


def idle_share(ctx: Dict) -> Optional[float]:
    """Share of the window in which no device activity ran, in %."""
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / ctx["window_s"]) if tr else None


def mfu(ctx: Dict) -> Optional[float]:
    """The model FLOPs of the window's work over the window and the bf16
    dense peak, in % (``roofline.window_flops``)."""
    e = ctx["engine"]
    t3_tokens = 2 * sum(s[4] * s[5] for s in ctx["slices"])
    prefill = 2 * sum(p[2] for p in ctx["prefills"])
    jobs = ctx["jobs"]
    if not (t3_tokens or jobs):
        return None
    flops = roofline.window_flops(e["flop_rates"], t3_tokens, prefill, jobs, e["n_evals"])
    return 100.0 * flops / ctx["window_s"] / roofline.BF16_PEAK_FLOPS


def _kernel_s(ctx: Dict, names) -> float:
    tr = ctx["trace"]
    return sum(v for k, v in tr["by_name"].items() if k in names) if tr else 0.0


def k1_roofline(ctx: Dict) -> Optional[float]:
    """K1's bound over its kernel time in the window, in %: the frozen
    ``decode_bound`` of every recorded call, over the device time of
    ``decode_slice_kernel`` and ``decode_combine_kernel``."""
    t = _kernel_s(ctx, ("decode_slice_kernel", "decode_combine_kernel"))
    if not ctx["k1"] or not t:
        return None
    least = sum(roofline.decode_bound(q_shape, q_elem, q_dtype, c_dtype, int(rows), hk, sc)[0]
                for q_shape, q_elem, q_dtype, c_dtype, hk, sc, rows in ctx["k1"])
    return 100.0 * least / 1e3 / t


def k2ctx_roofline(ctx: Dict) -> Optional[float]:
    """K2's context form: the frozen ``ctx_bound`` of every recorded call
    over the device time of ``flash_ctx_kernel``, in %."""
    t = _kernel_s(ctx, ("flash_ctx_kernel",))
    if not ctx["k2"] or not t:
        return None
    least = sum(roofline.ctx_bound(q_shape, q_elem, q_dtype, kp_rows, P, W, c_elem, valid)[0]
                for q_shape, q_elem, q_dtype, kp_rows, P, W, c_elem, valid in ctx["k2"])
    return 100.0 * least / 1e3 / t
