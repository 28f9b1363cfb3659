"""The yardstick's arithmetic: percentiles, the window's rate, the union of
device intervals and the WAV's structure.

Frozen copies of the program's bench helpers (``scripts/common.py``:
``check_wav``, ``device_ms``'s interval union; ``percentile`` there takes
no count, this one states it), so a change to the program cannot move
them.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


WAV_HEADER_BYTES = 44


def percentile(values: Sequence[float], q: float) -> Tuple[float, int, int]:
    """Nearest rank: the ⌈q·n⌉-th smallest value → (value, n, samples
    beyond it)."""
    vals = sorted(values)
    n = len(vals)
    if not n:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q * n))
    return vals[rank - 1], n, n - rank


def median(values: Sequence[float]) -> float:
    vals = sorted(values)
    n = len(vals)
    return vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])


def bytes_in_window(arrivals: Iterable[Tuple[float, int]], t_open: float, t_close: float) -> int:
    """PCM bytes that arrived in [t_open, t_close)."""
    return sum(n for t, n in arrivals if t_open <= t < t_close)


def audio_rate(arrivals: Iterable[Tuple[float, int]], t_open: float, t_close: float, sr: int) -> float:
    """Seconds of 16-bit mono PCM that arrived in [t_open, t_close), per
    second of that span."""
    return bytes_in_window(arrivals, t_open, t_close) / 2 / sr / (t_close - t_open)


def interval_union(spans: List[Tuple[int, int]]) -> int:
    """Total length covered by the union of [a, b) intervals."""
    if not spans:
        return 0
    spans = sorted(spans)
    busy, (lo, hi) = 0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo


def check_wav(data: bytes, stats: Dict, sr: int, spt: int, fade: int) -> np.ndarray:
    """A streamed WAV against its request's record (RIFF header, sample
    count against the tokens produced, less the codes S3Gen drops as outside
    its vocabulary, the crossfade's seams, finite, not silent) → its PCM16
    samples."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE" or data[36:40] != b"data":
        raise AssertionError("no RIFF/WAVE header")
    channels, rate, _, _, bits = struct.unpack("<HLLHH", data[22:36])
    if (channels, rate, bits) != (1, sr, 16):
        raise AssertionError(f"header says {channels} ch, {rate} Hz, {bits} bit")
    pcm = np.frombuffer(data[44:], dtype="<i2")
    if pcm.size != stats["samples"]:
        raise AssertionError(f"{pcm.size} samples in the WAV, engine emitted {stats['samples']}")
    want = (sum(n + 1 for n in stats["t3_tokens"]) - stats["dropped_codes"]) * spt
    if stats["synth_samples"] != want:
        raise AssertionError(f"synthesised {stats['synth_samples']} samples, tokens "
                             f"{stats['t3_tokens']} less {stats['dropped_codes']} dropped give {want}")
    seams, rest = divmod(stats["synth_samples"] - stats["samples"], fade)
    if rest or not 0 <= seams < stats["slices"]:
        raise AssertionError(f"crossfade accounting off ({stats})")
    if np.abs(pcm).max() < 33:
        raise AssertionError("silent audio")
    return pcm
