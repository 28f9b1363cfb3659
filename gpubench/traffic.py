"""The one traffic generator: a mix file's parameters and a seed → the
requests, in the order they are sent.

Every seed gets the same work in another order: the text lengths are a
fixed set (the quantiles of a lognormal, clipped), and an open loop's gaps
between arrivals are a fixed set (the quantiles of an exponential at the
mix's rate); the seed shuffles both and writes the words. Every
``greedy_every``-th request decodes greedily (temperature 0), so the
correctness check can hold its tokens to the reference's logits; the rest
take the server's sampling defaults.

Mix file keys: ``loop`` ("closed" or "open"), ``clients`` and
``start_stagger_s`` (closed: client c sends its first request c · stagger
after the loop starts),
``rate_per_s`` (open), ``warmup_s`` (the loop runs this long before the
window opens), ``text_chars`` {median, sigma, min, max}, ``pool`` (lengths in
the set), ``greedy_every``, ``max_new_tokens`` (the decode cap per text
chunk), ``overlap`` (``chunk_overlap_strategy``).
"""
from __future__ import annotations

import math
import random
import statistics
from dataclasses import dataclass
from typing import Dict, List

from . import textgen


@dataclass(frozen=True)
class Request:
    index: int
    text: str
    greedy: bool
    due_s: float = 0.0   # open loop: seconds after the loop starts


def _lengths(mix: Dict) -> List[int]:
    tc = mix["text_chars"]
    n = mix["pool"]
    z = statistics.NormalDist()
    return [int(min(tc["max"], max(tc["min"], round(math.exp(
        math.log(tc["median"]) + tc["sigma"] * z.inv_cdf((i + 0.5) / n))))))
        for i in range(n)]


def _texts(mix: Dict, rng: random.Random, count: int) -> List[str]:
    lengths: List[int] = []
    while len(lengths) < count:
        pool = _lengths(mix)
        rng.shuffle(pool)
        lengths += pool
    return [textgen.text(rng, n) for n in lengths[:count]]


def _arrivals(n: int, span: float, rng: random.Random) -> List[float]:
    """``n`` arrival times in [0, span): the gaps are the quantiles of an
    exponential, scaled to sum to ``span``, in a seeded order."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    rng.shuffle(gaps)
    total = sum(gaps)
    out, t = [], 0.0
    for g in gaps:
        out.append(t)
        t += g * span / total
    return out


def requests(mix: Dict, seed: int, count: int = 0, warmup_s: float = 0.0,
             seconds: float = 0.0) -> List[Request]:
    """The requests of the mix under ``seed``, in the order they are sent.
    A closed loop: the first ``count``. An open loop: round(rate · warmup_s)
    due in the warm-up and round(rate · seconds) due in the window, each set
    spread over its span, due times in seconds after the loop starts."""
    rng = random.Random(seed)
    if mix["loop"] == "open":
        rate = mix["rate_per_s"]
        n_warm, n_win = round(rate * warmup_s), max(1, round(rate * seconds))
        due = _arrivals(n_warm, warmup_s, rng) if n_warm else []
        due += [warmup_s + t for t in _arrivals(n_win, seconds, rng)]
        count = len(due)
    else:
        due = [0.0] * count
    texts = _texts(mix, rng, count)
    return [Request(i, texts[i], i % mix["greedy_every"] == 0, due[i]) for i in range(count)]
