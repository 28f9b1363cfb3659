"""Seeded English text of a given length: sentences of common words, with
capitals, commas and full stops, cut at a word boundary near the length."""
from __future__ import annotations

import random

_WORDS = (
    "the a an this that every some our their my your its one two three many few "
    "quick slow bright dark quiet loud small large early late warm cold old new "
    "long short gentle careful sudden distant nearby simple steady open narrow "
    "river city garden morning evening window market station engineer teacher "
    "letter music weather bridge answer question road forest harbour kitchen "
    "village lantern journey signal message story picture country mountain "
    "walks runs waits listens reads writes builds carries opens closes finds "
    "keeps leaves watches follows brings turns starts stops sends hears "
    "softly quickly slowly often never always again together outside inside "
    "through across under over before after while because and but so then"
).split()


def sentence(rng: random.Random) -> str:
    n = rng.randint(5, 14)
    words = [rng.choice(_WORDS) for _ in range(n)]
    if n > 8:
        words[rng.randint(3, n - 4)] += ","
    return " ".join(words).capitalize() + "."


def text(rng: random.Random, length: int) -> str:
    """About ``length`` characters (never over it, at least one sentence's
    first words), ending with a full stop."""
    out = ""
    while len(out) < length:
        out = (out + " " + sentence(rng)).strip()
    if len(out) > length:
        cut = out[:length].rsplit(" ", 1)[0].rstrip(",.")
        out = cut + "."
    return out
