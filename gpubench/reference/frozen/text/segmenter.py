"""Rule-based English sentence segmentation (a copy of
``chatterbox_tpu.text.segmenter``).

The reference delegates sentence boundary detection to the pysbd library
(reference src/text_processing.py:143-158). pysbd is not available in
this environment, so this is a self-contained segmenter covering the cases the
TTS frontend needs: terminal punctuation, common abbreviations, initials,
decimal numbers, ellipses (pre-normalized upstream), and quoted sentence ends.
"""
from __future__ import annotations

import re
from typing import List

# Common English abbreviations that a period does NOT terminate a sentence after.
_ABBREVIATIONS = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "mt", "capt", "col",
    "gen", "lt", "sgt", "rev", "hon", "pres", "gov", "sen", "rep",
    "vs", "etc", "eg", "e.g", "ie", "i.e", "cf", "al", "approx",
    "inc", "ltd", "co", "corp", "dept", "univ", "assn", "bros",
    "no", "nos", "vol", "fig", "sec", "min", "max", "est",
    "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep", "sept", "oct",
    "nov", "dec", "mon", "tue", "wed", "thu", "fri", "sat", "sun",
    "ave", "blvd", "rd", "hwy", "apt",
}

# A sentence terminator: run of .!? possibly followed by closing quotes/brackets.
_TERMINATOR = re.compile(r"([.!?]+[\"'”’)\]]*)(\s+|$)")


def _is_abbreviation(prefix: str) -> bool:
    """True if the text immediately before a period ends with an abbreviation."""
    m = re.search(r"([A-Za-z][A-Za-z.]*)$", prefix)
    if not m:
        return False
    word = m.group(1).rstrip(".").lower()
    if word in _ABBREVIATIONS:
        return True
    # Single-letter initial, e.g. "J. K. Rowling"
    if len(word) == 1:
        return True
    # Dotted acronyms like "U.S"
    if "." in m.group(1):
        return True
    return False


def segment_sentences(text: str) -> List[str]:
    """Split text into sentences. Whitespace-collapsed input is expected."""
    if not text or not text.strip():
        return []

    sentences: List[str] = []
    start = 0
    pos = 0
    n = len(text)
    while pos < n:
        m = _TERMINATOR.search(text, pos)
        if not m:
            break
        end = m.end(1)
        punct = m.group(1)
        before = text[start:m.start(1)]

        # Period-terminated candidates need abbreviation / decimal guards.
        if punct.startswith("."):
            # Decimal number: "3.14" — only a boundary if followed by space+etc,
            # but _TERMINATOR requires whitespace, so "3. 14" would split; a
            # digit immediately after the period never matches here.
            if _is_abbreviation(before):
                # If the next word starts a clearly new sentence (capitalized
                # non-name word after e.g. "etc."), we still keep it joined —
                # simple rule: abbreviation never terminates.
                pos = end
                continue
        candidate = text[start:end].strip()
        if candidate:
            sentences.append(candidate)
        start = end
        pos = end

    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences
