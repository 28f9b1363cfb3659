"""Text frontend: normalization + chunking for streaming TTS (a copy of
``chatterbox_tpu.text.processing``; the chip-side program imports nothing
of the JAX package).

Behavioral contract follows the reference frontend
(reference src/text_processing.py:114-196):

  1. collapse whitespace; normalize smart punctuation; capitalize first letter;
  2. segment into sentences; guarantee each ends with one of ``. ! ? -``;
  3. greedily pack sentences into chunks of at most ``max_length`` characters;
  4. sentences longer than ``max_length`` are split first on ``;``/``:`` then on
     ``,`` then on word boundaries;
  5. a merge pass prevents chunks with fewer than two words, allowing a 10%
     length overflow when merging.

The implementation is original (the reference's pysbd dependency is replaced by
our own segmenter; the splitting/merging passes are restructured around a
delimiter-preserving tokenizer), but the observable chunking behavior matches.
"""
from __future__ import annotations

import re
from typing import List, Optional

from .segmenter import segment_sentences

_SENTENCE_ENDERS = (".", "!", "?", "-")

# Normalization table: smart punctuation -> ASCII / prosody-friendly forms.
_NORMALIZATIONS = [
    ("...", ". "),
    ("…", ". "),   # …
    (" - ", ", "),
    ("—", "-"),    # —
    ("–", "-"),    # –
    (" ,", ","),
    ("“", '"'),    # “
    ("”", '"'),    # ”
    ("‘", "'"),    # ‘
    ("’", "'"),    # ’
]

_MERGE_BUFFER = 0.10  # allowed overflow when merging small chunks
_MIN_WORDS = 2


def _normalize(text: str) -> str:
    text = " ".join(text.split())
    for old, new in _NORMALIZATIONS:
        text = text.replace(old, new)
    if text and text[0].islower():
        text = text[0].upper() + text[1:]
    return text


def _ensure_terminal_punct(sentence: str) -> str:
    sentence = sentence.strip()
    if sentence and not sentence.endswith(_SENTENCE_ENDERS):
        sentence += "."
    return sentence


def _split_keep_delims(text: str, delims: str) -> List[str]:
    """Split on any char in `delims`, keeping the delimiter attached to the
    preceding phrase. Runs of adjacent delimiters stick to the prior phrase."""
    pattern = re.compile(r"[^" + re.escape(delims) + r"]*[" + re.escape(delims) + r"]")
    phrases: List[str] = []
    pos = 0
    for m in pattern.finditer(text):
        piece = m.group(0).strip()
        pos = m.end()
        if not piece or all(c in delims for c in piece):
            # Bare delimiter run: glue onto the previous phrase.
            if phrases and piece:
                phrases[-1] += piece
            continue
        phrases.append(piece)
    tail = text[pos:].strip()
    if tail:
        phrases.append(tail)
    return phrases


def _split_by_words(text: str, max_length: int) -> List[str]:
    chunks: List[str] = []
    current = ""
    for word in text.split():
        joined = f"{current} {word}" if current else word
        if len(joined) <= max_length:
            current = joined
        else:
            if current:
                chunks.append(current)
            current = word
    if current:
        chunks.append(current)
    return _merge_small(chunks, max_length)


def _merge_small(chunks: List[str], max_length: int) -> List[str]:
    """Merge chunks with < _MIN_WORDS words into a neighbor when the combined
    length stays within max_length * (1 + buffer)."""
    limit = max_length * (1 + _MERGE_BUFFER)
    out: List[str] = []
    i = 0
    while i < len(chunks):
        chunk = chunks[i]
        if len(chunk.split()) >= _MIN_WORDS:
            out.append(chunk)
            i += 1
            continue
        # Small chunk: prefer merging backwards, then forwards.
        if out and len(out[-1]) + 1 + len(chunk) <= limit:
            out[-1] = f"{out[-1]} {chunk}"
        elif i + 1 < len(chunks) and len(chunk) + 1 + len(chunks[i + 1]) <= limit:
            out.append(f"{chunk} {chunks[i + 1]}")
            i += 1  # consumed the neighbor too
        else:
            out.append(chunk)  # unavoidable small chunk
        i += 1
    return out


def _split_oversized(sentence: str, max_length: int) -> List[str]:
    """Break one overlong sentence: major delimiters, minor delimiters, words."""
    pieces: List[str] = []
    for major in _split_keep_delims(sentence, ";:") or [sentence]:
        if len(major) <= max_length:
            pieces.append(major)
            continue
        for minor in _split_keep_delims(major, ",") or [major]:
            if len(minor) <= max_length:
                pieces.append(minor)
            else:
                pieces.extend(_split_by_words(minor, max_length))
    merged = _merge_small(pieces, max_length)
    return [p.strip() for p in merged if p.strip()]


def split_text_into_chunks(text: str, max_length: Optional[int] = None) -> List[str]:
    """Normalize `text` and split it into TTS-sized chunks.

    With ``max_length=None`` returns one chunk per sentence (each guaranteed to
    end in sentence punctuation). Otherwise packs sentences greedily into
    chunks of at most ``max_length`` characters.
    """
    if not text or not text.strip():
        return []
    text = _normalize(text)

    sentences = [_ensure_terminal_punct(s) for s in segment_sentences(text)]
    sentences = [s for s in sentences if s]

    if max_length is None:
        return sentences

    chunks: List[str] = []
    current = ""
    for sentence in sentences:
        if len(sentence) > max_length:
            if current:
                chunks.append(current)
                current = ""
            chunks.extend(_split_oversized(sentence, max_length))
            continue
        joined = f"{current} {sentence}" if current else sentence
        if len(joined) <= max_length:
            current = joined
        else:
            if current:
                chunks.append(current)
            current = sentence
    if current:
        chunks.append(current)

    merged = _merge_small(chunks, max_length)
    return [c.strip() for c in merged if c.strip()]
