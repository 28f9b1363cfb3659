"""Text tokenizer (EnTokenizer equivalent; the contract of
``chatterbox_tpu.models.tokenizer``).

The reference's ``EnTokenizer`` wraps a HF `tokenizers` BPE with a ~704-token
vocabulary; the serving stack calls ``text_to_tokens(chunk)`` and pads with
SOT/EOT itself (reference src/tts_streaming.py:463-465, 477-478).

Here: if a ``tokenizer.json`` exists in the model directory, ``BPEFile``
reads it in pure Python (no `tokenizers` package): the ``BPE`` model with its
vocabulary, ranked merges (as "a b" strings or pairs) and ``unk_token``
(unknown characters unfused), the ``added_tokens`` split out
before pre-tokenization (``[SPACE]``, ``[STOP]``, ``[UNK]``) and the
``Whitespace`` pre-tokenizer; that is what ``scripts/train_tokenizer.py``
writes and what the reference consumes. A file that uses any other
component raises ``ValueError`` naming it. Without a file, a deterministic
character-level scheme maps text into the same id space so the pipeline
runs without the pretrained artifact (random-weight/dev mode).
"""
from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, List, Optional

import numpy as np

# Unicode White_Space (what \s matches in the `regex` crate HF uses)
_WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))


def _is_word(ch: str) -> bool:
    """\\w of the `regex` crate: Alphabetic, marks, decimal digits, connector
    punctuation and the join controls."""
    cat = unicodedata.category(ch)
    return cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or ch in "\u200c\u200d"


def _whitespace_split(text: str) -> List[str]:
    """The ``Whitespace`` pre-tokenizer: the matches of ``\\w+|[^\\w\\s]+``."""
    out: List[str] = []
    cur, cur_word = "", False
    for ch in text:
        if ch in _WHITE_SPACE:
            if cur:
                out.append(cur)
            cur = ""
            continue
        w = _is_word(ch)
        if cur and w != cur_word:
            out.append(cur)
            cur = ""
        cur += ch
        cur_word = w
    if cur:
        out.append(cur)
    return out


class BPEFile:
    """A HF ``tokenizer.json`` with a BPE model, read without `tokenizers`;
    ``encode(text)`` gives the ids ``Tokenizer.encode(text).ids`` gives."""

    def __init__(self, path: str):
        with open(path, "r", encoding="utf-8") as fh:
            spec = json.load(fh)
        model = spec.get("model") or {}
        for component, value, ok in (
                ("model", model.get("type"), ("BPE",)),
                ("normalizer", spec.get("normalizer"), (None,)),
                ("pre_tokenizer", (spec.get("pre_tokenizer") or {}).get("type"), ("Whitespace",)),
                ("post_processor", spec.get("post_processor"), (None,)),
                ("model.dropout", model.get("dropout"), (None, 0, 0.0)),
                ("model.continuing_subword_prefix", model.get("continuing_subword_prefix"),
                 (None, "")),
                ("model.end_of_word_suffix", model.get("end_of_word_suffix"), (None, "")),
                ("model.byte_fallback", model.get("byte_fallback", False), (False,)),
                ("model.fuse_unk", model.get("fuse_unk", False), (False,)),
                ("model.ignore_merges", model.get("ignore_merges", False), (False,))):
            if value not in ok:
                raise ValueError(f"{path}: unsupported tokenizer {component}: {value!r}")
        self.vocab: Dict[str, int] = model["vocab"]
        self.unk_id = self.vocab.get(model.get("unk_token"))
        if self.unk_id is None:
            raise ValueError(f"{path}: the model's unk_token {model.get('unk_token')!r} is not "
                             "in its vocabulary")
        # (left id, right id) → (rank, merged id)
        self.merges: Dict[tuple, tuple] = {}
        for rank, m in enumerate(model.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self.added: Dict[str, int] = {}
        for tok in spec.get("added_tokens", []):
            for opt in ("single_word", "lstrip", "rstrip"):
                if tok.get(opt):
                    raise ValueError(f"{path}: unsupported added_tokens option {opt} "
                                     f"on {tok['content']!r}")
            self.added[tok["content"]] = tok["id"]
        # leftmost-longest match over the added tokens
        self._added_re = (re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added else None)

    def _word(self, word: str) -> List[int]:
        """BPE over one pre-tokenized word: its characters (each unknown one
        → the unk id), then the lowest-ranked adjacent pair merged first,
        the leftmost of equal ranks."""
        ids = [self.vocab.get(ch, self.unk_id) for ch in word]
        while len(ids) > 1:
            best = None
            for p in range(len(ids) - 1):
                m = self.merges.get((ids[p], ids[p + 1]))
                if m is not None and (best is None or m[0] < best[0]):
                    best = (m[0], p, m[1])
            if best is None:
                break
            _, p, new = best
            ids[p: p + 2] = [new]
        return ids

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        pos = 0
        pieces = []
        if self._added_re is not None:
            for m in self._added_re.finditer(text):
                pieces.append((text[pos: m.start()], None))
                pieces.append((None, self.added[m.group()]))
                pos = m.end()
        pieces.append((text[pos:], None))
        for segment, added_id in pieces:
            if added_id is not None:
                out.append(added_id)
                continue
            for word in _whitespace_split(segment):
                out.extend(self._word(word))
        return out


class TextTokenizer:
    SPACE_ID = 1  # fallback mapping reserves 0 (=EOT/stop_text_token) and specials

    def __init__(self, tokenizer_file: Optional[str] = None, vocab_size: int = 704):
        self.vocab_size = vocab_size
        self._tok: Optional[BPEFile] = None
        if tokenizer_file and os.path.isfile(tokenizer_file):
            self._tok = BPEFile(tokenizer_file)

    @property
    def is_pretrained(self) -> bool:
        return self._tok is not None

    def text_to_tokens(self, text: str) -> np.ndarray:
        """→ int32 array [1, T] (no SOT/EOT — the caller pads, like the
        reference does)."""
        if self._tok is not None:
            # match the reference preprocessing: lowercase + space→special
            ids = self._tok.encode(text.lower().replace(" ", "[SPACE]"))
            return np.asarray([ids], dtype=np.int32)
        return np.asarray([self._fallback_encode(text)], dtype=np.int32)

    def _fallback_encode(self, text: str) -> List[int]:
        """Deterministic char-level scheme inside the 704-id space:
        ids 2..(vocab-2) from a stable hash of the character; id 1 for space.
        Avoids 0 (stop_text_token) and 255 (start_text_token)."""
        out: List[int] = []
        lo, hi = 2, self.vocab_size - 2
        for ch in text.lower():
            if ch.isspace():
                out.append(self.SPACE_ID)
                continue
            code = (ord(ch) * 2654435761) % (hi - lo)
            tok = lo + code
            if tok == 255:  # start_text_token collision
                tok += 1
            out.append(tok)
        return out or [self.SPACE_ID]
