"""Text tokenizer (EnTokenizer equivalent; a copy of
``chatterbox_tpu.models.tokenizer``).

The reference's ``EnTokenizer`` wraps a HF `tokenizers` BPE with a ~704-token
vocabulary; the serving stack calls ``text_to_tokens(chunk)`` and pads with
SOT/EOT itself (reference src/tts_streaming.py:463-465, 477-478).

Here: if a ``tokenizer.json`` exists in the model directory it is loaded with
the `tokenizers` library (checkpoint-compatible path); otherwise a
deterministic character-level fallback maps text into the same id space so
the full pipeline runs without the pretrained artifact (random-weight/dev
mode).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


class TextTokenizer:
    SPACE_ID = 1  # fallback mapping reserves 0 (=EOT/stop_text_token) and specials

    def __init__(self, tokenizer_file: Optional[str] = None, vocab_size: int = 704):
        self.vocab_size = vocab_size
        self._tok = None
        if tokenizer_file and os.path.isfile(tokenizer_file):
            from tokenizers import Tokenizer

            self._tok = Tokenizer.from_file(tokenizer_file)

    @property
    def is_pretrained(self) -> bool:
        return self._tok is not None

    def text_to_tokens(self, text: str) -> np.ndarray:
        """→ int32 array [1, T] (no SOT/EOT — the caller pads, like the
        reference does)."""
        if self._tok is not None:
            # match the reference preprocessing: lowercase + space→special
            ids = self._tok.encode(text.lower().replace(" ", "[SPACE]")).ids
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
