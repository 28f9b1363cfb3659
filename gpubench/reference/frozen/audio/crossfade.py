"""Equal-power crossfade stitching for streamed audio slices.

Reproduces the chunk-seam behavior of the reference streaming pipeline
(reference src/tts_streaming.py:866-874 fade curves, :709-758 hold-back
crossfade logic): the last ``fade_len`` samples of every emitted chunk are held
back and mixed with the head of the next chunk using cos/sin equal-power
curves, so seams between synthesis slices are click-free. Extracted into a
standalone, fully-testable state machine operating on numpy arrays (audio
chunks are ≤ a few seconds, so this is host-side work).

A copy of ``chatterbox_tpu.audio.crossfade`` with the numpy mix only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np



def equal_power_curves(fade_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """(fade_out, fade_in) = (cos, sin) quarter-wave envelopes of length fade_len."""
    t = np.linspace(0.0, 1.0, fade_len, dtype=np.float32)
    return np.cos(t * np.pi / 2).astype(np.float32), np.sin(t * np.pi / 2).astype(np.float32)


def trim_leading(audio: np.ndarray, milliseconds: int, sample_rate: int) -> np.ndarray:
    n = (milliseconds * sample_rate) // 1000
    if n > 0 and audio.shape[0] > n:
        return audio[n:]
    return audio


def trim_trailing(audio: np.ndarray, milliseconds: int, sample_rate: int) -> np.ndarray:
    n = (milliseconds * sample_rate) // 1000
    if n > 0 and audio.shape[0] > n:
        return audio[:-n]
    return audio


class CrossfadeStitcher:
    """Streaming crossfade between successive audio chunks.

    Usage: call ``push(chunk)`` per synthesized slice; it returns the audio
    safe to emit now (possibly empty). Call ``flush()`` once at end-of-stream
    to release the held tail.
    """

    def __init__(self, fade_len: int):
        self.fade_len = int(fade_len)
        if self.fade_len > 0:
            self.fade_out, self.fade_in = equal_power_curves(self.fade_len)
        else:
            self.fade_out = self.fade_in = None
        self._held: Optional[np.ndarray] = None
        self._started = False

    def push(self, chunk: np.ndarray) -> np.ndarray:
        """Emit the audio that is safe to send; hold back up to fade_len
        samples for the next seam. Sample-conserving: every input sample is
        emitted exactly once (the reference's fallback paths drop the new
        chunk's body and double-play the overlap of short chunks — both
        deliberately fixed here, tts_streaming.py:735-746)."""
        chunk = np.asarray(chunk, dtype=np.float32)
        fl = self.fade_len

        if not self._started:
            self._started = True
            if fl > 0 and chunk.shape[0] > fl:
                self._held = chunk[-fl:]
                return chunk[:-fl]
            self._held = chunk if chunk.size else None
            return np.empty(0, np.float32)

        can_fade = (
            fl > 0
            and self._held is not None
            and self._held.shape[0] == fl
            and chunk.shape[0] > fl
        )
        if can_fade:
            mixed = self._held * self.fade_out + chunk[:fl] * self.fade_in
            # hold at most fade_len of the *unconsumed* samples — never
            # samples already mixed (short chunks would be double-played)
            hold = min(fl, chunk.shape[0] - fl)
            body = chunk[fl : chunk.shape[0] - hold]
            self._held = chunk[chunk.shape[0] - hold :] if hold > 0 else None
            return np.concatenate([mixed, body])

        # No fade possible (held tail shorter than fade_len): emit held + the
        # chunk body unfaded, hold the new tail.
        held = self._held if self._held is not None else np.empty(0, np.float32)
        if fl > 0 and chunk.shape[0] > fl:
            self._held = chunk[-fl:]
            return np.concatenate([held, chunk[:-fl]])
        self._held = chunk if chunk.size else None
        return held

    def flush(self) -> np.ndarray:
        """Release the held tail at end-of-stream."""
        out = self._held if self._held is not None else np.empty(0, np.float32)
        self._held = None
        return out
