"""Host-side PCM utilities: float → PCM16 and the streaming WAV header.

Same byte contracts as ``chatterbox_tpu.audio.pcm`` (numpy only)."""
from __future__ import annotations

import struct

import numpy as np


def float_to_pcm16(audio: np.ndarray) -> bytes:
    """Clamp a float waveform to [-1, 1] → little-endian int16 bytes."""
    clipped = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    return (clipped * 32767.0).astype("<i2").tobytes()


def make_wav_header(
    sample_rate: int,
    channels: int = 1,
    bit_depth: int = 16,
    data_size: int = 0xFFFFFFFF,
) -> bytes:
    """RIFF/WAVE header; data_size=0xFFFFFFFF signals an unbounded stream."""
    byte_rate = sample_rate * channels * bit_depth // 8
    block_align = channels * bit_depth // 8
    riff_size = data_size + 36 if data_size != 0xFFFFFFFF else 0xFFFFFFFF
    header = struct.pack("<4sL4s", b"RIFF", riff_size, b"WAVE")
    header += struct.pack(
        "<4sLHHLLHH", b"fmt ", 16, 1, channels, sample_rate, byte_rate, block_align, bit_depth
    )
    header += struct.pack("<4sL", b"data", data_size)
    return header
