"""Host-side PCM utilities: float ↔ PCM16, the WAV header, WAV IO and
resampling.

Same byte contracts as ``chatterbox_tpu.audio.pcm`` (numpy only; resampling
is scipy's polyphase filter, the JAX package's own fallback)."""
from __future__ import annotations

import struct
from math import gcd
from typing import Tuple

import numpy as np


def float_to_pcm16(audio: np.ndarray) -> bytes:
    """Clamp a float waveform to [-1, 1] → little-endian int16 bytes."""
    clipped = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    return (clipped * 32767.0).astype("<i2").tobytes()


def pcm16_to_float(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0


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


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """A mono 16-bit PCM WAV file."""
    data = float_to_pcm16(audio)
    with open(path, "wb") as fh:
        fh.write(make_wav_header(sample_rate, data_size=len(data)))
        fh.write(data)


def _decode_pcm(path: str, data: bytes, bits: int) -> np.ndarray:
    if bits == 16:
        return np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    if bits == 8:
        return (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    if bits == 32:
        return np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    if bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8)
        raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3).astype(np.int32)
        vals = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        return vals.astype(np.float32) / float(1 << 23)
    raise ValueError(f"{path}: unsupported PCM bit depth {bits}")


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """A RIFF/WAVE file → (mono float32 samples in [-1, 1], sample rate).

    PCM 8/16/24/32-bit and IEEE float32/64, WAVE_FORMAT_EXTENSIBLE included;
    several channels are averaged."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if len(blob) < 12 or blob[0:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, fmt_body, data = 12, None, b"", None
    while pos + 8 <= len(blob):
        cid, csize = struct.unpack_from("<4sL", blob, pos)
        body = blob[pos + 8: pos + 8 + csize]
        if cid == b"fmt ":
            fmt, fmt_body = struct.unpack_from("<HHLLHH", body, 0), body
        elif cid == b"data":
            data = body
        pos += 8 + csize + (csize & 1)  # chunks are word-aligned
        if fmt is not None and data is not None:
            break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the format code opens the SubFormat GUID
        # at offset 24 of the fmt chunk
        if len(fmt_body) < 26:
            raise ValueError(f"{path}: malformed WAVE_FORMAT_EXTENSIBLE fmt chunk")
        audio_format = struct.unpack_from("<H", fmt_body, 24)[0]
    if audio_format == 1:
        x = _decode_pcm(path, data, bits)
    elif audio_format == 3:
        x = np.frombuffer(data, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), int(sample_rate)


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Band-limited polyphase resampling (``scipy.signal.resample_poly``),
    e.g. 24 kHz → 16 kHz for voice conditioning."""
    if orig_sr == target_sr:
        return np.asarray(audio, dtype=np.float32)
    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    out = resample_poly(np.asarray(audio, dtype=np.float64), target_sr // g, orig_sr // g)
    return np.ascontiguousarray(out, dtype=np.float32)
