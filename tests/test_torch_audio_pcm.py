"""The port's WAV IO and resampling against the JAX package's
(``chatterbox_tpu.audio.pcm``): ``read_wav`` on 8, 16, 24 and 32-bit PCM,
float32/64, stereo and WAVE_FORMAT_EXTENSIBLE files; ``write_wav`` round
trips; ``resample`` is ``scipy.signal.resample_poly``.
"""
import struct

import numpy as np
import pytest
from scipy.signal import resample_poly

from chatterbox_tpu.audio import pcm as jpcm
from chatterbox_tpu_torch.audio import pcm as tpcm


def _riff(fmt_code: int, channels: int, sr: int, bits: int, data: bytes,
          extensible: bool = False) -> bytes:
    """A RIFF/WAVE file with a LIST chunk of odd size before its data (word
    alignment), in the plain or the extensible fmt layout."""
    block = channels * bits // 8
    fmt = struct.pack("<HHLLHH", 0xFFFE if extensible else fmt_code, channels, sr, sr * block,
                      block, bits)
    if extensible:
        fmt += struct.pack("<HHL", 22, bits, 0) + struct.pack("<H", fmt_code) + b"\x00" * 14
    body = b"WAVE" + b"fmt " + struct.pack("<L", len(fmt)) + fmt
    body += b"LIST" + struct.pack("<L", 3) + b"abc\x00"
    body += b"data" + struct.pack("<L", len(data)) + data
    return b"RIFF" + struct.pack("<L", len(body)) + body


def _encode(x: np.ndarray, kind: str) -> tuple:
    """float samples in [-1, 1) → (fmt code, bits, bytes)."""
    if kind == "pcm8":
        return 1, 8, np.clip(np.round(x * 128 + 128), 0, 255).astype(np.uint8).tobytes()
    if kind == "pcm16":
        return 1, 16, np.round(x * 32767).astype("<i2").tobytes()
    if kind == "pcm24":
        v = np.round(x * (2 ** 23 - 1)).astype(np.int32)
        b = np.stack([(v >> s) & 0xFF for s in (0, 8, 16)], axis=-1).astype(np.uint8)
        return 1, 24, b.tobytes()
    if kind == "pcm32":
        return 1, 32, np.round(x * (2 ** 31 - 1)).astype("<i4").tobytes()
    if kind == "float32":
        return 3, 32, x.astype("<f4").tobytes()
    return 3, 64, x.astype("<f8").tobytes()


KINDS = ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64"]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_read_wav_matches_jax(tmp_path, kind, channels):
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.99, 0.99, 3001 * channels)
    code, bits, data = _encode(x, kind)
    path = tmp_path / f"{kind}.wav"
    path.write_bytes(_riff(code, channels, 22050, bits, data, extensible=(kind == "pcm24")))
    got, sr = tpcm.read_wav(str(path))
    want, jsr = jpcm.read_wav(str(path))
    assert sr == jsr == 22050
    assert got.dtype == np.float32 and got.shape == (3001,)
    np.testing.assert_array_equal(got, want)
    mono = x.reshape(-1, channels).mean(axis=1)
    # one quantisation step, or float32's own resolution near 1
    step = max(2.0 ** (1 - bits), 2.0 ** -23) if code == 1 else 2.0 ** -23
    np.testing.assert_allclose(got, mono, atol=2 * step)


def test_write_wav_round_trip(tmp_path):
    """The port writes a 16-bit mono file that both readers decode to the
    samples, and the streaming header's fields for a known size."""
    x = np.sin(np.linspace(0, 40, 4800)).astype(np.float32) * 0.8
    path = tmp_path / "out.wav"
    tpcm.write_wav(str(path), x, 24000)
    blob = path.read_bytes()
    assert blob[:44] == tpcm.make_wav_header(24000, data_size=2 * 4800)
    got, sr = tpcm.read_wav(str(path))
    want, _ = jpcm.read_wav(str(path))
    assert sr == 24000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, x, atol=2.0 / 32768)
    np.testing.assert_array_equal(tpcm.pcm16_to_float(blob[44:]), jpcm.pcm16_to_float(blob[44:]))


@pytest.mark.parametrize("blob, match", [(b"RIFX\x00\x00\x00\x00WAVE", "not a RIFF"),
                                         (_riff(1, 1, 16000, 12, b"\x00" * 6), "bit depth"),
                                         (_riff(2, 1, 16000, 16, b"\x00" * 6), "format code")])
def test_read_wav_rejects(tmp_path, blob, match):
    path = tmp_path / "bad.wav"
    path.write_bytes(blob)
    with pytest.raises(ValueError, match=match):
        tpcm.read_wav(str(path))
    with pytest.raises(ValueError):
        jpcm.read_wav(str(path))


@pytest.mark.parametrize("rates", [(24000, 16000), (16000, 24000), (44100, 16000),
                                   (22050, 24000), (16000, 16000)])
def test_resample_is_resample_poly(rates):
    orig, target = rates
    x = np.random.default_rng(1).standard_normal(orig // 3).astype(np.float32)
    got = tpcm.resample(x, orig, target)
    g = np.gcd(orig, target)
    want = resample_poly(x.astype(np.float64), target // g, orig // g).astype(np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
