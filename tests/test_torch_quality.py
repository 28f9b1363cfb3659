"""The port's MCD / LSD (``chatterbox_tpu_torch.audio.quality``): the cases
of tests/test_quality_metrics.py against the port's copy, and equality with
the JAX package's functions on seeded signals."""
import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (caps torch's threads)

from chatterbox_tpu.audio import quality as jquality
from chatterbox_tpu_torch.audio import log_spectral_distance, mel_cepstral_distortion


def _tone(freq, sr=24000, secs=1.0, amp=0.5):
    t = np.arange(int(sr * secs)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def test_mcd_zero_for_identical():
    x = _tone(220)
    assert mel_cepstral_distortion(x, x, 24000) < 1e-6


def test_mcd_orders_similarity():
    x = _tone(220)
    d_near = mel_cepstral_distortion(x, _tone(233), 24000)   # ~1 semitone away
    d_far = mel_cepstral_distortion(x, _tone(1200), 24000)
    assert 0 < d_near < d_far


def test_lsd_monotone_with_noise():
    rng = np.random.default_rng(0)
    x = _tone(300)
    a = x + 0.01 * rng.standard_normal(len(x)).astype(np.float32)
    b = x + 0.2 * rng.standard_normal(len(x)).astype(np.float32)
    assert log_spectral_distance(x, a, 24000) < log_spectral_distance(x, b, 24000)


def test_mcd_handles_length_mismatch():
    x = _tone(220, secs=1.0)
    y = _tone(220, secs=0.8)
    assert np.isfinite(mel_cepstral_distortion(x, y, 24000))


def test_empty_signal_is_infinitely_far():
    assert mel_cepstral_distortion(np.zeros(0, np.float32), _tone(220), 24000) == float("inf")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sr", [16000, 24000])
def test_equals_jax_package(seed, sr):
    """Both functions equal the JAX package's to float64 rounding, on
    seeded noisy chirps of unequal lengths."""
    rng = np.random.default_rng(seed)
    n = int(sr * rng.uniform(0.4, 1.2))
    t = np.arange(n) / sr
    ref = (0.4 * np.sin(2 * np.pi * (150 + 400 * t) * t) + 0.05 * rng.standard_normal(n))
    hyp = ref + 0.1 * rng.standard_normal(n)
    hyp = hyp[: n - int(rng.integers(1, sr // 10))].astype(np.float32)
    ref = ref.astype(np.float32)
    got = (mel_cepstral_distortion(ref, hyp, sr), log_spectral_distance(ref, hyp, sr))
    want = (jquality.mel_cepstral_distortion(ref, hyp, sr),
            jquality.log_spectral_distance(ref, hyp, sr))
    assert all(np.isfinite(got)) and min(got) > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
