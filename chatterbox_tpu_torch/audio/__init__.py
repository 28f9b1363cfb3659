from .crossfade import CrossfadeStitcher, equal_power_curves, trim_leading, trim_trailing
from .encoding import AudioEncoder, AudioFormat
from .pcm import float_to_pcm16, make_wav_header, pcm16_to_float, read_wav, resample, write_wav
from .quality import log_spectral_distance, mel_cepstral_distortion

__all__ = [
    "AudioEncoder",
    "AudioFormat",
    "CrossfadeStitcher",
    "equal_power_curves",
    "float_to_pcm16",
    "log_spectral_distance",
    "make_wav_header",
    "mel_cepstral_distortion",
    "pcm16_to_float",
    "read_wav",
    "resample",
    "trim_leading",
    "trim_trailing",
    "write_wav",
]
