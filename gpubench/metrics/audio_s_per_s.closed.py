"""audio_s_per_s.closed: see ``gpubench.layers.audio_s_per_s``."""
from gpubench.layers import audio_s_per_s as read  # noqa: F401
