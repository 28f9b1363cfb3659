"""t3_slots_mean.closed: see ``gpubench.layers.t3_slots_mean``."""
from gpubench.layers import t3_slots_mean as read  # noqa: F401
