"""t3_step_ms.open: see ``gpubench.layers.t3_step_ms``."""
from gpubench.layers import t3_step_ms as read  # noqa: F401
