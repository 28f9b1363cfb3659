"""t3_step_ms.closed: see ``gpubench.layers.t3_step_ms``."""
from gpubench.layers import t3_step_ms as read  # noqa: F401
