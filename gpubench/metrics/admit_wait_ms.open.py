"""admit_wait_ms.open: see ``gpubench.layers.admit_wait_ms``."""
from gpubench.layers import admit_wait_ms as read  # noqa: F401
