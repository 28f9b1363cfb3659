"""ttfa_p50_ms.closed: see ``gpubench.layers.ttfa_p50_ms``."""
from gpubench.layers import ttfa_p50_ms as read  # noqa: F401
