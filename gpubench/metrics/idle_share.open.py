"""idle_share.open: see ``gpubench.layers.idle_share``."""
from gpubench.layers import idle_share as read  # noqa: F401
