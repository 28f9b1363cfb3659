"""mfu.open: see ``gpubench.layers.mfu``."""
from gpubench.layers import mfu as read  # noqa: F401
