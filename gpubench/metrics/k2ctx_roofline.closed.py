"""k2ctx_roofline.closed: see ``gpubench.layers.k2ctx_roofline``."""
from gpubench.layers import k2ctx_roofline as read  # noqa: F401
