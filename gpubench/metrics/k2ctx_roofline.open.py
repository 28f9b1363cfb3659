"""k2ctx_roofline.open: see ``gpubench.layers.k2ctx_roofline``."""
from gpubench.layers import k2ctx_roofline as read  # noqa: F401
