"""k1_roofline.closed: see ``gpubench.layers.k1_roofline``."""
from gpubench.layers import k1_roofline as read  # noqa: F401
