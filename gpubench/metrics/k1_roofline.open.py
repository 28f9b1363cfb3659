"""k1_roofline.open: see ``gpubench.layers.k1_roofline``."""
from gpubench.layers import k1_roofline as read  # noqa: F401
