"""s3gen_call_ms.closed: see ``gpubench.layers.s3gen_call_ms``."""
from gpubench.layers import s3gen_call_ms as read  # noqa: F401
