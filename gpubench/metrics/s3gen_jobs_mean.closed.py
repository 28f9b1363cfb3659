"""s3gen_jobs_mean.closed: see ``gpubench.layers.s3gen_jobs_mean``."""
from gpubench.layers import s3gen_jobs_mean as read  # noqa: F401
