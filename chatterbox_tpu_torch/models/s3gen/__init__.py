"""The DiT S3Gen stack (``s3gen_arch="dit"``): the token encoder, the DiT
flow, the x-vector and the HiFT-style vocoder."""
from .config import S3GenConfig  # noqa: F401
from .model import (  # noqa: F401
    draw_noise,
    s3gen_embed_ref,
    s3gen_inference,
    s3gen_mel_and_source,
    s3gen_param_tree,
)
