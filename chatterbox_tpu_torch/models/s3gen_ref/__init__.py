"""Checkpoint-compatible S3Gen stack (reference architecture), uncached path."""
from .config import FlowRefConfig, HiFTConfig, S3GenRefConfig  # noqa: F401
from .model import (  # noqa: F401
    draw_noise,
    init_s3gen_ref_params,
    s3gen_ref_inference,
    s3gen_ref_inference_tail,
)
