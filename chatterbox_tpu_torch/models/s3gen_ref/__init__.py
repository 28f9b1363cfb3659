"""Checkpoint-compatible S3Gen stack (reference architecture): the uncached,
prompt-cached and streaming paths, and the voice embedding (``embed_ref``)."""
from .config import FlowRefConfig, HiFTConfig, S3GenRefConfig  # noqa: F401
from .model import (  # noqa: F401
    draw_noise,
    init_s3gen_ref_params,
    init_s3gen_stream_state,
    s3gen_ref_embed_ref,
    s3gen_ref_flow,
    s3gen_ref_flow_streaming,
    s3gen_ref_inference,
    s3gen_ref_inference_streaming,
    s3gen_ref_inference_tail,
    s3gen_ref_prompt_prefill,
    split_stream_state,
    stack_stream_states,
)
