from .config import T3Config
from .model import (
    cond_embeddings,
    init_t3_params,
    make_decode_state,
    t3_decode_slice,
    t3_prefill,
)

__all__ = [
    "T3Config",
    "cond_embeddings",
    "init_t3_params",
    "make_decode_state",
    "t3_decode_slice",
    "t3_prefill",
]
