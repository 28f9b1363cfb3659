from .nn import NEG_INF, apply_rope, causal_attention, layer_norm, linear, rms_norm, rope_frequencies, swiglu
from .sampling import apply_repetition_penalty, sample_token, top_p_filter

__all__ = [
    "NEG_INF",
    "apply_repetition_penalty",
    "apply_rope",
    "causal_attention",
    "layer_norm",
    "linear",
    "rms_norm",
    "rope_frequencies",
    "sample_token",
    "swiglu",
    "top_p_filter",
]
