"""T3 configuration.

T3 is the autoregressive text→speech-token decoder: a llama-style transformer
whose input sequence packs [voice conditioning | text tokens | speech tokens]
and which emits 25 speech tokens per second of audio from a 6561-entry
codebook. Hyperparameter surface follows the reference model as consumed by
the serving stack (reference src/tts_streaming.py:283, 369, 423, 477 —
start/stop text tokens, speech_cond_prompt_len, 1000-token cap) and the
publicly known Chatterbox checkpoint shapes (SURVEY.md §2b: ~0.5B llama
backbone, speech vocab 6561 + specials).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class T3Config:
    # Vocabularies / special tokens
    text_vocab_size: int = 704
    speech_vocab_size: int = 8194
    start_text_token: int = 255
    stop_text_token: int = 0
    start_speech_token: int = 6561
    stop_speech_token: int = 6562
    num_speech_codes: int = 6561  # valid codebook entries (< this are real codes)

    # Conditioning
    speaker_embed_dim: int = 256
    speech_cond_prompt_len: int = 150
    use_perceiver_resampler: bool = True
    perceiver_latents: int = 32
    perceiver_heads: int = 4

    # Backbone (Llama-style, ~520M at defaults)
    hidden_size: int = 1024
    num_layers: int = 30
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: int = 64
    intermediate_size: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5

    # KV cache storage: "native" (params dtype) or "int8" (per-token-per-head
    # symmetric quantization — halves decode bandwidth, the dominant cost of
    # batched decode, at ~1% attention error)
    kv_cache_dtype: str = "native"

    # KV cache layout: "seq" ([L, B, S, Hk, Dh], XLA grouped attention) or
    # "paired" ([L, B, Hk//2, S, 2*Dh], head-paired Pallas kernel whose grid
    # bounds reads to the filled prefix — ops/pallas_attention_v3.py).
    # paired+int8 composes both: int8 paired cache + seq-last scale planes
    # ([L, B, Hp, 2, S]) with in-kernel scale-factored dequant.
    kv_cache_layout: str = "seq"

    def __post_init__(self):
        if self.kv_cache_layout == "paired" and self.num_kv_heads % 2:
            raise ValueError(
                "kv_cache_layout='paired' needs an even num_kv_heads "
                f"(got {self.num_kv_heads})"
            )

    # Sequence budget. 160 covers a 150-char chunk even with the 1-token-per-
    # char fallback tokenizer (BPE needs ~60); +SOT/EOT.
    max_text_tokens: int = 160
    max_speech_tokens: int = 1024  # ≥ reference's 1000-token decode cap
    learned_pos_emb: bool = True

    @property
    def cond_len(self) -> int:
        prompt = self.perceiver_latents if self.use_perceiver_resampler else self.speech_cond_prompt_len
        return 1 + prompt + 1  # [speaker] + prompt + [emotion]

    @property
    def max_seq_len(self) -> int:
        # rounded up to the Pallas attention block (256) so the batched cache
        # needs no padding copies for grid-bounded kernel reads
        raw = self.cond_len + self.max_text_tokens + 1 + self.max_speech_tokens
        return ((raw + 255) // 256) * 256

    @staticmethod
    def tiny() -> "T3Config":
        """Small config for CPU tests: same token semantics, tiny backbone."""
        return T3Config(
            hidden_size=64,
            speaker_embed_dim=32,  # matches VoiceEncoderConfig.tiny().embed_dim
            num_layers=2,
            num_heads=4,
            num_kv_heads=4,
            head_dim=16,
            intermediate_size=128,
            speech_cond_prompt_len=6,
            perceiver_latents=4,
            perceiver_heads=2,
            max_text_tokens=32,
            max_speech_tokens=64,
        )

    def with_(self, **kw) -> "T3Config":
        return replace(self, **kw)
