"""Configs for the checkpoint-compatible S3Gen stack.

This package mirrors, tensor-for-tensor, the token-to-waveform model family
the reference serves from ``s3gen.safetensors``
(reference src/tts_streaming.py:365-372, 583-590, 681-688;
reference scripts/download_models.py:8-17). The architectures are the
publicly known CosyVoice2-lineage components (SURVEY.md §2b rows 3-4):

* S3TokenizerV2 — whisper-style audio encoder + FSQ quantizer, 25 Hz, 3^8 codes
* CAMPPlus — x-vector speaker encoder over kaldi fbanks
* CausalMaskedDiffWithXvec — upsample-conformer encoder + matcha-style
  conditional-flow-matching mel decoder
* HiFTGenerator — NSF source-filter vocoder with an ISTFT head

Default field values follow the published model family's configurations; the
pretrained artifact is unavailable in this offline build environment, so they
are validated structurally (tests/test_s3gen_ref_convert.py synthesises the
exact key schema and requires a clean conversion). Anything that only the real
artifact can confirm (e.g. the tokenizer's layer count) is a config field, so
a mismatch surfaces as a strict conversion report, not silence.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class S3TokRefConfig:
    """S3TokenizerV2 (speech_tokenizer_v2_25hz): whisper-mel → 2× stride-2
    convs → transformer → FSQ with 3^8 codes, 25 tokens/s."""

    n_mels: int = 128          # whisper log-mel bins (fixed by the front-end)
    n_state: int = 1280
    n_head: int = 20
    n_layer: int = 6
    n_audio_ctx: int = 1500    # positional-embedding table length (frames @25 Hz)
    fsq_dim: int = 8           # FSQ dimensions
    fsq_levels: int = 3        # quantization levels per dimension (3^8 = 6561)

    @staticmethod
    def tiny() -> "S3TokRefConfig":
        return S3TokRefConfig(n_state=32, n_head=2, n_layer=1, n_audio_ctx=64)


@dataclasses.dataclass(frozen=True)
class CampPlusConfig:
    """CAMPPlus x-vector: FCM conv head + CAM-dense TDNN trunk."""

    feat_dim: int = 80         # kaldi fbank bins (fixed by the front-end)
    embedding_size: int = 192
    m_channels: int = 32       # FCM width
    init_channels: int = 128   # TDNN head width
    growth_rate: int = 32
    bn_size: int = 4
    num_layers: Tuple[int, ...] = (12, 24, 16)
    kernel_sizes: Tuple[int, ...] = (3, 3, 3)
    dilations: Tuple[int, ...] = (1, 2, 2)

    @staticmethod
    def tiny() -> "CampPlusConfig":
        return CampPlusConfig(
            m_channels=4, init_channels=8, growth_rate=4, bn_size=2,
            num_layers=(2, 2), kernel_sizes=(3, 3), dilations=(1, 2),
        )


@dataclasses.dataclass(frozen=True)
class FlowRefConfig:
    """Token → mel flow: embedding → UpsampleConformerEncoder (2× up) →
    causal-UNet CFM estimator (matcha layout)."""

    vocab_size: int = 6561
    input_size: int = 512      # conformer width
    output_size: int = 80      # mel bins
    spk_embed_dim: int = 192
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6        # pre-upsample conformer blocks
    num_up_blocks: int = 4     # post-upsample conformer blocks
    up_stride: int = 2         # token → mel frame ratio
    pre_lookahead_len: int = 3
    # CFM estimator (matcha ConditionalDecoder, one down/up level)
    dec_in_channels: int = 320      # x(80) + mu(80) + spk(80) + cond(80)
    dec_time_dim: int = 320         # SinusoidalPosEmb dim (== in_channels)
    dec_channels: Tuple[int, ...] = (256,)
    dec_num_heads: int = 8
    dec_attention_head_dim: int = 64
    dec_n_blocks: int = 4           # transformer blocks per UNet stage
    dec_num_mid_blocks: int = 12
    # solver
    n_timesteps: int = 10
    inference_cfg_rate: float = 0.7
    sigma_min: float = 1e-6
    # Keep encoder/estimator activations in the weights' dtype instead of
    # the f32 the reference computes in (CUDA fp32 — matcha/cosyvoice run
    # unhalved). Deliberate TPU deviation (CHATTERBOX_FLOW_BF16=1, measured
    # by scripts/quality_study.py): with bf16 weights the flow's matmuls
    # then run at the MXU's native bf16 rate and HBM traffic halves.
    # Attention scores, softmax statistics, GroupNorm statistics and the
    # Euler integration state stay f32 regardless (ops/nn.py mixed-precision
    # contract), and the HiFT vocoder input is pinned to f32 at the mel
    # handoff (model.py _mel_and_source).
    bf16_activations: bool = False

    @staticmethod
    def tiny() -> "FlowRefConfig":
        return FlowRefConfig(
            input_size=16, attention_heads=2, linear_units=32, num_blocks=1,
            num_up_blocks=1, dec_time_dim=16, dec_channels=(16,),
            dec_num_heads=2, dec_attention_head_dim=8, dec_n_blocks=1,
            dec_num_mid_blocks=1, n_timesteps=2,
        )


@dataclasses.dataclass(frozen=True)
class HiFTConfig:
    """HiFT vocoder: ConvRNN f0 predictor → harmonic-plus-noise NSF source →
    source-injected upsampling stack with Snake resblocks → 16/4 ISTFT head."""

    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sample_rate: int = 24000
    nsf_alpha: float = 0.1       # sine amplitude
    nsf_sigma: float = 0.003     # additive noise std (voiced)
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    f0_cond_channels: int = 512
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99

    @staticmethod
    def tiny() -> "HiFTConfig":
        return HiFTConfig(
            base_channels=8, nb_harmonics=2,
            upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
            source_resblock_kernel_sizes=(3, 3),
            source_resblock_dilation_sizes=((1,), (1,)),
            f0_cond_channels=8,
        )


@dataclasses.dataclass(frozen=True)
class S3GenRefConfig:
    tokenizer: S3TokRefConfig = dataclasses.field(default_factory=S3TokRefConfig)
    speaker: CampPlusConfig = dataclasses.field(default_factory=CampPlusConfig)
    flow: FlowRefConfig = dataclasses.field(default_factory=FlowRefConfig)
    hift: HiFTConfig = dataclasses.field(default_factory=HiFTConfig)
    # static prompt windows (reference: 10 s of 24 kHz ref audio → 250 tokens
    # @25 Hz / 500 mel frames @50 Hz — tts_streaming.py:365-372)
    max_prompt_tokens: int = 250
    max_prompt_mel: int = 500
    sample_rate: int = 24000
    token_rate: int = 25

    @property
    def samples_per_token(self) -> int:
        r = 1
        for u in self.hift.upsample_rates:
            r *= u
        return self.flow.up_stride * r * self.hift.istft_hop

    @property
    def n_mels(self) -> int:
        return self.flow.output_size

    @property
    def vocab_size(self) -> int:
        return self.flow.vocab_size

    @property
    def spk_dim(self) -> int:
        return self.speaker.embedding_size

    @staticmethod
    def tiny() -> "S3GenRefConfig":
        return S3GenRefConfig(
            tokenizer=S3TokRefConfig.tiny(),
            speaker=CampPlusConfig.tiny(),
            flow=FlowRefConfig.tiny(),
            hift=HiFTConfig.tiny(),
            max_prompt_tokens=8,
            max_prompt_mel=16,
        )
