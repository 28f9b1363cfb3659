"""TTSEngine: the streaming synthesis pipeline (torch counterpart of
``chatterbox_tpu/runtime/engine.py``).

Same contract: ``ainit`` / ``stream`` / ``prepare_conditionals`` /
``clear_voice_cache`` / ``shutdown``. ``stream`` chunks the text and runs two
asyncio producers joined by bounded queues: the T3 producer decodes each chunk
(first a short look-ahead group so S3Gen starts sooner); the S3Gen producer
re-synthesises the chunk's accumulated tokens ("full" overlap) or each slice
alone ("zero"), carries the vocoder's excitation cache across slices, then
crossfades, trims and encodes.

Two serving paths, as in the JAX package. With ``MAX_DECODE_SLOTS`` > 1 (the
default, 16) every request decodes in a slot of one ``BatchedT3Decoder`` and
synthesises through one ``S3GenScheduler`` micro-batcher (device-resident
source state, tail-windowed vocoder); with ``MAX_DECODE_SLOTS=1`` each request
prefills its own cache and calls S3Gen itself.

S3Gen serves the JAX package's defaults: the per-voice CFM prompt cache in
"step" mode (``CHATTERBOX_CFM_PROMPT_CACHE``: "step", "static" or "0" for the
uncached re-solve) and, on the batched path with full overlap, streaming CFM
(``CHATTERBOX_CFM_STREAM``, default "1"): each slice solves only its new
tokens against the voice's prompt context and the request's frozen earlier
frames. The per-request path uses the prompt cache without streaming, as in
the JAX package.

Voices, as in the JAX package: a request with no voice id gets the default
voice, read from ``MODEL_PATH/conds.pt`` or, with no usable file, the neutral
voice that ``_cond_fn`` builds from zero waveforms; a voice id names a file
of the voice store (``serve.voice_manager``), cloned at its first request by
``prepare_conditionals`` (S3TokenizerV2, the VoiceEncoder, CAMPPlus and the
mel front ends) and cached under its name.

S3Gen comes in the JAX package's two architectures (``EngineConfig.s3gen_arch``):
"ref", the checkpoint-compatible stack that ``full()`` serves by default, and
"dit", the DiT redesign with its own speech tokenizer (S3Tok), which
``tiny()`` and ``CHATTERBOX_S3GEN_ARCH=dit`` select. As in the JAX engine the
DiT runs without the CFM prompt cache, streaming CFM and the tail-windowed
vocoder, and ignores ``conds.pt`` (its voices are the neutral voice or
clones).

Weights come from ``MODEL_PATH``, as in the JAX engine: a native checkpoint
(``runtime.checkpoint``) first, then the reference safetensors
(``runtime.loader``), else a random init made on the device from a seeded
generator. With ``CHATTERBOX_PROGRESSIVE_SLICES=1`` and streaming CFM,
slices after a chunk's second grow (s → 2s → … ≤ 100 tokens), as in the JAX
engine. The device is explicit: with no CUDA device and no ``device="cpu"``,
construction raises. The engine records the JAX engine's serving metrics
(``runtime.metrics``).

``CHATTERBOX_TP=N`` serves tensor-parallel over ``devices`` (default
``cuda:0`` … ``cuda:N−1``), as the JAX engine does over its first N devices:
this process is rank 0 and runs the engine; N−1 follower processes hold
their shards of T3 and, for the ref arch, of S3Gen-ref's flow, and replay
every sharded call (``runtime/tp_serving.py``). The DiT, S3Tok, cloning and
HiFT run here alone. Every sharded call goes through ``self.calls``, which
is the plain call without tensor parallelism.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import functools
import math
import os
import threading
import time
import zlib
from enum import Enum
from pathlib import Path
from typing import AsyncGenerator, Dict, Literal, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.crossfade import CrossfadeStitcher, trim_leading, trim_trailing
from ..audio.encoding import AudioEncoder
from ..audio.pcm import float_to_pcm16, read_wav, resample
from ..logging_config import log
from ..models.s3gen import S3GenConfig, s3gen_embed_ref, s3gen_inference
from ..models.s3gen import draw_noise as dit_draw_noise
from ..models.s3gen_ref import S3GenRefConfig, draw_noise, s3gen_ref_embed_ref
from ..models.s3gen_ref.decoder import cfm_noise_frames
from ..models.s3gen_ref.features import reflect_tail
from ..models.s3gen_ref.tokenizer import s3tok_ref_tokenize
from ..models.s3tok import S3TokConfig, s3tok_tokenize
from ..models.t3 import T3Config, cond_embeddings
from ..models.tokenizer import TextTokenizer
from ..models.voice_encoder import VoiceEncoderConfig, voice_embed
from ..ops import _build
from ..ops.spectral import log_mel_spectrogram
from ..serve.voice_manager import VoiceManager
from ..parallel.sharding import check_tp
from ..settings import get_settings, get_tts_config
from ..text import split_text_into_chunks
from .cancellation import CancellationToken, race_cancellation
from .loader import load_default_conds, load_params
from .metrics import metrics
from .s3gen_scheduler import MAX_TAIL_TOKENS, S3GenScheduler
from .tp_serving import (FollowerSpec, ShardedCalls, TPGroup, params_to_numpy,
                         shard_engine_params, tp_size)

S3_SR = 16000      # the tokenizer's, the VoiceEncoder's and CAMPPlus's rate
S3GEN_SR = 24000   # the prompt mel's rate
ENC_COND_LEN = 6 * S3_SR        # T3 prompt budget: tokenize at most 6 s
DEC_COND_LEN = 10 * S3GEN_SR    # embed_ref budget: 10 s of 24 kHz audio
DEC16_COND_LEN = 10 * S3_SR     # the same 10 s at 16 kHz
NEUTRAL_VOICE_S = 2             # the neutral voice: 2 s of zeros


class InitializationState(Enum):
    NOT_STARTED = "not_started"
    INITIALIZING = "initializing"
    READY = "ready"
    ERROR = "error"


@dataclasses.dataclass
class Conditionals:
    """Voice conditioning: T3 lanes [2, C, D] (cond, uncond) + the S3Gen ref dict."""

    t3_cond_lanes: torch.Tensor
    gen_ref: Dict


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    t3: T3Config
    s3gen: S3GenConfig = S3GenConfig()
    s3tok: S3TokConfig = S3TokConfig()
    ve: VoiceEncoderConfig = VoiceEncoderConfig()
    text_bucket: int = 16       # pad text token counts to multiples of this
    max_new_tokens: int = 1000  # per-chunk decode cap
    param_dtype: str = "float32"
    # the token-to-waveform architecture: "ref" (the checkpoint-compatible
    # stack, ``s3gen_ref``) or "dit" (the DiT redesign, ``s3gen`` + ``s3tok``)
    s3gen_arch: str = "dit"
    s3gen_ref: Optional[S3GenRefConfig] = None

    @property
    def gen(self):
        """The active token-to-waveform config."""
        return self.s3gen_ref if self.s3gen_arch == "ref" else self.s3gen

    @staticmethod
    def tiny() -> "EngineConfig":
        return EngineConfig(
            t3=T3Config.tiny(),
            s3gen=S3GenConfig.tiny(),
            s3tok=S3TokConfig.tiny(),
            ve=VoiceEncoderConfig.tiny(),
            text_bucket=8,
            max_new_tokens=64,
        )

    @staticmethod
    def tiny_ref() -> "EngineConfig":
        return dataclasses.replace(
            EngineConfig.tiny(), s3gen_arch="ref",
            s3gen_ref=EngineConfig._apply_ref_env_knobs(S3GenRefConfig.tiny()))

    @staticmethod
    def _apply_ref_env_knobs(ref_cfg: S3GenRefConfig) -> S3GenRefConfig:
        """The JAX package's flow knobs, same variables:
        CHATTERBOX_FLOW_PROMPT_TOKENS trims the prompt window,
        CHATTERBOX_CFM_STEPS the Euler step count, CHATTERBOX_FLOW_BF16=1
        keeps encoder/CFM activations in the weights' dtype."""
        ptoks = int(os.environ.get("CHATTERBOX_FLOW_PROMPT_TOKENS", "0") or 0)
        if 0 < ptoks < ref_cfg.max_prompt_tokens:
            ref_cfg = dataclasses.replace(ref_cfg, max_prompt_tokens=ptoks, max_prompt_mel=2 * ptoks)
        steps = int(os.environ.get("CHATTERBOX_CFM_STEPS", "0") or 0)
        if 0 < steps != ref_cfg.flow.n_timesteps:
            ref_cfg = dataclasses.replace(
                ref_cfg, flow=dataclasses.replace(ref_cfg.flow, n_timesteps=steps))
        if os.environ.get("CHATTERBOX_FLOW_BF16", "0") == "1":
            ref_cfg = dataclasses.replace(
                ref_cfg, flow=dataclasses.replace(ref_cfg.flow, bf16_activations=True))
        return ref_cfg

    @staticmethod
    def full(param_dtype: str = "bfloat16") -> "EngineConfig":
        """Published widths: T3 30×1024 (H=16, Dh=64); S3Gen in the arch
        CHATTERBOX_S3GEN_ARCH names ("ref" by default, else the DiT with
        S3Tok). KV cache dtype from CHATTERBOX_KV (int8 default, ``native``
        = params dtype); per-chunk decode cap from
        CHATTERBOX_MAX_NEW_TOKENS."""
        arch = os.environ.get("CHATTERBOX_S3GEN_ARCH", "ref")
        kv = os.environ.get("CHATTERBOX_KV", "int8")
        cap = int(os.environ.get("CHATTERBOX_MAX_NEW_TOKENS", "1000"))
        return EngineConfig(
            t3=T3Config().with_(kv_cache_dtype=kv),
            ve=VoiceEncoderConfig(),
            param_dtype=param_dtype,
            s3gen_arch=arch,
            s3gen_ref=(EngineConfig._apply_ref_env_knobs(S3GenRefConfig())
                       if arch == "ref" else None),
            max_new_tokens=max(8, min(cap, 1000)),
        )


def _bucket(n: int, step: int, cap: int) -> int:
    return min(cap, max(step, int(math.ceil(n / step)) * step))


def _stable_seed(request_id: str) -> int:
    """Process-independent seed from a request id."""
    return zlib.crc32(request_id.encode()) & 0x7FFFFFFF


def _queue_put_final(q: asyncio.Queue, item) -> None:
    """Best-effort non-blocking sentinel put (drops one stale entry if full)."""
    try:
        q.put_nowait(item)
    except asyncio.QueueFull:
        try:
            q.get_nowait()
            q.put_nowait(item)
        except (asyncio.QueueEmpty, asyncio.QueueFull):
            pass


SLICE_SIZE_SNAP = (8, 16, 25, 35, 50, 70, 100)


def _snap_slice_size(requested: int, cap: int) -> int:
    requested = max(1, min(requested, cap))
    snapped = min(SLICE_SIZE_SNAP, key=lambda s: (abs(s - requested), s))
    return max(1, min(snapped, cap))


def _lookahead_size(slice_size: int) -> int:
    """First-slice look-ahead: max(3, 0.2·slice)."""
    return max(3, -(-slice_size // 5))


# Largest progressive slice: with its EOS code it stays within MAX_TAIL_TOKENS
# and the streaming block ladder (s3gen_scheduler.STREAM_BLOCK_SNAP), so 100,
# the top of SLICE_SIZE_SNAP.
PROGRESSIVE_SLICE_CAP = 100


def _progressive_enabled() -> bool:
    """CHATTERBOX_PROGRESSIVE_SLICES=1: on the streaming full-overlap path,
    slices after a chunk's second grow (s → 2s → … ≤ PROGRESSIVE_SLICE_CAP),
    which halves the S3Gen calls of a long chunk without touching the first
    audio (the JAX engine's deliberate deviation from the reference's fixed
    audio_tokens_per_slice)."""
    return os.environ.get("CHATTERBOX_PROGRESSIVE_SLICES", "0") == "1"


def _next_slice_target(cur: int, slice_size: int, cap: int) -> int:
    """Next progressive slice size: double, snap to the ladder, never shrink,
    at most PROGRESSIVE_SLICE_CAP."""
    nxt = _snap_slice_size(cur * 2, cap)
    return min(max(nxt, cur, slice_size), PROGRESSIVE_SLICE_CAP)


def _token_bucket_sizes(slice_size: int, cap: int):
    """Accumulated-token buckets: the slice size, then a doubling ladder."""
    sizes = [min(slice_size, cap)]
    b = 32
    while b < cap:
        if b > sizes[-1]:
            sizes.append(b)
        b *= 2
    if sizes[-1] < cap:
        sizes.append(cap)
    return sizes


# the prompt noise of every voice's CFM prompt cache: a fixed seed keeps the
# cache voice-stable (the JAX engine's fixed PRNGKey(777))
PROMPT_NOISE_SEED = 777


def reference_inputs(wav: np.ndarray, sr: int) -> Tuple[torch.Tensor, ...]:
    """A reference waveform → ``_cond_fn``'s audio inputs on the CPU: the
    audio at 24 kHz and at 16 kHz, each cut to 10 s and zero-padded to that
    static size, and its lengths (the T3 prompt's 16 kHz length capped at
    6 s)."""
    wav24 = resample(wav, sr, S3GEN_SR)[:DEC_COND_LEN]
    wav16 = resample(wav, sr, S3_SR)[:DEC16_COND_LEN]
    w24 = torch.zeros((1, DEC_COND_LEN))
    w24[0, : len(wav24)] = torch.from_numpy(wav24)
    w16 = torch.zeros((1, DEC16_COND_LEN))
    w16[0, : len(wav16)] = torch.from_numpy(wav16)
    return (w24, torch.tensor([len(wav24)]), w16, torch.tensor([min(len(wav16), ENC_COND_LEN)]),
            torch.tensor([len(wav16)]))


def neutral_inputs() -> Tuple[torch.Tensor, ...]:
    """``_cond_fn``'s audio inputs for the neutral voice: 2 s of zeros at
    each rate."""
    n24, n16 = NEUTRAL_VOICE_S * S3GEN_SR, NEUTRAL_VOICE_S * S3_SR
    return (torch.zeros((1, n24)), torch.tensor([n24]), torch.zeros((1, n16)),
            torch.tensor([n16]), torch.tensor([n16]))


def _t3_lanes(t3p: Dict, t3c: T3Config, spk: torch.Tensor, tokens: torch.Tensor,
              tok_len: torch.Tensor, exaggeration: torch.Tensor) -> torch.Tensor:
    """T3's conditioning lanes [2, C, D] from a voice's speaker embedding and
    prompt tokens (cut or zero-padded to the prompt window): cond, then
    uncond with zero speaker and exaggeration."""
    P = t3c.speech_cond_prompt_len
    prompt = F.pad(tokens[:, :P], (0, max(0, P - tokens.shape[1])))
    prompt_len = tok_len.clamp_max(P)
    cond = cond_embeddings(t3p, t3c, spk, prompt, exaggeration, prompt_len)
    uncond = cond_embeddings(t3p, t3c, torch.zeros_like(spk), prompt,
                             torch.zeros_like(exaggeration), prompt_len)
    return torch.cat([cond, uncond])


@torch.inference_mode()
def _cond_fn(params: Dict, cfg: EngineConfig, wav24: torch.Tensor, wav24_len: torch.Tensor,
             wav16: torch.Tensor, wav16_len_enc: torch.Tensor, wav16_len_dec: torch.Tensor,
             exaggeration: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """A voice's conditioning from its reference audio → (T3 lanes [2, C, D]:
    cond, then uncond with zero speaker and exaggeration; the S3Gen ref
    dict). ``wav16`` is one buffer with two valid lengths: the T3 prompt
    tokenizes ``wav16_len_enc`` samples (≤ 6 s), the VoiceEncoder and
    ``embed_ref`` take ``wav16_len_dec`` (≤ 10 s). Runs where the tensors
    are. The ref arch tokenizes with S3TokenizerV2 and embeds with
    ``s3gen_ref_embed_ref``; the DiT, as the JAX engine's ``_jit_cond``
    does, with S3Tok, then a 16 kHz log-mel (400/160/80) for the x-vector
    over ``wav16_len_dec // 160`` frames, and its prompt mel is padded to
    the static ``max_prompt_mel`` window (zeros, which the packing ignores)
    so voices stack in one batch."""
    if cfg.s3gen_arch == "ref":
        refc = cfg.s3gen_ref
        tokens, tok_len = s3tok_ref_tokenize(params["s3gen"]["tokenizer"], refc.tokenizer, wav16,
                                             wav16_len_enc)
    else:
        tokens, tok_len = s3tok_tokenize(params["s3tok"], cfg.s3tok, wav16, wav16_len_enc)
    spk = voice_embed(params["ve"], cfg.ve, wav16, wav16_len_dec)
    lanes = _t3_lanes(params["t3"], cfg.t3, spk, tokens, tok_len, exaggeration)
    if cfg.s3gen_arch == "ref":
        return lanes, s3gen_ref_embed_ref(params["s3gen"], refc, wav24, wav24_len, wav16,
                                          wav16_len_dec)
    s3c = cfg.s3gen
    P = cfg.t3.speech_cond_prompt_len
    prompt = F.pad(tokens[:, :P], (0, max(0, P - tokens.shape[1])))
    fbank = log_mel_spectrogram(wav16, S3_SR, 400, 160, 80)
    ref = s3gen_embed_ref(params["s3gen"], s3c, reflect_tail(wav24, wav24_len), fbank,
                          prompt[:, : s3c.max_prompt_tokens],
                          tok_len.clamp_max(s3c.max_prompt_tokens),
                          fbank_len=wav16_len_dec // 160)
    mel = ref["prompt_mel"]
    ref["prompt_mel"] = F.pad(mel, (0, 0, 0, s3c.max_prompt_mel - mel.shape[1]))
    return lanes, ref


def _dit_infer(cfg: S3GenConfig, params, tokens, token_len, ref, src, cache_len, noise,
               cache=None):
    if cache is not None:
        raise ValueError("the CFM prompt cache is a ref-arch feature")
    return s3gen_inference(params, cfg, tokens, token_len, ref, src, cache_len, noise)


def _resolve_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' explicitly to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _resolve_devices(tp: int, devices, device) -> Tuple[str, ...]:
    """Every rank's device under tensor parallelism: ``devices`` as given,
    else ``cuda:0`` … ``cuda:tp−1`` (the JAX engine's first tp devices);
    fewer cards than ranks refuse."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < tp:
            raise RuntimeError(f"CHATTERBOX_TP={tp} needs {tp} CUDA devices, found {n} "
                               "(pass devices= to place the ranks)")
        devices = [f"cuda:{i}" for i in range(tp)]
    devices = tuple(str(torch.device(d)) for d in devices)
    if len(devices) != tp:
        raise ValueError(f"CHATTERBOX_TP={tp} with {len(devices)} devices {devices}")
    if device is not None and torch.device(device) != torch.device(devices[0]):
        raise ValueError(f"device={device} is not rank 0's device {devices[0]}")
    return devices


def config_from_env() -> EngineConfig:
    """The config ``TTSEngine()`` builds when given none, as the JAX engine
    chooses it: with CHATTERBOX_TINY_MODEL the tiny DiT config, or
    ``tiny_ref()`` when CHATTERBOX_S3GEN_ARCH=ref; else ``full()`` in the
    DTYPE_POLICY dtype; KV_CACHE_DTYPE, when not "native", sets T3's cache."""
    settings = get_settings()
    if os.environ.get("CHATTERBOX_TINY_MODEL"):
        cfg = (EngineConfig.tiny_ref() if os.environ.get("CHATTERBOX_S3GEN_ARCH", "dit") == "ref"
               else EngineConfig.tiny())
    else:
        cfg = EngineConfig.full(settings.DTYPE_POLICY)
    if settings.KV_CACHE_DTYPE != "native":
        cfg = dataclasses.replace(cfg, t3=cfg.t3.with_(kv_cache_dtype=settings.KV_CACHE_DTYPE))
    return cfg


class TTSEngine:
    def __init__(self, engine_cfg: Optional[EngineConfig] = None, seed: int = 0,
                 device=None, params: Optional[Dict] = None, devices=None):
        """``params`` (optional) replaces the random init: {"t3": …, "s3gen":
        …, "ve": …} in the port's layout (``convert.convert_params``), on
        ``device``. ``devices``: every rank's device under ``CHATTERBOX_TP``
        (rank 0's is the engine's; e.g. ``["cpu"] * N``); a tp that does not
        divide T3's heads refuses here, before any rank starts."""
        settings = get_settings()
        if engine_cfg is None:
            engine_cfg = config_from_env()
        self.cfg = engine_cfg
        self.seed = seed
        self.tp_size = max(1, tp_size())
        self.tp_devices: Optional[Tuple[str, ...]] = None
        if self.tp_size > 1:
            check_tp(engine_cfg.t3, self.tp_size)
            self.tp_devices = _resolve_devices(self.tp_size, devices, device)
            device = self.tp_devices[0]
        self.tp: Optional[TPGroup] = None   # the followers, once _init_models starts them
        self.device = _resolve_device(device)
        self.gen_cfg = engine_cfg.gen
        self.sr = self.gen_cfg.sample_rate
        # the arch's chunk inference, (params, tokens, token_len, ref, src,
        # cache_len, noise, cache=None) → (wav, new_src), and its noise
        # draw, (cfg, batch, T, generator, device) → noise
        if engine_cfg.s3gen_arch == "ref":
            self._infer = self._ref_infer
            self._draw_noise = draw_noise
        else:
            self._infer = functools.partial(_dit_infer, engine_cfg.s3gen)
            self._draw_noise = dit_draw_noise
        # the sharded calls (the plain ones until _init_models starts a
        # tensor-parallel group)
        self.calls = ShardedCalls(engine_cfg, params, self.device)
        self.voice_manager = VoiceManager()
        self.voice_cache: Dict[str, Conditionals] = {}
        self.params: Optional[Dict] = params
        self.load_report: Dict = {}   # what _init_models loaded, and its wall
        self.tokenizer: Optional[TextTokenizer] = None
        self._state = InitializationState.NOT_STARTED
        self._progress = ""
        self._error: Optional[str] = None
        # 0 = auto: as many concurrent requests as there are decode slots
        self.tts_semaphore = asyncio.Semaphore(
            settings.CONCURRENT_REQUESTS_PER_WORKER or max(1, settings.MAX_DECODE_SLOTS))
        self.decoder: Optional[BatchedT3Decoder] = None         # MAX_DECODE_SLOTS > 1
        self.s3gen_scheduler: Optional[S3GenScheduler] = None   # same gate
        self._request_errors: Dict[str, str] = {}
        # per-voice CFM prompt caches (LRU, CHATTERBOX_CFM_CACHE_VOICES) and
        # each voice's fresh streaming state: voice → (its cache, the state)
        self._cfm_cache_lru: "collections.OrderedDict[str, Dict]" = collections.OrderedDict()
        self._stream0: Dict[str, tuple] = {}
        self._cfm_lock = threading.Lock()
        # bounded re-synthesis window in tokens (0: the whole chunk)
        self.overlap_window = int(os.environ.get("CHATTERBOX_OVERLAP_WINDOW_TOKENS", "0") or 0)
        # per-request record (tokens per chunk, samples, TTFA, wall), newest last
        self.request_stats: "collections.OrderedDict[str, Dict]" = collections.OrderedDict()

    # ------------------------------------------------------------------ init
    def get_initialization_status(self) -> dict:
        return {"state": self._state.value, "progress": self._progress, "error": self._error}

    def tp_status(self) -> Dict:
        """Tensor parallelism as ``/system-status`` shows it."""
        if self.tp is None:
            return {"size": self.tp_size, "devices": self.tp_devices}
        return {"size": self.tp_size, "devices": self.tp_devices, "backend": self.tp.backend,
                "followers_alive": self.tp.alive(),
                "sharded": ["t3", "s3gen_ref"] if self.cfg.s3gen_arch == "ref" else ["t3"]}

    def shutdown(self) -> None:
        log.info("Engine shutdown: releasing device buffers.")
        for sched in (self.decoder, self.s3gen_scheduler):
            if sched is not None:
                sched.stop()
        if self.tp is not None:
            self.calls = ShardedCalls(self.cfg, None, self.device)   # drop the channels first
            self.tp.close()
            self.tp = None
        self.decoder = None
        self.s3gen_scheduler = None
        self.params = None
        self.voice_cache.clear()
        self._cfm_cache_lru.clear()
        self._stream0.clear()

    async def ainit(self) -> None:
        try:
            asyncio.get_running_loop().set_default_executor(
                concurrent.futures.ThreadPoolExecutor(max_workers=8, thread_name_prefix="chatterbox-io"))
            self._state = InitializationState.INITIALIZING
            self._progress = "Initializing models..."
            await asyncio.to_thread(self._init_models)
            self._progress = "Loading the default voice..."
            conds = await asyncio.to_thread(self._default_conditionals)
            if self._cfm_cache_mode() != "0":
                self._progress = "Building the default voice's CFM prompt cache..."
                await asyncio.to_thread(self._cfm_cache_for, "default", conds)
            if get_settings().MAX_DECODE_SLOTS > 1:
                self._init_schedulers()
                self._progress = "Warming up the batched decoder..."
                await self._warmup_decoder()
            self._state = InitializationState.READY
            self._progress = "Model ready"
            log.info("Engine ready on %s", self.device)
        except Exception as exc:
            self._state = InitializationState.ERROR
            self._error = str(exc)
            self._progress = f"Failed: {exc}"
            log.exception("Engine initialization failed")
            raise

    def _init_models(self) -> None:
        """The weights, as the JAX engine finds them in MODEL_PATH: a native
        checkpoint, else the reference safetensors (``t3_cfg.safetensors``
        present), else a random init from the engine's seed. Under
        ``CHATTERBOX_TP`` the followers start here, build the same weights
        (or receive injected ones) and keep their shards; this rank keeps
        shard 0 and the replicated rest."""
        model_dir = Path(get_settings().MODEL_PATH)
        dtype_name = self.cfg.param_dtype
        injected = self.params is not None
        if not injected:
            self._progress = "Loading weights..."
            dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
            self.params = load_params(model_dir, self.cfg, dtype, self.device, self.seed,
                                      self.load_report)
        if self.device.type == "cuda":
            _build.library()  # build the kernels now, not inside the first request
        if self.tp_size > 1:
            self._progress = f"Starting {self.tp_size - 1} tensor-parallel followers..."
            spec = FollowerSpec(self.cfg, self.seed, str(model_dir), dtype_name,
                                params_to_numpy(self.params) if injected else None)
            self.tp = TPGroup(self.cfg, self.tp_devices, spec)
            self.params = shard_engine_params(self.params, self.cfg, self.tp_size, 0,
                                              follower=False)
            self.calls = ShardedCalls(self.cfg, self.params, self.device, t3=self.tp.t3,
                                      s3=self.tp.s3)
            log.info("tensor-parallel over %d devices (t3%s)", self.tp_size,
                     " + s3gen_ref" if self.cfg.s3gen_arch == "ref" else "")
        else:
            self.calls = ShardedCalls(self.cfg, self.params, self.device)
        tok_file = model_dir / "tokenizer.json"
        self.tokenizer = TextTokenizer(str(tok_file) if tok_file.exists() else None,
                                       self.cfg.t3.text_vocab_size)

    def _ref_infer(self, params, tokens, token_len, ref, src, cache_len, noise, cache=None):
        """The ref arch's chunk inference, through the sharded calls."""
        return self.calls.s3gen_infer(tokens, token_len, ref, noise, cache, src, cache_len)

    def _init_schedulers(self) -> None:
        """The batched T3 decoder and the S3Gen micro-batcher, with the
        first-audio gate between them (``CHATTERBOX_FIRST_AUDIO_GATE``: "0"
        turns it off, a float sets its bounded wait in seconds, default 0.25)
        and, for the ref arch, the tail-windowed vocoder unless
        ``CHATTERBOX_TAIL_VOCODE=0`` (the DiT vocodes in full and slices)."""
        settings = get_settings()
        self.decoder = self.calls.make_decoder(settings.MAX_DECODE_SLOTS,
                                               get_tts_config().AUDIO_TOKENS_PER_SLICE)
        calls = self.calls
        tail_infer = stream_infer = None
        if self.cfg.s3gen_arch == "ref":
            def stream_infer(p, tk, tl, nl, rf, sr, cl, nz, start, tail_len, states, nb, cache):
                return calls.s3gen_stream(tk, tl, nl, rf, nz, states, nb, cache, sr, cl, start,
                                          tail_len)

            if os.environ.get("CHATTERBOX_TAIL_VOCODE", "1") == "1":
                def tail_infer(p, tk, tl, rf, sr, cl, nz, start, tail_len, cache=None):
                    return calls.s3gen_infer(tk, tl, rf, nz, cache, sr, cl, start, tail_len)
        # the source row holds the largest bucket plus the largest per-slice
        # window shift (≤ slice + EOS ≤ MAX_TAIL_TOKENS)
        self.s3gen_scheduler = S3GenScheduler(
            self.params["s3gen"], self.gen_cfg, infer=self._infer,
            state_tokens=self._reachable_token_cap() + MAX_TAIL_TOKENS, tail_infer=tail_infer,
            noise_fn=self._draw_noise, stream_infer=stream_infer)
        gate_env = os.environ.get("CHATTERBOX_FIRST_AUDIO_GATE", "1")
        if gate_env != "0":
            timeout = 0.25 if gate_env == "1" else float(gate_env)
            self.decoder.first_audio_gate = functools.partial(
                self.s3gen_scheduler.wait_dispatch, timeout=timeout)

    async def _warmup_decoder(self) -> None:
        """Push one dummy chunk through the batched decoder (admission, a
        look-ahead slice and a full slice) before the first request."""
        conds = self.voice_cache["default"]
        text = np.zeros((2, self.cfg.text_bucket), np.int64)
        async for _ in self.decoder.decode_chunk(
            conds.t3_cond_lanes, text, 4, 0.8, 0.95, 0.5, 1.2,
            max_new_tokens=self.decoder.slice_size,
            lookahead=_lookahead_size(self.decoder.slice_size),
        ):
            pass

    def _reachable_token_cap(self) -> int:
        """Largest accumulated-token count one text chunk can feed S3Gen:
        per-chunk decode stops at ``max_new_tokens`` (+1 appended EOS code)."""
        return min(self.cfg.t3.max_speech_tokens + 8, self.cfg.max_new_tokens + 2)

    # ------------------------------------------------------ CFM prompt cache
    def _cfm_cache_mode(self) -> str:
        """CHATTERBOX_CFM_PROMPT_CACHE: "step" (the default: the frozen prompt
        context of every Euler step), "static" (the last step's, reused at
        every step: 10x smaller) or "0" (off: the uncached re-solve). Always
        "0" for the DiT arch, whose flow has no prompt cache."""
        if self.cfg.s3gen_arch != "ref":
            return "0"
        v = os.environ.get("CHATTERBOX_CFM_PROMPT_CACHE", "step").lower()
        if v in ("1", "step"):
            return "step"
        return "static" if v == "static" else "0"

    def _streaming(self) -> bool:
        """Streaming CFM serves the batched path when the cache is per step
        and CHATTERBOX_CFM_STREAM is "1" (the default)."""
        return (self.s3gen_scheduler is not None and self._cfm_cache_mode() == "step"
                and os.environ.get("CHATTERBOX_CFM_STREAM", "1") == "1")

    @torch.inference_mode()
    def _cfm_cache_for(self, voice_id: str, conds: Conditionals) -> Optional[Dict]:
        """The voice's frozen CFM prompt context, built at its first request
        from the fixed prompt noise and kept in an LRU of
        CHATTERBOX_CFM_CACHE_VOICES voices (default 4: a full-size "step"
        context is about 1.1 GB in bf16). Evicting a voice drops its
        streaming template too."""
        mode = self._cfm_cache_mode()
        if mode == "0":
            return None
        with self._cfm_lock:
            hit = self._cfm_cache_lru.pop(voice_id, None)
            if hit is not None:
                self._cfm_cache_lru[voice_id] = hit  # most recently used
                return hit
            cache = self.calls.prompt_prefill(conds.gen_ref, self._prompt_noise(), mode)
            cap = max(1, int(os.environ.get("CHATTERBOX_CFM_CACHE_VOICES", "4")))
            while len(self._cfm_cache_lru) >= cap:
                evicted, _ = self._cfm_cache_lru.popitem(last=False)
                self._stream0.pop(evicted, None)
                log.info("CFM prompt cache: evicted voice '%s' (cap %d)", evicted, cap)
            self._cfm_cache_lru[voice_id] = cache
            return cache

    def _prompt_noise(self) -> torch.Tensor:
        """The initial noise of every voice's CFM prompt solve, from the fixed
        seed PROMPT_NOISE_SEED (the hook through which tests inject the JAX
        engine's draw)."""
        rc = self.cfg.s3gen_ref
        gen = torch.Generator(device=self.device).manual_seed(PROMPT_NOISE_SEED)
        pm = rc.max_prompt_tokens * rc.flow.up_stride
        return torch.randn((1, cfm_noise_frames(pm), rc.flow.output_size), generator=gen,
                           device=self.device)

    @torch.inference_mode()
    def _stream_state0(self, voice_id: str, cfm_cache: Dict) -> Dict:
        """The voice's fresh streaming state (nothing updates a state in
        place, so every chunk of every request of the voice starts from it);
        the K/V ring holds CHATTERBOX_STREAM_WINDOW frames (default 512)."""
        hit = self._stream0.get(voice_id)
        if hit is not None and hit[0] is cfm_cache:
            return hit[1]
        window = int(os.environ.get("CHATTERBOX_STREAM_WINDOW", "512"))
        state = self.calls.stream_state0(cfm_cache, window, self._reachable_token_cap())
        self._stream0[voice_id] = (cfm_cache, state)
        return state

    def _decode_seed(self, request_id: str, chunk_idx: int) -> int:
        """The sampling seed of one text chunk: stable across processes and
        independent of the slot and the co-tenants."""
        return (self.seed * 1_000_003 + _stable_seed(request_id) + chunk_idx) & 0x7FFFFFFF

    # --------------------------------------------------------------- voices
    def _conditionals(self, inputs: Tuple[torch.Tensor, ...]) -> Conditionals:
        """``_cond_fn`` on the engine's device at VOICE_EXAGGERATION_FACTOR;
        ``inputs`` as ``reference_inputs`` gives them."""
        exag = torch.tensor([get_tts_config().VOICE_EXAGGERATION_FACTOR], device=self.device)
        lanes, ref = _cond_fn(self.params, self.cfg, *(x.to(self.device) for x in inputs), exag)
        return Conditionals(lanes, ref)

    def _default_conditionals(self) -> Conditionals:
        """The no-voice_id conditionals: the snapshot's default voice
        (``MODEL_PATH/conds.pt``) when present and readable; the neutral
        voice, built from 2 s of zeros, otherwise. The DiT arch ignores
        ``conds.pt``, with a warning, as the JAX engine does."""
        if "default" not in self.voice_cache:
            conds = None
            conds_file = Path(get_settings().MODEL_PATH) / "conds.pt"
            if conds_file.exists() and self.cfg.s3gen_arch != "ref":
                log.warning("conds.pt found but s3gen_arch='dit' uses its own conditioning "
                            "format; using the neutral default voice.")
            elif conds_file.exists():
                try:
                    conds = self._conds_from_default_file(load_default_conds(conds_file))
                    log.info("Default voice loaded from %s", conds_file)
                except Exception:
                    log.warning("Failed to read %s; using the neutral default voice",
                                conds_file, exc_info=True)
            if conds is None:
                conds = self._conditionals(neutral_inputs())
                log.info("Default voice: the neutral voice (no usable %s)", conds_file)
            self.voice_cache["default"] = conds
        return self.voice_cache["default"]

    @torch.inference_mode()
    def _conds_from_default_file(self, raw: Dict) -> Conditionals:
        """The loaded ``conds.pt`` fields → Conditionals: the T3 lanes as
        ``_cond_fn`` builds them, from the stored speaker embedding, prompt
        tokens and exaggeration; the gen dict padded to the static prompt
        windows."""
        rc, dev = self.cfg.s3gen_ref, self.device
        toks = torch.as_tensor(raw["prompt_speech_tokens"], device=dev).long()
        lanes = _t3_lanes(self.params["t3"], self.cfg.t3,
                          torch.as_tensor(raw["speaker_emb"], device=dev), toks,
                          torch.tensor([toks.shape[1]], device=dev),
                          torch.tensor([raw["emotion_adv"]], dtype=torch.float32, device=dev))

        Pg, Pm, up = rc.max_prompt_tokens, rc.max_prompt_mel, rc.flow.up_stride
        gtok = np.zeros((1, Pg), np.int64)
        n_tok = min(raw["prompt_token"].shape[1], raw["prompt_token_len"], Pg)
        gtok[0, :n_tok] = raw["prompt_token"][0, :n_tok]
        mel = np.zeros((1, Pm, rc.n_mels), np.float32)
        n_mel = min(raw["prompt_feat"].shape[1], raw["prompt_feat_len"], Pm)
        mel[0, :n_mel] = raw["prompt_feat"][0, :n_mel]
        # alignment rule: mel frames == up_stride × tokens
        n_tok = min(n_tok, n_mel // up)
        n_mel = n_tok * up
        mel[0, n_mel:] = 0.0
        param_dtype = self.params["s3gen"]["flow"]["input_emb"].dtype
        ref = {
            "spk_emb": torch.as_tensor(raw["embedding"], device=dev).to(param_dtype),
            "prompt_tokens": torch.as_tensor(gtok, device=dev),
            "prompt_len": torch.tensor([n_tok], device=dev),
            "prompt_mel": torch.as_tensor(mel, device=dev),
            "prompt_mel_len": torch.tensor([n_mel], device=dev),
        }
        return Conditionals(lanes, ref)

    def prepare_conditionals(self, wav_fpath: str) -> None:
        """Clone the voice of a reference WAV and cache it under the file's
        name: at most 10 s of it, resampled to 24 and 16 kHz and padded to
        the static sizes."""
        wav, sr = read_wav(wav_fpath)
        voice_id = Path(wav_fpath).name
        self.voice_cache[voice_id] = self._conditionals(reference_inputs(wav, sr))
        log.info("Prepared conditionals for voice '%s'", voice_id)

    def clear_voice_cache(self, voice_id: str) -> None:
        self._cfm_cache_lru.pop(voice_id, None)
        self._stream0.pop(voice_id, None)
        if voice_id in self.voice_cache:
            del self.voice_cache[voice_id]
            log.info("Removed voice '%s' from cache.", voice_id)
        else:
            log.warning("Attempted to clear non-cached voice '%s'.", voice_id)

    async def _get_conds(self, voice_id: Optional[str], request_id: str) -> Conditionals:
        if not voice_id:
            return await asyncio.to_thread(self._default_conditionals)
        if voice_id not in self.voice_cache:
            path = self.voice_manager.get_voice_path(voice_id)
            if path is None:
                raise FileNotFoundError(f"Voice '{voice_id}' not found")
            log.info("[%s] Voice '%s' not cached; preparing conditionals", request_id, voice_id)
            await asyncio.to_thread(self.prepare_conditionals, path)
        return self.voice_cache[voice_id]

    # --------------------------------------------------------------- stream
    async def stream(
        self,
        text: str,
        output_format: str,
        voice_id: Optional[str],
        cfg_guidance_weight: float,
        synthesis_temperature: float,
        text_processing_chunk_size: int,
        audio_tokens_per_slice: int,
        remove_trailing_milliseconds: int,
        remove_leading_milliseconds: int,
        chunk_overlap_strategy: Literal["zero", "full"],
        crossfade_duration_milliseconds: int,
        request_id: str,
        cancellation_token: CancellationToken,
    ) -> AsyncGenerator[bytes, None]:
        tts_cfg = get_tts_config()
        async with self.tts_semaphore:
            if self._state != InitializationState.READY:
                raise RuntimeError(f"TTS Engine is not ready. Status: {self._state.value}")
            start_time = time.time()
            conds = await self._get_conds(voice_id, request_id)
            cfm_cache = stream0 = None
            if self._cfm_cache_mode() != "0":
                cfm_cache = await asyncio.to_thread(self._cfm_cache_for, voice_id or "default",
                                                    conds)
            if cfm_cache is not None and chunk_overlap_strategy == "full" and self._streaming():
                stream0 = await asyncio.to_thread(self._stream_state0, voice_id or "default",
                                                  cfm_cache)
            text_chunks = await asyncio.to_thread(
                split_text_into_chunks, text, text_processing_chunk_size)
            if not text_chunks:
                yield b""
                return
            # synth_samples: audio into the crossfade; samples: audio out of it
            # (each faded seam merges fade_len samples of two slices into one)
            # t3_s / s3gen_s: host wall of the device calls (they overlap)
            # streamed / fallbacks: S3Gen calls that ran streaming CFM, and
            # chunks that fell back from it to the re-solve; window_drops:
            # re-solves that dropped left context (CHATTERBOX_OVERLAP_WINDOW_TOKENS);
            # slice_tokens: the T3 tokens of each slice sent to S3Gen;
            # dropped_codes: sampled codes outside S3Gen's vocabulary, which
            # S3Gen never sees (the T3 speech vocabulary is larger)
            stats = {"chunks": len(text_chunks), "t3_tokens": [], "synth_samples": 0,
                     "samples": 0, "slices": 0, "slice_tokens": [], "ttfa_s": None, "wall_s": None,
                     "t3_s": 0.0, "t3_steps": 0, "s3gen_s": 0.0, "streamed": 0,
                     "fallbacks": 0, "window_drops": 0, "dropped_codes": 0}
            self.request_stats[request_id] = stats
            while len(self.request_stats) > 64:
                self.request_stats.popitem(last=False)

            token_q: asyncio.Queue = asyncio.Queue(maxsize=tts_cfg.SPEECH_TOKEN_QUEUE_MAX_SIZE)
            pcm_q: asyncio.Queue = asyncio.Queue(maxsize=tts_cfg.PCM_CHUNK_QUEUE_MAX_SIZE)
            slice_size = _snap_slice_size(audio_tokens_per_slice, self.cfg.max_new_tokens)
            # progressive slices ride the streaming block ladder, so they need
            # the streaming full-overlap path
            progressive = _progressive_enabled() and stream0 is not None
            t3_task = asyncio.create_task(self._t3_producer(
                text_chunks, token_q, conds, cfg_guidance_weight, synthesis_temperature,
                slice_size, request_id, cancellation_token, stats, progressive))
            s3_task = asyncio.create_task(self._s3gen_producer(
                token_q, pcm_q, conds, chunk_overlap_strategy, slice_size,
                crossfade_duration_milliseconds, remove_leading_milliseconds,
                remove_trailing_milliseconds, len(text_chunks), request_id,
                cancellation_token, stats, cfm_cache, stream0))
            first_pcm_at = [None]  # TTFA anchor: first audio, not the container header

            async def pcm_generator():
                while True:
                    cancelled, item = await race_cancellation(pcm_q.get(), cancellation_token)
                    if cancelled or item is None:
                        break
                    if first_pcm_at[0] is None:
                        first_pcm_at[0] = time.time()
                    yield item

            encoder = AudioEncoder(output_format, self.sr, log_prefix=f"[{request_id}] ")
            failed = False
            try:
                async for out in encoder.encode(pcm_generator()):
                    if stats["ttfa_s"] is None and first_pcm_at[0] is not None:
                        stats["ttfa_s"] = first_pcm_at[0] - start_time
                        log.info("[%s] Time to first audio chunk: %.4fs", request_id, stats["ttfa_s"])
                    yield out
                err = self._request_errors.pop(request_id, None)
                if err is not None:
                    failed = True
                    raise RuntimeError(f"synthesis pipeline failed: {err}")
            finally:
                stats["wall_s"] = time.time() - start_time
                metrics.record_request(stats["ttfa_s"], stats["wall_s"], failed,
                                       cancellation_token.is_cancelled())
                self._request_errors.pop(request_id, None)
                for task in (t3_task, s3_task):
                    task.cancel()
                await asyncio.gather(t3_task, s3_task, return_exceptions=True)

    # ---------------------------------------------------------- T3 producer
    async def _t3_producer(self, text_chunks, token_q: asyncio.Queue, conds: Conditionals,
                           cfg_weight: float, temperature: float, slice_size: int,
                           request_id: str, token: CancellationToken, stats: Dict,
                           progressive: bool = False) -> None:
        t3c = self.cfg.t3
        calls = self.calls
        try:
            for i, chunk in enumerate(text_chunks):
                if token.is_cancelled():
                    break
                t_start = time.time()
                ids = self.tokenizer.text_to_tokens(chunk)[0]
                ids = np.concatenate(
                    [[t3c.start_text_token], ids[: t3c.max_text_tokens - 2], [t3c.stop_text_token]]
                ).astype(np.int64)
                T_pad = _bucket(len(ids), self.cfg.text_bucket, t3c.max_text_tokens)
                padded = np.zeros((1, T_pad), np.int64)
                padded[0, : len(ids)] = ids
                lanes = np.repeat(padded, 2, axis=0)
                seed = self._decode_seed(request_id, i)

                if self.decoder is not None:
                    n_slices = await self._produce_chunk_batched(
                        conds, lanes, len(ids), cfg_weight, temperature, slice_size, token_q,
                        token, i, len(text_chunks), seed, stats, progressive)
                    log.info("[%s][T3] chunk %d/%d: %d slices (batched) in %.3fs", request_id,
                             i + 1, len(text_chunks), n_slices, time.time() - t_start)
                    if n_slices < 0:  # cancelled mid-chunk
                        return
                    continue

                t0 = time.perf_counter()
                cache = await asyncio.to_thread(calls.t3_prefill, conds.t3_cond_lanes, lanes,
                                                len(ids))
                stats["t3_s"] += time.perf_counter() - t0
                state = await asyncio.to_thread(calls.t3_state, [seed], temperature, 0.95,
                                                cfg_weight, 1.2)
                produced, slice_idx, kept, done = 0, 0, 0, False
                pos0 = t3c.cond_len + T_pad
                cache_depth = pos0 + 1 + t3c.max_speech_tokens
                while produced < self.cfg.max_new_tokens and not done:
                    if token.is_cancelled():
                        break
                    want = _lookahead_size(slice_size) if produced == 0 else slice_size
                    n = min(want, self.cfg.max_new_tokens - produced)
                    # bounds the plain attention's read; the kernel stops at each row's pos
                    s_view = min(cache_depth, ((pos0 + produced + n + 1 + 255) // 256) * 256)

                    def run_slice():
                        toks = calls.t3_decode_slice(cache, state, n, s_view)
                        return toks, bool(state["done"][0])

                    t0 = time.perf_counter()
                    toks, done = await asyncio.to_thread(run_slice)
                    stats["t3_s"] += time.perf_counter() - t0
                    stats["t3_steps"] += n
                    row = toks[0]
                    eos = np.where(row == t3c.stop_speech_token)[0]
                    if len(eos):
                        row = row[: eos[0]]
                    produced += n
                    kept += len(row)
                    slice_idx += 1
                    item = {
                        "tokens": row,
                        "chunk_idx": i,
                        "slice_idx": slice_idx,
                        "is_first_slice": slice_idx == 1,
                        "is_last_slice": done or produced >= self.cfg.max_new_tokens,
                        "is_first_chunk": i == 0,
                        "is_last_chunk": i == len(text_chunks) - 1,
                    }
                    cancelled, _ = await race_cancellation(token_q.put(item), token)
                    if cancelled:
                        return
                stats["t3_tokens"].append(kept)
                log.info("[%s][T3] chunk %d/%d: %d slices, %d tokens in %.3fs", request_id,
                         i + 1, len(text_chunks), slice_idx, kept, time.time() - t_start)
        except Exception as exc:
            log.exception("[%s][T3] producer error", request_id)
            self._request_errors[request_id] = f"T3: {exc}"
        finally:
            if token.is_cancelled():
                _queue_put_final(token_q, None)
            else:
                try:
                    await asyncio.wait_for(token_q.put(None), timeout=10)
                except asyncio.TimeoutError:
                    _queue_put_final(token_q, None)

    async def _produce_chunk_batched(self, conds: Conditionals, lanes: np.ndarray, text_len: int,
                                     cfg_weight: float, temperature: float, slice_size: int,
                                     token_q: asyncio.Queue, token: CancellationToken,
                                     chunk_idx: int, n_chunks: int, seed: int,
                                     stats: Dict, progressive: bool = False) -> int:
        """Decode one text chunk in a slot of the batched decoder and re-cut
        its token stream into request-sized slices → the slice count, or -1
        if cancelled. With ``progressive`` (streaming full overlap only)
        slices after the second grow toward PROGRESSIVE_SLICE_CAP."""
        buf = np.zeros((0,), np.int64)
        slice_idx, kept = 0, 0
        pending: Optional[dict] = None

        def make_item(tokens: np.ndarray, idx: int) -> dict:
            return {"tokens": tokens, "chunk_idx": chunk_idx, "slice_idx": idx,
                    "is_first_slice": idx == 1, "is_last_slice": False,
                    "is_first_chunk": chunk_idx == 0, "is_last_chunk": chunk_idx == n_chunks - 1}

        async def emit(item: dict) -> bool:
            cancelled, _ = await race_cancellation(token_q.put(item), token)
            return not cancelled

        # the first group goes out early (look-ahead) so S3Gen starts sooner;
        # for the request's first chunk the decoder also runs a short slice
        target = min(_lookahead_size(slice_size), slice_size)
        async for row in self.decoder.decode_chunk(
            conds.t3_cond_lanes, lanes, text_len, temperature, 0.95, cfg_weight, 1.2,
            self.cfg.max_new_tokens, token, seed=seed,
            lookahead=target if chunk_idx == 0 else 0, stats=stats,
        ):
            kept += len(row)
            buf = np.concatenate([buf, row])
            while len(buf) >= target:
                if pending is not None and not await emit(pending):
                    return -1
                slice_idx += 1
                pending = make_item(buf[:target], slice_idx)
                buf = buf[target:]
                if progressive and slice_idx >= 2:
                    target = _next_slice_target(target, slice_size, self.cfg.max_new_tokens)
                else:
                    target = slice_size
                # tokens remain past the cut, so this slice is not the last:
                # send it now instead of holding it for the next decode slice
                if len(buf):
                    if not await emit(pending):
                        return -1
                    pending = None
        if token.is_cancelled():
            return -1
        stats["t3_tokens"].append(kept)
        if len(buf):
            if pending is not None and not await emit(pending):
                return -1
            slice_idx += 1
            pending = make_item(buf, slice_idx)
        if pending is None:
            # no tokens at all: still send the final marker, so the EOS code
            # and the trailing trim apply
            slice_idx = 1
            pending = make_item(np.zeros((0,), np.int64), slice_idx)
        pending["is_last_slice"] = True
        if not await emit(pending):
            return -1
        return slice_idx

    # -------------------------------------------------------- S3Gen producer
    async def _s3gen_producer(self, token_q: asyncio.Queue, pcm_q: asyncio.Queue,
                              conds: Conditionals, overlap: str, slice_size: int,
                              crossfade_ms: int, lead_trim_ms: int, trail_trim_ms: int,
                              n_chunks: int, request_id: str, token: CancellationToken,
                              stats: Dict, cfm_cache: Optional[Dict] = None,
                              stream0: Optional[Dict] = None) -> None:
        """``cfm_cache``: the voice's CFM prompt cache (None: uncached).
        ``stream0``: the voice's fresh streaming state; with it and full
        overlap each slice solves only its new tokens (streaming CFM), and
        the overlap window does not apply (nothing is dropped)."""
        s3p = self.params["s3gen"]
        s3c = self.gen_cfg
        spt = s3c.samples_per_token
        dev = self.device
        stitcher = CrossfadeStitcher(int(self.sr * crossfade_ms / 1000.0))
        buckets = _token_bucket_sizes(slice_size, self._reachable_token_cap())
        full = overlap == "full"
        streaming = stream0 is not None and full
        # request-stable noise: every slice of a chunk reseeds the same
        # generator, so frame t gets the same CFM noise on every re-synthesis
        noise_gen = torch.Generator(device=dev)
        base_seed = (1234 * 1_000_003 + _stable_seed(request_id)) & 0x7FFFFFFF
        acc_tokens = np.zeros((0,), np.int64)
        prev_samples = 0  # absolute samples of the chunk already emitted (full overlap)
        src_drop = 0      # window drop (tokens) the source cache is aligned to
        src_valid = 0     # valid samples in the batched path's source row
        last_chunk_idx = -1
        source_cache = np.zeros((0,), np.float32)  # per-request path: on the host
        source_state = None                        # batched path: a device row
        rstate = None                              # streaming: the chunk's state

        async def emit(audio: np.ndarray) -> bool:
            if audio.size == 0:
                return True
            stats["samples"] += int(audio.size)
            cancelled, _ = await race_cancellation(pcm_q.put(float_to_pcm16(audio)), token)
            return not cancelled

        try:
            while True:
                cancelled, item = await race_cancellation(token_q.get(), token)
                if cancelled or item is None:
                    break
                t_start = time.time()
                metrics.record_tokens(len(item["tokens"]))
                stats["slice_tokens"].append(len(item["tokens"]))
                t_prep0 = time.perf_counter()
                if item["chunk_idx"] != last_chunk_idx:
                    acc_tokens = np.zeros((0,), np.int64)
                    prev_samples = src_drop = src_valid = 0
                    source_cache = np.zeros((0,), np.float32)
                    source_state = None
                    rstate = stream0 if streaming else None
                    last_chunk_idx = item["chunk_idx"]
                    chunk_seed = base_seed + item["chunk_idx"]
                new_toks = item["tokens"]
                if item["is_last_slice"]:
                    # reference quirk kept: speech EOS appends stop_text_token
                    # (=0, a valid code)
                    new_toks = np.concatenate([new_toks, [self.cfg.t3.stop_text_token]])
                in_vocab = new_toks < s3c.vocab_size
                stats["dropped_codes"] += int(in_vocab.size - in_vocab.sum())
                new_toks = new_toks[in_vocab]
                drop = new_count = 0
                if full:
                    prev_acc = acc_tokens.size
                    acc_tokens = np.concatenate([acc_tokens, new_toks])
                    if rstate is not None:
                        if acc_tokens.size == 0:
                            continue
                        if acc_tokens.size < 3:
                            # keep the min-conv pad IN the accumulated stream,
                            # so the next slice's old/new split matches the
                            # frozen state (token 0 is a valid code)
                            acc_tokens = np.pad(acc_tokens, (0, 3 - acc_tokens.size))
                        new_count = acc_tokens.size - prev_acc
                        if new_count == 0:
                            continue
                    elif self.overlap_window:
                        # bounded re-synthesis: keep the last W tokens of left
                        # context, never dropping past the emitted prefix
                        drop = max(0, min(acc_tokens.size - self.overlap_window,
                                          prev_samples // spt))
                        stats["window_drops"] += drop > 0
                    infer_tokens = acc_tokens[drop:]
                else:
                    infer_tokens = new_toks
                if infer_tokens.size == 0:
                    continue
                if infer_tokens.size < 3:
                    infer_tokens = np.pad(infer_tokens, (0, 3 - infer_tokens.size))
                T = next(b for b in buckets if b >= infer_tokens.size)
                padded = np.full((1, T), s3c.vocab_size, np.int64)
                padded[0, : infer_tokens.size] = infer_tokens
                valid = infer_tokens.size * spt
                prev_rel = prev_samples - drop * spt if full else 0
                if self.s3gen_scheduler is not None:
                    # batched: the source row stays on the device and only
                    # the new tail comes back
                    if rstate is not None and new_count > min(MAX_TAIL_TOKENS, T):
                        # the decoder never emits more than slice + EOS tokens;
                        # were it to, the streaming block would truncate them:
                        # re-solve the rest of this chunk instead
                        log.error("[%s][S3GEN] %d new tokens exceed the streaming block; "
                                  "falling back to re-solve", request_id, new_count)
                        stats["fallbacks"] += 1
                        rstate = None
                    shift = (drop - src_drop) * spt if full else 0
                    clen = max(0, min(src_valid - shift, T * spt)) if full else 0
                    metrics.record_stage("s3gen_prep_host", time.perf_counter() - t_prep0)
                    t0 = time.perf_counter()
                    if rstate is not None:
                        tail, start_used, new_state, rstate = await self.s3gen_scheduler.synthesize(
                            padded[0], infer_tokens.size, conds.gen_ref, source_state, clen,
                            chunk_seed, prev_rel=prev_rel, cache=cfm_cache, new_len=new_count,
                            rstate=rstate)
                        stats["streamed"] += 1
                    else:
                        tail, start_used, new_state = await self.s3gen_scheduler.synthesize(
                            padded[0], infer_tokens.size, conds.gen_ref, source_state, clen,
                            chunk_seed, shift=shift, prev_rel=prev_rel, keep_state=full,
                            cache=cfm_cache)
                    stats["s3gen_s"] += time.perf_counter() - t0
                    t_host0 = time.perf_counter()
                    audio = tail[prev_rel - start_used: valid - start_used]
                    if full:
                        source_state = new_state
                        src_valid = valid
                else:
                    # the previous slice's excitation overrides the new one's
                    # prefix, aligned to this slice's window
                    src = np.zeros((1, T * spt), np.float32)
                    cache_len = 0
                    if full:
                        off = (drop - src_drop) * spt
                        sc = source_cache[off:]
                        cache_len = min(sc.size, T * spt)
                        src[0, :cache_len] = sc[:cache_len]
                    metrics.record_stage("s3gen_prep_host", time.perf_counter() - t_prep0)

                    def run(tokens=padded, n_valid=infer_tokens.size, src=src,
                            cache_len=cache_len, seed=chunk_seed, T=T):
                        with torch.inference_mode():
                            noise_gen.manual_seed(seed)
                            noise = self._draw_noise(s3c, 1, T, noise_gen, dev)
                            w, ns = self._infer(
                                s3p, torch.as_tensor(tokens, device=dev),
                                torch.tensor([n_valid], device=dev), conds.gen_ref,
                                torch.as_tensor(src, device=dev),
                                torch.tensor([cache_len], device=dev), noise, cfm_cache)
                            return w[0].float().cpu().numpy(), ns[0].float().cpu().numpy()

                    t0 = time.perf_counter()
                    wav, new_src = await asyncio.to_thread(run)
                    dt = time.perf_counter() - t0
                    metrics.record_stage("s3gen_single_device", dt)
                    stats["s3gen_s"] += dt
                    t_host0 = time.perf_counter()
                    audio = wav[prev_rel: valid]
                    if full:
                        source_cache = new_src[:valid]
                if full:
                    src_drop = drop
                    prev_samples = drop * spt + valid
                if item["is_first_chunk"] and item["is_first_slice"]:
                    audio = trim_leading(audio, lead_trim_ms, self.sr)
                if item["is_last_chunk"] and item["is_last_slice"]:
                    audio = trim_trailing(audio, trail_trim_ms, self.sr)
                log.info("[%s][S3GEN] slice %d (chunk %d/%d): %d tokens → %.2fs audio in %.3fs",
                         request_id, item["slice_idx"], item["chunk_idx"] + 1, n_chunks,
                         infer_tokens.size, len(audio) / self.sr, time.time() - t_start)
                stats["synth_samples"] += int(audio.size)
                stats["slices"] += 1
                stitched = stitcher.push(audio)
                metrics.record_stage("s3gen_stitch_host", time.perf_counter() - t_host0)
                if not await emit(stitched):
                    return
        except Exception as exc:
            log.exception("[%s][S3GEN] producer error", request_id)
            self._request_errors[request_id] = f"S3Gen: {exc}"
        finally:
            if token.is_cancelled():
                _queue_put_final(pcm_q, None)
            else:
                try:
                    await emit(stitcher.flush())
                    await asyncio.wait_for(pcm_q.put(None), timeout=10)
                except asyncio.TimeoutError:
                    _queue_put_final(pcm_q, None)
