#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (chatterbox_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and its wall time; any failure raises and
the script exits non-zero without printing the final line:

1. the machine: GPU name and power limit (nvidia-smi), torch/CUDA versions,
   TF32 switched off for matmuls and cuDNN (float32 means float32 here);
2. build: one nvcc per chatterbox_tpu_torch/csrc/*.cu, all started together,
   for sm_90a, then one link; ptxas's report, and K3's and K2's segment
   kernel's registers and spills per compiled instance (and whether ptxas
   serialized the latter's wgmma instructions);
3. kernels against their plain PyTorch versions (max-abs error against a
   stated tolerance): K1 and K2 at two lanes, K1 (every body, at 2 and at
   32 lanes) on windows that start and end at, one row before and one row
   past its slice length and twice it, K3 (bf16 and f32, at 2 and at 32
   lanes) on such windows for its own slice length and on windows at and
   across its ring's tile edges, the bodies no serving path runs (K2 at
   dh = 32 and 128; K1 and K3 at Dh = 32 and 128, G = 2 and 4; K3 also at
   G = 8 and 3), then K1 (int8 and bf16 bodies), K2 and K3 at the batched
   path's shapes (32 lanes; 16 CFG pairs), and K2's context form
   (csrc/flash_mha_context.cu, over the prompt, ring and own segments read
   in place) in each dtype pair (float32 over bf16, float32, bf16) at the
   streaming batch's shapes (32 lanes, Tq = 72, 142 and 202 new frames over
   500 prompt and 512 ring keys; the prompt shared by the lanes, and per
   lane), without a ring, and at a ragged Tq, P and W with an all-masked
   lane, timed in two turns against the earlier design (K2 over the float32
   concatenation, alone and with its copies).
   Each gets its device time (CUDA events around calls queued
   behind a spin kernel), its time per call with the host's dispatch (CUDA
   events around one call on an idle GPU), its plain version's device time,
   one PyTorch library call's device time on the same inputs
   (scaled_dot_product_attention, a yardstick the port never calls) and its
   bound: the larger of the bytes it must move over 3.35 TB/s and its
   operations over the tensor-core peak for their type (float32 at the TF32
   rate);
4. batched serving with the S3Gen defaults (the CFM prompt cache in "step"
   mode, streaming CFM): EngineConfig.full() (int8 KV cache, random weights
   from a seed, a seeded conds.pt as the default voice,
   CHATTERBOX_MAX_NEW_TOKENS), MAX_DECODE_SLOTS=16; the default voice's
   prompt cache rebuilt as at a voice's first request (its build time and
   size, and one request's streaming state), then 16 concurrent requests
   through engine.stream(..., output_format="wav") with the HTTP handler's
   arguments, some spanning two text chunks, under torch.profiler (CUDA
   activity only) for the device's busy share and the peak memory (beside
   the earlier float32-buffer design's). Every WAV is checked (RIFF
   header, sample count against the tokens produced, finite, not silent);
   the decoder must have run 12 or more slots at once, S3Gen must have
   batched 2 or more streaming jobs, every S3Gen call must have streamed (no
   fallback to re-solve), and K1 (int8 body), K2's self form (the prompt
   prefill) and K2's context form must have launched. Then one 35-step
   slice at 16 slots, timed on the host and under the profiler;
5. S3Gen at full width on phase 4's engine: a chunk's first streaming slice
   from a fresh state against the prompt-cached tail path with the same
   cache and noise (FIRST_SLICE_TOL); one batched call (16 jobs, 128-token
   bucket) per path, streaming, cached re-solve and uncached re-solve, with
   its device time and its device time by kernel (the streaming call's
   beside the earlier float32-buffer design's); then 4 concurrent
   one-chunk requests on the uncached batched path
   (CHATTERBOX_CFM_PROMPT_CACHE=0) at a decode cap of 35 tokens, which must
   run K2's self form only and batch 2 or more uncached S3Gen jobs;
5b. voice cloning on phase 4's engine, the voice store pointed at the
   repo's preloaded-voices/ (VOICES_DIR a temporary directory): (a)
   prepare_conditionals clones demo-voice.wav on the card, cold, then warm
   under the profiler (wall and device time), held against the same
   _cond_fn on the CPU over an f32 copy of the weights and the same padded
   inputs (the share of each prompt-token row that agrees, reported; held
   to CLONE_TOL: every digit away from an FSQ boundary equal, cosine and
   max-abs error of the CAMPPlus and VoiceEncoder embeddings, max-abs error
   of the prompt mel and of the T3 lanes); (b) the voice dropped, 4 concurrent requests in it at
   a decode cap of 35 tokens on the batched defaults: the first clones it
   again through the voice store and builds its CFM prompt cache (K2's self
   form), and K2's context form and K1's int8 body must launch, the voice
   must hold its own prompt cache, and an S3Gen batch must stack two or
   more of its jobs; then its prompt cache's build time and size;
6. the per-request path (MAX_DECODE_SLOTS=1) at a decode cap of 35 tokens,
   on a MODEL_PATH with no conds.pt: the neutral default voice, built on
   the card from 2 s of zeros, held against the CPU as in 5b; then one
   two-chunk request with the prompt cache, then one one-chunk request
   uncached, with the same checks and K1/K2 launches;
7. a full-width BatchedT3Decoder with a bf16 cache at 16 slots: 16 prefills,
   one slice (K1's bf16 body at 32 lanes), then K3 against its plain version
   and beside K1's bf16 body on the live cache of the first and last layer;
8. serving from a model directory: the three reference safetensors files
   written at full size by the port's writer from its schemas (the
   manifest's 2,792 keys, synthesize_checkpoint's seeded values) with a
   seeded conds.pt; EngineConfig.full() booted from them by ainit as a
   deployment starts (int8 KV, 16 slots), the load's wall and GB/s, a clean
   manifest diff and conversion for each file; every leaf on the card held
   bitwise to the same loader's conversion on the CPU; 4 concurrent
   one-chunk requests with CHATTERBOX_PROGRESSIVE_SLICES=1 at a decode cap
   of 210 tokens (WAVs checked, K1's int8 body and both K2 forms launched,
   a slice past 35 tokens, every slice streamed), with each request's slice
   sizes, TTFA and RTF; then the engine's parameters saved as a native
   checkpoint and loaded back on the card, bitwise equal. The directory also
   holds a tokenizer.json (``runtime.synthetic``'s): the boot must read it with
   the port's BPE reader and give TOKENIZER_IDS for TOKENIZER_SENTENCE;
9. the DiT S3Gen configuration (CHATTERBOX_S3GEN_ARCH=dit, EngineConfig.full():
   the DiT stack and S3Tok at their published widths, bf16, int8 KV, random
   weights), on a MODEL_PATH holding a seeded conds.pt: (a) the engine warns
   and builds the neutral default voice, held against the CPU; (b) one
   batched S3Gen call (16 jobs, 128-token bucket, 105 tokens) with its
   device time and its device time by kernel, then 2 jobs in the 64-token
   bucket on a conditioned float32 copy of the weights, card against CPU
   (DIT_TOL: the mel, the f0 and the excitation from the same f0 held; the
   whole chain's excitation and the waveform reported, with its clipped
   share); (c) prepare_conditionals on the demo voice, held against
   the CPU (DIT_CLONE_TOL), with wall and device time; (d) 8 concurrent
   one-chunk requests at 16 slots and a 70-token cap (WAVs checked, S3Gen
   batching 2 or more jobs, K1's int8 body launched; K2's launches reported,
   expected 0), then one two-chunk request per request (MAX_DECODE_SLOTS=1),
   with TTFA and RTF; (e) the engine's native checkpoint saved and loaded
   back on the card, bitwise equal;
10. T3 training at full width (CHATTERBOX_S3GEN_ARCH=dit, EngineConfig.full():
   T3 30 x 1024, bf16, random weights): (a) a manifest of 4 clips cut from
   the demo voice featurized on the card by T3FeatureExtractor, two of them
   (both prompt branches) held against the CPU's extractor over an f32 copy
   of the weights; (b) one adamw step on T3 cut to 2 layers in float32,
   card against CPU (TRAIN_STEP_TOL: loss, gradient norm, every gradient
   leaf and every parameter after the step); (c) the entry point,
   ``train_t3.main --batch 4 --steps 10`` (text 160, speech 1024), then two
   timed steps each with and without recomputation (device ms, host wall,
   peak memory, the share of elements a bf16 step changes, device time by
   kernel) and 8 steps at lr 1e-3 on one batch, whose loss must fall; (d)
   an engine booted from the trained checkpoint, its T3 bitwise the trained
   leaves, serving one request (K1's int8 body launched);
11. the kernels' switches and the bench: (a) with CHATTERBOX_PALLAS=0 and
   CHATTERBOX_FLASH=0, K1's and K2's wrappers refuse CUDA tensors, naming
   the knob (the port has no plain route on the card); then
   EngineConfig.full() (ref arch, 16 slots) at a decode cap of 35 tokens,
   the default voice's prompt cache rebuilt and 4 one-chunk requests with
   the plain versions swapped in at the call sites (serve_bench's
   ``--plain-attention``: WAVs checked, no launch of any K1 or K2 body or
   form), then the same on the kernels (K1's int8 body and both K2 forms
   launch); (b) ``python -m chatterbox_tpu_torch.scripts.serve_bench
   --capacity --streams-list 1,4 --warmup-waves 1 --overlap full``, then
   ``scripts.bench`` and ``scripts.ttfa_trace --warmups 1`` side by side,
   each in a subprocess at that cap:
   each exits with 0, every JSON line parses, TTFA and RTF are finite and
   positive, the profiled wave's busy share is in (0, 1], and bench's last
   line has bench.py's four keys with the sweep's MEASURED value;
12. tensor- and data-parallel T3 (``parallel/``), two ranks on the card
   over gloo (NCCL refuses two ranks on one device; nothing here measures
   NVLink or a tensor-parallel speed-up): (a) the full-width T3 (int8 KV)
   at 16 lanes, a prefill and one 35-step decode slice at tp = 2 against
   one unsharded rank, in bf16 (as served: K1 at 8 heads per rank, 30 x 35
   launches each; the ranks' tokens equal; the tokens that differ from the
   unsharded run reported) and in float32 (the ranks' tokens equal to the
   unsharded run, one more step's hidden state within TP_F32_HIDDEN_TOL);
   (b) one adamw step at
   phase 10's shape (B = 4 x 1218 positions, full width cut to 4 layers,
   float32) under dp = 1 x tp = 2 and dp = 2 x tp = 1 against the
   single-rank step (TRAIN_STEP_TOL); (c) each rank's step wall and the
   share of a step in collectives;
13. serving under CHATTERBOX_TP=2 (``runtime/tp_serving.py``), rank 0 and
   one follower process on the card over gloo: EngineConfig.full() (ref,
   int8 KV, 16 slots, the prompt cache and streaming CFM), 4 concurrent
   one-chunk requests at a 35-token cap, each rank's launch counts set to 0
   just before: every WAV checked, the follower's token digest equal to
   rank 0's, K1's int8 body and both K2 forms launched on each rank, at 8
   and 4 heads per rank; bf16 tokens against a tp = 1 engine reported
   beside a control (tp = 1, one of the requests alone); with float32
   weights, on the per-request path (MAX_DECODE_SLOTS=1), a request's
   tokens and sample count held to tp = 1's, and one prompt-cached batched
   S3Gen-ref call held to tp = 1's (TP_S3GEN_TOL: mel, excitation, waveform
   through a conditioned vocoder). Phase 3 holds K1 at
   8 heads and both K2 forms at 4 heads (one rank's) to their plain
   versions (``check_tp_heads``);
14. the port's scripts at full width, each a ``python -m`` process on the
   card as a user starts it, every engine EngineConfig.full() (ref, bf16)
   from phase 4's model directory (a seeded conds.pt; the random init from
   seed 0, which boots faster than loading a full-size directory) at a
   decode cap of 70 tokens: (a) ``quality_study --only
   kv_native,reference_exact,prompt_cache_static`` (each variant and its
   ``default`` baseline a child process): every WAV checked against its
   request's record (the child's sidecar), each variant's MCD and LSD
   against default finite and its MCD > 0, and each sidecar's launches:
   default K1's int8 body and K2's context form, kv_native K1's float body
   at every decode step and no int8 one, reference_exact no K1 at all (its
   plain version swapped in for CHATTERBOX_PALLAS=0) and K2's self form,
   prompt_cache_static K2; (b) ``parity_check`` with reference_exact's
   WAV as its reference and the study's request id and text: the same pinned
   stack in a fresh process, exit 0 and MCD <= 0.01 dB; (c)
   ``export_checkpoint`` into a temporary directory, read back with
   ``load_checkpoint``, every leaf bitwise equal to the weights it was made
   from, with its bytes and wall; (d) ``demo_synthesis --full-model``, its
   TTFA and total printed and its WAV checked against the request's record
   (its log line); (c) and (d) run beside (a) and (b). Walls print beside
   the card's name and power limit; the weights are random, so none is a
   quality or speed result;
15. the kernels' JSON summary, the GPU line, then the final JSON line.

K1 and K2 report the launches of the batched serving phase (the main path),
K2 once per form; K3, which no serving path calls, reports its launches in
phases 3 and 7. Each kernel also reports its launches while phase 8 served
the loaded checkpoint (``launches_loaded_checkpoint``), while phase 9
served the DiT (``launches_dit``), from the start of phase 10's training
to the end of its closing request (``launches_training``), and in phase
11(a) with the plain versions swapped in (``launches_kernels_off``, 0 for
K1 and K2) and on the kernels (``launches_kernels_on``); K1 also reports
each rank's launches in phase 12(a)'s sharded slice (``launches_tp``) and
its query heads per rank there (``heads_tp``); K1 and both K2 forms report
each rank's launches while phase 13's tp = 2 engine served
(``launches_tp_serving``) and their heads per rank (``heads_tp_serving``);
K1 (per cache body) and both K2 forms report each phase 14 study child's
request launches (``launches_study``).
"""
from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from chatterbox_tpu_torch.runtime import synthetic
from chatterbox_tpu_torch.runtime.synthetic import TOKENIZER_IDS, TOKENIZER_SENTENCE, write_conds
from chatterbox_tpu_torch.scripts.common import (check_wav, device_ms, gpu_line, plain_attention,
                                                 profiler)

KERNELS = {
    "decode_attention": {
        "source": "chatterbox_tpu_torch/csrc/decode_attention.cu",
        "replaces": "chatterbox_tpu/ops/pallas_attention_v3.py:191",
    },
    "flash_mha": {
        "source": "chatterbox_tpu_torch/csrc/flash_mha.cu",
        "replaces": "chatterbox_tpu/ops/pallas_mha.py:85",
    },
    # K2's context form: the TPU kernel is K2's; the JAX package computes this
    # form as an einsum (chatterbox_tpu/models/s3gen_ref/decoder.py:293)
    "flash_mha_context": {
        "source": "chatterbox_tpu_torch/csrc/flash_mha_context.cu",
        "replaces": "chatterbox_tpu/ops/pallas_mha.py:85",
    },
    "decode_attention_pipelined": {
        "source": "chatterbox_tpu_torch/csrc/decode_attention_pipelined.cu",
        "replaces": "chatterbox_tpu/ops/pallas_attention_v3.py:415",
    },
}
# Both sides compute in float32. A float32 output differs by summation order
# only; a bfloat16 output is each side's float32 result rounded to bf16, so
# the two may sit one bf16 step apart (2^-7 relative, |out| < 2 here).
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
# H100 SXM data-sheet peaks: HBM bytes/s; dense tensor-core operations/s by
# the type the kernel's inputs arrive in. float32 counts at the TF32 rate: an
# f32 attention can run its products on the tensor cores (K2 does, split into
# bf16 parts), so the 67e12 of f32 math outside them is not the least time.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 495e12, torch.bfloat16: 989e12, torch.int8: 1979e12}
TEXTS = [
    "Hello from the port. This request runs on one graphics card.",
    "The quick brown fox jumps over the lazy dog, while the patient engineer "
    "watches the kernels compile. Streaming speech should start quickly and "
    "keep ahead of playback. A second text chunk begins somewhere around here.",
    "Random weights speak no language, but the pipeline still has to hold together.",
]
# engine.stream's arguments besides text and request id, as the HTTP handler
# passes them for a default-voice WAV request
REQUEST = dict(output_format="wav", voice_id=None, cfg_guidance_weight=0.5,
               synthesis_temperature=0.8, text_processing_chunk_size=150,
               audio_tokens_per_slice=35, remove_trailing_milliseconds=0,
               remove_leading_milliseconds=0, chunk_overlap_strategy="full",
               crossfade_duration_milliseconds=30)
SLOTS = 16                 # MAX_DECODE_SLOTS of the batched phase
LANES = 2 * SLOTS          # CFG pairs: the decode kernels' batch
MAX_NEW_TOKENS = "140"     # per-chunk decode cap (random weights never stop)


def queued_ms(fn, n: int) -> float | None:
    """Device ms per call of ``n`` calls queued behind a spin kernel, so the
    GPU runs them back to back and the events around them hold no host time;
    None if the host could not queue them all before the spin ended (the
    device's launch queue is finite)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    spin_s = 3 * (time.perf_counter() - t0) + 2e-3
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * 2e9))   # ≥ spin_s at any SM clock up to 2 GHz
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    queued_s = time.perf_counter() - t0
    b.synchronize()
    return a.elapsed_time(b) / n if queued_s < spin_s else None


def time_ms(fn, iters: int = 30, warmup: int = 3) -> tuple[float, float]:
    """(device ms, call ms) of one call. Device: ``queued_ms`` over
    ``iters`` calls, or fewer when a call launches so many kernels that
    ``iters`` of them overflow the launch queue. Call: the median CUDA-event
    time around one call on an idle GPU, which also holds the host's
    dispatch (for a wrapper: its checks and the ctypes launch), since the GPU
    waits for it after the first event."""
    for _ in range(warmup):
        fn()
    n, device = iters, None
    while device is None and n >= 1:
        device = queued_ms(fn, n)
        n //= 2
    if device is None:
        raise RuntimeError("one call's launches do not fit behind the spin kernel")
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return device, statistics.median(times)


def bound(bytes_moved: float, ops: float, dtype) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the work of one call."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: float,
            show: bool = True) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    if show:
        print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.1e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def quantize(x: torch.Tensor):
    """Per-token int8 with f32 scales, as the model's cache stores it."""
    s = x.float().abs().amax(-1).clamp_min(1e-8) / 127.0
    return torch.round(x.float() / s[..., None]).clamp(-127, 127).to(torch.int8), s


# K1's bodies as (query dtype, cache): an int8 cache serves bf16 queries
DECODE_BODIES = ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                 (torch.bfloat16, "int8"))


def decode_inputs(g, B: int, H: int, Hk: int, S: int, Dh: int, q_dtype, cache: str):
    """Random K1 inputs for one body → ((q, k, v, k_new, v_new), (k_scale,
    v_scale)); the scales are None unless the cache is int8."""
    rnd = lambda *shape: torch.randn(shape, generator=g, device=g.device)  # noqa: E731
    q = rnd(B, H, Dh).to(q_dtype)
    kn, vn = rnd(B, Hk, Dh).to(q_dtype), rnd(B, Hk, Dh).to(q_dtype)
    k, v = rnd(B, Hk, S, Dh), rnd(B, Hk, S, Dh)
    if cache == "int8":
        (k, ks), (v, vs) = quantize(k), quantize(v)
        return (q, k, v, kn, vn), (ks, vs)
    return (q, k.to(q_dtype), v.to(q_dtype), kn, vn), (None, None)


def slice_edge_windows(L: int) -> list[tuple[int, int]]:
    """(start, pos) pairs that start and end at, one row before and one row
    past a kernel's slice length L and twice it (starts also at 0)."""
    edges = [L - 1, L, L + 1, 2 * L - 1, 2 * L, 2 * L + 1]
    return [(s, p) for s in [0, *edges] for p in edges if s <= p]


def tile_edge_windows(L: int, T: int, stages: int) -> list[tuple[int, int]]:
    """(start, pos) pairs whose part of a slice of L rows is one row, or at,
    one row before and one row past 1, 2 and ``stages`` tiles of T rows and
    one tile more (the ring's wrap); they start at 0, at 5 and 3 rows before
    the slice edge."""
    lens = sorted({1, *(n * T + d for n in (1, 2, stages, stages + 1) for d in (-1, 0, 1))})
    return [(s, s + n) for s in (0, 5, L - 3) for n in lens]


def check_decode_attention(results: dict) -> None:
    """K1 at 2 lanes: windows at and past tile and slice edges, every body."""
    from chatterbox_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    B, H, Hk, S, Dh = 2, 16, 16, 1300, 64
    edges = slice_edge_windows(da.slice_rows())
    print(f"  K1 slice length {da.slice_rows()} rows; {len(edges)} slice-edge windows",
          flush=True)
    windows = [((5, 17), (65, 129)), ((0, 33), (64, 640)), ((31, 12), (1299, 700))]
    # the slice-edge windows two at a time: (starts, ends) of lanes 0 and 1
    pairs = zip(edges[::2], edges[1::2] + edges[:1])
    windows += [((a[0], b[0]), (a[1], b[1])) for a, b in pairs]
    for q_dtype, cache in DECODE_BODIES:
        worst = 0.0
        for (s0, s1), (p0, p1) in windows:
            tensors, scales = decode_inputs(g, B, H, Hk, S, Dh, q_dtype, cache)
            start = torch.tensor([s0, s1], dtype=torch.int32, device=dev)
            pos = torch.tensor([p0, p1], dtype=torch.int32, device=dev)
            s_view = min(S, ((max(p0, p1) + 1 + 255) // 256) * 256)
            args = (*tensors, start, pos, *scales)
            worst = max(worst, compare(f"decode_attention[{cache}] B=2 start={s0},{s1} "
                                       f"pos={p0},{p1}", da.decode_attention(*args),
                                       da.decode_attention_plain(*args, s_view=s_view),
                                       TOL[q_dtype]))
        results[cache] = {"max_abs_err": worst, "tol": TOL[q_dtype]}


def check_flash_mha(results: dict, H: int = 8) -> None:
    """K2's self form against its plain version, float32 and bfloat16: at 2
    lanes (T = 1012 with an all-masked lane, and 2500), then at the batched
    path's shape (16 jobs' CFG pairs, the 64-token bucket: T = 2 × (250 + 64)
    frames). The all-masked lane's rows must be exact zeros. ``H``: the
    heads (8, the estimator's; 4, one rank's under CHATTERBOX_TP=2)."""
    from chatterbox_tpu_torch.ops import flash_mha as fm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2 + H)
    dh = 64

    def self_mask(B, T):
        valid = torch.ones((B, T), dtype=torch.bool, device=dev)
        valid[0, T - 37:] = False              # padded tail
        valid[1, :100] = False
        return valid

    # (B, T, key mask, lane whose keys are all masked or None)
    cases = [(2, 1012, self_mask(2, 1012), 1), (2, 2500, self_mask(2, 2500), None),
             (LANES, 628, self_mask(LANES, 628), None)]
    form = "flash_mha" + ("" if H == 8 else f" H={H}")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        worst, timing = 0.0, {}
        for B, T, valid, masked in cases:
            q, k, v = (torch.randn((B, H, T, dh), generator=g, device=dev).to(dtype)
                       for _ in range(3))
            valid = valid.clone()
            if masked is not None:
                valid[masked] = False
            got = fm.flash_mha(q, k, v, valid, scale=0.125)
            want = fm.flash_mha_plain(q, k, v, valid, scale=0.125)
            worst = max(worst, compare(f"{form}[{name}] B={B} T={T}", got, want, TOL[dtype]))
            if masked is not None:
                zero = got[masked].float().abs().max().item()
                if zero != 0.0:
                    raise AssertionError(f"{form}[{name}]: all-masked lane gave {zero}, not 0")
                continue
            ms, call_ms = time_ms(lambda: fm.flash_mha(q, k, v, valid, scale=0.125))
            plain_ms, _ = time_ms(lambda: fm.flash_mha_plain(q, k, v, valid, scale=0.125))
            mask = valid[:, None, None, :]
            library_ms, _ = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=0.125))
            # QKᵀ and PV over the valid keys; q read and out written once, K
            # and V read at the valid keys only (the function needs no other)
            n_valid = valid.sum().item()
            ops = 4.0 * dh * H * T * n_valid
            moved = (2 * q.numel() + 2 * H * dh * n_valid) * q.element_size() + valid.numel()
            bound_ms, bound_by = bound(moved, ops, dtype)
            print(f"  {form}[{name}] B={B} H={H} T={T} dh={dh}: device ms kernel {ms:.4f}, plain "
                  f"{plain_ms:.4f}, SDPA {library_ms:.4f}, bound {bound_ms:.4f} ({bound_by}); "
                  f"kernel per call {call_ms:.4f}", flush=True)
            timing[(B, T)] = {"shape": f"B={B} H={H} T={T} dh={dh}", "ms": ms,
                              "plain_ms": plain_ms, "call_ms": call_ms,
                              "library_ms": library_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by}
        results[name] = {"max_abs_err": worst, "tol": TOL[dtype], **timing[(LANES, 628)],
                         f"B2_T2500": timing[(2, 2500)]}


# K2's context form: (q and own K/V dtype, prompt and ring dtype) as the
# serving configurations give them: float32 activations over bf16 weights
# (the default), float32 weights, CHATTERBOX_FLOW_BF16=1
CTX_PAIRS = {"f32_bf16": (torch.float32, torch.bfloat16), "f32_f32": (torch.float32, torch.float32),
             "bf16_bf16": (torch.bfloat16, torch.bfloat16)}


def ctx_segments(g, B2: int, Bp: int, H: int, Tq: int, P: int, W: int, pair: str, valid):
    """Random segments of one context call: q, own K/V [B2, H, Tq, 64] in the
    activation dtype, prompt K/V [Bp, H, P, 64] and ring K/V [B2, H, W, 64]
    (None when W = 0) in the context dtype, and the key mask."""
    q_dt, c_dt = CTX_PAIRS[pair]
    rnd = lambda b, n: torch.randn((b, H, n, 64), generator=g, device=g.device)  # noqa: E731
    q, ko, vo = (rnd(B2, Tq).to(q_dt) for _ in range(3))
    kp, vp = (rnd(Bp, P).to(c_dt) for _ in range(2))
    kr, vr = ((rnd(B2, W).to(c_dt) for _ in range(2)) if W else (None, None))
    return q, ko, vo, kp, vp, kr, vr, valid


def ctx_bound(args) -> tuple[float, str]:
    """The context form's least time over the bytes its segments hold: q read
    and out written once; K and V at the valid keys only, the prompt's once
    per row it holds (Bp = 2: two rows for all lanes); the key mask."""
    q, ko, vo, kp, vp, kr, vr, valid = args
    B2, H, Tq, dh = q.shape
    P, W = kp.shape[2], 0 if kr is None else kr.shape[2]
    rows = valid[:, :P].unflatten(0, (kp.shape[0], B2 // kp.shape[0])).any(1)
    kv = 2 * H * dh
    moved = (2 * q.numel() * q.element_size() + kv * valid[:, P + W:].sum().item() * q.element_size()
             + kv * (rows.sum().item() + valid[:, P:P + W].sum().item()) * kp.element_size()
             + valid.numel())
    ops = 4.0 * dh * H * Tq * valid.sum().item()
    return bound(moved, ops, q.dtype)


def check_flash_mha_context(results: dict, H: int = 8) -> None:
    """K2's context form (``flash_mha_context``, csrc/flash_mha_context.cu)
    over segments read in place, against its plain version, for each dtype
    pair: at the streaming batch's shapes (32 lanes, Tq = 72, 142 and 202 new
    frames over 500 prompt and 512 ring keys, the prompt of a batch-1 voice
    shared by the lanes, Bp = 2; in the default pair also Bp = 32), at the
    cached path's (no ring, Tq = 72), and at a ragged Tq, P and W with an
    all-masked lane, whose rows must be exact zeros. At H = 8 the streaming
    shapes are timed in two turns: the kernel, then the earlier design
    (``flash_mha`` over the [prompt | ring | own] concatenation in the
    activations' dtype) alone and with the copies each of its calls paid
    (the step's prompt and the block's own K/V into the buffer; the ring's,
    once per solve, left out); then the plain version, SDPA on the
    concatenation, and the bound over the segments' bytes (``ctx_bound``)."""
    from chatterbox_tpu_torch.ops import flash_mha as fm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9 + H)
    timed = H == 8
    for pair, (q_dt, c_dt) in CTX_PAIRS.items():
        worst, timing = 0.0, {}
        # (B2, Bp, Tq, P, W, lane whose keys are all masked or None, timed)
        cases = [(LANES, 2, Tq, CTX_PROMPT, CTX_RING, None, timed) for Tq in (72, 142, 202)]
        if pair == "f32_bf16":
            cases += [(LANES, LANES, Tq, CTX_PROMPT, CTX_RING, None, timed) for Tq in (72, 142, 202)]
        cases += [(LANES, 2, 72, CTX_PROMPT, 0, None, False), (LANES, 2, 37, 489, 501, 3, False)]
        for B2, Bp, Tq, P, W, masked, time_it in cases:
            valid = context_mask(g, B2, Tq, P, W, dev)
            if masked is not None:
                valid[masked] = False
            args = ctx_segments(g, B2, Bp, H, Tq, P, W, pair, valid)
            shape = f"B2={B2} Bp={Bp} H={H} Tq={Tq} P={P} W={W} dh=64"
            got = fm.flash_mha_context(*args, scale=0.125)
            want = fm.flash_mha_context_plain(*args, scale=0.125)
            worst = max(worst, compare(f"flash_mha_context[{pair}] {shape}", got, want,
                                       TOL[q_dt]))
            if masked is not None:
                zero = got[masked].float().abs().max().item()
                if zero != 0.0:
                    raise AssertionError(f"flash_mha_context[{pair}]: all-masked lane gave {zero}")
            if not time_it:
                continue
            q, ko, vo, kp, vp, kr, vr, _ = args
            rep = B2 // Bp
            # the earlier design's buffer, as its caller built it
            buf_k = torch.cat([kp.repeat_interleave(rep, 0), kr, ko.to(c_dt)], 2).to(q_dt)
            buf_v = torch.cat([vp.repeat_interleave(rep, 0), vr, vo.to(c_dt)], 2).to(q_dt)

            def earlier_with_copies():
                for buf, pr, own in ((buf_k, kp, ko), (buf_v, vp, vo)):
                    buf[:, :, :P].unflatten(0, (Bp, rep)).copy_(pr.unsqueeze(1))
                    buf[:, :, P + W:].copy_(own)
                return fm.flash_mha(q, buf_k, buf_v, valid, scale=0.125)

            new = lambda: fm.flash_mha_context(*args, scale=0.125)  # noqa: E731
            earlier = lambda: fm.flash_mha(q, buf_k, buf_v, valid, scale=0.125)  # noqa: E731
            turns = [[time_ms(fn)[0] for fn in (new, earlier, earlier_with_copies)]
                     for _ in range(2)]
            _, call_ms = time_ms(new)
            plain_ms, _ = time_ms(lambda: fm.flash_mha_context_plain(*args, scale=0.125))
            library_ms, _ = time_ms(lambda: F.scaled_dot_product_attention(
                q, buf_k, buf_v, attn_mask=valid[:, None, None, :], scale=0.125))
            bound_ms, bound_by = ctx_bound(args)
            (ms, old_ms, old_copies_ms), (ms2, old_ms2, old_copies_ms2) = turns
            print(f"  flash_mha_context[{pair}] {shape}: device ms kernel {ms:.4f}, {ms2:.4f}; "
                  f"earlier design {old_ms:.4f}, {old_ms2:.4f} (with its copies {old_copies_ms:.4f}, "
                  f"{old_copies_ms2:.4f}); plain {plain_ms:.4f}, SDPA {library_ms:.4f}, bound "
                  f"{bound_ms:.4f} ({bound_by}, share {100 * bound_ms / ms:.1f} %); kernel per "
                  f"call {call_ms:.4f}", flush=True)
            timing[(Bp, Tq)] = {"shape": shape, "ms": ms, "ms_turn2": ms2,
                                "earlier_ms": [old_ms, old_ms2],
                                "earlier_with_copies_ms": [old_copies_ms, old_copies_ms2],
                                "plain_ms": plain_ms, "call_ms": call_ms,
                                "library_ms": library_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by}
        results[pair] = {"max_abs_err": worst, "tol": TOL[q_dt]}
        if timed:
            results[pair].update(timing[(2, 72)], **{
                f"Bp{bp}_Tq{tq}": timing[(bp, tq)] for bp, tq in timing if (bp, tq) != (2, 72)})


# the streaming batch's attention: 16 requests' CFG lanes, Tq new frames (a
# block of 36, 71 or 101 tokens) over [500 prompt | 512 ring | Tq own] keys
CTX_PROMPT, CTX_RING = 500, 512


def context_mask(g, B: int, Tq: int, n_prompt: int, n_ring: int, dev) -> torch.Tensor:
    """A streaming call's key mask: the prompt valid, each lane's ring
    filled to a random klen, each lane's own block right-packed with a random
    number of new frames."""
    klen = torch.randint(0, n_ring + 1, (B,), generator=g, device=dev)
    new = torch.randint(1, Tq + 1, (B,), generator=g, device=dev)
    r = torch.arange(n_ring, device=dev)[None, :]
    o = torch.arange(Tq, device=dev)[None, :]
    return torch.cat([torch.ones((B, n_prompt), dtype=torch.bool, device=dev),
                      r < klen[:, None], o >= (Tq - new)[:, None]], dim=1)


def batched_windows(dev, S: int):
    """(start, pos) for 32 lanes: starts 0–160, ends 200–1270, one lane
    empty (start = pos)."""
    rng = np.random.default_rng(3)
    start = rng.integers(0, 161, LANES)
    pos = rng.integers(200, 1271, LANES)
    start[5] = pos[5] = 700
    pos = np.minimum(pos, S)
    return (torch.as_tensor(start, dtype=torch.int32, device=dev),
            torch.as_tensor(pos, dtype=torch.int32, device=dev))


def decode_library_fn(q, k, v, kn, vn, start, pos):
    """One scaled_dot_product_attention call computing the decode function:
    the self-term appended as one more key, a boolean mask for [start, pos)."""
    B, H, Dh = q.shape
    S = k.shape[2]
    k_ext = torch.cat([k, kn[:, :, None]], dim=2)
    v_ext = torch.cat([v, vn[:, :, None]], dim=2)
    idx = torch.arange(S + 1, device=q.device)
    mask = ((idx >= start[:, None]) & (idx < pos[:, None])) | (idx == S)
    mask = mask[:, None, None, :]
    q4 = q[:, :, None]
    return lambda: F.scaled_dot_product_attention(q4, k_ext, v_ext, attn_mask=mask,
                                                  scale=1.0 / Dh ** 0.5)


def decode_bound(q, cache_dtype, start, pos, Hk, scales: bool):
    """Bound of one decode-attention call: each [start, pos) row of K and V
    (and its f32 scales) read once, q / the current k, v read once, the
    output written once; 4 ops per (row + self-term, head, Dh)."""
    B, H, Dh = q.shape
    rows = (pos - start).clamp_min(0).sum().item()
    elem = torch.tensor([], dtype=cache_dtype).element_size()
    moved = (2 * rows * Hk * Dh * elem + (2 * rows * Hk * 4 if scales else 0)
             + (2 * B * H * Dh + 2 * B * Hk * Dh) * q.element_size() + 8 * B)
    ops = 4.0 * (rows + B) * H * Dh
    return bound(moved, ops, cache_dtype if cache_dtype == torch.int8 else q.dtype)


def time_decode(name, fn, plain_fn, library_fn, bound_ms, bound_by, err, tol) -> dict:
    ms, call_ms = time_ms(fn)
    plain_ms, _ = time_ms(plain_fn)
    library_ms, _ = time_ms(library_fn)
    print(f"  {name}: device ms kernel {ms:.4f}, plain {plain_ms:.4f}, SDPA {library_ms:.4f}, "
          f"bound {bound_ms:.4f} ({bound_by}); kernel per call {call_ms:.4f}", flush=True)
    return {"max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "call_ms": call_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def check_decode_slice_edges(k1: dict) -> None:
    """K1 at 32 lanes, every body, on windows at and across its slice edges."""
    from chatterbox_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    H = Hk = 16
    S, Dh = 1280, 64
    edges = slice_edge_windows(da.slice_rows())
    wins = [edges[i % len(edges)] for i in range(LANES)]
    start = torch.tensor([w[0] for w in wins], dtype=torch.int32, device=dev)
    pos = torch.tensor([w[1] for w in wins], dtype=torch.int32, device=dev)
    for q_dtype, cache in DECODE_BODIES:
        tensors, scales = decode_inputs(g, LANES, H, Hk, S, Dh, q_dtype, cache)
        args = (*tensors, start, pos, *scales)
        err = compare(f"decode_attention[{cache}] B={LANES} slice-edge windows",
                      da.decode_attention(*args), da.decode_attention_plain(*args),
                      TOL[q_dtype])
        k1[f"slice_edges_B{LANES}_{cache}"] = {"max_abs_err": err, "tol": TOL[q_dtype]}


def check_pipelined_edges(k3: dict) -> None:
    """K3, bf16 and f32, on windows at and across its slice edges and its
    ring's tile edges: two windows per call at 2 lanes, then all of them at
    32 lanes."""
    from chatterbox_tpu_torch.ops import decode_attention as da
    from chatterbox_tpu_torch.ops import decode_attention_pipelined as dap

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    H = Hk = 16
    S, Dh = 1300, 64
    L = dap.slice_rows()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        T = dap.tile_rows(Dh, dtype)
        wins = slice_edge_windows(L) + tile_edge_windows(L, T, dap.stages())
        pairs = list(zip(wins[::2], wins[1::2] + wins[:1]))
        lanes32 = [[wins[(i + j) % len(wins)] for j in range(LANES)]
                   for i in range(0, len(wins), LANES)]
        worst = {2: 0.0, LANES: 0.0}
        for lane_wins in [list(p) for p in pairs] + lanes32:
            B = len(lane_wins)
            tensors, _ = decode_inputs(g, B, H, Hk, S, Dh, dtype, name)
            start = torch.tensor([w[0] for w in lane_wins], dtype=torch.int32, device=dev)
            pos = torch.tensor([w[1] for w in lane_wins], dtype=torch.int32, device=dev)
            args = (*tensors, start, pos)
            worst[B] = max(worst[B], compare(
                f"decode_attention_pipelined[{name}] B={B} windows {lane_wins[:2]}…",
                dap.decode_attention_pipelined(*args), da.decode_attention_plain(*args),
                TOL[dtype], show=False))
        print(f"  decode_attention_pipelined[{name}]: slice {L} rows, tile {T} rows, "
              f"{dap.stages()} stages; {len(wins)} slice- and tile-edge windows in "
              f"{len(pairs)} calls at 2 lanes (max_abs_err {worst[2]:.3e}) and "
              f"{len(lanes32)} at {LANES} (max_abs_err {worst[LANES]:.3e}); tol "
              f"{TOL[dtype]:.1e}", flush=True)
        k3[f"edges_{name}"] = {"windows": len(wins), "slice_rows": L, "tile_rows": T,
                               "max_abs_err_B2": worst[2], f"max_abs_err_B{LANES}": worst[LANES],
                               "tol": TOL[dtype]}


def check_other_shapes(k1: dict, k2: dict, k3: dict) -> None:
    """The compiled bodies no serving path runs, at 2 lanes: K2 at dh = 32
    and 128, K1 at Dh = 32 and 128 and at G = 2 and 4, K3 at the same and
    at G = 8 and 3 (query heads split across blocks)."""
    from chatterbox_tpu_torch.ops import decode_attention_pipelined as dap
    from chatterbox_tpu_torch.ops import decode_attention as da
    from chatterbox_tpu_torch.ops import flash_mha as fm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        worst = 0.0
        for dh in (32, 128):
            q, k, v = (rnd(2, 4, 300, dh).to(dtype) for _ in range(3))
            valid = torch.ones((2, 300), dtype=torch.bool, device=dev)
            valid[1, 250:] = False
            worst = max(worst, compare(f"flash_mha[{name}] dh={dh} B=2 T=300",
                                       fm.flash_mha(q, k, v, valid, scale=dh ** -0.5),
                                       fm.flash_mha_plain(q, k, v, valid, scale=dh ** -0.5),
                                       TOL[dtype]))
        k2[f"other_dh_{name}"] = {"max_abs_err": worst, "tol": TOL[dtype]}
    start = torch.tensor([3, 200], dtype=torch.int32, device=dev)
    pos = torch.tensor([300, 517], dtype=torch.int32, device=dev)
    for q_dtype, cache in DECODE_BODIES:
        worst = 0.0
        for H, Hk, Dh in ((8, 8, 32), (8, 8, 128), (8, 4, 64), (8, 2, 64)):
            tensors, scales = decode_inputs(g, 2, H, Hk, 600, Dh, q_dtype, cache)
            args = (*tensors, start, pos, *scales)
            worst = max(worst, compare(f"decode_attention[{cache}] H={H} Hk={Hk} Dh={Dh} B=2",
                                       da.decode_attention(*args),
                                       da.decode_attention_plain(*args), TOL[q_dtype]))
        k1[f"other_shapes_{cache}"] = {"max_abs_err": worst, "tol": TOL[q_dtype]}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        worst = 0.0
        for H, Hk, Dh in ((8, 8, 32), (8, 8, 128), (8, 4, 64), (8, 2, 64), (8, 1, 64),
                          (12, 4, 32)):
            tensors, _ = decode_inputs(g, 2, H, Hk, 600, Dh, dtype, name)
            args = (*tensors, start, pos)
            worst = max(worst, compare(
                f"decode_attention_pipelined[{name}] H={H} Hk={Hk} Dh={Dh} B=2",
                dap.decode_attention_pipelined(*args), da.decode_attention_plain(*args),
                TOL[dtype]))
        k3[f"other_shapes_{name}"] = {"max_abs_err": worst, "tol": TOL[dtype]}


def check_batched_decode(k1: dict, k3: dict) -> None:
    """K1 (int8 and bf16 bodies) and K3 (bf16 and f32) at the batched
    decoder's shapes: 32 lanes, H = Hk = 16, Dh = 64, S = 1280. K3 is timed
    beside K1's bf16 body on the same inputs."""
    from chatterbox_tpu_torch.ops import decode_attention as da
    from chatterbox_tpu_torch.ops import decode_attention_pipelined as dap

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    H = Hk = 16
    S, Dh = 1280, 64
    start, pos = batched_windows(dev, S)
    shape = f"B={LANES} H={H} S={S} Dh={Dh}, mean window {(pos - start).float().mean().item():.1f}"
    print(f"  batched decode inputs: {shape}", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
        q = rnd(LANES, H, Dh).to(dtype)
        kn, vn = rnd(LANES, Hk, Dh).to(dtype), rnd(LANES, Hk, Dh).to(dtype)
        kf, vf = rnd(LANES, Hk, S, Dh), rnd(LANES, Hk, S, Dh)
        k, v = kf.to(dtype), vf.to(dtype)
        args = (q, k, v, kn, vn, start, pos)
        want = da.decode_attention_plain(*args)
        err = compare(f"decode_attention_pipelined[{name}] {shape}",
                      dap.decode_attention_pipelined(*args), want, TOL[dtype])
        bms, bby = decode_bound(q, dtype, start, pos, Hk, scales=False)
        k3[name] = {"shape": shape, **time_decode(
            f"decode_attention_pipelined[{name}] B={LANES}",
            lambda: dap.decode_attention_pipelined(*args), lambda: da.decode_attention_plain(*args),
            decode_library_fn(*args), bms, bby, err, TOL[dtype])}
        if dtype == torch.bfloat16:
            err1 = compare(f"decode_attention[bfloat16] {shape}", da.decode_attention(*args),
                           want, TOL[dtype])
            k1[f"bfloat16_B{LANES}"] = {"shape": shape, **time_decode(
                f"decode_attention[bfloat16] B={LANES}", lambda: da.decode_attention(*args),
                lambda: da.decode_attention_plain(*args), decode_library_fn(*args), bms, bby,
                err1, TOL[dtype])}
            (kq, ks), (vq, vs) = quantize(kf), quantize(vf)
            qargs = (q, kq, vq, kn, vn, start, pos, ks, vs)
            err8 = compare(f"decode_attention[int8] {shape}", da.decode_attention(*qargs),
                           da.decode_attention_plain(*qargs), TOL[dtype])
            # the yardstick reads the dequantised cache in bf16 (2x the bytes)
            deq = lambda x, s: (x.float() * s[..., None]).to(dtype)  # noqa: E731
            lib_args = (q, deq(kq, ks), deq(vq, vs), kn, vn, start, pos)
            bms8, bby8 = decode_bound(q, torch.int8, start, pos, Hk, scales=True)
            k1[f"int8_B{LANES}"] = {"shape": shape, **time_decode(
                f"decode_attention[int8] B={LANES}", lambda: da.decode_attention(*qargs),
                lambda: da.decode_attention_plain(*qargs), decode_library_fn(*lib_args),
                bms8, bby8, err8, TOL[dtype])}


def check_tp_heads(k1: dict, k2: dict, k2c: dict) -> None:
    """The kernels at one rank's head counts under CHATTERBOX_TP=2: K1's
    int8 and bf16 bodies at 32 lanes with H = Hk = 8 (T3's 16 heads over two
    ranks) at the batched decoder's S and windows, and both K2 forms at H = 4
    (the estimator's 8 over two ranks), each against its plain version (the
    context form untimed)."""
    from chatterbox_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    H = Hk = 8
    S, Dh = 1280, 64
    start, pos = batched_windows(dev, S)
    for q_dtype, cache in (("bfloat16", "int8"), ("bfloat16", "bfloat16")):
        dtype = getattr(torch, q_dtype)
        tensors, scales = decode_inputs(g, LANES, H, Hk, S, Dh, dtype, cache)
        args = (*tensors, start, pos, *scales)
        err = compare(f"decode_attention[{cache}] B={LANES} H={H} Hk={Hk} S={S} (one rank's heads)",
                      da.decode_attention(*args), da.decode_attention_plain(*args), TOL[dtype])
        k1[f"tp_heads_{cache}"] = {"shape": f"B={LANES} H={H} Hk={Hk} S={S} Dh={Dh}",
                                   "max_abs_err": err, "tol": TOL[dtype]}
    check_flash_mha(k2, H=4)
    check_flash_mha_context(k2c, H=4)


def ptxas_report(log: str, kernel: str) -> list[dict]:
    """Registers and spill bytes ptxas reported (``-Xptxas -v``) for each
    compiled instance of the kernel template named ``kernel``."""
    types = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
    found, name, spills = [], "", (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and kernel in name:
            t = re.search(kernel + r"I(\w+?)Li(\d+)ELi(\d+)E", name)
            what = (f"{kernel}<{types.get(t.group(1), t.group(1))}, Dh {t.group(2)}, "
                    f"heads {t.group(3)}>" if t else name)
            found.append({"function": what, "registers": int(m.group(1)),
                          "spill_stores": spills[0], "spill_loads": spills[1]})
    return found


CTX_PAIR_OF_INSTANCE = {"0": "f32_bf16", "1": "f32_f32", "2": "bf16_bf16"}


def ctx_ptxas_report(log: str) -> dict:
    """ptxas's registers and spill bytes for each instance of K2's segment
    kernel (flash_ctx_kernel<pair>), and any message that it serialized the
    kernel's wgmma instructions (C75xx "Potential Performance Loss")."""
    found, name, spills = [], "", (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and "flash_ctx_kernel" in name:
            t = re.search(r"flash_ctx_kernelILi(\d)E", name)
            found.append({"function": f"flash_ctx_kernel<{CTX_PAIR_OF_INSTANCE[t.group(1)]}>",
                          "registers": int(m.group(1)), "spill_stores": spills[0],
                          "spill_loads": spills[1]})
    serialized = [line.strip() for line in log.splitlines()
                  if "flash_ctx_kernel" in line and "Performance Loss" in line]
    return {"instances": found, "wgmma_serialized": serialized}


def reset_launches():
    from chatterbox_tpu_torch.ops import decode_attention as da
    from chatterbox_tpu_torch.ops import decode_attention_pipelined as dap
    from chatterbox_tpu_torch.ops import flash_mha as fm

    for mod in (da, fm, dap):
        mod.reset_launches()


def read_launches() -> dict:
    from chatterbox_tpu_torch.ops import decode_attention as da
    from chatterbox_tpu_torch.ops import decode_attention_pipelined as dap
    from chatterbox_tpu_torch.ops import flash_mha as fm

    return {"decode_attention": dict(da.launches), "flash_mha": dict(fm.launches),
            "decode_attention_pipelined": dict(dap.launches)}


async def start_engine():
    from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine

    cfg = EngineConfig.full()
    if cfg.s3gen_arch == "ref":
        s3gen = (f"S3Gen conformer {cfg.s3gen_ref.flow.input_size} ({cfg.s3gen_ref.flow.num_blocks}"
                 f"+{cfg.s3gen_ref.flow.num_up_blocks} blocks), HiFT {cfg.s3gen_ref.hift.base_channels}")
    else:
        c = cfg.s3gen
        s3gen = (f"S3Gen DiT: encoder {c.enc_dim}x{c.enc_layers}, DiT {c.dit_dim}x{c.dit_layers} "
                 f"H={c.dit_heads}, vocoder {c.voc_channels}; S3Tok {cfg.s3tok.dim}x{cfg.s3tok.layers}")
    print(f"  config: T3 {cfg.t3.num_layers}x{cfg.t3.hidden_size} H={cfg.t3.num_heads} "
          f"kv={cfg.t3.kv_cache_dtype}, {s3gen}, params {cfg.param_dtype}, "
          f"max_new_tokens {cfg.max_new_tokens}, MAX_DECODE_SLOTS {os.environ['MAX_DECODE_SLOTS']}",
          flush=True)
    t0 = time.perf_counter()
    engine = TTSEngine(cfg, seed=0)
    await engine.ainit()
    torch.cuda.synchronize()
    print(f"  ainit {time.perf_counter() - t0:.2f} s on {engine.device}", flush=True)
    return engine


async def run_requests(engine, texts, prefix: str, request: dict = REQUEST):
    """Send ``texts`` concurrently with ``request``'s arguments → [(request
    id, wav bytes)]."""
    from chatterbox_tpu_torch.runtime.cancellation import CancellationToken

    async def one(i, text):
        rid = f"{prefix}-{i}"
        data = b""
        async for chunk in engine.stream(text=text, request_id=rid,
                                         cancellation_token=CancellationToken(), **request):
            data += chunk
        return rid, data

    return await asyncio.gather(*[one(i, t) for i, t in enumerate(texts)])


def report_requests(engine, results, two_chunks: bool = True) -> float:
    """Check each WAV and print its request's numbers → seconds of audio;
    ``two_chunks``: one request must have spanned two text chunks."""
    spt = engine.cfg.gen.samples_per_token
    fade = int(engine.sr * REQUEST["crossfade_duration_milliseconds"] / 1000)
    total = 0.0
    for rid, data in results:
        stats = engine.request_stats[rid]
        audio_s = check_wav(rid, data, stats, engine.sr, spt, fade)
        total += audio_s
        print(f"  {rid}: {stats['chunks']} chunk(s), tokens {stats['t3_tokens']}, "
              f"{audio_s:.2f} s audio, TTFA {stats['ttfa_s']:.3f} s, wall {stats['wall_s']:.3f} s, "
              f"RTF {stats['wall_s'] / audio_s:.3f}; T3 {stats['t3_s']:.2f} s over "
              f"{stats['t3_steps']} steps, S3Gen {stats['s3gen_s']:.2f} s for "
              f"{stats['slices']} calls", flush=True)
    if two_chunks and not any(engine.request_stats[rid]["chunks"] >= 2 for rid, _ in results):
        raise AssertionError("no request spanned two text chunks")
    return total


def require_main_path(launches: dict, what: str, forms=("float32", "float32_ctx")) -> None:
    """K1's int8 body and each named form of K2 must have launched."""
    if launches["decode_attention"]["int8"] == 0 or any(
            launches["flash_mha"][f] == 0 for f in forms):
        raise AssertionError(f"{what} did not run K1's int8 body and K2 {forms}: {launches}")


def text_lanes(engine, text: str):
    """A text chunk's T3 input as the engine builds it → (lanes [2, T_pad], length)."""
    from chatterbox_tpu_torch.runtime.engine import _bucket

    t3c = engine.cfg.t3
    ids = engine.tokenizer.text_to_tokens(text)[0]
    ids = np.concatenate([[t3c.start_text_token], ids[: t3c.max_text_tokens - 2],
                          [t3c.stop_text_token]]).astype(np.int64)
    T_pad = _bucket(len(ids), engine.cfg.text_bucket, t3c.max_text_tokens)
    lanes = np.zeros((2, T_pad), np.int64)
    lanes[:, : len(ids)] = ids
    return lanes, len(ids)


def fill_slots(engine, dec) -> int:
    """Prefill one chunk into every slot of a decoder whose loop is idle →
    the attention view for direct slices (on the card the kernel stops at
    each row's own pos; the view bounds only the plain version's read)."""
    lanes = engine.voice_cache["default"].t3_cond_lanes
    for slot in range(dec.n_slots):
        text, n = text_lanes(engine, TEXTS[slot % len(TEXTS)][: 40 + 7 * slot])
        dec.insert(slot, lanes, text, n, 0.8, 0.95, 0.5, 1.2, seed=slot)
    return dec.cfg.max_seq_len


def nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def build_voice_cache(engine, voice: str = "default") -> dict:
    """Drop a voice's CFM prompt cache and build it again, as its first
    request does: its build time, its size and the size of one request's
    streaming state (the K/V ring and the rest)."""
    conds = engine.voice_cache[voice]
    engine.clear_voice_cache(voice)
    engine.voice_cache[voice] = conds
    torch.cuda.synchronize()
    m0, t0 = torch.cuda.memory_allocated(), time.perf_counter()
    cache = engine._cfm_cache_for(voice, conds)
    torch.cuda.synchronize()
    build_s, grown = time.perf_counter() - t0, torch.cuda.memory_allocated() - m0
    state = engine._stream_state0(voice, cache)
    info = {"build_s": build_s, "cache_bytes": nbytes(cache), "allocated_bytes": grown,
            "ring_bytes": nbytes({k: state["cfm"][k] for k in ("k", "v")}),
            "state_bytes": nbytes(state)}
    print(f"  CFM prompt cache (step mode) of voice '{voice}': built in {build_s:.3f} s, "
          f"{info['cache_bytes'] / 2**20:.1f} MiB ({grown / 2**20:.1f} MiB allocated); one "
          f"request's streaming state {info['state_bytes'] / 2**20:.1f} MiB, of which the K/V ring "
          f"{info['ring_bytes'] / 2**20:.1f} MiB (window {state['cfm']['k'].shape[3]} frames)",
          flush=True)
    return info


async def serve_batched(out: dict):
    """Phase 4 → (the engine, kept for phase 5; K1/K2 launches)."""
    engine = await start_engine()
    dec, s3 = engine.decoder, engine.s3gen_scheduler
    if engine._cfm_cache_mode() != "step" or not engine._streaming():
        raise AssertionError("the engine's defaults are not the step prompt cache + streaming CFM")
    texts = [TEXTS[i % 3] if i % 3 else f"Stream {i}. {TEXTS[0]}" for i in range(SLOTS)]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    cache_info = build_voice_cache(engine)
    t0 = time.perf_counter()
    with profiler() as prof:
        results = await run_requests(engine, texts, "batched")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    t1 = time.perf_counter()
    summed_ms, busy_ms = device_ms(prof)
    print(f"  {SLOTS} concurrent requests: wall {wall:.3f} s under the CUDA-only profiler "
          f"(its summary took {time.perf_counter() - t1:.1f} s); device activity summed "
          f"{summed_ms / 1e3:.3f} s", flush=True)
    audio = report_requests(engine, results)
    stats = [engine.request_stats[rid] for rid, _ in results]
    streamed, slices = sum(s["streamed"] for s in stats), sum(s["slices"] for s in stats)
    fallbacks = sum(s["fallbacks"] for s in stats)
    full = [(n, k, dt) for n, k, dt in dec.slice_log if n == SLOTS]
    step_ms = 1e3 * sum(dt for *_, dt in full) / max(1, sum(k for _, k, _ in full))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  total: {audio:.2f} s of audio in {wall:.3f} s of wall = {audio / wall:.3f} s of audio "
          f"per s at {SLOTS} streams; device busy {busy_ms / 1e3:.3f} s = "
          f"{100 * busy_ms / 1e3 / wall:.1f} % of the wall; peak memory {peak_gib:.2f} GiB "
          "(the earlier float32 [prompt | ring | own] buffer's design: 21.85 GiB, and 14.44 "
          "before it, on an NVIDIA H100 80GB HBM3 at 700 W)", flush=True)
    print(f"  decoder: max_active_seen {dec.max_active_seen}; {len(full)} slices at {SLOTS} "
          f"active slots, host wall {step_ms:.2f} ms per step; S3Gen max_batch_seen "
          f"{s3.max_batch_seen}, streaming max_batch_seen {s3.max_stream_batch_seen}; "
          f"{streamed} of {slices} S3Gen calls streamed, {fallbacks} fallbacks to re-solve",
          flush=True)
    print(f"  launches during serving: {launches}", flush=True)
    require_main_path(launches, "batched serving")
    if dec.max_active_seen < SLOTS * 3 // 4:   # 12 of 16
        raise AssertionError(f"the decoder ran at most {dec.max_active_seen} slots at once")
    if s3.max_stream_batch_seen < 2:
        raise AssertionError("S3Gen never batched two streaming jobs")
    if fallbacks or streamed != slices:
        raise AssertionError(f"{fallbacks} fallbacks; {streamed} of {slices} calls streamed")

    # one 35-step slice at 16 active slots, on the idle serving decoder
    view = fill_slots(engine, dec)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.run_slice(35, view)
        walls.append(time.perf_counter() - t0)
    with profiler() as prof:
        dec.run_slice(35, view)
        torch.cuda.synchronize()
    slice_dev, _ = device_ms(prof)
    for slot in range(SLOTS):
        dec.finish(slot)
    alone_ms = 1e3 * statistics.median(walls) / 35
    print(f"  one 35-step slice at {SLOTS} slots alone: host wall {alone_ms:.2f} ms per step "
          f"({[round(1e3 * w, 1) for w in walls]} ms per slice), device {slice_dev / 35:.3f} ms "
          f"per step ({100 * slice_dev / 35 / alone_ms:.1f} % busy)", flush=True)
    out.update(wall_s=wall, audio_s=audio, audio_per_wall=audio / wall, busy=busy_ms / 1e3 / wall,
               device_summed_s=summed_ms / 1e3, device_busy_s=busy_ms / 1e3,
               max_active_seen=dec.max_active_seen, s3gen_max_batch=s3.max_batch_seen,
               s3gen_max_stream_batch=s3.max_stream_batch_seen, s3gen_calls=slices,
               serving_step_ms=step_ms, alone_step_ms=alone_ms, slice_device_ms=slice_dev,
               peak_memory_gib=peak_gib, cfm_prompt_cache=cache_info)
    return engine, launches


# a chunk's first streaming slice against the prompt-cached tail path, at
# full width: the same cache and noise, so the mels differ by float32
# summation order (right-packed block against left-packed bucket) through 10
# Euler steps, held relative to the mel's peak; the excitation follows from
# the mel. The waveform's difference is reported, not held: the random-weight
# vocoder amplifies a 1e-7 change of the mel to 3e-2 of the waveform (the
# same check at EngineConfig.tiny_ref() on the CPU), which says nothing of
# the streaming path
FIRST_SLICE_TOL = {"mel": 1e-3, "source": 1e-3}


def s3gen_batch(engine, B: int, T: int, acc: int, seed: int):
    """Inputs of one batched S3Gen call at bucket T: B jobs of ``acc``
    accumulated tokens → (tokens, token_len, ref, src, cache_len, start,
    tail_len, noise for a re-solve, noise for a streaming slice)."""
    from chatterbox_tpu_torch.models.s3gen_ref import draw_noise
    from chatterbox_tpu_torch.runtime.s3gen_scheduler import MAX_TAIL_TOKENS

    rc, dev = engine.cfg.s3gen_ref, engine.device
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.full((B, T), rc.flow.vocab_size, dtype=torch.int64, device=dev)
    tokens[:, :acc] = torch.randint(0, rc.flow.vocab_size, (B, acc), generator=g, device=dev)
    ref = {k: torch.cat([v] * B) for k, v in engine.voice_cache["default"].gen_ref.items()}
    spt = rc.samples_per_token
    tail_len = min(MAX_TAIL_TOKENS, T) * spt
    start = torch.full((B,), max(0, min((acc - 35) * spt, T * spt - tail_len)), device=dev)
    zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
    noise = [{k: torch.cat([d[k] for d in draws]) for k in draws[0]}
             for draws in ([draw_noise(rc, 1, T, g, dev, stream=st) for _ in range(B)]
                           for st in (False, True))]
    return (tokens, torch.full((B,), acc, device=dev), ref, torch.zeros((B, T * spt), device=dev),
            zeros, start, tail_len, *noise)


@torch.inference_mode()
def check_first_slice(engine) -> dict:
    """s3gen_ref_inference_streaming from a fresh state against
    s3gen_ref_inference_tail with the same prompt cache and noise, on the
    full model (random weights): a chunk's first slice of 36 tokens in the
    64-token bucket."""
    from chatterbox_tpu_torch.models.s3gen_ref import (
        s3gen_ref_inference_streaming,
        s3gen_ref_inference_tail,
    )
    from chatterbox_tpu_torch.models.s3gen_ref.model import _mel_and_source
    from chatterbox_tpu_torch.runtime.s3gen_scheduler import stream_block_tokens

    rc, p = engine.cfg.s3gen_ref, engine.params["s3gen"]
    cache = engine._cfm_cache_lru["default"]
    T, n0 = 64, 36
    tokens, tlen, ref, src, clen, _, tail_len, _, noise = s3gen_batch(engine, 1, T, n0, seed=11)
    start = torch.zeros_like(clen)
    fpt, spt = rc.flow.up_stride, rc.samples_per_token
    mel_c, src_c = _mel_and_source(p, rc, tokens, tlen, ref, src, clen, noise, cache)
    wav_c, _ = s3gen_ref_inference_tail(p, rc, tokens, tlen, ref, src, clen, noise, start, tail_len,
                                        cfm_cache=cache)
    state0 = engine._stream_state0("default", cache)
    wav_s, src_s, st = s3gen_ref_inference_streaming(
        p, rc, tokens, tlen, tlen, ref, src, clen, noise, start, tail_len, state0,
        stream_block_tokens(n0, T), cache)
    n_mel, n_wav = n0 * fpt, n0 * spt
    mel_s = st["mel"][:, :n_mel]
    peak = mel_c[:, :n_mel].abs().max().item()
    errs = {"mel": compare("first slice mel (relative to its peak)", mel_s / peak,
                           mel_c[:, :n_mel] / peak, FIRST_SLICE_TOL["mel"]),
            "source": compare("first slice source", src_s[:, :n_wav], src_c[:, :n_wav],
                              FIRST_SLICE_TOL["source"]),
            "wav": compare("first slice wav (not held)", wav_s[:, :n_wav], wav_c[:, :n_wav],
                           float("inf"))}
    if int(st["cfm"]["frames"][0]) != n_mel or st["mel"][:, n_mel:].abs().max().item() != 0.0:
        raise AssertionError("first slice: the streaming state did not advance by its frames")
    print(f"  mel peak {peak:.3f}, wav peak {wav_c.abs().max().item():.3f}", flush=True)
    return {"max_abs_err": errs, "tol": FIRST_SLICE_TOL, "mel_peak": peak}


@torch.inference_mode()
def s3gen_call_times(engine, T: int = 128, acc: int = 105) -> dict:
    """Device and host time of one batched S3Gen call at the batched path's
    shape (16 jobs, the 128-token bucket, 105 tokens accumulated, 35 new):
    streaming (the default), prompt-cached re-solve and uncached re-solve
    (the path before the prompt cache)."""
    from chatterbox_tpu_torch.models.s3gen_ref import (
        s3gen_ref_inference_streaming,
        s3gen_ref_inference_tail,
        stack_stream_states,
    )
    from chatterbox_tpu_torch.runtime.s3gen_scheduler import stream_block_tokens

    rc, p = engine.cfg.s3gen_ref, engine.params["s3gen"]
    cache = engine._cfm_cache_lru["default"]
    B, new = SLOTS, 35
    tokens, tlen, ref, src, clen, start, tail_len, noise, snoise = s3gen_batch(engine, B, T, acc, 5)
    rstate = stack_stream_states([engine._stream_state0("default", cache)] * B)
    nlen = torch.full_like(tlen, new)
    calls = {
        "streaming": lambda: s3gen_ref_inference_streaming(
            p, rc, tokens, tlen, nlen, ref, src, clen, snoise, start, tail_len, rstate,
            stream_block_tokens(new + 1, T), cache),
        "cached": lambda: s3gen_ref_inference_tail(p, rc, tokens, tlen, ref, src, clen, noise,
                                                   start, tail_len, cfm_cache=cache),
        "uncached": lambda: s3gen_ref_inference_tail(p, rc, tokens, tlen, ref, src, clen, noise,
                                                     start, tail_len),
    }
    out = {}
    for name, fn in calls.items():
        # the profiled call comes first: device time does not need a warm
        # call (phase 4 and the first-slice check ran these paths); the host
        # wall is taken on the second, outside the profiler
        reset_launches()
        with profiler() as prof:
            fn()
            torch.cuda.synchronize()
        summed, busy, kernels, n_device = device_ms(prof, top=8)
        k2 = read_launches()["flash_mha"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = {"device_ms": summed, "busy_ms": busy, "host_wall_ms": 1e3 * wall,
                     "device_activities": n_device, "k2_launches": k2, "top_kernels": kernels}
        print(f"  S3Gen batched call [{name}] B={B} bucket {T}, {acc} tokens ({new} new): device "
              f"{summed:.1f} ms (busy {busy:.1f} ms) over {n_device} device activities, host "
              f"wall {1e3 * wall:.1f} ms; K2 launches {k2}; device ms by kernel {kernels}",
              flush=True)
    print(f"  the streaming call's device time: {out['streaming']['device_ms']:.1f} ms (the earlier "
          "float32-buffer design: 484.5-488.5 ms on an NVIDIA H100 80GB HBM3 at 700 W)", flush=True)
    return out


# The cloned voice on the card against the same _cond_fn on the CPU, on an
# f32 copy of the engine's weights and the same padded inputs. The card runs
# the engine's bf16 weights: the tokenizer and CAMPPlus compute in bf16 (each
# casts its input down to its weights' dtype, as in the JAX package), the
# VoiceEncoder and the mel front ends in float32. The float32 paths are held
# at float32's summation-order scale (the prompt mel's float32 FFT is within
# 5e-6 of float64's on this voice), the bf16 ones at bf16's: CAMPPlus at
# full width on this voice is within cosine 0.99999 and 6e-3 of its peak of
# the f32 copy on the CPU. Tokens: an FSQ digit flips wherever the bf16 run
# moves 0.999·tanh(z) across ±0.5, and bf16 moves z by up to 0.053 at widths
# 256–768 on the CPU (one code in 75 is already 1.3 % of this voice's row;
# a 1e-6 change of the input flips 2 of 75 at width 256), so a share of
# agreeing tokens is reported, not held. Held instead: every digit whose
# 0.999·tanh(z) on the CPU lies more than "digit_margin" from ±0.5 is the
# card's digit, for both token rows (the T3 prompt's ≤ 6 s and the S3Gen
# prompt's ≤ 10 s); the T3 lanes are held against the CPU's lanes from the
# card's tokens (from its own: reported). "rel": max-abs error over 1 + the
# CPU side's peak.
CLONE_TOL = {
    "digit_margin": 0.1,       # tanh domain; 2x bf16's largest move of z
    "ve_cos": 0.9999,          # VoiceEncoder embedding (float32 both sides)
    "ve_abs": 1e-4,
    "mel_abs": 1e-4,           # prompt log-mel (float32 both sides)
    "spk_cos": 0.999,          # CAMPPlus x-vector (bf16 on the card)
    "spk_rel": 5e-2,
    "lanes_rel": 5e-2,         # T3 lanes (a bf16 perceiver on the card), the card's tokens
}
CLONE_VOICE = "demo-voice.wav"   # preloaded-voices/: 24 kHz mono 16-bit, 3.0 s


def f32_cpu(tree):
    """A parameter tree's float32 copy on the CPU."""
    if isinstance(tree, dict):
        return {k: f32_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [f32_cpu(v) for v in tree]
    return tree.detach().cpu().float() if tree.is_floating_point() else tree.detach().cpu()


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return F.cosine_similarity(a.float().cpu().flatten(), b.float().cpu().flatten(), dim=0).item()


def token_check(card: torch.Tensor, z: torch.Tensor, n: int, cfg) -> dict:
    """The card's tokens [n] against the CPU's FSQ input z [n, dims]: the
    share of tokens that agree, and the digits more than digit_margin from a
    rounding boundary on the CPU (decisive) and how many of them differ."""
    from chatterbox_tpu_torch.models.s3gen_ref.tokenizer import _FSQ_TANH_SCALE, fsq_digits

    z = z[:n].float()
    want = fsq_digits(z)
    powers = cfg.fsq_levels ** torch.arange(cfg.fsq_dim)
    got = (card[:n].cpu()[:, None] // powers) % cfg.fsq_levels
    decisive = ((torch.tanh(z) * _FSQ_TANH_SCALE).abs() - 0.5).abs() > CLONE_TOL["digit_margin"]
    codes = (want * powers).sum(-1).long()
    return {"n": n, "share": (card[:n].cpu() == codes).float().mean().item() if n else 1.0,
            "digits": n * cfg.fsq_dim, "decisive": int(decisive.sum()),
            "decisive_differ": int(((got != want) & decisive).sum())}


@torch.inference_mode()
def compare_conditionals(engine, conds, inputs, what: str) -> dict:
    """``conds``, built on the card from ``inputs`` (``reference_inputs`` or
    ``neutral_inputs``), against ``_cond_fn`` on the CPU over an f32 copy of
    the weights it reads; the T3 prompt's tokens and the VoiceEncoder's
    embedding, which the lanes fold in, are recomputed on each side. Raises
    on a breach of CLONE_TOL, after printing every number."""
    from chatterbox_tpu_torch.models.s3gen_ref.tokenizer import (
        s3tok_ref_encode,
        s3tok_ref_tokenize,
    )
    from chatterbox_tpu_torch.models.voice_encoder import voice_embed
    from chatterbox_tpu_torch.runtime.engine import _cond_fn, _t3_lanes
    from chatterbox_tpu_torch.settings import get_tts_config

    p, cfg, dev = engine.params, engine.cfg, engine.device
    tok = cfg.s3gen_ref.tokenizer
    cpu = {"t3": f32_cpu({k: p["t3"][k] for k in ("cond", "speech_emb")}),
           "s3gen": f32_cpu({k: p["s3gen"][k] for k in ("tokenizer", "speaker")}),
           "ve": f32_cpu(p["ve"])}
    exag = torch.tensor([get_tts_config().VOICE_EXAGGERATION_FACTOR])
    t0 = time.perf_counter()
    lanes, ref = _cond_fn(cpu, cfg, *inputs, exag)
    cpu_s = time.perf_counter() - t0
    w16, enc_len, dec_len = inputs[2], inputs[3], inputs[4]
    gref = {k: v.cpu() for k, v in conds.gen_ref.items()}
    rows = {}
    for row, n_samples, card in (("t3", enc_len, None), ("s3gen", dec_len, gref["prompt_tokens"])):
        z, n = s3tok_ref_encode(cpu["s3gen"]["tokenizer"], tok, w16, n_samples)
        if card is None:   # the T3 prompt's row, which the lanes fold in
            card, n_card = s3tok_ref_tokenize(p["s3gen"]["tokenizer"], tok, w16.to(dev),
                                              n_samples.to(dev))
        else:              # the prompt window, cut to the mel by the alignment rule
            n_card, n = gref["prompt_len"], ref["prompt_len"]
        if int(n_card[0]) != int(n[0]):
            raise AssertionError(f"{what}: {row} token counts {int(n_card[0])} (card), "
                                 f"{int(n[0])} (CPU)")
        rows[row] = token_check(card[0], z[0], int(n[0]), tok)
        if row == "t3":
            t3_card = (card.cpu(), n_card.cpu())
    ve = [voice_embed(pp, cfg.ve, w16.to(d), dec_len.to(d))
          for pp, d in ((p["ve"], dev), (cpu["ve"], "cpu"))]
    # the lanes from the card's prompt tokens: a flipped code moves a
    # perceiver latent that attends to it by a whole embedding, which the
    # token check already counts
    lanes_card_tokens = _t3_lanes(cpu["t3"], cfg.t3, ve[1], *t3_card, exag)

    def max_abs(a, b):
        return (a.float().cpu() - b.float()).abs().max().item()

    out = {
        "tokens": rows,
        "ve_cos": cosine(ve[0], ve[1]), "ve_abs": max_abs(ve[0], ve[1]),
        "mel_abs": max_abs(gref["prompt_mel"], ref["prompt_mel"]),
        "spk_cos": cosine(gref["spk_emb"], ref["spk_emb"]),
        "spk_rel": max_abs(gref["spk_emb"], ref["spk_emb"]) / (1 + ref["spk_emb"].abs().max().item()),
        "lanes_rel": max_abs(conds.t3_cond_lanes, lanes_card_tokens)
        / (1 + lanes_card_tokens.abs().max().item()),
        "lanes_rel_cpu_tokens": max_abs(conds.t3_cond_lanes, lanes) / (1 + lanes.abs().max().item()),
        "spk_peak": ref["spk_emb"].abs().max().item(), "lanes_peak": lanes.abs().max().item(),
        "mel_len": [int(gref["prompt_mel_len"][0]), int(ref["prompt_mel_len"][0])],
        "cpu_s": cpu_s,
    }
    print(f"  {what}, card against the CPU (f32 copy): {json.dumps(out)}; tolerances "
          f"{json.dumps(CLONE_TOL)}", flush=True)
    bad = [f"tokens_{r}" for r, v in rows.items() if v["decisive_differ"]]
    bad += [k for k in ("ve_cos", "spk_cos") if not out[k] >= CLONE_TOL[k]]
    bad += [k for k in ("ve_abs", "mel_abs", "spk_rel", "lanes_rel") if not out[k] <= CLONE_TOL[k]]
    if out["mel_len"][0] != out["mel_len"][1]:
        bad.append("mel_len")
    if bad:
        raise AssertionError(f"{what}: outside CLONE_TOL: {bad}")
    return out


async def clone_phase(engine, out: dict) -> None:
    """On phase 4's engine: (a) clone CLONE_VOICE from the voice store on the
    card (prepare_conditionals, once cold, then warm under the profiler) and
    hold it against the CPU; (b) drop it and serve 4 concurrent requests in
    that voice at REDUCED_NEW_TOKENS on the batched defaults: the first
    clones it again through the voice store and builds its CFM prompt cache.
    K2's self form (that build), its context form and K1's int8 body must
    launch, the voice must get its own cache, and an S3Gen batch must stack
    two or more of its jobs. Then the cache's build time and size."""
    import dataclasses

    from chatterbox_tpu_torch.audio.pcm import read_wav
    from chatterbox_tpu_torch.runtime.engine import reference_inputs

    path = engine.voice_manager.get_voice_path(CLONE_VOICE)
    if path is None or not path.startswith(os.environ["PRELOADED_VOICES_DIR"]):
        raise AssertionError(f"{CLONE_VOICE} not found in the preloaded voices: {path}")
    walls = []
    for cold in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cold:
            engine.prepare_conditionals(path)
        else:
            with profiler() as prof:
                engine.prepare_conditionals(path)
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    summed, busy, kernels, n_device = device_ms(prof, top=6)
    conds = engine.voice_cache[CLONE_VOICE]
    if conds.t3_cond_lanes.device != engine.device:
        raise AssertionError("the cloned voice's conditionals are not on the engine's device")
    print(f"  prepare_conditionals({CLONE_VOICE}): wall {walls[0]:.3f} s cold, {walls[1]:.3f} s "
          f"warm; warm device time {summed:.2f} ms (busy {busy:.2f} ms) over {n_device} device "
          f"activities; device ms by kernel {kernels}", flush=True)
    inputs = reference_inputs(*read_wav(path))
    check = compare_conditionals(engine, conds, inputs, f"cloned {CLONE_VOICE}")
    out["clone"] = {"prepare_wall_s": walls, "prepare_device_ms": summed,
                    "prepare_busy_ms": busy, "prepare_device_activities": n_device,
                    "against_cpu": check}

    s3, cfg = engine.s3gen_scheduler, engine.cfg
    engine.clear_voice_cache(CLONE_VOICE)
    engine.cfg = dataclasses.replace(cfg, max_new_tokens=REDUCED_NEW_TOKENS)
    s3.max_batch_seen = s3.max_stream_batch_seen = 0
    request = dict(REQUEST, voice_id=CLONE_VOICE)
    texts = [TEXTS[0], TEXTS[2], f"Stream 2. {TEXTS[0]}", f"Stream 3. {TEXTS[2]}"]
    try:
        reset_launches()
        t0 = time.perf_counter()
        results = await run_requests(engine, texts, "cloned", request)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        engine.cfg = cfg
    audio = report_requests(engine, results, two_chunks=False)
    print(f"  {len(results)} concurrent requests in {CLONE_VOICE} (first use: cloned through the "
          f"voice store, its prompt cache built): {audio:.2f} s of audio in {wall:.3f} s of wall; "
          f"S3Gen max_batch_seen {s3.max_batch_seen} (streaming {s3.max_stream_batch_seen}); "
          f"launches {launches}", flush=True)
    require_main_path(launches, "serving the cloned voice")
    if CLONE_VOICE not in engine.voice_cache or CLONE_VOICE not in engine._cfm_cache_lru:
        raise AssertionError(f"{CLONE_VOICE} has no conditionals or no CFM prompt cache of its own")
    if engine._cfm_cache_lru[CLONE_VOICE] is engine._cfm_cache_lru.get("default"):
        raise AssertionError("the cloned voice shares the default voice's prompt cache")
    if s3.max_stream_batch_seen < 2:
        raise AssertionError("S3Gen never stacked two jobs of the cloned voice")
    stats = [engine.request_stats[rid] for rid, _ in results]
    out["clone"].update(requests=len(results), wall_s=wall, audio_s=audio,
                        ttfa_s=[st["ttfa_s"] for st in stats], s3gen_max_stream_batch=
                        s3.max_stream_batch_seen, launches=launches,
                        cfm_prompt_cache=build_voice_cache(engine, CLONE_VOICE))


# the decode cap of the later serving phases, below phase 4's: one 35-token
# slice per chunk, then the closing slice's S3Gen call re-solves the
# accumulated tokens
REDUCED_NEW_TOKENS = 35


async def s3gen_phase(engine, out: dict) -> None:
    """Phase 5, on phase 4's engine: the first-slice check, the device time
    of one batched call per path, then a wave on the uncached batched path
    (CHATTERBOX_CFM_PROMPT_CACHE=0: 4 concurrent one-chunk requests at
    REDUCED_NEW_TOKENS), which must batch 2 or more uncached S3Gen jobs."""
    import dataclasses

    out["first_slice"] = check_first_slice(engine)
    out["s3gen_call"] = s3gen_call_times(engine)
    s3, cfg = engine.s3gen_scheduler, engine.cfg
    texts = [TEXTS[0], TEXTS[2], f"Stream 2. {TEXTS[0]}", f"Stream 3. {TEXTS[2]}"]
    os.environ["CHATTERBOX_CFM_PROMPT_CACHE"] = "0"
    engine.cfg = dataclasses.replace(cfg, max_new_tokens=REDUCED_NEW_TOKENS)
    s3.max_batch_seen = s3.max_stream_batch_seen = 0
    try:
        reset_launches()
        t0 = time.perf_counter()
        with profiler() as prof:
            results = await run_requests(engine, texts, "uncached")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        summed_ms, busy_ms = device_ms(prof)
        audio = report_requests(engine, results, two_chunks=False)
        print(f"  uncached batched path, {len(results)} concurrent requests: {audio:.2f} s of "
              f"audio in {wall:.3f} s of wall; device activity summed {summed_ms / 1e3:.3f} s, "
              f"busy {100 * busy_ms / 1e3 / wall:.1f} %; S3Gen max_batch_seen "
              f"{s3.max_batch_seen} (streaming {s3.max_stream_batch_seen}); launches {launches}",
              flush=True)
        require_main_path(launches, "uncached batched serving", forms=("float32",))
        if launches["flash_mha"]["float32_ctx"] or s3.max_stream_batch_seen:
            raise AssertionError("CHATTERBOX_CFM_PROMPT_CACHE=0 ran the cached or streaming path")
        if s3.max_batch_seen < 2:
            raise AssertionError("S3Gen never batched two uncached jobs")
        out["uncached_wave"] = {"requests": len(results), "wall_s": wall, "audio_s": audio,
                                "device_summed_s": summed_ms / 1e3, "busy": busy_ms / 1e3 / wall,
                                "s3gen_max_batch": s3.max_batch_seen}
    finally:
        del os.environ["CHATTERBOX_CFM_PROMPT_CACHE"]
        engine.cfg = cfg


async def serve_per_request(out: dict):
    """At reduced depth (REDUCED_NEW_TOKENS per chunk), on a MODEL_PATH with
    no conds.pt: the neutral default voice, built on the card, against the
    CPU; then one two-chunk request with the default prompt cache, then one
    one-chunk request on the uncached path (CHATTERBOX_CFM_PROMPT_CACHE=0),
    one after the other."""
    from chatterbox_tpu_torch.runtime.engine import neutral_inputs

    os.environ["CHATTERBOX_MAX_NEW_TOKENS"] = str(REDUCED_NEW_TOKENS)
    try:
        engine = await start_engine()
    finally:
        os.environ["CHATTERBOX_MAX_NEW_TOKENS"] = MAX_NEW_TOKENS
    if (Path(os.environ["MODEL_PATH"]) / "conds.pt").exists():
        raise AssertionError("phase 6 must run without conds.pt")
    out["neutral_voice"] = compare_conditionals(engine, engine.voice_cache["default"],
                                                neutral_inputs(), "neutral default voice")
    reset_launches()
    results = await run_requests(engine, [TEXTS[1]], "single")
    os.environ["CHATTERBOX_CFM_PROMPT_CACHE"] = "0"
    try:
        results += await run_requests(engine, [TEXTS[2]], "single-uncached")
    finally:
        del os.environ["CHATTERBOX_CFM_PROMPT_CACHE"]
    launches = read_launches()
    report_requests(engine, results)
    print(f"  launches: {launches}", flush=True)
    require_main_path(launches, "per-request serving")
    if engine.decoder is not None:
        raise AssertionError("MAX_DECODE_SLOTS=1 built a batched decoder")
    return engine


def batched_bf16_decoder(engine, k1: dict, k3: dict) -> int:
    """Phase 6 → K3 launches."""
    from chatterbox_tpu_torch.ops import decode_attention as da
    from chatterbox_tpu_torch.ops import decode_attention_pipelined as dap
    from chatterbox_tpu_torch.runtime.scheduler import BatchedT3Decoder

    t3c = engine.cfg.t3.with_(kv_cache_dtype="native")
    dec = BatchedT3Decoder(engine.params["t3"], t3c, n_slots=SLOTS, slice_size=35)
    if dec.cache["k"].dtype != torch.bfloat16:
        raise AssertionError(f"native KV cache is {dec.cache['k'].dtype}")
    view = fill_slots(engine, dec)
    reset_launches()
    toks, _ = dec.run_slice(35, view)
    torch.cuda.synchronize()
    rose = read_launches()["decode_attention"]["native"]
    if rose != 35 * t3c.num_layers:
        raise AssertionError(f"bf16 body launched {rose} times, not 35 x {t3c.num_layers}")
    if not ((toks >= 0) & (toks < t3c.speech_vocab_size)).all():
        raise AssertionError("bf16 decoder: tokens out of range")
    print(f"  {SLOTS} prefills + one 35-step slice at {LANES} lanes: K1 bf16-body launches "
          f"{rose}; slot 0 tokens {toks[0][:8].tolist()}…", flush=True)
    dev = engine.device
    g = torch.Generator(device=dev).manual_seed(6)
    start, pos = dec.cache["start"], dec.cache["pos"]
    H, Hk, Dh = t3c.num_heads, t3c.num_kv_heads, t3c.head_dim
    shape = (f"live cache B={LANES} H={H} S={t3c.max_seq_len} Dh={Dh}, windows "
             f"{int((pos - start).min())}–{int((pos - start).max())}")
    for layer in (0, t3c.num_layers - 1):
        rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
        args = (rnd(LANES, H, Dh), dec.cache["k"][layer], dec.cache["v"][layer],
                rnd(LANES, Hk, Dh), rnd(LANES, Hk, Dh), start, pos)
        want = da.decode_attention_plain(*args)
        err = compare(f"decode_attention_pipelined[bfloat16] layer {layer} {shape}",
                      dap.decode_attention_pipelined(*args), want, TOL[torch.bfloat16])
        k3["live"] = max(k3.get("live", 0.0), err)
        if layer == 0:
            k1_ms, _ = time_ms(lambda: da.decode_attention(*args))
            bms, bby = decode_bound(args[0], torch.bfloat16, start, pos, Hk, scales=False)
            k3["live_timing"] = time_decode(
                "decode_attention_pipelined[bfloat16] layer 0 live cache",
                lambda: dap.decode_attention_pipelined(*args),
                lambda: da.decode_attention_plain(*args), decode_library_fn(*args), bms, bby,
                err, TOL[torch.bfloat16])
            print(f"  layer 0 live cache: device ms K1 bf16 {k1_ms:.4f}", flush=True)
            k3["live_ms"], k1["live_bf16_ms"] = k3["live_timing"]["ms"], k1_ms
    return read_launches()["decode_attention_pipelined"]["native"]


# the loaded-checkpoint phase: a one-chunk request decodes up to 210 tokens,
# which progressive slices cut into 7, 35, 70 and 98
LOADED_NEW_TOKENS = "210"


def write_reference_checkpoint(model_dir: Path) -> dict:
    """The three reference safetensors files at full size from the port's
    schemas (every key of the manifest, seeded values), a seeded conds.pt
    and a tokenizer.json, by ``runtime.synthetic`` → the bytes and the
    write's wall."""
    out = synthetic.write_reference_checkpoint(model_dir)
    for name, f in out["files"].items():
        print(f"  {name}: {f['keys']} keys, {f['values'] / 1e6:.1f} M values, "
              f"{f['bytes'] / 2**30:.3f} GiB", flush=True)
    total, write_s = out["bytes"], out["write_s"]
    print(f"  {sum(f['keys'] for f in out['files'].values())} keys, {total / 2**30:.2f} GiB: values "
          f"drawn in {out['synth_s']:.2f} s, written in {write_s:.2f} s "
          f"({total / write_s / 1e9:.2f} GB/s)", flush=True)
    return out


def compare_params(got: dict, want: dict, what: str) -> dict:
    """Leaf by leaf, bitwise (torch.equal on the CPU): the leaf and element
    counts and the leaves that differ, which must be none."""
    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in leaves(v, f"{prefix}{k}/")]
        if isinstance(tree, list):
            return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}{i}/")]
        return [(prefix[:-1], tree)]

    a, b = leaves(got), leaves(want)
    if [k for k, _ in a] != [k for k, _ in b]:
        raise AssertionError(f"{what}: the trees differ in structure")
    differ = [k for (k, x), (_, y) in zip(a, b)
              if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x.cpu(), y.cpu())]
    out = {"leaves": len(a), "elements": int(sum(x.numel() for _, x in a)), "differ": len(differ)}
    print(f"  {what}: {out['leaves']} leaves, {out['elements'] / 1e6:.1f} M elements compared "
          f"bitwise, {len(differ)} differ {differ[:5]}", flush=True)
    if differ:
        raise AssertionError(f"{what}: {len(differ)} leaves differ")
    return out


async def serve_loaded_checkpoint(model_dir: Path, native_dir: Path, out: dict) -> dict:
    """Phase 8: boot from the reference files, hold the card's leaves to the
    CPU's conversion, serve with progressive slices, round-trip the native
    format → the launches of the serving run."""
    from chatterbox_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
    from chatterbox_tpu_torch.runtime.loader import load_reference_checkpoint

    out["written"] = write_reference_checkpoint(model_dir)
    engine = await start_engine()
    ids = engine.tokenizer.text_to_tokens(TOKENIZER_SENTENCE)[0].tolist()
    print(f"  tokenizer.json read by the port's BPE reader: {TOKENIZER_SENTENCE!r} -> {ids}",
          flush=True)
    if not engine.tokenizer.is_pretrained or ids != TOKENIZER_IDS:
        raise AssertionError(f"the boot did not read tokenizer.json as expected: {ids}")
    out["tokenizer_ids"] = ids
    report = engine.load_report
    dtype = engine.params["t3"]["text_emb"].dtype
    print(f"  load: {report['bytes'] / 2**30:.2f} GiB read and converted to the card in "
          f"{report['seconds']:.2f} s ({report['bytes'] / report['seconds'] / 1e9:.2f} GB/s), "
          f"params {dtype}", flush=True)
    for name, f in report["files"].items():
        bad = {k: len(f[k]) for k in ("mismatched", "missing", "unused")}
        print(f"  {name}: {f['keys']} keys; manifest diff {f['manifest']}; conversion {bad}",
              flush=True)
        if any(bad.values()) or any(f["manifest"][k] for k in ("unexpected", "missing",
                                                               "shape_mismatch")):
            raise AssertionError(f"{name}: the conversion or the manifest diff is not clean")
    if len(report["files"]) != 3:
        raise AssertionError(f"loaded {sorted(report['files'])}, not the three files")
    t0 = time.perf_counter()
    cpu_params = load_reference_checkpoint(model_dir, engine.cfg, dtype, "cpu")
    cpu_s = time.perf_counter() - t0
    print(f"  the same files converted on the CPU in {cpu_s:.2f} s", flush=True)
    card_vs_cpu = compare_params(engine.params, cpu_params, "card against the CPU's conversion")
    del cpu_params
    for f in list(model_dir.glob("*.safetensors")):
        f.unlink()   # room on the disk for the native copy

    texts = [TEXTS[0], TEXTS[2], f"Loaded. {TEXTS[0]}", f"Loaded. {TEXTS[2]}"]
    reset_launches()
    # the default voice's prompt cache built again inside the counted run, as
    # at a voice's first request: K2's self form runs there
    out["cfm_prompt_cache"] = build_voice_cache(engine)
    results = await run_requests(engine, texts, "loaded")
    launches = read_launches()
    print(f"  {gpu_line()}", flush=True)
    report_requests(engine, results, two_chunks=False)
    stats = [engine.request_stats[rid] for rid, _ in results]
    for (rid, _), st in zip(results, stats):
        print(f"  {rid}: slices {st['slice_tokens']}", flush=True)
    print(f"  launches: {launches}", flush=True)
    require_main_path(launches, "serving the loaded checkpoint")
    if any(st["chunks"] != 1 for st in stats):
        raise AssertionError("a request spanned more than one text chunk")
    if not any(n > 35 for st in stats for n in st["slice_tokens"]):
        raise AssertionError("no slice grew past 35 tokens")
    if any(st["fallbacks"] or st["streamed"] != st["slices"] for st in stats):
        raise AssertionError("a slice fell back to the re-solve")

    t0 = time.perf_counter()
    save_checkpoint(native_dir, engine.params, engine.cfg)
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = load_checkpoint(native_dir, engine.cfg, dtype, engine.device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    native_bytes = sum(f.stat().st_size for f in native_dir.glob("*.safetensors"))
    print(f"  native checkpoint: {native_bytes / 2**30:.2f} GiB (float32) written in {save_s:.2f} s, "
          f"read back to the card in {load_s:.2f} s", flush=True)
    round_trip = compare_params(native, engine.params, "native round trip against the engine")
    del native
    out.update(load_s=report["seconds"], load_bytes=report["bytes"],
               load_gb_s=report["bytes"] / report["seconds"] / 1e9, cpu_convert_s=cpu_s,
               card_vs_cpu=card_vs_cpu, native_save_s=save_s, native_load_s=load_s,
               native_bytes=native_bytes, round_trip=round_trip,
               slices={rid: st["slice_tokens"] for (rid, _), st in zip(results, stats)},
               ttfa_s=[st["ttfa_s"] for st in stats])
    engine.shutdown()
    return launches


# ------------------------------------------------------------ the DiT phase
# Phase 9 serves the DiT S3Gen configuration (CHATTERBOX_S3GEN_ARCH=dit):
# EngineConfig.full() with the DiT stack and S3Tok at their published widths,
# bf16 params, the int8 KV cache, random weights from the engine's seed.
# Requests decode at most DIT_NEW_TOKENS per chunk.
DIT_NEW_TOKENS = "70"
# A DiT chunk on the card against the CPU in float32 (TF32 off), 2 jobs in the
# 64-token bucket with the same tokens, voice and noise, on a float32 copy of
# the weights conditioned as the CPU tests condition the JAX tree
# (condition_dit): AdaLN-zero leaves drawn, else the flow returns its noise;
# the vocoder's resblocks scaled by DIT_RES_SCALE, else ~70 % of the waveform
# sits on the ±1 clip. Held: the mel relative to its peak (float32 summation
# order through 10 Euler steps; 7.9e-7 against float64 in a CPU rehearsal at
# this shape), the f0 predicted from the CPU's mel relative to its peak, and
# the excitation made from the CPU's f0 and noise on each side (|source| <
# 1). Its phase is a cumsum of f0/sr over the chunk, times k up to 8: at
# these weights' f0 peak of 2.5 kHz the 8th harmonic's argument reaches
# 3.2e5 rad after 61,440 samples, where one float32 ulp is 0.031 rad, and
# 5.0e3 rad after the first token (ulp 4.9e-4). torch sums in float64 on
# the CPU and in float32 on the card, so the excitation is held at 1e-4
# over its first token (2.8e-5 on the card) and at 2e-2 over the chunk
# (5.7e-3 on the card). The excitation of the whole chain is
# reported, not held (its f0 differs by float32 order too, 1.5e-2 on the
# card), and so are the waveform's difference and clipped share.
DIT_TOL = {"mel": 1e-4, "f0": 1e-4, "source_head": 1e-4, "source": 2e-2}
DIT_RES_SCALE = 0.1
# The DiT's voice on the card against the CPU: CLONE_TOL, but its x-vector
# (a 512-channel TDNN in bf16 on the card, the same width in every config)
# is held at cosine 0.995: bf16 against float32 on the CPU gave 0.99903 on
# the demo voice and 0.99908 on the neutral one, and 7e-3 of its peak.
DIT_CLONE_TOL = {**CLONE_TOL, "spk_cos": 0.995}


def to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: to_dev(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_dev(v, dev) for v in tree]
    return tree.to(dev)


def condition_dit(params: dict, seed: int) -> dict:
    """A float32 CPU copy of DiT S3Gen parameters (the port's layout),
    conditioned as tests/torch_port_helpers.py ``conditioned_dit_params``
    conditions the JAX tree."""
    g = torch.Generator().manual_seed(seed)
    q = f32_cpu(params)
    lay, out = q["flow"]["layers"], q["flow"]["out_proj"]
    D = lay["ada_w"].shape[2]   # [L, 6D, D]
    lay["ada_w"] = torch.randn(lay["ada_w"].shape, generator=g) / D ** 0.5
    lay["ada_b"] = torch.randn(lay["ada_b"].shape, generator=g) * 0.1
    out["w"] = torch.randn(out["w"].shape, generator=g) / D ** 0.5
    for stage in q["vocoder"]["stages"]:
        for block in stage["res"]:
            for unit in block:
                unit["c2"]["w"] = unit["c2"]["w"] * DIT_RES_SCALE
    return q


def dit_batch(cfg, ref1: dict, B: int, T: int, acc: int, seed: int, dev) -> tuple:
    """``s3gen_mel_and_source``'s inputs after params and cfg: B jobs of
    ``acc`` random tokens in bucket T, the voice ``ref1`` stacked, no
    excitation cache, noise from a generator seeded ``seed`` on ``dev``."""
    from chatterbox_tpu_torch.models.s3gen import draw_noise

    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.full((B, T), cfg.vocab_size, dtype=torch.int64, device=dev)
    tokens[:, :acc] = torch.randint(0, cfg.vocab_size, (B, acc), generator=g, device=dev)
    ref = {k: torch.cat([v] * B).to(dev) for k, v in ref1.items()}
    zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
    return (tokens, torch.full((B,), acc, device=dev), ref,
            torch.zeros((B, T * cfg.samples_per_token), device=dev), zeros,
            draw_noise(cfg, B, T, g, dev))


@torch.inference_mode()
def dit_s3gen_call(engine, T: int = 128, acc: int = 105) -> dict:
    """(b) One batched DiT S3Gen call at the batched path's shape (16 jobs,
    the 128-token bucket, 105 tokens) on the engine's bf16 weights: device
    time, by kernel, and host wall. Then the float32 check against the CPU
    (DIT_TOL)."""
    from chatterbox_tpu_torch.models.s3gen import s3gen_inference, s3gen_mel_and_source
    from chatterbox_tpu_torch.models.s3gen.vocoder import make_source, predict_f0, vocode

    cfg, p, dev = engine.cfg.s3gen, engine.params["s3gen"], engine.device
    ref1 = engine.voice_cache["default"].gen_ref
    args = dit_batch(cfg, ref1, SLOTS, T, acc, 5, dev)
    reset_launches()
    with profiler() as prof:
        wav, _ = s3gen_inference(p, cfg, *args)
        torch.cuda.synchronize()
    summed, busy, kernels, n_device = device_ms(prof, top=8)
    launches = read_launches()
    t0 = time.perf_counter()
    s3gen_inference(p, cfg, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.isfinite(wav).all():
        raise AssertionError("DiT batched call: non-finite waveform")
    print(f"  DiT S3Gen batched call B={SLOTS} bucket {T}, {acc} tokens: device {summed:.1f} ms "
          f"(busy {busy:.1f} ms) over {n_device} device activities, host wall {1e3 * wall:.1f} ms; "
          f"launches {launches}; device ms by kernel {kernels}", flush=True)
    out = {"device_ms": summed, "busy_ms": busy, "host_wall_ms": 1e3 * wall,
           "device_activities": n_device, "launches": launches, "top_kernels": kernels}

    q = condition_dit(p, seed=3)
    cpu_args = dit_batch(cfg, f32_cpu(ref1), 2, 64, 50, 9, "cpu")
    t0 = time.perf_counter()
    mel_c, src_c = s3gen_mel_and_source(q, cfg, *cpu_args)
    wav_c = vocode(q["vocoder"], cfg, mel_c, src_c)
    cpu_s = time.perf_counter() - t0
    qd = to_dev(q, dev)
    mel_g, src_g = s3gen_mel_and_source(qd, cfg, *to_dev(list(cpu_args), dev))
    wav_g = vocode(qd["vocoder"], cfg, mel_g, src_g).cpu()
    mel_g, src_g = mel_g.cpu(), src_g.cpu()
    f0_c = predict_f0(q["vocoder"], mel_c)
    f0_g = predict_f0(qd["vocoder"], mel_c.to(dev)).cpu()
    noise = cpu_args[5]["source"]
    exc_c = make_source(q["vocoder"], cfg, f0_c, noise)
    exc_g = make_source(qd["vocoder"], cfg, f0_c.to(dev), noise.to(dev)).cpu()
    peak, f0_peak = mel_c.abs().max().item(), f0_c.abs().max().item()
    spt = cfg.samples_per_token
    errs = {"mel": compare("DiT mel, float32, card against the CPU (relative to its peak)",
                           mel_g / peak, mel_c / peak, DIT_TOL["mel"]),
            "f0": compare("DiT f0 from the CPU's mel (relative to its peak)", f0_g / f0_peak,
                          f0_c / f0_peak, DIT_TOL["f0"]),
            "source_head": compare("DiT excitation from the CPU's f0 and noise, first token",
                                   exc_g[:, :spt], exc_c[:, :spt], DIT_TOL["source_head"]),
            "source": compare("DiT excitation from the CPU's f0 and noise", exc_g, exc_c,
                              DIT_TOL["source"]),
            "source_chain": compare("DiT excitation of the whole chain (not held)", src_g, src_c,
                                    float("inf")),
            "wav": compare("DiT waveform, float32, card against the CPU (not held)", wav_g, wav_c,
                           float("inf"))}
    clipped = (wav_c.abs() >= 1.0).float().mean().item()
    print(f"  mel peak {peak:.3f}, f0 peak {f0_peak:.2f} Hz; waveform peak {wav_c.abs().max().item():.3f}, clipped share "
          f"{clipped:.4f}; the CPU's float32 run took {cpu_s:.2f} s", flush=True)
    out["against_cpu"] = {"max_abs_err": errs, "tol": DIT_TOL, "mel_peak": peak,
                          "clipped_share": clipped, "cpu_s": cpu_s}
    return out


def dit_token_check(card: torch.Tensor, z: torch.Tensor, n: int, cfg) -> dict:
    """S3Tok's tokens [n] on the card against the CPU's FSQ input z = tanh(·)
    [n, dims]: the share that agree, and the digits more than digit_margin
    from the ±0.5 rounding boundary on the CPU, which must all agree."""
    z = z[:n].float()
    want = torch.round(z).long() + 1
    powers = cfg.fsq_levels ** torch.arange(cfg.fsq_dims)
    got = (card[:n].cpu()[:, None] // powers) % cfg.fsq_levels
    decisive = (z.abs() - 0.5).abs() > CLONE_TOL["digit_margin"]
    codes = (want * powers).sum(-1)
    return {"n": n, "share": (card[:n].cpu() == codes).float().mean().item() if n else 1.0,
            "digits": n * cfg.fsq_dims, "decisive": int(decisive.sum()),
            "decisive_differ": int(((got != want) & decisive).sum())}


@torch.inference_mode()
def compare_dit_conditionals(engine, conds, inputs, what: str) -> dict:
    """The DiT engine's ``conds``, built on the card from ``inputs``, against
    ``_cond_fn`` on the CPU over an f32 copy of the weights it reads, with
    DIT_CLONE_TOL: S3Tok's decisive digits (the T3 prompt's row, whose first
    prompt_len tokens the S3Gen prompt holds), the VoiceEncoder and x-vector
    embeddings, the prompt mel, and the T3 lanes on the card's tokens."""
    from chatterbox_tpu_torch.models.s3tok import s3tok_fsq, s3tok_tokenize
    from chatterbox_tpu_torch.models.voice_encoder import voice_embed
    from chatterbox_tpu_torch.runtime.engine import _cond_fn, _t3_lanes
    from chatterbox_tpu_torch.settings import get_tts_config

    p, cfg, dev = engine.params, engine.cfg, engine.device
    cpu = {"t3": f32_cpu({k: p["t3"][k] for k in ("cond", "speech_emb")}),
           "s3gen": {"xvector": f32_cpu(p["s3gen"]["xvector"])},
           "s3tok": f32_cpu(p["s3tok"]), "ve": f32_cpu(p["ve"])}
    exag = torch.tensor([get_tts_config().VOICE_EXAGGERATION_FACTOR])
    t0 = time.perf_counter()
    lanes, ref = _cond_fn(cpu, cfg, *inputs, exag)
    cpu_s = time.perf_counter() - t0
    w16, enc_len, dec_len = inputs[2], inputs[3], inputs[4]
    gref = {k: v.cpu() for k, v in conds.gen_ref.items()}
    z, valid = s3tok_fsq(cpu["s3tok"], cfg.s3tok, w16, enc_len)
    card, n_card = s3tok_tokenize(p["s3tok"], cfg.s3tok, w16.to(dev), enc_len.to(dev))
    n = int(valid[0].sum())
    if int(n_card[0]) != n:
        raise AssertionError(f"{what}: token counts {int(n_card[0])} (card), {n} (CPU)")
    # the S3Gen prompt: the T3 prompt window's first tokens (padded with
    # vocab_size past a shorter T3 window, as in the JAX engine)
    m, P = int(gref["prompt_len"][0]), cfg.t3.speech_cond_prompt_len
    row = F.pad(card[0, :P].cpu(), (0, max(0, m - P)), value=cfg.s3gen.vocab_size)
    if m != min(n, cfg.s3gen.max_prompt_tokens) or not torch.equal(
            gref["prompt_tokens"][0, :m], row[:m]):
        raise AssertionError(f"{what}: the S3Gen prompt is not the T3 prompt's first {m} tokens")
    ve = [voice_embed(pp, cfg.ve, w16.to(d), dec_len.to(d))
          for pp, d in ((p["ve"], dev), (cpu["ve"], "cpu"))]
    lanes_card_tokens = _t3_lanes(cpu["t3"], cfg.t3, ve[1], card.cpu(), n_card.cpu(), exag)

    def max_abs(a, b):
        return (a.float().cpu() - b.float()).abs().max().item()

    out = {
        "tokens": dit_token_check(card[0], z[0], n, cfg.s3tok),
        "ve_cos": cosine(ve[0], ve[1]), "ve_abs": max_abs(ve[0], ve[1]),
        "mel_abs": max_abs(gref["prompt_mel"], ref["prompt_mel"]),
        "spk_cos": cosine(gref["spk_emb"], ref["spk_emb"]),
        "spk_rel": max_abs(gref["spk_emb"], ref["spk_emb"]) / (1 + ref["spk_emb"].abs().max().item()),
        "lanes_rel": max_abs(conds.t3_cond_lanes, lanes_card_tokens)
        / (1 + lanes_card_tokens.abs().max().item()),
        "lanes_rel_cpu_tokens": max_abs(conds.t3_cond_lanes, lanes) / (1 + lanes.abs().max().item()),
        "mel_len": [int(gref["prompt_mel_len"][0]), int(ref["prompt_mel_len"][0])],
        "cpu_s": cpu_s,
    }
    print(f"  {what}, card against the CPU (f32 copy): {json.dumps(out)}; tolerances "
          f"{json.dumps(DIT_CLONE_TOL)}", flush=True)
    bad = ["tokens"] if out["tokens"]["decisive_differ"] else []
    bad += [k for k in ("ve_cos", "spk_cos") if not out[k] >= DIT_CLONE_TOL[k]]
    bad += [k for k in ("ve_abs", "mel_abs", "spk_rel", "lanes_rel")
            if not out[k] <= DIT_CLONE_TOL[k]]
    if out["mel_len"][0] != out["mel_len"][1]:
        bad.append("mel_len")
    if bad:
        raise AssertionError(f"{what}: outside CLONE_TOL: {bad}")
    return out


class WarningRecords(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


async def dit_phase(tmp: Path, out: dict) -> dict:
    """Phase 9 → the K1/K2/K3 launches of (d). (a) the default voice with a
    seeded conds.pt present: the engine warns and builds the neutral voice,
    held against the CPU; (b) dit_s3gen_call; (c) prepare_conditionals on
    CLONE_VOICE, held against the CPU; (d) 8 concurrent one-chunk requests
    at 16 slots (S3Gen must batch 2 or more jobs, K1's int8 body must run),
    then one two-chunk request per request (MAX_DECODE_SLOTS=1); (e) the
    engine's native checkpoint saved and loaded back on the card, bitwise
    equal."""
    from chatterbox_tpu_torch.runtime.checkpoint import (NATIVE_MANIFEST, load_checkpoint,
                                                         save_checkpoint)
    from chatterbox_tpu_torch.runtime.engine import neutral_inputs, reference_inputs
    from chatterbox_tpu_torch.audio.pcm import read_wav

    model_dir, native_dir = tmp / "models-dit", tmp / "models-dit-native"
    model_dir.mkdir()
    write_conds(model_dir / "conds.pt")
    os.environ.update(MODEL_PATH=str(model_dir), CHATTERBOX_S3GEN_ARCH="dit",
                      MAX_DECODE_SLOTS=str(SLOTS), CHATTERBOX_MAX_NEW_TOKENS=DIT_NEW_TOKENS)
    records = WarningRecords()
    logging.getLogger("chatterbox_tpu_torch").addHandler(records)
    try:
        engine = await start_engine()
    finally:
        logging.getLogger("chatterbox_tpu_torch").removeHandler(records)
    s3 = engine.s3gen_scheduler
    if engine.cfg.s3gen_arch != "dit" or "s3tok" not in engine.params:
        raise AssertionError("CHATTERBOX_S3GEN_ARCH=dit did not build the DiT engine")
    if engine._cfm_cache_mode() != "0" or engine._streaming() or s3._tail_infer is not None:
        raise AssertionError("the DiT engine runs a prompt cache, streaming CFM or the tail vocoder")
    if not any("conds.pt found but s3gen_arch='dit'" in m for m in records.messages):
        raise AssertionError(f"no warning for conds.pt under the DiT: {records.messages}")
    print("  (a) conds.pt present: the engine warned and built the neutral voice", flush=True)
    out["neutral_voice"] = compare_dit_conditionals(engine, engine.voice_cache["default"],
                                                    neutral_inputs(), "DiT neutral default voice")
    out["s3gen_call"] = dit_s3gen_call(engine)

    path = engine.voice_manager.get_voice_path(CLONE_VOICE)
    walls = []
    for cold in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cold:
            engine.prepare_conditionals(path)
        else:
            with profiler() as prof:
                engine.prepare_conditionals(path)
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    summed, busy, kernels, n_device = device_ms(prof, top=6)
    print(f"  (c) prepare_conditionals({CLONE_VOICE}): wall {walls[0]:.3f} s cold, {walls[1]:.3f} s "
          f"warm; warm device time {summed:.2f} ms (busy {busy:.2f} ms) over {n_device} device "
          f"activities; device ms by kernel {kernels}", flush=True)
    out["clone"] = {"prepare_wall_s": walls, "prepare_device_ms": summed, "prepare_busy_ms": busy,
                    "against_cpu": compare_dit_conditionals(
                        engine, engine.voice_cache[CLONE_VOICE],
                        reference_inputs(*read_wav(path)), f"DiT clone of {CLONE_VOICE}")}

    texts = [f"Voice {i}. {TEXTS[2 * (i % 2)]}" for i in range(8)]
    s3.max_batch_seen = 0
    reset_launches()
    t0 = time.perf_counter()
    results = await run_requests(engine, texts, "dit-batched")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    audio = report_requests(engine, results, two_chunks=False)
    print(f"  (d) {len(texts)} concurrent requests at {SLOTS} slots: {audio:.2f} s of audio in "
          f"{wall:.3f} s of wall; S3Gen max_batch_seen {s3.max_batch_seen}; launches {launches}",
          flush=True)
    if s3.max_batch_seen < 2:
        raise AssertionError("the DiT S3Gen never batched two jobs")
    if launches["decode_attention"]["int8"] == 0:
        raise AssertionError("the DiT serving path did not run K1's int8 body")
    stats = [engine.request_stats[rid] for rid, _ in results]
    out["batched"] = {"requests": len(texts), "wall_s": wall, "audio_s": audio,
                      "s3gen_max_batch": s3.max_batch_seen, "launches": launches,
                      "ttfa_s": [st["ttfa_s"] for st in stats],
                      "rtf": [st["wall_s"] * engine.sr / max(1, st["samples"]) for st in stats]}
    engine.shutdown()
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    os.environ["MAX_DECODE_SLOTS"] = "1"
    engine = await start_engine()
    reset_launches()
    results = await run_requests(engine, [TEXTS[1]], "dit-single")
    single = read_launches()
    report_requests(engine, results)
    st = engine.request_stats[results[0][0]]
    print(f"  (d) per request: launches {single}", flush=True)
    if engine.decoder is not None or single["decode_attention"]["int8"] == 0:
        raise AssertionError("the DiT per-request path did not run as asked")
    out["per_request"] = {"launches": single, "ttfa_s": st["ttfa_s"],
                          "rtf": st["wall_s"] * engine.sr / max(1, st["samples"])}
    for k, v in single.items():
        for form, n in v.items():
            launches[k][form] += n

    dtype = engine.params["t3"]["text_emb"].dtype
    t0 = time.perf_counter()
    save_checkpoint(native_dir, engine.params, engine.cfg)
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    manifest = json.loads((native_dir / NATIVE_MANIFEST).read_text())
    if manifest["s3gen_arch"] != "dit" or manifest["models"] != ["s3gen", "s3tok", "t3", "ve"]:
        raise AssertionError(f"native manifest: {manifest['s3gen_arch']}, {manifest['models']}")
    t0 = time.perf_counter()
    native = load_checkpoint(native_dir, engine.cfg, dtype, engine.device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    native_bytes = sum(f.stat().st_size for f in native_dir.glob("*.safetensors"))
    print(f"  (e) native DiT checkpoint: {native_bytes / 2**30:.2f} GiB (float32) written in "
          f"{save_s:.2f} s, read back to the card in {load_s:.2f} s", flush=True)
    out["native"] = {"bytes": native_bytes, "save_s": save_s, "load_s": load_s,
                     "round_trip": compare_params(native, engine.params,
                                                  "DiT native round trip against the engine")}
    del native
    engine.shutdown()
    return launches


# ------------------------------------------------------------ the training phase
# Phase 10 trains T3 at full width (CHATTERBOX_S3GEN_ARCH=dit: featurizing
# needs S3Tok) on a manifest of TRAIN_CLIPS clips cut from CLONE_VOICE.
TRAIN_SEED = 11
TRAIN_TEXTS = ["The port trains its decoder on one card.",
               "A short clip.",
               "Gains and cuts of one voice make a small manifest.",
               "Fifteen seconds of the same voice, louder and softer, take the long prompt branch."]
# (b) One adamw step at TRAIN_CHECK_LR on the card against the CPU: T3 at
# full width cut to 2 layers, float32, TF32 off, one batch of 2 at
# max_speech 256, the same inputs. Held: the loss and the gradient norm
# (relative), every gradient leaf within grad_rel of its largest magnitude
# plus grad_floor of the tree's largest (the CPU tests' bounds against JAX:
# float32 GEMMs over 1024-4096-wide reductions and 900 positions, summed in
# another order, should differ by ~1e-6 of a leaf's largest), and every
# parameter within param_lr · lr. Adam's first step is lr · g/(|g| + eps)
# (eps 1e-8), which moves by eps·|Δg|/g² where the sides' gradients differ
# by Δg: an element whose gradient has another sign on each side, or whose
# CPU gradient is nonzero and below uncertain_below (100 eps; rounding
# noise, as in a bias the softmax cancels), may step either way on either
# side and is held within param_lr_uncertain · lr.
TRAIN_CHECK_LR = 1e-5
TRAIN_STEP_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "grad_rel": 1e-4, "grad_floor": 1e-6,
                  "param_lr": 1e-2, "param_lr_uncertain": 2.01, "uncertain_below": 1e-6}
TRAIN_STEPS = 10        # (c): the entry point at --batch 4, the JAX script's shapes
TRAIN_FALL_LR = 1e-4    # (c): from the initial weights, the loss must fall over
TRAIN_FALL_STEPS = 8    # TRAIN_FALL_STEPS on one batch
TRAINED_NEW_TOKENS = "35"   # (d): the closing request's decode cap


def write_train_manifest(tmp: Path) -> Path:
    """A manifest of 4 clips: CLONE_VOICE as it is, two seeded cuts of it at
    seeded gains, and five seeded gains of it end to end (15 s: the long
    prompt branch)."""
    from chatterbox_tpu_torch.audio.pcm import read_wav, write_wav

    wav, sr = read_wav(str(Path(__file__).resolve().parent / "preloaded-voices" / CLONE_VOICE))
    rng = np.random.default_rng(TRAIN_SEED)
    clips = [wav]
    for _ in range(2):
        a, b = int(rng.integers(0, len(wav) // 3)), int(rng.integers(2 * len(wav) // 3, len(wav)))
        clips.append(wav[a:b] * rng.uniform(0.5, 1.0))
    clips.append(np.concatenate([wav * rng.uniform(0.5, 1.0) for _ in range(5)]))
    lines = []
    for i, (clip, text) in enumerate(zip(clips, TRAIN_TEXTS)):
        path = tmp / f"train-{i}.wav"
        write_wav(str(path), clip.astype(np.float32), sr)
        lines.append(f"{path}\t{text}\n")
    manifest = tmp / "train.tsv"
    manifest.write_text("".join(lines))
    return manifest


def train_featurize_check(engine, manifest: Path) -> tuple:
    """(a) → (the card's Examples, results): the manifest featurized on the
    card by T3FeatureExtractor; the short clip 0 and the long clip 3 held
    against the CPU's extractor over an f32 copy of the weights (DIT_CLONE_TOL:
    S3Tok's decisive digits, the VoiceEncoder's cosine and error; the text
    ids and the prompt/target split exactly)."""
    from chatterbox_tpu_torch.audio.pcm import read_wav, resample
    from chatterbox_tpu_torch.models.s3tok import s3tok_fsq
    from chatterbox_tpu_torch.training.data import T3FeatureExtractor, load_manifest

    pairs = load_manifest(str(manifest))
    extractor = T3FeatureExtractor(engine.params, engine.cfg, engine.tokenizer)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    examples = [extractor.extract(w, t) for w, t in pairs]
    wall = time.perf_counter() - t0
    cpu = {"s3tok": f32_cpu(engine.params["s3tok"]), "ve": f32_cpu(engine.params["ve"])}
    cpu_x = T3FeatureExtractor(cpu, engine.cfg, engine.tokenizer)
    P = engine.cfg.t3.speech_cond_prompt_len
    out = {"featurize_s": wall, "speech_tokens": [len(e.speech_tokens) for e in examples]}
    for i in (0, 3):
        got, want = examples[i], cpu_x.extract(*pairs[i])
        wav, sr = read_wav(pairs[i][0])
        w16 = torch.from_numpy(resample(wav, sr, 16000)[None])
        with torch.inference_mode():
            z, valid = s3tok_fsq(cpu["s3tok"], engine.cfg.s3tok, w16, torch.tensor([w16.shape[1]]))
        n = int(valid[0].sum())
        if len(got.speech_tokens) != len(want.speech_tokens) or not (
                np.array_equal(got.text_tokens, want.text_tokens)):
            raise AssertionError(f"clip {i}: the card's split or text ids differ from the CPU's")
        # the clip's tokens: the target, then the prompt's valid tokens
        tokens = np.concatenate([got.speech_tokens, got.prompt_tokens[: n - len(got.speech_tokens)]])
        spk = [torch.from_numpy(e.speaker_emb) for e in (got, want)]
        out[f"clip{i}"] = {
            "branch": "tail" if len(got.speech_tokens) > P else "half",
            "tokens": dit_token_check(torch.from_numpy(tokens).long(), z[0], n, engine.cfg.s3tok),
            "ve_cos": cosine(*spk), "ve_abs": (spk[0] - spk[1]).abs().max().item(),
            "text_ids": len(got.text_tokens)}
        r = out[f"clip{i}"]
        if r["tokens"]["decisive_differ"] or not (r["ve_cos"] >= DIT_CLONE_TOL["ve_cos"]
                                                  and r["ve_abs"] <= DIT_CLONE_TOL["ve_abs"]):
            raise AssertionError(f"clip {i}: outside DIT_CLONE_TOL: {r}")
    if out["clip3"]["branch"] != "tail" or out["clip0"]["branch"] != "half":
        raise AssertionError(f"the clips did not take both prompt branches: {out}")
    print(f"  (a) {len(examples)} clips featurized on the card in {wall:.3f} s; against the CPU "
          f"(f32 copy): {json.dumps(out)}; tolerances {json.dumps(DIT_CLONE_TOL)}", flush=True)
    return examples, out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def train_step_check(cfg, examples) -> dict:
    """(b) One adamw step, card against CPU (TRAIN_STEP_TOL)."""
    from chatterbox_tpu_torch.models.t3 import init_t3_params
    from chatterbox_tpu_torch.training import adamw, make_train_step
    from chatterbox_tpu_torch.training.data import make_batches

    t3c = cfg.t3.with_(num_layers=2)
    params = init_t3_params(t3c, torch.Generator().manual_seed(TRAIN_SEED), "cpu")
    batch = next(make_batches(examples, t3c, 2, max_speech=256, shuffle_seed=0, device="cpu"))
    sides = {}
    for dev in ("cuda", "cpu"):
        init, step = make_train_step(t3c, adamw(TRAIN_CHECK_LR))
        state = init(to_dev(params, dev))
        t0 = time.perf_counter()
        state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
        loss = float(m["loss"])
        sides[dev] = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                      "wall_s": time.perf_counter() - t0,
                      "grads": {k: x.grad.cpu() for k, x in _flat(state["params"]).items()},
                      "params": {k: x.detach().cpu() for k, x in _flat(state["params"]).items()}}
        del state
    card, cpu, tol = sides["cuda"], sides["cpu"], TRAIN_STEP_TOL
    held, bad = compare_steps(card, cpu, TRAIN_CHECK_LR)
    out = {"positions": int(batch["speech_mask"].shape[0] * (
               t3c.cond_len + batch["text_tokens"].shape[1] + batch["speech_mask"].shape[1])),
           **held, "wall_s": [card["wall_s"], cpu["wall_s"]]}
    print(f"  (b) one adamw step (lr {TRAIN_CHECK_LR}) at {t3c.num_layers}x{t3c.hidden_size}, f32, "
          f"card against CPU: {json.dumps(out)}; tolerances {json.dumps(tol)}", flush=True)
    if bad:
        raise AssertionError(f"(b) card against CPU outside TRAIN_STEP_TOL: {bad}")
    return out


def compare_steps(got: dict, want: dict, lr: float) -> tuple:
    """One adamw step's results (loss, grad_norm, and flat dicts of CPU
    tensors: grads, params after the step) against another's, under
    TRAIN_STEP_TOL → (the errors over their tolerances, the names held
    outside them)."""
    tol = TRAIN_STEP_TOL
    top = max(g.abs().max().item() for g in want["grads"].values())
    grad_err, param_err, uncertain, bad = 0.0, 0.0, 0, []
    for k, g in want["grads"].items():
        g_tol = tol["grad_rel"] * g.abs().max().item() + tol["grad_floor"] * top
        err = (got["grads"][k] - g).abs().max().item()
        grad_err = max(grad_err, err / g_tol)
        unsure = (torch.sign(got["grads"][k]) != torch.sign(g)) | (
            (g.abs() < tol["uncertain_below"]) & (g != 0))
        uncertain += int(unsure.sum())
        p_tol = lr * torch.where(unsure, tol["param_lr_uncertain"], tol["param_lr"])
        p_err = (got["params"][k] - want["params"][k]).abs()
        param_err = max(param_err, (p_err / p_tol).max().item())
        if err > g_tol or (p_err > p_tol).any():
            bad.append(k)
    if abs(got["loss"] - want["loss"]) > tol["loss_rel"] * abs(want["loss"]):
        bad.append("loss")
    if abs(got["grad_norm"] - want["grad_norm"]) > tol["grad_norm_rel"] * want["grad_norm"]:
        bad.append("grad_norm")
    held = {"loss": [got["loss"], want["loss"]], "grad_norm": [got["grad_norm"], want["grad_norm"]],
            "grad_err_over_tol": grad_err, "param_err_over_tol": param_err,
            "uncertain_elements": uncertain,
            "elements": int(sum(g.numel() for g in want["grads"].values())),
            "leaves": len(want["grads"])}
    return held, bad


def timed_steps(cfg, params, batch, remat: bool, lr: float = 1e-5, n: int = 3) -> dict:
    """``n`` adamw steps on one batch from a fresh state (the first builds
    Adam's moments; the last runs under the profiler): each step's device
    ms (CUDA events) and host wall, the peak memory over them, the share of
    the elements the first step changed, and the last step's device time
    by kernel."""
    from chatterbox_tpu_torch.training import adamw, make_train_step

    init, step = make_train_step(cfg, adamw(lr), remat=remat)
    gc.collect()
    torch.cuda.empty_cache()
    state = init(params)
    before = [x.detach().clone() for x in state["leaves"]]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = {"remat": remat, "device_ms": [], "wall_ms": [], "loss": []}
    for i in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if i == n - 1:
            with profiler() as prof:
                e0.record()
                state, m = step(state, batch)
                e1.record()
                torch.cuda.synchronize()
        else:
            e0.record()
            state, m = step(state, batch)
            e1.record()
            torch.cuda.synchronize()
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["device_ms"].append(e0.elapsed_time(e1))
        out["loss"].append(float(m["loss"]))
        if i == 0:
            changed = sum(int((x.detach() != b).sum()) for x, b in zip(state["leaves"], before))
            out["changed_share"] = changed / sum(b.numel() for b in before)
            del before
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["state_bytes"] = base
    summed, busy, kernels, n_device = device_ms(prof, top=8)
    out.update(profiled_ms=summed, profiled_busy_ms=busy, kernels=kernels, activities=n_device)
    del state
    return out


def train_entry_point(tmp: Path, manifest: Path, t3_init: dict, out: dict) -> tuple:
    """(c) → (the trained engine, the checkpoint's directory):
    train_t3.main at --batch 4 --steps TRAIN_STEPS (bf16, max_speech 1024,
    text 160), whose loss must fall; then, on its trained T3 and one of its
    batches, three timed steps with recomputation and three without; then
    TRAIN_FALL_STEPS steps at TRAIN_FALL_LR on that batch from ``t3_init``
    (the initial weights main started from), whose loss must fall."""
    from chatterbox_tpu_torch.training import adamw, make_train_step, train_t3
    from chatterbox_tpu_torch.training.data import make_batches

    ckpt, empty = tmp / "trained", tmp / "models-train"
    empty.mkdir()
    os.environ.update(MODEL_PATH=str(empty), CHATTERBOX_S3GEN_ARCH="dit")
    t0 = time.perf_counter()
    res = train_t3.main([str(manifest), "--out", str(ckpt), "--batch", "4",
                         "--steps", str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine, cfg = res["engine"], res["engine"].cfg.t3
    batch = next(make_batches(res["examples"], cfg, 4, shuffle_seed=0, device=engine.device))
    positions = batch["speech_tokens"].shape[0] * (cfg.cond_len + cfg.max_text_tokens
                                                   + batch["speech_tokens"].shape[1])
    targets = int(batch["speech_mask"].sum())
    steps = [timed_steps(cfg, engine.params["t3"], batch, remat) for remat in (True, False)]
    init, step = make_train_step(cfg, adamw(TRAIN_FALL_LR))
    state, fall = init(t3_init), []
    for _ in range(TRAIN_FALL_STEPS):
        state, m = step(state, batch)
        fall.append(float(m["loss"]))
    del state
    host = sorted(res["step_s"][1:])
    ms = steps[0]["device_ms"][1]
    out.update(entry_wall_s=wall, losses=res["losses"], step_wall_ms=[s * 1e3 for s in res["step_s"]],
               positions_per_step=positions, target_tokens_per_step=targets,
               steps=steps, fall_lr=TRAIN_FALL_LR, fall_losses=fall,
               positions_per_s=positions / (ms / 1e3), target_tokens_per_s=targets / (ms / 1e3))
    print(f"  (c) train_t3.main --batch 4 --steps {TRAIN_STEPS}: {wall:.2f} s in all; losses "
          f"{[round(x, 4) for x in res['losses']]}; host wall per step (steps 2-{TRAIN_STEPS}) "
          f"median {1e3 * host[len(host) // 2]:.1f} ms, first {1e3 * res['step_s'][0]:.1f} ms",
          flush=True)
    for r in steps:
        print(f"  (c) remat={r['remat']}: device ms per step {[round(x, 2) for x in r['device_ms']]}, "
              f"host wall ms {[round(x, 2) for x in r['wall_ms']]}; peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB allocated ({r['state_bytes'] / 2**30:.2f} GiB "
              f"before the first step); the first step changed {100 * r['changed_share']:.3f} % "
              f"of the elements at lr 1e-5; last step profiled {r['profiled_ms']:.1f} ms over "
              f"{r['activities']} device activities, by kernel {r['kernels']}", flush=True)
    print(f"  (c) {positions} positions ({targets} target tokens) per step: "
          f"{out['positions_per_s']:.0f} positions/s, {out['target_tokens_per_s']:.0f} target "
          f"tokens/s with recomputation; at lr {TRAIN_FALL_LR} on one batch from the initial "
          f"weights the loss went "
          f"{[round(x, 4) for x in fall]}", flush=True)
    if not all(np.isfinite(res["losses"])) or len(res["losses"]) != TRAIN_STEPS or not (
            res["losses"][-1] < res["losses"][0]):
        raise AssertionError(f"(c) the entry point's losses: {res['losses']}")
    if not fall[-1] < fall[0]:
        raise AssertionError(f"(c) the loss did not fall at lr {TRAIN_FALL_LR}: {fall}")
    if not steps[0]["peak_bytes"] < steps[1]["peak_bytes"]:
        raise AssertionError("(c) recomputation did not lower the peak memory")
    return engine, ckpt


async def train_to_serve(trained, ckpt: Path, out: dict) -> dict:
    """(d) An engine booted from the trained checkpoint: its T3 leaves
    bitwise the trained ones, then one one-chunk request per request at a
    TRAINED_NEW_TOKENS cap (WAV checked, K1's int8 body launched)."""
    os.environ.update(MODEL_PATH=str(ckpt), MAX_DECODE_SLOTS="1",
                      CHATTERBOX_MAX_NEW_TOKENS=TRAINED_NEW_TOKENS)
    engine = await start_engine()
    out["leaves"] = compare_params(engine.params["t3"], trained.params["t3"],
                                   "the served checkpoint's T3 against the trained leaves")
    results = await run_requests(engine, [TEXTS[0]], "trained")
    launches = read_launches()
    audio = report_requests(engine, results, two_chunks=False)
    st = engine.request_stats[results[0][0]]
    out["request"] = {"audio_s": audio, "ttfa_s": st["ttfa_s"], "tokens": st["t3_tokens"]}
    print(f"  (d) one request from the trained checkpoint: {audio:.2f} s of audio; launches since "
          f"(c) began {launches}", flush=True)
    if launches["decode_attention"]["int8"] == 0:
        raise AssertionError("(d) serving the trained checkpoint did not run K1's int8 body")
    engine.shutdown()
    return launches


def training_phase(tmp: Path, out: dict) -> dict:
    """Phase 10 → the kernels' launches from (c)'s start to (d)'s end."""
    from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine

    os.environ.update(MODEL_PATH=str(tmp / "models-train-a"), CHATTERBOX_S3GEN_ARCH="dit",
                      MAX_DECODE_SLOTS="1")
    (tmp / "models-train-a").mkdir()
    manifest = write_train_manifest(tmp)
    cfg = EngineConfig.full()
    print(f"  config: T3 {cfg.t3.num_layers}x{cfg.t3.hidden_size} H={cfg.t3.num_heads} "
          f"FFN {cfg.t3.intermediate_size}, S3Tok {cfg.s3tok.dim}x{cfg.s3tok.layers}, "
          f"params {cfg.param_dtype}", flush=True)
    engine = TTSEngine(cfg, seed=0)
    engine._init_models()
    examples, out["featurize"] = train_featurize_check(engine, manifest)
    t3_init = engine.params["t3"]   # the random init train_t3.main starts from (seed 0)
    engine.shutdown()
    del engine
    out["step_check"] = train_step_check(cfg, examples)
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    out["entry_point"] = {}
    trained, ckpt = train_entry_point(tmp, manifest, t3_init, out["entry_point"])
    del t3_init
    out["serve"] = {}
    launches = asyncio.run(train_to_serve(trained, ckpt, out["serve"]))
    trained.shutdown()
    return launches


# ------------------------------------------------ the kernels' switches, the bench
# Phase 11: (a) CHATTERBOX_PALLAS=0 and CHATTERBOX_FLASH=0 make K1's and
# K2's CUDA calls raise; serving without the kernels happens only inside
# the bench (--plain-attention); (b) the bench's three entry points in
# subprocesses, as an operator runs them, at a decode cap of
# BENCH_NEW_TOKENS.
KNOBS = ("CHATTERBOX_PALLAS", "CHATTERBOX_FLASH")
BENCH_NEW_TOKENS = "35"


def check_knobs_refuse() -> None:
    """With each knob at 0, its kernel's wrapper raises on CUDA tensors,
    naming the knob, and launches nothing."""
    from chatterbox_tpu_torch.ops import decode_attention as da
    from chatterbox_tpu_torch.ops import flash_mha as fm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    tensors, scales = decode_inputs(g, 2, 16, 16, 256, 64, torch.bfloat16, "int8")
    start = torch.tensor([0, 3], dtype=torch.int32, device=dev)
    pos = torch.tensor([100, 200], dtype=torch.int32, device=dev)
    q = torch.randn((2, 8, 40, 64), generator=g, device=dev)
    valid = torch.ones((2, 40), dtype=torch.bool, device=dev)
    calls = {"CHATTERBOX_PALLAS": lambda: da.decode_attention(*tensors, start, pos, *scales),
             "CHATTERBOX_FLASH": lambda: fm.flash_mha(q, q, q, valid)}
    reset_launches()
    for knob, call in calls.items():
        os.environ[knob] = "0"
        try:
            call()
        except RuntimeError as e:
            if f"{knob}='0'" not in str(e):
                raise
            print(f"  {knob}=0 refused: {e}", flush=True)
        else:
            raise AssertionError(f"{knob}=0: the wrapper ran a CUDA call")
        finally:
            del os.environ[knob]
    if any(any(c.values()) for c in read_launches().values()):
        raise AssertionError(f"a refused call launched a kernel: {read_launches()}")


async def kernels_off_phase(out: dict) -> dict:
    """(a) ``check_knobs_refuse``; then on the ref arch at 16 slots: the
    default voice's prompt cache rebuilt and 4 one-chunk requests, first
    with the plain versions swapped in (``plain_attention``: no launch of
    any K1 or K2 body or form), then on the kernels (K1's int8 body and
    both K2 forms launch) → the launches of each run."""
    check_knobs_refuse()
    engine = await start_engine()
    texts = [TEXTS[0], TEXTS[2], f"Off. {TEXTS[0]}", f"Off. {TEXTS[2]}"]
    runs = {}
    try:
        for label, swap in (("off", plain_attention), ("on", contextlib.nullcontext)):
            reset_launches()
            with swap():
                build_voice_cache(engine)   # K2's self form runs in the prompt prefill
                t0 = time.perf_counter()
                results = await run_requests(engine, texts, f"kernels-{label}")
                wall = time.perf_counter() - t0
            launches = read_launches()
            audio = report_requests(engine, results, two_chunks=False)
            print(f"  kernels {label}: {audio:.2f} s of audio in {wall:.3f} s; launches {launches}",
                  flush=True)
            runs[label] = {"launches": launches, "wall_s": wall, "audio_s": audio}
    finally:
        engine.shutdown()
    off = runs["off"]["launches"]
    if any(off["decode_attention"].values()) or any(off["flash_mha"].values()):
        raise AssertionError(f"K1 or K2 launched with the plain versions swapped in: {off}")
    require_main_path(runs["on"]["launches"], "serving on the kernels")
    out.update({label: {k: v for k, v in r.items() if k != "launches"} for label, r in runs.items()})
    return {label: r["launches"] for label, r in runs.items()}


def finite_positive(row: dict, keys, what: str) -> None:
    for k in keys:
        v = row[k]
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            raise AssertionError(f"{what}: {k} = {v!r}")


def check_bench_rows(script: str, rows: list) -> None:
    """The JSON lines of one entry point: TTFA and RTF finite and positive,
    the profiled wave's busy share in (0, 1], bench's last line in
    bench.py's shape with the sweep's MEASURED value."""
    if script == "serve_bench":
        waves = [r for r in rows if r["mode"] in ("capacity_wave", "profiled")]
        if not waves or not any(r["mode"] == "capacity" for r in rows) \
                or not any(r["mode"] == "profiled" for r in rows):
            raise AssertionError("serve_bench: no capacity waves, capacity row or profiled wave")
        for r in waves:
            finite_positive(r, ("ttfa_p50_ms", "ttfa_p99_ms", "rtf_p50", "rtf_max", "aggregate_x"),
                            f"serve_bench {r['mode']} {r['streams']}")
            if not 0 <= r["realtime_streams"] <= r["streams"]:
                raise AssertionError(f"serve_bench: {r}")
        busy = next(r for r in rows if r["mode"] == "profiled")["busy_share"]
        if not 0 < busy <= 1:
            raise AssertionError(f"serve_bench: busy share {busy}")
    elif script == "bench":
        last = rows[-1]
        if set(last) != {"metric", "value", "unit", "vs_baseline"} \
                or "MEASURED" not in last["unit"] or last["value"] < 0:
            raise AssertionError(f"bench's last line: {last}")
        for k in ("prefill", "slice_1", f"slice_{SLOTS}", "s3gen_B1", "s3gen_B4"):
            finite_positive(rows[-2][k], ("host_ms", "event_ms", "device_busy_ms"), f"bench {k}")
    else:
        finite_positive(rows[-1], ("ttfa_audio_s", "wall_s", "audio_s"), "ttfa_trace")


def bench_phase(tmp: Path, out: dict) -> None:
    """(b) serve_bench --capacity (full overlap) and ttfa_trace side by side,
    then bench, each in its own process on a fresh engine at a
    BENCH_NEW_TOKENS cap: each exits with 0, every JSON line parses, and
    ``check_bench_rows`` holds."""
    env = {**os.environ, "CHATTERBOX_MAX_NEW_TOKENS": BENCH_NEW_TOKENS, "BENCH_S3_BATCH": "4",
           "MAX_DECODE_SLOTS": str(SLOTS)}
    sweep = tmp / "torch_serve_bench.json"
    steps = [
        {"serve_bench": ["--capacity", "--streams-list", "1,4", "--warmup-waves", "1",
                         "--overlap", "full", "--out", str(sweep)],
         "ttfa_trace": ["--warmups", "1", "--out", str(tmp / "torch_ttfa_trace.json")]},
        {"bench": ["--out", str(sweep)]},   # reads the sweep's measured value
    ]
    for step in steps:
        t0 = time.perf_counter()
        procs = {script: subprocess.Popen(
            [sys.executable, "-m", f"chatterbox_tpu_torch.scripts.{script}", *args], env=env,
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for script, args in step.items()}
        for script, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"{script} exited {proc.returncode}:\n{stderr[-4000:]}")
            rows = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
            print(f"  {script} (done {wall:.1f} s into its step): "
                  + "\n    ".join(json.dumps(r) for r in rows), flush=True)
            out[script] = {"wall_s": wall, "last_row": {k: v for k, v in rows[-1].items()
                                                         if k not in ("stages", "top_kernels")}}
            check_bench_rows(script, rows)


# ------------------------------------------------ tensor- and data-parallel T3
# Phase 12: parallel/ on the one card, two ranks over gloo (NCCL refuses two
# ranks on one device). Gloo reduces CUDA tensors through the host, so no
# time here says anything of NVLink or of a tensor-parallel speed-up: the
# phase checks that the sharded functions give the unsharded results.
# (a) The full-width T3 (int8 KV) at TP_LANES lanes: a prefill and one
# TP_STEPS-step decode slice at tp = 2, against the same on one unsharded
# rank; K1 runs at H/tp = 8 heads per rank, 30 layers x TP_STEPS launches
# each (counted in the bf16 run, as served). Both ranks take the same
# tokens (held, both dtypes). Against the unsharded run: with float32
# weights the tokens are equal and the hidden state of one more step after
# the slice (the whole cache's history behind it) is within
# TP_F32_HIDDEN_TOL (held). With bf16 weights the two runs round their
# products to bf16 from float32 sums taken in another order (cuBLAS picks
# its kernel by shape, and the row-parallel partials are summed across
# ranks), so a near-tie of the sampler's scores can flip a token and the
# request then diverges: the tokens that differ and each request's first
# divergence are reported, not held. So is a control with no tensor
# parallelism: the unsharded bf16 model serving the same 16 lanes inside a
# batch of 32 (the lanes twice; cuBLAS picks other kernels for 32 rows)
# against the 16-lane run.
# (b) One adamw step at phase 10's shape (B = 4 x 1218 positions: text 160,
# speech 1024), full width cut to TP_TRAIN_LAYERS layers, float32, under
# dp = 1 x tp = 2 and dp = 2 x tp = 1, each held to the single-rank step on
# the same inputs at TRAIN_STEP_TOL (``compare_steps``). The rows' target
# counts differ, so a per-replica loss normaliser would show.
# (c) Each rank's wall for each, and the share of a step in collectives (a
# second step with every torch.distributed.all_reduce synchronised and
# timed).
TP_LANES = 16
TP_STEPS = REDUCED_NEW_TOKENS
TP_F32_HIDDEN_TOL = 1e-3       # float32 summation order over 30 layers, |h| < 8
TP_TRAIN_LAYERS = 4
TP_TRAIN_BATCH = (4, 160, 1024)   # B, text, speech
TP_SEED = 12


def tp_decode_inputs(cfg, dev) -> dict:
    rng = np.random.default_rng(TP_SEED)
    L, T = TP_LANES, min(64, cfg.max_text_tokens)
    return {"speaker_emb": torch.from_numpy(rng.standard_normal(
                (L, cfg.speaker_embed_dim)).astype(np.float32)).to(dev),
            "prompt_tokens": torch.from_numpy(rng.integers(
                0, cfg.num_speech_codes, (L, cfg.speech_cond_prompt_len))).to(dev),
            "emotion": torch.full((L,), 0.5, device=dev),
            "text_tokens": torch.from_numpy(rng.integers(1, cfg.text_vocab_size, (L, T))).to(dev),
            "text_len": torch.from_numpy(rng.integers(8, T + 1, L).astype(np.int32)).to(dev),
            "seeds": [int(x) for x in rng.integers(0, 2**31, L // 2)]}


def tp_decode(params, cfg, x, group) -> dict:
    """Prefill, one TP_STEPS slice, then one more step's hidden state."""
    from chatterbox_tpu_torch.models.t3 import model as tm
    from chatterbox_tpu_torch.ops import decode_attention as da

    dev = x["text_tokens"].device
    with torch.inference_mode():
        cond = tm.cond_embeddings(params, cfg, x["speaker_emb"], x["prompt_tokens"],
                                  x["emotion"]).to(params["text_emb"].dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = tm.t3_prefill(params, cfg, cond, x["text_tokens"], x["text_len"], tp_group=group)
        state = tm.make_decode_state(cfg, x["seeds"], 0.8, 0.95, 0.5, 1.2, dev)
        da.reset_launches()
        tokens = tm.t3_decode_slice(params, cfg, cache, state, TP_STEPS, tp_group=group)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = da.launches["int8"]
        lanes = state["last_token"].repeat_interleave(2)
        step = state["step"].repeat_interleave(2).clamp(0, cfg.max_speech_tokens + 1)
        h = (params["speech_emb"][lanes] + params["speech_pos"][step])[:, None]
        hidden = tm._backbone_decode_step(params, cfg, h, cache, None, group)[:, 0]
    return {"tokens": tokens.cpu(), "hidden": hidden.float().cpu(), "wall_s": wall,
            "k1_launches": launches, "kv_heads": cache["k"].shape[2],
            "q_heads": tm._local_heads(params, cfg)[0]}


def tp_train_batch(cfg, dev) -> dict:
    rng = np.random.default_rng(TP_SEED + 1)
    B, T, S = TP_TRAIN_BATCH
    s_len = (S * np.array([1.0, 0.68, 0.29, 0.12])).astype(int)   # unequal per replica
    t_len = rng.integers(20, T + 1, B).astype(np.int32)
    text = rng.integers(1, cfg.text_vocab_size, (B, T)).astype(np.int32)
    text[np.arange(T)[None, :] >= t_len[:, None]] = 0
    mask = (np.arange(S)[None, :] < s_len[:, None]).astype(np.float32)
    speech = rng.integers(0, cfg.num_speech_codes, (B, S)).astype(np.int32) * (mask > 0)
    host = {"speaker_emb": rng.standard_normal((B, cfg.speaker_embed_dim)).astype(np.float32),
            "prompt_tokens": rng.integers(0, cfg.num_speech_codes,
                                          (B, cfg.speech_cond_prompt_len)).astype(np.int32),
            "emotion": np.full((B,), 0.5, np.float32), "text_tokens": text, "text_len": t_len,
            "speech_tokens": speech.astype(np.int32), "speech_mask": mask}
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


class TimedAllReduce:
    """Within the block every torch.distributed.all_reduce is synchronised
    and its host wall summed (``seconds``, ``calls``)."""

    def __enter__(self):
        import torch.distributed as dist

        self.orig, self.seconds, self.calls = dist.all_reduce, 0.0, 0

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(*a, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce = self.orig


def tp_step(cfg, params, batch, mesh) -> dict:
    """One adamw step at TRAIN_CHECK_LR (``mesh`` None: one rank) → loss,
    grad_norm, the full gradients and parameters after it (flat, CPU), the
    step's wall; then a second step with the all-reduces timed."""
    from chatterbox_tpu_torch.parallel import unshard_params
    from chatterbox_tpu_torch.parallel.sharding import _map_leaves
    from chatterbox_tpu_torch.training import adamw, make_train_step

    init, step = make_train_step(cfg, adamw(TRAIN_CHECK_LR), mesh=mesh)
    state = init(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "wall_s": time.perf_counter() - t0}
    grads = _map_leaves(state["params"], lambda path, p: p.grad)
    trained = state["params"]
    if mesh is not None:
        grads, trained = unshard_params(grads, mesh), unshard_params(trained, mesh)
    # copies: the timed step below updates the parameters in place
    out["grads"] = {k: v.detach().cpu().clone() for k, v in _flat(grads).items()}
    out["params"] = {k: v.detach().cpu().clone() for k, v in _flat(trained).items()}
    with TimedAllReduce() as timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out.update(timed_wall_s=wall, all_reduce_s=timer.seconds, all_reduces=timer.calls,
               collective_share=timer.seconds / wall)
    return out


def parallel_rank(rank) -> dict:
    """Phase 12 in one of the two ranks (``parallel.launch``'s function):
    (a) and (b); rank 0 also runs the unsharded references and compares."""
    from chatterbox_tpu_torch.models.t3 import init_t3_params
    from chatterbox_tpu_torch.ops import _build
    from chatterbox_tpu_torch.parallel import make_mesh, shard_params, tp_group
    from chatterbox_tpu_torch.parallel.sharding import _map_leaves
    from chatterbox_tpu_torch.runtime.engine import EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    dev = rank.device
    out = {"rank": rank.rank, "backend": rank.backend, "device": str(dev), "decode": {},
           "tokens": {}}
    # (a) serving's functions at tp = 2, in bf16 (as served) and in float32
    cfg = EngineConfig.full().t3
    mesh_tp = make_mesh(1, 2, rank.devices)
    x = tp_decode_inputs(cfg, dev)
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        full = init_t3_params(cfg, torch.Generator(device=dev).manual_seed(TP_SEED), dev, dtype)
        sharded = tp_decode(shard_params(full, mesh_tp, cfg), cfg, x, tp_group(mesh_tp))
        got = out["decode"][name] = {k: sharded[k] for k in ("wall_s", "k1_launches", "kv_heads",
                                                             "q_heads")}
        if rank.rank == 0:
            ref = tp_decode(full, cfg, x, None)
            differ = sharded["tokens"] != ref["tokens"]
            first = [int(row.nonzero()[0]) if row.any() else None for row in differ]
            got.update(
                unsharded_wall_s=ref["wall_s"], unsharded_k1_launches=ref["k1_launches"],
                tokens_equal=bool(torch.equal(sharded["tokens"], ref["tokens"])),
                tokens_differ=int(differ.sum()), tokens=int(ref["tokens"].numel()),
                first_divergence=first,
                hidden_max_abs=(sharded["hidden"] - ref["hidden"]).abs().max().item(),
                hidden_max=ref["hidden"].abs().max().item())
            if dtype == torch.bfloat16:
                twice = {k: v + v if k == "seeds" else torch.cat([v, v]) for k, v in x.items()}
                wide = tp_decode(full, cfg, twice, None)["tokens"][: TP_LANES // 2]
                differ = wide != ref["tokens"]
                got["control_32_lanes"] = {
                    "tokens_differ": int(differ.sum()),
                    "first_divergence": [int(row.nonzero()[0]) if row.any() else None
                                         for row in differ]}
        out["tokens"][name] = sharded["tokens"]
        del full, sharded
        torch.cuda.empty_cache()
    # (b) one training step per mesh
    t3c = cfg.with_(num_layers=TP_TRAIN_LAYERS)
    params = init_t3_params(t3c, torch.Generator().manual_seed(TRAIN_SEED), "cpu")
    params = _map_leaves(params, lambda path, t: t.to(dev))
    batch = tp_train_batch(t3c, dev)
    steps = {f"dp{dp}_tp{tp}": tp_step(t3c, params, batch, make_mesh(dp, tp, rank.devices))
             for dp, tp in ((1, 2), (2, 1))}
    keep = ("loss", "grad_norm", "wall_s", "timed_wall_s", "all_reduce_s", "all_reduces",
            "collective_share")
    out["train"] = {k: {f: r[f] for f in keep} for k, r in steps.items()}
    if rank.rank == 0:
        single = tp_step(t3c, params, batch, None)
        out["train"]["single"] = {f: single[f] for f in ("loss", "grad_norm", "wall_s")}
        for k, r in steps.items():
            held, bad = compare_steps(r, single, TRAIN_CHECK_LR)
            out["train"][k].update(held=held, outside_tol=bad)
        out["train"]["positions"] = int(batch["speech_mask"].shape[0] * (
            t3c.cond_len + batch["text_tokens"].shape[1] + batch["speech_mask"].shape[1]))
        out["train"]["target_tokens"] = int(batch["speech_mask"].sum())
    return out


def parallel_phase(out: dict) -> dict:
    """Phase 12 → K1's launches in each rank's sharded slice."""
    from chatterbox_tpu_torch.parallel import launch

    ranks = launch(parallel_rank, ["cuda:0", "cuda:0"], timeout_s=600.0)
    r0 = ranks[0]
    dec, train = r0["decode"]["bfloat16"], r0["train"]
    f32 = r0["decode"]["float32"]
    per_rank = [r["decode"]["bfloat16"]["k1_launches"] for r in ranks]
    out.update(backend=r0["backend"],
               decode={"rank0": r0["decode"], "rank1": ranks[1]["decode"]},
               train={"rank0": train, "rank1": ranks[1]["train"]}, k1_launches_per_rank=per_rank)
    print(f"  backend {r0['backend']}: 2 ranks on cuda:0 (gloo reduces CUDA tensors through "
          "the host; nothing here measures NVLink, and no time below is a tensor-parallel "
          "speed figure)", flush=True)
    for name, d in r0["decode"].items():
        print(f"  (a) T3 30x1024 {name}, int8 KV, {TP_LANES} lanes, tp=2: prefill + {TP_STEPS} "
              f"steps {[round(r['decode'][name]['wall_s'], 3) for r in ranks]} s per rank, "
              f"unsharded {d['unsharded_wall_s']:.3f} s; K1 at {d['q_heads']} query / "
              f"{d['kv_heads']} kv heads per rank, launches per rank "
              f"{[r['decode'][name]['k1_launches'] for r in ranks]}; the ranks' tokens equal "
              f"{all(torch.equal(r['tokens'][name], r0['tokens'][name]) for r in ranks)}; equal "
              f"to the unsharded run {d['tokens_equal']} ({d['tokens_differ']} of {d['tokens']} "
              f"differ; first divergence per request {d['first_divergence']}); the next step's "
              f"hidden max abs error {d['hidden_max_abs']:.4g} (|h| max {d['hidden_max']:.3g})"
              + (f"; control without tensor parallelism, the unsharded run's lanes inside a batch "
                 f"of 32 against it: {json.dumps(d['control_32_lanes'])}"
                 if "control_32_lanes" in d else ""), flush=True)
    for k in ("dp1_tp2", "dp2_tp1"):
        t = train[k]
        print(f"  (b) {k}: one adamw step at {TP_TRAIN_LAYERS}x1024 f32, B=4 x "
              f"{train['positions'] // 4} positions ({train['target_tokens']} targets), against "
              f"one rank: {json.dumps(t['held'])}; outside tolerance {t['outside_tol']}", flush=True)
        print(f"  (c) {k}: step wall per rank {[round(r['train'][k]['wall_s'], 3) for r in ranks]} s "
              f"(one rank alone {train['single']['wall_s']:.3f} s); with every all_reduce "
              f"synchronised: {[round(r['train'][k]['timed_wall_s'], 3) for r in ranks]} s, of it "
              f"in {[r['train'][k]['all_reduces'] for r in ranks]} all_reduces "
              f"{[round(r['train'][k]['all_reduce_s'], 3) for r in ranks]} s, share "
              f"{[round(r['train'][k]['collective_share'], 3) for r in ranks]}", flush=True)
    bad = []
    if r0["backend"] != "gloo":
        bad.append(f"backend {r0['backend']}")
    for name in ("bfloat16", "float32"):
        if not all(torch.equal(r["tokens"][name], r0["tokens"][name]) for r in ranks):
            bad.append(f"(a) {name}: the ranks' tokens differ")
    if not f32["tokens_equal"]:
        bad.append("(a) float32: tokens against the unsharded run")
    if not f32["hidden_max_abs"] <= TP_F32_HIDDEN_TOL:
        bad.append("(a) float32: hidden state")
    if per_rank != [30 * TP_STEPS] * 2 or dec["q_heads"] != 8 or dec["kv_heads"] != 8:
        bad.append(f"(a) K1 launches {per_rank} at {dec['q_heads']} heads")
    for k in ("dp1_tp2", "dp2_tp1"):
        if train[k]["outside_tol"]:
            bad.append(f"(b) {k}: {train[k]['outside_tol']}")
        if not all(r["train"][k]["loss"] == train[k]["loss"] for r in ranks):
            bad.append(f"(b) {k}: the ranks' losses differ")
    if bad:
        raise AssertionError(f"phase 12: {bad}")
    return {"per_rank": per_rank, "heads_per_rank": dec["q_heads"]}


# ------------------------------------------------- tensor-parallel serving
# Phase 13 serves the main path under CHATTERBOX_TP=2: EngineConfig.full()
# (ref arch, int8 KV, random weights from the engine's seed, the seeded
# conds.pt), MAX_DECODE_SLOTS=16 with the prompt cache and streaming CFM,
# rank 0 and one follower process on cuda:0 over gloo (NCCL refuses two
# ranks on one device), so no wall below is a tensor-parallel speed figure:
# every collective goes through the host. Requests decode at most
# TP_SERVE_NEW_TOKENS per chunk.
TP_SERVE_NEW_TOKENS = "35"
# one S3Gen-ref call at tp = 2 against tp = 1 on the same tokens and noise,
# with the voice's prompt cache (K2's context form at 4 heads per rank),
# float32 weights: tests/test_parallel_s3gen.py's tolerances (the excitation
# is tanh-bounded; the waveform takes float32 reassociation in the sharded
# products through the vocoder), and the mel within float32 summation order
# relative to its peak. HiFT is replicated and reads the sharded flow's mel.
# At full width its random init is chaotic: Snake's random alphas near 0
# and convs drawn at 1/sqrt(Cin) whatever their kernel width grow the
# activations to ~1e10, and a 2e-6 change of the mel moves the clipped
# waveform by 1.98 (a CPU rehearsal at this config: correlation 0.32, as on
# the card). So for this call both engines' HiFT is conditioned alike:
# Snake's alphas at 1, every conv at fan-in Cin·K, the output conv scaled
# by TP_HIFT_POST_SCALE with its log-magnitude lowered by
# TP_HIFT_LOGMAG_SHIFT (in the rehearsal: peak 0.034, nothing clipped, a
# 2e-6 mel change within 1.6e-7 of waveform).
TP_S3GEN_TOL = {"source": 1e-5, "wav": 2e-2, "corr": 0.999, "mel_rel": 1e-4}
TP_S3GEN_JOBS, TP_S3GEN_TOKENS = 2, 64
TP_HIFT_POST_SCALE, TP_HIFT_LOGMAG_SHIFT = 0.1, 2.0


@contextlib.contextmanager
def spy_tokens(engine):
    """Record, per request id, every slice's tokens that the engine's T3
    producer hands its S3Gen producer, while the block runs → the record."""
    out: dict = {}
    producer = engine._s3gen_producer

    class Spy:
        def __init__(self, q, slices):
            self.q, self.slices = q, slices

        async def get(self):
            item = await self.q.get()
            if item is not None:
                self.slices.append(np.asarray(item["tokens"]).tolist())
            return item

    engine._s3gen_producer = lambda token_q, *a, **kw: producer(
        Spy(token_q, out.setdefault(a[8], [])), *a, **kw)
    try:
        yield out
    finally:
        del engine._s3gen_producer


@contextlib.contextmanager
def conditioned_hift(engine):
    """The engine's HiFT conditioned (see TP_S3GEN_TOL) while the block
    runs."""
    s3 = engine.params["s3gen"]
    hift = s3["mel2wav"]

    def conv(c, scale=1.0):   # [Cout, Cin, K], or [Cin, Cout, K] for ups
        return {**c, "w": c["w"] * (scale / math.sqrt(c["w"].shape[-1]))}

    def resblock(r):
        return {**r, "convs1": [conv(c) for c in r["convs1"]],
                "convs2": [conv(c) for c in r["convs2"]],
                "alpha1": [torch.ones_like(a) for a in r["alpha1"]],
                "alpha2": [torch.ones_like(a) for a in r["alpha2"]]}

    post = conv(hift["conv_post"], TP_HIFT_POST_SCALE)
    shift = torch.zeros_like(post["b"])
    shift[: engine.cfg.s3gen_ref.hift.istft_n_fft // 2 + 1] = TP_HIFT_LOGMAG_SHIFT
    s3["mel2wav"] = {**hift, "conv_pre": conv(hift["conv_pre"]),
                     "ups": [conv(u) for u in hift["ups"]],
                     "source_downs": [conv(u) for u in hift["source_downs"]],
                     "resblocks": [resblock(r) for r in hift["resblocks"]],
                     "source_resblocks": [resblock(r) for r in hift["source_resblocks"]],
                     "conv_post": {"w": post["w"], "b": post["b"] * TP_HIFT_POST_SCALE - shift}}
    try:
        yield
    finally:
        s3["mel2wav"] = hift


async def tp_start(tp: int, dtype: str):
    """An EngineConfig.full() engine at CHATTERBOX_TP=tp with ``dtype``
    weights (tp > 1: ranks on cuda:0) → (the engine, its ainit wall)."""
    from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine

    os.environ["CHATTERBOX_TP"] = str(tp)
    try:
        t0 = time.perf_counter()
        engine = TTSEngine(EngineConfig.full(dtype), seed=0,
                           devices=["cuda:0"] * tp if tp > 1 else None)
        await engine.ainit()
        torch.cuda.synchronize()
    finally:
        del os.environ["CHATTERBOX_TP"]
    return engine, time.perf_counter() - t0


async def tp_serve(engine, texts, label: str) -> dict:
    """Serve ``texts`` concurrently (request ids tp-0 …, the same on every
    engine, so the same sampling seeds); every WAV checked → {"tokens": per
    request, "samples": per request, "wall_s"}."""
    from chatterbox_tpu_torch.runtime.cancellation import CancellationToken

    async def one(i, text):
        data = b""
        async for chunk in engine.stream(text=text, request_id=f"tp-{i}",
                                         cancellation_token=CancellationToken(), **REQUEST):
            data += chunk
        return f"tp-{i}", data

    with spy_tokens(engine) as spy:
        t0 = time.perf_counter()
        results = await asyncio.gather(*[one(i, text) for i, text in enumerate(texts)])
        wall = time.perf_counter() - t0
    audio = report_requests(engine, results, two_chunks=False)
    print(f"  {label}: {len(texts)} requests, {audio:.2f} s of audio in {wall:.3f} s", flush=True)
    return {"tokens": {rid: spy[rid] for rid, _ in results},
            "samples": {rid: (len(data) - 44) // 2 for rid, data in results}, "wall_s": wall}


def token_diff(a: dict, b: dict) -> dict:
    """Two runs' tokens per request → how many differ, and each request's
    first differing position."""
    n = differ = 0
    first = {}
    for rid in b["tokens"]:
        x = [t for sl in a["tokens"][rid] for t in sl]
        y = [t for sl in b["tokens"][rid] for t in sl]
        n += max(len(x), len(y))
        d = [i for i in range(max(len(x), len(y)))
             if i >= len(x) or i >= len(y) or x[i] != y[i]]
        differ += len(d)
        first[rid] = d[0] if d else None
    return {"tokens": n, "differ": differ, "first_divergence": first,
            "samples_equal": all(a["samples"][rid] == b["samples"][rid] for rid in b["samples"])}


def tp_s3gen_call(e1, e2) -> dict:
    """One batched S3Gen-ref call (TP_S3GEN_JOBS jobs, the TP_S3GEN_TOKENS
    bucket, the default voice and its prompt cache): e2's sharded calls (K2
    at 4 heads on each rank) against e1's unsharded weights on the same
    tokens and noise, both vocoders conditioned → the errors, held to
    TP_S3GEN_TOL."""
    from chatterbox_tpu_torch.models.s3gen_ref import (draw_noise, s3gen_ref_flow,
                                                       s3gen_ref_inference)

    rc, dev = e1.cfg.s3gen_ref, e1.device
    B, T = TP_S3GEN_JOBS, TP_S3GEN_TOKENS
    g = torch.Generator(device=dev).manual_seed(21)
    tokens = torch.randint(0, rc.flow.vocab_size, (B, T), generator=g, device=dev)
    tlen = torch.tensor([T, T - 17], device=dev)
    ref = {k: torch.cat([v] * B) for k, v in e1.voice_cache["default"].gen_ref.items()}
    noise = draw_noise(rc, B, T, g, dev)
    src = torch.zeros((B, T * rc.samples_per_token), device=dev)
    clen = torch.zeros((B,), dtype=torch.long, device=dev)
    out, bad = {}, []
    for label, c1, c2 in (("prompt_cached", e1._cfm_cache_lru["default"],
                           e2._cfm_cache_lru["default"]),):
        with torch.inference_mode(), conditioned_hift(e1), conditioned_hift(e2):
            wav1, src1 = s3gen_ref_inference(e1.params["s3gen"], rc, tokens, tlen, ref, src, clen,
                                             noise, cfm_cache=c1)
            mel1 = s3gen_ref_flow(e1.params["s3gen"], rc, tokens, tlen, ref, noise["cfm"], c1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav2, src2 = e2.calls.s3gen_infer(tokens, tlen, ref, noise, c2, src, clen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            mel2 = e2.calls.s3gen_flow(tokens, tlen, ref, noise, c2)
        peak = mel1.abs().max().item()
        r = {"mel_max_abs": (mel2 - mel1).abs().max().item(), "mel_peak": peak,
             "source_max_abs": (src2 - src1).abs().max().item(),
             "wav_max_abs": (wav2 - wav1).abs().max().item(),
             "wav_peak": wav1.abs().max().item(),
             "wav_clipped": (wav1.abs() >= e1.cfg.s3gen_ref.hift.audio_limit).float().mean().item(),
             "wav_corr": min(float(np.corrcoef(a, b)[0, 1]) for a, b in zip(
                 wav1.float().cpu().numpy(), wav2.float().cpu().numpy())),
             "tp2_wall_s": wall}
        out[label] = r
        print(f"  S3Gen-ref {label}, {B} jobs x {T} tokens, tp=2 against tp=1: mel max abs "
              f"{r['mel_max_abs']:.3g} (peak {peak:.3g}), excitation {r['source_max_abs']:.3g}, "
              f"waveform {r['wav_max_abs']:.3g} (corr {r['wav_corr']:.6f}; peak "
              f"{r['wav_peak']:.3g}, clipped share {r['wav_clipped']:.3g}); tp=2 call "
              f"{wall:.3f} s", flush=True)
        if not (r["mel_max_abs"] <= TP_S3GEN_TOL["mel_rel"] * peak
                and r["source_max_abs"] <= TP_S3GEN_TOL["source"]
                and r["wav_max_abs"] <= TP_S3GEN_TOL["wav"]
                and r["wav_corr"] > TP_S3GEN_TOL["corr"] and r["wav_peak"] > 1e-3
                and r["wav_clipped"] == 0.0):
            bad.append(f"{label}: {r}")
    if bad:
        raise AssertionError(f"phase 13 S3Gen-ref at tp=2 against tp=1 ({TP_S3GEN_TOL}): {bad}")
    return out


async def tp_serving_phase(out: dict) -> dict:
    """Phase 13 → each rank's K1 and K2 launches while the tp = 2 engine
    served (a)'s 4 concurrent requests, and the head counts they ran at.

    (a) bf16 weights, as served: a tp = 1 engine serves the 4 requests
    concurrently, then the first alone (the control: bf16 tokens may move
    with the batch they decode in, with no tensor parallelism); the tp = 2
    engine
    serves them with the default voice's prompt cache rebuilt, its launch
    counts set to 0 on both ranks just before and read just after: every
    WAV checked, the follower's token digest equal to rank 0's, K1's int8
    body and both K2 forms launched on each rank at 8 and 4 heads; its
    tokens against tp = 1 reported beside the control. (b) float32 weights,
    on the per-request path (MAX_DECODE_SLOTS=1: the T3 prefill, decode
    state and slices and the prompt-cached S3Gen call through the sharded
    calls): tp = 2 against tp = 1, the first request's tokens and sample
    count held equal; then one batched S3Gen-ref call held to TP_S3GEN_TOL
    (``tp_s3gen_call``)."""
    texts = [TEXTS[0], TEXTS[2], f"Parallel. {TEXTS[0]}", f"Parallel. {TEXTS[2]}"]
    walls, runs, engines = {}, {}, {}
    try:
        for tp in (1, 2):
            engines[tp], walls[f"boot_tp{tp}_bf16_s"] = await tp_start(tp, "bfloat16")
        e1, e2 = engines[1], engines[2]
        print(f"  tp=2: {json.dumps(e2.tp_status())}; ainit (s) {json.dumps(walls)}", flush=True)
        runs["tp1"] = await tp_serve(e1, texts, "tp=1 bf16, concurrent")
        runs["alone"] = await tp_serve(e1, texts[:1], "tp=1 bf16, alone (control)")
        reset_launches()
        e2.tp.follower_stats(reset_launches=True)
        build_voice_cache(e2)   # K2's self form runs in the prompt prefill
        runs["tp2"] = await tp_serve(e2, texts, "tp=2 bf16, concurrent")
        per_rank = [read_launches(), e2.tp.follower_stats()[0]["launches"]]
        gc.collect()
        lead, (follower,) = e2.calls.stats(), e2.tp.follower_stats()
        est = e2.params["s3gen"]["flow"]["estimator"]["down"]["tf"][0]
        heads = {"decode_attention": e2.params["t3"]["backbone"]["layers"]["wq"].shape[1]
                 // e2.cfg.t3.head_dim, "flash_mha": est["to_q"]["w"].shape[0]
                 // e2.cfg.s3gen_ref.flow.dec_attention_head_dim}
    finally:
        for e in engines.values():
            e.shutdown()
        engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
    digests_equal = ((lead["token_digest"], lead["token_calls"])
                     == (follower["token_digest"], follower["token_calls"]))
    del e1, e2
    launches = {"decode_attention": [r["decode_attention"]["int8"] for r in per_rank],
                "flash_mha": [r["flash_mha"]["float32"] for r in per_rank],
                "flash_mha_context": [r["flash_mha"]["float32_ctx"] for r in per_rank]}
    bf16 = {"tp2_vs_tp1": token_diff(runs["tp1"], runs["tp2"]),
            "control_alone_vs_concurrent": token_diff(runs["tp1"], runs["alone"])}
    print(f"  tp=2: follower's token digest equal to rank 0's {digests_equal} "
          f"({lead['token_calls']} T3 calls); launches per rank {json.dumps(launches)} at "
          f"{json.dumps(heads)} heads per rank; follower handles {follower['handles']}",
          flush=True)
    print(f"  bf16 tokens, tp=2 against tp=1: {json.dumps(bf16['tp2_vs_tp1'])}; control "
          f"(tp=1, the first request alone against all four): "
          f"{json.dumps(bf16['control_alone_vs_concurrent'])}", flush=True)
    os.environ["MAX_DECODE_SLOTS"] = "1"
    try:
        for tp in (1, 2):
            engines[tp], walls[f"boot_tp{tp}_f32_s"] = await tp_start(tp, "float32")
        for tp in (1, 2):
            runs[f"f32_tp{tp}"] = await tp_serve(engines[tp], texts[:1],
                                                 f"tp={tp} float32, per request")
        s3 = tp_s3gen_call(engines[1], engines[2])
    finally:
        os.environ["MAX_DECODE_SLOTS"] = str(SLOTS)
        for e in engines.values():
            e.shutdown()
        engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
    f32 = token_diff(runs["f32_tp1"], runs["f32_tp2"])
    print(f"  float32 tokens, tp=2 against tp=1: {json.dumps(f32)}", flush=True)
    walls.update({f"serve_{k}_s": r["wall_s"] for k, r in runs.items()})
    print(f"  walls (s), {gpu_line()}; two ranks on one card over gloo, so no tensor-parallel "
          f"speed figure: {json.dumps({k: round(v, 3) for k, v in walls.items()})}", flush=True)
    out.update(backend="gloo", launches_per_rank=launches, heads_per_rank=heads,
               digests_equal=digests_equal, bf16=bf16, float32=f32, s3gen_call=s3, walls=walls)
    bad = []
    if not digests_equal:
        bad.append("the follower's tokens differ from rank 0's")
    if heads != {"decode_attention": 8, "flash_mha": 4}:
        bad.append(f"heads per rank {heads}")
    if any(n == 0 for v in launches.values() for n in v):
        bad.append(f"a kernel did not launch on every rank: {launches}")
    if f32["differ"] or not f32["samples_equal"]:
        bad.append(f"float32 tokens or sample counts differ: {f32}")
    if bad:
        raise AssertionError(f"phase 13: {bad}")
    return {"launches": launches, "heads": heads}


# ------------------------------------------------ the scripts at full width
# Phase 14 runs the port's scripts as a user starts them (``python -m``, a
# process each, on the card): the quality study of three variants against
# its default, parity_check against the study's reference_exact WAV,
# export_checkpoint and demo_synthesis --full-model. Every child boots
# EngineConfig.full() (ref) from one model directory. The weights are random,
# so no wall and no MCD here is a quality or speed result: an MCD says only
# whether a knob reaches the output.
STUDY_NEW_TOKENS = "70"
STUDY_ONLY = ("kv_native", "reference_exact", "prompt_cache_static")
# parity_check runs reference_exact's pinned stack again in a fresh process
PARITY_MCD_DB = 0.01
# variables a study variant or a script sets: the children start without them
SCRIPT_KNOBS = ("CHATTERBOX_S3GEN_ARCH", "CHATTERBOX_KV", "KV_CACHE_DTYPE",
                "CHATTERBOX_CFM_PROMPT_CACHE", "CHATTERBOX_CFM_STREAM", "CHATTERBOX_CFM_STEPS",
                "CHATTERBOX_PROGRESSIVE_SLICES", "CHATTERBOX_PALLAS", "CHATTERBOX_FLASH",
                "CHATTERBOX_TP", "CHATTERBOX_TINY_MODEL", "CHATTERBOX_FORCE_CPU",
                "CHATTERBOX_STREAM_WINDOW", "CHATTERBOX_FLOW_BF16", "CHATTERBOX_FLOW_PROMPT_TOKENS",
                "CHATTERBOX_OVERLAP_WINDOW_TOKENS", "STUDY_TEXT", "STUDY_SLICE")


def study_launch_faults(name: str, record: dict) -> list:
    """What a study child's sidecar must show: ``default`` K1's int8 body
    and K2's context form; ``kv_native`` K1's float body and no int8 one;
    ``reference_exact`` no K1 launch at all (its plain version swapped in)
    and K2's self form; ``prompt_cache_static`` K2. Request counts, and for a
    launch that must not happen, ainit's too."""
    req, init = record["launches"], record["launches_ainit"]
    k1, k2 = req["decode_attention"], req["flash_mha"]
    k1_all = {b: n + init["decode_attention"][b] for b, n in k1.items()}
    rules = {"default": {"K1 int8 > 0": k1["int8"] > 0, "K2 context > 0": k2["float32_ctx"] > 0},
             "kv_native": {"K1 float > 0": k1["native"] > 0, "K1 int8 = 0": k1_all["int8"] == 0},
             "reference_exact": {"K1 = 0": not any(k1_all.values()),
                                 "K2 self > 0": k2["float32"] > 0,
                                 "K1 swapped": record["plain"] == ["decode_attention"]},
             "prompt_cache_static": {"K2 > 0": any(k2.values())}}[name]
    if name != "reference_exact" and record["plain"]:
        rules["no swap"] = False
    return [rule for rule, ok in rules.items() if not ok]


def run_script(name: str, args: list, env: dict, timeout: float = 600):
    """``python -m chatterbox_tpu_torch.scripts.<name> args`` in ``env`` →
    (the finished process, its wall); a run past ``timeout`` is killed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"chatterbox_tpu_torch.scripts.{name}", *args],
                          env=env, cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    print(f"  {name} exited {proc.returncode} after {wall:.1f} s", flush=True)
    return proc, wall


def export_and_demo(tmp: Path, env: dict) -> dict:
    """(c) and (d)'s processes, run beside the study: export_checkpoint into
    ``tmp/exported``, then demo_synthesis --full-model → each one's finished
    process and wall."""
    runs = {}
    for name, args in (("export_checkpoint", [str(tmp / "exported")]),
                       ("demo_synthesis", ["--full-model", "--out", str(tmp / "demo.wav")])):
        runs[name] = run_script(name, args, env)
        if runs[name][0].returncode != 0:
            break
    return runs


def scripts_phase(tmp: Path, model_dir: Path, out: dict) -> dict:
    """Phase 14 (see the module's docstring): the study and then
    parity_check in this thread, export_checkpoint and then demo_synthesis
    beside them → each study child's request launches."""
    from concurrent.futures import ThreadPoolExecutor

    from chatterbox_tpu_torch.runtime.checkpoint import load_checkpoint
    from chatterbox_tpu_torch.runtime.engine import EngineConfig
    from chatterbox_tpu_torch.runtime.loader import load_params
    from chatterbox_tpu_torch.scripts import quality_study

    card = gpu_line()
    env = {k: v for k, v in os.environ.items() if k not in SCRIPT_KNOBS}
    env.update(MODEL_PATH=str(model_dir), CHATTERBOX_MAX_NEW_TOKENS=STUDY_NEW_TOKENS,
               MAX_DECODE_SLOTS=str(SLOTS), TMPDIR=str(tmp / "scripts-tmp"))
    (tmp / "scripts-tmp").mkdir()
    walls = {}
    with ThreadPoolExecutor(1) as pool:
        side = pool.submit(export_and_demo, tmp, env)
        # (a) the study: default and three variants, a child process each
        proc, walls["quality_study"] = run_script(
            "quality_study", ["--only", ",".join(STUDY_ONLY), "--out", str(tmp / "study.json")], env)
        if proc.returncode == 0:
            study_proc = proc
            # (b) parity_check: reference_exact's stack in a fresh process
            (study_dir,) = (tmp / "scripts-tmp").glob("quality_study_*")
            proc, walls["parity_check"] = run_script(
                "parity_check", ["--text", quality_study.TEXT,
                                 "--ref", str(study_dir / "reference_exact.wav"),
                                 "--seed-request-id", quality_study.REQUEST_ID,
                                 "--out", str(tmp / "parity_hyp.wav")], env)
        side_runs = side.result()
    if "parity_check" not in walls:
        raise AssertionError(f"quality_study exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    parity_proc = proc

    report = json.loads(study_proc.stdout)
    records, faults = {}, {}
    for name in ("default", *STUDY_ONLY):
        if name != "default" and name not in report["variants"]:
            raise AssertionError(f"study variant {name} failed:\n{study_proc.stderr[-4000:]}")
        record = json.loads((study_dir / f"{name}.json").read_text())
        records[name] = record
        st, sr = record["request_stats"], record["sample_rate"]
        audio_s = check_wav(name, (study_dir / f"{name}.wav").read_bytes(), st, sr,
                            record["samples_per_token"], int(sr * 30 / 1000))
        if record["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"study variant {name} ran on {record['device']}")
        row = report["variants"].get(name, {})
        print(f"  {name}: {audio_s:.2f} s audio, tokens {st['t3_tokens']}, MCD "
              f"{row.get('mcd_db', '-')} dB, LSD {row.get('lsd_db', '-')} dB; ainit "
              f"{record['ainit_s']:.2f} s (load {record['load_s']}); plain {record['plain']}; "
              f"launches {record['launches']} (ainit {record['launches_ainit']})", flush=True)
        faults[name] = study_launch_faults(name, record)
    # kv_native's K1 float body at every decode step of default's int8 one
    k1_steps = records["default"]["launches"]["decode_attention"]["int8"]
    if records["kv_native"]["launches"]["decode_attention"]["native"] != k1_steps:
        faults["kv_native"].append(f"K1 float launches != default's int8 launches {k1_steps}")
    for name, row in report["variants"].items():
        if not (math.isfinite(row["mcd_db"]) and math.isfinite(row["lsd_db"])
                and row["mcd_db"] > 0):
            faults[name].append(f"MCD {row['mcd_db']} / LSD {row['lsd_db']}: not finite and > 0 "
                                "(a knob that leaves the WAV unchanged)")
    if any(faults.values()):
        raise AssertionError(f"phase 14(a): {faults}")

    parity = (json.loads(parity_proc.stdout.strip().splitlines()[-1])
              if parity_proc.stdout.strip() else {})
    print(f"  parity_check against reference_exact.wav: {parity}", flush=True)
    if parity_proc.returncode != 0 or not parity.get("mcd_db", math.inf) <= PARITY_MCD_DB:
        raise AssertionError(f"parity_check: exit {parity_proc.returncode}, MCD "
                             f"{parity.get('mcd_db')} (bound {PARITY_MCD_DB} dB):\n"
                             f"{parity_proc.stderr[-4000:]}")

    for name, (proc, wall) in side_runs.items():
        walls[name] = wall
        if proc.returncode != 0:
            raise AssertionError(f"{name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    # (c) the export, read back bitwise against the weights it was made from
    export_dir = tmp / "exported"
    cfg = EngineConfig.full()
    exported = load_checkpoint(export_dir, cfg, torch.bfloat16, "cuda")
    source = load_params(model_dir, cfg, torch.bfloat16, torch.device("cuda"), 0, {})
    export = compare_params(exported, source, "the exported checkpoint against its source weights")
    del exported, source
    export["bytes"] = sum(f.stat().st_size for f in export_dir.iterdir())
    print(f"  exported {export['bytes'] / 2**30:.2f} GiB; the process took "
          f"{walls['export_checkpoint']:.1f} s", flush=True)
    shutil.rmtree(export_dir)

    # (d) the demo's WAV against the request's record (its log line)
    proc = side_runs["demo_synthesis"][0]
    demo_lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("init:", "TTFA:"))]
    stats = json.loads(re.search(r"request_stats (\{.*\})", proc.stderr).group(1))
    gen = cfg.gen
    demo_audio = check_wav("demo", (tmp / "demo.wav").read_bytes(), stats, gen.sample_rate,
                           gen.samples_per_token, int(gen.sample_rate * 30 / 1000))
    print(f"  demo_synthesis: {'; '.join(demo_lines)}; {demo_audio:.2f} s audio, "
          f"tokens {stats['t3_tokens']}", flush=True)

    print(f"  walls (s), {card}; random weights, so neither a quality nor a speed result; "
          f"export and demo ran beside the study: "
          f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}", flush=True)
    out.update(card=card, study=report, parity=parity, export=export, walls=walls,
               demo={"lines": demo_lines, "audio_s": demo_audio},
               ainit_s={n: r["ainit_s"] for n, r in records.items()})
    return {n: r["launches"] for n, r in records.items()}


def phase(title: str):
    print(f"== {title}", flush=True)
    return time.perf_counter()


def done(t0: float, walls: dict, key: str) -> None:
    walls[key] = time.perf_counter() - t0
    print(f"  [phase wall {walls[key]:.1f} s]", flush=True)


class _Tee:
    """Standard output also written to a file: the whole run's log (the
    output's last lines hold little more than the summary records)."""

    def __init__(self, stream, path: Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        self.stream, self.file = stream, open(path, "w")

    def write(self, text):
        self.file.write(text)
        return self.stream.write(text)

    def flush(self):
        self.file.flush()
        self.stream.flush()

    def __getattr__(self, name):   # fileno, isatty, encoding …: the stream's
        return getattr(self.stream, name)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import chatterbox_tpu_torch  # noqa: F401  (fails outside a checkout)
    from chatterbox_tpu_torch.ops import _build

    sys.stdout = _Tee(sys.stdout, Path.cwd() / "chiprun_out" / "chip_smoke.log")

    walls: dict = {}
    t0 = phase("1. machine")
    print(f"  {gpu_line()}", flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    done(t0, walls, "machine")

    t0 = phase("2. build")
    _build.library()
    info = _build.build_info
    print(f"  {info.get('command', info['path'])}".replace("\n", "\n  "), flush=True)
    print(f"  built in {info['seconds']:.2f} s (cached: {info['cached']})", flush=True)
    if info.get("log"):
        print("  " + info["log"].strip().replace("\n", "\n  "), flush=True)
    k3_ptxas = ptxas_report(info.get("log", ""), "pipelined_slice_kernel")
    for r in k3_ptxas:
        print(f"  K3 {r['function']}: {r['registers']} registers, spill stores "
              f"{r['spill_stores']} B, spill loads {r['spill_loads']} B", flush=True)
    ctx_ptxas = ctx_ptxas_report(info.get("log", ""))
    for r in ctx_ptxas["instances"]:
        print(f"  K2 context {r['function']}: {r['registers']} registers at launch (setmaxnreg: "
              f"producer 56, consumers 216), spill stores {r['spill_stores']} B, spill loads "
              f"{r['spill_loads']} B", flush=True)
    print("  K2 context: " + ("; ".join(ctx_ptxas["wgmma_serialized"]) or
                              "ptxas reports no serialized wgmma"), flush=True)
    done(t0, walls, "build")

    t0 = phase("3. kernels against their plain versions")
    k1, k2, k3, k2c = {}, {}, {}, {}
    reset_launches()
    check_decode_attention(k1)
    check_decode_slice_edges(k1)
    check_pipelined_edges(k3)
    check_flash_mha(k2)
    check_flash_mha_context(k2c)
    check_other_shapes(k1, k2, k3)
    check_batched_decode(k1, k3)
    k2_h4, k2c_h4 = {}, {}
    check_tp_heads(k1, k2_h4, k2c_h4)
    k3_launches = read_launches()["decode_attention_pipelined"]["native"]
    done(t0, walls, "kernels")

    serving, k3_live = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        model_dir, neutral_dir = Path(tmp) / "models", Path(tmp) / "models-neutral"
        model_dir.mkdir()
        neutral_dir.mkdir()
        write_conds(model_dir / "conds.pt")
        os.environ.update(MODEL_PATH=str(model_dir), CHATTERBOX_MAX_NEW_TOKENS=MAX_NEW_TOKENS,
                          CHATTERBOX_KV="int8", MAX_DECODE_SLOTS=str(SLOTS),
                          VOICES_DIR=str(Path(tmp) / "voices"),
                          PRELOADED_VOICES_DIR=str(Path(__file__).resolve().parent / "preloaded-voices"))
        for name in ("CHATTERBOX_CFM_PROMPT_CACHE", "CHATTERBOX_CFM_STREAM"):
            os.environ.pop(name, None)   # the defaults: step prompt cache, streaming CFM
        t0 = phase(f"4. batched serving ({SLOTS} slots, int8 KV, {SLOTS} concurrent requests; "
                   "CFM prompt cache and streaming CFM)")
        loop = asyncio.new_event_loop()
        engine, launches = loop.run_until_complete(serve_batched(serving))
        done(t0, walls, "batched_serving")

        t0 = phase("5. S3Gen at full width: first streaming slice against the cached tail path; "
                   "one batched call per path; the uncached batched path")
        loop.run_until_complete(s3gen_phase(engine, serving))
        done(t0, walls, "s3gen")

        t0 = phase(f"5b. voice cloning on phase 4's engine: {CLONE_VOICE} on the card against the "
                   "CPU; 4 concurrent requests in that voice")
        loop.run_until_complete(clone_phase(engine, serving))
        engine.shutdown()
        loop.run_until_complete(asyncio.sleep(0))   # let the schedulers' tasks end
        loop.close()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        done(t0, walls, "voice_cloning")

        t0 = phase("6. per-request serving (MAX_DECODE_SLOTS=1, int8 KV) with no conds.pt: "
                   "the neutral default voice")
        os.environ["MAX_DECODE_SLOTS"] = "1"
        os.environ["MODEL_PATH"] = str(neutral_dir)
        engine = asyncio.run(serve_per_request(serving))
        done(t0, walls, "per_request_serving")

        t0 = phase(f"7. BatchedT3Decoder with a bf16 cache at {SLOTS} slots; K3 on its live cache")
        k3_launches += batched_bf16_decoder(engine, k1, k3_live)
        engine.shutdown()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        done(t0, walls, "bf16_decoder")

        t0 = phase("8. a full-size reference checkpoint: written, loaded on the card and held to "
                   "the CPU; 4 requests with progressive slices; the native round trip")
        loaded_dir, native_dir = Path(tmp) / "models-loaded", Path(tmp) / "models-native"
        loaded_dir.mkdir()
        os.environ.update(MODEL_PATH=str(loaded_dir), MAX_DECODE_SLOTS=str(SLOTS),
                          CHATTERBOX_MAX_NEW_TOKENS=LOADED_NEW_TOKENS,
                          CHATTERBOX_PROGRESSIVE_SLICES="1")
        serving["checkpoint"] = {}
        try:
            loaded_launches = asyncio.run(serve_loaded_checkpoint(
                loaded_dir, native_dir, serving["checkpoint"]))
        finally:
            del os.environ["CHATTERBOX_PROGRESSIVE_SLICES"]
            os.environ["CHATTERBOX_MAX_NEW_TOKENS"] = MAX_NEW_TOKENS
        gc.collect()
        torch.cuda.empty_cache()
        done(t0, walls, "loaded_checkpoint")

        t0 = phase("9. the DiT S3Gen configuration (CHATTERBOX_S3GEN_ARCH=dit) at full width: "
                   "the default voice, one batched call, cloning, both serving paths, the native "
                   "round trip")
        serving["dit"] = {}
        try:
            dit_launches = asyncio.run(dit_phase(Path(tmp), serving["dit"]))
        finally:
            del os.environ["CHATTERBOX_S3GEN_ARCH"]
            os.environ["CHATTERBOX_MAX_NEW_TOKENS"] = MAX_NEW_TOKENS
        gc.collect()
        torch.cuda.empty_cache()
        done(t0, walls, "dit")

        t0 = phase("10. T3 training at full width (CHATTERBOX_S3GEN_ARCH=dit): featurizing, one "
                   "step against the CPU, the entry point, serving the trained checkpoint")
        serving["training"] = {}
        try:
            training_launches = training_phase(Path(tmp), serving["training"])
        finally:
            del os.environ["CHATTERBOX_S3GEN_ARCH"]
            os.environ["CHATTERBOX_MAX_NEW_TOKENS"] = MAX_NEW_TOKENS
        gc.collect()
        torch.cuda.empty_cache()
        done(t0, walls, "training")

        t0 = phase(f"11. the kernels' switches ({', '.join(KNOBS)} at 0 refused; 4 requests "
                   "with the plain versions, then on the kernels); the bench's entry points "
                   "in subprocesses")
        serving["kernels_off"], serving["bench"] = {}, {}
        os.environ.update(MODEL_PATH=str(model_dir), MAX_DECODE_SLOTS=str(SLOTS),
                          CHATTERBOX_MAX_NEW_TOKENS=BENCH_NEW_TOKENS)
        try:
            knob_launches = asyncio.run(kernels_off_phase(serving["kernels_off"]))
        finally:
            os.environ["CHATTERBOX_MAX_NEW_TOKENS"] = MAX_NEW_TOKENS
        gc.collect()
        torch.cuda.empty_cache()
        bench_phase(Path(tmp), serving["bench"])
        done(t0, walls, "kernels_off_and_bench")

        t0 = phase("12. tensor- and data-parallel T3: 2 ranks on the card (gloo)")
        serving["parallel"] = {}
        tp_launches = parallel_phase(serving["parallel"])
        done(t0, walls, "parallel")

        t0 = phase("13. tensor-parallel serving (CHATTERBOX_TP=2): 2 ranks on the card (gloo), "
                   "4 requests batched with the prompt cache and streaming CFM; one S3Gen-ref "
                   "call against tp=1; float32 against tp=1")
        serving["tp_serving"] = {}
        os.environ.update(MODEL_PATH=str(model_dir), MAX_DECODE_SLOTS=str(SLOTS),
                          CHATTERBOX_MAX_NEW_TOKENS=TP_SERVE_NEW_TOKENS)
        try:
            tp_serving = asyncio.run(tp_serving_phase(serving["tp_serving"]))
        finally:
            os.environ["CHATTERBOX_MAX_NEW_TOKENS"] = MAX_NEW_TOKENS
        gc.collect()
        torch.cuda.empty_cache()
        done(t0, walls, "tp_serving")

        t0 = phase("14. the scripts at full width, each a process on the card: the quality "
                   f"study ({', '.join(STUDY_ONLY)} against default), parity_check, "
                   "export_checkpoint, demo_synthesis --full-model")
        serving["scripts"] = {}
        study_launches = scripts_phase(Path(tmp), model_dir, serving["scripts"])
        done(t0, walls, "scripts")

    print("== 15. summary", flush=True)
    # ms / plain_ms / library_ms: device time per call; call_ms: with the
    # host's dispatch; bound_ms: bytes over 3.35 TB/s or operations over peak
    k3_main = {**k3["bfloat16"], "max_abs_err": max(k3["bfloat16"]["max_abs_err"], k3_live["live"]),
               "live_cache_err": k3_live["live"], "live_cache_ms": k3_live["live_ms"],
               "live_cache": k3_live["live_timing"]}
    summary = {"kernels": [
        dict(name="decode_attention", route="cuda", **KERNELS["decode_attention"],
             launches=launches["decode_attention"]["int8"], body="int8", **k1[f"int8_B{LANES}"],
             launches_loaded_checkpoint=loaded_launches["decode_attention"]["int8"],
             launches_dit=dit_launches["decode_attention"]["int8"],
             launches_training=training_launches["decode_attention"]["int8"],
             launches_kernels_off=knob_launches["off"]["decode_attention"]["int8"],
             launches_kernels_on=knob_launches["on"]["decode_attention"]["int8"],
             launches_tp=tp_launches["per_rank"], heads_tp=tp_launches["heads_per_rank"],
             launches_tp_serving=tp_serving["launches"]["decode_attention"],
             heads_tp_serving=tp_serving["heads"]["decode_attention"],
             launches_study={n: l["decode_attention"] for n, l in study_launches.items()},
             other_bodies={"bfloat16": k1[f"bfloat16_B{LANES}"], "B2_checks": {
                 c: k1[c] for c in ("int8", "bfloat16", "float32")}, "slice_edge_checks": {
                 c: k1[f"slice_edges_B{LANES}_{c}"] for c in ("int8", "bfloat16", "float32")},
                 "other_shapes": {c: k1[f"other_shapes_{c}"] for c in ("int8", "bfloat16", "float32")},
                 "tp_heads": {c: k1[f"tp_heads_{c}"] for c in ("int8", "bfloat16")},
                 "live_bf16_ms": k1["live_bf16_ms"]}),
        dict(name="flash_mha", route="cuda", **KERNELS["flash_mha"],
             launches=launches["flash_mha"]["float32"], body="float32, self form",
             launches_loaded_checkpoint=loaded_launches["flash_mha"]["float32"],
             launches_dit=dit_launches["flash_mha"]["float32"],
             launches_training=training_launches["flash_mha"]["float32"],
             launches_kernels_off=knob_launches["off"]["flash_mha"]["float32"],
             launches_kernels_on=knob_launches["on"]["flash_mha"]["float32"],
             launches_tp_serving=tp_serving["launches"]["flash_mha"],
             heads_tp_serving=tp_serving["heads"]["flash_mha"],
             launches_study={n: l["flash_mha"]["float32"] for n, l in study_launches.items()},
             launches_from="phase 4: the default voice's prompt prefill", **k2["float32"],
             other_bodies={"bfloat16": k2["bfloat16"], "other_head_dims": {
                 c: k2[f"other_dh_{c}"] for c in ("float32", "bfloat16")},
                 "tp_heads_4": k2_h4}),
        dict(name="flash_mha_context", route="cuda", **KERNELS["flash_mha_context"],
             launches=launches["flash_mha"]["float32_ctx"],
             body="float32 q and own keys over bf16 prompt (Bp = 2) and ring, Tq = 72",
             launches_loaded_checkpoint=loaded_launches["flash_mha"]["float32_ctx"],
             launches_dit=dit_launches["flash_mha"]["float32_ctx"],
             launches_training=training_launches["flash_mha"]["float32_ctx"],
             launches_kernels_off=knob_launches["off"]["flash_mha"]["float32_ctx"],
             launches_kernels_on=knob_launches["on"]["flash_mha"]["float32_ctx"],
             launches_tp_serving=tp_serving["launches"]["flash_mha_context"],
             heads_tp_serving=tp_serving["heads"]["flash_mha"],
             launches_study={n: l["flash_mha"]["float32_ctx"] for n, l in study_launches.items()},
             launches_from="phase 4: every cached and streaming estimator evaluation",
             **k2c["f32_bf16"], other_bodies={"f32_f32": k2c["f32_f32"],
                                              "bf16_bf16": k2c["bf16_bf16"],
                                              "tp_heads_4": k2c_h4, "ptxas": ctx_ptxas}),
        dict(name="decode_attention_pipelined", route="cuda",
             **KERNELS["decode_attention_pipelined"], launches=k3_launches, body="bfloat16",
             launches_loaded_checkpoint=loaded_launches["decode_attention_pipelined"]["native"],
             launches_dit=dit_launches["decode_attention_pipelined"]["native"],
             launches_training=training_launches["decode_attention_pipelined"]["native"],
             launches_kernels_off=knob_launches["off"]["decode_attention_pipelined"]["native"],
             launches_kernels_on=knob_launches["on"]["decode_attention_pipelined"]["native"],
             launches_from="phases 3 and 7 (no serving path calls it)", **k3_main,
             slice_rows=k3["edges_bfloat16"]["slice_rows"],
             other_bodies={"float32": k3["float32"], "edge_checks": {
                 c: k3[f"edges_{c}"] for c in ("bfloat16", "float32")},
                 "other_shapes": {c: k3[f"other_shapes_{c}"] for c in ("bfloat16", "float32")},
                 "ptxas": k3_ptxas}),
    ]}
    print(f"  serving: {json.dumps(serving)}", flush=True)
    # after the long serving record, so the end of the output keeps it
    print(f"  phase walls (s): {json.dumps({k: round(v, 1) for k, v in walls.items()})}",
          flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
