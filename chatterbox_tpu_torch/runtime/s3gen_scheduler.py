"""S3Gen micro-batcher with device-resident source state (torch counterpart
of ``chatterbox_tpu/runtime/s3gen_scheduler.py``).

Concurrent chunk syntheses that share a token bucket go out as ONE batched
call: their token rows, conditioning dicts, source windows and noise stack
along the batch axis. Batches form greedily, with no artificial wait: what is
queued for a bucket when the previous batch returns goes out together, up to
the token-product budget (``CHATTERBOX_S3GEN_BATCH_TOKENS``). Queues key on
(bucket, CFM prompt cache identity, streaming): a batch shares one per-voice
prompt cache, and streaming jobs run another model call than re-solve jobs.

Streaming jobs (``rstate``) solve only their new tokens, right-packed into a
block from ``STREAM_BLOCK_SNAP`` picked for the batch's largest ``new_len``;
their per-request states stack into one batched state for the call, and
each job's future returns its own new state.

Each request's excitation source cache stays on the device as a fixed-size
``[state_len]`` row; a batch gathers the window each job needs (``shift``)
and returns the updated rows. Only the new audio tail (``prev_rel`` → at
most ``MAX_TAIL_TOKENS`` tokens of samples) is copied to the host.

Noise: each job draws its CFM and source noise from its own generator seeded
with the job's seed (the arch's ``draw_noise``), so a request's audio is the
same solo or co-batched. The DiT arch runs its ``infer`` with a full vocode
and slices the tail (no ``tail_infer``, no streaming), as the JAX package
does.

Two deliberate differences from the JAX scheduler:

* no power-of-two padding. XLA compiles one graph per batch size, so the JAX
  scheduler pads a batch to the next power of two; eager PyTorch compiles
  nothing per shape, so a batch runs exactly the jobs it takes.
* no catch-and-retry at a smaller batch. A failed batch fails its jobs
  loudly, as the JAX scheduler's batch-of-one failure does; a retry would hide
  a kernel fault that shows only at some batch size.

"""
from __future__ import annotations

import asyncio
import dataclasses
import os
import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..logging_config import log
from ..models.s3gen_ref import (
    draw_noise,
    s3gen_ref_inference,
    s3gen_ref_inference_streaming,
    split_stream_state,
    stack_stream_states,
)
from .metrics import metrics

# Upper bound on NEW tokens per synthesis call: the largest snapped
# audio_tokens_per_slice (100, engine.SLICE_SIZE_SNAP) + the appended EOS
# code. The returned tail is min(MAX_TAIL_TOKENS, bucket)·spt samples.
MAX_TAIL_TOKENS = 101

# Streaming-block ladder (tokens): a streaming call solves a right-packed
# block of new_block·up_stride frames, so the block follows the slice, not
# MAX_TAIL_TOKENS. Every snapped slice size + the EOS code fits one of these.
STREAM_BLOCK_SNAP = (36, 71, 101)


def stream_block_tokens(max_new: int, bucket: int) -> int:
    """Smallest streaming block that holds ``max_new`` new tokens, clamped
    to the bucket (accumulated ≥ new) and MAX_TAIL_TOKENS."""
    nb = next((s for s in STREAM_BLOCK_SNAP if s >= max_new), MAX_TAIL_TOKENS)
    return max(1, min(nb, MAX_TAIL_TOKENS, bucket))


def _cancel_jobs(jobs: List["_Job"]) -> None:
    """Cancel the jobs' futures and empty the list."""
    for job in jobs:
        if not job.future.done():
            job.future.cancel()
    jobs.clear()


@dataclasses.dataclass
class _Job:
    tokens: np.ndarray              # [T] bucket-padded
    token_len: int
    ref: Dict                       # per-request ref dict (leaves [1, ...])
    state: Optional[torch.Tensor]   # [state_len] device source row (None = zeros)
    cache_len: int                  # valid samples in state after shift
    seed: int                       # noise seed (chunk-stable)
    shift: int                      # samples to skip from state (window drop)
    prev_rel: int                   # first NEW sample (window-relative)
    future: asyncio.Future
    keep_state: bool = True         # the caller wants the updated row back
    cache: Optional[Dict] = None    # per-voice CFM prompt cache, shared by the batch
    new_len: int = 0                # streaming: NEW tokens this slice
    rstate: Optional[Dict] = None   # streaming: the request's state (batch 1)


class S3GenScheduler:
    def __init__(self, params: Dict, cfg, max_batch: int = 16, infer=None,
                 state_tokens: int = 1032, tail_infer=None, noise_fn=draw_noise,
                 stream_infer=None):
        """``infer(params, tokens, token_len, ref, src, cache_len, noise)`` →
        (wav [B, T·spt], new_src [B, T·spt]): the batched chunk inference
        (default ``s3gen_ref_inference``); ``noise_fn(cfg, batch, T,
        generator, device, stream=...)`` draws its ``noise`` (default the
        ref arch's ``draw_noise``; ``stream`` is passed only for streaming
        jobs).

        ``tail_infer``: optional windowed-vocoder variant (… same args …,
        start [B], tail_len) → (tail [B, tail_len], new_src), which vocodes
        only a receptive-field window around the tail (exact; see
        ``s3gen_ref_inference_tail``). Both take ``cache=`` for jobs with a
        CFM prompt cache. Streaming jobs run ``stream_infer(params, tokens,
        token_len, new_len, ref, src, cache_len, noise, start, tail_len,
        states, new_block_tokens, cache)`` → (tails, new source, the jobs'
        new states), by default ``s3gen_ref_inference_streaming`` over the
        jobs' stacked states.

        ``state_tokens``: source-row capacity in tokens (≥ the largest bucket
        plus the largest per-slice shift)."""
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        # memory guard: flow activations grow with batch × bucket
        self.batch_token_budget = int(os.environ.get("CHATTERBOX_S3GEN_BATCH_TOKENS", "4096"))
        self.state_len = state_tokens * cfg.samples_per_token
        leaf = params
        while not isinstance(leaf, torch.Tensor):
            leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
        self.device = leaf.device
        self._infer = infer or (
            lambda p, tk, tl, rf, sr, cl, nz, cache=None: s3gen_ref_inference(
                p, cfg, tk, tl, rf, sr, cl, nz, cfm_cache=cache))
        self._tail_infer = tail_infer
        self._stream_infer = stream_infer or self._stream_stacked
        self._noise_fn = noise_fn
        self._noise_gen = torch.Generator(device=self.device)
        self._queues: Dict[tuple, List[_Job]] = {}
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # first-audio gate: bumped when a batch has been issued on the device
        self._dispatch_seq = 0
        self._dispatch_evt: Optional[asyncio.Event] = None
        # high-watermarks of jobs in one batch, and in one streaming batch
        # (they show that micro-batching batches)
        self.max_batch_seen = 0
        self.max_stream_batch_seen = 0

    def _stream_stacked(self, params, tokens, tlen, nlen, ref, src, clen, noise, starts, tail,
                        states, nb, cache):
        tails, new_src, new_state = s3gen_ref_inference_streaming(
            params, self.cfg, tokens, tlen, nlen, ref, src, clen, noise, starts, tail,
            stack_stream_states(states), nb, cache)
        return tails, new_src, split_stream_state(new_state, len(states))

    def _tail_len(self, T: int) -> int:
        return min(MAX_TAIL_TOKENS, T) * self.cfg.samples_per_token

    def allowed_batch(self, T: int) -> int:
        """Largest batch the scheduler forms at bucket T: max_batch, capped
        by the token-product budget (any size, no power-of-two ladder)."""
        return max(1, min(self.max_batch, self.batch_token_budget // T))

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        if self._task is not None and not self._task.done() and self._loop is loop:
            return
        self._loop = loop
        self._wake = asyncio.Event()
        self._dispatch_evt = asyncio.Event()
        self._queues = {}
        self._task = loop.create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def _signal_dispatch(self) -> None:
        """Loop-thread callback: a batch was issued on the device."""
        self._dispatch_seq += 1
        if self._dispatch_evt is not None:
            self._dispatch_evt.set()

    async def wait_dispatch(self, timeout: float = 0.25) -> bool:
        """Wait (bounded) until the NEXT batch has been issued on the device.
        The T3 loop calls this after a slice that gave a fresh request its
        first tokens, so that request's first synthesis is queued before the
        next decode slice."""
        self.start()
        seq0 = self._dispatch_seq
        deadline = asyncio.get_running_loop().time() + timeout
        while self._dispatch_seq == seq0:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return False
            self._dispatch_evt.clear()
            try:
                await asyncio.wait_for(self._dispatch_evt.wait(), remaining)
            except asyncio.TimeoutError:
                return False
        return True

    async def synthesize(
        self,
        tokens: np.ndarray,              # [T] bucket-padded
        token_len: int,
        ref: Dict,                       # leaves [1, ...]
        state: Optional[torch.Tensor],   # [state_len] device row (None = zeros)
        cache_len: int,                  # valid source samples after shift
        seed: int,
        shift: int = 0,                  # window drop in samples
        prev_rel: int = 0,               # first new sample (window-relative)
        keep_state: bool = True,         # False: the caller discards the new row
        cache: Optional[Dict] = None,    # per-voice CFM prompt cache
        new_len: int = 0,                # streaming: NEW tokens this slice
        rstate: Optional[Dict] = None,   # streaming: the request's state
    ):
        """→ (audio tail [tail_len] on the host, tail start offset, new device
        source row, or None when ``keep_state`` is False), and for a
        streaming job (``rstate``) a fourth element, the request's new
        state. The caller's new audio is ``tail[prev_rel - start :]`` up to
        its valid length."""
        if rstate is not None:
            if cache is None:
                raise ValueError("a streaming job needs the CFM prompt cache")
            if not 0 < new_len <= min(MAX_TAIL_TOKENS, len(tokens)):
                raise ValueError(f"streaming job with {new_len} new tokens "
                                 f"(bucket {len(tokens)}, block ≤ {MAX_TAIL_TOKENS})")
            if shift:
                raise ValueError("streaming jobs never drop a window (shift must be 0)")
        n = len(tokens) * self.cfg.samples_per_token
        if not 0 <= shift <= self.state_len - n:
            # a clamped window would misalign the excitation cache
            raise ValueError(f"source shift {shift} outside [0, {self.state_len - n}] "
                             f"(state_len {self.state_len}, bucket {len(tokens)})")
        self.start()
        fut = asyncio.get_running_loop().create_future()
        qkey = (len(tokens), id(cache) if cache is not None else 0, rstate is not None)
        job = _Job(tokens, token_len, ref, state, cache_len, seed, shift, prev_rel, fut,
                   keep_state, cache, new_len, rstate)
        queue = self._queues.setdefault(qkey, [])
        queue.append(job)
        self._wake.set()
        try:
            return await fut
        except asyncio.CancelledError:
            # a job no batch has taken yet leaves the queue with its caller
            # (and its state with it)
            queue[:] = [j for j in queue if j is not job]
            raise

    @torch.inference_mode()
    def _run_batch(self, jobs: List[_Job]):
        """One batched call for jobs of one queue → (tails [B, tail_len] on
        the host, start offsets, new source rows [B, state_len], the
        streaming jobs' new states or None)."""
        t_stack = _time.perf_counter()
        T = len(jobs[0].tokens)
        cache, streaming = jobs[0].cache, jobs[0].rstate is not None
        spt = self.cfg.samples_per_token
        n, tail = T * spt, self._tail_len(T)
        dev = self.device
        tokens = torch.as_tensor(np.stack([j.tokens for j in jobs]), device=dev)
        tlen = torch.as_tensor([j.token_len for j in jobs], device=dev)
        ref = {k: torch.cat([j.ref[k] for j in jobs]) for k in jobs[0].ref}
        clen = torch.as_tensor([j.cache_len for j in jobs], device=dev)
        if all(j.state is None for j in jobs):
            src = torch.zeros((len(jobs), n), device=dev)
        else:
            zero = torch.zeros((self.state_len,), device=dev)
            states = torch.stack([zero if j.state is None else j.state for j in jobs])
            shifts = torch.as_tensor([j.shift for j in jobs], device=dev)
            src = torch.gather(states, 1, shifts[:, None] + torch.arange(n, device=dev))
        draws = []
        for j in jobs:
            self._noise_gen.manual_seed(j.seed)
            stream_kw = {"stream": True} if streaming else {}
            draws.append(self._noise_fn(self.cfg, 1, T, self._noise_gen, dev, **stream_kw))
        noise = {k: torch.cat([d[k] for d in draws]) for k in draws[0]}
        starts_host = [min(max(j.prev_rel, 0), max(0, n - tail)) for j in jobs]
        starts = torch.as_tensor(starts_host, device=dev)
        kw = {} if cache is None else {"cache": cache}
        new_rstates = None
        if streaming:
            nlen = torch.as_tensor([j.new_len for j in jobs], device=dev)
        metrics.record_stage("s3gen_stack_host", _time.perf_counter() - t_stack)
        if streaming:
            nb = stream_block_tokens(max(j.new_len for j in jobs), T)
            tails, new_src, new_rstates = self._stream_infer(
                self.params, tokens, tlen, nlen, ref, src, clen, noise, starts, tail,
                [j.rstate for j in jobs], nb, cache)
        elif self._tail_infer is not None:
            tails, new_src = self._tail_infer(self.params, tokens, tlen, ref, src, clen, noise,
                                              starts, tail, **kw)
        else:
            wav, new_src = self._infer(self.params, tokens, tlen, ref, src, clen, noise, **kw)
            tails = torch.gather(wav, 1, starts[:, None] + torch.arange(tail, device=dev))
        new_states = torch.zeros((len(jobs), self.state_len), device=dev)
        new_states[:, :n] = new_src.float()
        # the batch is issued on the device: open the first-audio gate before
        # the host copy of the tails waits for it to finish
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(self._signal_dispatch)
            except RuntimeError:
                pass
        return tails.float().cpu().numpy(), starts_host, new_states, new_rstates

    async def _run(self) -> None:
        while True:
            qkey = next((k for k, q in self._queues.items() if q), None)
            if qkey is None:
                self._wake.clear()
                await self._wake.wait()
                continue
            await self._serve_batch(qkey)

    async def _serve_batch(self, qkey: tuple) -> None:
        """Run one batch off ``qkey``'s queue and resolve its jobs (a
        coroutine of its own, so nothing of the batch, its streaming states
        included, outlives it while the loop idles)."""
        bucket = qkey[0]
        queue = self._queues[qkey]
        take = min(len(queue), self.allowed_batch(bucket))
        jobs, queue[:] = queue[:take], queue[take:]
        t0 = _time.perf_counter()
        try:
            tails, starts, new_states, new_rstates = await asyncio.to_thread(self._run_batch, jobs)
        except asyncio.CancelledError:
            # the cancelled task keeps this frame (its traceback): it must
            # not keep the jobs
            _cancel_jobs(jobs)
            raise
        except Exception as exc:
            log.exception("S3Gen batch (bucket=%d, jobs=%d) failed", bucket, take)
            for job in jobs:
                if not job.future.done():
                    job.future.set_exception(exc)
            return
        dt = _time.perf_counter() - t0
        metrics.record_stage("s3gen_device", dt, items=take)
        self.max_batch_seen = max(self.max_batch_seen, take)
        if new_rstates is not None:
            self.max_stream_batch_seen = max(self.max_stream_batch_seen, take)
        log.info("[S3GEN] batch bucket=%d jobs=%d cached=%s streaming=%s %.3fs", bucket, take,
                 qkey[1] != 0, qkey[2], dt)
        for i, job in enumerate(jobs):
            if not job.future.done():
                result = (tails[i], starts[i], new_states[i] if job.keep_state else None)
                if new_rstates is not None:
                    result += (new_rstates[i],)
                job.future.set_result(result)
