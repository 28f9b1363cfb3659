"""Continuous-batching T3 decoder (torch counterpart of
``chatterbox_tpu/runtime/scheduler.py``).

N decode slots share one set of weights and one KV cache, held per layer:
``cache["k"][i]`` is ``[2N, Hk, C, Dh]`` (int8 with f32 scales
``[2N, Hk, C]``, or the params dtype); every decode slice advances all slots
together. The capacity C follows the positions the slots reach: before each
slice it becomes the slice's attention view (the 256-bucket of max(pos) +
steps + 1) when that is larger, or when that is at most C/2; before a
prefill it grows to hold the prefix and the first step. A resize moves one
layer's tensor at a time (allocate, copy the live prefix, drop the old), so
it never holds two whole caches; lanes of idle slots whose ``pos`` lies past
a shrunk C restart at 0, so no write or read leaves it. Lanes are
``[slot0-cond, slot0-uncond, slot1-cond, …]``. A request's text chunk is
prefilled straight into its slot's two lanes between slices (in place: only
the first P positions are written, and entries past ``pos`` left by an
earlier occupant stay unread because the attention stops at each row's own
``pos``). Idle slots start out ``done``: they re-emit EOS inside the batch and
advance neither ``pos`` nor ``step``. Each slot samples with its own seed and
step counter (``make_decode_state``), so a request's tokens do not depend on
its slot or its co-tenants.

The asyncio surface is one ``decode_chunk`` async generator per text chunk,
yielding numpy token slices. Admission and each slice run in
``asyncio.to_thread``, one at a time, from the loop task. Not ported: the
JAX package's ``warm_variants`` (it fills XLA's jit caches; eager PyTorch has
none).

Under tensor parallelism (``runtime/tp_serving.py``) the decoder holds this
rank's shard of T3, its cache holds this rank's kv heads, and its device
steps (``insert``, ``finish``, ``run_slice``) go through ``calls``, which
runs each in step on every rank: each follower holds a decoder of its own
and replays them.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import AsyncGenerator, Dict, List, Optional

import numpy as np
import torch

from ..logging_config import log
from ..models.t3 import T3Config, make_decode_state, t3_decode_slice
from ..models.t3.model import _quantize_kv, t3_prefill_raw
from .cancellation import CancellationToken
from .metrics import NO_SPAN, current_request, metrics


class DecodeError(RuntimeError):
    """The batched decoder loop died; in-flight requests must fail loudly."""


@dataclasses.dataclass
class _Submission:
    cond_lanes: torch.Tensor  # [2, C, D] on the decoder's device
    text: np.ndarray          # [2, T_pad]
    text_len: int
    temperature: float
    top_p: float
    cfg_weight: float
    rep_penalty: float
    max_new_tokens: int
    cancellation: Optional[CancellationToken]
    slot_future: asyncio.Future
    seed: int = 0
    # tokens the submitter wants early (first-audio look-ahead): while the
    # slot has produced nothing, the loop runs a short slice
    lookahead: int = 0
    # the request's record: "t3_s" / "t3_steps" grow by the host wall and the
    # steps of every admission and slice that carried this chunk
    stats: Optional[Dict] = None
    rid: Optional[str] = None
    wait: object = NO_SPAN    # "t3.admit_wait", closed when _admit takes it


# Short-slice lengths for fresh look-ahead admissions (3..20 tokens).
LOOKAHEAD_STEPS = (8, 20)
# The cache's capacity moves in steps of this many positions (K1's slice).
CACHE_BUCKET = 256


def _moved(old: torch.Tensor, rows: int, keep: int) -> torch.Tensor:
    """One layer's ``[B, Hk, S, …]`` cache tensor at ``rows`` positions: its
    first ``keep`` copied, the rest zero (the plain attention reads them)."""
    new = old.new_empty((*old.shape[:2], rows, *old.shape[3:]))
    new[:, :, :keep] = old[:, :, :keep]
    new[:, :, keep:].zero_()
    return new


class BatchedT3Decoder:
    def __init__(self, params: Dict, cfg: T3Config, n_slots: int = 16, slice_size: int = 35,
                 calls=None):
        """``calls``: a tensor-parallel engine's ``tp_serving.ShardedCalls``
        (``params`` is then this rank's shard)."""
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.slice_size = slice_size
        self.calls = calls
        L, Dh = cfg.num_layers, cfg.head_dim
        Hk = params["backbone"]["layers"]["wk"].shape[1] // Dh   # this shard's kv heads
        B = 2 * n_slots
        dev = params["speech_emb"].device
        self.device = dev
        # the cache's capacity C, in positions (see _capacity)
        self.rows = S = self._bucket(1)
        i32 = dict(dtype=torch.int32, device=dev)
        self.cache = {"start": torch.zeros((B,), **i32), "pos": torch.zeros((B,), **i32)}

        def layers(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(L)]

        if cfg.kv_cache_dtype == "int8":
            self.cache.update(k=layers((B, Hk, S, Dh), torch.int8),
                              v=layers((B, Hk, S, Dh), torch.int8),
                              k_scale=layers((B, Hk, S), torch.float32),
                              v_scale=layers((B, Hk, S), torch.float32))
        else:
            dtype = params["speech_emb"].dtype
            self.cache.update(k=layers((B, Hk, S, Dh), dtype), v=layers((B, Hk, S, Dh), dtype))
        self.state = make_decode_state(cfg, [0] * n_slots, 0.8, 0.95, 0.5, 1.2, dev)
        self.state["done"][:] = True  # all slots idle

        self._free: List[int] = list(range(n_slots))
        self._queues: Dict[int, asyncio.Queue] = {}
        self._pos_host: Dict[int, int] = {}  # host-tracked cache fill per slot
        self._produced: Dict[int, int] = {}
        self._caps: Dict[int, int] = {}
        self._lookahead: Dict[int, int] = {}
        self._cancels: Dict[int, Optional[CancellationToken]] = {}
        self._stats: Dict[int, Optional[Dict]] = {}
        self._pending: "asyncio.Queue[_Submission]" = asyncio.Queue()
        # high-watermark of slots decoded in one slice (shows that continuous
        # batching batches)
        self.max_active_seen = 0
        # first-audio gate (the engine wires S3GenScheduler.wait_dispatch):
        # after a slice in which a fresh look-ahead slot produced its first
        # tokens, the loop waits (bounded) for the next S3Gen batch to be
        # issued, so that request's first synthesis is queued on the device
        # ahead of the next decode slice
        self.first_audio_gate = None
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    # ------------------------------------------------------ device steps (sync)
    def insert(self, slot: int, cond_lanes: torch.Tensor, text: np.ndarray, text_len: int,
               temperature: float, top_p: float, cfg_weight: float, rep_penalty: float,
               seed: int) -> None:
        """Prefill one chunk into lanes 2·slot, 2·slot+1 of the cache (in
        place, quantising for int8) and reset the slot's decode-state row."""
        args = (slot, cond_lanes, text, text_len, temperature, top_p, cfg_weight, rep_penalty,
                seed)
        if self.calls is None:
            return self._insert(*args)
        return self.calls.decoder_insert(self, *args)

    def finish(self, slot: int) -> None:
        if self.calls is None:
            return self._finish(slot)
        return self.calls.decoder_finish(self, slot)

    def run_slice(self, n_steps: int, s_view: int):
        """One decode slice over every slot → (tokens [N, n_steps], done [N])
        as numpy, in one device-to-host copy. ``s_view`` must exceed every
        active lane's pos + n_steps: the cache is resized to hold it."""
        if self.calls is None:
            return self._run_slice(n_steps, s_view)
        return self.calls.decoder_run_slice(self, n_steps, s_view)

    @torch.inference_mode()
    def _insert(self, slot: int, cond_lanes: torch.Tensor, text: np.ndarray, text_len: int,
                temperature: float, top_p: float, cfg_weight: float, rep_penalty: float,
                seed: int, tp_group=None) -> None:
        cfg, dev = self.cfg, self.device
        # the prefix and the first step's write at P
        self._resize(self._capacity(cond_lanes.shape[1] + text.shape[1] + 1, shrink=False))
        text_t = torch.as_tensor(text, device=dev)
        tlen = torch.full((2,), text_len, dtype=torch.int64, device=dev)
        k, v, pad = t3_prefill_raw(self.params, cfg, cond_lanes, text_t, tlen, tp_group)
        P = k.shape[2]
        lanes = slice(2 * slot, 2 * slot + 2)
        if "k_scale" in self.cache:
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            parts = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            parts = {"k": k, "v": v}
        for name, x in parts.items():
            # [L, 2, P, Hk, …] → each layer's [2, Hk, P, …]
            for layer, xi in zip(self.cache[name], x.transpose(2, 3)):
                layer[lanes, :, :P] = xi
        self.cache["start"][lanes] = pad
        self.cache["pos"][lanes] = P
        st = self.state
        st["last_token"][slot] = cfg.start_speech_token
        st["step"][slot] = 0
        st["done"][slot] = False
        st["token_counts"][slot] = 0
        st["temperature"][slot] = temperature
        st["top_p"][slot] = top_p
        st["cfg_weight"][slot] = cfg_weight
        st["rep_penalty"][slot] = rep_penalty
        # seeded only by the request: reproducible whatever the co-tenants
        st["seed"][slot] = int(seed) & 0x7FFFFFFF

    @torch.inference_mode()
    def _finish(self, slot: int) -> None:
        self.state["done"][slot] = True

    def _view_for(self, n_steps: int, slots) -> int:
        """Attention view for a slice: the 256-bucket of max(pos) + n_steps + 1
        over ``slots``. Only the plain attention reads up to it; the kernel
        stops at each row's own pos."""
        return self._bucket(max(self._pos_host[s] for s in slots) + n_steps + 1)

    def _bucket(self, positions: int) -> int:
        """The 256-bucket that holds ``positions``, at most max_seq_len."""
        return min(self.cfg.max_seq_len, -(-positions // CACHE_BUCKET) * CACHE_BUCKET)

    def _capacity(self, positions: int, shrink: bool) -> int:
        """The capacity for a prefill or (``shrink``) a slice that reaches
        ``positions``: their bucket when it is larger than C; on a slice also
        when it is at most C/2 (so slots that straddle a bucket do not resize
        every slice); else C."""
        want = self._bucket(positions)
        if want > self.rows or (shrink and 2 * want <= self.rows):
            return want
        return self.rows

    @torch.inference_mode()
    def _resize(self, rows: int) -> None:
        """Move the cache to ``rows`` positions, one layer's tensor at a
        time, so that the transient above the larger cache is one layer's
        tensor. Every rank under tensor parallelism resizes here from the
        same arguments."""
        if rows == self.rows:
            return
        with metrics.span("t3.cache.resize", rows_from=self.rows, rows_to=rows):
            if rows < self.rows:
                # idle lanes still write at their pos every step: a stale pos
                # past the new capacity restarts at 0 (active lanes lie inside
                # the view)
                stale = self.cache["pos"] >= rows
                self.cache["start"].masked_fill_(stale, 0)
                self.cache["pos"].masked_fill_(stale, 0)
            keep = min(self.rows, rows)
            for name in ("k", "v", "k_scale", "v_scale"):
                layers = self.cache.get(name, ())
                for i in range(len(layers)):
                    layers[i] = _moved(layers[i], rows, keep)
            self.rows = rows

    @torch.inference_mode()
    def _run_slice(self, n_steps: int, s_view: int, tp_group=None):
        self._resize(self._capacity(s_view, shrink=True))
        with metrics.span("t3.slice.enqueue", steps=n_steps):
            toks = t3_decode_slice(self.params, self.cfg, self.cache, self.state, n_steps,
                                   s_view, tp_group=tp_group)
            out = torch.cat([toks, self.state["done"][:, None].to(toks.dtype)], dim=1)
        with metrics.span("t3.slice.fetch"):
            out = out.cpu()
        out = out.numpy()
        return out[:, :n_steps], out[:, n_steps].astype(bool)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        """(Re)start the loop on the current event loop. The decoder may
        outlive a loop (warm-up in one ``asyncio.run``, serving in another);
        a task bound to a dead loop is replaced with its loop primitives."""
        loop = asyncio.get_running_loop()
        if self._task is not None and not self._task.done() and self._loop is loop:
            return
        self._loop = loop
        self._wake = asyncio.Event()
        self._pending = asyncio.Queue()
        self._task = loop.create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    # -------------------------------------------------------------- client
    async def decode_chunk(
        self,
        cond_lanes: torch.Tensor,
        text: np.ndarray,
        text_len: int,
        temperature: float,
        top_p: float,
        cfg_weight: float,
        rep_penalty: float,
        max_new_tokens: int,
        cancellation: Optional[CancellationToken] = None,
        seed: int = 0,
        lookahead: int = 0,
        stats: Optional[Dict] = None,
    ) -> AsyncGenerator[np.ndarray, None]:
        """Yield EOS-trimmed token slices for one text chunk, which holds one
        slot until EOS, its cap or cancellation. ``lookahead`` > 0 asks for
        the first tokens through a short slice (first-audio latency)."""
        self.start()
        fut = asyncio.get_running_loop().create_future()
        rid = current_request.get()
        await self._pending.put(_Submission(
            cond_lanes, text, text_len, temperature, top_p, cfg_weight, rep_penalty,
            max_new_tokens, cancellation, fut, seed, lookahead, stats, rid,
            metrics.span("t3.admit_wait", request=rid).open()))
        self._wake.set()
        slot = await fut
        queue = self._queues[slot]
        while True:
            item = await queue.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item

    # ------------------------------------------------------------ scheduler
    async def _admit(self) -> None:
        while self._free and not self._pending.empty():
            sub = self._pending.get_nowait()
            if sub.cancellation is not None and sub.cancellation.is_cancelled():
                # the waiter may already be cancelled, leaving its future done
                if not sub.slot_future.done():
                    sub.slot_future.set_exception(asyncio.CancelledError())
                continue
            slot = self._free.pop(0)
            sub.wait.set(slot=slot)
            sub.wait.close()
            P = self.cfg.cond_len + sub.text.shape[1]
            try:
                with metrics.span("t3.prefill", stage="t3_prefill_device", request=sub.rid,
                                  positions=P) as prefill:
                    await asyncio.to_thread(
                        self.insert, slot, sub.cond_lanes, sub.text, sub.text_len,
                        sub.temperature, sub.top_p, sub.cfg_weight, sub.rep_penalty, sub.seed)
            except Exception as exc:
                # the submission is off the pending queue: fail its future here
                self._free.insert(0, slot)
                if not sub.slot_future.done():
                    sub.slot_future.set_exception(DecodeError(f"prefill insert failed: {exc}"))
                raise
            if sub.stats is not None:
                sub.stats["t3_s"] += prefill.dt
            if sub.slot_future.done():
                # the waiter was cancelled during the prefill: park the slot
                self.finish(slot)
                self._free.insert(0, slot)
                continue
            self._queues[slot] = asyncio.Queue()
            self._pos_host[slot] = P
            self._produced[slot] = 0
            # the cache holds at most max_seq_len positions: a slot's last
            # slice may overshoot its cap by up to one slice, and every write
            # must stay inside
            longest = max(self.slice_size, LOOKAHEAD_STEPS[-1])
            self._caps[slot] = min(sub.max_new_tokens, self.cfg.max_seq_len - P - longest)
            self._lookahead[slot] = min(sub.lookahead, LOOKAHEAD_STEPS[-1])
            self._cancels[slot] = sub.cancellation
            self._stats[slot] = sub.stats
            sub.slot_future.set_result(slot)

    def _release(self, slot: int) -> None:
        q = self._queues.pop(slot, None)
        if q is not None:
            q.put_nowait(None)
        for d in (self._pos_host, self._produced, self._caps, self._lookahead, self._cancels,
                  self._stats):
            d.pop(slot, None)
        self._free.append(slot)

    async def _run(self) -> None:
        cfg = self.cfg
        try:
            while True:
                await self._admit()
                active = [s for s in range(self.n_slots) if s in self._queues]
                if not active:
                    self._wake.clear()
                    await self._wake.wait()
                    continue

                # cancellations → force slots done
                for slot in list(active):
                    tok = self._cancels.get(slot)
                    if tok is not None and tok.is_cancelled():
                        self.finish(slot)
                        self._release(slot)
                        active.remove(slot)
                if not active:
                    continue
                self.max_active_seen = max(self.max_active_seen, len(active))

                # a fresh look-ahead admission gets a short slice so its first
                # audio does not wait behind a full slice for every slot
                fresh_la = [self._lookahead[s] for s in active
                            if self._produced.get(s, 1) == 0 and self._lookahead.get(s, 0) > 0]
                n_steps = (next(n for n in LOOKAHEAD_STEPS if n >= max(fresh_la)) if fresh_la
                           else self.slice_size)
                s_view = self._view_for(n_steps, active)

                with metrics.span("t3.slice", stage="t3_decode_device", items=len(active),
                                  steps=n_steps, slots=len(active)) as sl:
                    tokens, done = await asyncio.to_thread(self.run_slice, n_steps, s_view)
                    sl.set(cache_rows=self.rows)
                dt = sl.dt
                for s in active:
                    self._pos_host[s] += n_steps
                    st = self._stats.get(s)
                    if st is not None:
                        st["t3_s"] += dt
                        st["t3_steps"] += n_steps

                # slots whose first tokens this slice begin a first-audio path
                fresh_first = [s for s in active
                               if self._produced.get(s) == 0 and self._lookahead.get(s, 0) > 0]

                for slot in active:
                    row = tokens[slot]
                    eos = np.where(row == cfg.stop_speech_token)[0]
                    if len(eos):
                        row = row[: eos[0]]
                    remaining = self._caps[slot] - self._produced[slot]
                    row = row[:remaining]
                    if len(row):
                        self._produced[slot] += len(row)
                        self._queues[slot].put_nowait(row)
                    finished = bool(done[slot]) or self._produced[slot] >= self._caps[slot]
                    if finished:
                        if not bool(done[slot]):
                            self.finish(slot)
                        self._release(slot)

                if self.first_audio_gate is not None and any(
                    self._produced.get(s, 0) > 0 or s not in self._queues for s in fresh_first
                ):
                    # bounded: a timeout only means the next slice starts on time
                    try:
                        with metrics.span("t3.gate_wait"):
                            await self.first_audio_gate()
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        log.warning("first-audio gate failed", exc_info=True)
                        self.first_audio_gate = None
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            log.exception("Batched decoder loop crashed")
            err = DecodeError(f"batched decoder crashed: {exc}")
            # fail queued submissions loudly (their futures would never resolve)
            while not self._pending.empty():
                sub = self._pending.get_nowait()
                if not sub.slot_future.done():
                    sub.slot_future.set_exception(err)
            # active requests get the error before the end sentinel, so they
            # fail instead of completing with truncated audio
            for slot in list(self._queues):
                self._queues[slot].put_nowait(err)
                self._release(slot)
            self._task = None  # a fresh start() spins a new loop
