"""Serving under ``CHATTERBOX_TP=N``: rank 0 runs the engine, ranks 1…N−1
follow it (the port's counterpart of the JAX engine's tensor-parallel
placement, ``chatterbox_tpu/runtime/engine.py:888-911``).

JAX serves tensor-parallel from one process: XLA turns the placed shardings
into collectives. Here every rank is a process holding its shard of T3 and,
for the ref arch, of S3Gen-ref's flow (``parallel/sharding.py``); everything
else is replicated and runs on rank 0 alone: the HTTP app, the text
frontend, the schedulers, sampling noise, voice cloning, HiFT, crossfade
and encoding. Each sharded call runs in step on every rank.

``ShardedCalls`` holds those calls. Rank 0's engine and schedulers call its
methods (without tensor parallelism each is the plain call); a follower's
loop calls the same methods with the arguments rank 0 sent, so one body
serves both sides. A call goes through its group's ``Channel``:

* Two groups, one for the T3 calls and one for the S3Gen calls, since rank 0
  issues them from different threads and two threads' collectives on one
  group would interleave. On rank 0 each channel has a lock that
  serialises its calls; on a follower one thread per group loops. On a
  card each group's calls run on a CUDA stream of their own, on every
  rank: on one shared stream the two groups' collectives would queue
  behind each other in each rank's own order, and NCCL then deadlocks.
* A call's header (its name, plain arguments, handles, tensor shapes and
  dtypes, the handles to free) goes to each follower through a pipe; its
  tensors follow as broadcasts over the group; then the call runs on every
  rank with the group as its ``tp_group``.
* State a follower keeps between calls (a per-request T3 cache and decode
  state, a voice's CFM prompt cache, a request's streaming state, the
  batched decoder) lives under a handle. On rank 0 the object is a
  ``Mirrored`` dict carrying that handle; when rank 0 drops its last
  reference (the request finished, failed or was cancelled; the voice was
  cleared or evicted) the handle joins the channel's free list, which the
  next call's header carries.
* Noise is drawn on rank 0 only; a follower gets the CFM noise it needs in
  the call's tensors and draws nothing. Sampling keeps no state
  (``ops/sampling.py``), so every rank samples and takes the same tokens;
  each rank folds the tokens of every T3 call into a digest
  (``ShardedCalls.stats``) that tests and ``chip_smoke.py`` compare.
* A follower stops after the flow: it computes no excitation and runs no
  HiFT, whose output nobody would read.

No fallback: a follower that has exited, or a collective that fails or
passes its group's timeout (GROUP_TIMEOUT_S),
makes the call raise, and every later call raises at once. The engine never
carries on with fewer ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import multiprocessing
import os
import queue
import tempfile
import threading
import time
import traceback
import weakref
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..logging_config import log
from ..models.s3gen_ref import (
    init_s3gen_stream_state,
    s3gen_ref_flow,
    s3gen_ref_flow_streaming,
    s3gen_ref_inference,
    s3gen_ref_inference_streaming,
    s3gen_ref_inference_tail,
    s3gen_ref_prompt_prefill,
    split_stream_state,
    stack_stream_states,
)
from ..models.s3gen_ref.decoder import static_prompt_cache
from ..models.t3 import make_decode_state, t3_decode_slice, t3_prefill
from ..ops import decode_attention, flash_mha
from ..parallel.mesh import backend_for
from ..parallel.sharding import check_tp, shard_s3gen_ref_params, shard_t3_params

# how long rank 0 waits for the followers to build their weights and report
STARTUP_TIMEOUT_S = 900.0
# how long shutdown waits for a follower to exit after the stop call
STOP_TIMEOUT_S = 30.0
# how long a collective of either group waits for its peers
GROUP_TIMEOUT_S = 300.0
# handles, unique across both groups (a follower keeps them in one table)
_HANDLES = itertools.count(1)


def tp_size() -> int:
    """``CHATTERBOX_TP`` as the JAX engine reads it (unset, 0 or 1: none)."""
    return int(os.environ.get("CHATTERBOX_TP", "0") or 0)


class TPError(RuntimeError):
    """A follower or a collective failed: tensor-parallel serving stops."""


class Mirrored(dict):
    """A rank-0 dict whose counterparts on the followers live under
    ``handle``."""
    __slots__ = ("handle", "__weakref__")


def _handle(obj) -> Optional[int]:
    return None if obj is None else obj.handle


class LocalChannel:
    """No tensor parallelism: a call runs here alone, with no group."""
    leader = True
    group = None

    @contextlib.contextmanager
    def op(self, name: str, plain=None, refs=None, tensors=None, n_new: int = 0):
        yield None, [None] * n_new

    def keep(self, obj, handle):
        return obj


LOCAL = LocalChannel()


def _flat_tensors(tensors: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{"ref": {"spk_emb": t, …}, "tokens": t} → {"ref.spk_emb": t, …}."""
    out = {}
    for k, v in tensors.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def _nest_tensors(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        if "." in k:
            a, b = k.split(".", 1)
            out.setdefault(a, {})[b] = v
        else:
            out[k] = v
    return out


def _bcast_opts() -> dist.BroadcastOptions:
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    return opts


def _group_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    return torch.cuda.Stream(device) if device.type == "cuda" else None


@contextlib.contextmanager
def _on_stream(stream: Optional[torch.cuda.Stream]):
    """Run the block on ``stream`` after the caller's stream's work, and
    make the caller's stream wait for the block's (no-op on the CPU)."""
    if stream is None:
        yield
        return
    caller = torch.cuda.current_stream(stream.device)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        caller.wait_stream(stream)


class LeaderChannel:
    """Rank 0's end of one group: sends each call to the followers, then
    runs it here."""
    leader = True

    def __init__(self, name: str, group, pipes: List, procs: List, device: torch.device):
        self.name, self.group, self.pipes, self.procs = name, group, pipes, procs
        self.stream = _group_stream(device)
        self.lock = threading.Lock()
        self.free: List[int] = []
        self.free_lock = threading.Lock()
        self.broken: Optional[str] = None

    def _check(self) -> None:
        if self.broken is not None:
            raise TPError(f"tensor-parallel serving stopped: {self.broken}")
        dead = [r for r, p in enumerate(self.procs, start=1) if not p.is_alive()]
        if dead:
            self.broken = f"follower rank(s) {dead} exited (code {self.procs[dead[0] - 1].exitcode})"
            raise TPError(f"tensor-parallel serving stopped: {self.broken}")

    def _free(self, handle: int) -> None:
        with self.free_lock:
            self.free.append(handle)

    def keep(self, obj, handle):
        """``obj`` as a ``Mirrored`` dict under ``handle``; the followers drop
        theirs once this one is gone."""
        m = Mirrored(obj)
        m.handle = handle
        weakref.finalize(m, self._free, handle)
        return m

    def send(self, header: Dict) -> None:
        for pipe in self.pipes:
            pipe.send(header)

    @contextlib.contextmanager
    def op(self, name: str, plain=None, refs=None, tensors=None, n_new: int = 0):
        """→ (the group, ``n_new`` fresh handles) for the call's body, which
        runs under this channel's lock after the followers got the call."""
        with self.lock:
            self._check()
            flat = {k: v.contiguous() for k, v in _flat_tensors(tensors or {}).items()}
            new = [next(_HANDLES) for _ in range(n_new)]
            with self.free_lock:
                free, self.free = self.free, []
            header = {"op": name, "plain": plain or {}, "new": new, "free": free,
                      "refs": {k: ([_handle(x) for x in v] if isinstance(v, list) else _handle(v))
                               for k, v in (refs or {}).items()},
                      "tensors": [(k, tuple(v.shape), v.dtype) for k, v in flat.items()]}
            try:
                self.send(header)
                with _on_stream(self.stream):
                    # a CUDA broadcast over gloo writes the root's tensor
                    # back too: allowed on inference tensors in inference mode
                    with torch.inference_mode():
                        for v in flat.values():
                            self.group.broadcast([v], _bcast_opts()).wait()
                    yield self.group, new
            except Exception as exc:
                self.broken = f"{self.name} call {name!r} failed: {exc!r}"
                raise

    def stop(self) -> None:
        with self.lock:
            try:
                self.send({"op": "stop", "free": []})
            except (OSError, ValueError):
                pass
            self.broken = self.broken or "stopped"


class FollowerChannel:
    """A follower's end of one group: the call being replayed gives the
    body its group and the handles rank 0 named."""
    leader = False

    def __init__(self, name: str, group, handles: Dict[int, Any], device: torch.device):
        self.name, self.group, self.handles = name, group, handles
        self.stream = _group_stream(device)
        self.header: Dict = {}

    @contextlib.contextmanager
    def op(self, name: str, plain=None, refs=None, tensors=None, n_new: int = 0):
        yield self.group, self.header["new"]

    def keep(self, obj, handle):
        self.handles[handle] = obj
        return obj


def _ref_flow(ref: Dict) -> Dict:
    """The leaves of a conditioning dict that the flow reads (the x-vector,
    prompt tokens and prompt mel, and their lengths): all of them."""
    return {k: ref[k] for k in ("spk_emb", "prompt_tokens", "prompt_len", "prompt_mel",
                                "prompt_mel_len")}


class ShardedCalls:
    """The calls that run sharded under tensor parallelism, on rank 0 and on
    every follower alike (see the module docstring). ``params``: this rank's
    shard (the full tree without tensor parallelism); ``t3`` / ``s3``: the
    groups' channels (``LOCAL`` without tensor parallelism; ``s3`` is
    ``LOCAL`` for the DiT arch, which runs on rank 0 alone)."""

    def __init__(self, cfg, params: Dict, device: torch.device, t3=LOCAL, s3=LOCAL):
        self.cfg, self.params, self.device = cfg, params, device
        self.t3, self.s3 = t3, s3
        self.decoder = None           # a follower's batched decoder
        self.token_digest = 0         # crc32 over every T3 call's tokens, in order
        self.token_calls = 0

    def record_tokens(self, toks: np.ndarray) -> None:
        self.token_digest = zlib.crc32(np.ascontiguousarray(toks, np.int64).tobytes(),
                                       self.token_digest)
        self.token_calls += 1

    # ------------------------------------------------------ T3, per request
    def t3_prefill(self, cond_lanes: torch.Tensor, lanes: np.ndarray, text_len: int):
        """One chunk's prefill into its own cache (``models.t3.t3_prefill``)."""
        dev = self.device
        with self.t3.op("t3_prefill", plain={"lanes": lanes, "text_len": text_len},
                        tensors={"cond_lanes": cond_lanes}, n_new=1) as (g, new), \
                torch.inference_mode():
            cache = t3_prefill(self.params["t3"], self.cfg.t3, cond_lanes,
                               torch.as_tensor(lanes, device=dev),
                               torch.full((2,), text_len, dtype=torch.int64, device=dev),
                               tp_group=g)
        return self.t3.keep(cache, new[0])

    def t3_state(self, seeds: List[int], temperature: float, top_p: float, cfg_weight: float,
                 rep_penalty: float):
        """A decode state (``models.t3.make_decode_state``)."""
        with self.t3.op("t3_state", plain=dict(seeds=seeds, temperature=temperature,
                                               top_p=top_p, cfg_weight=cfg_weight,
                                               rep_penalty=rep_penalty), n_new=1) as (_, new), \
                torch.inference_mode():
            state = make_decode_state(self.cfg.t3, seeds, temperature, top_p, cfg_weight,
                                      rep_penalty, self.device)
        return self.t3.keep(state, new[0])

    def t3_decode_slice(self, cache, state, n: int, s_view: int) -> np.ndarray:
        """One decode slice on a request's cache and state (both updated in
        place) → its tokens on the host."""
        with self.t3.op("t3_decode_slice", plain={"n": n, "s_view": s_view},
                        refs={"cache": cache, "state": state}) as (g, _), torch.inference_mode():
            toks = t3_decode_slice(self.params["t3"], self.cfg.t3, cache, state, n, s_view,
                                   tp_group=g).cpu().numpy()
        self.record_tokens(toks)
        return toks

    # ------------------------------------------------ T3, the batched decoder
    def make_decoder(self, n_slots: int, slice_size: int):
        """The batched decoder over this rank's shard (every rank builds one:
        its cache holds this rank's kv heads)."""
        from .scheduler import BatchedT3Decoder

        with self.t3.op("make_decoder", plain={"n_slots": n_slots, "slice_size": slice_size}):
            decoder = BatchedT3Decoder(self.params["t3"], self.cfg.t3, n_slots=n_slots,
                                       slice_size=slice_size, calls=self)
        if not self.t3.leader:
            self.decoder = decoder
        return decoder

    def decoder_insert(self, decoder, slot: int, cond_lanes: torch.Tensor, text: np.ndarray,
                       text_len: int, temperature: float, top_p: float, cfg_weight: float,
                       rep_penalty: float, seed: int) -> None:
        decoder = decoder or self.decoder
        with self.t3.op("decoder_insert", plain=dict(
                slot=slot, text=text, text_len=text_len, temperature=temperature, top_p=top_p,
                cfg_weight=cfg_weight, rep_penalty=rep_penalty, seed=seed),
                tensors={"cond_lanes": cond_lanes}) as (g, _):
            decoder._insert(slot, cond_lanes, text, text_len, temperature, top_p, cfg_weight,
                            rep_penalty, seed, g)

    def decoder_finish(self, decoder, slot: int) -> None:
        decoder = decoder or self.decoder
        with self.t3.op("decoder_finish", plain={"slot": slot}):
            decoder._finish(slot)

    def decoder_run_slice(self, decoder, n_steps: int, s_view: int):
        decoder = decoder or self.decoder
        with self.t3.op("decoder_run_slice", plain={"n_steps": n_steps, "s_view": s_view}) \
                as (g, _):
            toks, done = decoder._run_slice(n_steps, s_view, g)
        self.record_tokens(toks)
        return toks, done

    # --------------------------------------------------------------- S3Gen
    def prompt_prefill(self, ref: Dict, noise: torch.Tensor, mode: str):
        """A voice's CFM prompt cache (``s3gen_ref_prompt_prefill``; with
        ``mode`` "static", its last step only)."""
        with self.s3.op("prompt_prefill", plain={"mode": mode},
                        tensors={"ref": _ref_flow(ref), "noise": noise}, n_new=1) as (g, new), \
                torch.inference_mode():
            cache = s3gen_ref_prompt_prefill(self.params["s3gen"], self.cfg.s3gen_ref, ref, noise,
                                             tp_group=g)
            if mode == "static":
                cache = static_prompt_cache(cache)
        return self.s3.keep(cache, new[0])

    def stream_state0(self, cache, window: int, cap_tokens: int):
        """A voice's fresh streaming state (``init_s3gen_stream_state``)."""
        with self.s3.op("stream_state0", plain={"window": window, "cap_tokens": cap_tokens},
                        refs={"cache": cache}, n_new=1) as (_, new), torch.inference_mode():
            state = init_s3gen_stream_state(self.cfg.s3gen_ref, cache, window, cap_tokens)
        return self.s3.keep(state, new[0])

    def s3gen_infer(self, tokens, token_len, ref, noise, cache=None, src=None, cache_len=None,
                    start=None, tail_len: Optional[int] = None):
        """One batched chunk inference: ``s3gen_ref_inference``, or with
        ``start`` ``s3gen_ref_inference_tail``; a follower runs its flow
        only. → (wav or tail, new source) on rank 0, None on a follower."""
        rc = self.cfg.s3gen_ref
        with self.s3.op("s3gen_infer", refs={"cache": cache},
                        tensors={"tokens": tokens, "token_len": token_len, "ref": _ref_flow(ref),
                                 "noise": {"cfm": noise["cfm"]}}) as (g, _), \
                torch.inference_mode():
            p = self.params["s3gen"]
            if not self.s3.leader:
                s3gen_ref_flow(p, rc, tokens, token_len, ref, noise["cfm"], cache, tp_group=g)
                return None
            if start is None:
                return s3gen_ref_inference(p, rc, tokens, token_len, ref, src, cache_len, noise,
                                           cfm_cache=cache, tp_group=g)
            return s3gen_ref_inference_tail(p, rc, tokens, token_len, ref, src, cache_len, noise,
                                            start, tail_len, cfm_cache=cache, tp_group=g)

    def s3gen_flow(self, tokens, token_len, ref, noise, cache=None) -> torch.Tensor:
        """The flow of one batched chunk inference (``s3gen_ref_flow``) → the
        mel, on every rank (a check of the sharded flow)."""
        with self.s3.op("s3gen_flow", refs={"cache": cache},
                        tensors={"tokens": tokens, "token_len": token_len, "ref": _ref_flow(ref),
                                 "noise": {"cfm": noise["cfm"]}}) as (g, _), \
                torch.inference_mode():
            return s3gen_ref_flow(self.params["s3gen"], self.cfg.s3gen_ref, tokens, token_len, ref,
                                  noise["cfm"], cache, tp_group=g)

    def s3gen_stream(self, tokens, token_len, new_len, ref, noise, rstates: List, nb: int, cache,
                     src=None, cache_len=None, start=None, tail_len: Optional[int] = None):
        """One batched streaming call over the jobs' states (stacked, then
        split again) → (tails, new source, the jobs' new states); a follower
        runs its flow only and keeps the new states."""
        rc = self.cfg.s3gen_ref
        with self.s3.op("s3gen_stream", plain={"nb": nb}, refs={"rstates": rstates, "cache": cache},
                        tensors={"tokens": tokens, "token_len": token_len, "new_len": new_len,
                                 "ref": _ref_flow(ref), "noise": {"cfm": noise["cfm"]}},
                        n_new=len(rstates)) as (g, new), torch.inference_mode():
            p = self.params["s3gen"]
            state = stack_stream_states(rstates)
            if self.s3.leader:
                tails, new_src, new_state = s3gen_ref_inference_streaming(
                    p, rc, tokens, token_len, new_len, ref, src, cache_len, noise, start, tail_len,
                    state, nb, cache, tp_group=g)
            else:
                tails = new_src = None
                _, new_state = s3gen_ref_flow_streaming(p, rc, tokens, token_len, new_len, ref,
                                                        noise["cfm"], state, nb, cache, tp_group=g)
        states = [self.s3.keep(st, h)
                  for st, h in zip(split_stream_state(new_state, len(rstates)), new)]
        return tails, new_src, states

    # -------------------------------------------------------------- checks
    def stats(self) -> Dict:
        """This rank's live handles, token digest and T3 call count, and its
        kernel launches (K1's by body, K2's by form)."""
        handles = getattr(self.t3, "handles", None)
        return {"handles": None if handles is None else len(handles),
                "token_digest": self.token_digest, "token_calls": self.token_calls,
                "launches": {"decode_attention": dict(decode_attention.launches),
                             "flash_mha": dict(flash_mha.launches)}}


# ---------------------------------------------------------------------------
# the follower processes
# ---------------------------------------------------------------------------
GROUPS = ("t3", "s3gen")


def _new_group(backend: str, store, name: str, rank: int, n: int, timeout_s: float):
    """A process group of its own over the shared store, outside the default
    group (an engine process may hold several in turn)."""
    prefix = dist.PrefixStore(f"chatterbox-tp/{name}", store)
    timeout = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(prefix, rank, n, opts)
    return dist.ProcessGroupGloo(prefix, rank, n, timeout)


@dataclasses.dataclass
class FollowerSpec:
    """What a follower needs to build its shard: the engine's config and
    seed, and either the model directory or the parameters themselves (the
    port's layout as numpy, with their torch dtypes); and rank 0's number of
    intra-op threads, which it takes too (ranks that each spread over every
    core leave each other's parallel ops waiting on descheduled threads)."""
    cfg: Any
    seed: int
    model_dir: str
    dtype: str
    params: Optional[Dict] = None
    threads: int = dataclasses.field(default_factory=torch.get_num_threads)


def params_to_numpy(params) -> Any:
    """A parameter tree → (numpy leaves, dtype names), to cross a process
    boundary (bf16 as float32, cast back on arrival)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(v) for v in params]
    return (params.detach().float().cpu().numpy() if params.is_floating_point()
            else params.detach().cpu().numpy(), str(params.dtype).split(".")[1])


def params_from_numpy(tree, device) -> Any:
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    a, dtype = tree
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def shard_engine_params(params: Dict, cfg, tp: int, t: int, follower: bool) -> Dict:
    """Rank ``t``'s weights: T3's shard and, for the ref arch, S3Gen-ref's
    (the replicated rest as it is). A follower keeps only what its calls
    read: T3 and S3Gen-ref's flow."""
    out = dict(params)
    out["t3"] = shard_t3_params(params["t3"], cfg.t3, tp, t)
    if cfg.s3gen_arch == "ref":
        out["s3gen"] = shard_s3gen_ref_params(params["s3gen"], cfg.s3gen_ref, tp, t)
        if follower:
            out["s3gen"] = {"flow": out["s3gen"]["flow"]}
    if follower:
        out = {k: v for k, v in out.items() if k in ("t3", "s3gen") and
               (k == "t3" or cfg.s3gen_arch == "ref")}
    return out


def _follow(calls: ShardedCalls, channel: FollowerChannel, pipe, device) -> None:
    """Replay rank 0's calls on one group until the stop call."""
    while True:
        while not pipe.poll(1.0):
            if not multiprocessing.parent_process().is_alive():
                raise TPError("rank 0 exited")
        header = pipe.recv()
        for h in header["free"]:
            channel.handles.pop(h, None)
        if header["op"] == "stop":
            return
        if header["op"] == "stats":
            pipe.send(calls.stats())
            if header.get("reset"):
                decode_attention.reset_launches()
                flash_mha.reset_launches()
            continue
        with _on_stream(channel.stream):
            flat = {}
            with torch.inference_mode():
                for k, shape, dtype in header["tensors"]:
                    t = torch.empty(shape, dtype=dtype, device=device)
                    channel.group.broadcast([t], _bcast_opts()).wait()
                    flat[k] = t
            kwargs = dict(header["plain"])
            for k, h in header["refs"].items():
                kwargs[k] = ([channel.handles[x] for x in h] if isinstance(h, list)
                             else (None if h is None else channel.handles[h]))
            kwargs.update(_nest_tensors(flat))
            if header["op"].startswith("decoder_"):
                kwargs["decoder"] = None
            channel.header = header
            getattr(calls, header["op"])(**kwargs)


def _follower_main(rank: int, n: int, devices: Sequence[str], backend: str, store_path: str,
                   timeout_s: float, spec: FollowerSpec, pipes: Dict, results) -> None:
    try:
        torch.set_num_threads(spec.threads)
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
            from ..ops import _build

            _build.library()   # rank 0 built it before starting the followers
        store = dist.FileStore(store_path, n)
        groups = {name: _new_group(backend, store, name, rank, n, timeout_s) for name in pipes}
        dtype = torch.bfloat16 if spec.dtype == "bfloat16" else torch.float32
        if spec.params is not None:
            params = params_from_numpy(spec.params, device)
        else:
            from .loader import load_params

            params = load_params(spec.model_dir, spec.cfg, dtype, device, spec.seed, {})
        params = shard_engine_params(params, spec.cfg, n, rank, follower=True)
        handles: Dict[int, Any] = {}
        channels = {name: FollowerChannel(name, g, handles, device)
                    for name, g in groups.items()}
        calls = ShardedCalls(spec.cfg, params, device, t3=channels["t3"],
                             s3=channels.get("s3gen", LOCAL))
        results.put((rank, "ready", None))

        def loop(name):
            try:
                _follow(calls, channels[name], pipes[name], device)
            except BaseException:
                log.error("tensor parallel: follower rank %d, %s group:\n%s", rank, name,
                          traceback.format_exc())
                os._exit(1)   # the other group's thread may be blocked in a collective

        threads = [threading.Thread(target=loop, args=(name,), daemon=True) for name in pipes]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


class TPGroup:
    """Rank 0's handle on a tensor-parallel engine's followers: starts them,
    holds the channels, stops them."""

    def __init__(self, cfg, devices: Sequence[str], spec: FollowerSpec):
        self.devices = tuple(str(torch.device(d)) for d in devices)
        self.n = len(self.devices)
        self.backend = backend_for(self.devices)
        self.timeout_s = GROUP_TIMEOUT_S
        names = GROUPS if cfg.s3gen_arch == "ref" else ("t3",)
        check_tp(cfg.t3, self.n)
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory(prefix="chatterbox-tp-")
        store_path = os.path.join(self._tmp.name, "store")
        results = ctx.Queue()
        ends = [{name: ctx.Pipe() for name in names} for _ in range(1, self.n)]
        self.procs = [ctx.Process(
            target=_follower_main, daemon=True, name=f"chatterbox-tp-rank{r}",
            args=(r, self.n, self.devices, self.backend, store_path, self.timeout_s, spec,
                  {name: e[name][1] for name in names}, results))
            for r, e in zip(range(1, self.n), ends)]
        log.info("tensor parallel: starting %d followers on %s over %s", self.n - 1,
                 ", ".join(self.devices[1:]), self.backend)
        for p in self.procs:
            p.start()
        self.channels = {}
        try:
            store = dist.FileStore(store_path, self.n)
            groups = {name: _new_group(self.backend, store, name, 0, self.n, self.timeout_s)
                      for name in names}
            device = torch.device(self.devices[0])
            self.channels = {name: LeaderChannel(name, groups[name], [e[name][0] for e in ends],
                                                 self.procs, device) for name in names}
            self._await_ready(results)
        except BaseException:
            self.close()
            raise

    def _await_ready(self, results) -> None:
        ready, deadline = set(), time.monotonic() + STARTUP_TIMEOUT_S
        while len(ready) < self.n - 1:
            try:
                rank, what, payload = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs, start=1) if not p.is_alive()]
                if dead:
                    raise TPError(f"follower rank(s) {dead} exited during startup")
                if time.monotonic() > deadline:
                    raise TPError(f"followers not ready after {STARTUP_TIMEOUT_S:.0f} s")
                continue
            if what == "error":
                raise TPError(f"follower rank {rank} failed to start:\n{payload}")
            ready.add(rank)

    @property
    def t3(self) -> LeaderChannel:
        return self.channels["t3"]

    @property
    def s3(self):
        return self.channels.get("s3gen", LOCAL)

    def alive(self) -> List[bool]:
        return [p.is_alive() for p in self.procs]

    def follower_stats(self, reset_launches: bool = False) -> List[Dict]:
        """Every follower's ``ShardedCalls.stats()`` once it has dropped the
        handles rank 0 freed (a check for tests and the smoke run); with
        ``reset_launches`` each then sets its kernel launch counts to 0.
        Each group's thread answers in turn, the T3 group's last."""
        out = []
        for ch in self.channels.values():
            with ch.lock:
                ch._check()
                with ch.free_lock:
                    free, ch.free = ch.free, []
                ch.send({"op": "stats", "free": free, "reset": reset_launches})
                out = [self._recv(pipe) for pipe in ch.pipes]
        return out

    def _recv(self, pipe) -> Dict:
        if not pipe.poll(self.timeout_s):
            raise TPError(f"a follower did not answer within {self.timeout_s:.0f} s")
        return pipe.recv()

    def close(self) -> None:
        """Send the stop call, join the followers (killing any that do not
        exit) and drop the groups."""
        for ch in self.channels.values():
            ch.stop()
        deadline = time.monotonic() + STOP_TIMEOUT_S
        for p in self.procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
        self.channels = {}
        self._tmp.cleanup()
