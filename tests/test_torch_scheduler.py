"""The port's continuous-batching T3 decoder on the CPU (tiny model).

The six cases of tests/test_scheduler.py on
``chatterbox_tpu_torch.runtime.scheduler.BatchedT3Decoder``, and four that
hold it to the JAX package's decoder and to its own contract:

* greedy parity: three concurrent requests through the port's decoder give
  exactly the tokens the JAX ``BatchedT3Decoder`` gives them;
* co-tenant independence: a sampled request gives the same tokens alone in
  slot 0 as beside two co-tenants in slot 2 (each slot samples from its own
  seed and step);
* a reused slot's stale cache entries past ``pos`` (here overwritten with
  garbage) do not change its tokens;
* a crash of the loop fails the active and the queued requests loudly.

And the cache's capacity C (``BatchedT3Decoder.rows``), on a config whose
cache spans three 256-buckets (``LONG``, max_seq_len 768):

* ``_capacity``: a slice grows C to its view's bucket when that is larger
  and shrinks it only to a view at most C/2; a prefill only grows it; it
  never passes max_seq_len;
* a long chunk grows C to max_seq_len, a medium one that outlives it keeps
  C (its view is more than C/2), a short one after both shrinks C to 256,
  where the medium one's lanes lie past it: greedy and sampled tokens equal
  a decoder pinned at max_seq_len (the cache before C followed the reach),
  int8 and native;
* a resize holds at most one layer's share above the larger cache (the
  live cache tensors counted on the CPU while it runs).

Both packages get the JAX init's parameters (converted) and the same
conditioning lanes; ``LONG`` runs on the port's own init.
"""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tree_to_np, to_t

from chatterbox_tpu.models.t3 import T3Config as JT3Config
from chatterbox_tpu.models.t3 import cond_embeddings, init_t3_params
from chatterbox_tpu.runtime.scheduler import BatchedT3Decoder as JBatchedT3Decoder
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.models.t3 import T3Config
from chatterbox_tpu_torch.models.t3 import cond_embeddings as tcond_embeddings
from chatterbox_tpu_torch.models.t3 import init_t3_params as tinit_t3_params
from chatterbox_tpu_torch.runtime import scheduler
from chatterbox_tpu_torch.runtime.cancellation import CancellationToken
from chatterbox_tpu_torch.runtime.scheduler import BatchedT3Decoder, DecodeError

CFG = T3Config.tiny()
# tiny, with room for 600 speech tokens: max_seq_len 768, three buckets
LONG = T3Config.tiny().with_(max_speech_tokens=600)


@pytest.fixture(scope="module")
def setup():
    jcfg = JT3Config.tiny()
    jparams = init_t3_params(jax.random.PRNGKey(0), jcfg)
    spk = jnp.ones((1, jcfg.speaker_embed_dim)) * 0.1
    prompt = jnp.zeros((1, jcfg.speech_cond_prompt_len), jnp.int32)
    cond = cond_embeddings(jparams, jcfg, spk, prompt, jnp.full((1,), 0.5))
    uncond = cond_embeddings(jparams, jcfg, jnp.zeros_like(spk), prompt, jnp.zeros((1,)))
    lanes = np.asarray(jnp.concatenate([cond, uncond], 0))
    return jparams, convert_params(jax_tree_to_np(jparams), "cpu"), lanes


def _text(tokens, T_pad=8):
    ids = np.asarray(tokens, np.int64)
    out = np.zeros((2, T_pad), np.int64)
    out[:, : len(ids)] = ids
    return out, len(ids)


async def _collect(decoder, lanes, text, tlen, max_new=24, token=None, temperature=0.8,
                   seed=0, lookahead=0):
    rows = []
    async for row in decoder.decode_chunk(lanes, text, tlen, temperature, 0.95, 0.5, 1.2,
                                          max_new, token, seed=seed, lookahead=lookahead):
        rows.append(row)
    return np.concatenate(rows) if rows else np.zeros((0,), np.int64)


def _run(params, n_slots, slice_size, body):
    async def run():
        dec = BatchedT3Decoder(params, CFG, n_slots=n_slots, slice_size=slice_size)
        try:
            return await body(dec)
        finally:
            dec.stop()

    return asyncio.run(run())


def test_single_request_roundtrip(setup):
    _, params, lanes = setup
    text, tlen = _text([255, 5, 6, 0])
    toks = _run(params, 4, 6, lambda dec: _collect(dec, to_t(lanes), text, tlen, max_new=20))
    assert 1 <= len(toks) <= 20
    assert (toks < CFG.num_speech_codes).all()  # EOS trimmed out


def test_concurrent_requests_share_batch(setup):
    _, params, lanes = setup
    text, tlen = _text([255, 7, 8, 9, 0])

    async def body(dec):
        out = await asyncio.gather(*[
            _collect(dec, to_t(lanes), text, tlen, max_new=18, seed=i) for i in range(6)])
        return out, dec.max_active_seen

    results, max_active = _run(params, 4, 6, body)
    assert len(results) == 6  # 6 requests through 4 slots
    assert max_active == 4
    for toks in results:
        assert 1 <= len(toks) <= 18
        assert (toks < CFG.num_speech_codes).all()


def test_slot_reuse_and_cap(setup):
    _, params, lanes = setup
    text, tlen = _text([255, 3, 0])

    async def body(dec):
        a = await _collect(dec, to_t(lanes), text, tlen, max_new=8)
        b = await _collect(dec, to_t(lanes), text, tlen, max_new=8)
        assert len(dec._free) == 2  # both slots returned
        return a, b

    a, b = _run(params, 2, 4, body)
    assert len(a) <= 8 and len(b) <= 8


def test_queued_waiter_cancelled_while_slots_busy(setup):
    """A request cancelled while queued for a slot leaves its slot future
    cancelled; admission must not resolve it again (InvalidStateError would
    kill the loop and fail every request in flight)."""
    _, params, lanes = setup
    text, tlen = _text([255, 4, 0])

    async def body(dec):
        holder = asyncio.create_task(_collect(dec, to_t(lanes), text, tlen, max_new=200))
        await asyncio.sleep(0.3)  # holder admitted, decoding
        waiter = asyncio.create_task(_collect(dec, to_t(lanes), text, tlen, max_new=8))
        await asyncio.sleep(0.05)
        waiter.cancel()
        with pytest.raises(asyncio.CancelledError):
            await waiter
        toks = await asyncio.wait_for(holder, timeout=120)
        # a third request must still be served (loop alive, slot free)
        toks2 = await asyncio.wait_for(
            _collect(dec, to_t(lanes), text, tlen, max_new=8), timeout=120)
        return toks, toks2

    toks, toks2 = _run(params, 1, 4, body)
    assert len(toks) >= 1 and len(toks2) >= 1


def test_lookahead_short_first_slice(setup):
    """A submission with lookahead > 0 gets its first tokens from a short
    slice: the first row holds at most the snapped look-ahead length."""
    _, params, lanes = setup
    text, tlen = _text([255, 5, 6, 0])

    async def body(dec):
        rows = []
        async for row in dec.decode_chunk(to_t(lanes), text, tlen, 0.8, 0.95, 0.5, 1.2, 40,
                                          None, lookahead=4):
            rows.append(row)
        return rows

    rows = _run(params, 2, 16, body)
    assert rows, "no tokens produced"
    assert len(rows[0]) <= 8, len(rows[0])  # LOOKAHEAD_STEPS[0] >= 4, under slice 16


def test_cancellation_releases_slot(setup):
    _, params, lanes = setup
    text, tlen = _text([255, 4, 0])

    async def body(dec):
        token = CancellationToken()

        async def consume():
            got = 0
            async for row in dec.decode_chunk(to_t(lanes), text, tlen, 0.8, 0.95, 0.5, 1.2,
                                              1000, token):
                got += len(row)
                token.cancel()
            return got

        got = await asyncio.wait_for(consume(), timeout=60)
        await asyncio.sleep(0.2)
        assert len(dec._free) == 2
        return got

    assert _run(params, 2, 4, body) >= 0


REQUESTS = [([255, 5, 6, 0], 20), ([255, 7, 8, 9, 10, 11, 0], 26), ([255, 3, 0], 14)]


def test_greedy_tokens_match_jax_decoder(setup):
    """Three concurrent greedy requests (4 slots): the port's tokens equal
    the JAX decoder's, request by request."""
    jparams, params, lanes = setup

    async def jax_run():
        dec = JBatchedT3Decoder(jparams, JT3Config.tiny(), n_slots=4, slice_size=6)
        try:
            async def one(ids, cap):
                text, tlen = _text(ids)
                rows = [r async for r in dec.decode_chunk(
                    lanes, text.astype(np.int32), tlen, 0.0, 0.95, 0.5, 1.2, cap, None)]
                return np.concatenate(rows) if rows else np.zeros((0,), np.int64)
            return await asyncio.gather(*[one(ids, cap) for ids, cap in REQUESTS])
        finally:
            dec.stop()

    async def body(dec):
        return await asyncio.gather(*[
            _collect(dec, to_t(lanes), *_text(ids), max_new=cap, temperature=0.0)
            for ids, cap in REQUESTS])

    want = asyncio.run(jax_run())
    got = _run(params, 4, 6, body)
    for g, w in zip(got, want):
        assert len(w) > 0
        np.testing.assert_array_equal(g, np.asarray(w))


def test_sampled_tokens_do_not_depend_on_slot_or_cotenants(setup):
    """temperature 0.8: alone in slot 0, and in slot 2 beside two co-tenants
    admitted first, the request gives the same tokens."""
    _, params, lanes = setup
    text, tlen = _text([255, 5, 6, 0])

    async def alone(dec):
        return await _collect(dec, to_t(lanes), text, tlen, max_new=24, seed=77)

    async def crowded(dec):
        others = [asyncio.create_task(_collect(dec, to_t(lanes), *_text(ids), max_new=30,
                                               seed=s))
                  for ids, s in (([255, 9, 9, 9, 9, 0], 1), ([255, 4, 0], 2))]
        await asyncio.sleep(0)  # the co-tenants queue first: slots 0 and 1
        mine = await _collect(dec, to_t(lanes), text, tlen, max_new=24, seed=77)
        await asyncio.gather(*others)
        return mine, dec.max_active_seen

    a = _run(params, 4, 6, alone)
    b, max_active = _run(params, 4, 6, crowded)
    assert max_active == 3
    assert len(a) > 0
    np.testing.assert_array_equal(a, b)


def test_stale_cache_past_pos_is_not_read(setup):
    """A slot reused after a longer request, with garbage written past the
    new request's prefill, gives the tokens a fresh decoder gives."""
    _, params, lanes = setup
    text, tlen = _text([255, 5, 6, 0])
    P = CFG.cond_len + text.shape[1]

    async def fresh(dec):
        return await _collect(dec, to_t(lanes), text, tlen, max_new=24, seed=5)

    async def reused(dec):
        await _collect(dec, to_t(lanes), *_text([255, 1, 2, 3, 4, 5, 6, 0]), max_new=40, seed=9)
        with torch.inference_mode():
            for name, val in (("k", 1e4), ("v", -1e4)):
                for layer in dec.cache[name]:
                    layer[0:2, :, P:] = val  # slot 0's lanes, past the prefix
        return await _collect(dec, to_t(lanes), text, tlen, max_new=24, seed=5)

    a = _run(params, 1, 6, fresh)
    b = _run(params, 1, 6, reused)
    assert len(a) > 0
    np.testing.assert_array_equal(a, b)


def test_loop_crash_fails_active_and_queued_requests(setup):
    """A slice that raises kills the loop: the request in the slot and the
    one queued behind it both fail with DecodeError instead of hanging or
    ending with truncated tokens; a fresh request then starts a new loop."""
    _, params, lanes = setup
    text, tlen = _text([255, 5, 6, 0])

    async def body(dec):
        real = dec.run_slice

        def broken(*args):
            raise RuntimeError("synthetic device fault")

        dec.run_slice = broken
        outs = await asyncio.wait_for(asyncio.gather(
            *[_collect(dec, to_t(lanes), text, tlen, max_new=8) for _ in range(2)],
            return_exceptions=True), timeout=60)
        dec.run_slice = real
        again = await asyncio.wait_for(_collect(dec, to_t(lanes), text, tlen, max_new=8), 60)
        return outs, again

    outs, again = _run(params, 1, 4, body)
    assert all(isinstance(o, DecodeError) and "synthetic" in str(o) for o in outs), outs
    assert len(again) >= 1


# ------------------------------------------------- the cache's capacity C
def long_model(cfg=LONG):
    """The port's init at ``cfg`` and its conditioning lanes [2, C, D]."""
    params = tinit_t3_params(cfg, torch.Generator().manual_seed(0), "cpu")
    spk = torch.full((1, cfg.speaker_embed_dim), 0.1)
    prompt = torch.zeros((1, cfg.speech_cond_prompt_len), dtype=torch.int64)
    with torch.inference_mode():
        cond = tcond_embeddings(params, cfg, spk, prompt, torch.full((1,), 0.5))
        uncond = tcond_embeddings(params, cfg, torch.zeros_like(spk), prompt, torch.zeros(1))
    return params, torch.cat([cond, uncond], 0)


class PinnedDecoder(BatchedT3Decoder):
    """The cache held at max_seq_len whatever the slots reach."""

    def _capacity(self, positions, shrink):
        return self.cfg.max_seq_len


def watch_resizes(dec):
    """→ the list that each resize of ``dec`` appends (rows from, rows to) to."""
    seen, real = [], dec._resize

    def spy(rows):
        if rows != dec.rows:
            seen.append((dec.rows, rows))
        real(rows)

    dec._resize = spy
    return seen


# P = LONG.cond_len + 8 = 14; slices of 20: the long chunk (cap 734) reaches
# 754 positions, the medium one (admitted at the long one's 400th token,
# cap 400) about 420, the short one 44
REACH_SLICE = 20
REACH_RESIZES = [(256, 512), (512, 768), (768, 256)]


async def reach_scenario(dec, lanes, temperature):
    """A long chunk; a medium one admitted once the long one has 400 tokens,
    which outlives it; then a short one → their tokens."""
    half = asyncio.Event()

    async def long():
        rows, got = [], 0
        try:
            async for row in dec.decode_chunk(lanes, *_text([255, 5, 6, 0]), temperature, 0.95,
                                              0.5, 1.2, 2000, None, seed=1):
                rows.append(row)
                got += len(row)
                if got >= 400:
                    half.set()
        finally:
            half.set()
        return np.concatenate(rows)

    async def medium():
        await half.wait()
        return await _collect(dec, lanes, *_text([255, 7, 8, 0]), max_new=400,
                              temperature=temperature, seed=2)

    a, d = await asyncio.gather(long(), medium())
    e = await _collect(dec, lanes, *_text([255, 3, 0]), max_new=30, temperature=temperature,
                       seed=3)
    return [a, d, e]


@pytest.mark.parametrize("rows, positions, shrink, want", [
    (256, 256, True, 256),     # fits
    (256, 257, True, 512),     # crosses a bucket: grow
    (256, 10_000, True, 768),  # never past max_seq_len
    (768, 512, True, 768),     # a view above C/2: keep
    (768, 300, True, 768),     # its view 512, above C/2: keep
    (768, 256, True, 256),     # a view at most C/2: shrink to it
    (768, 20, True, 256),
    (512, 256, True, 256),
    (768, 20, False, 768),     # a prefill never shrinks
    (256, 300, False, 512),
], ids=lambda v: str(v))
def test_capacity_grows_past_a_bucket_and_shrinks_at_half(rows, positions, shrink, want):
    params, _ = long_model()
    dec = BatchedT3Decoder(params, LONG, n_slots=1, slice_size=REACH_SLICE)
    assert LONG.max_seq_len == 768 and dec.rows == 256
    dec.rows = rows
    assert dec._capacity(positions, shrink) == want


@pytest.mark.parametrize("kv, temperature", [("int8", 0.0), ("native", 0.8), ("int8", 0.8)],
                         ids=["greedy-int8", "sampled-native", "sampled-int8"])
def test_capacity_follows_reach_and_keeps_the_pinned_tokens(kv, temperature):
    """C grows to max_seq_len with the long chunk, stays while the medium
    one's view (512) exceeds C/2, and shrinks to 256 for the short one,
    clamping the medium one's released lanes (pos ~434) inside it; every
    chunk's tokens equal those of a decoder pinned at max_seq_len."""
    cfg = LONG.with_(kv_cache_dtype=kv)
    params, lanes = long_model(cfg)

    async def run(cls):
        dec = cls(params, cfg, n_slots=2, slice_size=REACH_SLICE)
        seen = watch_resizes(dec)
        try:
            toks = await reach_scenario(dec, lanes, temperature)
        finally:
            dec.stop()
        return toks, seen, dec

    got, seen, dec = asyncio.run(run(BatchedT3Decoder))
    want, _, pinned = asyncio.run(run(PinnedDecoder))
    assert seen == REACH_RESIZES
    assert dec.rows == 256 and pinned.rows == cfg.max_seq_len
    assert [len(t) for t in got] == [734, 400, 30]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # every lane inside C: the released medium slot's stale pos restarted at 0
    pos, start = dec.cache["pos"], dec.cache["start"]
    assert int(pos.max()) < dec.rows and bool((start <= pos).all())
    assert all(t.shape[2] == dec.rows for name in ("k", "v") for t in dec.cache[name])


@pytest.mark.parametrize("kv", ["int8", "native"])
@pytest.mark.parametrize("rows_from, rows_to", [(256, 768), (768, 256)], ids=["grow", "shrink"])
def test_resize_holds_at_most_one_layer_above_the_larger_cache(monkeypatch, kv, rows_from,
                                                               rows_to):
    """The live cache bytes (every layer tensor that still has a reference)
    at each moved tensor: never more than the larger cache plus one layer's
    share; and the resize does not hold both caches at once."""
    import weakref

    cfg = LONG.with_(kv_cache_dtype=kv, num_layers=6)
    params, _ = long_model(cfg)
    dec = BatchedT3Decoder(params, cfg, n_slots=2, slice_size=REACH_SLICE)
    dec._resize(rows_from)
    names = [n for n in ("k", "v", "k_scale", "v_scale") if n in dec.cache]
    refs = [weakref.ref(t) for n in names for t in dec.cache[n]]

    def live():
        return sum(t.nbytes for t in (r() for r in refs) if t is not None)

    before, peak, real = live(), [0], scheduler._moved

    def spy(old, rows, keep):
        new = real(old, rows, keep)
        refs.append(weakref.ref(new))
        peak[0] = max(peak[0], live())   # the old tensor and its successor
        return new

    monkeypatch.setattr(scheduler, "_moved", spy)
    dec._resize(rows_to)
    after = live()
    assert dec.rows == rows_to and after * rows_from == before * rows_to
    larger = max(before, after)
    assert larger < peak[0] <= larger + larger // cfg.num_layers
    assert peak[0] < before + after
