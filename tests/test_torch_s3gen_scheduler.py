"""The port's S3Gen micro-batcher and tail-windowed vocoder on the CPU.

Prompt-cached and streaming jobs: a cached batch equals direct cached calls,
a streaming batch equals direct batch-1 streaming calls (tail, source row
and each job's new state), and jobs with different caches never share a
batch.

After the non-streaming cases of tests/test_s3gen_scheduler.py, on
``chatterbox_tpu_torch.runtime.s3gen_scheduler.S3GenScheduler`` with the
reference architecture at S3GenRefConfig.tiny() (the JAX init, converted,
HiFT conditioned with POST_SCALE so no compared sample clips: at the helper's
default scale these waveforms reach the ±0.99 clip, and the vocoder then
amplifies a 5e-7 batch-size reordering of the mel to 1e-5). Each job's noise
comes from its own seeded generator, so a batched job equals the direct call
on the same draws. The port has no power-of-two padding and no retry at a smaller
batch: a 3-job batch runs 3 lanes, and a failure fails its jobs.

``s3gen_ref_inference_tail`` is held to the JAX package's on the same noise
(1e-4, float32 summation order) and to the port's own full vocode (2e-6, as
tests/test_s3gen_ref.py holds JAX's).
"""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    conditioned_s3gen_params,
    jax_s3gen_noise,
    jax_tree_to_np,
    to_np,
    to_t,
)

from chatterbox_tpu.models.s3gen_ref import hift as jhift
from chatterbox_tpu.models.s3gen_ref import model as jmodel
from chatterbox_tpu.models.s3gen_ref.config import S3GenRefConfig as JCfg
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.models.s3gen_ref import (
    S3GenRefConfig,
    draw_noise,
    init_s3gen_stream_state,
    s3gen_ref_inference,
    s3gen_ref_inference_streaming,
    s3gen_ref_inference_tail,
    s3gen_ref_prompt_prefill,
)
from chatterbox_tpu_torch.models.s3gen_ref.hift import hift_receptive_margin
from chatterbox_tpu_torch.runtime.s3gen_scheduler import (
    MAX_TAIL_TOKENS,
    S3GenScheduler,
    stream_block_tokens,
)

CFG = S3GenRefConfig.tiny()
SPT = CFG.samples_per_token
STATE_TOKENS = 16
BATCH_TOL = 1e-5   # one batched call against B = 1 calls: summation order only
POST_SCALE = 2e-3
TAIL_TOL = 2e-6    # windowed against full vocode of the same batch


@pytest.fixture(scope="module")
def setup():
    jcfg = JCfg.tiny()
    jp = conditioned_s3gen_params(jmodel.init_s3gen_ref_params(jax.random.PRNGKey(2), jcfg), jcfg,
                                  POST_SCALE)
    rng = np.random.default_rng(3)
    ref_np = {
        "spk_emb": rng.standard_normal((1, 192)).astype(np.float32),
        "prompt_tokens": rng.integers(0, 6561, (1, jcfg.max_prompt_tokens)).astype(np.int32),
        "prompt_len": np.array([6], np.int32),
        "prompt_mel": rng.standard_normal((1, jcfg.max_prompt_mel, 80)).astype(np.float32),
        "prompt_mel_len": np.array([12], np.int32),
    }
    ref = {k: to_t(v) for k, v in ref_np.items()}
    return jcfg, jp, convert_params(jax_tree_to_np(jp), "cpu"), ref_np, ref


def _tokens(T, n, seed=0):
    tokens = np.full((T,), CFG.flow.vocab_size, np.int64)
    tokens[:n] = np.random.default_rng(seed).integers(0, 50, n)
    return tokens


def _direct(params, tokens, n, ref, seed, src=None, clen=0):
    """The model called directly, B = 1, on the job's own draws."""
    T = len(tokens)
    g = torch.Generator().manual_seed(seed)
    src = torch.zeros((1, T * SPT)) if src is None else src[None]
    with torch.inference_mode():
        return s3gen_ref_inference(params, CFG, torch.as_tensor(tokens[None]), torch.tensor([n]),
                                   ref, src, torch.tensor([clen]), draw_noise(CFG, 1, T, g, "cpu"))


def _serve(params, jobs, **kw):
    async def run():
        sched = S3GenScheduler(params, CFG, **{"max_batch": 4, "state_tokens": STATE_TOKENS, **kw})
        try:
            return await asyncio.gather(*[sched.synthesize(*a, **k) for a, k in jobs]), sched
        finally:
            sched.stop()

    return asyncio.run(run())


def test_batched_matches_direct_call(setup):
    """Four co-batched jobs, each with its own seed: each equals the direct
    call on its draws; the tail is the whole waveform (T < MAX_TAIL_TOKENS)
    and the state row is the new source, zero-padded to capacity."""
    _, _, params, _, ref = setup
    T = 6
    tokens = _tokens(T, T)
    (results, sched) = _serve(params, [((tokens, T, ref, None, 0, 11 + i), {}) for i in range(4)])
    assert sched.max_batch_seen == 4
    for i, (tail, start, state) in enumerate(results):
        wav, src = _direct(params, tokens, T, ref, 11 + i)
        assert start == 0 and tail.shape == (T * SPT,)
        assert state.shape == (STATE_TOKENS * SPT,)
        assert 1e-3 < np.abs(tail).max() < CFG.hift.audio_limit
        np.testing.assert_allclose(tail, to_np(wav[0]), atol=BATCH_TOL, rtol=0)
        np.testing.assert_allclose(to_np(state[: T * SPT]), to_np(src[0]), atol=BATCH_TOL, rtol=0)
        np.testing.assert_array_equal(to_np(state[T * SPT:]), 0.0)


def test_state_roundtrip_and_shift(setup):
    """The returned row fed back with a window shift: the new source's first
    cache_len samples are the shifted row's (excitation continuity), and the
    same inputs give the same outputs."""
    _, _, params, _, ref = setup
    T = 6
    tokens = _tokens(T, T)
    (first,), _ = _serve(params, [((tokens, T, ref, None, 0, 3), {})])
    state1 = first[2]
    clen = (T - 1) * SPT
    again = ((tokens, T, ref, state1, clen, 3), dict(shift=SPT, prev_rel=(T - 1) * SPT))
    (a, b), _ = _serve(params, [again, again])
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(to_np(a[2]), to_np(b[2]))
    assert a[1] == 0  # start = min(prev_rel, T*spt - tail_len) = 0 here
    np.testing.assert_array_equal(to_np(a[2][:clen]), to_np(state1[SPT:SPT + clen]))
    assert np.isfinite(a[0]).all()


def test_mixed_buckets(setup):
    _, _, params, _, ref = setup
    jobs = [((_tokens(T, T), T, ref, None, 0, T), {}) for T in (4, 8, 4, 8)]
    results, _ = _serve(params, jobs)
    assert [len(t) for t, _, _ in results] == [4 * SPT, 8 * SPT, 4 * SPT, 8 * SPT]
    for t, _, _ in results:
        assert np.isfinite(t).all()


def test_error_propagates_to_every_job_of_the_batch(setup):
    """A failing batch fails its jobs: no retry at a smaller batch."""
    _, _, params, _, ref = setup
    calls = []

    def broken(*args):
        calls.append(args[1].shape[0])
        raise RuntimeError("synthetic failure")

    async def run():
        sched = S3GenScheduler(params, CFG, max_batch=4, state_tokens=STATE_TOKENS, infer=broken)
        try:
            return await asyncio.gather(*[
                sched.synthesize(_tokens(4, 4), 4, ref, None, 0, i) for i in range(2)
            ], return_exceptions=True)
        finally:
            sched.stop()

    outs = asyncio.run(run())
    assert calls == [2]
    assert all(isinstance(o, RuntimeError) and "synthetic" in str(o) for o in outs)


def test_allowed_batch_token_product_cap(setup):
    """batch × bucket is capped by the token-product budget, at any batch
    size (no power-of-two ladder)."""
    _, _, params, _, _ = setup
    sched = S3GenScheduler(params, CFG, max_batch=16, state_tokens=STATE_TOKENS)
    sched.batch_token_budget = 4096
    assert sched.allowed_batch(256) == 16
    assert sched.allowed_batch(264) == 15
    assert sched.allowed_batch(512) == 8
    assert sched.allowed_batch(1032) == 3
    assert sched.allowed_batch(5000) == 1


def test_keep_state_false_returns_none(setup):
    _, _, params, _, ref = setup
    tokens = _tokens(6, 6)
    (keep, drop), _ = _serve(params, [((tokens, 6, ref, None, 0, 5), dict(keep_state=True)),
                                      ((tokens, 6, ref, None, 0, 5), dict(keep_state=False))])
    assert drop[2] is None and keep[2] is not None
    np.testing.assert_array_equal(keep[0], drop[0])


def test_three_jobs_run_three_lanes(setup):
    """Three queued jobs go out as one call of batch 3: no padding."""
    _, _, params, _, ref = setup
    lanes = []

    def spy(p, tk, *rest):
        lanes.append(tk.shape[0])
        return s3gen_ref_inference(p, CFG, tk, *rest)

    tokens = _tokens(6, 6)
    results, _ = _serve(params, [((tokens, 6, ref, None, 0, 3), {})] * 3, max_batch=8, infer=spy)
    assert lanes == [3]
    for tail, start, _ in results:
        assert start == 0
        np.testing.assert_array_equal(tail, results[0][0])


def test_unported_jobs_raise(setup):
    """Prompt-cached and streaming jobs are accepted; a streaming job the
    block cannot hold, one without the prompt cache, or one with a window
    shift, is refused, as is an out-of-range shift."""
    _, _, params, _, ref = setup

    async def run(**kw):
        sched = S3GenScheduler(params, CFG, state_tokens=STATE_TOKENS)
        try:
            return await sched.synthesize(_tokens(4, 4), 4, ref, None, 0, 0, **kw)
        finally:
            sched.stop()

    cache = _cache(params, ref)
    state = init_s3gen_stream_state(CFG, cache, 16, STATE_TOKENS)
    assert len(asyncio.run(run(cache=cache))) == 3
    assert len(asyncio.run(run(cache=cache, new_len=4, rstate=state))) == 4
    with pytest.raises(ValueError, match="prompt cache"):
        asyncio.run(run(new_len=4, rstate=state))
    with pytest.raises(ValueError, match="new tokens"):
        asyncio.run(run(cache=cache, new_len=5, rstate=state))
    with pytest.raises(ValueError, match="shift"):
        asyncio.run(run(cache=cache, new_len=4, rstate=state, shift=SPT))
    with pytest.raises(ValueError, match="shift"):
        asyncio.run(run(shift=STATE_TOKENS * SPT))


def _cache(params, ref, seed=777):
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn((1, 2048, CFG.flow.output_size), generator=g)
    with torch.inference_mode():
        return s3gen_ref_prompt_prefill(params, CFG, ref, noise)


def test_cached_batch_matches_direct_call(setup):
    """Three co-batched jobs with the voice's prompt cache (captured at
    batch 1, broadcast over the batch): each equals the direct cached call
    on its draws."""
    _, _, params, _, ref = setup
    cache = _cache(params, ref)
    T = 6
    tokens = _tokens(T, 5)
    results, sched = _serve(params, [((tokens, 5, ref, None, 0, 30 + i), dict(cache=cache))
                                     for i in range(3)])
    assert sched.max_batch_seen == 3
    for i, (tail, _, state) in enumerate(results):
        g = torch.Generator().manual_seed(30 + i)
        with torch.inference_mode():
            wav, src = s3gen_ref_inference(
                params, CFG, torch.as_tensor(tokens[None]), torch.tensor([5]), ref,
                torch.zeros((1, T * SPT)), torch.tensor([0]), draw_noise(CFG, 1, T, g, "cpu"),
                cfm_cache=cache)
        np.testing.assert_allclose(tail, to_np(wav[0]), atol=BATCH_TOL, rtol=0)
        np.testing.assert_allclose(to_np(state[: T * SPT]), to_np(src[0]), atol=BATCH_TOL, rtol=0)


def test_streaming_batch_matches_direct_call(setup):
    """Two streaming jobs co-batched at different stages of their chunks
    (a first slice of 4 tokens; a second slice of 3 after 4): the block is
    picked for the larger new_len, each job's tail, source row and new state
    equal the direct batch-1 streaming call on its draws, and the returned
    states are the job's own."""
    _, _, params, _, ref = setup
    cache = _cache(params, ref)
    T = 8
    tokens = _tokens(T, 7, seed=3)
    fresh = init_s3gen_stream_state(CFG, cache, 16, STATE_TOKENS)

    def direct(n_tok, new, src_row, clen, prev, seed, rstate):
        g = torch.Generator().manual_seed(seed)
        with torch.inference_mode():
            return s3gen_ref_inference_streaming(
                params, CFG, torch.as_tensor(tokens[None]), torch.tensor([n_tok]),
                torch.tensor([new]), ref, src_row[None, : T * SPT], torch.tensor([clen]),
                draw_noise(CFG, 1, T, g, "cpu", stream=True), torch.tensor([prev]), T * SPT,
                rstate, stream_block_tokens(4, T), cache)

    # job b's first slice (4 tokens), run alone to make its second-slice state
    _, src_b, st_b = direct(4, 4, torch.zeros(STATE_TOKENS * SPT), 0, 0, 41, fresh)
    row_b = torch.zeros(STATE_TOKENS * SPT)
    row_b[: T * SPT] = src_b[0]
    jobs = [((tokens, 4, ref, None, 0, 40), dict(cache=cache, new_len=4, rstate=fresh)),
            ((tokens, 7, ref, row_b, 4 * SPT, 41),
             dict(cache=cache, new_len=3, rstate=st_b, prev_rel=4 * SPT))]
    results, sched = _serve(params, jobs)
    assert sched.max_batch_seen == 2 and sched.max_stream_batch_seen == 2
    want = [direct(4, 4, torch.zeros(STATE_TOKENS * SPT), 0, 0, 40, fresh),
            direct(7, 3, row_b, 4 * SPT, 4 * SPT, 41, st_b)]
    for (tail, start, row, st), (w_tail, w_src, w_st) in zip(results, want):
        assert start == 0
        np.testing.assert_allclose(tail, to_np(w_tail[0]), atol=BATCH_TOL, rtol=0)
        np.testing.assert_allclose(to_np(row[: T * SPT]), to_np(w_src[0]), atol=BATCH_TOL, rtol=0)
        np.testing.assert_allclose(to_np(st["mel"]), to_np(w_st["mel"]), atol=BATCH_TOL, rtol=0)
        for k, a in w_st["cfm"].items():
            np.testing.assert_allclose(to_np(st["cfm"][k]), to_np(a), atol=BATCH_TOL,
                                       rtol=BATCH_TOL, err_msg=k)
    assert [int(r[3]["cfm"]["frames"][0]) for r in results] == [4 * CFG.flow.up_stride,
                                                                 7 * CFG.flow.up_stride]


def test_jobs_with_different_caches_do_not_coalesce(setup):
    """Queues key on the prompt cache's identity: four jobs of one bucket
    with two voices' caches go out as two batches of two."""
    _, _, params, _, ref = setup
    caches = [_cache(params, ref, seed) for seed in (1, 2)]
    lanes = []

    def spy(p, tk, *rest, cache=None):
        lanes.append((tk.shape[0], id(cache)))
        return s3gen_ref_inference(p, CFG, tk, *rest, cfm_cache=cache)

    tokens = _tokens(6, 6)
    jobs = [((tokens, 6, ref, None, 0, i), dict(cache=caches[i % 2])) for i in range(4)]
    _serve(params, jobs, infer=spy)
    assert sorted(lanes) == sorted([(2, id(caches[0])), (2, id(caches[1]))])


def test_tail_vocode_through_scheduler_matches_full(setup):
    """A full-overlap slice whose bucket exceeds the vocoder window: two
    co-batched jobs at different window positions emit, through the
    tail-windowed path, the audio of the full-vocode path (2e-6), with equal
    state rows."""
    _, _, params, _, ref = setup
    T, acc = 192, 160
    assert T > MAX_TAIL_TOKENS  # windowing engages
    tokens = _tokens(T, acc, seed=7)
    state0 = torch.zeros(((T + 64) * SPT,))

    def tail_infer(p, tk, tl, rf, sr, cl, nz, start, tail_len):
        return s3gen_ref_inference_tail(p, CFG, tk, tl, rf, sr, cl, nz, start, tail_len)

    jobs = [((tokens, acc, ref, state0, prev, 21), dict(prev_rel=prev))
            for prev in (100 * SPT, 60 * SPT)]
    res_w, _ = _serve(params, jobs, max_batch=2, state_tokens=T + 64, tail_infer=tail_infer)
    res_f, _ = _serve(params, jobs, max_batch=2, state_tokens=T + 64)
    for (tail_w, start_w, state_w), (tail_f, start_f, state_f) in zip(res_w, res_f):
        assert start_w == start_f
        valid = acc * SPT - start_w  # samples of real audio inside the tail
        np.testing.assert_allclose(tail_w[:valid], tail_f[:valid], rtol=0, atol=TAIL_TOL)
        np.testing.assert_array_equal(to_np(state_w), to_np(state_f))


def test_inference_tail_matches_jax_and_full_vocode(setup):
    """Three rows at three window positions (first, interior, last): the
    port's tail equals JAX's on JAX's noise (1e-4) and the port's own full
    vocode (2e-6); the source is the full path's."""
    jcfg, jp, params, ref_np, _ = setup
    T, B = 64, 3
    tail_len = 8 * SPT
    starts = np.array([0, 17 * SPT + 5, T * SPT - tail_len], np.int32)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 50, (B, T)).astype(np.int32)
    tokens[:] = tokens[0]
    tlen = np.full((B,), T, np.int32)
    src0 = np.repeat((rng.standard_normal((1, T * SPT)) * 0.05).astype(np.float32), B, 0)
    clen = np.full((B,), 10 * SPT, np.int32)
    ref_b = {k: np.repeat(v, B, 0) for k, v in ref_np.items()}
    key = jax.random.PRNGKey(9)
    want, want_src = jax.jit(jmodel.s3gen_ref_inference_tail, static_argnums=(1, 9))(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(tlen), jax.tree.map(jnp.asarray, ref_b),
        jnp.asarray(src0), jnp.asarray(clen), key, jnp.asarray(starts), tail_len)
    args = (params, CFG, to_t(tokens), to_t(tlen), {k: to_t(v) for k, v in ref_b.items()},
            to_t(src0), to_t(clen), jax_s3gen_noise(jcfg, key, B, T))
    with torch.inference_mode():
        tail, src = s3gen_ref_inference_tail(*args, to_t(starts), tail_len)
        full, full_src = s3gen_ref_inference(*args)
    peak = float(np.abs(np.asarray(want)).max())
    assert 1e-3 < peak < jcfg.hift.audio_limit, f"tail peak {peak}: silent or clipped"
    np.testing.assert_allclose(to_np(tail), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_np(src), np.asarray(want_src), atol=1e-4, rtol=1e-4)
    for b, s in enumerate(starts):
        np.testing.assert_allclose(to_np(tail[b]), to_np(full[b, s:s + tail_len]),
                                   rtol=0, atol=TAIL_TOL, err_msg=f"start={s}")
    np.testing.assert_array_equal(to_np(src), to_np(full_src))


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_receptive_margin_is_the_jax_packages(size):
    if size == "tiny":
        cfg, jcfg = S3GenRefConfig.tiny(), JCfg.tiny()
    else:
        cfg, jcfg = S3GenRefConfig(), JCfg()
    assert hift_receptive_margin(cfg.hift) == jhift.hift_receptive_margin(jcfg.hift)
