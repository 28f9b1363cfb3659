"""Serving under ``CHATTERBOX_TP`` on the CPU: S3Gen-ref's tensor-parallel
rules, the sharded S3Gen-ref calls, and the engine whose followers mirror
every T3 and S3Gen call (``runtime/tp_serving.py``).

Multi-rank model calls run their ranks through ``parallel.launch`` (spawned
processes, gloo, RANK_TIMEOUT_S; the rank function is
tests/torch_tp_serving_workers.py's). The engine at ``CHATTERBOX_TP=2`` is
rank 0 in this process and starts its follower itself, on
``devices=["cpu", "cpu"]``; each of its groups has a timeout
(``tp_serving.GROUP_TIMEOUT_S``).

* the port's split dims against the JAX package's ``s3gen_ref_param_specs``
  leaf by leaf, carried into the port's layout, where every block divides
  (tiny at tp = 2, full width at tp = 2 and 4); at tiny tp = 4 the attention
  blocks (2 heads) stay whole in the port, where JAX falls back leaf by leaf;
* at full width every conformer and estimator projection shards at tp = 2
  and 4;
* ``s3gen_ref_inference`` (uncached and with the prompt cache), the prompt
  prefill and a streamed chunk at tp = 2 against the JAX package's tp = 2
  run on its 8 virtual devices and against the unsharded port; each rank's
  prompt cache and ring hold its own heads;
* the engine at ``CHATTERBOX_TP=2``, ``tiny_ref()`` and ``tiny()``, per
  request and batched, against the JAX engine at ``CHATTERBOX_TP=2`` with
  JAX's noise injected, at tests/test_torch_engine_parity.py's bounds; the
  follower's token digest equals rank 0's;
* ``clear_voice_cache``, a cancelled request and ``shutdown`` free the
  follower's state; a killed follower fails the next request with an error;
* the batched decoder at tp = 2 grows and shrinks its cache in step with
  rank 0 (tests/test_torch_scheduler.py's reach scenario) and takes the
  unsharded decoder's tokens.
"""
import asyncio
import contextlib
import dataclasses
import gc
import time

import numpy as np
import pytest
import torch

import torch_tp_serving_workers as workers
from test_torch_scheduler import (LONG, REACH_RESIZES, REACH_SLICE, long_model, reach_scenario,
                                  watch_resizes)
from test_torch_engine_parity import (CASES, FRAME_TOL, ISTFT_FRAME, LSD_DB, MCD_DB, PCM_STEP,
                                      QUEUE_ROOM, REQUEST, TEXTS, WAVE_TOL, YARDSTICK_SHARE,
                                      _ids, _inject_jax_noise, _pcm, _serve)
from torch_port_helpers import (conditioned_dit_params, conditioned_s3gen_params, jax_s3gen_noise,
                                jax_tree_to_np, prompt_noise, to_np, write_conds)

import jax
import jax.numpy as jnp

from chatterbox_tpu.config import reset_config_cache
from chatterbox_tpu.models.s3gen_ref import model as jmodel
from chatterbox_tpu.models.s3gen_ref.config import S3GenRefConfig as JCfg
from chatterbox_tpu.ops.initializers import shape_only_init
from chatterbox_tpu.parallel import make_mesh as jmake_mesh
from chatterbox_tpu.parallel.mesh import AXES as JAXES
from chatterbox_tpu.parallel.sharding import _match_tree as jmatch_tree
from chatterbox_tpu.parallel.sharding import _spec_is_shardable
from chatterbox_tpu.parallel.sharding import s3gen_ref_param_specs as jspecs
from chatterbox_tpu.parallel.sharding import shard_s3gen_ref_params as jshard_s3gen
from chatterbox_tpu.runtime import CancellationToken as JToken
from chatterbox_tpu.runtime import EngineConfig as JEngineConfig
from chatterbox_tpu.runtime import TTSEngine as JTTSEngine
from chatterbox_tpu_torch import parallel
from chatterbox_tpu_torch.audio.quality import log_spectral_distance, mel_cepstral_distortion
from chatterbox_tpu_torch.convert import _perm, convert_params
from chatterbox_tpu_torch.models.s3gen_ref import model as tmodel
from chatterbox_tpu_torch.models.s3gen_ref.config import S3GenRefConfig
from chatterbox_tpu_torch.models.s3gen_ref.decoder import GN_GROUPS
from chatterbox_tpu_torch.ops.initializers import ShapeInit
from chatterbox_tpu_torch.parallel.mesh import Rank
from chatterbox_tpu_torch.runtime.cancellation import CancellationToken
from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine
from chatterbox_tpu_torch.runtime.scheduler import BatchedT3Decoder
from chatterbox_tpu_torch.runtime.tp_serving import (FollowerSpec, ShardedCalls, TPError, TPGroup,
                                                     params_to_numpy, shard_engine_params)

CFG = S3GenRefConfig.tiny()
JCFG = JCfg.tiny()
RANK_TIMEOUT_S = 120.0
# intra-op threads of each rank of a tensor-parallel engine (its follower
# takes rank 0's): two ranks that each spread a parallel op over every core
# of a loaded host leave each other waiting on descheduled threads
ENGINE_THREADS = 2
# S3Gen-ref at tp = 2 against tp = 1 and against JAX: float32 summation
# order only, through the conditioned vocoder (tests/test_torch_cfm_streaming.py's)
TOL = 1e-4


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _jax_dims(jparams, cfg, tp: int, port_params) -> dict:
    """JAX's per-leaf split (its rules, with its fall-back to replication
    where a dim does not divide) → the port's split dim of each leaf."""
    mesh = jmake_mesh(dp=1, tp=tp, devices=jax.devices()[:tp])
    specs = _flat(jmatch_tree(jparams, jspecs(cfg)))
    shapes = {k: v.shape for k, v in _flat(jparams).items()}
    ndims = {k: v.dim() for k, v in _flat(port_params).items()}
    out = {}
    for path, spec in specs.items():
        tp_dims = [i for i, names in enumerate(spec) if names == JAXES.tp]
        if not tp_dims or not _spec_is_shardable(spec, shapes[path], mesh):
            out[path] = None
            continue
        parts = path.split("/")
        parents = tuple(p for p in parts[:-1] if not p.isdigit())
        perm = _perm(parts[-1], parents, ndims[path])
        out[path] = perm.index(tp_dims[0]) if perm is not None else tp_dims[0]
    return out


def _port_full_width():
    return convert_params(tmodel.s3gen_ref_param_tree(S3GenRefConfig(), ShapeInit()), "meta")


@pytest.fixture(scope="module")
def jparams():
    jp = jmodel.init_s3gen_ref_params(jax.random.PRNGKey(0), JCFG)
    return conditioned_s3gen_params(jax_tree_to_np(jp), JCFG)


def _port_np(jparams):
    """The port's layout as numpy (what crosses to a rank)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t.numpy()
    return walk(convert_params(jparams, "cpu"))


# ------------------------------------------------------------------- specs
@pytest.mark.parametrize("tp", [2])
def test_tiny_split_dims_match_jax_leaf_by_leaf(jparams, tp):
    port = convert_params(jparams, "cpu")
    got = parallel.s3gen_ref_split_dims(port, CFG, tp)
    want = _jax_dims(jparams, JCFG, tp, port)
    assert got.keys() == want.keys()
    assert got == want
    assert sum(d is not None for d in got.values()) == 62


@pytest.mark.parametrize("tp", [2, 4])
def test_full_width_split_dims_match_jax_leaf_by_leaf(tp):
    with shape_only_init():
        jp = jmodel.init_s3gen_ref_params(jax.random.PRNGKey(0), JCfg())
    port = _port_full_width()
    got = parallel.s3gen_ref_split_dims(port, S3GenRefConfig(), tp)
    assert got == _jax_dims(jp, JCfg(), tp, port)


def test_tiny_tp4_keeps_undividing_blocks_whole(jparams):
    """2 heads do not split over 4 ranks: the port keeps each attention
    block whole (JAX splits the leaves that divide); the feed-forwards and
    resnets (16 channels, 8 groups) still shard."""
    port = convert_params(jparams, "cpu")
    got = parallel.s3gen_ref_split_dims(port, CFG, 4)
    want = _jax_dims(jparams, JCFG, 4, port)
    attn = [p for p in got if "/attn/" in p or "/to_" in p]
    assert attn and all(got[p] is None for p in attn)
    assert any(want[p] is not None for p in attn)
    rest = [p for p in got if p not in attn]
    assert {p: got[p] for p in rest} == {p: want[p] for p in rest}
    assert parallel.s3gen_ref_block_shards(CFG, 4) == {
        "conformer attention": False, "conformer feed-forward": True,
        "estimator attention": False, "estimator feed-forward": True, "resnet": True}


@pytest.mark.parametrize("tp", [2, 4])
def test_every_projection_shards_at_full_width(tp):
    """No silent fall-back (tests/test_parallel_s3gen.py's check, per
    block): at full width every leaf the rules split is split, and those are
    every conformer block's q/k/v/pos/out, bias_u/bias_v and w1/w2, every
    estimator transformer block's to_q/k/v/to_out and ff1/ff2, and every
    resnet's time-MLP, block1 and block2."""
    cfg = S3GenRefConfig()
    params = _port_full_width()
    rules = parallel.sharding._match_tree(params, parallel.s3gen_ref_param_specs(cfg))
    dims = parallel.s3gen_ref_split_dims(params, cfg, tp)
    assert dims == rules
    fl = cfg.flow
    levels = 2 + fl.dec_num_mid_blocks
    conformer, tf, resnet = 13, 7, 5   # split leaves per block
    assert sum(d is not None for d in dims.values()) == (
        (fl.num_blocks + fl.num_up_blocks) * conformer + levels * fl.dec_n_blocks * tf
        + levels * resnet)
    assert all(parallel.s3gen_ref_block_shards(cfg, tp).values())
    assert GN_GROUPS == parallel.sharding.GN_GROUPS


def test_shards_concatenate_to_the_full_tree(jparams):
    """Rank t's shard of a split leaf is slice t along its split dim; a
    replicated leaf is the full one, not a copy."""
    port = convert_params(jparams, "cpu")
    a, b = (parallel.shard_s3gen_ref_params(port, CFG, 2, t) for t in (0, 1))
    dims = parallel.s3gen_ref_split_dims(port, CFG, 2)
    fa, fb, fp = _flat(a), _flat(b), _flat(port)
    for path, dim in dims.items():
        if dim is None:
            assert fa[path] is fp[path] and fb[path] is fp[path]
        else:
            assert torch.equal(torch.cat([fa[path], fb[path]], dim), fp[path]), path


# ------------------------------------------------------ the sharded calls
T, SLICES, TAIL_TOKENS, WINDOW = 12, (4, 4, 4), 6, 32


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    ref = {"spk_emb": rng.standard_normal((1, 192)).astype(np.float32),
           "prompt_tokens": rng.integers(0, 6561, (1, JCFG.max_prompt_tokens)).astype(np.int32),
           "prompt_len": np.array([6], np.int32),
           "prompt_mel": rng.standard_normal((1, JCFG.max_prompt_mel, 80)).astype(np.float32),
           "prompt_mel_len": np.array([12], np.int32)}
    tokens = rng.integers(0, 50, (1, T)).astype(np.int32)
    return ref, tokens


def _jax_calls(jp, ref, tokens, mesh=None):
    """JAX's uncached and cached inference, prompt prefill and streamed
    chunk (sharded over ``mesh``: its tp rules, jit-placed)."""
    spt = JCFG.samples_per_token
    if mesh is not None:
        jp = jshard_s3gen(jax.tree.map(jnp.asarray, jp), JCFG, mesh)
    jref = jax.tree.map(jnp.asarray, ref)
    key = jax.random.PRNGKey(9)
    toks, tlen = jnp.asarray(tokens), jnp.array([T])
    src0, clen0 = jnp.zeros((1, T * spt)), jnp.array([0])
    out = {}
    infer = jax.jit(lambda p, r, c: jmodel.s3gen_ref_inference(p, JCFG, toks, tlen, r, src0,
                                                               clen0, key, cfm_cache=c))
    out["wav"], out["src"] = infer(jp, jref, None)
    jc = jax.jit(lambda p, r: jmodel.s3gen_ref_prompt_prefill(p, JCFG, r,
                                                              jax.random.PRNGKey(777)))(jp, jref)
    out["cached_wav"], _ = infer(jp, jref, jc)
    state = jmodel.init_s3gen_stream_state(JCFG, jc, window=WINDOW, cap_tokens=T)
    stream = jax.jit(lambda p, r, c, tl, n, src, cl, st, start: jmodel.s3gen_ref_inference_streaming(
        p, JCFG, toks, tl, n, r, src, cl, key, start, TAIL_TOKENS * spt, st, max(SLICES),
        cfm_cache=c))
    src, total, tails = src0, 0, []
    for n in SLICES:
        total += n
        start = min((total - n) * spt, T * spt - TAIL_TOKENS * spt)
        tail, src, state = stream(jp, jref, jc, jnp.array([total]), jnp.array([n]), src,
                                  jnp.array([(total - n) * spt]), state, jnp.array([start]))
        tails.append(np.asarray(tail))
    out["stream_tails"] = np.stack(tails)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def sharded_run(jparams, inputs):
    ref, tokens = inputs
    noise = {k: to_np(v) for k, v in jax_s3gen_noise(JCFG, jax.random.PRNGKey(9), 1, T).items()}
    args = (CFG, _port_np(jparams), ref, tokens, noise, to_np(prompt_noise(80)), noise, SLICES,
            TAIL_TOKENS * CFG.samples_per_token, WINDOW)
    one = workers.s3gen_calls(Rank(0, 1, torch.device("cpu"), ("cpu",), "gloo"), *args)
    assert all(one["unsharded_equal"].values())
    two = parallel.launch(workers.s3gen_calls, ["cpu"] * 2, args=args, timeout_s=RANK_TIMEOUT_S)
    mesh = jmake_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    return one, two, _jax_calls(jparams, ref, tokens, mesh)


@pytest.mark.parametrize("key", ["wav", "src", "cached_wav", "stream_tails", "stream_mel"])
def test_sharded_s3gen_matches_unsharded(sharded_run, key):
    one, two, _ = sharded_run
    assert np.abs(one[key]).max() > 1e-3
    for r in two:
        np.testing.assert_allclose(r[key], one[key], rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("key", ["wav", "src", "cached_wav", "stream_tails"])
def test_sharded_s3gen_matches_jax_tp2(sharded_run, key):
    _, two, jax_tp2 = sharded_run
    for r in two:
        np.testing.assert_allclose(r[key], jax_tp2[key], rtol=TOL, atol=TOL, err_msg=key)


def test_each_rank_holds_its_heads(sharded_run):
    """Rank t's prompt cache and ring hold heads [t·H/2, (t+1)·H/2) of the
    unsharded ones; its shard's projections are half as wide."""
    one, two, _ = sharded_run
    H = CFG.flow.dec_num_heads
    for t, r in enumerate(two):
        for key, axis in (("cache_k", -3), ("ring_k", -3)):
            want = np.take(one[key], np.arange(t * H // 2, (t + 1) * H // 2), axis=axis)
            np.testing.assert_allclose(r[key], want, rtol=TOL, atol=TOL, err_msg=key)
        assert r["shapes"]["to_q"][0] * 2 == one["shapes"]["to_q"][0]
        assert r["shapes"]["block2"][1] * 2 == one["shapes"]["block2"][1]
        assert r["shapes"]["q"][0] * 2 == one["shapes"]["q"][0]


# ------------------------------------------------------------ the engine
def _env(mp, tmp, slots):
    (tmp / "models").mkdir(exist_ok=True)
    write_conds(tmp / "models" / "conds.pt", spk_dim=32)
    for k, v in {"MODEL_PATH": str(tmp / "models"), "VOICES_DIR": str(tmp / "voices"),
                 "PRELOADED_VOICES_DIR": str(tmp / "preloaded"), "MAX_DECODE_SLOTS": str(slots),
                 "CHATTERBOX_PRECOMPILE": "0", "TTS_SPEECH_TOKEN_QUEUE_MAX_SIZE": str(QUEUE_ROOM),
                 "TTS_PCM_CHUNK_QUEUE_MAX_SIZE": str(QUEUE_ROOM), "CHATTERBOX_TP": "2"}.items():
        mp.setenv(k, v)
    for k in ("CHATTERBOX_S3GEN_ARCH", "CHATTERBOX_TINY_MODEL", "CHATTERBOX_CFM_PROMPT_CACHE",
              "CHATTERBOX_CFM_STREAM"):
        mp.delenv(k, raising=False)
    reset_config_cache()


@contextlib.contextmanager
def _engine_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(ENGINE_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _digests(engine):
    gc.collect()
    return engine.calls.stats(), engine.tp.follower_stats()


@pytest.fixture(scope="module", params=list(CASES))
def tp_served(request, tmp_path_factory):
    """test_torch_engine_parity.py's cases with both engines at
    CHATTERBOX_TP=2 → (arch, the JAX WAVs, the JAX WAVs under other keys,
    the port's WAVs, its request stats, its injected draws, the sample
    rate, rank 0's and the follower's token digests)."""
    arch, slots = CASES[request.param]
    n = 1 if slots == 1 else len(TEXTS)
    tmp = tmp_path_factory.mktemp("tp_parity")
    mp = pytest.MonkeyPatch()
    _env(mp, tmp, slots)
    cfg, jcfg = ((c.tiny_ref() if arch == "ref" else c.tiny()) for c in (EngineConfig,
                                                                           JEngineConfig))
    if slots > 1:
        cfg, jcfg = (dataclasses.replace(c, max_new_tokens=24) for c in (cfg, jcfg))
    try:
        jeng = JTTSEngine(jcfg, seed=3)
        init_models = jeng._init_models

        def init_and_condition():
            init_models()   # shards T3 and, for the ref arch, S3Gen-ref
            s3 = jax_tree_to_np(jeng.params["s3gen"])
            if arch == "ref":
                s3 = jshard_s3gen(jax.tree.map(jnp.asarray, conditioned_s3gen_params(
                    s3, jcfg.s3gen_ref)), jcfg.s3gen_ref, jeng.mesh)
            else:
                s3 = jax.tree.map(jnp.asarray, conditioned_dit_params(s3))
            jeng.params["s3gen"] = s3

        jeng._init_models = init_and_condition
        asyncio.run(jeng.ainit())
        jwavs = asyncio.run(_serve(jeng, JToken, _ids("parity", n)))
        yard = asyncio.run(_serve(jeng, JToken, _ids("yardstick", n)))
        params = {k: convert_params(jax_tree_to_np(v), "cpu") for k, v in jeng.params.items()}
        jeng.shutdown()
        with _engine_threads():
            teng = TTSEngine(cfg, seed=3, device="cpu", params=params, devices=["cpu", "cpu"])
            calls = _inject_jax_noise(teng, jcfg, _ids("parity", n))
            asyncio.run(teng.ainit())
            twavs = asyncio.run(_serve(teng, CancellationToken, _ids("parity", n)))
            stats = [teng.request_stats[r] for r in _ids("parity", n)]
            digests = _digests(teng)
            teng.shutdown()
    finally:
        mp.undo()
        reset_config_cache()
    return arch, jwavs, yard, twavs, stats, calls, cfg.gen.sample_rate, digests


def test_tp_engine_served_the_case_with_jax_noise(tp_served):
    arch, jwavs, yard, twavs, stats, calls, sr, _ = tp_served
    for j, y, t in zip(jwavs, yard, twavs):
        assert len(t) == len(j) == len(y) > 44
    assert calls["draws"] >= sum(len(st["slice_tokens"]) for st in stats) > 0
    assert calls["prompt"] == (1 if arch == "ref" else 0)
    batched = len(stats) > 1
    assert all((st["streamed"] > 0) == (arch == "ref" and batched) for st in stats)


def test_tp_engine_wav_parity_against_two_key_yardstick(tp_served):
    arch, jwavs, yard, twavs, stats, calls, sr, _ = tp_served
    for j, y, t in zip(jwavs, yard, twavs):
        j, y, t = _pcm(j), _pcm(y), _pcm(t)
        mcd, lsd = mel_cepstral_distortion(j, t, sr), log_spectral_distance(j, t, sr)
        yard_mcd, yard_lsd = mel_cepstral_distortion(j, y, sr), log_spectral_distance(j, y, sr)
        assert mcd <= min(MCD_DB, YARDSTICK_SHARE * yard_mcd), (mcd, yard_mcd)
        assert lsd <= min(LSD_DB, YARDSTICK_SHARE * yard_lsd), (lsd, yard_lsd)


def test_tp_engine_samples_agree(tp_served):
    arch, jwavs, yard, twavs, stats, calls, sr, _ = tp_served
    for j, t in zip(jwavs, twavs):
        j, t = _pcm(j), _pcm(t)
        assert np.abs(j).max() > 10 * PCM_STEP
        np.testing.assert_allclose(t[:ISTFT_FRAME], j[:ISTFT_FRAME], rtol=0, atol=FRAME_TOL)
        np.testing.assert_allclose(t, j, rtol=0, atol=WAVE_TOL[arch])


def test_tp_follower_takes_rank0_tokens(tp_served):
    """Every T3 call's tokens, folded in call order, are the same on the
    follower as on rank 0."""
    *_, (lead, followers) = tp_served
    assert lead["token_calls"] > 0
    for f in followers:
        assert (f["token_digest"], f["token_calls"]) == (lead["token_digest"], lead["token_calls"])


@pytest.fixture
def tp_engine(tmp_path, request):
    """A started ``tiny_ref()`` engine at CHATTERBOX_TP=2 (MAX_DECODE_SLOTS
    from the test's parameter), shut down after the test."""
    mp = pytest.MonkeyPatch()
    _env(mp, tmp_path, request.param)
    with _engine_threads():
        eng = TTSEngine(dataclasses.replace(EngineConfig.tiny_ref(), max_new_tokens=24), seed=3,
                        device="cpu", devices=["cpu", "cpu"])
        try:
            asyncio.run(eng.ainit())
            yield eng
        finally:
            eng.shutdown()
            mp.undo()
            reset_config_cache()


async def _stream(eng, text, rid, token=None, stop_after=None):
    token = token or CancellationToken()
    out, n = b"", 0
    async for chunk in eng.stream(text=text, request_id=rid, cancellation_token=token, **REQUEST):
        out += chunk
        n += 1
        if stop_after is not None and n >= stop_after:
            token.cancel()
    return out


@pytest.mark.parametrize("tp_engine", [1, 4], indirect=True, ids=["per_request", "batched"])
def test_voice_clear_cancel_and_shutdown_free_follower_state(tp_engine):
    """The follower keeps the default voice's prompt cache (and, batched,
    its streaming template) between requests and nothing of a finished or
    cancelled request; ``clear_voice_cache`` drops the voice's; ``shutdown``
    stops the follower."""
    eng = tp_engine
    voice = 2 if eng.decoder is not None else 1
    wav = asyncio.run(_stream(eng, TEXTS[0], "a"))
    assert len(wav) > 44
    lead, (f,) = _digests(eng)
    assert f["handles"] == voice and f["token_digest"] == lead["token_digest"]
    eng.clear_voice_cache("default")
    assert _digests(eng)[1][0]["handles"] == 0
    asyncio.run(_stream(eng, TEXTS[0], "b", stop_after=2))
    assert _digests(eng)[1][0]["handles"] == voice
    procs = eng.tp.procs
    eng.shutdown()
    assert eng.tp is None and not any(p.is_alive() for p in procs)


@pytest.mark.parametrize("tp_engine", [4], indirect=True, ids=["batched"])
def test_killed_follower_fails_the_request(tp_engine):
    """A follower that dies fails the next request with an error, fast, and
    every request after it: no rank-0-only fallback, no hang."""
    eng = tp_engine
    eng.tp.procs[0].kill()
    eng.tp.procs[0].join()
    for rid in ("x", "y"):
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="follower rank"):
            asyncio.run(_stream(eng, TEXTS[1], rid))
        assert time.monotonic() - t0 < 30
    with pytest.raises(TPError):
        eng.calls.t3_state([0], 0.0, 0.95, 0.5, 1.2)


def test_tp_decoder_resizes_its_cache_with_rank0():
    """The reach scenario (a long chunk grows the cache to max_seq_len, a
    short one after a medium one shrinks it to 256) through a batched
    decoder at tp = 2, int8, sampled: the follower, replaying rank 0's
    inserts and slices, holds the same capacity after every call and takes
    the same tokens, and those are the unsharded decoder's."""
    cfg = dataclasses.replace(EngineConfig.tiny(), t3=LONG.with_(kv_cache_dtype="int8"))
    params, lanes = long_model(cfg.t3)

    async def run(dec):
        seen = watch_resizes(dec)
        try:
            return await reach_scenario(dec, lanes, 0.8), seen
        finally:
            dec.stop()

    want, _ = asyncio.run(run(BatchedT3Decoder(params, cfg.t3, n_slots=2,
                                               slice_size=REACH_SLICE)))
    with _engine_threads():
        group = TPGroup(cfg, ["cpu", "cpu"], FollowerSpec(
            cfg, 0, "", "float32", params=params_to_numpy({"t3": params})))
        try:
            calls = ShardedCalls(cfg, shard_engine_params({"t3": params}, cfg, 2, 0, False),
                                 torch.device("cpu"), t3=group.t3)
            got, seen = asyncio.run(run(calls.make_decoder(2, REACH_SLICE)))
            lead, (follower,) = calls.stats(), group.follower_stats()
        finally:
            group.close()
    assert seen == REACH_RESIZES
    assert lead["cache_rows"] == 256 and lead["token_calls"] > 0
    for key in ("cache_rows", "rows_digest", "token_digest", "token_calls"):
        assert follower[key] == lead[key], key
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
