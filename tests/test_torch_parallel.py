"""The port's ``parallel/`` on the CPU: the (dp, tp) mesh over gloo, T3's
tensor-parallel rules, the sharded T3 functions and the sharded train step.

Multi-rank cases run their ranks through ``parallel.launch`` (spawned
processes, a file store, gloo), each group under its own timeout
(RANK_TIMEOUT_S); the rank functions are tests/torch_parallel_workers.py's.
The T3 config is tests/test_parallel_training.py's (8 heads, 128 wide).

* mesh shapes and the ValueError, as test_parallel_training.py checks them;
  the backend choice (NCCL only where every rank has a card of its own);
* the port's split dims against the JAX package's PartitionSpecs, leaf by
  leaf, carried through ``convert``'s layout permutation; a tp that does
  not divide the heads raises, naming the leaf;
* the sharded ``t3_forward_train`` logits at dp = 2, tp = 2 against the
  JAX package's forward, unsharded and sharded over its 8 virtual devices
  (dp = 2, tp = 4), at that test's tolerance;
* one dp = 2 × tp = 2 train step against the single-rank step: loss,
  gradient norm, every gradient leaf, every parameter after the step. The
  batch's rows hold unequal target counts, so a per-replica mean of losses
  differs from the whole batch's; a ``reduce_from_tp`` that all-reduced in
  its backward would double every gradient upstream of a row-parallel
  product;
* a tensor-parallel prefill and decode slice with an int8 cache at tp = 2
  and 4, and in bf16 at tp = 2: each rank's cache holds Hk/tp heads, and
  every rank takes the unsharded port's tokens;
* ``train_t3 --tiny --cpu --dp 2 --tp 2``: its checkpoint matches the
  single-process run's to stated multiples of lr and serves in both
  engines; a tp that does not divide the heads and a batch that does not
  divide over dp refuse before any rank starts, and so does an engine at a
  ``CHATTERBOX_TP`` that does not divide the heads.
"""
import asyncio
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from torch_port_helpers import jax_tree_to_np, to_np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from chatterbox_tpu.models.t3 import T3Config as JT3Config
from chatterbox_tpu.models.t3 import init_t3_params as jinit_t3
from chatterbox_tpu.models.t3.model import cond_embeddings as jcond
from chatterbox_tpu.models.t3.model import t3_forward_train as jforward
from chatterbox_tpu.parallel import make_mesh as jmake_mesh
from chatterbox_tpu.parallel import shard_params as jshard_params
from chatterbox_tpu.parallel.mesh import AXES as JAXES
from chatterbox_tpu.parallel.sharding import _match_tree, t3_param_specs as jspecs
from chatterbox_tpu_torch import parallel
from chatterbox_tpu_torch.convert import _perm, convert_params
from chatterbox_tpu_torch.models.t3 import model as tm
from chatterbox_tpu_torch.models.t3.config import T3Config
from chatterbox_tpu_torch.training import adamw, make_train_step

WIDTHS = dict(hidden_size=128, num_heads=8, num_kv_heads=8, head_dim=16,
              intermediate_size=256, max_text_tokens=16, max_speech_tokens=32)
JCFG = JT3Config.tiny().with_(**WIDTHS)
CFG = T3Config.tiny().with_(**WIDTHS)
B, T, S = 4, 8, 16
RANK_TIMEOUT_S = 120.0
# test_parallel_training.py's tolerance for a sharded forward
FWD_ATOL, FWD_RTOL = 2e-4, 1e-3
# float32 step, sharded against unsharded: summation order only (the
# row-parallel products sum two partial products). As tests/test_torch_train.py
# holds the port to JAX: the loss to LOSS_RTOL, each gradient leaf within
# GRAD_REL of its largest magnitude plus GRAD_FLOOR of the tree's largest;
# Adam's first step is ±lr wherever |g| ≫ eps, so a parameter is held within
# PARAM_LR_MULT · lr, or NOISE_STEP_LR_MULT · lr where its gradient is
# rounding noise (below GRAD_FLOOR of the tree's largest).
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-6
LR = 1e-3
PARAM_LR_MULT = 0.1
NOISE_STEP_LR_MULT = 2.01


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def jparams():
    return jinit_t3(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params_np(jparams):
    """The JAX init in the port's layout, numpy leaves."""
    return workers._numpy(convert_params(jax_tree_to_np(jparams), "cpu"))


def _batch(seed: int) -> dict:
    """Ragged text and speech; rows 0-1 hold far more targets than rows 2-3,
    so dp replica 0's target count is not replica 1's."""
    rng = np.random.default_rng(seed)
    t_len = rng.integers(3, T + 1, B).astype(np.int32)
    text = rng.integers(1, CFG.text_vocab_size, (B, T)).astype(np.int32)
    text[np.arange(T)[None, :] >= t_len[:, None]] = 0
    s_len = np.array([S, S - 2, 5, 3])
    speech = rng.integers(0, CFG.num_speech_codes, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < s_len[:, None]).astype(np.float32)
    speech[mask == 0] = 0
    return {
        "speaker_emb": rng.standard_normal((B, CFG.speaker_embed_dim)).astype(np.float32),
        "prompt_tokens": rng.integers(0, CFG.num_speech_codes,
                                      (B, CFG.speech_cond_prompt_len)).astype(np.int32),
        "emotion": np.full((B,), 0.5, np.float32),
        "text_tokens": text, "text_len": t_len, "speech_tokens": speech, "speech_mask": mask,
    }


# ------------------------------------------------------------------- mesh
def test_mesh_shapes():
    out = parallel.launch(workers.mesh_shapes, ["cpu"] * 4, timeout_s=RANK_TIMEOUT_S)
    for r, got in enumerate(out):
        assert got["dp2_tp2"] == (2, 2)
        assert got["default"] == (1, 4)   # all tensor parallel
        assert got["dp4"] == (4, 1)
        assert "dp(3) * tp(3) != device count (4)" in got["dp3_tp3"]
        assert got["coords"] == (r // 2, r % 2)   # the ranks of a tp group are consecutive
    assert parallel.mesh_shape(8, dp=2, tp=4) == (2, 4)
    with pytest.raises(ValueError):
        parallel.mesh_shape(8, dp=3, tp=3)


def test_backend_choice():
    assert parallel.backend_for(["cpu"] * 4) == "gloo"
    assert parallel.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert parallel.backend_for(["cuda:0", "cuda:0"]) == "gloo"   # NCCL refuses two on one card
    assert parallel.backend_for(["cuda:0", "cpu"]) == "gloo"


def test_launch_fails_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank one fails"):
        parallel.launch(workers.fail_on_rank_1, ["cpu"] * 2, timeout_s=RANK_TIMEOUT_S)


# ------------------------------------------------------------------- specs
def test_specs_match_jax_leaf_by_leaf(jparams, params_np):
    """Each port split dim is the JAX spec's tp dim carried through the
    leaf's layout permutation; every other leaf (the perceiver included) is
    replicated on both sides."""
    want = _flat(_match_tree(jax_tree_to_np(jparams), jspecs()))
    got = parallel.param_split_dims(params_np)
    assert got.keys() == want.keys()
    assert "cond/perceiver/attn/wq/w" in got
    split = set()
    for path, spec in want.items():
        tp_dims = [i for i, names in enumerate(spec) if names == JAXES.tp]
        if not tp_dims:
            assert got[path] is None, path
            continue
        key = path.split("/")[-1]
        perm = _perm(key, tuple(path.split("/")[:-1]), params_np_ndim(params_np, path))
        port_dim = perm.index(tp_dims[0]) if perm is not None else tp_dims[0]
        assert got[path] == port_dim, path
        split.add(key)
    assert split == {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}


def params_np_ndim(params_np, path):
    return _flat(params_np)[path].ndim


def test_shards_are_the_jax_shards(jparams, params_np):
    """The leaves JAX's shard_params places on tp index t are the port's
    shard t, carried into the port's layout."""
    mesh = jmake_mesh(dp=2, tp=4)
    sharded = _flat(jshard_params(jparams, mesh))
    port = _flat(params_np)
    dims = parallel.param_split_dims(params_np)
    for path in ("backbone/layers/wq", "backbone/layers/wo", "backbone/layers/w_down"):
        perm = _perm(path.split("/")[-1], (), 3)
        jdim = perm[dims[path]]   # the JAX layout's dim of the port's split dim
        n = port[path].shape[dims[path]] // 4
        for t in range(4):
            jshard = next(np.asarray(s.data) for s in sharded[path].addressable_shards
                          if (s.index[jdim].start or 0) == t * n)
            want = np.take(port[path], np.arange(t * n, (t + 1) * n), axis=dims[path])
            np.testing.assert_array_equal(np.transpose(jshard, perm), want)


def test_tp_must_divide_heads():
    with pytest.raises(ValueError, match="backbone/layers/wq: 8 query heads do not split over tp=3"):
        parallel.check_tp(CFG, 3)
    with pytest.raises(ValueError, match="backbone/layers/wk: 2 kv heads"):
        parallel.check_tp(CFG.with_(num_kv_heads=2), 4)
    for tp in (2, 4):   # tiny() and full() divide by 2 and by 4
        parallel.check_tp(T3Config.tiny(), tp)
        parallel.check_tp(T3Config(), tp)


# ----------------------------------------------------------- forward, step
@pytest.fixture(scope="module")
def sharded_run(params_np):
    batch = _batch(3)
    out = parallel.launch(workers.forward_and_step, ["cpu"] * 4,
                          args=(CFG, params_np, batch, 2, 2, LR), timeout_s=RANK_TIMEOUT_S)
    return batch, out


def test_sharded_forward_matches_jax(jparams, sharded_run):
    batch, out = sharded_run
    jb = {k: jnp.asarray(batch[k]) for k in ("speaker_emb", "prompt_tokens", "emotion",
                                            "text_tokens", "speech_tokens")}

    def forward(p, b):
        cond = jcond(p, JCFG, b["speaker_emb"], b["prompt_tokens"], b["emotion"])
        return jforward(p, JCFG, cond, b["text_tokens"], b["speech_tokens"])

    ref = np.asarray(jax.jit(forward)(jparams, jb))
    mesh = jmake_mesh(dp=2, tp=4)
    b_shard = {k: jax.device_put(v, NamedSharding(mesh, P(JAXES.dp))) for k, v in jb.items()}
    with mesh:
        jsharded = np.asarray(jax.jit(forward)(jshard_params(jparams, mesh), b_shard))
    for r in out:   # rank (d, t) holds rows [2d, 2d + 2)
        rows = slice(2 * r["dp_index"], 2 * r["dp_index"] + 2)
        np.testing.assert_allclose(r["logits"], ref[rows], atol=FWD_ATOL, rtol=FWD_RTOL)
        np.testing.assert_allclose(r["logits"], jsharded[rows], atol=FWD_ATOL, rtol=FWD_RTOL)
    # the two tp ranks of a dp replica hold the same logits, bit for bit
    np.testing.assert_array_equal(out[0]["logits"], out[1]["logits"])
    np.testing.assert_array_equal(out[2]["logits"], out[3]["logits"])


def test_sharded_train_step_matches_single_rank(params_np, sharded_run):
    batch, out = sharded_run
    init, step = make_train_step(CFG, adamw(LR))
    state = init(workers._tensors(params_np))
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    want_g = {k: to_np(p.grad) for k, p in _flat(state["params"]).items()}
    want_p = {k: to_np(p) for k, p in _flat(state["params"]).items()}
    top = max(np.abs(g).max() for g in want_g.values())
    # a mean of the replicas' own losses is not the batch's loss
    mask = batch["speech_mask"]
    assert mask[:2].sum() != mask[2:].sum()
    for r in out:
        np.testing.assert_allclose(r["loss"], float(m["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], float(m["grad_norm"]), rtol=LOSS_RTOL)
        got_g, got_p = _flat(r["grads"]), _flat(r["params"])
        assert got_g.keys() == want_g.keys()
        for k, g in want_g.items():
            np.testing.assert_allclose(got_g[k], g, rtol=0,
                                       atol=GRAD_REL * np.abs(g).max() + GRAD_FLOOR * top,
                                       err_msg=k)
            noise = np.abs(g) < GRAD_FLOOR * top
            tol = LR * np.where(noise, NOISE_STEP_LR_MULT, PARAM_LR_MULT)
            assert (np.abs(got_p[k] - want_p[k]) <= tol).all(), k
    # per layer: two all-reduces forward, two backward (copy_to_tp), and
    # the recomputation's one: it stops at the last activation the backward
    # needs (torch's non-reentrant early stop), before the MLP's all-reduce
    assert [r["collectives"]["all_reduce"] for r in out] == [5 * CFG.num_layers] * 4


# ------------------------------------------------------------------ decode
def _decode_inputs(seed: int, R: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    L = 2 * R   # CFG lanes
    t_len = rng.integers(3, T + 1, L).astype(np.int32)
    text = rng.integers(1, CFG.text_vocab_size, (L, T)).astype(np.int32)
    return {"speaker_emb": rng.standard_normal((L, CFG.speaker_embed_dim)).astype(np.float32),
            "prompt_tokens": rng.integers(0, CFG.num_speech_codes,
                                          (L, CFG.speech_cond_prompt_len)).astype(np.int32),
            "emotion": np.full((L,), 0.5, np.float32), "text_tokens": text, "text_len": t_len,
            "seeds": [11, 12][:R]}


@pytest.mark.parametrize("tp, dtype", [(2, torch.float32), (4, torch.float32),
                                       (2, torch.bfloat16)], ids=["tp2", "tp4", "tp2-bf16"])
def test_sharded_decode_gives_every_rank_the_unsharded_tokens(params_np, tp, dtype):
    """bf16 as the card serves: the row-parallel partials are summed in
    float32 before the one cast to bf16."""
    cfg = CFG.with_(kv_cache_dtype="int8")
    inputs, n_steps = _decode_inputs(5), 12
    out = parallel.launch(workers.decode, ["cpu"] * tp,
                          args=(cfg, params_np, inputs, tp, n_steps, dtype),
                          timeout_s=RANK_TIMEOUT_S)
    full = workers._map_leaves(workers._tensors(params_np), lambda path, x: x.to(dtype))
    x = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items() if k != "seeds"}
    with torch.inference_mode():
        cond = tm.cond_embeddings(full, cfg, x["speaker_emb"], x["prompt_tokens"], x["emotion"])
        cache = tm.t3_prefill(full, cfg, cond, x["text_tokens"], x["text_len"])
        state = tm.make_decode_state(cfg, inputs["seeds"], 0.8, 0.95, 0.5, 1.2, "cpu")
        want = tm.t3_decode_slice(full, cfg, cache, state, n_steps).numpy()
    for r in out:
        assert r["kv_heads"] == cfg.num_kv_heads // tp and r["k_dtype"] == "torch.int8"
        np.testing.assert_array_equal(r["tokens"], want)
        # two all-reduces per layer per step
        assert r["collectives"]["all_reduce"] == 2 * cfg.num_layers * n_steps


# ------------------------------------------------------------- entry point
TEXTS = ["Hello world.", "The quick brown fox.", "A port of the trainer.",
         "Streaming speech, one token at a time."]
# 2 adamw steps at lr 1e-5, 4 ranks against one process: the same batches,
# summed in another order. As tests/test_torch_training_data.py holds the
# port's checkpoint to JAX's: an element whose gradient is rounding noise
# may step either way, about lr per step on each side (2 · 2 · 1.004 lr),
# and all but CKPT_LOOSE_SHARE of the elements agree within
# CKPT_TIGHT_LR_MULT · lr.
TRAIN_LR = 1e-5
CKPT_LR_MULT = 4.02
CKPT_TIGHT_LR_MULT = 0.01
CKPT_LOOSE_SHARE = 1e-3
SERVE = dict(text="Hello there. A trained checkpoint.", output_format="wav", voice_id=None,
             cfg_guidance_weight=0.5, synthesis_temperature=0.0, text_processing_chunk_size=40,
             audio_tokens_per_slice=8, remove_trailing_milliseconds=0,
             remove_leading_milliseconds=0, chunk_overlap_strategy="full",
             crossfade_duration_milliseconds=10, request_id="trained")


def _clip(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    f0 = 120.0 + 40.0 * rng.random()
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_t3 --tiny --cpu, 2 steps at --batch 2: once in this process and
    once over --dp 2 --tp 2 (random init from an empty MODEL_PATH)."""
    from chatterbox_tpu.config import reset_config_cache
    from chatterbox_tpu_torch.audio.pcm import write_wav
    from chatterbox_tpu_torch.training import train_t3

    tmp = tmp_path_factory.mktemp("torch_parallel_train")
    (tmp / "empty").mkdir()
    lines = []
    for i, seconds in enumerate((0.8, 0.3, 1.0, 0.36)):
        write_wav(str(tmp / f"clip{i}.wav"), _clip(seconds, i), 16000)
        lines.append(f"{tmp / f'clip{i}.wav'}\t{TEXTS[i]}\n")
    (tmp / "manifest.tsv").write_text("".join(lines))
    mp = pytest.MonkeyPatch()
    for k, v in {"MODEL_PATH": str(tmp / "empty"), "VOICES_DIR": str(tmp / "voices"),
                 "PRELOADED_VOICES_DIR": str(tmp / "preloaded"), "MAX_DECODE_SLOTS": "1"}.items():
        mp.setenv(k, v)
    mp.delenv("CHATTERBOX_S3GEN_ARCH", raising=False)
    mp.setenv("CHATTERBOX_TINY_MODEL", "1")   # what --tiny sets, undone after
    reset_config_cache()
    flags = [str(tmp / "manifest.tsv"), "--tiny", "--cpu", "--steps", "2", "--batch", "2",
             "--lr", str(TRAIN_LR)]
    try:
        single = train_t3.main([*flags, "--out", str(tmp / "single")])
        single["engine"].shutdown()
        meshed = train_t3.main([*flags, "--out", str(tmp / "mesh"), "--dp", "2", "--tp", "2"])
        yield tmp, single, meshed, flags
    finally:
        mp.undo()
        reset_config_cache()


def _ckpt(directory: Path) -> dict:
    import json

    from chatterbox_tpu_torch.runtime.safetensors_io import load_file

    return {name: load_file(directory / f"{name}.safetensors")
            for name in json.loads((directory / "chatterbox_tpu.json").read_text())["models"]}


def test_train_t3_dp2_tp2_matches_one_process(trained):
    tmp, single, meshed, _ = trained
    assert meshed["backend"] == "gloo" and (meshed["dp"], meshed["tp"]) == (2, 2)
    np.testing.assert_allclose(meshed["losses"], single["losses"], rtol=LOSS_RTOL)
    one, four = _ckpt(tmp / "single"), _ckpt(tmp / "mesh")
    assert one.keys() == four.keys() and one["t3"].keys() == four["t3"].keys()
    err = np.concatenate([np.abs(four["t3"][k] - one["t3"][k]).ravel() for k in one["t3"]])
    assert err.max() <= CKPT_LR_MULT * TRAIN_LR
    assert (err > CKPT_TIGHT_LR_MULT * TRAIN_LR).mean() <= CKPT_LOOSE_SHARE
    for name in one:
        if name != "t3":
            for key in one[name]:
                assert np.array_equal(four[name][key], one[name][key]), (name, key)


def test_train_t3_dp2_tp2_checkpoint_serves_in_both_engines(trained, monkeypatch):
    from chatterbox_tpu.config import reset_config_cache
    from chatterbox_tpu.runtime import CancellationToken as JToken
    from chatterbox_tpu.runtime import EngineConfig as JEngineConfig
    from chatterbox_tpu.runtime import TTSEngine as JTTSEngine
    from chatterbox_tpu_torch.runtime.cancellation import CancellationToken
    from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine

    tmp = trained[0]
    monkeypatch.setenv("MODEL_PATH", str(tmp / "mesh"))
    reset_config_cache()

    async def serve(engine, token):
        await engine.ainit()
        head = to_np(engine.params["t3"]["speech_head"]["w"])
        data = b""
        async for chunk in engine.stream(**SERVE, cancellation_token=token):
            data += chunk
        engine.shutdown()
        return data, head

    try:
        twav, thead = asyncio.run(serve(TTSEngine(EngineConfig.tiny(), device="cpu"),
                                        CancellationToken()))
        jwav, jhead = asyncio.run(serve(JTTSEngine(JEngineConfig.tiny()), JToken()))
    finally:
        reset_config_cache()
    trained_head = _ckpt(tmp / "mesh")["t3"]["speech_head/w"]   # the JAX layout
    np.testing.assert_array_equal(jhead, trained_head)
    np.testing.assert_array_equal(thead, trained_head.T)
    for wav in (twav, jwav):
        assert wav[:4] == b"RIFF" and len(wav) > 44
        assert np.abs(np.frombuffer(wav[44:], "<i2")).max() > 0
    assert len(twav) == len(jwav)


def test_train_t3_refuses_a_mesh_that_does_not_fit(trained, tmp_path):
    from chatterbox_tpu_torch.training import train_t3

    flags = trained[3]
    with pytest.raises(ValueError, match="backbone/layers/wq: 4 query heads do not split over tp=3"):
        train_t3.main([*flags, "--out", str(tmp_path / "a"), "--tp", "3"])
    with pytest.raises(ValueError, match="--batch 2 does not split over --dp 4"):
        train_t3.main([*flags, "--out", str(tmp_path / "b"), "--dp", "4"])


def test_tensor_parallel_serving_still_refuses(monkeypatch):
    """Serving under CHATTERBOX_TP is ported (tests/test_torch_tp_serving.py),
    but a tp that does not divide T3's heads still refuses, naming the
    leaf, before any rank starts."""
    import multiprocessing

    from chatterbox_tpu_torch.runtime.engine import EngineConfig, TTSEngine

    monkeypatch.setenv("CHATTERBOX_TP", "3")
    with pytest.raises(ValueError, match="backbone/layers/wq: 4 query heads do not split over tp=3"):
        TTSEngine(EngineConfig.tiny_ref(), device="cpu", devices=["cpu"] * 3)
    assert not multiprocessing.active_children()
