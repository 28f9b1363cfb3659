"""The port's CFM prompt cache against the JAX package's, on the CPU.

After tests/test_cfm_prompt_cache.py, on S3GenRefConfig.tiny(): the same
parameters (the JAX init, converted), the same inputs, and the JAX package's
own noise handed to the port (the prompt's from the fixed key 777, a
chunk's from its key). Leaf by leaf, the port's flat context goes through
``decoder.context_to_tree`` into the JAX package's capture tree.

Tolerances, all float32: 1e-4 on mels and waveforms (summation order); on the
captured context 1e-4 relative to each leaf's largest magnitude (GroupNorm
sums of squares reach ~1e3). The JAX side attends over prepended keys with
its einsum, the port with K2's context form (plain version here): they agree
on every valid frame.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    assert_trees_close,
    conditioned_s3gen_params,
    jax_s3gen_noise,
    jax_tree_to_np,
    prompt_noise,
    to_np,
    to_t,
)

from chatterbox_tpu.models.s3gen_ref import decoder as jdec
from chatterbox_tpu.models.s3gen_ref import model as jmodel
from chatterbox_tpu.models.s3gen_ref.config import S3GenRefConfig as JCfg
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.models.s3gen_ref import decoder as tdec
from chatterbox_tpu_torch.models.s3gen_ref import model as tmodel
from chatterbox_tpu_torch.models.s3gen_ref.config import S3GenRefConfig

CFG = S3GenRefConfig.tiny()
FL = CFG.flow
M = FL.output_size
TOL = 1e-4


@pytest.fixture(scope="module")
def est():
    jp = jdec.init_estimator_params(jax.random.PRNGKey(0), JCfg.tiny().flow)
    return jp, convert_params(jax_tree_to_np(jp), "cpu")


@pytest.fixture(scope="module")
def vcache(est):
    """A per-voice cache at batch 1 from both packages: 12 prompt frames,
    the first 3 masked (the left pad of a short prompt)."""
    jp, tp = est
    rs = np.random.RandomState(11)
    P = 12
    mu_p, cond_p = rs.randn(1, P, M).astype(np.float32), rs.randn(1, P, M).astype(np.float32)
    spk = rs.randn(1, M).astype(np.float32)
    valid_p = np.ones((1, P), bool)
    valid_p[0, :3] = False
    jc = jdec.cfm_prompt_prefill(jp, JCfg.tiny().flow, jax.random.PRNGKey(777),
                                 *map(jnp.asarray, (mu_p, spk, cond_p, valid_p)))
    tc = tdec.cfm_prompt_prefill(tp, FL, prompt_noise(M), *map(to_t, (mu_p, spk, cond_p, valid_p)))
    return jc, tc


def test_prompt_prefill_matches_jax(vcache):
    """Every captured leaf (K/V per block, halos, GroupNorm statistics, per
    Euler step), and the converter's round trip is exact."""
    jc, tc = vcache
    np.testing.assert_array_equal(to_np(tc["pv"]), np.asarray(jc["pv"]))
    assert tc["est"]["k"].shape[:2] == (FL.n_timesteps, 3)   # S steps, 3 transformer blocks
    tree = tdec.context_to_tree(FL, tc["est"])
    assert_trees_close(jc["est"], tree)
    back = tdec.context_from_tree(FL, tree)
    assert back.keys() == tc["est"].keys()
    for k in back:
        assert torch.equal(back[k], tc["est"][k]), k


def _cached_inputs(B=2, Tg=8, seed=5):
    rs = np.random.RandomState(seed)
    mu, spk = rs.randn(B, Tg, M).astype(np.float32), rs.randn(B, M).astype(np.float32)
    valid = np.ones((B, Tg), bool)
    valid[1, 5:] = False
    return mu, spk, valid


@pytest.mark.parametrize("mode", ["step", "static"])
def test_cached_generate_matches_jax(est, vcache, mode):
    """cfm_generate_cached at batch 2 against a batch-1 voice cache (the
    [c, u] → [c×B, u×B] lane expansion), in "step" and "static" mode, on the
    valid frames."""
    (jp, tp), (jc, tc) = est, vcache
    if mode == "static":
        jc = {"est": jax.tree.map(lambda a: a[-1:], jc["est"]), "pv": jc["pv"]}
        tc = tdec.static_prompt_cache(tc)
        assert tc["est"]["k"].shape[0] == 1
    mu, spk, valid = _cached_inputs()
    key = jax.random.PRNGKey(5)
    want = jdec.cfm_generate_cached(jp, JCfg.tiny().flow, key, *map(jnp.asarray, (mu, spk, valid)),
                                    jc)
    noise = to_t(jax.random.normal(key, (2, 2048, M), jnp.float32))
    got = tdec.cfm_generate_cached(tp, FL, noise, *map(to_t, (mu, spk, valid)), tc)
    np.testing.assert_allclose(to_np(got)[valid], np.asarray(want)[valid], atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def s3gen():
    jcfg = JCfg.tiny()
    jp = conditioned_s3gen_params(jmodel.init_s3gen_ref_params(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, jp, convert_params(jax_tree_to_np(jp), "cpu")


def _ref(jcfg, prompt_len, seed=1):
    rng = np.random.default_rng(seed)
    P, Pm, up = jcfg.max_prompt_tokens, jcfg.max_prompt_mel, jcfg.flow.up_stride
    tokens = rng.integers(0, 6561, (1, P)).astype(np.int32)
    tokens[:, prompt_len:] = 0
    mel = rng.standard_normal((1, Pm, 80)).astype(np.float32)
    mel[:, prompt_len * up:] = 0.0
    return {"spk_emb": rng.standard_normal((1, 192)).astype(np.float32),
            "prompt_tokens": tokens, "prompt_len": np.array([prompt_len], np.int32),
            "prompt_mel": mel, "prompt_mel_len": np.array([prompt_len * up], np.int32)}


def test_empty_prompt_cached_path_is_exact(s3gen):
    """With no valid prompt token the cached mel equals the uncached one to
    summation order (1e-5, as the JAX test; the merged-statistics GroupNorm
    against the two-pass one), and so does the source."""
    jcfg, _, tp = s3gen
    ref = {k: to_t(v) for k, v in _ref(jcfg, 0).items()}
    cache = tmodel.s3gen_ref_prompt_prefill(tp, CFG, ref, prompt_noise(M))
    T = 8
    tokens = torch.as_tensor(np.random.RandomState(7).randint(0, 50, (1, T)))
    args = (tp, CFG, tokens, torch.tensor([6]), ref, torch.zeros((1, T * CFG.samples_per_token)),
            torch.tensor([0]), jax_s3gen_noise(jcfg, jax.random.PRNGKey(42), 1, T))
    mel_c, src_c = tmodel._mel_and_source(*args, cfm_cache=cache)
    mel_u, src_u = tmodel._mel_and_source(*args)
    np.testing.assert_allclose(to_np(mel_c), to_np(mel_u), atol=1e-5)
    np.testing.assert_allclose(to_np(src_c), to_np(src_u), atol=1e-6)


def test_real_prompt_cached_inference_matches_jax(s3gen):
    """s3gen_ref_prompt_prefill + s3gen_ref_inference with the cache, end to
    end against the JAX package's, waveform and source; the cache is really
    used (the uncached waveform differs)."""
    jcfg, jp, tp = s3gen
    ref_np = _ref(jcfg, jcfg.max_prompt_tokens)
    jref, tref = jax.tree.map(jnp.asarray, ref_np), {k: to_t(v) for k, v in ref_np.items()}
    jc = jmodel.s3gen_ref_prompt_prefill(jp, jcfg, jref, jax.random.PRNGKey(777))
    tc = tmodel.s3gen_ref_prompt_prefill(tp, CFG, tref, prompt_noise(M))
    T, spt = 8, CFG.samples_per_token
    tokens = np.random.RandomState(7).randint(0, 50, (1, T)).astype(np.int32)
    key = jax.random.PRNGKey(43)
    want_w, want_s = jmodel.s3gen_ref_inference(
        jp, jcfg, jnp.asarray(tokens), jnp.array([6]), jref, jnp.zeros((1, T * spt)),
        jnp.array([0]), key, cfm_cache=jc)
    noise = jax_s3gen_noise(jcfg, key, 1, T)
    args = (tp, CFG, to_t(tokens), torch.tensor([6]), tref, torch.zeros((1, T * spt)),
            torch.tensor([0]), noise)
    got_w, got_s = tmodel.s3gen_ref_inference(*args, cfm_cache=tc)
    peak = float(np.abs(np.asarray(want_w)).max())
    assert 1e-3 < peak < jcfg.hift.audio_limit, peak
    np.testing.assert_allclose(to_np(got_w), np.asarray(want_w), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(to_np(got_s), np.asarray(want_s), atol=TOL, rtol=TOL)
    uncached, _ = tmodel.s3gen_ref_inference(*args)
    assert not np.allclose(to_np(uncached), to_np(got_w), atol=1e-6)


# ----------------------------------------------------- mechanism unit tests
def _conv(rs, cin, cout):
    """A k = 3 conv in both layouts: JAX [K, Cin, Cout], the port [Cout, Cin, K]."""
    w, b = rs.randn(3, cin, cout).astype(np.float32), rs.randn(cout).astype(np.float32)
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, {"w": to_t(w.transpose(2, 1, 0)), "b": to_t(b)}


def test_conv_halo_matches_concat_and_jax():
    """_conv_h with a frozen boundary frame == the generated rows of a
    SAME_TORCH conv over [prompt | generated]; the pos-injected halo of a
    right-packed block and the capture match the JAX package's."""
    from chatterbox_tpu.ops.conv import conv1d as jconv1d

    rs = np.random.RandomState(0)
    p, g = rs.randn(2, 5, 4).astype(np.float32), rs.randn(2, 7, 4).astype(np.float32)
    jw, tw = _conv(rs, 4, 6)
    full = jconv1d(jnp.concatenate([p, g], 1), jw["w"], jw["b"], padding="SAME_TORCH")
    got = tdec._conv_h(to_t(g), tw, pc=to_t(p[:, -1:]))
    np.testing.assert_allclose(to_np(got), np.asarray(full[:, 5:]), atol=1e-5, rtol=1e-5)
    pos = np.array([0, 3], np.int32)
    want, want_cap = jdec._conv_h(jnp.asarray(g), jw, jnp.asarray(p[:, -1:]), cap=True,
                                  pos=jnp.asarray(pos))
    got, got_cap = tdec._conv_h(to_t(g), tw, to_t(p[:, -1:]), cap=True, pos=to_t(pos))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(to_np(got_cap), np.asarray(want_cap))
    np.testing.assert_array_equal(to_np(got_cap), g[:, -1:])


def test_group_norm_stats_merge_matches_joint_and_jax():
    """GroupNorm over generated frames with the prompt's captured statistics
    == GroupNorm over [prompt | generated] (generated rows), and equals the
    JAX package's merged form."""
    rs = np.random.RandomState(2)
    B, Tp, Tg, C, G = 2, 6, 9, 16, 4
    p, g = rs.randn(B, Tp, C).astype(np.float32), rs.randn(B, Tg, C).astype(np.float32)
    w, b = rs.randn(C).astype(np.float32), rs.randn(C).astype(np.float32)
    vp = np.array([[1, 1, 1, 1, 0, 0], [1] * 6], bool)
    vg = np.array([[1] * 7 + [0, 0], [1] * 9], bool)
    _, stats = tdec._group_norm(to_t(p), to_t(w), to_t(b), groups=G, valid=to_t(vp), cap=True)
    merged = tdec._group_norm(to_t(g), to_t(w), to_t(b), groups=G, valid=to_t(vg), extra=stats)
    joint = tdec._group_norm(to_t(np.concatenate([p, g], 1)), to_t(w), to_t(b), groups=G,
                             valid=to_t(np.concatenate([vp, vg], 1)))
    np.testing.assert_allclose(to_np(merged), to_np(joint)[:, Tp:], atol=1e-5, rtol=1e-4)
    _, jstats = jdec._group_norm(jnp.asarray(p), w, b, groups=G, valid=jnp.asarray(vp), cap=True)
    np.testing.assert_allclose(to_np(stats["s"]), np.stack([jstats["s1"], jstats["s2"]], 1),
                               rtol=1e-6)
    np.testing.assert_array_equal(to_np(stats["n"]), np.asarray(jstats["n"]))
    jmerged = jdec._group_norm(jnp.asarray(g), w, b, groups=G, valid=jnp.asarray(vg), extra=jstats)
    np.testing.assert_allclose(to_np(merged), np.asarray(jmerged), atol=1e-5, rtol=1e-5)


def test_tf_block_cached_cross_attention_matches_concat_and_jax(est):
    """The prompt rows' K/V do not depend on the generated rows, so the
    generated rows of a joint block equal the block over the frozen prompt
    K/V (K2's context form); both packages agree on valid rows, and a
    K/V ring prepends the same way."""
    jp, tp = est
    jtf, ttf = jp["mid"][0]["tf"][0], tp["mid"][0]["tf"][0]
    jfl = JCfg.tiny().flow
    ch = FL.dec_channels[0]
    rs = np.random.RandomState(3)
    xp, xg = rs.randn(2, 5, ch).astype(np.float32), rs.randn(2, 4, ch).astype(np.float32)
    vp = np.array([[1, 1, 1, 0, 0], [1] * 5], bool)
    vg = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], bool)
    _, rec = tdec._tf_block(ttf, FL, to_t(xp), to_t(vp), cap=True)
    ctx = (rec["k"], rec["v"], None, None, to_t(np.concatenate([vp, vg], 1)))
    cached = tdec._tf_block(ttf, FL, to_t(xg), to_t(vg), ctx=ctx)
    joint = tdec._tf_block(ttf, FL, to_t(np.concatenate([xp, xg], 1)),
                           to_t(np.concatenate([vp, vg], 1)))
    np.testing.assert_allclose(to_np(cached)[vg], to_np(joint)[:, 5:][vg], atol=1e-5, rtol=1e-4)
    _, jrec = jdec._tf_block(jtf, jfl, jnp.asarray(xp), jnp.asarray(vp), cap=True)
    np.testing.assert_allclose(to_np(rec["k"].transpose(1, 2)), np.asarray(jrec["k"]), atol=1e-6)
    ring_mask = np.array([[1, 1, 0], [1, 0, 0]], bool)
    jring = {"k": jrec["k"][:, :3], "v": jrec["v"][:, :3], "mask": jnp.asarray(ring_mask)}
    want = jdec._tf_block(jtf, jfl, jnp.asarray(xg), jnp.asarray(vg), pc=jrec,
                          pvalid=jnp.asarray(vp), ring=jring)
    ctx = (rec["k"], rec["v"], rec["k"][:, :, :3].contiguous(), rec["v"][:, :, :3].contiguous(),
           to_t(np.concatenate([vp, ring_mask, vg], 1)))
    got = tdec._tf_block(ttf, FL, to_t(xg), to_t(vg), ctx=ctx)
    np.testing.assert_allclose(to_np(got)[vg], np.asarray(want)[vg], atol=TOL, rtol=TOL)
