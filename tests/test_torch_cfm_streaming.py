"""The port's streaming CFM against the JAX package's, on the CPU.

After tests/test_cfm_streaming.py and tests/test_s3gen_streaming.py, on
S3GenRefConfig.tiny(): the same parameters (the JAX init, converted), the
same inputs, and the JAX package's noise handed to the port (a slice's
2048-frame buffer from its key; the prompt's from the fixed key 777). The
port's flat state goes through ``decoder.stream_state_to_tree`` into the JAX
package's {"hg", "ring", "klen", "frames"} tree and is compared leaf by leaf.

Tolerances, all float32: 1e-4 on mels, waveforms and sources (summation
order); 1e-4 relative to each state leaf's largest magnitude (GroupNorm sums
of squares reach ~1e3); 2e-4 / 1e-3 where a first slice is held to the
cached path, as the JAX test holds it (right-packed block against
left-packed frames: another reduction order).
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
JFL = JCfg.tiny().flow
M = FL.output_size
TOL = 1e-4
WINDOW = 16


@pytest.fixture(scope="module")
def est():
    jp = jdec.init_estimator_params(jax.random.PRNGKey(0), JFL)
    return jp, convert_params(jax_tree_to_np(jp), "cpu")


@pytest.fixture(scope="module")
def vcache(est):
    """A per-voice cache at batch 1 from both packages (12 prompt frames)."""
    jp, tp = est
    rs = np.random.RandomState(11)
    P = 12
    mu_p, cond_p = rs.randn(1, P, M).astype(np.float32), rs.randn(1, P, M).astype(np.float32)
    spk = rs.randn(1, M).astype(np.float32)
    valid_p = np.ones((1, P), bool)
    jc = jdec.cfm_prompt_prefill(jp, JFL, jax.random.PRNGKey(777),
                                 *map(jnp.asarray, (mu_p, spk, cond_p, valid_p)))
    tc = tdec.cfm_prompt_prefill(tp, FL, prompt_noise(M), *map(to_t, (mu_p, spk, cond_p, valid_p)))
    return jc, tc


def _noise(key, B):
    return to_t(jax.random.normal(key, (B, 2048, M), jnp.float32))


def _port_slice(tp, tc, key, mu, spk, tg, state):
    return tdec.cfm_generate_streaming(tp, FL, _noise(key, mu.shape[0]), to_t(mu), to_t(spk),
                                       to_t(tg), tc, state)


@pytest.mark.parametrize("tg", [8, 5])
def test_first_slice_matches_cached(est, vcache, tg):
    """A fresh state's first slice is the cached solve of the same frames
    (right-packed here, left-packed there)."""
    (_, tp), (_, tc) = est, vcache
    Tg = 8
    rs = np.random.RandomState(6)
    mu_l, spk = rs.randn(1, Tg, M).astype(np.float32), rs.randn(1, M).astype(np.float32)
    mu_l[:, tg:] = 0.0
    key = jax.random.PRNGKey(5)
    valid_l = np.arange(Tg)[None] < tg
    mel_c = tdec.cfm_generate_cached(tp, FL, _noise(key, 1), to_t(mu_l), to_t(spk),
                                     to_t(valid_l), tc)
    mu_r = np.roll(mu_l, Tg - tg, axis=1)
    st = tdec.init_stream_state(FL, tc, WINDOW)
    mel_s, st2 = _port_slice(tp, tc, key, mu_r, spk, np.array([tg], np.int32), st)
    np.testing.assert_allclose(to_np(mel_s)[0, Tg - tg:], to_np(mel_c)[0, :tg], atol=2e-4,
                               rtol=1e-3)
    assert int(st2["frames"][0]) == tg and int(st2["klen"][0]) == tg


def test_slices_and_state_match_jax(est, vcache):
    """Three slices at batch 2 through a 16-frame ring (the third evicts;
    in the third, lane 1 is batch padding with tg = 0): each slice's mel on
    the valid frames, and the whole state after every slice, leaf by leaf."""
    (jp, tp), (jc, tc) = est, vcache
    B, Tg = 2, 8
    rs = np.random.RandomState(21)
    spk = rs.randn(B, M).astype(np.float32)
    jst = jdec.init_stream_state(JFL, jc, WINDOW, batch=B)
    tst = tdec.init_stream_state(FL, tc, WINDOW, batch=B)
    assert_trees_close(jst, tdec.stream_state_to_tree(FL, tst))
    for i, tg in enumerate(([8, 5], [8, 7], [8, 0])):
        tg = np.array(tg, np.int32)
        mu = rs.randn(B, Tg, M).astype(np.float32)
        key = jax.random.PRNGKey(30 + i)
        want, jst = jdec.cfm_generate_streaming(jp, JFL, key, jnp.asarray(mu), jnp.asarray(spk),
                                                jnp.asarray(tg), jc, jst)
        got, tst = _port_slice(tp, tc, key, mu, spk, tg, tst)
        valid = np.arange(Tg)[None] >= (Tg - tg[:, None])
        np.testing.assert_allclose(to_np(got)[valid], np.asarray(want)[valid], atol=TOL,
                                   rtol=TOL, err_msg=f"slice {i}")
        assert_trees_close(jst, tdec.stream_state_to_tree(FL, tst))
    assert to_np(tst["klen"]).tolist() == [16, 12] and to_np(tst["frames"]).tolist() == [24, 12]


def test_ring_append_matches_jax():
    """The ring update alone: lanes that fill, overflow (evict), pass
    (tg = 0) and start empty, against the JAX package's ``_ring_append``."""
    rng = np.random.default_rng(4)
    B2, W, Tg, H, dh = 4, 10, 6, 2, 3
    ring = rng.standard_normal((B2, W, H, dh)).astype(np.float32)
    caps = rng.standard_normal((B2, Tg, H, dh)).astype(np.float32)
    klen, tg = np.array([3, 9, 5, 0], np.int32), np.array([4, 6, 0, 6], np.int32)
    tree = lambda a: {"down": {"resnet": None, "tf": [{"k": a, "v": -a}], "conv": None},  # noqa: E731
                      "mid": [], "up": {"resnet": None, "tf": [], "conv": None},
                      "final": {"conv": None, "gn": None}}
    want, want_len = jdec._ring_append(tree(jnp.asarray(ring)), tree(jnp.asarray(caps)),
                                       jnp.asarray(klen), jnp.asarray(tg), W, Tg)
    head = lambda a: to_t(a.transpose(0, 2, 1, 3))[None]  # noqa: E731  [1, B2, H, L, dh]
    k, v, got_len = tdec._ring_append(head(ring), head(-ring), head(caps), head(-caps),
                                      to_t(klen).long(), to_t(tg).long(), Tg)
    np.testing.assert_array_equal(to_np(got_len), np.asarray(want_len))
    np.testing.assert_array_equal(to_np(k[0].transpose(1, 2)), np.asarray(want["down"]["tf"][0]["k"]))
    np.testing.assert_array_equal(to_np(v[0].transpose(1, 2)), np.asarray(want["down"]["tf"][0]["v"]))


def test_padding_lane_state_passthrough(est, vcache):
    """A lane with tg = 0 keeps its ring, klen, frames, halos and GroupNorm
    statistics bit for bit; the other lane advances."""
    (_, tp), (_, tc) = est, vcache
    B, Tg = 2, 8
    rs = np.random.RandomState(41)
    spk = rs.randn(B, M).astype(np.float32)
    st = tdec.init_stream_state(FL, tc, WINDOW, batch=B)
    _, st1 = _port_slice(tp, tc, jax.random.PRNGKey(40), rs.randn(B, Tg, M).astype(np.float32),
                         spk, np.array([8, 8], np.int32), st)
    _, st2 = _port_slice(tp, tc, jax.random.PRNGKey(42), rs.randn(B, Tg, M).astype(np.float32),
                         spk, np.array([8, 0], np.int32), st1)
    assert to_np(st2["frames"]).tolist() == [16, 8] and to_np(st2["klen"]).tolist() == [16, 8]
    lane1 = [1, B + 1]
    for key, ax in tdec.STATE_LANE_AXIS.items():
        a, b = st1[key].index_select(ax, torch.tensor(lane1)), st2[key].index_select(ax, torch.tensor(lane1))
        assert torch.equal(a, b), key
        a0, b0 = st1[key].select(ax, 0), st2[key].select(ax, 0)
        if key != "halo":   # lane 0's halos may repeat by chance; its ring and sums move
            assert not torch.equal(a0, b0), key


def test_stack_and_split_stream_states(est, vcache):
    """Three batch-1 states → one batch-3 state with lanes [c×3, u×3] →
    the same three states back."""
    _, tc = vcache
    rs = np.random.RandomState(0)
    states = []
    for i in range(3):
        st = tmodel.init_s3gen_stream_state(CFG, tc, WINDOW, cap_tokens=6)
        st = {"cfm": {k: a + i if a.is_floating_point() else a + i for k, a in st["cfm"].items()},
              "mel": st["mel"] + to_t(rs.randn(*st["mel"].shape).astype(np.float32))}
        states.append(st)
    stacked = tmodel.stack_stream_states(states)
    assert stacked["cfm"]["k"].shape[1] == 6 and stacked["cfm"]["klen"].tolist() == [0, 1, 2]
    assert torch.equal(stacked["cfm"]["halo"][:, 1], states[1]["cfm"]["halo"][:, 0])
    assert torch.equal(stacked["cfm"]["halo"][:, 4], states[1]["cfm"]["halo"][:, 1])
    for a, b in zip(tmodel.split_stream_state(stacked, 3), states):
        assert torch.equal(a["mel"], b["mel"])
        for k in b["cfm"]:
            assert torch.equal(a["cfm"][k], b["cfm"][k]), k


# ----------------------------------------------- s3gen_ref_inference_streaming
CAP, NEW_BLOCK = 12, 6
SPT, FPT = CFG.samples_per_token, FL.up_stride
TAIL = 6 * SPT


@pytest.fixture(scope="module")
def s3gen():
    jcfg = JCfg.tiny()
    jp = conditioned_s3gen_params(jmodel.init_s3gen_ref_params(jax.random.PRNGKey(0), jcfg), jcfg)
    rng = np.random.default_rng(1)
    ref = {"spk_emb": rng.standard_normal((1, 192)).astype(np.float32),
           "prompt_tokens": rng.integers(0, 6561, (1, jcfg.max_prompt_tokens)).astype(np.int32),
           "prompt_len": np.array([6], np.int32),
           "prompt_mel": rng.standard_normal((1, jcfg.max_prompt_mel, 80)).astype(np.float32),
           "prompt_mel_len": np.array([12], np.int32)}
    jref, tref = jax.tree.map(jnp.asarray, ref), {k: to_t(v) for k, v in ref.items()}
    tp = convert_params(jax_tree_to_np(jp), "cpu")
    jc = jmodel.s3gen_ref_prompt_prefill(jp, jcfg, jref, jax.random.PRNGKey(777))
    tc = tmodel.s3gen_ref_prompt_prefill(tp, CFG, tref, prompt_noise(M))
    tokens = rng.integers(0, 50, (1, CAP)).astype(np.int32)
    return jcfg, jp, tp, jref, tref, jc, tc, tokens


def test_first_slice_matches_tail_path(s3gen):
    """A chunk's first streaming slice equals s3gen_ref_inference_tail with
    the same cache and noise (up to summation order; the JAX test's 2e-3 on
    the wav, 1e-3 on the source); the buffer past the new frames stays 0."""
    _, _, tp, _, tref, _, tc, tokens = s3gen
    n0 = 4
    noise = jax_s3gen_noise(JCfg.tiny(), jax.random.PRNGKey(9), 1, CAP)
    src0 = torch.zeros((1, CAP * SPT))
    want, want_src = tmodel.s3gen_ref_inference_tail(
        tp, CFG, to_t(tokens), torch.tensor([n0]), tref, src0, torch.tensor([0]), noise,
        torch.tensor([0]), TAIL, cfm_cache=tc)
    st0 = tmodel.init_s3gen_stream_state(CFG, tc, window=32, cap_tokens=CAP)
    got, got_src, st1 = tmodel.s3gen_ref_inference_streaming(
        tp, CFG, to_t(tokens), torch.tensor([n0]), torch.tensor([n0]), tref, src0,
        torch.tensor([0]), noise, torch.tensor([0]), TAIL, st0, NEW_BLOCK, tc)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=2e-3)
    np.testing.assert_allclose(to_np(got_src), to_np(want_src), rtol=0, atol=1e-3)
    assert int(st1["cfm"]["frames"][0]) == n0 * FPT
    assert (to_np(st1["mel"])[0, n0 * FPT:] == 0.0).all()


def test_slice_sequence_matches_jax(s3gen):
    """Three slices of one chunk through both packages: each slice's wav
    tail and source, and the state (CFM context and frozen mel) after each;
    the emitted mel prefix stays frozen across slices."""
    jcfg, jp, tp, jref, tref, jc, tc, tokens = s3gen
    key = jax.random.PRNGKey(9)
    noise = jax_s3gen_noise(jcfg, key, 1, CAP)
    jst = jmodel.init_s3gen_stream_state(jcfg, jc, window=32, cap_tokens=CAP)
    tst = tmodel.init_s3gen_stream_state(CFG, tc, window=32, cap_tokens=CAP)
    jsrc, tsrc = jnp.zeros((1, CAP * SPT)), torch.zeros((1, CAP * SPT))
    prev = tlen = 0
    for n in (4, 4, 4):
        tlen += n
        start = min(prev, CAP * SPT - TAIL)
        jw, jsrc, jst = jmodel.s3gen_ref_inference_streaming(
            jp, jcfg, jnp.asarray(tokens), jnp.array([tlen]), jnp.array([n]), jref, jsrc,
            jnp.array([prev]), key, jnp.array([start]), TAIL, jst, NEW_BLOCK, cfm_cache=jc)
        old_mel = tst["mel"]
        tw, tsrc, tst = tmodel.s3gen_ref_inference_streaming(
            tp, CFG, to_t(tokens), torch.tensor([tlen]), torch.tensor([n]), tref, tsrc,
            torch.tensor([prev]), noise, torch.tensor([start]), TAIL, tst, NEW_BLOCK, tc)
        peak = float(np.abs(np.asarray(jw)).max())
        assert 1e-3 < peak < jcfg.hift.audio_limit, peak
        np.testing.assert_allclose(to_np(tw), np.asarray(jw), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(to_np(tsrc), np.asarray(jsrc), atol=TOL, rtol=TOL)
        assert_trees_close(jst, {"cfm": tdec.stream_state_to_tree(FL, tst["cfm"]),
                                 "mel": tst["mel"]})
        assert torch.equal(tst["mel"][0, : (tlen - n) * FPT], old_mel[0, : (tlen - n) * FPT])
        prev = tlen * SPT
    assert int(tst["cfm"]["frames"][0]) == CAP * FPT
