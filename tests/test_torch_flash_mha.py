"""K2 parity: the port's flash MHA (plain version, which its wrapper runs
for CPU tensors) against the JAX package's Pallas ``flash_mha(...,
interpret=True)``, including a ragged T and an all-masked row; its context
form (Tq queries over Tk prepended keys) against the JAX package's einsum
branch of ``_tf_block`` on valid rows; the port's estimator transformer
block against JAX ``_tf_block`` on its flash branch; and the precision
contract of the CUDA kernel's tensor-core products, emulated in plain torch,
for both forms. The context form over segments read in place
(``flash_mha_context``: a prompt shared by the lanes or per lane, a ring or
none, in each dtype pair) against JAX's einsum and ``_tf_block`` with pc /
ring, its kernel's product split emulated, and its wrapper's refusals. The
CUDA kernels themselves are compared with the plain versions on the card, by
chip_smoke.py. Tolerance 2e-5 (float32, as tests/test_pallas_mha.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_helpers import jax_tree_to_np, to_np, to_t

from chatterbox_tpu.models.s3gen_ref import decoder as jdec
from chatterbox_tpu.models.s3gen_ref.config import FlowRefConfig as JFlowCfg
from chatterbox_tpu.ops.pallas_mha import flash_mha as jflash
from chatterbox_tpu_torch.convert import convert_params
from chatterbox_tpu_torch.models.s3gen_ref import decoder as tdec
from chatterbox_tpu_torch.models.s3gen_ref.config import FlowRefConfig
from chatterbox_tpu_torch.ops import flash_mha as fm

TOL = 2e-5


def _qkv(seed, B, H, T, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("T", [256, 100, 300])  # 100 and 300: ragged against the 256 block
def test_flash_mha_matches_pallas(T):
    B, H, dh = 2, 3, 64
    q, k, v = _qkv(0, B, H, T, dh)
    valid = np.ones((B, T), bool)
    valid[1, T - T // 3:] = False
    want = jflash(*map(jnp.asarray, (q, k, v, valid)), scale=0.125, interpret=True)
    got = fm.flash_mha(*map(to_t, (q, k, v, valid)), scale=0.125)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=TOL, rtol=TOL)


def test_all_masked_row_returns_zero_like_pallas():
    B, H, T, dh = 2, 2, 130, 64
    q, k, v = _qkv(3, B, H, T, dh)
    valid = np.ones((B, T), bool)
    valid[0] = False  # lane 0: empty key set
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v, valid)), interpret=True))
    got = to_np(fm.flash_mha(*map(to_t, (q, k, v, valid))))
    np.testing.assert_allclose(got[0], 0.0, atol=0)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_tf_block_matches_jax_flash_branch(monkeypatch):
    """decoder._tf_block: JAX on its flash branch (K2, interpret) against the
    port's block, whose attention is always K2."""
    monkeypatch.setattr(jdec, "_FLASH_INTERPRET", True)
    jcfg = JFlowCfg.tiny()
    p = jdec.init_estimator_params(jax.random.PRNGKey(0), jcfg)
    tf_j = p["mid"][0]["tf"][0]
    tf_t = convert_params(jax_tree_to_np(tf_j), "cpu")
    B, T, C = 2, 70, jcfg.dec_channels[0]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, 50:] = False
    want = jdec._tf_block(tf_j, jcfg, jnp.asarray(x), jnp.asarray(valid))
    got = tdec._tf_block(tf_t, FlowRefConfig.tiny(), to_t(x), to_t(valid))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=TOL, rtol=TOL)


def test_wrapper_uses_plain_version_on_cpu_and_counts_no_launch():
    """Self and context form alike: no launch is counted on the CPU (the
    counts now also hold the context form's, under <dtype>_ctx)."""
    q, k, v = _qkv(4, 1, 2, 40, 32)
    valid = np.ones((1, 40), bool)
    fm.reset_launches()
    got = fm.flash_mha(*map(to_t, (q, k, v, valid)))
    want = fm.flash_mha_plain(*map(to_t, (q, k, v, valid)))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    got = fm.flash_mha(to_t(q[:, :, :7]), *map(to_t, (k, v, valid)))
    torch.testing.assert_close(got, want[:, :, :7], atol=0, rtol=0)
    assert fm.launches == {"float32": 0, "bfloat16": 0, "float32_ctx": 0, "bfloat16_ctx": 0}


def test_wrapper_rejects_other_devices():
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fm.flash_mha(q, q, q, torch.ones((1, 4), dtype=torch.bool, device="meta"))


# --- the precision contract of the kernel's tensor-core products, emulated ---
#
# csrc/flash_mha.cu multiplies on the tensor cores. Its float32 body splits
# every operand x into hi = bf16(x) and lo = bf16(x - hi) and takes each
# product as hi·hi + hi·lo + lo·hi with f32 sums ("bf16x3"). The contract:
# at the batched path's shapes that stays within CONTRACT_TOL of the plain
# float32 version. TF32x3 (the same split in TF32) qualifies too; one-pass
# bf16 or TF32 does not.

CONTRACT_TOL = 2e-5


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def _round_tf32(x):
    """TF32: float32 with the low 13 mantissa bits zeroed."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


_ROUNDING = {"bf16": _round_bf16, "tf32": _round_tf32}


def _product(a, b, eq, rnd, passes):
    if passes == 1:
        return torch.einsum(eq, rnd(a), rnd(b))
    a_hi, b_hi = rnd(a), rnd(b)
    a_lo, b_lo = rnd(a - a_hi), rnd(b - b_hi)
    return (torch.einsum(eq, a_hi, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_lo, b_hi))


def _emulated_mha(q, k, v, valid, scale, rnd, passes=3):
    """flash_mha_plain's arithmetic with Q·Kᵀ and P·V taken under a rounding
    scheme of the tensor cores (``passes`` = 3: the hi/lo split)."""
    s = _product(q, k, "bhid,bhjd->bhij", rnd, passes) * scale
    kmask = valid[:, None, None, :]
    s = s.masked_fill(~kmask, -1e9)
    p = torch.where(kmask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = _product(p, v, "bhij,bhjd->bhid", rnd, passes)
    return out / p.sum(-1, keepdim=True).clamp_min(1e-30)


def _contract_error(B, H, T, dh, valid, rnd, passes, seed):
    """max |emulated − plain| over randn inputs, 8 lanes at a time."""
    q, k, v = (to_t(x) for x in _qkv(seed, B, H, T, dh))
    valid = to_t(valid)
    err = 0.0
    for b0 in range(0, B, 8):
        lanes = (q[b0:b0 + 8], k[b0:b0 + 8], v[b0:b0 + 8], valid[b0:b0 + 8])
        got = _emulated_mha(*lanes, 0.125, rnd, passes)
        err = max(err, (got - fm.flash_mha_plain(*lanes, scale=0.125)).abs().max().item())
    return err


@pytest.mark.parametrize("scheme", ["bf16", "tf32"])
def test_split_contract_at_batched_shapes(scheme):
    """B = 32 CFG lanes, H = 8, T = 628, dh = 64, scale 0.125, with the padded
    tail and leading mask chip_smoke.py uses."""
    B, T = 32, 628
    valid = np.ones((B, T), bool)
    valid[0, T - 37:] = False
    valid[1, :100] = False
    err = _contract_error(B, 8, T, 64, valid, _ROUNDING[scheme], 3, seed=9)
    assert err <= CONTRACT_TOL, err


def _ragged_valid(B, T):
    valid = np.ones((B, T), bool)
    valid[0, T - 37:] = False     # padded tail
    valid[1, T - 300:] = False
    valid[2] = False              # a lane whose keys are all masked
    return valid


@pytest.mark.parametrize("scheme", ["bf16", "tf32"])
def test_split_contract_at_ragged_t_with_masked_tail(scheme):
    B, T = 4, 1012
    err = _contract_error(B, 8, T, 64, _ragged_valid(B, T), _ROUNDING[scheme], 3, seed=10)
    assert err <= CONTRACT_TOL, err


@pytest.mark.parametrize("scheme", ["bf16", "tf32"])
def test_one_pass_rounding_breaks_the_contract(scheme):
    """Why the float32 body splits: one pass of either type misses the bound."""
    B, T = 4, 1012
    err = _contract_error(B, 8, T, 64, _ragged_valid(B, T), _ROUNDING[scheme], 1, seed=10)
    assert err > CONTRACT_TOL, err


@pytest.mark.parametrize("T", [256, 100, 300])
def test_split_contract_matches_pallas(T):
    """The emulated bf16x3 products against the JAX kernel (interpret mode)."""
    B, H, dh = 2, 3, 64
    q, k, v = _qkv(0, B, H, T, dh)
    valid = np.ones((B, T), bool)
    valid[1, T - T // 3:] = False
    want = jflash(*map(jnp.asarray, (q, k, v, valid)), scale=0.125, interpret=True)
    got = _emulated_mha(*map(to_t, (q, k, v, valid)), 0.125, _round_bf16)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)


# --- the context form: Tq new frames over [prompt | ring | own] keys ---

def _ctx_inputs(seed, B, H, Tq, n_ctx, dh):
    """q [B, H, Tq, dh], k/v [B, H, n_ctx + Tq, dh] and the key mask of a
    cached or streaming call: a prompt with a masked left pad, a partly
    filled ring, and the block's own right-packed frames."""
    rng = np.random.default_rng(seed)
    Tk = n_ctx + Tq
    q = rng.standard_normal((B, H, Tq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, Tk, dh)).astype(np.float32) for _ in range(2))
    valid = np.ones((B, Tk), bool)
    valid[:, : n_ctx // 4] = False             # the prompt's left pad
    valid[:, n_ctx // 2 + 17: n_ctx] = False   # the ring past its klen
    valid[0, n_ctx: n_ctx + Tq // 3] = False   # lane 0: a short right-packed block
    return q, k, v, valid


def _jax_einsum_attention(q, k, v, valid, scale):
    """The JAX package's context branch (decoder.py:293-298), on the head-major
    layout: masked softmax over all Tk keys, float32."""
    s = jnp.einsum("bhid,bhjd->bhij", q, k, preferred_element_type=jnp.float32) * scale
    s = jnp.where(valid[:, None, None, :], s, -1e9)
    return jnp.einsum("bhij,bhjd->bhid", jax.nn.softmax(s, axis=-1), v,
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("Tq,n_ctx", [(9, 40), (72, 130), (13, 1)])
def test_context_form_matches_jax_einsum_on_valid_rows(Tq, n_ctx):
    """flash_mha_plain with Tq ≠ Tk against the JAX einsum. The forms differ
    only where a query row has no valid key at all (JAX: the uniform average
    of every key, K2: 0); the model never hits that on a valid frame (a
    frame's own key is valid), so lane 1 gets an all-masked mask here and is
    compared only for K2's zero."""
    B, H, dh = 3, 2, 64
    q, k, v, valid = _ctx_inputs(11, B, H, Tq, n_ctx, dh)
    valid[1] = False
    want = np.asarray(_jax_einsum_attention(*map(jnp.asarray, (q, k, v, valid)), 0.125))
    got = to_np(fm.flash_mha(*map(to_t, (q, k, v, valid)), scale=0.125))
    assert got.shape == (B, H, Tq, dh)
    np.testing.assert_array_equal(got[1], 0.0)
    keep = [0, 2]
    np.testing.assert_allclose(got[keep], want[keep], atol=TOL, rtol=TOL)


def _contract_error_ctx(B, H, Tq, n_ctx, dh, rnd, passes, seed):
    q, k, v, valid = (to_t(x) for x in _ctx_inputs(seed, B, H, Tq, n_ctx, dh))
    err = 0.0
    for b0 in range(0, B, 8):
        lanes = (q[b0:b0 + 8], k[b0:b0 + 8], v[b0:b0 + 8], valid[b0:b0 + 8])
        got = _emulated_mha(*lanes, 0.125, rnd, passes)
        err = max(err, (got - fm.flash_mha_plain(*lanes, scale=0.125)).abs().max().item())
    return err


@pytest.mark.parametrize("Tq", [72, 202])
def test_split_contract_context_form_at_batched_shapes(Tq):
    """The bf16x3 products of the context form at the streaming batch's
    shapes (32 CFG lanes, H = 8, dh = 64; Tq = 72 or 202 new frames over
    Tk = Tq + 1012 keys: 500 prompt frames and a 512-frame ring) stay within
    CONTRACT_TOL of float32; one-pass bf16 does not."""
    err = _contract_error_ctx(32, 8, Tq, 1012, 64, _round_bf16, 3, seed=12)
    assert err <= CONTRACT_TOL, err
    assert _contract_error_ctx(8, 8, Tq, 1012, 64, _round_bf16, 1, seed=12) > CONTRACT_TOL


# --- the context form over segments read in place (flash_mha_context) ---
#
# Tq new frames over [prompt | ring | own]: the prompt [Bp, H, P, dh] (Bp =
# B2, or 2 for a voice captured at batch 1, shared by lanes [c×B, u×B]) and
# the ring [B2, H, W, dh] in the weights' dtype, the own keys in the
# activations'. Tolerances: TOL (2e-5) where both sides compute in float32
# on the same values; bf16 outputs BF16_TOL, one bf16 step of |out| < 2
# (the plain version rounds its float32 result to bf16 once).

BF16_TOL = 1.6e-2
PAIRS = {"f32_bf16": (torch.float32, torch.bfloat16), "f32_f32": (torch.float32, torch.float32),
         "bf16_bf16": (torch.bfloat16, torch.bfloat16)}
# ring fill per lane: empty, partial (a random klen per lane) or full
RING_FILLS = ("empty", "partial", "full")


def _segments(seed, B2, Bp, H, Tq, P, W, dh, fill="partial"):
    """float32 numpy q, own K/V, prompt K/V [Bp, ...], ring K/V [B2, ...]
    (None when W = 0) and the key mask [B2, P + W + Tq] of a cached or
    streaming call: the prompt with a masked left pad, each lane's ring
    filled to its klen, the own frames right-packed (lane 0 short). Every
    row has a valid key (the prompt's)."""
    rng = np.random.default_rng(seed)
    rnd = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, ko, vo = rnd(B2, H, Tq, dh), rnd(B2, H, Tq, dh), rnd(B2, H, Tq, dh)
    kp, vp = rnd(Bp, H, P, dh), rnd(Bp, H, P, dh)
    kr, vr = (rnd(B2, H, W, dh), rnd(B2, H, W, dh)) if W else (None, None)
    klen = {"empty": np.zeros(B2, int), "full": np.full(B2, W),
            "partial": rng.integers(0, W + 1, B2)}[fill]
    own = np.ones((B2, Tq), bool)
    own[0, : Tq // 3] = False
    pmask = np.ones((B2, P), bool)
    pmask[:, : P // 5] = False
    valid = np.concatenate([pmask, np.arange(W)[None, :] < klen[:, None], own], 1)
    return q, ko, vo, kp, vp, kr, vr, valid


def _torch_segments(arrays, pair):
    """numpy segments → torch, q and own K/V in the pair's activation
    dtype, prompt and ring in its context dtype."""
    q_dt, c_dt = PAIRS[pair]
    q, ko, vo, kp, vp, kr, vr, valid = arrays
    act = [to_t(x).to(q_dt) for x in (q, ko, vo)]
    ctx = [None if x is None else to_t(x).to(c_dt) for x in (kp, vp, kr, vr)]
    return (*act, *ctx, to_t(valid))


def _concat(args):
    """(q, k, v, valid) over the float32 concatenation [prompt | ring | own]
    of torch segments, the prompt repeated to the lanes."""
    q, ko, vo, kp, vp, kr, vr, valid = args
    rep = q.shape[0] // kp.shape[0]
    ks = [kp.float().repeat_interleave(rep, 0)] + ([kr.float()] if kr is not None else [])
    vs = [vp.float().repeat_interleave(rep, 0)] + ([vr.float()] if vr is not None else [])
    return q, torch.cat(ks + [ko.float()], 2), torch.cat(vs + [vo.float()], 2), valid


CTX_CASES = [  # (B2, Bp, Tq, P, W, ring fill)
    (8, 2, 9, 40, 24, "partial"),
    (8, 2, 72, 130, 64, "full"),
    (8, 2, 13, 70, 64, "empty"),
    (8, 8, 9, 40, 24, "partial"),
    (4, 4, 17, 65, 0, "empty"),     # W = 0: the cached path's prompt only
    (8, 2, 72, 130, 0, "empty"),
]


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("B2,Bp,Tq,P,W,fill", CTX_CASES)
def test_context_plain_matches_jax_einsum_and_concat(B2, Bp, Tq, P, W, fill, pair):
    """flash_mha_context_plain against the JAX package's context einsum
    (decoder.py:293-298) over JAX's concatenation of the same segments (the
    prompt rows repeated to the lanes, every part cast to the activations'
    float32 as JAX casts it), and against flash_mha_plain over the
    concatenation (bitwise: the same arithmetic). In float32 within TOL; a
    bf16 output within BF16_TOL."""
    H, dh = 2, 64
    args = _torch_segments(_segments(13, B2, Bp, H, Tq, P, W, dh, fill), pair)
    got = fm.flash_mha_context_plain(*args, scale=0.125)
    assert got.shape == (B2, H, Tq, dh) and got.dtype == PAIRS[pair][0]
    cat = _concat(args)
    torch.testing.assert_close(got, fm.flash_mha_plain(*cat, scale=0.125), atol=0, rtol=0)
    q, k, v, valid = (to_np(x.float()) for x in cat)
    want = np.asarray(_jax_einsum_attention(*map(jnp.asarray, (q, k, v, valid)), 0.125))
    tol = BF16_TOL if got.dtype == torch.bfloat16 else TOL
    np.testing.assert_allclose(to_np(got.float()), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("fill", RING_FILLS + ("none",))
def test_tf_block_segments_match_jax_tf_block(fill):
    """The port's _tf_block over segments (a batch-1 voice's prompt, Bp = 2,
    shared by B2 = 8 lanes; the ring empty, partial, full or absent) against
    JAX's _tf_block with pc / pvalid / ring (decoder.py:260-298) on the
    prompt repeated to the lanes, float32, on valid frames; TOL."""
    jcfg = JFlowCfg.tiny()
    p = jdec.init_estimator_params(jax.random.PRNGKey(4), jcfg)
    tf_j = p["mid"][0]["tf"][0]
    tf_t = convert_params(jax_tree_to_np(tf_j), "cpu")
    B2, T, P, W = 8, 7, 11, 0 if fill == "none" else 5
    H, dh, C = jcfg.dec_num_heads, jcfg.dec_attention_head_dim, jcfg.dec_channels[0]
    _, _, _, kp, vp, kr, vr, valid = _segments(
        21, B2, 2, H, T, P, W, dh, "empty" if fill == "none" else fill)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((B2, T, C)).astype(np.float32)
    own = valid[:, P + W:]
    got = tdec._tf_block(tf_t, FlowRefConfig.tiny(), to_t(x), to_t(own),
                         ctx=(to_t(kp), to_t(vp), None if kr is None else to_t(kr),
                              None if vr is None else to_t(vr), to_t(valid)))
    lanes = lambda a: np.repeat(a, B2 // 2, 0).transpose(0, 2, 1, 3)  # noqa: E731  [B2, P, H, dh]
    pc = {"k": jnp.asarray(lanes(kp)), "v": jnp.asarray(lanes(vp))}
    ring = None if kr is None else {"k": jnp.asarray(kr.transpose(0, 2, 1, 3)),
                                    "v": jnp.asarray(vr.transpose(0, 2, 1, 3)),
                                    "mask": jnp.asarray(valid[:, P:P + W])}
    want = jdec._tf_block(tf_j, jcfg, jnp.asarray(x), jnp.asarray(own), pc=pc,
                          pvalid=jnp.asarray(valid[:, :P]), ring=ring)
    np.testing.assert_allclose(to_np(got)[own], np.asarray(want)[own], atol=TOL, rtol=TOL)


def test_tf_block_context_runs_the_context_form(monkeypatch):
    """With a context, _tf_block calls flash_mha_context with the segments as
    they are (no concatenation) and never flash_mha."""
    jcfg = JFlowCfg.tiny()
    tf_t = convert_params(jax_tree_to_np(
        jdec.init_estimator_params(jax.random.PRNGKey(4), jcfg)["mid"][0]["tf"][0]), "cpu")
    H, dh, C = jcfg.dec_num_heads, jcfg.dec_attention_head_dim, jcfg.dec_channels[0]
    _, _, _, kp, vp, kr, vr, valid = _segments(23, 4, 2, H, 6, 9, 4, dh)
    seen = []

    def spy(q, k_own, v_own, k_prompt, v_prompt, k_ring, v_ring, valid, scale=None):
        seen.append((k_prompt, k_ring))
        return fm.flash_mha_context_plain(q, k_own, v_own, k_prompt, v_prompt, k_ring, v_ring,
                                          valid, scale)

    def refuse(*a, **kw):
        raise AssertionError("the context form went to flash_mha")

    monkeypatch.setattr(tdec, "flash_mha_context", spy)
    monkeypatch.setattr(tdec, "flash_mha", refuse)
    segs = tuple(map(to_t, (kp, vp, kr, vr, valid)))
    x = to_t(np.random.default_rng(1).standard_normal((4, 6, C)).astype(np.float32))
    tdec._tf_block(tf_t, FlowRefConfig.tiny(), x, segs[-1][:, 9 + 4:], ctx=segs)
    assert len(seen) == 1 and seen[0][0] is segs[0] and seen[0][1] is segs[2]


def _lane_slice(args, b0, n):
    """Lanes [b0, b0 + n) of torch segments, their prompt rows repeated to
    the n lanes (Bp = n)."""
    q, ko, vo, kp, vp, kr, vr, valid = args
    rep = q.shape[0] // kp.shape[0]
    lanes = lambda x: None if x is None else x[b0:b0 + n]  # noqa: E731
    prompt = lambda x: x.repeat_interleave(rep, 0)[b0:b0 + n]  # noqa: E731
    return (lanes(q), lanes(ko), lanes(vo), prompt(kp), prompt(vp), lanes(kr), lanes(vr),
            lanes(valid))


def _split_product(a, b, eq, split_b):
    """bf16x3 product with a split into hi/lo; b's lo part taken only where
    ``split_b`` (a float32 segment) — a bf16 segment's lo is exactly 0."""
    a_hi = _round_bf16(a)
    a_lo = _round_bf16(a - a_hi)
    b_hi = _round_bf16(b)
    out = torch.einsum(eq, a_hi, b_hi) + torch.einsum(eq, a_lo, b_hi)
    if split_b:
        out = out + torch.einsum(eq, a_hi, _round_bf16(b - b_hi))
    return out


def _emulated_context(q, ko, vo, kp, vp, kr, vr, valid, scale):
    """flash_mha_context_plain's arithmetic with the new kernel's products:
    two terms (Q_hi·K + Q_lo·K, P_hi·V + P_lo·V) on the bf16 prompt and ring
    tiles, three on the float32 own tiles."""
    rep = q.shape[0] // kp.shape[0]
    k_ctx = torch.cat([kp.float().repeat_interleave(rep, 0)] + ([kr.float()] if kr is not None else []), 2)
    v_ctx = torch.cat([vp.float().repeat_interleave(rep, 0)] + ([vr.float()] if vr is not None else []), 2)
    L = k_ctx.shape[2]
    s = torch.cat([_split_product(q, k_ctx, "bhid,bhjd->bhij", False),
                   _split_product(q, ko, "bhid,bhjd->bhij", True)], -1) * scale
    kmask = valid[:, None, None, :]
    s = s.masked_fill(~kmask, -1e9)
    p = torch.where(kmask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = (_split_product(p[..., :L], v_ctx, "bhij,bhjd->bhid", False)
           + _split_product(p[..., L:], vo, "bhij,bhjd->bhid", True))
    return out / p.sum(-1, keepdim=True).clamp_min(1e-30)


@pytest.mark.parametrize("Tq", [72, 202])
def test_split_contract_context_segments_at_streaming_shapes(Tq):
    """The new kernel's products at the streaming batch's shapes (32 CFG
    lanes, H = 8, dh = 64; Tq new frames over Tk = Tq + 1012 keys: a
    500-frame bf16 prompt shared by the lanes (Bp = 2), a 512-frame bf16
    ring filled at random, float32 own frames) stay within CONTRACT_TOL of
    flash_mha_context_plain, and equal the three-term emulation of the
    earlier design over the float32 concatenation (bf16-valued context keys:
    its third term adds exact zeros there) up to float32 summation order
    (1e-6)."""
    B2, H, P, W, dh = 32, 8, 500, 512, 64
    args = _torch_segments(_segments(14, B2, 2, H, Tq, P, W, dh), "f32_bf16")
    err = gap = 0.0
    for b0 in range(0, B2, 8):
        lanes = _lane_slice(args, b0, 8)
        got = _emulated_context(*lanes, 0.125)
        err = max(err, (got - fm.flash_mha_context_plain(*lanes, scale=0.125)).abs().max().item())
        earlier = _emulated_mha(*_concat(lanes), 0.125, _round_bf16)
        gap = max(gap, (got - earlier).abs().max().item())
    assert err <= CONTRACT_TOL, err
    assert gap <= 1e-6, gap


def test_context_wrapper_uses_plain_version_on_cpu_and_counts_no_launch():
    """Every dtype pair, with and without a ring: on the CPU the wrapper
    returns the plain version's result (bitwise) and counts no launch."""
    fm.reset_launches()
    for pair in PAIRS:
        for W in (0, 24):
            args = _torch_segments(_segments(15, 4, 2, 2, 9, 40, W, 64), pair)
            got = fm.flash_mha_context(*args, scale=0.125)
            torch.testing.assert_close(got, fm.flash_mha_context_plain(*args, scale=0.125),
                                       atol=0, rtol=0)
    assert fm.launches == {"float32": 0, "bfloat16": 0, "float32_ctx": 0, "bfloat16_ctx": 0}


def _refusals():
    """(what, arguments) the context wrapper must refuse, each one change
    away from a valid call."""
    ok = _torch_segments(_segments(16, 4, 2, 2, 9, 40, 24, 64), "f32_bf16")
    q, ko, vo, kp, vp, kr, vr, valid = ok

    def with_(**kw):
        names = ("q", "k_own", "v_own", "k_prompt", "v_prompt", "k_ring", "v_ring", "valid")
        d = dict(zip(names, ok))
        d.update(kw)
        return tuple(d[n] for n in names)

    return [
        ("dtype pair", with_(k_prompt=kp.half(), v_prompt=vp.half(), k_ring=kr.half(),
                             v_ring=vr.half())),
        ("dtype pair", with_(q=q.bfloat16(), k_own=ko.bfloat16(), v_own=vo.bfloat16(),
                             k_prompt=kp.float(), v_prompt=vp.float(), k_ring=kr.float(),
                             v_ring=vr.float())),
        ("must match q", with_(k_own=ko[:, :, :8].contiguous())),
        ("must match q", with_(v_own=vo.bfloat16())),
        ("does not fit q", with_(k_prompt=kp[:1].repeat(3, 1, 1, 1))),
        ("does not fit q", with_(k_prompt=kp[:, :1].contiguous())),
        ("does not fit k_prompt", with_(v_prompt=vp[:, :, :39].contiguous())),
        ("both be given", with_(v_ring=None)),
        ("does not fit q", with_(k_ring=kr[:2].contiguous())),
        ("does not fit k_prompt", with_(v_ring=vr.float())),
        ("valid must be", with_(valid=valid[:, 1:].contiguous())),
        ("valid must be", with_(valid=valid.to(torch.uint8))),
        ("contiguous", with_(k_prompt=kp.transpose(2, 3).contiguous().transpose(2, 3))),
        ("contiguous", with_(q=q.transpose(2, 3).contiguous().transpose(2, 3))),
        ("is on", with_(valid=valid.to("meta"))),
    ]


@pytest.mark.parametrize("case", range(len(_refusals())))
def test_context_wrapper_refuses(case):
    what, args = _refusals()[case]
    fm.reset_launches()
    with pytest.raises(ValueError, match=what):
        fm.flash_mha_context(*args, scale=0.125)
    assert fm.launches["float32_ctx"] == 0


def test_context_wrapper_rejects_other_devices():
    q = torch.zeros((2, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fm.flash_mha_context(q, q, q, q, q, None, None,
                             torch.ones((2, 8), dtype=torch.bool, device="meta"))
