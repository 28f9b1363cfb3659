"""K2 parity: the port's flash MHA (plain version, which its wrapper runs
for CPU tensors) against the JAX package's Pallas ``flash_mha(...,
interpret=True)``, including a ragged T and an all-masked row; its context
form (Tq queries over Tk prepended keys) against the JAX package's einsum
branch of ``_tf_block`` on valid rows; the port's estimator transformer
block against JAX ``_tf_block`` on its flash branch; and the precision
contract of the CUDA kernel's tensor-core products, emulated in plain torch,
for both forms. The CUDA kernel itself is compared with the plain version on
the card, by chip_smoke.py. Tolerance 2e-5 (float32, as
tests/test_pallas_mha.py).
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
