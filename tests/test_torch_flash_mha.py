"""K2 parity: the port's flash MHA (plain version, which its wrapper runs
for CPU tensors) against the JAX package's Pallas ``flash_mha(...,
interpret=True)``, including a ragged T and an all-masked row; and the
port's estimator transformer block against JAX ``_tf_block`` on its flash
branch. The CUDA kernel itself is compared with this plain version on the
card, by chip_smoke.py. Tolerance 2e-5 (float32, as tests/test_pallas_mha.py).
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
    q, k, v = _qkv(4, 1, 2, 40, 32)
    valid = np.ones((1, 40), bool)
    fm.reset_launches()
    got = fm.flash_mha(*map(to_t, (q, k, v, valid)))
    want = fm.flash_mha_plain(*map(to_t, (q, k, v, valid)))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert fm.launches == {"float32": 0, "bfloat16": 0}


def test_wrapper_rejects_other_devices():
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fm.flash_mha(q, q, q, torch.ones((1, 4), dtype=torch.bool, device="meta"))
