"""K1 and K3 parity: the port's decode attention wrappers (on CPU tensors
they run the plain version) against the JAX package's Pallas kernels
``paired_decode_attention(..., interpret=True)`` and
``paired_decode_attention_pipelined(..., interpret=True)``.

Mirrors the cases of tests/test_pallas_v3.py and tests/test_int8_kv.py:
MHA and GQA, float and int8 caches, rows with start > 0, and garbage past
pos that must not leak in. The port's cache is [B, Hk, S, Dh]; the JAX
kernel reads the paired [B, Hk/2, S, 2·Dh] layout built from the same data.
The CUDA kernels themselves are compared with the plain version on the card,
by chip_smoke.py. Tolerance 2e-5 (float32, as tests/test_pallas_v3.py).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torch_port_helpers import to_np, to_t

from chatterbox_tpu.ops.pallas_attention_v3 import (
    pack_cache_paired,
    pack_scales_paired,
    paired_decode_attention,
    paired_decode_attention_pipelined,
)
from chatterbox_tpu_torch.ops import decode_attention as da
from chatterbox_tpu_torch.ops import decode_attention_pipelined as dap

TOL = 2e-5


def _inputs(seed, heads, B=3, S=512, Dh=64):
    H, Hk = heads
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hk, Dh)).astype(np.float32)  # seq-major
    vc = rng.standard_normal((B, S, Hk, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, Hk, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, Hk, Dh)).astype(np.float32)
    start = np.array([0, 5, 17], np.int32)[:B]
    pos = np.array([40, 200, 400], np.int32)[:B]
    return q, kc, vc, kn, vn, start, pos


def _quantize(x):
    scale = np.maximum(np.abs(x).max(axis=-1), 1e-8) / 127.0
    q = np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _port(q, kc, vc, kn, vn, start, pos, ks=None, vs=None, s_view=None):
    """Port call: seq-major [B, S, Hk, …] → the port's [B, Hk, S, …]."""
    head_major = lambda a: to_t(np.ascontiguousarray(np.moveaxis(a, 1, 2)))  # noqa: E731
    return da.decode_attention(
        to_t(q), head_major(kc), head_major(vc), to_t(kn), to_t(vn), to_t(start), to_t(pos),
        None if ks is None else head_major(ks), None if vs is None else head_major(vs),
        s_view=s_view,
    )


@pytest.mark.parametrize("heads", [(4, 4), (8, 2)])  # (H, Hk): MHA and GQA
@pytest.mark.parametrize("s_view", [None, 512])
def test_float_cache_matches_pallas(heads, s_view):
    q, kc, vc, kn, vn, start, pos = _inputs(0, heads)
    want = paired_decode_attention(
        jnp.asarray(q), pack_cache_paired(jnp.asarray(kc)), pack_cache_paired(jnp.asarray(vc)),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(start), jnp.asarray(pos),
        s_view=s_view, interpret=True,
    )
    got = _port(q, kc, vc, kn, vn, start, pos, s_view=s_view)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("heads", [(4, 4), (8, 2)])
def test_int8_cache_matches_pallas(heads):
    """Scale-factored int8: the per-token scales multiply scores and probs;
    the current token stays unquantised."""
    q, kc, vc, kn, vn, start, pos = _inputs(11, heads)
    kq, ks = _quantize(kc)
    vq, vs = _quantize(vc)
    want = paired_decode_attention(
        jnp.asarray(q), pack_cache_paired(jnp.asarray(kq)), pack_cache_paired(jnp.asarray(vq)),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(start), jnp.asarray(pos),
        k_scale=pack_scales_paired(jnp.asarray(ks)), v_scale=pack_scales_paired(jnp.asarray(vs)),
        interpret=True,
    )
    got = _port(q, kq, vq, kn, vn, start, pos, ks, vs)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_garbage_past_pos_and_before_start_is_ignored(quantized):
    """Entries outside [start, pos) must not affect the result."""
    q, kc, vc, kn, vn, start, pos = _inputs(1, (4, 4), B=2)
    start, pos = np.array([3, 0], np.int32), np.array([100, 256], np.int32)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[:, 256:] = 1e4
    vc2[:, 256:] = -1e4
    kc2[0, :3] = -1e4
    vc2[0, :3] = 1e4
    kc2[0, 100:] = 1e4
    if quantized:
        a = _port(q, *_quantize(kc)[:1], *_quantize(vc)[:1], kn, vn, start, pos,
                  _quantize(kc)[1], _quantize(vc)[1])
        b = _port(q, *_quantize(kc2)[:1], *_quantize(vc2)[:1], kn, vn, start, pos,
                  _quantize(kc2)[1], _quantize(vc2)[1])
        # rows of the garbage region carry their own scales: the valid rows'
        # int8 values and scales are identical, so the results are too
        np.testing.assert_allclose(to_np(a), to_np(b), atol=0)
    else:
        a = _port(q, kc, vc, kn, vn, start, pos)
        b = _port(q, kc2, vc2, kn, vn, start, pos)
        np.testing.assert_allclose(to_np(a), to_np(b), atol=0)


def test_empty_window_is_the_self_term():
    """With start == pos the only key is the current token: out == v_new."""
    q, kc, vc, kn, vn, _, _ = _inputs(2, (8, 2), B=2)
    pos = np.array([7, 0], np.int32)
    got = _port(q, kc, vc, kn, vn, pos, pos)
    want = np.repeat(vn, 4, axis=1)
    np.testing.assert_allclose(to_np(got), want, atol=1e-6)


def test_wrapper_uses_plain_version_on_cpu_and_counts_no_launch():
    q, kc, vc, kn, vn, start, pos = _inputs(3, (4, 4), B=2)
    da.reset_launches()
    got = _port(q, kc, vc, kn, vn, start, pos)
    head_major = lambda a: to_t(np.ascontiguousarray(np.moveaxis(a, 1, 2)))  # noqa: E731
    want = da.decode_attention_plain(to_t(q), head_major(kc), head_major(vc), to_t(kn),
                                     to_t(vn), to_t(start), to_t(pos))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert da.launches == {"native": 0, "int8": 0}


def test_wrapper_rejects_other_devices():
    q = torch.zeros((1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_attention(q, q, q, q, q, q, q)


@pytest.mark.parametrize("heads", [(4, 4), (8, 2)])  # (H, Hk): MHA and GQA
def test_pipelined_matches_pallas(heads):
    """K3: the cases of tests/test_pallas_v3.py::test_pipelined_matches_reference
    (a row with start > 0 and one 2 rows deep) against the pipelined Pallas
    kernel with a 3-deep copy ring."""
    H, Hk = heads
    B, S, Dh = 4, 512, 64
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hk, Dh)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hk, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, Hk, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, Hk, Dh)).astype(np.float32)
    start = np.array([0, 5, 17, 2], np.int32)
    pos = np.array([40, 200, 255, 9], np.int32)
    want = paired_decode_attention_pipelined(
        jnp.asarray(q), pack_cache_paired(jnp.asarray(kc)), pack_cache_paired(jnp.asarray(vc)),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(start), jnp.asarray(pos),
        s_view=256, n_buf=3, interpret=True,
    )
    head_major = lambda a: to_t(np.ascontiguousarray(np.moveaxis(a, 1, 2)))  # noqa: E731
    got = dap.decode_attention_pipelined(to_t(q), head_major(kc), head_major(vc), to_t(kn),
                                         to_t(vn), to_t(start), to_t(pos), s_view=256)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=TOL, rtol=TOL)


def test_pipelined_wrapper_uses_plain_version_on_cpu_and_counts_no_launch():
    q, kc, vc, kn, vn, start, pos = _inputs(4, (8, 2), B=3)
    head_major = lambda a: to_t(np.ascontiguousarray(np.moveaxis(a, 1, 2)))  # noqa: E731
    args = (to_t(q), head_major(kc), head_major(vc), to_t(kn), to_t(vn), to_t(start), to_t(pos))
    dap.reset_launches()
    got = dap.decode_attention_pipelined(*args)
    torch.testing.assert_close(got, da.decode_attention_plain(*args), atol=0, rtol=0)
    assert dap.launches == {"native": 0}


def test_pipelined_wrapper_rejects_other_devices():
    q = torch.zeros((1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dap.decode_attention_pipelined(q, q, q, q, q, q, q)
