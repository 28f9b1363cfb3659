"""K1 and K3 parity: the port's decode attention wrappers (on CPU tensors
they run the plain version) against the JAX package's Pallas kernels
``paired_decode_attention(..., interpret=True)`` and
``paired_decode_attention_pipelined(..., interpret=True)``.

Mirrors the cases of tests/test_pallas_v3.py and tests/test_int8_kv.py:
MHA and GQA, float and int8 caches, rows with start > 0, and garbage past
pos that must not leak in. The port's cache is [B, Hk, S, Dh]; the JAX
kernel reads the paired [B, Hk/2, S, 2·Dh] layout built from the same data.
An emulation of K1's CUDA decomposition (split-S partials and their combine)
is held against both. The CUDA kernels themselves are compared with the plain
version on the card, by chip_smoke.py. Tolerance 2e-5 (float32, as
tests/test_pallas_v3.py).
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


# --- K1's split-S decomposition (csrc/decode_attention.cu), emulated ---------

SLICE_ROWS = 256   # cache rows per block of the CUDA kernel (kSlice)
WARPS, LOADS = 4, 2  # warps per block; row loads per warp per tile


def _partial(qg, k, v, ks, vs):
    """(max, sum, acc) over the given rows, or the empty partial (sum 0)."""
    Hk, G, Dh = qg.shape
    if k.shape[1] == 0:
        return (torch.full((Hk, G), -1e9), torch.zeros(Hk, G), torch.zeros(Hk, G, Dh))
    s = torch.einsum("hgd,hnd->hgn", qg, k)
    if ks is not None:
        s = s * ks[:, None, :]
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    if vs is not None:
        p = p * vs[:, None, :]
    return m, l, torch.einsum("hgn,hnd->hgd", p, v)


def _fold(parts):
    """Fold partials, weighting each by exp(m - M) and skipping those with
    sum 0 (their max is the mask value, never a weight of 1)."""
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    live = l > 0
    M = torch.where(live, m, torch.tensor(-torch.inf)).amax(0)
    w = torch.where(live, torch.exp(m - M), 0.0)
    return M, (w * l).sum(0), (w[..., None] * acc).sum(0)


def _split_s_emulation(q, k, v, kn, vn, start, pos, ks=None, vs=None, rows_per_load=8):
    """Plain-torch emulation of the kernel's partials and combine: each block
    (slice of SLICE_ROWS rows, lane) splits its rows among its warps as the
    kernel does (tiles of WARPS x LOADS loads of ``rows_per_load`` rows),
    folds the warps' partials into the slice's, and the combine folds the
    slices' partials with the unquantised self-term."""
    B, H, Dh = q.shape
    Hk, S = k.shape[1], k.shape[2]
    G = H // Hk
    scale = 1.0 / Dh ** 0.5
    tile = WARPS * LOADS * rows_per_load
    out = torch.empty(B, Hk, G, Dh)
    for b in range(B):
        qg = q[b].reshape(Hk, G, Dh) * scale
        slices = []
        for s0 in range(0, S, SLICE_ROWS):
            lo, hi = max(int(start[b]), s0), min(int(pos[b]), s0 + SLICE_ROWS)
            warps = []
            for w in range(WARPS):
                rows = [r for t in range(0, SLICE_ROWS, tile) for st in range(LOADS)
                        for sub in range(rows_per_load)
                        if lo <= (r := s0 + t + (w * LOADS + st) * rows_per_load + sub) < hi]
                idx = torch.tensor(rows, dtype=torch.long)
                warps.append(_partial(qg, k[b][:, idx], v[b][:, idx],
                                      None if ks is None else ks[b][:, idx],
                                      None if vs is None else vs[b][:, idx]))
            slices.append(_fold(warps))
        m, l, acc = _fold(slices)
        s_self = torch.einsum("hgd,hd->hg", qg, kn[b])
        M = torch.maximum(m, s_self)
        w, ps = torch.where(l > 0, torch.exp(m - M), 0.0), torch.exp(s_self - M)
        out[b] = ((w[..., None] * acc + ps[..., None] * vn[b][:, None, :])
                  / (w * l + ps)[..., None])
    return out.reshape(B, H, Dh)


_SPLIT_CASES = {   # (starts, ends) per lane; S = 768 gives three slices
    "slice_edges": ([0, 255, 256, 257, 1, 511, 0, 255], [256, 513, 512, 511, 257, 512, 255, 768]),
    "empty_slices": ([600, 0, 260, 512], [610, 5, 500, 768]),
    "empty_window": ([7, 0, 256], [7, 0, 256]),
}


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("heads", [(4, 4), (8, 4)])  # (H, Hk): G = 1 and G = 2
def test_split_s_decomposition_matches_plain_and_pallas(case, quantized, heads):
    """The slices' partials and their combine give what the plain version and
    the Pallas kernel give, with garbage outside every window."""
    starts, ends = _SPLIT_CASES[case]
    B = len(starts)
    q, kc, vc, kn, vn, _, _ = _inputs(21, heads, B=B, S=768)
    start, pos = np.array(starts, np.int32), np.array(ends, np.int32)
    for b in range(B):   # garbage before start and past pos
        kc[b, :starts[b]], vc[b, :starts[b]] = 1e4, -1e4
        kc[b, ends[b]:], vc[b, ends[b]:] = -1e4, 1e4
    jargs = [jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(start), jnp.asarray(pos)]
    head_major = lambda a: to_t(np.ascontiguousarray(np.moveaxis(a, 1, 2)))  # noqa: E731
    if quantized:
        (kq, ks), (vq, vs) = _quantize(kc), _quantize(vc)
        want_j = paired_decode_attention(
            jnp.asarray(q), pack_cache_paired(jnp.asarray(kq)), pack_cache_paired(jnp.asarray(vq)),
            *jargs, k_scale=pack_scales_paired(jnp.asarray(ks)),
            v_scale=pack_scales_paired(jnp.asarray(vs)), interpret=True)
        args = (to_t(q), head_major(kq).float(), head_major(vq).float(), to_t(kn), to_t(vn),
                to_t(start), to_t(pos), head_major(ks), head_major(vs))
        rows_per_load = 8    # int8 body, Dh = 64: 16 values per 16-byte load
    else:
        want_j = paired_decode_attention(
            jnp.asarray(q), pack_cache_paired(jnp.asarray(kc)), pack_cache_paired(jnp.asarray(vc)),
            *jargs, interpret=True)
        args = (to_t(q), head_major(kc), head_major(vc), to_t(kn), to_t(vn),
                to_t(start), to_t(pos))
        rows_per_load = 2    # float32 body, Dh = 64: 4 values per load
    got = _split_s_emulation(*args, rows_per_load=rows_per_load)
    plain_args = args if not quantized else (args[0], args[1].to(torch.int8),
                                             args[2].to(torch.int8), *args[3:])
    np.testing.assert_allclose(to_np(got), to_np(da.decode_attention_plain(*plain_args)),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(to_np(got), np.asarray(want_j), atol=TOL, rtol=TOL)
    if case == "empty_window":
        G = heads[0] // heads[1]
        np.testing.assert_allclose(to_np(got), np.repeat(vn, G, axis=1), atol=1e-6)


# --- K3's split-S decomposition fed through a copy ring -----------------------
# (csrc/decode_attention_pipelined.cu), emulated

K3_SLICE_ROWS = 512   # cache rows per block (kSlice)
K3_TILE_BYTES = 8192  # bytes of K (and of V) per ring stage (kTileBytes)
K3_STAGES = 2         # ring stages (kStages)
K3_WARPS, K3_STEPS = 4, 2   # warps per block; warp loads per softmax update


def _k3_geometry(elem_bytes, Dh):
    """(tile rows, rows per warp load) of the kernel's ring for a cache of
    ``elem_bytes``-byte values: a warp load is 32 lanes x 16 bytes."""
    row_bytes = Dh * elem_bytes
    return K3_TILE_BYTES // row_bytes, 512 // row_bytes


def _k3_emulation(q, k, v, kn, vn, start, pos, elem_bytes):
    """Plain-torch emulation of the kernel: each block (slice, lane) copies
    its part [lo, hi) of the window from lo on, a tile at a time, into a ring
    of stages that start as NaN and keep an older tile's rows past the new
    tile's end; each warp reads only the rows below the tile's row count
    (zeros elsewhere, as the kernel's guarded reads), updates its online
    softmax once per K3_STEPS warp loads, the warps' partials fold into the
    slice's, and the combine folds the slices with the self-term."""
    B, H, Dh = q.shape
    Hk, S = k.shape[1], k.shape[2]
    G = H // Hk
    scale = 1.0 / Dh ** 0.5
    tile, rpl = _k3_geometry(elem_bytes, Dh)
    loads = tile // rpl // K3_WARPS
    out = torch.empty(B, Hk, G, Dh)
    for b in range(B):
        qg = q[b].reshape(Hk, G, Dh) * scale
        slices = []
        for s0 in range(0, S, K3_SLICE_ROWS):
            lo = max(int(start[b]), 0, s0)
            hi = min(int(pos[b]), S, s0 + K3_SLICE_ROWS)
            state = [[torch.full((Hk, G), -1e9), torch.zeros(Hk, G), torch.zeros(Hk, G, Dh)]
                     for _ in range(K3_WARPS)]
            ring_k = torch.full((K3_STAGES, Hk, tile, Dh), float("nan"))
            ring_v = torch.full((K3_STAGES, Hk, tile, Dh), float("nan"))
            for t in range(max(0, -(-(hi - lo) // tile))):
                row0 = lo + t * tile
                n = min(tile, hi - row0)
                st = t % K3_STAGES
                ring_k[st, :, :n] = k[b][:, row0:row0 + n]
                ring_v[st, :, :n] = v[b][:, row0:row0 + n]
                for w, ws in enumerate(state):
                    for i in range(0, loads, K3_STEPS):
                        rows = torch.tensor([((i + j) * K3_WARPS + w) * rpl + sub
                                             for j in range(K3_STEPS) for sub in range(rpl)])
                        if int(rows[0]) >= n:
                            break
                        live = rows < n
                        kx = torch.where(live[None, :, None], ring_k[st][:, rows], 0.0)
                        vx = torch.where(live[None, :, None], ring_v[st][:, rows], 0.0)
                        s = torch.where(live, torch.einsum("hgd,hnd->hgn", qg, kx), -1e9)
                        m_new = torch.maximum(ws[0], s.amax(-1))
                        alpha = torch.exp(ws[0] - m_new)
                        p = torch.where(live, torch.exp(s - m_new[..., None]), 0.0)
                        ws[0] = m_new
                        ws[1] = ws[1] * alpha + p.sum(-1)
                        ws[2] = ws[2] * alpha[..., None] + torch.einsum("hgn,hnd->hgd", p, vx)
            slices.append(_fold([tuple(ws) for ws in state]))
        m, l, acc = _fold(slices) if slices else (torch.full((Hk, G), -1e9),
                                                  torch.zeros(Hk, G), torch.zeros(Hk, G, Dh))
        s_self = torch.einsum("hgd,hd->hg", qg, kn[b])
        M = torch.where(l > 0, torch.maximum(m, s_self), s_self)
        w, ps = torch.where(l > 0, torch.exp(m - M), 0.0), torch.exp(s_self - M)
        out[b] = ((w[..., None] * acc + ps[..., None] * vn[b][:, None, :])
                  / (w * l + ps)[..., None])
    return out.reshape(B, H, Dh)


def _k3_cases():
    """(starts, ends) per lane over three slices of K3_SLICE_ROWS rows. Tile
    rows: 32 (f32 geometry) and 64 (bf16 geometry) at Dh = 64."""
    L = K3_SLICE_ROWS
    return {
        "slice_length": [(0, L - 1), (0, L), (0, L + 1), (L - 1, 2 * L), (L, 2 * L + 1),
                         (L + 1, 2 * L - 1)],
        "twice_slice_length": [(0, 2 * L - 1), (0, 2 * L), (0, 2 * L + 1), (1, 2 * L + 1),
                               (L - 1, 3 * L)],
        "tile_edges": [(0, 31), (0, 32), (0, 33), (5, 5 + 63), (5, 5 + 64), (5, 5 + 65),
                       (9, 9 + 3 * 64 + 1), (L - 40, L + 90)],
        "shorter_than_a_tile": [(3, 30), (L - 2, L + 3), (100, 101), (2 * L + 7, 2 * L + 20)],
        "empty_window": [(7, 7), (0, 0), (L, L), (2 * L + 1, 2 * L + 1)],
    }


_K3_CASES = _k3_cases()


@pytest.fixture(scope="module")
def k3_pallas_reference():
    """JAX's pipelined Pallas kernel (interpret mode) per (heads, case), run
    once for both geometries."""
    cache = {}

    def get(heads, case, inputs):
        if (heads, case) not in cache:
            q, kc, vc, kn, vn, start, pos = inputs
            cache[heads, case] = np.asarray(paired_decode_attention_pipelined(
                jnp.asarray(q), pack_cache_paired(jnp.asarray(kc)),
                pack_cache_paired(jnp.asarray(vc)), jnp.asarray(kn), jnp.asarray(vn),
                jnp.asarray(start), jnp.asarray(pos), n_buf=3, interpret=True))
        return cache[heads, case]

    return get


@pytest.mark.parametrize("elem_bytes", [4, 2])   # the kernel's f32 and bf16 geometries
@pytest.mark.parametrize("case", sorted(_K3_CASES))
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)])  # (H, Hk): MHA and GQA (G = 4)
def test_k3_decomposition_matches_plain_and_pallas(heads, case, elem_bytes,
                                                   k3_pallas_reference):
    """K3's slices, ring tiles, per-warp partials and combine give what the
    plain version and the pipelined Pallas kernel give, with garbage before
    every start and past every pos."""
    starts, ends = map(list, zip(*_K3_CASES[case]))
    B = len(starts)
    q, kc, vc, kn, vn, _, _ = _inputs(31, heads, B=B, S=3 * K3_SLICE_ROWS)
    start, pos = np.array(starts, np.int32), np.array(ends, np.int32)
    for b in range(B):
        kc[b, :starts[b]], vc[b, :starts[b]] = 1e4, -1e4
        kc[b, ends[b]:], vc[b, ends[b]:] = -1e4, 1e4
    head_major = lambda a: to_t(np.ascontiguousarray(np.moveaxis(a, 1, 2)))  # noqa: E731
    args = (to_t(q), head_major(kc), head_major(vc), to_t(kn), to_t(vn), to_t(start), to_t(pos))
    got = _k3_emulation(*args, elem_bytes=elem_bytes)
    np.testing.assert_allclose(to_np(got), to_np(dap.decode_attention_pipelined(*args)),
                               atol=TOL, rtol=TOL)
    want = k3_pallas_reference(heads, case, (q, kc, vc, kn, vn, start, pos))
    np.testing.assert_allclose(to_np(got), want, atol=TOL, rtol=TOL)
    if case == "empty_window":
        np.testing.assert_allclose(to_np(got), np.repeat(vn, heads[0] // heads[1], axis=1),
                                   atol=1e-6)
