"""The CFM estimator (causal-UNet ConditionalDecoder, matcha layout) and
its solvers (a frozen copy of the port's ``models/s3gen_ref/decoder.py``):
the estimator, the prompt prefill that captures a voice's frozen context at
every Euler step, and the streaming solve of a slice's new frames against
the prompt and the request's earlier frames. Attention is K2's plain form
(``ops/flash_mha.py``): float32 softmax over the valid keys.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.conv import conv1d
from ...ops.flash_mha import flash_mha, flash_mha_context
from ...ops.nn import layer_norm, linear
from ...parallel.tp import row_parallel, row_parallel_conv
from .config import FlowRefConfig

# fixed noise-buffer length (frames): the CFM initial noise at frame t is the
# same whatever the chunk length, so full-overlap re-synthesis of accumulated
# tokens reproduces earlier frames (seam stability)
_NOISE_FRAMES = 2048
# GroupNorm groups of every resnet conv block and the final block
GN_GROUPS = 8


def init_estimator_params(init, cfg: FlowRefConfig) -> Dict:
    """JAX-layout tree (convert with ``convert.convert_params``)."""
    ch = cfg.dec_channels[0]
    tdim = ch * 4
    inner = cfg.dec_num_heads * cfg.dec_attention_head_dim
    mk = lambda *shape: init.dense(shape)  # noqa: E731

    def mk_resnet(cin: int):
        return {
            "mlp": {"w": mk(tdim, ch), "b": mk(ch)},
            "block1": {"conv": {"w": mk(3, cin, ch), "b": mk(ch)}, "gn": {"w": mk(ch), "b": mk(ch)}},
            "block2": {"conv": {"w": mk(3, ch, ch), "b": mk(ch)}, "gn": {"w": mk(ch), "b": mk(ch)}},
            "res": {"w": mk(1, cin, ch), "b": mk(ch)},
        }

    def mk_tf():
        return {
            "norm1": {"w": mk(ch), "b": mk(ch)},
            "to_q": {"w": mk(ch, inner)},
            "to_k": {"w": mk(ch, inner)},
            "to_v": {"w": mk(ch, inner)},
            "to_out": {"w": mk(inner, ch), "b": mk(ch)},
            "norm3": {"w": mk(ch), "b": mk(ch)},
            "ff1": {"w": mk(ch, 4 * ch), "b": mk(4 * ch)},
            "ff2": {"w": mk(4 * ch, ch), "b": mk(ch)},
        }

    def mk_level(cin: int):
        return {
            "resnet": mk_resnet(cin),
            "tf": [mk_tf() for _ in range(cfg.dec_n_blocks)],
            "conv": {"w": mk(3, ch, ch), "b": mk(ch)},
        }

    return {
        "time_mlp": {
            "lin1": {"w": mk(cfg.dec_time_dim, tdim), "b": mk(tdim)},
            "lin2": {"w": mk(tdim, tdim), "b": mk(tdim)},
        },
        "down": mk_level(cfg.dec_in_channels),
        "mid": [
            {"resnet": mk_resnet(ch), "tf": [mk_tf() for _ in range(cfg.dec_n_blocks)]}
            for _ in range(cfg.dec_num_mid_blocks)
        ],
        "up": mk_level(2 * ch),
        "final": {"conv": {"w": mk(3, ch, ch), "b": mk(ch)}, "gn": {"w": mk(ch), "b": mk(ch)}},
        "proj": {"w": mk(1, ch, cfg.output_size), "b": mk(cfg.output_size)},
    }


def _group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int = GN_GROUPS,
                eps: float = 1e-5, valid: torch.Tensor | None = None,
                extra: Dict | None = None, cap: bool = False):
    """torch GroupNorm over [B, T, C], statistics over the valid frames only.

    Prompt-cache and streaming support, as in the JAX package: ``cap`` also
    returns this region's sufficient statistics ``{"s": [B, 2, G] (Σx, Σx²),
    "n": [B] frame count}``; ``extra`` (the same form) merges frozen-context
    statistics into this call's own. The capture holds the OWN region only:
    streaming accumulates it into a running total, so a merged capture would
    count the frozen context twice."""
    B, T, C = x.shape
    g = x.float().reshape(B, T, groups, C // groups)
    if cap or extra is not None:
        vm = valid[:, :, None, None].float()
        s1 = (g * vm).sum(dim=(1, 3))                      # [B, G]
        s2 = (g.square() * vm).sum(dim=(1, 3))
        n = valid.float().sum(1)                           # [B]
        own = {"s": torch.stack([s1, s2], 1), "n": n}
        if extra is not None:
            s1 = s1 + extra["s"][:, 0]
            s2 = s2 + extra["s"][:, 1]
            n = n + extra["n"]
        denom = (n[:, None] * (C // groups)).clamp_min(1.0)
        mean = s1 / denom
        var = (s2 / denom - mean.square()).clamp_min(0.0)
        gn = (g - mean[:, None, :, None]) * torch.rsqrt(var[:, None, :, None] + eps)
        out = gn.reshape(B, T, C).to(x.dtype) * w + b
        return (out, own) if cap else out
    if valid is None:
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    else:
        vm = valid[:, :, None, None].float()
        denom = vm.sum(dim=1, keepdim=True).clamp_min(1.0) * (C // groups)
        mean = (g * vm).sum(dim=(1, 3), keepdim=True) / denom
        var = ((g - mean).square() * vm).sum(dim=(1, 3), keepdim=True) / denom
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(B, T, C).to(x.dtype) * w + b


def _gn_extra(a: Dict | None, b: Dict | None) -> Dict | None:
    """Merge two frozen-context GroupNorm statistic dicts (the statistics
    are additive)."""
    if a is None:
        return b
    if b is None:
        return a
    return {k: a[k] + b[k] for k in a}


def _conv_h(x: torch.Tensor, p: Dict, pc: torch.Tensor | None = None, cap: bool = False,
            pos: torch.Tensor | None = None, tp_group=None):
    """SAME_TORCH conv1d with an optional frozen left context (halo).

    ``pc`` ([B, (K−1)//2, C]): frozen frames that replace the zero left pad,
    so the region's first frames convolve over the real left context; the
    right edge keeps its zero pad. ``pos`` ([B], right-packed streaming
    blocks, k = 3 only): each row's first valid frame; the halo goes right
    before it instead of before the block. ``cap`` also returns this
    region's own last (K−1)//2 frames in the weights' dtype. ``tp_group``:
    the weight holds a shard of the input channels, and the products are
    summed over the group."""
    w, b = p["w"], p["b"]
    hw = (w.shape[-1] - 1) // 2
    B, T, C = x.shape
    if pc is not None and hw and pos is not None:
        assert hw == 1, "pos-injected halo supports k=3 convs only"
        ext = F.pad(x, (0, 0, hw, hw))                     # [B, T+2, C]
        jj = torch.arange(T + 2 * hw, device=x.device)[None, :, None]
        # ext row `pos` is original row pos-1: the pad row right before the
        # first valid frame (or the prepended zero when pos == 0)
        ext = torch.where(jj == pos[:, None, None], pc.to(x.dtype), ext)
        out = row_parallel_conv(ext, w, b, tp_group, "VALID")
    elif pc is not None and hw:
        ext = torch.cat([pc.to(x.dtype), x, x.new_zeros((B, hw, C))], dim=1)
        out = row_parallel_conv(ext, w, b, tp_group, "VALID")
    else:
        out = row_parallel_conv(x, w, b, tp_group, "SAME_TORCH")
    if cap:
        # stored in the weights' dtype: the frozen context is read every
        # slice, and bf16 halves the per-voice cache
        return out, x[:, T - hw:].to(w.dtype)
    return out


def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x.float())).to(x.dtype)


def _time_embedding(p: Dict, cfg: FlowRefConfig, t: torch.Tensor) -> torch.Tensor:
    """t: [B] in [0, 1] → [B, 4*ch] (sinusoid scale 1000, matcha convention)."""
    half = cfg.dec_time_dim // 2
    freq = torch.exp(torch.as_tensor(np.arange(half) * -(np.log(10000.0) / (half - 1)),
                                     dtype=torch.float32, device=t.device))
    ang = 1000.0 * t.float()[:, None] * freq[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    h = F.silu(linear(emb, p["lin1"]["w"], p["lin1"]["b"]))
    return linear(h, p["lin2"]["w"], p["lin2"]["b"])


@functools.lru_cache(maxsize=None)
def _layout(cfg: FlowRefConfig, h2: int | None = None):
    """Where each context node of the estimator sits in the port's flat
    layout, in the order an evaluation visits them: the k = 3 conv halos
    (``(path, channels)``; packed side by side along the last axis), the
    GroupNorms and the transformer blocks. A path names the node in the JAX
    package's capture tree. ``h2``: the channels of this rank's ``block2``
    inputs (the resnets' shard; default all of them)."""
    ch = cfg.dec_channels[0]
    h2 = ch if h2 is None else h2
    halos, gns, tfs = [], [], []

    def level(name, cin, conv):
        halos.extend([((*name, "resnet", "h1"), cin), ((*name, "resnet", "h2"), h2)])
        gns.extend([(*name, "resnet", "g1"), (*name, "resnet", "g2")])
        tfs.extend((*name, "tf", i) for i in range(cfg.dec_n_blocks))
        if conv:
            halos.append(((*name, "conv"), ch))

    level(("down",), cfg.dec_in_channels, True)
    for j in range(cfg.dec_num_mid_blocks):
        level(("mid", j), ch, False)
    level(("up",), 2 * ch, True)
    halos.append((("final", "conv"), ch))
    gns.append(("final", "gn"))
    offsets = np.cumsum([0] + [c for _, c in halos]).tolist()
    return halos, offsets, gns, tfs


class _Walk:
    """One estimator evaluation's frozen context and captures, in the flat
    layout (see ``_layout``). A context ("est") is a dict of

    * ``halo`` [B2, ΣC]: one frame per k = 3 conv, side by side;
    * ``gs`` [B2, NG, 2, G] and ``gn`` [B2, NG]: per GroupNorm, Σx, Σx² per
      group and the frame count;
    * ``k``, ``v`` [NB, Bx, H, L, dh]: per transformer block, head-major
      (the kernel's layout), Bx = B2 or 2 (a batch-1 voice context).

    The request's halos replace the prompt's and the GroupNorm statistics
    add. The keys and values reach the walk as ``kv`` = (prompt keys,
    prompt values, ring keys, ring values, key mask): one Euler step's
    prompt [NB, Bx, H, P, dh], a streaming request's ring [NB, B2, H, W, dh]
    (or None, None) and the mask [B2, P + W + T] over [prompt | ring | own];
    block i attends over their i-th entries in place. With no context,
    every node is the plain one (zero conv pad, own statistics,
    self-attention)."""

    def __init__(self, cfg: FlowRefConfig, pc: Dict | None, rc: Dict | None, kv,
                 cap_cv: bool, cap_kv: bool, h2: int | None = None, tp_group=None):
        self.offsets = _layout(cfg, h2)[1]
        self.tp_group = tp_group
        pest = pc["est"] if pc is not None else None
        rest = rc["est"] if rc is not None else None
        self.pos = rc.get("pos") if rc is not None else None
        src = rest if rest is not None else pest
        self.halo = src["halo"] if src is not None else None
        stats = lambda e: None if e is None else {"s": e["gs"], "n": e["gn"]}  # noqa: E731
        self.gn = _gn_extra(stats(pest), stats(rest))
        self.kv = kv
        self.cap_cv, self.cap_kv = cap_cv, cap_kv
        self.hi = self.gi = self.ti = 0
        self.out = {"halo": [], "gs": [], "gn": [], "k": [], "v": []}

    def conv(self, x: torch.Tensor, p: Dict, row_parallel: bool = False) -> torch.Tensor:
        """The next k = 3 conv, with its halo; captures the input's last
        frame. ``row_parallel``: the weight holds a shard of the input
        channels (summed over the walk's group)."""
        i = self.hi
        self.hi += 1
        pc = None
        if self.halo is not None:
            o0, o1 = self.offsets[i], self.offsets[i + 1]
            pc = self.halo[:, None, o0:o1]
        r = _conv_h(x, p, pc, self.cap_cv, pos=self.pos,
                    tp_group=self.tp_group if row_parallel else None)
        if not self.cap_cv:
            return r
        self.out["halo"].append(r[1][:, 0])
        return r[0]

    def group_norm(self, x: torch.Tensor, p: Dict, valid: torch.Tensor) -> torch.Tensor:
        """The next GroupNorm. ``x`` with fewer channels than ``p`` holds
        this rank's shard of them (a sharded resnet's ``block1``): it takes
        the matching groups, and slice of the affine."""
        i = self.gi
        self.gi += 1
        w, b, groups = p["w"], p["b"], GN_GROUPS
        C = x.shape[-1]
        if C < w.shape[0]:
            t = self.tp_group.rank()
            w, b, groups = w[t * C:(t + 1) * C], b[t * C:(t + 1) * C], GN_GROUPS * C // w.shape[0]
        extra = None if self.gn is None else {"s": self.gn["s"][:, i, :, :groups],
                                              "n": self.gn["n"][:, i]}
        r = _group_norm(x, w, b, groups, valid=valid, extra=extra, cap=self.cap_cv)
        if not self.cap_cv:
            return r
        self.out["gs"].append(F.pad(r[1]["s"], (0, GN_GROUPS - groups)))
        self.out["gn"].append(r[1]["n"])
        return r[0]

    def tf(self, p: Dict, cfg: FlowRefConfig, x: torch.Tensor, valid: torch.Tensor):
        i = self.ti
        self.ti += 1
        ctx = None
        if self.kv is not None:
            kp, vp, kr, vr, mask = self.kv
            ctx = (kp[i], vp[i], None if kr is None else kr[i], None if vr is None else vr[i], mask)
        r = _tf_block(p, cfg, x, valid, cap=self.cap_kv, ctx=ctx, tp_group=self.tp_group)
        if not self.cap_kv:
            return r
        self.out["k"].append(r[1]["k"])
        self.out["v"].append(r[1]["v"])
        return r[0]

    def captured(self) -> Dict:
        """The evaluation's captures in the flat layout."""
        o, rec = self.out, {}
        if self.cap_cv:
            rec.update(halo=torch.cat(o["halo"], dim=1), gs=torch.stack(o["gs"], 1),
                       gn=torch.stack(o["gn"], 1))
        if self.cap_kv:
            rec.update(k=torch.stack(o["k"]), v=torch.stack(o["v"]))
        return rec


def _resnet(p: Dict, x: torch.Tensor, mask: torch.Tensor, valid: torch.Tensor,
            temb: torch.Tensor, walk: _Walk) -> torch.Tensor:
    """``walk`` supplies the frozen context (halos, GroupNorm statistics) and
    takes the captures. A sharded resnet (``block2`` holds a shard of its
    input channels) runs ``block1``, its GroupNorm and the time-MLP on this
    rank's channels and sums ``block2`` over the walk's group."""
    xm = x * mask
    w2 = p["block2"]["conv"]["w"]
    h = _mish(walk.group_norm(walk.conv(xm, p["block1"]["conv"]), p["block1"]["gn"], valid))
    h = h + linear(_mish(temb), p["mlp"]["w"], p["mlp"]["b"])[:, None]
    h = _mish(walk.group_norm(walk.conv(h * mask, p["block2"]["conv"],
                                        row_parallel=w2.shape[1] < w2.shape[0]),
                              p["block2"]["gn"], valid))
    return h + conv1d(xm, p["res"]["w"], p["res"]["b"])


def _tf_block(p: Dict, cfg: FlowRefConfig, x: torch.Tensor, valid: torch.Tensor,
              cap: bool = False, ctx=None, tp_group=None):
    """DiT-style block without positional encoding; its attention is K2.

    ``ctx`` = (prompt keys, prompt values [Bp, H, P, dh], ring keys, ring
    values [B, H, W, dh] or None, key mask [B, P + W + T]): the frozen
    context (the voice prompt's, a streaming request's ring; Bp = B, or 2
    for a voice captured at batch 1), so this call's attention is K2's
    context form over [prompt | ring | own], each read where it lies (no
    positional encoding: frozen keys need no index bookkeeping). ``cap``
    also returns this call's K/V in the weights' dtype, head-major.
    ``tp_group``: a block whose to_q/k/v hold this rank's heads attends over
    them and sums ``to_out`` over the group; a feed-forward whose ``ff1``
    holds a shard of its units sums ``ff2``."""
    B, T, C = x.shape
    dh = cfg.dec_attention_head_dim
    H = p["to_q"]["w"].shape[0] // dh
    attn_group = tp_group if H < cfg.dec_num_heads else None
    ff_group = tp_group if p["ff1"]["w"].shape[0] < 4 * C else None
    h = layer_norm(x, p["norm1"]["w"], p["norm1"]["b"])
    heads = lambda w: linear(h, w).reshape(B, T, H, dh).transpose(1, 2)  # noqa: E731
    q, k, v = (heads(p[n]["w"]).contiguous() for n in ("to_q", "to_k", "to_v"))
    scale = float(1.0 / np.sqrt(dh))
    if ctx is not None:
        o = flash_mha_context(q, k, v, *ctx, scale=scale)
    else:
        o = flash_mha(q, k, v, valid.contiguous(), scale=scale)
    out = o.transpose(1, 2).reshape(B, T, H * dh)
    x = x + row_parallel(out.to(x.dtype), p["to_out"]["w"], p["to_out"]["b"], attn_group)
    h = layer_norm(x, p["norm3"]["w"], p["norm3"]["b"])
    h = row_parallel(F.gelu(linear(h, p["ff1"]["w"], p["ff1"]["b"]), approximate="tanh"),
                     p["ff2"]["w"], p["ff2"]["b"], ff_group)
    out = x + h
    if cap:
        wdt = p["to_k"]["w"].dtype
        return out, {"k": k.to(wdt), "v": v.to(wdt)}
    return out


def estimator_forward(
    params: Dict,
    cfg: FlowRefConfig,
    x: torch.Tensor,      # [B, T, M] current sample
    mu: torch.Tensor,     # [B, T, M] encoder output
    spk: torch.Tensor,    # [B, M'] projected speaker embedding
    cond: torch.Tensor,   # [B, T, M] prompt-mel conditioning track
    t: torch.Tensor,      # [B] flow time
    valid: torch.Tensor,  # [B, T] bool
    pc: Dict | None = None,
    cap: bool = False,
    rc: Dict | None = None,
    cap_mode: str | None = None,
    kv=None,
    tp_group=None,
):
    """One vector-field evaluation → [B, T, M].

    ``pc`` ({"est": one Euler step's prompt halos and GroupNorm
    statistics}): the frames convolve and normalise against the frozen voice
    prompt instead of carrying it in ``x``. ``rc`` ({"est": one step's
    request halos and GroupNorm running statistics, "pos": [B] first valid
    row of a right-packed block}): a streaming request's own frozen frames.
    ``kv`` (prompt keys, prompt values, ring keys, ring values, key mask):
    the frozen K/V the frames attend to, per transformer block, read in
    place. Context layout: see ``_Walk``.

    ``cap`` / ``cap_mode`` → (out, captured context): "full" (``cap``)
    captures everything (the prompt prefill), "light" the halos and
    GroupNorm statistics (every streaming Euler step), "kv" the K/V only
    (the clean-context pass at the end of a streaming slice).

    ``tp_group``: ``params`` is this rank's shard (``parallel.sharding``);
    every rank gets the same output and captures its own shard's context."""
    B, T, _ = x.shape
    mode = "full" if cap else cap_mode
    cap_cv = mode in ("full", "light")
    cap_kv = mode in ("full", "kv")
    h2 = params["down"]["resnet"]["block2"]["conv"]["w"].shape[1]
    walk = _Walk(cfg, pc, rc, kv, cap_cv, cap_kv, h2, tp_group)
    mask = valid[:, :, None].to(x.dtype)
    temb = _time_embedding(params["time_mlp"], cfg, t)
    spk_track = spk[:, None, :].expand(B, T, spk.shape[-1]).to(x.dtype)
    h = torch.cat([x, mu, spk_track, cond], dim=-1)

    def level(h, p_level, with_conv: bool, skip_in=None):
        rn_in = h if skip_in is None else torch.cat([h, skip_in], dim=-1)
        h = _resnet(p_level["resnet"], rn_in, mask, valid, temb, walk)
        for tf in p_level["tf"]:
            h = walk.tf(tf, cfg, h * mask, valid)
        if with_conv:
            return walk.conv(h * mask, p_level["conv"]), h
        return h, h

    h, skip = level(h, params["down"], True)
    for m in params["mid"]:
        h, _ = level(h, m, False)
    h, _ = level(h, params["up"], True, skip_in=skip)
    f = params["final"]
    h = walk.group_norm(walk.conv(h * mask, f["conv"]), f["gn"], valid)
    out = conv1d(_mish(h) * mask, params["proj"]["w"], params["proj"]["b"]) * mask
    if mode is not None:
        return out, walk.captured()
    return out


def _t_span(cfg: FlowRefConfig) -> np.ndarray:
    steps = np.arange(cfg.n_timesteps + 1, dtype=np.float64) / cfg.n_timesteps
    return (1.0 - np.cos(steps * 0.5 * np.pi)).astype(np.float32)


def cfm_noise_frames(n_frames: int) -> int:
    """Frames of initial noise to draw for a ``n_frames`` solve."""
    return max(_NOISE_FRAMES, n_frames)


def _cfg_lanes(mu: torch.Tensor, spk: torch.Tensor, valid: torch.Tensor, cond=None):
    """The [cond | uncond] CFG lanes of one solve: the uncond lane zeroes
    mu, spk and cond (no cond → zeros for both)."""
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    spk2 = torch.cat([spk, torch.zeros_like(spk)])
    cond2 = (torch.zeros_like(mu2) if cond is None
             else torch.cat([cond, torch.zeros_like(cond)]))
    return mu2, spk2, cond2, torch.cat([valid, valid])


def _euler(x: torch.Tensor, v: torch.Tensor, dt, w: float) -> torch.Tensor:
    B = x.shape[0]
    vc, vu = v[:B], v[B:]
    return x + np.float32(dt) * ((1.0 + w) * vc - w * vu)


def cfm_prompt_prefill(
    params: Dict,
    cfg: FlowRefConfig,
    noise: torch.Tensor,    # [B, ≥P, M] float32: the FIXED (voice-stable) prompt noise
    mu_p: torch.Tensor,     # [B, P, M] encoder output over the prompt region
    spk: torch.Tensor,      # [B, 80]
    cond_p: torch.Tensor,   # [B, P, M] packed prompt-mel conditioning
    valid_p: torch.Tensor,  # [B, P]
    tp_group=None,
) -> Dict:
    """Solve the CFM over the voice-prompt region once, capturing its frozen
    context at every Euler step → a per-voice cache for
    ``cfm_generate_cached`` and ``cfm_generate_streaming``.

    Per step it keeps the prompt's K/V of every transformer block, the
    prompt's last frame before every k = 3 conv, and the prompt's GroupNorm
    statistics. The deviation is the JAX package's (its
    ``cfm_prompt_prefill``): prompt frames no longer see generated frames;
    with an empty prompt the cached path is exact.

    → {"est": the flat context with a leading step axis S = n_timesteps
    (``_Walk`` lists the leaves), "pv": [2B, P] prompt key mask}. Both CFG
    lanes are captured."""
    P = mu_p.shape[1]
    x = noise[:, :P].float()
    w = cfg.inference_cfg_rate
    mu2, spk2, cond2, valid2 = _cfg_lanes(mu_p, spk, valid_p, cond_p)
    t_span = _t_span(cfg)
    recs = []
    for t_i, dt in zip(t_span[:-1], t_span[1:] - t_span[:-1]):
        t = torch.full((mu2.shape[0],), float(t_i), dtype=torch.float32, device=mu_p.device)
        v, rec = estimator_forward(params, cfg, torch.cat([x, x]).to(mu_p.dtype), mu2, spk2,
                                   cond2, t, valid2, cap=True, tp_group=tp_group)
        x = _euler(x, v.float(), dt, w)
        recs.append(rec)
    return {"est": {k: torch.stack([r[k] for r in recs]) for k in recs[0]}, "pv": valid2}


def _voice_lanes(cache: Dict, B: int):
    """A voice context (captured at batch 1: lanes [cond, uncond]) for a
    batch of B → (pv [2B, P], est): the small leaves repeated to
    [c×B, u×B] as the JAX package repeats them; K/V stay at 2 lanes:
    K2 reads lane b's prompt from row b // B."""
    pv, est = cache["pv"], cache["est"]
    if pv.shape[0] == 2 * B:
        return pv, est
    assert pv.shape[0] == 2, "prompt cache lane layout must be [cond, uncond]"
    est = {k: a if k in ("k", "v") else a.repeat_interleave(B, 1) for k, a in est.items()}
    return pv.repeat_interleave(B, 0), est


def _step(est: Dict, s: int) -> Dict:
    """One Euler step's halos and GroupNorm statistics (the K/V reach the
    attention through ``kv``)."""
    return {k: est[k][s] for k in ("halo", "gs", "gn")}


# --------------------------------------------------------------------------
# Streaming full overlap: a request's own frozen generated-frame context
# --------------------------------------------------------------------------
# As in the JAX package (decoder.py:613-639): slice k solves only its new
# frames against [voice prompt | earlier generated frames]. The request's
# context holds, per transformer block, a K/V ring of its last ≤ W frames
# (captured by one extra evaluation at t = 1 on the slice's solved mel: the
# "clean context"); per k = 3 conv and Euler step, the previous slice's last
# frame; per GroupNorm and Euler step, the running statistics of all earlier
# frames, added to the prompt's. The state is flat (``_Walk``'s layout with
# a step axis in front of the halos and statistics):
#   halo [S, 2B, ΣC], gs [S, 2B, NG, 2, G], gn [S, 2B, NG],
#   k, v [NB, 2B, H, W, dh], klen [B], frames [B].
# Lanes are [cond × B, uncond × B].

# the axis of each state leaf that runs over CFG lanes (klen and frames run
# over requests, axis 0)
STATE_LANE_AXIS = {"halo": 1, "gs": 1, "gn": 1, "k": 1, "v": 1}


def init_stream_state(cfg: FlowRefConfig, vcache: Dict, window: int, batch: int = 1) -> Dict:
    """A fresh streaming context: halos start as the voice cache's (slice
    1's left context is the prompt's edge, as in ``cfm_generate_cached``),
    running GroupNorm statistics at zero, an empty K/V ring of ``window``
    frames."""
    _, est = _voice_lanes(vcache, batch)
    B2 = 2 * batch
    k = est["k"]   # [S, NB, Bx, H, P, dh]: H this rank's heads
    ring = lambda: k.new_zeros((k.shape[1], B2, k.shape[3], window, k.shape[5]))  # noqa: E731
    counts = lambda: torch.zeros((batch,), dtype=torch.int32, device=k.device)  # noqa: E731
    return {"halo": est["halo"].clone(), "gs": torch.zeros_like(est["gs"]),
            "gn": torch.zeros_like(est["gn"]), "k": ring(), "v": ring(),
            "klen": counts(), "frames": counts()}


def _ring_append(ring_k: torch.Tensor, ring_v: torch.Tensor, cap_k: torch.Tensor,
                 cap_v: torch.Tensor, klen: torch.Tensor, tg: torch.Tensor, Tg: int):
    """Append a slice's K/V (right-packed: each lane's valid entries are its
    last ``tg`` of ``Tg``) after the ring's ``klen`` valid frames, evicting
    the oldest when the window would overflow; ``klen``/``tg`` per lane.
    Only the mask matters (no positional encoding), so eviction is a roll.
    Gathers and one select per tensor, no scatter. → (k, v, new klen)."""
    NB, B2, H, W, dh = ring_k.shape
    shift = (klen + tg - W).clamp_min(0)
    base = klen - shift
    wpos = torch.arange(W, device=klen.device)[None, :]
    roll = (wpos + shift[:, None]) % W
    src = (wpos - base[:, None] + (Tg - tg[:, None])).clamp(0, Tg - 1)
    is_new = ((wpos >= base[:, None]) & (wpos < (base + tg)[:, None]))[None, :, None, :, None]

    def g(a, idx):
        return torch.gather(a, 3, idx[None, :, None, :, None].expand(NB, B2, H, W, dh))

    return (torch.where(is_new, g(cap_k, src), g(ring_k, roll)),
            torch.where(is_new, g(cap_v, src), g(ring_v, roll)), base + tg)


def cfm_generate_streaming(
    params: Dict,
    cfg: FlowRefConfig,
    noise: torch.Tensor,    # [B, ≥2048, M] float32: the chunk's noise buffer
    mu_g: torch.Tensor,     # [B, Tg, M] encoder output, NEW frames right-packed
    spk: torch.Tensor,      # [B, 80]
    tg: torch.Tensor,       # [B] valid new frames (each row's last tg)
    vcache: Dict,           # per-voice cache from cfm_prompt_prefill (per step)
    rstate: Dict,           # from init_stream_state or the previous slice
    tp_group=None,
):
    """Solve only this slice's new frames against [frozen voice prompt |
    frozen earlier frames], then capture this slice's context → (mel block
    [B, Tg, M] right-packed, next state).

    A row's new frames take their initial noise from buffer positions
    [P + frames, P + frames + tg), clipped to the buffer's 2048 frames as in
    the JAX package: the positions the uncached and cached paths give them,
    so a chunk's first slice is the cached solve. Rows with tg == 0 (batch
    padding) pass their state through unchanged."""
    B, Tg, M = mu_g.shape
    pv, est = _voice_lanes(vcache, B)
    S = cfg.n_timesteps
    assert est["k"].shape[0] == S, "streaming needs the per-step ('step') prompt cache"
    P = pv.shape[-1]
    dev = mu_g.device
    j = torch.arange(Tg, device=dev)[None, :]
    tg = tg.to(dev).long()
    valid_g = j >= (Tg - tg[:, None])
    abs_pos = P + rstate["frames"].long()[:, None] + (j - (Tg - tg[:, None]))
    idx = abs_pos.clamp(0, _NOISE_FRAMES - 1)
    x = torch.gather(noise[:, :_NOISE_FRAMES].float(), 1, idx[:, :, None].expand(B, Tg, M))
    w = cfg.inference_cfg_rate
    mu2, spk2, cond2, valid2 = _cfg_lanes(mu_g, spk, valid_g)
    tg2 = torch.cat([tg, tg])
    pos2 = Tg - tg2
    W = rstate["k"].shape[3]
    klen2 = torch.cat([rstate["klen"], rstate["klen"]]).long()
    rmask = torch.arange(W, device=dev)[None, :] < klen2[:, None]
    # the key mask over [prompt | ring | own]; K2 reads each step's prompt
    # K/V and the ring in place (a state split off a batch holds views: made
    # contiguous here, once per solve)
    kv_valid = torch.cat([pv, rmask, valid2], 1)
    ring_k, ring_v = rstate["k"].contiguous(), rstate["v"].contiguous()

    def kv(s):
        return est["k"][s].contiguous(), est["v"][s].contiguous(), ring_k, ring_v, kv_valid

    def ctx(s):
        return {"est": _step(est, s)}, {"est": _step(rstate, s), "pos": pos2}

    t_span = _t_span(cfg)
    caps = []
    for s, (t_i, dt) in enumerate(zip(t_span[:-1], t_span[1:] - t_span[:-1])):
        t = torch.full((2 * B,), float(t_i), dtype=torch.float32, device=dev)
        pc, rc = ctx(s)
        v, cap = estimator_forward(params, cfg, torch.cat([x, x]).to(mu_g.dtype), mu2, spk2,
                                   cond2, t, valid2, pc=pc, rc=rc, cap_mode="light", kv=kv(s),
                                   tp_group=tp_group)
        x = _euler(x, v.float(), dt, w)
        caps.append(cap)
    mel = x.to(mu_g.dtype)

    # clean context: one evaluation at t = 1 on the solved mel, against the
    # last step's context; later slices attend to keys computed from
    # (near-)clean frames
    _, clean = estimator_forward(params, cfg, torch.cat([mel, mel]), mu2, spk2, cond2,
                                 torch.ones((2 * B,), dtype=torch.float32, device=dev), valid2,
                                 pc={"est": _step(est, S - 1)},
                                 rc={"est": _step(rstate, S - 1), "pos": pos2},
                                 cap_mode="kv", kv=kv(S - 1), tp_group=tp_group)
    k, v, klen_new = _ring_append(rstate["k"], rstate["v"], clean["k"], clean["v"], klen2, tg2,
                                  Tg)
    # halos ← this slice's last frames, except on lanes without new frames;
    # GroupNorm running statistics ← old + this slice's (zero on such lanes)
    keep = (tg2 > 0)[None, :, None]
    new_state = {
        "halo": torch.where(keep, torch.stack([c["halo"] for c in caps]), rstate["halo"]),
        "gs": rstate["gs"] + torch.stack([c["gs"] for c in caps]),
        "gn": rstate["gn"] + torch.stack([c["gn"] for c in caps]),
        "k": k, "v": v,
        "klen": klen_new[:B].to(rstate["klen"].dtype),
        "frames": rstate["frames"] + tg.to(rstate["frames"].dtype),
    }
    return mel, new_state


# --------------------------------------------------------------------------
# The JAX package's capture-tree layout, for holding the two packages'
# caches and states against each other
# --------------------------------------------------------------------------


