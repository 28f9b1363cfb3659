"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

JAX stays on the CPU (tests/conftest.py); data crosses between the two
packages as numpy arrays. torch's intra-op threads are capped because the
suite runs in several worker processes at once.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(2)


def to_np(x) -> np.ndarray:
    """A jax array or torch tensor → float32/int numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def to_t(x, dtype=None) -> torch.Tensor:
    """numpy / jax array → CPU torch tensor (a copy)."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def jax_tree_to_np(tree):
    """A JAX pytree → the same nesting with numpy leaves."""
    import jax

    return jax.tree.map(np.asarray, tree)


# The random-weight HiFT stack grows its activations layer by layer: on
# unit-variance mels its output conv (conv_post) gives values with std ~200,
# so every magnitude saturates at exp(log 100) and ~90 % of the waveform sits
# on the ±audio_limit clip, where any two implementations agree trivially.
# ``conditioned_s3gen_params`` scales conv_post by HIFT_POST_SCALE (output std
# ~1) and lowers its log-magnitude bias by HIFT_LOGMAG_SHIFT, in both packages'
# parameters alike.
HIFT_POST_SCALE = 5e-3
HIFT_LOGMAG_SHIFT = 2.0


def conditioned_s3gen_params(jp, jcfg, post_scale: float = HIFT_POST_SCALE):
    """A JAX S3Gen ref parameter tree with conv_post conditioned as above
    (``post_scale`` replaces HIFT_POST_SCALE); the other subtrees, the voice
    embedding's ``tokenizer`` and ``speaker`` included, as they are."""
    post = jp["mel2wav"]["conv_post"]
    shift = np.zeros(post["b"].shape, np.float32)
    shift[: jcfg.hift.istft_n_fft // 2 + 1] = HIFT_LOGMAG_SHIFT
    return {**jp, "mel2wav": {
        **jp["mel2wav"],
        "conv_post": {"w": post["w"] * post_scale, "b": post["b"] * post_scale - shift},
    }}


def jax_s3gen_noise(jcfg, key, B, T):
    """The draws JAX's s3gen_ref_inference makes from ``key`` (CFM initial
    noise, HiFT initial phases, NSF noise), in the port's noise-dict form."""
    import jax
    import jax.numpy as jnp

    from chatterbox_tpu.models.s3gen_ref import decoder as jdec

    fl, hc = jcfg.flow, jcfg.hift
    assert (jcfg.max_prompt_tokens + T) * fl.up_stride <= jdec._NOISE_FRAMES
    k_ini, k_noise = jax.random.split(jax.random.fold_in(key, 1))
    H = hc.nb_harmonics + 1
    return {
        "cfm": to_t(jax.random.normal(key, (B, jdec._NOISE_FRAMES, fl.output_size), jnp.float32)),
        "rand_ini": to_t(jax.random.uniform(k_ini, (B, H))),
        "nsf": to_t(jax.random.normal(k_noise, (B, T * jcfg.samples_per_token, H))),
    }


def assert_trees_close(jax_tree, port_tree, rel: float = 1e-4):
    """Leaf by leaf (``None`` nodes skipped, as jax.tree does): the same
    structure and shapes, each leaf within ``rel`` of its largest magnitude
    (GroupNorm sums of squares reach ~1e3, so an absolute bound would say
    little)."""
    import jax

    want = jax.tree.leaves(jax_tree)
    got = jax.tree.leaves(jax.tree.map(to_np, port_tree))
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        a = np.asarray(a, np.float64)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * (1.0 + np.abs(a).max()))


def prompt_noise(n_mels: int, batch: int = 1) -> torch.Tensor:
    """The CFM prompt noise both packages draw from the fixed key 777 (the
    JAX engine's prompt-cache key), as a 2048-frame buffer."""
    import jax
    import jax.numpy as jnp

    return to_t(jax.random.normal(jax.random.PRNGKey(777), (batch, 2048, n_mels), jnp.float32))


def write_conds(path, spk_dim, n_prompt=6, n_feat=14, seed=7):
    """A seeded conds.pt in the reference format."""
    rng = np.random.default_rng(seed)
    t3 = {
        "speaker_emb": torch.tensor(rng.standard_normal((1, spk_dim)), dtype=torch.float32),
        "cond_prompt_speech_tokens": torch.tensor(rng.integers(0, 6561, (1, n_prompt))),
        "emotion_adv": 0.5 * torch.ones(1, 1, 1),
    }
    gen = {
        "prompt_token": torch.tensor(rng.integers(0, 6561, (1, n_prompt))),
        "prompt_token_len": torch.tensor([n_prompt]),
        "prompt_feat": torch.tensor(rng.standard_normal((1, n_feat, 80)), dtype=torch.float32),
        "prompt_feat_len": None,
        "embedding": torch.tensor(rng.standard_normal((1, 192)), dtype=torch.float32),
    }
    torch.save({"t3": t3, "gen": gen}, path)


def spy_slices(engine) -> dict:
    """Record, per request id, the tokens of every slice an engine's T3
    producer hands to its S3Gen producer (either package's engine: both
    take the token queue first and the request id tenth) → the record,
    filled as requests run."""
    from collections import defaultdict

    out = defaultdict(list)
    producer = engine._s3gen_producer

    class Spy:
        def __init__(self, q, slices):
            self.q, self.slices = q, slices

        async def get(self):
            item = await self.q.get()
            if item is not None:
                self.slices.append(np.asarray(item["tokens"]).tolist())
            return item

    engine._s3gen_producer = lambda token_q, *a, **kw: producer(Spy(token_q, out[a[8]]), *a, **kw)
    return out


# The DiT stack's random init leaves its AdaLN modulation and output
# projection at zero (AdaLN-zero), so the estimator returns 0 and the mel is
# the initial noise; and its vocoder's resblocks grow the activations to
# ~1e5, so ~70 % of the waveform sits on the ±1 clip. ``conditioned_dit_params``
# draws the zero leaves of the flow (``ada_w`` ~ N(0, 1/D), ``ada_b`` ~
# N(0, 0.01), ``out_proj.w`` ~ N(0, 1/D)) and scales each resblock's second
# conv by DIT_RES_SCALE (no clipped sample at tiny(), ~1 % at full width).
DIT_RES_SCALE = 0.1


def conditioned_dit_params(jp, seed: int = 0):
    """A JAX DiT S3Gen tree (numpy leaves) conditioned as above; a copy."""
    import copy

    rng = np.random.default_rng(seed)
    jp = copy.deepcopy(jp)
    lay, out = jp["flow"]["layers"], jp["flow"]["out_proj"]
    D = lay["ada_w"].shape[1]
    lay["ada_w"] = (rng.standard_normal(lay["ada_w"].shape) / np.sqrt(D)).astype(np.float32)
    lay["ada_b"] = (rng.standard_normal(lay["ada_b"].shape) * 0.1).astype(np.float32)
    out["w"] = (rng.standard_normal(out["w"].shape) / np.sqrt(D)).astype(np.float32)
    for stage in jp["vocoder"]["stages"]:
        for block in stage["res"]:
            for unit in block:
                unit["c2"]["w"] = unit["c2"]["w"] * DIT_RES_SCALE
    return jp


TOKENIZER_WORDS = ("hello", "world", "the", "quick", "brown", "fox", "speech", "token", "voice",
                   "streaming", "synthesis", "model", "is", "a", "of", "and", "port", "card")


def train_tokenizer_json(directory, seed: int = 0) -> str:
    """A BPE tokenizer.json trained with `tokenizers` as
    scripts/train_tokenizer.py trains one, on a seeded corpus the function
    writes (words, digits, punctuation) → its path."""
    import random
    from pathlib import Path

    from scripts.train_tokenizer import train

    rng = random.Random(seed)
    directory = Path(directory)
    corpus = directory / "corpus.txt"
    with open(corpus, "w", encoding="utf-8") as fh:
        for _ in range(400):
            words = [rng.choice(TOKENIZER_WORDS) for _ in range(rng.randint(3, 10))]
            fh.write(" ".join(words) + rng.choice([".", "!", "?", ","]) + f" {rng.randint(0, 999)}\n")
    out = directory / "tokenizer.json"
    train(str(corpus), str(out), 200)
    return str(out)
