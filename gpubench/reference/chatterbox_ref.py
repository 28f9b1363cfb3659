"""The plain reference of the ``ref`` configuration: Chatterbox's T3 and
S3Gen (reference architecture) in float32 PyTorch, one request at a time.

It imports nothing of the program. The models are a frozen copy
(``frozen/``) of the port's plain versions, with K2's plain form in place of
the kernel and no tensor parallelism; what surrounds them here is written
for one request: no batching, no KV cache, no bucketed right-packed blocks.
It works out again everything the program derives at set-up from the
inputs the benchmark hands both sides (the JAX-layout weights and the
``conds.pt`` default voice): the layouts, the T3 conditioning lanes, the
S3Gen conditioning dict, the voice's CFM prompt context and its fresh
streaming state.

The checks (``compare``), on the tokens and audio the program served:

- T3: the chunk's [conditioning | text | BOS | served tokens] through the
  backbone in one causal pass, both CFG lanes, the guided logits with the
  repetition penalty of the tokens before each step; at every step of a
  greedy request, the gap by which the served token lies below the best.
- S3Gen's flow: each slice's mel from the served tokens alone (the encoder
  over the accumulated tokens, the CFM solve of the slice's new frames
  against the voice's prompt context and the request's earlier frames, as
  the streaming full-overlap contract states) against the program's.
- HiFT, stage by stage from what the program handed each stage (its mel,
  f0, source cache): f0, the excitation, the vocoder's output before its
  ISTFT head; then the served PCM against the ISTFT head over the
  program's vocoder output, stitched as the engine states.

The noise the program draws enters as an input: the same seeded generator
draws on the same device type (the request id's CRC-32, as the engine's
``_stable_seed``; the prompt's fixed seed 777). The harness records what
the comparisons need of each batched S3Gen call (``CAPTURE``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .frozen.audio.crossfade import CrossfadeStitcher, trim_leading, trim_trailing
from .frozen.convert import convert_params
from .frozen.models.s3gen_ref import decoder as dec
from .frozen.models.s3gen_ref import model as s3m
from .frozen.models.s3gen_ref.config import (CampPlusConfig, FlowRefConfig, HiFTConfig,
                                             S3GenRefConfig, S3TokRefConfig)
from .frozen.models.s3gen_ref.hift import (_resblock, _source_down_rates, hift_receptive_margin,
                                          make_source, predict_f0)
from .frozen.models.t3 import model as t3m
from .frozen.models.t3.config import T3Config
from .frozen.models.voice_encoder.model import VoiceEncoderConfig, voice_encoder_param_tree
from .frozen.ops.conv import conv1d, conv_transpose1d
from .frozen.ops.nn import NEG_INF, linear
from .frozen.ops.precision import fp8_inputs
from .frozen.ops.spectral import istft, stft
from .frozen.text.processing import split_text_into_chunks

# what the harness records of the program for this reference: nothing at
# set-up; of each batched S3Gen call, the mel, f0 and excitation (with the
# source cache it was given) of every job (``run.Spies``)
OBSERVE: Dict = {}
_MODEL = "chatterbox_tpu_torch.models.s3gen_ref.model"
CAPTURE = {"mel": (_MODEL, "s3gen_ref_flow_streaming", [("out", 0)]),
           "f0": (_MODEL, "predict_f0", [("out", None)]),
           "source": (_MODEL, "_source_with_cache", [("arg", 3), ("arg", 4), ("out", None)]),
           # HiFT's last conv (conv_post), its output before the ISTFT head
           "post": ("chatterbox_tpu_torch.models.s3gen_ref.hift", "conv1d", [("out", None)])}
PROMPT_NOISE_SEED = 777
NOISE_BASE = 1234
STREAM_WINDOW = 512
REP_PENALTY = 1.2
LOOKAHEAD_MIN = 3
SLICE_SIZE_SNAP = (8, 16, 25, 35, 50, 70, 100)


# ------------------------------------------------------------ configuration
def _tuples(x):
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    return x


def _dc(cls, d: Dict):
    return cls(**{k: _tuples(v) for k, v in d.items()})


@dataclasses.dataclass(frozen=True)
class Sizes:
    t3: T3Config
    s3: S3GenRefConfig
    ve: VoiceEncoderConfig
    text_bucket: int
    max_new_tokens: int


def sizes(config: Dict, max_new_tokens: int) -> Sizes:
    """The configuration file's sizes → the frozen models' configs."""
    m = config["model"]
    s = m["s3gen_ref"]
    s3 = S3GenRefConfig(tokenizer=_dc(S3TokRefConfig, s["tokenizer"]),
                        speaker=_dc(CampPlusConfig, s["speaker"]),
                        flow=_dc(FlowRefConfig, s["flow"]), hift=_dc(HiFTConfig, s["hift"]),
                        **{k: v for k, v in s.items()
                           if k not in ("tokenizer", "speaker", "flow", "hift")})
    return Sizes(_dc(T3Config, m["t3"]), s3, _dc(VoiceEncoderConfig, m["ve"]),
                 m["engine"]["text_bucket"], max_new_tokens)


def param_trees(sz: Sizes, init) -> Dict:
    """The JAX-layout trees the program's parameters are converted from."""
    return {"t3": t3m.t3_param_tree(sz.t3, init),
            "s3gen": s3m.s3gen_ref_param_tree(sz.s3, init),
            "ve": voice_encoder_param_tree(sz.ve, init)}


def write_conds(path, seed: int, sz: Sizes) -> None:
    """A seeded default voice in Chatterbox's ``conds.pt`` format, at the
    prompt windows the configuration states (T3: speech_cond_prompt_len
    tokens; S3Gen: max_prompt_tokens tokens and twice as many mel frames)."""
    g = torch.Generator().manual_seed(seed)
    P, Pg = sz.t3.speech_cond_prompt_len, sz.s3.max_prompt_tokens
    codes = sz.t3.num_speech_codes
    t3 = {"speaker_emb": torch.randn((1, sz.t3.speaker_embed_dim), generator=g),
          "cond_prompt_speech_tokens": torch.randint(0, codes, (1, P), generator=g),
          "emotion_adv": 0.5 * torch.ones(1, 1, 1)}
    gen = {"prompt_token": torch.randint(0, codes, (1, Pg), generator=g),
           "prompt_token_len": torch.tensor([Pg]),
           "prompt_feat": torch.randn((1, 2 * Pg, sz.s3.n_mels), generator=g) * 2.0 - 6.0,
           "prompt_feat_len": torch.tensor([2 * Pg]),
           "embedding": torch.randn((1, sz.s3.spk_dim), generator=g)}
    torch.save({"t3": t3, "gen": gen}, path)


# ------------------------------------------------------------ text
def text_ids(chunk: str, t3c: T3Config) -> List[int]:
    """[SOT] + the chunk's ids + [EOT]: without a tokenizer.json the ids are
    a character hash inside the text vocabulary, 1 for whitespace."""
    lo, hi = 2, t3c.text_vocab_size - 2
    ids = []
    for ch in chunk.lower():
        if ch.isspace():
            ids.append(1)
            continue
        tok = lo + (ord(ch) * 2654435761) % (hi - lo)
        ids.append(tok + 1 if tok == 255 else tok)
    ids = ids or [1]
    return [t3c.start_text_token] + ids[: t3c.max_text_tokens - 2] + [t3c.stop_text_token]


def chunks(text: str, chunk_size: int) -> List[str]:
    return split_text_into_chunks(text, chunk_size)


def t3_lanes(p: Dict, t3c: T3Config, spk: torch.Tensor, toks: torch.Tensor, tok_len: torch.Tensor,
             emo: torch.Tensor) -> torch.Tensor:
    """T3's conditioning lanes [2, C, D]: cond, then uncond with a zero
    speaker and exaggeration; the prompt cut or zero-padded to its window."""
    P = t3c.speech_cond_prompt_len
    plen = tok_len.clamp_max(P)
    toks = torch.nn.functional.pad(toks[:, :P], (0, max(0, P - toks.shape[1])))
    cond = t3m.cond_embeddings(p, t3c, spk, toks, emo, plen)
    uncond = t3m.cond_embeddings(p, t3c, torch.zeros_like(spk), toks, torch.zeros_like(emo), plen)
    return torch.cat([cond, uncond])


# ------------------------------------------------------------ weights
def quantize_fp8(params):
    """Every weight of two or more dimensions rounded to float8 e4m3 with a
    scale per output row (the control: the next precision below bf16)."""
    def q(x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point() and x.dim() >= 2):
            return x
        amax = x.abs().flatten(1).amax(1).clamp_min(1e-12)
        scale = (amax / 448.0).view(-1, *([1] * (x.dim() - 1)))
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return q(t)

    return walk(params)


class Reference:
    """The reference over one set of weights and one default voice.
    ``observed``: what the harness saw the program make that the reference
    takes as given (nothing, for this configuration)."""

    PARTS = ("t3", "s3gen")

    def __init__(self, sz, raw_tree: Dict, conds_path, device, control: bool = False,
                 observed: Optional[Dict] = None):
        self.sz, self.device, self.control = sz, torch.device(device), control
        params = convert_params({k: raw_tree[k] for k in self.PARTS}, self.device, torch.float32)
        self.params = quantize_fp8(params) if control else params
        self.cache = None
        self.state0 = None
        self.voice_checks: Dict[str, float] = {}
        with torch.inference_mode(), fp8_inputs() if control else contextlib.nullcontext():
            self.t3_lanes, self.gen_ref = self._voice(conds_path, observed or {})

    def _voice(self, conds_path, observed: Dict):
        """The default voice from ``conds.pt``: T3's lanes and S3Gen's
        conditioning dict."""
        raw = torch.load(conds_path, map_location="cpu", weights_only=True)
        return self._t3_lanes(raw["t3"]), self._gen_ref(raw["gen"])

    # -------------------------------------------------------------- voice
    def _t3_lanes(self, t3: Dict) -> torch.Tensor:
        dev = self.device
        toks = torch.as_tensor(t3["cond_prompt_speech_tokens"]).long().reshape(1, -1).to(dev)
        spk = torch.as_tensor(t3["speaker_emb"]).float().reshape(1, -1).to(dev)
        emo = torch.as_tensor(t3["emotion_adv"]).float().reshape(-1)[:1].to(dev)
        return t3_lanes(self.params["t3"], self.sz.t3, spk, toks,
                        torch.tensor([toks.shape[1]], device=dev), emo)

    def _gen_ref(self, gen: Dict) -> Dict:
        rc, dev = self.sz.s3, self.device
        Pg, Pm, up = rc.max_prompt_tokens, rc.max_prompt_mel, rc.flow.up_stride
        ptok = torch.as_tensor(gen["prompt_token"]).long().reshape(1, -1)
        feat = torch.as_tensor(gen["prompt_feat"]).float().reshape(1, -1, rc.n_mels)
        n_tok = min(ptok.shape[1], int(torch.as_tensor(gen["prompt_token_len"]).reshape(-1)[0]), Pg)
        n_mel = min(feat.shape[1], int(torch.as_tensor(gen["prompt_feat_len"]).reshape(-1)[0]), Pm)
        n_tok = min(n_tok, n_mel // up)
        n_mel = n_tok * up
        gtok = torch.zeros((1, Pg), dtype=torch.long)
        gtok[0, :n_tok] = ptok[0, :n_tok]
        mel = torch.zeros((1, Pm, rc.n_mels))
        mel[0, :n_mel] = feat[0, :n_mel]
        return {"spk_emb": torch.as_tensor(gen["embedding"]).float().reshape(1, -1).to(dev),
                "prompt_tokens": gtok.to(dev), "prompt_len": torch.tensor([n_tok], device=dev),
                "prompt_mel": mel.to(dev), "prompt_mel_len": torch.tensor([n_mel], device=dev)}

    def voice_check(self, control=None) -> Dict[str, float]:
        """Numbers of the voice's own stage: none for this configuration."""
        return {}

    def _voice_context(self):
        """The voice's CFM prompt context and fresh streaming state."""
        if self.cache is None:
            rc = self.sz.s3
            gen = torch.Generator(device=self.device).manual_seed(PROMPT_NOISE_SEED)
            pm = rc.max_prompt_tokens * rc.flow.up_stride
            noise = torch.randn((1, dec.cfm_noise_frames(pm), rc.flow.output_size), generator=gen,
                                device=self.device)
            self.cache = s3m.s3gen_ref_prompt_prefill(self.params["s3gen"], rc, self.gen_ref, noise)
            self.state0 = s3m.init_s3gen_stream_state(rc, self.cache, STREAM_WINDOW,
                                                      self.reachable_cap())
        return self.cache, self.state0

    def reachable_cap(self) -> int:
        return min(self.sz.t3.max_speech_tokens + 8, self.sz.max_new_tokens + 2)

    # ----------------------------------------------------------------- T3
    @torch.inference_mode()
    def guided_logits(self, text: str, tokens: Sequence[int], cfg_weight: float) -> torch.Tensor:
        """The guided logits [n + 1, V] (float32) before each served token
        and after the last: CFG over the two lanes, the invalid ids masked,
        the repetition penalty of the tokens served before the step."""
        t3c, p, dev = self.sz.t3, self.params["t3"], self.device
        ids = torch.tensor(text_ids(text, t3c), device=dev)
        n = len(tokens)
        speech_in = torch.tensor([t3c.start_speech_token] + list(tokens), device=dev)
        text_h = p["text_emb"][ids] + p["text_pos"][: len(ids)]
        speech_h = p["speech_emb"][speech_in] + p["speech_pos"][: n + 1]
        h = torch.cat([self.t3_lanes, torch.cat([text_h, speech_h])[None].expand(2, -1, -1)], 1)
        valid = torch.ones(h.shape[:2], dtype=torch.bool, device=dev)
        hidden, _, _ = t3m._backbone_prefill(p, t3c, h, valid, collect_kv=False)
        first = self.t3_lanes.shape[1] + len(ids)
        logits = linear(hidden[:, first:], p["speech_head"]["w"], p["speech_head"]["b"]).float()
        ids_v = torch.arange(t3c.speech_vocab_size, device=dev)
        allowed = (ids_v < t3c.num_speech_codes) | (ids_v == t3c.stop_speech_token)
        guided = logits[0] + cfg_weight * (logits[0] - logits[1])
        guided = torch.where(allowed, guided, NEG_INF)
        seen = torch.zeros((n + 1, t3c.speech_vocab_size), dtype=torch.bool, device=dev)
        if n:
            tok = torch.tensor(list(tokens), device=dev)
            onehot = torch.zeros((n, t3c.speech_vocab_size), dtype=torch.bool, device=dev)
            onehot[torch.arange(n, device=dev), tok] = True
            seen[1:] = onehot.int().cumsum(0) > 0
        return torch.where(seen, torch.where(guided > 0, guided / REP_PENALTY,
                                             guided * REP_PENALTY), guided)

    def targets(self, tokens: Sequence[int]) -> List[int]:
        """The tokens the program chose at each checked step: the served
        ones, then EOS when the chunk stopped short of its cap."""
        cap = self.sz.max_new_tokens
        return list(tokens) + ([self.sz.t3.stop_speech_token] if len(tokens) < cap else [])

    # -------------------------------------------------------------- S3Gen
    def slice_size(self, requested: int) -> int:
        """The request's tokens per slice, snapped to the engine's ladder
        and at most the decode cap."""
        cap = self.sz.max_new_tokens
        requested = max(1, min(requested, cap))
        snapped = min(SLICE_SIZE_SNAP, key=lambda s: (abs(s - requested), s))
        return max(1, min(snapped, cap))

    def slices(self, tokens: Sequence[int], slice_size: int) -> List[List[int]]:
        """A chunk's served tokens as the engine cuts them: a look-ahead
        slice of max(3, ⌈slice/5⌉) tokens, then slices of ``slice_size``;
        the remainder, or an empty slice, ends the chunk."""
        out, pos = [], 0
        target = min(max(LOOKAHEAD_MIN, -(-slice_size // 5)), slice_size)
        while len(tokens) - pos >= target:
            out.append(list(tokens[pos:pos + target]))
            pos, target = pos + target, slice_size
        if pos < len(tokens) or not out:
            out.append(list(tokens[pos:]))
        return out

    def buckets(self, slice_size: int) -> List[int]:
        cap = self.reachable_cap()
        sizes_ = [min(slice_size, cap)]
        b = 32
        while b < cap:
            if b > sizes_[-1]:
                sizes_.append(b)
            b *= 2
        if sizes_[-1] < cap:
            sizes_.append(cap)
        return sizes_

    def _chunk_state(self):
        """What a chunk's first slice starts from: the voice's fresh
        streaming state."""
        return self._voice_context()[1]

    def _noise(self, T: int, gen):
        return s3m.draw_noise(self.sz.s3, 1, T, gen, self.device, stream=True)

    def _own_mel(self, acc: List[int], n_new: int, T: int, noise, state):
        """The slice's mel [T·fpt, M] from the served tokens alone, through
        this reference's own streaming state → (mel, next state)."""
        rc, dev = self.sz.s3, self.device
        mel, state = s3m.s3gen_ref_flow_streaming(
            self.params["s3gen"], rc, torch.tensor([acc], device=dev),
            torch.tensor([len(acc)], device=dev), torch.tensor([n_new], device=dev), self.gen_ref,
            noise["cfm"], state, n_new, self._voice_context()[0])
        return torch.nn.functional.pad(mel[0], (0, 0, 0, (T - len(acc)) * rc.flow.up_stride)), state

    def _f0(self, mel):
        return predict_f0(self.params["s3gen"]["mel2wav"], self.sz.s3.hift, mel[None])[0]

    def _source(self, f0, noise, job: Dict):
        """The excitation from an f0, its phase summed in f0's own dtype."""
        return make_source(self.params["s3gen"]["mel2wav"], self.sz.s3.hift, f0[None],
                           noise["rand_ini"], noise["nsf"])[0]

    def _post(self, mel, source):
        """HiFT up to its last conv: mel [F, 80] and excitation [F·up] →
        conv_post's output [frames, n_fft + 2] (``hift_decode``'s body), the
        log-magnitude and phase input of the ISTFT head."""
        p, cfg = self.params["s3gen"]["mel2wav"], self.sz.s3.hift
        mel, source = mel[None].float(), source[None].float()
        n_fft, hop = cfg.istft_n_fft, cfg.istft_hop
        win = p["stft_window"].float()
        s_spec = stft(source, n_fft, hop, win)
        s_stft = torch.cat([s_spec.real, s_spec.imag], dim=-1).to(mel.dtype)
        x = conv1d(mel, p["conv_pre"]["w"], p["conv_pre"]["b"], padding="SAME_TORCH")
        cum = _source_down_rates(cfg)
        nk = len(cfg.resblock_kernel_sizes)
        for i, u in enumerate(cfg.upsample_rates):
            x = torch.nn.functional.leaky_relu(x, cfg.lrelu_slope)
            x = conv_transpose1d(x, p["ups"][i]["w"], p["ups"][i]["b"], stride=u)
            if i == len(cfg.upsample_rates) - 1:
                x = torch.cat([x[:, 1:2], x], dim=1)
            du, sd = cum[i], p["source_downs"][i]
            if du == 1:
                si = conv1d(s_stft, sd["w"], sd["b"])
            else:
                pad = du // 2
                si = conv1d(torch.nn.functional.pad(s_stft, (0, 0, pad, pad)), sd["w"], sd["b"],
                            stride=du, padding="VALID")
            x = x + _resblock(p["source_resblocks"][i], si, cfg.source_resblock_dilation_sizes[i])
            acc = None
            for j in range(nk):
                r = _resblock(p["resblocks"][i * nk + j], x, cfg.resblock_dilation_sizes[j])
                acc = r if acc is None else acc + r
            x = acc / nk
        x = torch.nn.functional.leaky_relu(x, 0.01)
        return conv1d(x, p["conv_post"]["w"], p["conv_post"]["b"], padding="SAME_TORCH")[0]

    def _spectrum(self, post):
        """The ISTFT head's spectrum from conv_post's output: magnitude
        exp(x) capped at 100, phase sin(x)."""
        n = self.sz.s3.hift.istft_n_fft // 2 + 1
        post = post.float()
        return torch.polar(torch.exp(post[..., :n].clamp_max(float(np.log(1e2)))),
                           torch.sin(post[..., n:]))

    def _window(self, start: int, tail_len: int, T: int):
        """The program's vocoder window around a tail (``_vocode_tail_window``):
        (first token, tokens, the tail's offset in the window's samples)."""
        spt = self.sz.s3.samples_per_token
        margin_tok = -(-hift_receptive_margin(self.sz.s3.hift) // spt) + 1
        win_tok = min(T, -(-tail_len // spt) + 2 * margin_tok)
        w0 = min(max(start // spt - margin_tok, 0), T - win_tok)
        return w0, win_tok, min(max(start - w0 * spt, 0), win_tok * spt - tail_len)

    def _from_spectrum(self, z, n_samples: int):
        """The ISTFT of a spectrum, clipped to the audio limit."""
        cfg = self.sz.s3.hift
        win = self.params["s3gen"]["mel2wav"]["stft_window"].float()
        wav = istft(z[None], cfg.istft_n_fft, cfg.istft_hop, win, length=n_samples)[0]
        return wav.clamp(-cfg.audio_limit, cfg.audio_limit)

    def _served(self, job: Dict):
        """The program's mel, f0, source cache, cache length and source of a
        job, as the harness captured them (``CAPTURE``)."""
        return (job["mel"][0], job["f0"][0], job["source"][0], int(job["source"][1]),
                job["source"][2])

    @torch.inference_mode()
    def stages(self, request_id: str, chunk_tokens: List[Sequence[int]], chunk_jobs: List[List[Dict]],
               args: Dict):
        """Each slice of the request, stage by stage → [(valid frames, emitted
        samples [lo, hi) of the job's tail, this reference's mel from the
        served tokens, its f0 from the program's mel, its source from the
        program's f0 and source cache, its tail from the program's mel and
        source, the program's job, (the vocoder's conv_post output from this
        reference's own mel, f0 and excitation, its valid frames))]. The mel
        is the reference's own, through its own streaming state; each later
        stage starts from what the program handed it, since the excitation's
        phase sums f0 over the chunk and a last-bit difference of f0 turns it
        round; the last entry runs the vocoder from the reference's own mel
        alone, for the comparisons that do not read the phase."""
        gc, dev = self.sz.s3, self.device
        spt = gc.samples_per_token
        slice_size = self.slice_size(args["audio_tokens_per_slice"])
        buckets = self.buckets(slice_size)
        base = (NOISE_BASE * 1_000_003 + (zlib.crc32(request_id.encode()) & 0x7FFFFFFF)) & 0x7FFFFFFF
        gen = torch.Generator(device=dev)
        out = []
        for ci, (toks, jobs) in enumerate(zip(chunk_tokens, chunk_jobs)):
            acc: List[int] = []
            state, prev_valid = self._chunk_state(), 0
            slices = self.slices(toks, slice_size)
            k = 0
            for si, sl in enumerate(slices):
                last = si == len(slices) - 1
                new = sl + ([self.sz.t3.stop_text_token] if last else [])
                new = [t for t in new if t < gc.vocab_size]
                before = len(acc)
                acc += new
                if not acc:
                    continue
                if len(acc) < 3:
                    acc += [0] * (3 - len(acc))
                n_new = len(acc) - before
                if n_new == 0:
                    continue
                if k >= len(jobs) or jobs[k]["token_len"] != len(acc):
                    raise AssertionError(f"{request_id} chunk {ci}: the program's S3Gen jobs "
                                         f"{[j['token_len'] for j in jobs]} are not the slices "
                                         f"of its tokens")
                job = jobs[k]
                k += 1
                T = next(b for b in buckets if b >= len(acc))
                valid = len(acc) * spt
                gen.manual_seed(base + ci)
                noise = self._noise(T, gen)
                mel, state = self._own_mel(acc, n_new, T, noise, state)
                p_mel, p_f0, p_cache, p_clen, p_src = self._served(job)
                f0 = self._f0(p_mel)
                src = self._source(p_f0, noise, job)
                n = src.shape[0]
                src = torch.where(torch.arange(n, device=dev) < p_clen,
                                  p_cache[:n].to(src.dtype), src)
                start, tail = int(job["start"]), len(job["tail"])
                w0, win, off = self._window(start, tail, T)
                fpt = self._fpt()
                post = self._post(p_mel[w0 * fpt:(w0 + win) * fpt], p_src[w0 * spt:(w0 + win) * spt])
                # the vocoder again from this reference's own mel and f0
                own_src = self._source(self._f0(mel), noise, job)
                own_src = torch.where(torch.arange(own_src.shape[0], device=dev) < p_clen,
                                      p_cache[: own_src.shape[0]].to(own_src.dtype), own_src)
                own_post = self._post(mel[w0 * fpt:(w0 + win) * fpt],
                                      own_src[w0 * spt:(w0 + win) * spt])
                n_post = own_post.shape[0] * (len(acc) - w0) // win
                out.append((len(acc) * fpt, (prev_valid - start, valid - start), mel, f0, src,
                            post, (win * spt, off), job, (own_post, n_post)))
                prev_valid = valid
            if k != len(jobs):
                raise AssertionError(f"{request_id} chunk {ci}: {len(jobs)} S3Gen jobs for "
                                     f"{k} slices")
        return out

    def _fpt(self) -> int:
        return self.sz.s3.flow.up_stride

    def stitch(self, tails: List[List[np.ndarray]], args: Dict) -> np.ndarray:
        """Each chunk's emitted slices, as the engine stitches them: trimmed
        at the request's ends, crossfaded, PCM16. The control rounds the
        audio to bfloat16 first, the next precision below float32."""
        sr = self.sz.s3.sample_rate
        stitcher = CrossfadeStitcher(int(sr * args["crossfade_duration_milliseconds"] / 1000.0))
        out = []
        n_chunks = len(tails)
        for ci, chunk in enumerate(tails):
            for k, audio in enumerate(chunk):
                if self.control:
                    audio = torch.from_numpy(audio).to(torch.bfloat16).float().numpy()
                if ci == 0 and k == 0:
                    audio = trim_leading(audio, args["remove_leading_milliseconds"], sr)
                if ci == n_chunks - 1 and k == len(chunk) - 1:
                    audio = trim_trailing(audio, args["remove_trailing_milliseconds"], sr)
                out.append(stitcher.push(audio))
        out.append(stitcher.flush())
        audio = np.concatenate(out) if out else np.zeros(0, np.float32)
        return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)


# ------------------------------------------------------------ the checks
def estimator_evals(sz: Sizes) -> int:
    """CFM estimator evaluations per streaming solve: each Euler step, then
    the clean evaluation that captures the slice's context."""
    return sz.s3.flow.n_timesteps + 1


def job_positions(sz: Sizes, token_len: int, new_len: int):
    """(tokens the encoder runs over, frames the CFM solves) of one
    streaming job: the prompt and the accumulated tokens, the new frames."""
    return sz.s3.max_prompt_tokens + token_len, new_len * sz.s3.flow.up_stride


def flop_rates(raw: Dict) -> Dict[str, float]:
    from ..roofline import flop_rates as rates
    return rates(raw)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ / ‖want‖ over float32 copies."""
    got, want = got.float().flatten(), want.float().flatten()
    return float((got - want).norm() / want.norm().clamp_min(1e-12))


def compare(ref: Reference, sample, served_pcm: Dict[str, np.ndarray], check: Dict,
            jobs: Dict[str, List[List[Dict]]], control=None) -> Dict:
    """The sampled requests against the reference → the widest of each
    number over them:

    - ``t3_gap``: at each served step of a greedy request, the gap by which
      the served token's guided logit lies below the best (logits);
    - ``mel_rel``: the program's mel of each slice against the reference's
      own from the served tokens (relative L2 over the valid frames);
    - ``f0_rel``, ``source_rel``, ``spec_rel``: the program's f0, excitation
      and vocoder output before its ISTFT head (conv_post's log-magnitude
      and phase channels) against the reference's from the program's mel;
      f0 and source cache; mel and source (relative L2);
    - ``pcm_lsb``: the served PCM against the ISTFT head over the program's
      conv_post output, windowed, trimmed, crossfaded and converted as the
      engine states (largest difference, in PCM16 steps);
    - ``voc_mag_rel``, ``voc_ltas_rel``: the magnitude spectrum of the
      program's ISTFT head against the reference's whole chain from its
      own mel (its f0, its excitation, its vocoder) over the valid frames:
      frame by frame, and averaged over the frames (the long-term
      spectrum, blind to where the excitation's phase stands).

    The later stages start from what the program handed them: the
    excitation's phase sums f0 over a chunk, and with random weights HiFT's
    head caps every magnitude and takes the sine of large phases, so a
    last-bit difference upstream turns the audio round and no independent
    end-to-end waveform compares.

    With ``control`` (a second ``Reference`` in the next lower precision,
    put in the program's place): its numbers against the reference's from
    the same tokens and the same program inputs."""
    out = {"t3_gap": 0.0, "mel_rel": 0.0, "f0_rel": 0.0, "source_rel": 0.0, "spec_rel": 0.0,
           "pcm_lsb": 0.0, "voc_mag_rel": 0.0, "voc_ltas_rel": 0.0}
    low = fp8_inputs if control is not None else contextlib.nullcontext
    for r in sample:
        texts = chunks(r.req.text, r.args["text_processing_chunk_size"])
        if len(texts) != len(r.chunks):
            raise AssertionError(f"{r.rid}: {len(r.chunks)} chunks served, the text has {len(texts)}")
        if r.req.greedy:
            w = r.args["cfg_guidance_weight"]
            for text, toks in zip(texts, r.chunks):
                g = ref.guided_logits(text, toks, w)
                tgt = ref.targets(toks)
                if control is not None:
                    with low():
                        tgt = control.guided_logits(text, toks, w)[: len(tgt)].argmax(-1).tolist()
                rows = torch.arange(len(tgt), device=g.device)
                best = g[: len(tgt)].max(-1).values
                gap = float((best - g[rows, torch.tensor(tgt, device=g.device)]).max())
                out["t3_gap"] = max(out["t3_gap"], gap)
        want = ref.stages(r.rid, r.chunks, jobs[r.rid], r.args)
        with low():
            got = control.stages(r.rid, r.chunks, jobs[r.rid], r.args) if control else None
        tails: List[List[np.ndarray]] = [[] for _ in r.chunks]
        for i, (frames, (lo, hi), mel, f0, src, post, (n_win, off), job, (own, n_p)) in enumerate(want):
            ci = next(c for c, js in enumerate(jobs[r.rid]) if any(j is job for j in js))
            if got is not None:
                g_mel, g_f0, g_src, g_post = got[i][2], got[i][3], got[i][4], got[i][5]
                g_own = got[i][8][0]
            else:
                g_mel, g_f0, _, _, g_src = ref._served(job)
                g_post = g_own = job["post"][0]
            mag = ref._spectrum(own.float()).abs()[:n_p]
            g_mag = ref._spectrum(g_own.to(own.device).float()).abs()[:n_p]
            out["voc_mag_rel"] = max(out["voc_mag_rel"], _rel(g_mag, mag))
            out["voc_ltas_rel"] = max(out["voc_ltas_rel"], _rel(g_mag.mean(0), mag.mean(0)))
            n_s = frames * (src.shape[0] // f0.shape[0])
            out["mel_rel"] = max(out["mel_rel"], _rel(g_mel[:frames], mel[:frames]))
            out["f0_rel"] = max(out["f0_rel"], _rel(g_f0[:frames], f0[:frames]))
            out["source_rel"] = max(out["source_rel"], _rel(g_src[:n_s], src[:n_s]))
            out["spec_rel"] = max(out["spec_rel"], _rel(g_post, post))
            wav = ref._from_spectrum(ref._spectrum(job["post"][0]), n_win)
            wav = wav[off:off + len(job["tail"])]
            tails[ci].append(wav[lo:hi].cpu().numpy())
        pcm = (control or ref).stitch(tails, r.args)
        served = served_pcm[r.rid]
        out["pcm_lsb"] = max(out["pcm_lsb"], float(
            np.abs(pcm.astype(np.int64) - served.astype(np.int64)).max()
            if len(pcm) == len(served) else math.inf))
    return {**out, **ref.voice_check(control)}
