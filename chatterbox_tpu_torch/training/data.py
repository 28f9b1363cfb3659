"""Training data pipeline for T3 fine-tuning (torch counterpart of
``chatterbox_tpu/training/data.py``).

Builds teacher-forcing batches from (wav, transcript) pairs: the text side
goes through the serving tokenizer, the speech side through S3Tok (25 Hz
tokens), and the conditioning features (speaker embedding, prompt tokens,
exaggeration) come from the models the serving path uses, so training and
inference see the same featurization. Featurization runs on the engine's
device; batching is host-side numpy with static-shape padding.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..audio.pcm import read_wav, resample
from ..models.s3tok import s3tok_tokenize
from ..models.t3.config import T3Config
from ..models.tokenizer import TextTokenizer
from ..models.voice_encoder import voice_embed
from ..runtime.engine import _resolve_device


@dataclasses.dataclass
class Example:
    text_tokens: np.ndarray    # [T]
    speech_tokens: np.ndarray  # [S]
    speaker_emb: np.ndarray    # [spk]
    prompt_tokens: np.ndarray  # [P]


class T3FeatureExtractor:
    """wav + text → (text tokens, speech tokens, speaker emb, prompt tokens),
    on the device the parameters lie on."""

    def __init__(self, params: Dict, engine_cfg, tokenizer: TextTokenizer):
        if "s3tok" not in params:
            raise ValueError(
                "training featurizes speech with S3Tok, which only the DiT S3Gen arch has "
                f"(this engine's is {engine_cfg.s3gen_arch!r}): set CHATTERBOX_S3GEN_ARCH=dit")
        self.params = params
        self.cfg = engine_cfg
        self.tokenizer = tokenizer
        self.device = params["s3tok"]["final_norm"].device

    @torch.inference_mode()
    def extract(self, wav_path: str, transcript: str) -> Example:
        t3c: T3Config = self.cfg.t3
        wav, sr = read_wav(wav_path)
        wav16 = resample(wav, sr, 16000)
        w16 = torch.from_numpy(wav16[None]).to(self.device)
        speech_tokens, tok_len = s3tok_tokenize(
            self.params["s3tok"], self.cfg.s3tok, w16,
            torch.tensor([len(wav16)], dtype=torch.int32, device=self.device))
        speech = speech_tokens[0, : int(tok_len[0])].cpu().numpy()
        spk = voice_embed(self.params["ve"], self.cfg.ve, w16)[0].float().cpu().numpy()
        P = t3c.speech_cond_prompt_len
        prompt = np.zeros((P,), np.int32)
        # The conditioning prompt must be DISJOINT from the prediction
        # target, or the model learns to copy the prompt: take it from the
        # utterance's tail and drop those tokens from the target.
        if len(speech) > 2 * P:
            prompt[:P] = speech[-P:]
            speech = speech[:-P]
        else:
            half = max(1, len(speech) // 2)
            n = min(P, len(speech) - half)
            if n > 0:
                prompt[:n] = speech[half : half + n]
            speech = speech[:half]
        ids = self.tokenizer.text_to_tokens(transcript)[0]
        text = np.concatenate(
            [[t3c.start_text_token], ids[: t3c.max_text_tokens - 2], [t3c.stop_text_token]]
        ).astype(np.int32)
        return Example(text, speech.astype(np.int32), spk.astype(np.float32), prompt)


def make_batches(
    examples: Sequence[Example],
    cfg: T3Config,
    batch_size: int,
    max_speech: int | None = None,
    exaggeration: float = 0.5,
    shuffle_seed: int | None = 0,
    device=None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Pad and stack examples into train-step batches on ``device`` (the
    card unless the caller names one): drops the last ragged batch, and
    shuffles when a seed is given. Tokens are int32, the rest float32."""
    device = _resolve_device(device)
    max_speech = max_speech or cfg.max_speech_tokens
    order = np.arange(len(examples))
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    T = cfg.max_text_tokens
    for i in range(0, len(order) - batch_size + 1, batch_size):
        chunk = [examples[j] for j in order[i : i + batch_size]]
        text = np.zeros((batch_size, T), np.int32)
        text_len = np.zeros((batch_size,), np.int32)
        speech = np.zeros((batch_size, max_speech), np.int32)
        mask = np.zeros((batch_size, max_speech), np.float32)
        spk = np.zeros((batch_size, len(chunk[0].speaker_emb)), np.float32)
        prompt = np.zeros((batch_size, cfg.speech_cond_prompt_len), np.int32)
        for b, ex in enumerate(chunk):
            t = ex.text_tokens[:T]
            text[b, : len(t)] = t
            text_len[b] = len(t)
            s = ex.speech_tokens[: max_speech - 1]
            speech[b, : len(s)] = s
            speech[b, len(s)] = cfg.stop_speech_token
            mask[b, : len(s) + 1] = 1.0
            spk[b] = ex.speaker_emb
            prompt[b] = ex.prompt_tokens
        host = {"text_tokens": text, "text_len": text_len, "speech_tokens": speech,
                "speech_mask": mask, "speaker_emb": spk, "prompt_tokens": prompt,
                "emotion": np.full((batch_size,), exaggeration, np.float32)}
        yield {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def load_manifest(path: str) -> List[Tuple[str, str]]:
    """TSV manifest: wav_path<TAB>transcript per line."""
    pairs: List[Tuple[str, str]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or "\t" not in line:
                continue
            wav, text = line.split("\t", 1)
            pairs.append((wav, text))
    return pairs
