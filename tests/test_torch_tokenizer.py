"""The port's tokenizer.json reader (``models/tokenizer.py``, pure Python)
against the `tokenizers` package and the JAX package's ``TextTokenizer``.

A BPE ``tokenizer.json`` is trained in the test with `tokenizers`, as
``scripts/train_tokenizer.py`` trains one; a few hundred seeded strings
(words, punctuation, digits, characters outside the vocabulary, runs of
spaces, tabs and newlines) must give the same ids through all three. A file
with a component the reader does not implement raises, naming it; with no
file the character scheme is the JAX package's. The file ``chip_smoke.py``
writes for its model directory gives the ids the script holds the card's
boot to.
"""
import json
import random

import numpy as np
import pytest

from torch_port_helpers import train_tokenizer_json

from chatterbox_tpu.models.tokenizer import TextTokenizer as JTextTokenizer
from chatterbox_tpu_torch.models.tokenizer import BPEFile, TextTokenizer

ALPHABET = (list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")
            + list(" .,!?'-\"()[]:;_") + ["  ", "   ", "\t", "\n", "é", "ß", "中", "½", "²",
                                           "\u0301", "\u200d", "\x1c", "[SPACE]", "[STOP]"])


@pytest.fixture(scope="module")
def tok_file(tmp_path_factory):
    return train_tokenizer_json(tmp_path_factory.mktemp("tokenizer"))


def _strings(n: int = 300, seed: int = 3):
    rng = random.Random(seed)
    words = ["hello", "world", "quick", "streaming", "voice", "synthesis", "fox"]
    out = []
    for _ in range(n):
        parts = [rng.choice(ALPHABET) if rng.random() < 0.6 else rng.choice(words)
                 for _ in range(rng.randint(0, 12))]
        out.append("".join(parts))
    return out


def test_ids_match_tokenizers_and_jax(tok_file):
    from tokenizers import Tokenizer

    hf = Tokenizer.from_file(tok_file)
    port, jax_tok = TextTokenizer(tok_file), JTextTokenizer(tok_file)
    assert port.is_pretrained and jax_tok.is_pretrained
    unk = hf.token_to_id("[UNK]")
    seen_unk = 0
    for text in _strings():
        want = hf.encode(text.lower().replace(" ", "[SPACE]")).ids
        got = port.text_to_tokens(text)
        assert got.dtype == np.int32 and got.shape == (1, len(want))
        assert got[0].tolist() == want, text
        np.testing.assert_array_equal(got, jax_tok.text_to_tokens(text))
        seen_unk += unk in want
    assert seen_unk > 10   # characters outside the vocabulary were exercised


@pytest.mark.parametrize("component, value", [
    ("normalizer", {"type": "Lowercase"}),
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                       "use_regex": True}),
    ("post_processor", {"type": "TemplateProcessing", "single": [], "pair": [],
                        "special_tokens": {}}),
    ("model", "WordPiece"),
    ("model.byte_fallback", True),
    ("model.fuse_unk", True),
])
def test_unsupported_component_raises(tok_file, tmp_path, component, value):
    spec = json.loads(open(tok_file, encoding="utf-8").read())
    if component == "model":
        spec["model"]["type"] = value
    elif component.startswith("model."):
        spec["model"][component.split(".", 1)[1]] = value
    else:
        spec[component] = value
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=f"unsupported tokenizer {component}"):
        TextTokenizer(str(path))


def test_no_file_uses_the_character_scheme(tmp_path):
    port = TextTokenizer(str(tmp_path / "missing.json"))
    jax_tok = JTextTokenizer(str(tmp_path / "missing.json"))
    assert not port.is_pretrained
    for text in _strings(50, seed=5):
        np.testing.assert_array_equal(port.text_to_tokens(text), jax_tok.text_to_tokens(text))


def test_chip_smoke_tokenizer_file(tmp_path):
    """The small tokenizer.json chip_smoke.py and the bench write
    (``runtime.synthetic``, merges as "a b" strings): `tokenizers` and the
    port's reader give TOKENIZER_IDS."""
    from tokenizers import Tokenizer

    from chatterbox_tpu_torch.runtime import synthetic

    path = tmp_path / "tokenizer.json"
    synthetic.write_tokenizer_json(path)
    text = synthetic.TOKENIZER_SENTENCE
    want = Tokenizer.from_file(str(path)).encode(text.lower().replace(" ", "[SPACE]")).ids
    assert want == synthetic.TOKENIZER_IDS
    assert TextTokenizer(str(path)).text_to_tokens(text)[0].tolist() == want
    assert BPEFile(str(path)).encode("zz") == [BPEFile(str(path)).vocab["z"]] * 2
