"""Port parity: ergm_tpu_torch's tokenizer (``tokenizer/bpe.py``, the
native merge loop of ``tokenizer/native.py``) and ``tools/text2ids.py``
against ergm_tpu's, exactly: the same vocabulary and merges from
``train_bpe``, the same ids from ``encode`` (special tokens included) and
the same text from ``decode``, and the same pre-tokens from GPT-2's
split pattern.
"""
import json

import numpy as np
import pytest

from ergm_tpu.core.tokens import ADDITIONAL_SPECIAL_TOKENS as JAX_SPECIALS
from ergm_tpu.tokenizer import bpe as jbpe
from ergm_tpu.tools import text2ids as jt2i
from ergm_tpu_torch.core.tokens import ADDITIONAL_SPECIAL_TOKENS
from ergm_tpu_torch.tokenizer import bpe as tbpe
from ergm_tpu_torch.tokenizer import native as tnative
from ergm_tpu_torch.tools import text2ids as tt2i

CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "I don't think that's right, she said loudly.",
    "Empathetic response generation with multimodal features!",
    "Numbers like 123 and 42 should tokenize too.",
    "naïve café — déjà vu, 東京 and 😀 emoji",
] * 4
TEXTS = CORPUS[:5] + [
    "unseen wordz zzz qqq", "a", "", "   ", "tabs\tand\nnewlines \r\n end  ",
    "<bos><speaker1>hello there<speaker2><|endoftext|>", "I'll've we're they'd ISN'T",
    "x y z　w", "\x1c\x1d\x1e\x1f field separators",
]


@pytest.fixture(scope="module")
def tokenizers():
    j = jbpe.train_bpe(CORPUS, vocab_size=420, special_tokens=JAX_SPECIALS)
    t = tbpe.train_bpe(CORPUS, vocab_size=420, special_tokens=ADDITIONAL_SPECIAL_TOKENS)
    return j, t


def test_train_bpe_matches_jax(tokenizers):
    j, t = tokenizers
    assert ADDITIONAL_SPECIAL_TOKENS == JAX_SPECIALS
    assert t.vocab == j.vocab
    assert t.merge_ranks == j.merge_ranks
    assert t.special_tokens == j.special_tokens


@pytest.mark.parametrize("text", TEXTS)
def test_encode_decode_match_jax(tokenizers, text):
    j, t = tokenizers
    ids = t.encode(text)
    assert ids == j.encode(text)
    assert t.decode(ids) == j.decode(ids)
    assert t.decode(ids, skip_special_tokens=True) == j.decode(ids, skip_special_tokens=True)


def test_save_load_and_default_match_jax(tokenizers, tmp_path):
    _, t = tokenizers
    t.save(str(tmp_path))
    jl, tl = jbpe.load_or_train_default(str(tmp_path)), tbpe.load_or_train_default(str(tmp_path))
    assert tl.vocab == jl.vocab and tl.special_tokens == jl.special_tokens
    for text in TEXTS:
        assert tl.encode(text) == jl.encode(text)
    with pytest.raises(ValueError):
        tbpe.load_or_train_default(None)


def _clone(tok, use_native):
    merges = [m for m, _ in sorted(tok.merge_ranks.items(), key=lambda kv: kv[1])]
    return tbpe.BPETokenizer(tok.vocab, merges, special_tokens=list(tok.special_tokens),
                             use_native=use_native)


def test_native_merge_matches_python(tokenizers):
    """The merge loop of cpp/bpe_core.cpp, built into the port's build
    directory, gives the Python loop's ids."""
    _, t = tokenizers
    nat, py = _clone(t, True), _clone(t, False)
    assert nat.native_loaded and not py.native_loaded
    assert tnative.LIB_PATH.exists() and tnative.LIB_PATH.parent.name == "_build"
    rng = np.random.default_rng(0)
    words = " ".join(CORPUS).split()
    texts = TEXTS + [" ".join(rng.choice(words, 30)) for _ in range(20)]
    for text in texts:
        assert nat.encode(text) == py.encode(text), text


PRETOKEN_CASES = ["don't", "I'm", "we'll've", "'s's", "  two spaces", "trailing  ",
                  "\t\n  x", "a1b2", "1,000.5", "x\u3000y", "\x1cA\x1f", "emoji😀😀 ok",
                  "Ⅻ ½ ²", "naïve café — déjà vu, 東京"]


@pytest.mark.parametrize("text", PRETOKEN_CASES)
def test_pretokens_match_jax(text):
    """GPT-2's split pattern: contractions, letter and number runs under
    ``\\p{L}``/``\\p{N}``, and whitespace that leaves one space to the
    next word."""
    assert tbpe._PRETOKEN_RE.findall(text) == jbpe._PRETOKEN_RE.findall(text)


def test_tokenize_dialogues_and_text2ids_match_jax(tokenizers, tmp_path):
    _, t = tokenizers
    dialogues = [["hello there", ["how are you", "extra-field"]], ["doing today 😀"],
                 [CORPUS[1], CORPUS[4]]]
    assert tt2i.tokenize_dialogues(dialogues, t) == jt2i.tokenize_dialogues(dialogues, t)
    tok_dir = tmp_path / "tok"
    t.save(str(tok_dir))
    out = {}
    for name, mod in (("jax", jt2i), ("port", tt2i)):
        d = tmp_path / name
        d.mkdir()
        for prefix in ("train", "valid"):
            with open(d / f"{prefix}_sent_emo.json", "w") as f:
                json.dump(dialogues, f)
        mod.main([f"--data_dir={d}", "--prefixes=train,valid,test",
                  f"--tokenizer_dir={tok_dir}"])
        with open(d / "valid_sent_emo_ids.json") as f:
            out[name] = json.load(f)
        assert not (d / "test_sent_emo_ids.json").exists()
    assert out["port"] == out["jax"]
