"""GPT-2 byte-level BPE tokenizer (a copy of ``ergm_tpu/tokenizer/bpe.py``;
the port imports nothing of ``ergm_tpu``).

The reference depends on HF ``GPT2Tokenizer.from_pretrained`` downloads
(src/main.py:46); this implementation is file-based: load a standard
``vocab.json`` + ``merges.txt`` pair (byte-identical behavior to GPT-2's
tokenizer on the same files) or train a new BPE on a corpus
(``train_bpe``) for fully-offline/synthetic setups.

The C++ merge loop of ``cpp/bpe_core.cpp`` (``tokenizer/native.py``)
takes encode()'s merges when it builds; this module's Python loop is the
reference and the fallback.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import regex as re

from ergm_tpu_torch.core.tokens import ADDITIONAL_SPECIAL_TOKENS, EOS_TOKEN

# GPT-2 pre-tokenization pattern (splits contractions, letter runs,
# number runs, punctuation, whitespace).
_PRETOKEN_RE = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte->printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


@lru_cache()
def unicode_to_bytes() -> Dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


class BPETokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        special_tokens: Optional[Iterable[str]] = None,
        use_native: bool = True,
    ):
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.merge_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = unicode_to_bytes()
        self._bpe_cache: Dict[str, Tuple[str, ...]] = {}
        self._id_cache: Dict[str, list] = {}
        # C++ merge kernel (cpp/bpe_core.cpp) for the corpus-encode hot
        # path; absent when the library can't be built (``native_loaded``)
        self._native = None
        if use_native:
            from ergm_tpu_torch.tokenizer.native import NativeBPE

            nat = NativeBPE(self.vocab, merges)
            self._native = nat if nat.available else None
        self.special_tokens: Dict[str, int] = {}
        if special_tokens:
            self.add_special_tokens(special_tokens)
        if EOS_TOKEN in self.vocab:
            self.special_tokens.setdefault(EOS_TOKEN, self.vocab[EOS_TOKEN])
        self._rebuild_special_re()

    # -- special tokens --------------------------------------------------

    def add_special_tokens(self, tokens: Iterable[str]) -> int:
        """Append new special tokens to the vocab (HF add_special_tokens
        semantics — ids in registration order past the current size)."""
        added = 0
        for t in tokens:
            if t not in self.vocab:
                self.vocab[t] = len(self.vocab)
                self.id_to_token[self.vocab[t]] = t
                added += 1
            self.special_tokens[t] = self.vocab[t]
        self._rebuild_special_re()
        return added

    def _rebuild_special_re(self):
        if self.special_tokens:
            alts = "|".join(re.escape(t) for t in
                            sorted(self.special_tokens, key=len, reverse=True))
            self._special_re = re.compile(f"({alts})")
        else:
            self._special_re = None

    # -- core BPE --------------------------------------------------------

    def _bpe(self, token: str) -> Tuple[str, ...]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.merge_ranks.get(p, float("inf")))
            if best not in self.merge_ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        self._bpe_cache[token] = word
        return word

    def _word_ids_python(self, mapped: str) -> List[int]:
        word_ids: List[int] = []
        for piece in self._bpe(mapped):
            if piece in self.vocab:
                word_ids.append(self.vocab[piece])
            else:
                # unseen piece (possible with trained tiny vocabs):
                # fall back to per-character byte tokens
                word_ids.extend(self.vocab[ch] for ch in piece if ch in self.vocab)
        return word_ids

    @property
    def native_loaded(self) -> bool:
        """Whether encode()'s merges run in the C++ library."""
        return self._native is not None and self._native.has_byte_table

    def _encode_ordinary(self, text: str) -> List[int]:
        tokens = _PRETOKEN_RE.findall(text)
        cache = self._id_cache  # keyed by raw pre-token
        misses = [t for t in tokens if t not in cache]
        if misses:
            uniq = list(dict.fromkeys(misses))
            if self._native is not None and self._native.has_byte_table:
                # raw-bytes batch: mapping + merges run in the C++ kernel
                for t, word_ids in zip(
                        uniq, self._native.encode_word_bytes(
                            [u.encode("utf-8") for u in uniq])):
                    cache[t] = word_ids
            else:
                for t in uniq:
                    mapped = "".join(self.byte_encoder[b] for b in t.encode("utf-8"))
                    cache[t] = self._word_ids_python(mapped)
        ids: List[int] = []
        for t in tokens:
            ids.extend(cache[t])
        return ids

    def encode(self, text: str) -> List[int]:
        if self._special_re is None:
            return self._encode_ordinary(text)
        ids: List[int] = []
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self.special_tokens:
                ids.append(self.special_tokens[part])
            else:
                ids.extend(self._encode_ordinary(part))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        special_ids = set(self.special_tokens.values())
        pieces: List[str] = []
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None:
                continue
            if int(i) in special_ids:
                if not skip_special_tokens:
                    pieces.append(tok)
                continue
            pieces.append(tok)
        text = "".join(pieces)
        # map printable-unicode back to bytes where possible (special
        # tokens pass through verbatim)
        data = bytearray()
        for ch in text:
            b = self.byte_decoder.get(ch)
            if b is None:
                data.extend(ch.encode("utf-8"))
            else:
                data.append(b)
        return data.decode("utf-8", errors="replace")

    def __len__(self) -> int:
        return len(self.vocab)

    @property
    def eos_id(self) -> int:
        return self.vocab[EOS_TOKEN]

    # -- persistence -----------------------------------------------------

    def save(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "vocab.json"), "w") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        with open(os.path.join(out_dir, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in sorted(self.merge_ranks.items(), key=lambda kv: kv[1]):
                f.write(f"{a} {b}\n")
        if self.special_tokens:
            with open(os.path.join(out_dir, "special_tokens.json"), "w") as f:
                json.dump(self.special_tokens, f, ensure_ascii=False)

    @classmethod
    def load(cls, in_dir: str) -> "BPETokenizer":
        with open(os.path.join(in_dir, "vocab.json")) as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(in_dir, "merges.txt")) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        specials = None
        sp_path = os.path.join(in_dir, "special_tokens.json")
        if os.path.exists(sp_path):
            with open(sp_path) as f:
                specials = list(json.load(f).keys())
        return cls(vocab, merges, special_tokens=specials)


def train_bpe(
    corpus: Iterable[str],
    vocab_size: int,
    special_tokens: Optional[Sequence[str]] = None,
) -> BPETokenizer:
    """Train a byte-level BPE: 256 byte symbols + merges until vocab_size.

    Tiny/offline counterpart of the GPT-2 tokenizer build; the merge rule
    (most frequent adjacent pair wins, ties by first occurrence) matches
    the standard BPE algorithm.
    """
    byte_enc = bytes_to_unicode()
    base = sorted(byte_enc.values())
    vocab: Dict[str, int] = {s: i for i, s in enumerate(base)}
    if EOS_TOKEN not in vocab:
        vocab[EOS_TOKEN] = len(vocab)

    # word frequency over pre-tokens
    word_freq: Dict[Tuple[str, ...], int] = {}
    for text in corpus:
        for tok in _PRETOKEN_RE.findall(text):
            mapped = tuple(byte_enc[b] for b in tok.encode("utf-8"))
            word_freq[mapped] = word_freq.get(mapped, 0) + 1

    merges: List[Tuple[str, str]] = []
    words = dict(word_freq)
    while len(vocab) < vocab_size:
        pair_freq: Dict[Tuple[str, str], int] = {}
        for w, f in words.items():
            for p in zip(w, w[1:]):
                pair_freq[p] = pair_freq.get(p, 0) + f
        if not pair_freq:
            break
        best = max(pair_freq.items(), key=lambda kv: kv[1])[0]
        merges.append(best)
        merged = best[0] + best[1]
        vocab[merged] = len(vocab)
        new_words: Dict[Tuple[str, ...], int] = {}
        for w, f in words.items():
            out: List[str] = []
            i = 0
            while i < len(w):
                if i < len(w) - 1 and w[i] == best[0] and w[i + 1] == best[1]:
                    out.append(merged)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            t = tuple(out)
            new_words[t] = new_words.get(t, 0) + f
        words = new_words

    tok = BPETokenizer(vocab, merges)
    if special_tokens:
        tok.add_special_tokens(special_tokens)
    return tok


def load_or_train_default(tokenizer_dir: Optional[str]) -> BPETokenizer:
    """Load GPT-2-format tokenizer files from ``tokenizer_dir`` and attach
    the canonical special-token registry (core/tokens.py)."""
    if tokenizer_dir is None:
        raise ValueError("tokenizer_dir is required (no network downloads here)")
    tok = BPETokenizer.load(tokenizer_dir)
    tok.add_special_tokens(ADDITIONAL_SPECIAL_TOKENS)
    return tok
