"""A copy of ``ergm_tpu/data/synthetic.py`` (the port imports nothing of ``ergm_tpu``).

Synthetic dataset fixture in the exact reference pickle schema.

Stands in for MELD/IEMOCAP/MEDIC (README.md:30-32) in tests and
benchmarks: random "dialogues" over a configurable vocab, random
768-d modality features, and emotion labels, assembled through the same
ergm_tpu_torch.data.assembly code path real data uses — so the fixture also
exercises the load_data assembly step (SURVEY.md §4's "tiny synthetic pickle
fixture standing in for MELD").
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ergm_tpu_torch.core.tokens import SpecialTokens
from ergm_tpu_torch.data.assembly import assemble_split, write_split


def synthetic_vocab(base_size: int = 256) -> Dict[str, int]:
    """A tiny vocab whose ids 0..base_size-1 are 'words'; eos uses the
    GPT-2 convention of living inside the base vocab."""
    vocab = {f"w{i}": i for i in range(base_size - 1)}
    vocab["<|endoftext|>"] = len(vocab)
    return vocab


def make_synthetic_split(
    num_dialogues: int = 4,
    turns_per_dialogue: int = 4,
    utter_len: range = range(3, 9),
    feature_dim: int = 768,
    base_vocab_size: int = 256,
    seed: int = 0,
    st: Optional[SpecialTokens] = None,
    max_turns: Optional[int] = None,
    max_len: Optional[int] = 1024,
    captions: Optional[str] = None,
):
    """Returns (payloads, SpecialTokens). ``payloads`` has the two pickle
    dicts (see assembly.assemble_split).

    ``captions``: None (no cap key), "random" (independent random ids —
    uninformative conditioning), or "target" (caption = the utterance's
    own token ids, a caption-PREDICTABLE task: a model whose
    cross-attention works can copy the answer out of the caption, so
    training with captions must beat training without — the end-to-end
    proof that conditioning is wired, src/model.py:460-463).
    """
    rng = np.random.default_rng(seed)
    if st is None:
        vocab = synthetic_vocab(base_vocab_size)
        st = SpecialTokens.register(vocab)
    word_ids = np.arange(base_vocab_size - 1)

    dialogues, emotions, contexts = [], [], []
    imgs, auds = [], []
    caps = [] if captions else None
    for _ in range(num_dialogues):
        n_turns = turns_per_dialogue
        dia = [list(rng.choice(word_ids, size=rng.integers(utter_len.start, utter_len.stop)))
               for _ in range(n_turns)]
        dialogues.append([[int(t) for t in u] for u in dia])
        emotions.append([int(e) for e in rng.integers(0, 7, size=n_turns)])
        contexts.append([f"utterance {t}" for t in range(n_turns)])
        n_clips = 2
        imgs.append([rng.standard_normal(feature_dim).astype(np.float32) for _ in range(n_clips)])
        auds.append([rng.standard_normal(feature_dim).astype(np.float32) for _ in range(n_clips)])
        if captions == "target":
            caps.append([[int(t) for t in u] for u in dia])
        elif captions == "random":
            caps.append([
                [int(t) for t in rng.choice(word_ids, size=len(u))] for u in dia])
        elif captions is not None:
            raise ValueError(f"unknown captions mode {captions!r}")

    payloads = assemble_split(
        dialogues, emotions, st,
        img_features=imgs, aud_features=auds, contexts=contexts,
        captions=caps,
        max_turns=max_turns, max_len=max_len, feature_dim=feature_dim,
    )
    return payloads, st


def write_synthetic_dataset(data_dir: str, prefixes=("train", "valid"), **kw):
    """Write synthetic pickles for the given split prefixes; returns the
    SpecialTokens used (shared across splits)."""
    st = kw.pop("st", None)
    seed = kw.pop("seed", 0)
    for i, prefix in enumerate(prefixes):
        payloads, st = make_synthetic_split(seed=seed + i, st=st, **kw)
        write_split(payloads, data_dir, prefix)
    from ergm_tpu_torch.data.assembly import write_meta

    write_meta(st, data_dir)
    return st
