"""A copy of ``ergm_tpu/core/tokens.py`` (the port imports nothing of ``ergm_tpu``).

Canonical special-token registry.

The reference scatters three mutually inconsistent special-token sets
across its scripts (SURVEY.md §2.4.13):

- src/main.py:47-50 adds only ``<bos> <sp1> <sp2>``;
- src/scripts/text2ids.py:12-28 additionally adds ``<img> <aud>
  <cap_bos> <cap_eos>`` and seven emotion tokens;
- src/scripts/sentence_to_ids.py:10-11 spells the caption markers
  ``<bos_cap>/<eos_cap>``.

This module is the single source of truth for the rebuild: the union of
the sets, with text2ids.py's spelling winning for the caption markers.
IDs are assigned past the base vocab in registry order, matching how HF
``add_special_tokens`` appends (so a converter from a reference-trained
checkpoint sees identical ids if the same registration order was used).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

# Emotion vocabulary; order defines the 7 class ids
# (reference: src/scripts/emotion_labels.py:9).
EMOTION_LIST = ["anger", "disgust", "fear", "joy", "neutral", "sadness", "surprise"]
EMOTION_TO_ID = {e: i for i, e in enumerate(EMOTION_LIST)}
# Sentiment vocabulary (reference: src/scripts/emotion_labels.py:11).
SENTIMENT_LIST = ["neutral", "positive", "negative"]
SENTIMENT_TO_ID = {s: i for i, s in enumerate(SENTIMENT_LIST)}

# GPT-2's native eos; also used as the pad token by the reference
# collator (src/custom_dataset.py:120-122).
EOS_TOKEN = "<|endoftext|>"

BOS_TOKEN = "<bos>"
SP1_TOKEN = "<sp1>"
SP2_TOKEN = "<sp2>"
IMG_TOKEN = "<img>"
AUD_TOKEN = "<aud>"
CAP_BOS_TOKEN = "<cap_bos>"
CAP_EOS_TOKEN = "<cap_eos>"
EMOTION_TOKENS = [f"<{e}>" for e in EMOTION_LIST]

# Registration order: core conversational tokens first (matching
# src/main.py:47-50 so trained-checkpoint vocab ids line up), then the
# media/caption/emotion extensions from text2ids.py:23-28.
ADDITIONAL_SPECIAL_TOKENS: List[str] = [
    BOS_TOKEN,
    SP1_TOKEN,
    SP2_TOKEN,
    IMG_TOKEN,
    AUD_TOKEN,
    CAP_BOS_TOKEN,
    CAP_EOS_TOKEN,
    *EMOTION_TOKENS,
]


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Resolved special-token ids for a concrete tokenizer vocab."""

    bos_id: int
    eos_id: int
    sp1_id: int
    sp2_id: int
    img_id: int
    aud_id: int
    cap_bos_id: int
    cap_eos_id: int
    emotion_ids: tuple
    vocab_size: int

    @classmethod
    def register(cls, base_vocab: Dict[str, int]) -> "SpecialTokens":
        """Append the registry to ``base_vocab`` (mutating it) and resolve ids.

        ``base_vocab`` must already contain ``EOS_TOKEN`` (GPT-2's
        ``<|endoftext|>``). Tokens already present keep their ids.
        """
        if EOS_TOKEN not in base_vocab:
            raise ValueError(f"base vocab must contain {EOS_TOKEN!r}")
        for tok in ADDITIONAL_SPECIAL_TOKENS:
            if tok not in base_vocab:
                base_vocab[tok] = len(base_vocab)
        return cls(
            bos_id=base_vocab[BOS_TOKEN],
            eos_id=base_vocab[EOS_TOKEN],
            sp1_id=base_vocab[SP1_TOKEN],
            sp2_id=base_vocab[SP2_TOKEN],
            img_id=base_vocab[IMG_TOKEN],
            aud_id=base_vocab[AUD_TOKEN],
            cap_bos_id=base_vocab[CAP_BOS_TOKEN],
            cap_eos_id=base_vocab[CAP_EOS_TOKEN],
            emotion_ids=tuple(base_vocab[t] for t in EMOTION_TOKENS),
            vocab_size=len(base_vocab),
        )

    @classmethod
    def minimal(cls, base_vocab: Dict[str, int]) -> "SpecialTokens":
        """Register only ``<bos> <sp1> <sp2>`` like the reference training CLI
        (src/main.py:47-50), still resolving the rest to -1 placeholders."""
        if EOS_TOKEN not in base_vocab:
            raise ValueError(f"base vocab must contain {EOS_TOKEN!r}")
        for tok in (BOS_TOKEN, SP1_TOKEN, SP2_TOKEN):
            if tok not in base_vocab:
                base_vocab[tok] = len(base_vocab)
        get = lambda t: base_vocab.get(t, -1)
        return cls(
            bos_id=base_vocab[BOS_TOKEN],
            eos_id=base_vocab[EOS_TOKEN],
            sp1_id=base_vocab[SP1_TOKEN],
            sp2_id=base_vocab[SP2_TOKEN],
            img_id=get(IMG_TOKEN),
            aud_id=get(AUD_TOKEN),
            cap_bos_id=get(CAP_BOS_TOKEN),
            cap_eos_id=get(CAP_EOS_TOKEN),
            emotion_ids=tuple(get(t) for t in EMOTION_TOKENS),
            vocab_size=len(base_vocab),
        )
