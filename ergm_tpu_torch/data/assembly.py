"""A copy of ``ergm_tpu/data/assembly.py`` (the port imports nothing of ``ergm_tpu``).

Dialogue-window assembly: raw tokenized dialogues -> reference pickle schema.

The reference README promises a data-building step via
``src/scripts/load_data.py`` that the repo does not contain
(load_data.sh:1; SURVEY.md §2.4.1). Its *output* schema is fixed by the
consumer (src/custom_dataset.py:14-28):

    multi_{prefix}_data.pkl          {"txt", "img", "aud", "label"}
    context_label_{prefix}_data.pkl  {"context", "label"}

where, for dialogue ``i`` with utterances ``0..n-1``:

- ``txt[i][j]`` is the *window* for target j: a list of per-turn
  token-id lists that custom_dataset.py:49 chain-flattens, and whose
  sublist parity drives the sp1/sp2 token-type assignment
  (custom_dataset.py:55-56),
- ``label[i][j]`` (in multi_*) is the stored *target* sequence, from
  which labels are derived as ``target[2:-2] + [eos]`` and left-padded
  with -100 to the window length (custom_dataset.py:59-70),
- ``img[i]`` / ``aud[i]`` are per-clip feature lists; the dataset uses
  element 0 (custom_dataset.py:77-80),
- ``context[i][j]`` is the human-readable window text,
- context_label ``label[i][j]`` is the emotion id of utterance j.

This module defines the assembly convention (the part the reference
leaves unspecified) so that the *derived* labels line up with standard
next-token prediction under the reference's exact slicing:

- turn 0 is stored as ``[bos, sp] + ids``; later turns as ``[sp] + ids``
  where the speaker marker alternates sp1/sp2 by window-local parity
  (matching the token-type rule);
- the target turn j is stored in the window as its turn form plus a
  trailing ``eos``;
- the stored target is ``[bos, sp] + ids + [eos, eos]`` so that
  ``target[2:-2] + [eos] == ids + [eos]``, which after left-padding
  aligns token-for-token with the window tail. Under the shifted CE
  (logits[:-1] vs labels[1:]) this supervises exactly "predict each
  response token and the closing eos".

Caption conditioning (src/model.py:460-463, 311-329): the reference's
per-block cross-attention consumes ``caption_ids`` — token ids of the
clip's image caption wrapped in ``<cap_bos> … <cap_eos>``
(src/scripts/text2ids.py:23-28) — but its data path never produces
them (SURVEY.md §2.4.2). Here ``assemble_split`` optionally emits
``multi["cap"][i][j]``: the marker-wrapped caption ids for utterance j
of dialogue i. The extra key is invisible to the reference consumer
(custom_dataset.py reads only txt/img/aud/label), so the pickle stays
schema-compatible.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

from ergm_tpu_torch.core.tokens import SpecialTokens


def build_window(
    dialogue_ids: Sequence[Sequence[int]],
    target_idx: int,
    st: SpecialTokens,
    max_turns: Optional[int] = None,
    max_len: Optional[int] = None,
) -> List[List[int]]:
    """Window of turns for predicting utterance ``target_idx``.

    Honors ``max_turns`` (history truncation — declared but unused in the
    reference, src/main.py:356; SURVEY.md §2.4.8) and optionally drops
    oldest turns until the flattened window fits ``max_len``.
    """
    start = 0
    if max_turns is not None:
        start = max(0, target_idx + 1 - max_turns)

    def assemble(s: int) -> List[List[int]]:
        window = []
        for c, t in enumerate(range(s, target_idx + 1)):
            sp = st.sp1_id if c % 2 == 0 else st.sp2_id
            turn = [sp] + list(dialogue_ids[t])
            if c == 0:
                turn = [st.bos_id] + turn
            if t == target_idx:
                turn = turn + [st.eos_id]
            window.append(turn)
        return window

    window = assemble(start)
    if max_len is not None:
        while start < target_idx and sum(len(t) for t in window) >= max_len:
            start += 1
            window = assemble(start)
    return window


def build_target(utter_ids: Sequence[int], st: SpecialTokens, speaker_id: Optional[int] = None) -> List[int]:
    """Stored target: [bos, sp] + ids + [eos, eos], built so the reference
    slice target[2:-2] + [eos] recovers ids + [eos]."""
    sp = st.sp2_id if speaker_id is None else speaker_id
    return [st.bos_id, sp] + list(utter_ids) + [st.eos_id, st.eos_id]


def build_caption(caption_ids: Sequence[int], st: SpecialTokens) -> List[int]:
    """Wrap raw caption token ids in the caption markers
    (src/scripts/text2ids.py:23-28 registers <cap_bos>/<cap_eos>)."""
    if st.cap_bos_id < 0 or st.cap_eos_id < 0:
        raise ValueError("caption markers not registered; use SpecialTokens.register")
    return [st.cap_bos_id] + list(caption_ids) + [st.cap_eos_id]


def assemble_split(
    dialogues_ids: Sequence[Sequence[Sequence[int]]],
    emotion_labels: Sequence[Sequence[int]],
    st: SpecialTokens,
    img_features: Optional[Sequence] = None,
    aud_features: Optional[Sequence] = None,
    contexts: Optional[Sequence[Sequence[str]]] = None,
    captions: Optional[Sequence[Sequence[Sequence[int]]]] = None,
    max_turns: Optional[int] = None,
    max_len: Optional[int] = None,
    feature_dim: int = 768,
) -> Dict[str, dict]:
    """Assemble one split into the two reference pickle payloads.

    ``dialogues_ids[i][t]`` = token ids of utterance t of dialogue i.
    ``img_features[i]`` / ``aud_features[i]`` = per-clip feature vectors
    for dialogue i (list or array); zeros are substituted when absent so
    the schema stays complete (text-only corpora).
    ``captions[i][t]`` = raw caption token ids for the clip of utterance
    t (e.g. from BLIP captioning of the keyframe); when given, the multi
    payload gains a ``cap`` key with marker-wrapped ids.
    """
    import numpy as np

    txt, tgt = [], []
    ctx_out, emo_out = [], []
    imgs_out, auds_out = [], []
    caps_out = [] if captions is not None else None
    for i, dia in enumerate(dialogues_ids):
        emos = emotion_labels[i]
        if len(dia) != len(emos):
            raise ValueError(f"dialogue {i}: {len(dia)} utterances vs {len(emos)} emotion labels")
        windows, targets, ctxs = [], [], []
        for j in range(len(dia)):
            windows.append(build_window(dia, j, st, max_turns=max_turns, max_len=max_len))
            speaker = st.sp1_id if j % 2 == 0 else st.sp2_id
            targets.append(build_target(dia[j], st, speaker_id=speaker))
            if contexts is not None:
                ctxs.append(contexts[i][j])
            else:
                ctxs.append("")
        txt.append(windows)
        tgt.append(targets)
        ctx_out.append(ctxs)
        emo_out.append(list(emos))
        if caps_out is not None:
            if len(captions[i]) != len(dia):
                raise ValueError(
                    f"dialogue {i}: {len(dia)} utterances vs {len(captions[i])} captions")
            caps_out.append([build_caption(c, st) for c in captions[i]])
        if img_features is not None and i < len(img_features) and len(img_features[i]):
            imgs_out.append([np.asarray(f, np.float32).reshape(-1) for f in img_features[i]])
        else:
            imgs_out.append([np.zeros((feature_dim,), np.float32)])
        if aud_features is not None and i < len(aud_features) and len(aud_features[i]):
            auds_out.append([np.asarray(f, np.float32).reshape(-1) for f in aud_features[i]])
        else:
            auds_out.append([np.zeros((feature_dim,), np.float32)])

    multi = {"txt": txt, "img": imgs_out, "aud": auds_out, "label": tgt}
    if caps_out is not None:
        multi["cap"] = caps_out
    return {
        "multi": multi,
        "context_label": {"context": ctx_out, "label": emo_out},
    }


def write_split(payloads: Dict[str, dict], data_dir: str, prefix: str) -> None:
    """Write the two pickles with the reference's exact filenames
    (src/custom_dataset.py:14-15)."""
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, f"multi_{prefix}_data.pkl"), "wb") as f:
        pickle.dump(payloads["multi"], f)
    with open(os.path.join(data_dir, f"context_label_{prefix}_data.pkl"), "wb") as f:
        pickle.dump(payloads["context_label"], f)


META_FILENAME = "tokenizer_meta.json"


def write_meta(st: SpecialTokens, data_dir: str) -> None:
    """Persist resolved special-token ids + vocab size next to the pickles,
    so training/inference need not re-load a tokenizer just for ids (the
    reference re-derives them from GPT2Tokenizer every run,
    src/main.py:46-58)."""
    import dataclasses
    import json

    os.makedirs(data_dir, exist_ok=True)
    payload = dataclasses.asdict(st)
    payload["emotion_ids"] = list(st.emotion_ids)
    with open(os.path.join(data_dir, META_FILENAME), "w") as f:
        json.dump(payload, f, indent=1)


def read_meta(data_dir: str) -> SpecialTokens:
    import json

    with open(os.path.join(data_dir, META_FILENAME)) as f:
        payload = json.load(f)
    payload["emotion_ids"] = tuple(payload["emotion_ids"])
    return SpecialTokens(**payload)
