"""A copy of ``ergm_tpu/data/dataset.py`` (the port imports nothing of ``ergm_tpu``).

Dialogue dataset + static-shape batching for XLA.

Re-implements the reference's dataset semantics (src/custom_dataset.py)
torch-free, and replaces dynamic per-batch padding with bucketed static
shapes so every batch hits a cached XLA executable:

- loads ``multi_{prefix}_data.pkl`` / ``context_label_{prefix}_data.pkl``
  (custom_dataset.py:14-28),
- flattens dialogues into per-utterance examples with the reference's
  exact rules: chain-flatten the window (49), skip >=1024 (51-52),
  sp1/sp2 token types by window-sublist parity (55-56), labels =
  target[2:-2] + [eos] left-padded with -100 / inputs extended with eos
  on overshoot (59-70), per-dialogue first-clip img/aud feature (77-80),
- pads batches with eos (ids/token types) and -100 (labels)
  (custom_dataset.py:120-122), but to bucketed lengths (multiples of
  ``pad_multiple``, capped at ``max_len``) instead of the batch max.

The reference's ``[:1]`` debug truncation (custom_dataset.py:21, 27;
SURVEY.md §2.4.6) becomes an explicit ``limit`` argument, default off.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import warnings
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

IGNORE_INDEX = -100


@dataclass
class Example:
    input_ids: List[int]
    token_type_ids: List[int]
    labels: List[int]
    img: np.ndarray  # [D]
    aud: np.ndarray  # [D]
    context: str
    emotion_label: int
    # marker-wrapped caption token ids for the clip (multi["cap"][i][j],
    # assembly.build_caption); None on caption-less corpora
    caption_ids: Optional[List[int]] = None


@dataclass
class Batch:
    """Static-shape numpy batch; ``valid`` marks real (non-repeated) rows so
    eval metrics can ignore fill added to complete the final batch."""

    input_ids: np.ndarray  # [B, L] int32
    token_type_ids: np.ndarray  # [B, L] int32
    labels: np.ndarray  # [B, L] int32
    imgs: np.ndarray  # [B, D] float32
    auds: np.ndarray  # [B, D] float32
    emotion_labels: np.ndarray  # [B] int32
    attention_mask: np.ndarray  # [B, L] float32, 1 on real tokens
    valid: np.ndarray  # [B] bool
    contexts: List[str]
    caption_ids: Optional[np.ndarray] = None  # [B, Lc] int32, eos-padded
    caption_mask: Optional[np.ndarray] = None  # [B, Lc] float32, 1 on real

    def pin_memory(self) -> "Batch":
        """A copy whose arrays are page-locked CPU tensors, so that their copy
        to the card runs asynchronously (``torch.utils.data.DataLoader`` calls
        this in its pinning thread under ``pin_memory=True``)."""
        import torch

        return dataclasses.replace(self, **{
            f.name: torch.from_numpy(getattr(self, f.name)).pin_memory()
            for f in dataclasses.fields(self) if isinstance(getattr(self, f.name), np.ndarray)})


def _feat(x) -> np.ndarray:
    a = np.asarray(x, dtype=np.float32)
    return a.reshape(-1)


class DialogueDataset:
    def __init__(
        self,
        prefix: str,
        data_dir: str,
        sp1_id: int,
        sp2_id: int,
        eos_id: int,
        max_len: int = 1024,
        limit: Optional[int] = None,
    ):
        data_path = os.path.join(data_dir, f"multi_{prefix}_data.pkl")
        context_path = os.path.join(data_dir, f"context_label_{prefix}_data.pkl")
        with open(data_path, "rb") as f:
            data = pickle.load(f)
        with open(context_path, "rb") as f:
            context_label = pickle.load(f)

        texts = data["txt"][:limit] if limit else data["txt"]
        videos = data["img"][:limit] if limit else data["img"]
        audios = data["aud"][:limit] if limit else data["aud"]
        targets = data["label"][:limit] if limit else data["label"]
        caps = data.get("cap")  # optional caption ids (assembly docstring)
        if caps is not None and limit:
            caps = caps[:limit]
        contexts_data = context_label["context"][:limit] if limit else context_label["context"]
        emotions_data = context_label["label"][:limit] if limit else context_label["label"]

        self.examples: List[Example] = []
        for i in range(len(texts)):
            dia_texts, dia_targets = texts[i], targets[i]
            dia_ctx, dia_emo = contexts_data[i], emotions_data[i]
            assert len(dia_texts) == len(dia_targets) == len(dia_ctx) == len(dia_emo)
            img_f = _feat(videos[i][0])
            aud_f = _feat(audios[i][0])
            for j in range(len(dia_texts)):
                window = dia_texts[j]
                input_ids = [t for turn in window for t in turn]
                if len(input_ids) >= max_len:  # custom_dataset.py:51-52
                    continue
                token_types = [
                    sp1_id if c % 2 == 0 else sp2_id
                    for c, turn in enumerate(window)
                    for _ in turn
                ]
                labels = list(dia_targets[j][2:-2]) + [eos_id]  # custom_dataset.py:60
                gap = len(input_ids) - len(labels)
                if gap > 0:
                    labels = [IGNORE_INDEX] * gap + labels
                elif gap < 0:
                    input_ids = input_ids + [eos_id] * (-gap)
                    token_types = token_types + [token_types[-1]] * (-gap)
                assert len(input_ids) == len(labels) == len(token_types)
                cap = [int(t) for t in caps[i][j]] if caps is not None else None
                self.examples.append(Example(
                    input_ids=input_ids, token_type_ids=token_types, labels=labels,
                    img=img_f, aud=aud_f, context=dia_ctx[j], emotion_label=int(dia_emo[j]),
                    caption_ids=cap,
                ))

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, idx: int) -> Example:
        return self.examples[idx]


class Subset:
    """Index-selected view over a dataset (no example copies). Used for
    per-host sharding of the plain (num_workers=0) loader path — every
    process must iterate a DISJOINT equal-length slice, mirroring
    grain_loader's shard rule, or multi-host training silently trains on
    each example process_count times."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> Example:
        return self.dataset[self.indices[idx]]


def host_shard_order(
    n: int, host_index: int, host_count: int,
    shuffle: bool = False, seed: int = 0,
) -> np.ndarray:
    """Global-shuffle-then-shard index assignment for one host.

    The global index space is shuffled FIRST (epoch-seeded) and sharded
    after, so examples re-mix across hosts every epoch like a global
    DataLoader shuffle would; shard-then-shuffle would pin each example
    to one host forever. Shards are strided and truncated to the minimum
    per-host length so every host iterates the same batch count (the
    collective steps deadlock otherwise)."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    per_host = n // max(host_count, 1)
    return order[host_index::host_count][:per_host]


def _bucket_len(n: int, pad_multiple: int, max_len: int) -> int:
    b = ((n + pad_multiple - 1) // pad_multiple) * pad_multiple
    return min(b, max_len)


def collate(
    examples: List[Example],
    eos_id: int,
    batch_size: int,
    pad_multiple: int = 128,
    max_len: int = 1024,
    static: bool = False,
    static_caps: Optional[bool] = None,
    static_cap_len: int = 256,
    rows: Optional[Tuple[int, int]] = None,
) -> Batch:
    """Pad a list of examples to a static [batch_size, bucketed_len] batch.

    ``rows=(lo, hi)``: only rows [lo, hi) of that batch (a data-parallel
    rank's), padded as the whole batch is (its lengths, caption bucket
    and caption presence are the whole batch's), so the ranks' rows put
    together are the whole batch.

    Fill semantics match the reference collator (eos for ids/token types,
    -100 for labels; custom_dataset.py:120-122). Short batches are
    completed by repeating the final example with ``valid=False``.

    ``static=True`` (multi-host): pad to ``max_len`` (and captions to
    ``static_cap_len``) instead of the local batch's longest example —
    every process must build the SAME global array shape for
    ``jax.make_array_from_process_local_data``, and per-host dynamic
    buckets would diverge. ``static_caps`` likewise pins whether the
    caption arrays exist (a host whose local batch happens to lack
    captions must not produce a different batch pytree structure).
    """
    n = len(examples)
    assert 0 < n <= batch_size
    longest = max(len(e.input_ids) for e in examples)
    L = max_len if static else _bucket_len(longest, pad_multiple, max_len)
    D = examples[0].img.shape[0]
    lo, hi = (0, batch_size) if rows is None else rows
    nrows = hi - lo

    ids = np.full((nrows, L), eos_id, np.int32)
    tts = np.full((nrows, L), eos_id, np.int32)
    lbl = np.full((nrows, L), IGNORE_INDEX, np.int32)
    mask = np.zeros((nrows, L), np.float32)
    imgs = np.zeros((nrows, D), np.float32)
    auds = np.zeros((nrows, D), np.float32)
    emo = np.zeros((nrows,), np.int32)
    valid = np.zeros((nrows,), bool)
    contexts: List[str] = []

    # captions: static [B, Lc] bucket when any example carries them
    # (eos-pad like ids, mask 0 on pads; cross-attn masks pads out)
    has_caps = (any(e.caption_ids is not None for e in examples)
                if static_caps is None else static_caps)
    cap_ids = cap_mask = None
    if has_caps:
        if static:
            Lc = min(static_cap_len, max_len)
        else:
            longest_cap = max(len(e.caption_ids or []) for e in examples)
            Lc = _bucket_len(max(longest_cap, 1), min(pad_multiple, 32), max_len)
        cap_ids = np.full((nrows, Lc), eos_id, np.int32)
        cap_mask = np.zeros((nrows, Lc), np.float32)

    for row in range(lo, hi):
        e = examples[min(row, n - 1)]
        b = row - lo
        k = min(len(e.input_ids), L)
        ids[b, :k] = e.input_ids[:k]
        tts[b, :k] = e.token_type_ids[:k]
        lbl[b, :k] = e.labels[:k]
        mask[b, :k] = 1.0
        imgs[b] = e.img
        auds[b] = e.aud
        emo[b] = e.emotion_label
        valid[b] = row < n
        contexts.append(e.context)
        if has_caps and e.caption_ids:
            kc = min(len(e.caption_ids), cap_ids.shape[1])
            if len(e.caption_ids) > cap_ids.shape[1]:
                # silent truncation would mean the same dataset trains on
                # different caption content by host count (ADVICE r2); name
                # the bound that actually applied on this path
                bound = ("static_cap_len (static multi-host collation); "
                         "raise static_cap_len" if static
                         else "max_len (dynamic caption bucket); raise max_len")
                warnings.warn(
                    f"caption truncated {len(e.caption_ids)} -> "
                    f"{cap_ids.shape[1]} tokens by {bound} to keep full "
                    f"captions")
            cap_ids[b, :kc] = e.caption_ids[:kc]
            cap_mask[b, :kc] = 1.0
    return Batch(input_ids=ids, token_type_ids=tts, labels=lbl, imgs=imgs,
                 auds=auds, emotion_labels=emo, attention_mask=mask,
                 valid=valid, contexts=contexts,
                 caption_ids=cap_ids, caption_mask=cap_mask)


def batch_order(
    dataset: DialogueDataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
    static: bool = False,
    length_grouped: int = 0,
) -> List[np.ndarray]:
    """The example indices of each batch ``batches`` yields, in order (the
    plain iterator and ``data/loader.py``'s workers share it)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    starts = list(range(0, len(order), batch_size))
    if length_grouped > 1 and not static and len(order) > batch_size:
        mega = length_grouped * batch_size
        lens = np.array([len(dataset[i].input_ids) for i in order])
        order = np.concatenate([
            order[s:s + mega][np.argsort(lens[s:s + mega], kind="stable")]
            for s in range(0, len(order), mega)])
        if shuffle:
            full = [s for s in starts if s + batch_size <= len(order)]
            tail = [s for s in starts if s + batch_size > len(order)]
            np.random.default_rng(seed + 1).shuffle(full)
            starts = full + tail
    out = []
    for s in starts:
        idx = order[s:s + batch_size]
        if drop_remainder and len(idx) < batch_size:
            break
        out.append(idx)
    return out


def batches(
    dataset: DialogueDataset,
    batch_size: int,
    eos_id: int,
    shuffle: bool = False,
    seed: int = 0,
    pad_multiple: int = 128,
    max_len: int = 1024,
    drop_remainder: bool = False,
    static: bool = False,
    static_caps: Optional[bool] = None,
    length_grouped: int = 0,
) -> Iterator[Batch]:
    """Host-side batch iterator (the reference's DataLoader role,
    src/main.py:78-85). Sorting-free by default; bucketing keeps the
    number of distinct compiled shapes <= max_len/pad_multiple.
    ``static``/``static_caps``: see collate (multi-host shape pinning).

    ``length_grouped=K`` (K > 1): after the epoch shuffle, sort examples
    by length within megabatches of K*batch_size before slicing into
    batches, then shuffle the BATCH order (so an epoch is not a
    short-to-long curriculum). Similar-length rows land in the same
    bucket, cutting pad compute the reference's uniform shuffle burns:
    on a MELD-like length mix the real/padded token ratio goes
    0.358 -> 0.67 at pad_multiple=128 (0.80 at 64) with K=32. Ignored
    when ``static=True`` — multi-host pins every batch to max_len, so
    grouping cannot change shapes there."""
    for idx in batch_order(dataset, batch_size, shuffle=shuffle, seed=seed,
                           drop_remainder=drop_remainder, static=static,
                           length_grouped=length_grouped):
        yield collate([dataset[i] for i in idx], eos_id, batch_size, pad_multiple, max_len,
                      static=static, static_caps=static_caps)
