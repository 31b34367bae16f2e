"""MELD emotion/sentiment label preparation (a copy of ``ergm_tpu/tools/labels.py``
that reads the CSVs with the standard ``csv`` module in place of pandas).

Capability of src/scripts/emotion_labels.py: parse the MELD CSVs
({train,dev,test}_sent_emo.csv), group rows into dialogues by
Dialogue_ID, map the 7 emotions / 3 sentiments to ids (the canonical
lists live in ergm_tpu_torch/core/tokens.py), and pickle
``{split: {"emotion": [[...]], "sentiment": [[...]]}}``.

Unlike the reference's sequential-scan grouping (which silently merges
dialogues when IDs repeat non-contiguously, emotion_labels.py:38-57),
grouping here is by stable key while preserving first-appearance order.
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle
from typing import Dict, List, Sequence

from ergm_tpu_torch.core.tokens import EMOTION_TO_ID, SENTIMENT_TO_ID


def labels_from_rows(
    dialogue_ids: Sequence,
    emotions: Sequence[str],
    sentiments: Sequence[str],
) -> Dict[str, List[List[int]]]:
    order: List = []
    emo: Dict = {}
    senti: Dict = {}
    for d, e, s in zip(dialogue_ids, emotions, sentiments):
        if d not in emo:
            order.append(d)
            emo[d] = []
            senti[d] = []
        emo[d].append(EMOTION_TO_ID[str(e).strip().lower()])
        senti[d].append(SENTIMENT_TO_ID[str(s).strip().lower()])
    return {"emotion": [emo[d] for d in order],
            "sentiment": [senti[d] for d in order]}


def process_csv(csv_path: str) -> Dict[str, List[List[int]]]:
    with open(csv_path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return labels_from_rows([r["Dialogue_ID"] for r in rows],
                            [r["Emotion"] for r in rows],
                            [r["Sentiment"] for r in rows])


def main(argv=None):
    p = argparse.ArgumentParser(description="Build MELD emotion/sentiment label pickle")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--output_file", type=str, default="./emotion_sentiment_labels.pkl")
    args = p.parse_args(argv)

    results = {}
    for split, fname in (("train", "train_sent_emo.csv"),
                         ("dev", "dev_sent_emo.csv"),
                         ("test", "test_sent_emo.csv")):
        path = os.path.join(args.data_dir, fname)
        if not os.path.exists(path):
            print(f"skip {split}: {path} not found")
            continue
        results[split] = process_csv(path)
        print(f"{split}: {len(results[split]['emotion'])} dialogues")
    if results:
        with open(args.output_file, "wb") as f:
            pickle.dump(results, f)
        print(f"wrote {args.output_file}")


if __name__ == "__main__":
    main()
