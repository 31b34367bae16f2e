"""A copy of ``ergm_tpu/tools/labels_csv.py`` (the port imports nothing of ``ergm_tpu``).

Generic CSV/TSV dialogue converter -> interchange format.

Closes the last dataset row of the reference's target list: MEDIC
(reference README.md:30-32). The reference ships tooling only for MELD
(src/scripts/emotion_labels.py hard-codes MELD's column names and
7-emotion vocabulary); MEDIC — and any other transcript+label release —
arrives as per-utterance tables with its OWN column names and label
scheme. This tool maps any such table onto the framework's interchange
format (docs/DATASETS.md):

- ``{split}_sent_emo.json`` — list of dialogues, each a list of
  utterance strings (feed to ``ergm_tpu_torch.tools.text2ids``),
- ``emotion_sentiment_labels.pkl`` —
  ``{split: {"emotion": [[ids]], "sentiment": [[ids]]}}`` with labels
  mapped onto the canonical 7-way set (core/tokens.py EMOTION_LIST)
  and sentiment derived from the mapped emotion (same grouping MELD's
  annotations use) unless a sentiment column is given.

Column names are flags; dataset label vocabularies map through
``--label_map`` (``src=dst`` pairs, case-insensitive); rows whose label
is absent from the map follow ``--unmapped`` (neutral | drop | error).
Splits come from per-split CSVs, a split column, or a reproducible
dialogue-level fractional split (``--train_frac``, the surface
load_data.sh:5 promises).

MEDIC example (counseling transcripts; its empathy-mechanism labels
have no exact 7-way counterpart, so the mapping is the user's modeling
decision — this records one reasonable choice rather than hiding it):

    python -m ergm_tpu_torch.tools.labels_csv \
        --csv=medic.csv --dialogue_col=session_id \
        --utterance_col=text --emotion_col=empathy_label \
        --label_map="no_empathy=neutral,cognitive_empathy=neutral,\
affective_empathy=joy,mixed=surprise" \
        --train_frac=0.85 --output_dir=prepared/
"""

from __future__ import annotations

import argparse
import csv as _csv
import json
import os
import pickle
import random
from typing import Dict, List, Optional

from ergm_tpu_torch.core.tokens import EMOTION_TO_ID, SENTIMENT_TO_ID

# same derivation as labels_iemocap.EMOTION_TO_SENTIMENT (MELD grouping)
EMOTION_TO_SENTIMENT = {
    "joy": "positive",
    "anger": "negative",
    "disgust": "negative",
    "fear": "negative",
    "sadness": "negative",
    "neutral": "neutral",
    "surprise": "neutral",
}

SPLITS = ("train", "dev", "test")


def parse_label_map(spec: str) -> Dict[str, str]:
    """``"a=joy,b=neutral"`` -> {"a": "joy", ...} (keys lowercased)."""
    out: Dict[str, str] = {}
    for pair in spec.split(","):
        pair = pair.strip()
        if not pair:
            continue
        if "=" not in pair:
            raise ValueError(f"--label_map entry {pair!r} is not src=dst")
        src, dst = (x.strip().lower() for x in pair.split("=", 1))
        if dst not in EMOTION_TO_ID:
            raise ValueError(
                f"--label_map target {dst!r} is not one of the canonical "
                f"emotions {sorted(EMOTION_TO_ID)}")
        out[src] = dst
    return out


def read_rows(path: str, delimiter: Optional[str] = None) -> List[Dict[str, str]]:
    delim = delimiter or ("\t" if path.endswith((".tsv", ".txt")) else ",")
    with open(path, newline="", encoding="utf-8-sig") as f:
        return list(_csv.DictReader(f, delimiter=delim))


def group_dialogues(rows: List[Dict[str, str]], *, dialogue_col: str,
                    utterance_col: str, emotion_col: str,
                    sentiment_col: Optional[str], order_col: Optional[str],
                    label_map: Dict[str, str], unmapped: str):
    """rows -> (dialogues [[text]], emotion ids [[int]], sentiment ids
    [[int]], skipped count). Grouping is by stable key preserving
    first-appearance order (the same fix labels.py applies over the
    reference's sequential scan); within a dialogue rows sort by
    ``order_col`` when given, else keep file order."""
    for col in (dialogue_col, utterance_col, emotion_col):
        if rows and col not in rows[0]:
            raise KeyError(
                f"column {col!r} not in CSV header {sorted(rows[0])}")
    order: List[str] = []
    by_d: Dict[str, List[Dict[str, str]]] = {}
    for r in rows:
        d = r[dialogue_col]
        if d not in by_d:
            order.append(d)
            by_d[d] = []
        by_d[d].append(r)
    dialogues, emos, sentis = [], [], []
    skipped = 0
    for d in order:
        rs = by_d[d]
        if order_col:
            rs = sorted(rs, key=lambda r: float(r[order_col]))
        utts, e_ids, s_ids = [], [], []
        for r in rs:
            raw = str(r[emotion_col]).strip().lower()
            canonical = label_map.get(raw, raw if raw in EMOTION_TO_ID
                                      else None)
            if canonical is None:
                if unmapped == "error":
                    raise ValueError(
                        f"label {raw!r} not in --label_map and not a "
                        f"canonical emotion; add a mapping or use "
                        f"--unmapped=neutral/drop")
                if unmapped == "drop":
                    skipped += 1
                    continue
                canonical = "neutral"
            text = str(r[utterance_col]).strip()
            if not text:
                skipped += 1
                continue
            if sentiment_col:
                senti = str(r[sentiment_col]).strip().lower()
                if senti not in SENTIMENT_TO_ID:
                    raise ValueError(
                        f"sentiment {senti!r} not in {sorted(SENTIMENT_TO_ID)}")
            else:
                senti = EMOTION_TO_SENTIMENT[canonical]
            utts.append(text)
            e_ids.append(EMOTION_TO_ID[canonical])
            s_ids.append(SENTIMENT_TO_ID[senti])
        if utts:
            dialogues.append(utts)
            emos.append(e_ids)
            sentis.append(s_ids)
    return dialogues, emos, sentis, skipped


def fractional_split(n: int, train_frac: float, seed: int):
    """Dialogue-level reproducible split: train_frac train, the rest
    split evenly into dev/test (load_data.sh:5 passes train_frac)."""
    idx = list(range(n))
    random.Random(seed).shuffle(idx)
    n_train = int(round(n * train_frac))
    rest = idx[n_train:]
    n_dev = len(rest) // 2
    return {"train": set(idx[:n_train]), "dev": set(rest[:n_dev]),
            "test": set(rest[n_dev:])}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a generic per-utterance CSV/TSV dialogue "
                    "table (e.g. MEDIC) to the interchange format")
    p.add_argument("--csv", type=str, default=None,
                   help="Single table; split via --split_col or --train_frac.")
    for s in SPLITS:
        p.add_argument(f"--{s}_csv", type=str, default=None,
                       help=f"Per-split table for the {s} split.")
    p.add_argument("--delimiter", type=str, default=None,
                   help="Field delimiter (default: ',' or tab for .tsv/.txt)")
    p.add_argument("--dialogue_col", type=str, default="Dialogue_ID")
    p.add_argument("--utterance_col", type=str, default="Utterance")
    p.add_argument("--emotion_col", type=str, default="Emotion")
    p.add_argument("--sentiment_col", type=str, default=None,
                   help="Optional; derived from emotion when absent.")
    p.add_argument("--order_col", type=str, default=None,
                   help="Numeric column ordering utterances in a dialogue.")
    p.add_argument("--split_col", type=str, default=None,
                   help="Column holding train/dev/test (with --csv).")
    p.add_argument("--train_frac", type=float, default=None,
                   help="Dialogue-level random split (with --csv); the "
                        "remainder halves into dev/test.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--label_map", type=str, default="",
                   help="src=dst pairs mapping dataset labels onto the "
                        "canonical 7 emotions.")
    p.add_argument("--unmapped", choices=("neutral", "drop", "error"),
                   default="error",
                   help="Rows whose label has no mapping (default: error "
                        "loudly rather than silently relabel).")
    p.add_argument("--output_dir", type=str, default=".")
    args = p.parse_args(argv)

    label_map = parse_label_map(args.label_map)
    kw = dict(dialogue_col=args.dialogue_col, utterance_col=args.utterance_col,
              emotion_col=args.emotion_col, sentiment_col=args.sentiment_col,
              order_col=args.order_col, label_map=label_map,
              unmapped=args.unmapped)

    per_split_files = {s: getattr(args, f"{s}_csv") for s in SPLITS}
    dialogues = {s: [] for s in SPLITS}
    labels = {s: {"emotion": [], "sentiment": []} for s in SPLITS}
    skipped = 0
    if any(per_split_files.values()):
        if args.csv:
            raise ValueError("pass either --csv or per-split --*_csv, not both")
        for s, path in per_split_files.items():
            if not path:
                continue
            ds, es, ss, sk = group_dialogues(
                read_rows(path, args.delimiter), **kw)
            dialogues[s], skipped = ds, skipped + sk
            labels[s] = {"emotion": es, "sentiment": ss}
    elif args.csv:
        rows = read_rows(args.csv, args.delimiter)
        if args.split_col:
            for s in SPLITS:
                sub = [r for r in rows
                       if str(r[args.split_col]).strip().lower() == s]
                ds, es, ss, sk = group_dialogues(sub, **kw)
                dialogues[s], skipped = ds, skipped + sk
                labels[s] = {"emotion": es, "sentiment": ss}
        elif args.train_frac is not None:
            ds, es, ss, sk = group_dialogues(rows, **kw)
            skipped += sk
            assign = fractional_split(len(ds), args.train_frac, args.seed)
            for s in SPLITS:
                keep = assign[s]
                dialogues[s] = [d for i, d in enumerate(ds) if i in keep]
                labels[s] = {
                    "emotion": [e for i, e in enumerate(es) if i in keep],
                    "sentiment": [x for i, x in enumerate(ss) if i in keep]}
        else:
            raise ValueError("--csv needs --split_col or --train_frac")
    else:
        raise ValueError("pass --csv or at least one of --*_csv")

    os.makedirs(args.output_dir, exist_ok=True)
    for s in SPLITS:
        out = os.path.join(args.output_dir, f"{s}_sent_emo.json")
        with open(out, "w") as f:
            json.dump(dialogues[s], f)
        print(f"{s}: {len(dialogues[s])} dialogues, "
              f"{sum(len(d) for d in dialogues[s])} utterances -> {out}")
    pkl = os.path.join(args.output_dir, "emotion_sentiment_labels.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(labels, f)
    print(f"labels -> {pkl} (skipped {skipped} unmapped/empty rows)")


if __name__ == "__main__":
    main()
