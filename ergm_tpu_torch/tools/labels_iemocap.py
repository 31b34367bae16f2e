"""A copy of ``ergm_tpu/tools/labels_iemocap.py`` (the port imports nothing of ``ergm_tpu``).

IEMOCAP -> interchange-format converter (dialogue JSON + label pickle).

The reference targets IEMOCAP (reference README.md:30-32) but ships
tooling only for MELD (src/scripts/emotion_labels.py is CSV-specific;
SURVEY.md §2.1). This tool closes that gap: it walks an IEMOCAP release
tree, pairs each dialogue's ``dialog/EmoEvaluation/*.txt`` category
annotations with its ``dialog/transcriptions/*.txt`` turns, orders
utterances by start time, and emits the framework's interchange format
(docs/DATASETS.md step 3):

- ``{split}_sent_emo.json`` — list of dialogues, each a list of
  utterance strings (feed to ``ergm_tpu_torch.tools.text2ids``); splits are
  named train/dev/test (the MELD convention, so the downstream
  ``load_data`` defaults — ``--valid_split=dev`` — work unchanged),
- one label pickle ``{split: {"emotion": [[ids]], "sentiment":
  [[ids]]}}`` with IEMOCAP's 10-category labels mapped onto the
  framework's canonical 7-way set (core/tokens.py EMOTION_LIST):

      ang->anger  dis->disgust  fea->fear  hap/exc->joy  neu->neutral
      sad->sadness  sur->surprise

  ``fru`` (frustration), ``oth`` and ``xxx`` (no annotator majority)
  have no 7-way counterpart; they map to neutral by default or are
  dropped with ``--drop_unmapped`` (both choices are standard in the
  IEMOCAP literature — pick one and keep it fixed across splits).
  Sentiment is derived from the mapped emotion the same way MELD's
  annotations group them: joy->positive; anger/disgust/fear/sadness->
  negative; neutral/surprise->neutral.

IEMOCAP has no official split; the convention is leave-sessions-out.
``--valid_session``/``--test_session`` (defaults 4 and 5) assign whole
sessions; the rest are train.

    python -m ergm_tpu_torch.tools.labels_iemocap --data_dir=/data/IEMOCAP \
        --output_dir=prepared/
    python -m ergm_tpu_torch.tools.text2ids --data_dir=prepared \
        --prefixes=train,dev,test --tokenizer_dir=<gpt2 vocab dir>
    python -m ergm_tpu_torch.cli.load_data --source=json --data_dir=prepared \
        --valid_prefix=dev    # label key 'dev' is already the default
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import re
from typing import Dict, List, Optional, Tuple

from ergm_tpu_torch.core.tokens import EMOTION_TO_ID, SENTIMENT_TO_ID

IEMOCAP_TO_CANONICAL = {
    "ang": "anger", "dis": "disgust", "fea": "fear", "hap": "joy",
    "exc": "joy", "neu": "neutral", "sad": "sadness", "sur": "surprise",
    # no 7-way counterpart; mapped to neutral unless --drop_unmapped
    "fru": None, "oth": None, "xxx": None,
}

EMOTION_TO_SENTIMENT = {
    "joy": "positive",
    "anger": "negative", "disgust": "negative", "fear": "negative",
    "sadness": "negative",
    "neutral": "neutral", "surprise": "neutral",
}

# EmoEvaluation category line:
# [6.2901 - 8.2357]\tSes01F_impro01_F000\tneu\t[2.5000, 2.5000, 2.5000]
_EMO_LINE = re.compile(
    r"^\[(?P<start>[\d.]+)\s*-\s*[\d.]+\]\s+(?P<turn>\S+)\s+(?P<label>\w+)")
# transcription line: Ses01F_impro01_F000 [006.2901-008.2357]: Excuse me.
_TRANS_LINE = re.compile(r"^(?P<turn>\S+)\s+\[[^\]]*\]:\s*(?P<text>.*)$")


def parse_emo_file(path: str) -> List[Tuple[float, str, str]]:
    """[(start_time, turn_id, iemocap_label)] from an EmoEvaluation txt."""
    rows = []
    with open(path, errors="replace") as f:
        for line in f:
            m = _EMO_LINE.match(line.strip())
            if m:
                rows.append((float(m.group("start")), m.group("turn"),
                             m.group("label").lower()))
    rows.sort(key=lambda r: r[0])
    return rows


def parse_transcription_file(path: str) -> Dict[str, str]:
    """{turn_id: text} from a transcriptions txt."""
    texts = {}
    with open(path, errors="replace") as f:
        for line in f:
            m = _TRANS_LINE.match(line.strip())
            if m:
                texts[m.group("turn")] = m.group("text").strip()
    return texts


def session_of(dialogue_name: str) -> Optional[int]:
    """Ses03F_impro05 -> 3."""
    m = re.match(r"Ses(\d+)", dialogue_name)
    return int(m.group(1)) if m else None


def convert(data_dir: str, valid_session: int = 4, test_session: int = 5,
            drop_unmapped: bool = False):
    """-> (dialogues, labels, skipped): ``{split: [ [utterance texts] ]}``,
    ``{split: {"emotion": [[ids]], "sentiment": [[ids]]}}``, and the count
    of dropped utterances (unmapped category / missing transcription).
    Dialogues are ordered by (session, name). Split keys are
    train/dev/test — the MELD convention the rest of the pipeline
    defaults to (``load_data --valid_split=dev``)."""
    if valid_session == test_session:
        raise ValueError(
            f"--valid_session and --test_session are both {test_session}; "
            f"the dev split would be silently empty — pick distinct sessions")
    emo_files = sorted(
        glob.glob(os.path.join(data_dir, "**", "dialog", "EmoEvaluation",
                               "*.txt"), recursive=True))
    if not emo_files:
        raise FileNotFoundError(
            f"no dialog/EmoEvaluation/*.txt under {data_dir} — point "
            f"--data_dir at an IEMOCAP release root (Session1..Session5)")
    dialogues = {s: [] for s in ("train", "dev", "test")}
    labels = {s: {"emotion": [], "sentiment": []}
              for s in ("train", "dev", "test")}
    skipped = 0
    for emo_path in emo_files:
        name = os.path.splitext(os.path.basename(emo_path))[0]
        sess = session_of(name)
        if sess is None:
            continue
        split = ("test" if sess == test_session
                 else "dev" if sess == valid_session else "train")
        trans_path = os.path.join(
            os.path.dirname(os.path.dirname(emo_path)), "transcriptions",
            f"{name}.txt")
        texts = (parse_transcription_file(trans_path)
                 if os.path.exists(trans_path) else {})
        utts: List[str] = []
        emo_ids: List[int] = []
        senti_ids: List[int] = []
        for _start, turn, raw in parse_emo_file(emo_path):
            if raw not in IEMOCAP_TO_CANONICAL:
                skipped += 1
                continue
            canonical = IEMOCAP_TO_CANONICAL[raw]
            if canonical is None:
                if drop_unmapped:
                    skipped += 1
                    continue
                canonical = "neutral"
            text = texts.get(turn, "")
            if not text:
                skipped += 1
                continue
            utts.append(text)
            emo_ids.append(EMOTION_TO_ID[canonical])
            senti_ids.append(SENTIMENT_TO_ID[EMOTION_TO_SENTIMENT[canonical]])
        if utts:
            dialogues[split].append(utts)
            labels[split]["emotion"].append(emo_ids)
            labels[split]["sentiment"].append(senti_ids)
    return dialogues, labels, skipped


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert IEMOCAP to the interchange format")
    p.add_argument("--data_dir", type=str, required=True,
                   help="IEMOCAP release root (contains Session1..5).")
    p.add_argument("--output_dir", type=str, default=".")
    p.add_argument("--valid_session", type=int, default=4)
    p.add_argument("--test_session", type=int, default=5)
    p.add_argument("--drop_unmapped", action="store_true",
                   help="Drop fru/oth/xxx utterances instead of mapping "
                        "them to neutral.")
    args = p.parse_args(argv)

    dialogues, labels, skipped = convert(
        args.data_dir, valid_session=args.valid_session,
        test_session=args.test_session, drop_unmapped=args.drop_unmapped)
    os.makedirs(args.output_dir, exist_ok=True)
    for split, ds in dialogues.items():
        out = os.path.join(args.output_dir, f"{split}_sent_emo.json")
        with open(out, "w") as f:
            json.dump(ds, f)
        print(f"{split}: {len(ds)} dialogues, "
              f"{sum(len(d) for d in ds)} utterances -> {out}")
    pkl = os.path.join(args.output_dir, "emotion_sentiment_labels.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(labels, f)
    print(f"labels -> {pkl} (skipped {skipped} unmapped/untranscribed "
          f"utterances)")


if __name__ == "__main__":
    main()
