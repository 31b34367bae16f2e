"""Dialogue tokenization: ``{prefix}_sent_emo.json`` -> ``..._ids.json``
(a copy of ``ergm_tpu/tools/text2ids.py`` on the port's tokenizer).

Capability of src/scripts/text2ids.py (and its single-file variant
sentence_to_ids.py): tokenize every utterance of every dialogue with the
GPT-2 BPE extended by the canonical special-token registry
(core/tokens.py resolves the reference's three inconsistent
token sets — SURVEY.md §2.4.13). Uses the file-based BPE
(``ergm_tpu_torch/tokenizer/bpe.py``); no network.

Input format (text2ids.py:47-56): a JSON list of dialogues, each a list
of utterances, where an utterance is either a plain string or a list
whose first element is the text.

Usage::

    python -m ergm_tpu_torch.tools.text2ids --data_dir=DATA --tokenizer_dir=TOK
"""

from __future__ import annotations

import argparse
import json
import os


def tokenize_dialogues(dialogues, tokenizer):
    out = []
    for dialogue in dialogues:
        ids = []
        for utter in dialogue:
            text = utter[0] if isinstance(utter, (list, tuple)) else utter
            ids.append(tokenizer.encode(text))
        out.append(ids)
    assert len(out) == len(dialogues)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Tokenize dialogue JSON to id JSON")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--prefixes", type=str, default="train,valid,test")
    p.add_argument("--tokenizer_dir", type=str, required=True,
                   help="Dir with GPT-2 vocab.json/merges.txt")
    args = p.parse_args(argv)

    from ergm_tpu_torch.tokenizer.bpe import load_or_train_default

    tok = load_or_train_default(args.tokenizer_dir)
    for prefix in args.prefixes.split(","):
        in_path = os.path.join(args.data_dir, f"{prefix}_sent_emo.json")
        out_path = os.path.join(args.data_dir, f"{prefix}_sent_emo_ids.json")
        if not os.path.exists(in_path):
            print(f"skip {prefix}: {in_path} not found")
            continue
        with open(in_path, encoding="utf-8") as f:
            dialogues = json.load(f)
        ids = tokenize_dialogues(dialogues, tok)
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(ids, f)
        print(f"{prefix}: {len(ids)} dialogues -> {out_path}")


if __name__ == "__main__":
    main()
