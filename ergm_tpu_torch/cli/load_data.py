"""load_data (counterpart of ``ergm_tpu/cli/load_data.py``, the same flags) —
the data-assembly step the reference promises but does not
ship (load_data.sh calls src/scripts/load_data.py which is absent;
SURVEY.md §2.4.1).

Builds ``multi_{prefix}_data.pkl`` + ``context_label_{prefix}_data.pkl``
(+ ``tokenizer_meta.json``) in the schema custom_dataset.py:14-28
consumes, from either:

- ``--source=json``: tokenized dialogues ``{prefix}_sent_emo_ids.json``
  (the output of the text2ids step, src/scripts/text2ids.py:34-64), the
  emotion/sentiment label pickle (src/scripts/emotion_labels.py output),
  and optional per-dialogue feature pickles, or
- ``--source=synthetic``: a synthetic fixture (tests/benches/CI).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle


def build_from_json(args) -> None:
    from ergm_tpu_torch.core.tokens import SpecialTokens
    from ergm_tpu_torch.data.assembly import assemble_split, write_meta, write_split
    from ergm_tpu_torch.tokenizer.bpe import load_or_train_default

    tok = load_or_train_default(args.tokenizer_dir)
    vocab = dict(tok.vocab)
    st = SpecialTokens.register(vocab)

    with open(os.path.join(args.data_dir, args.labels_file), "rb") as f:
        labels = pickle.load(f)

    feature_store = {}
    if args.features_file:
        with open(os.path.join(args.data_dir, args.features_file), "rb") as f:
            feature_store = pickle.load(f)

    split_map = {args.train_prefix: "train", args.valid_prefix: args.valid_split}
    for prefix, label_split in split_map.items():
        ids_path = os.path.join(args.data_dir, f"{prefix}_sent_emo_ids.json")
        if not os.path.exists(ids_path):
            print(f"skip {prefix}: {ids_path} not found")
            continue
        with open(ids_path) as f:
            dialogues = json.load(f)
        emo = labels[label_split]["emotion"]
        imgs = feature_store.get(label_split, {}).get("img")
        auds = feature_store.get(label_split, {}).get("aud")
        # caption texts (e.g. BLIP captions of the clip keyframes):
        # {prefix}_captions.json = [[str per utterance] per dialogue],
        # tokenized here and wrapped in <cap_bos>/<cap_eos> by assembly
        captions = None
        cap_path = os.path.join(args.data_dir, f"{prefix}_captions.json")
        if args.captions and os.path.exists(cap_path):
            with open(cap_path) as f:
                cap_texts = json.load(f)
            captions = [[tok.encode(t) for t in dia] for dia in cap_texts]
        elif args.captions:
            print(f"warning: --captions set but {cap_path} not found")
        payloads = assemble_split(dialogues, emo, st, img_features=imgs,
                                  aud_features=auds, captions=captions,
                                  max_turns=args.max_turns,
                                  max_len=args.max_len)
        write_split(payloads, args.out_dir, prefix)
        n = sum(len(d) for d in dialogues)
        print(f"{prefix}: {len(dialogues)} dialogues / {n} utterances -> {args.out_dir}")
    write_meta(st, args.out_dir)


def build_synthetic(args) -> None:
    from ergm_tpu_torch.data.synthetic import write_synthetic_dataset

    st = write_synthetic_dataset(
        args.out_dir, prefixes=(args.train_prefix, args.valid_prefix),
        num_dialogues=args.num_dialogues, turns_per_dialogue=args.turns,
        seed=args.seed, captions="target" if args.captions else None)
    print(f"synthetic dataset written to {args.out_dir} "
          f"(vocab {st.vocab_size}, eos {st.eos_id})")


def main(argv=None):
    p = argparse.ArgumentParser(description="Build ERGM training pickles")
    p.add_argument("--source", choices=["json", "synthetic"], default="json")
    p.add_argument("--data_dir", type=str, default="data",
                   help="Input dir (json/labels/features).")
    p.add_argument("--out_dir", type=str, default=None,
                   help="Output dir; defaults to data_dir/<model_type>.")
    p.add_argument("--model_type", type=str, default="gpt2")
    p.add_argument("--train_prefix", type=str, default="train")
    p.add_argument("--valid_prefix", type=str, default="valid")
    p.add_argument("--valid_split", type=str, default="dev",
                   help="Label-pickle split name for the valid prefix "
                        "(MELD uses train/dev/test).")
    p.add_argument("--train_frac", type=float, default=0.85,
                   help="Accepted for load_data.sh compatibility "
                        "(splits here come from the source files).")
    p.add_argument("--labels_file", type=str, default="emotion_sentiment_labels.pkl")
    p.add_argument("--features_file", type=str, default=None,
                   help="Optional pickle {split: {'img': [...], 'aud': [...]}}.")
    p.add_argument("--captions", action="store_true",
                   help="Emit caption ids for cross-attention conditioning: "
                        "json source reads {prefix}_captions.json (caption "
                        "text per utterance); synthetic source uses the "
                        "caption-predictable task.")
    p.add_argument("--tokenizer_dir", type=str, default=None)
    p.add_argument("--max_turns", type=int, default=None)
    p.add_argument("--max_len", type=int, default=1024)
    p.add_argument("--num_dialogues", type=int, default=16)
    p.add_argument("--turns", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.out_dir is None:
        args.out_dir = os.path.join(args.data_dir, args.model_type)
    if args.source == "synthetic":
        build_synthetic(args)
    else:
        build_from_json(args)


if __name__ == "__main__":
    main()
