"""A copy of ``ergm_tpu/tools/corpora.py`` (the port imports nothing of ``ergm_tpu``).

Text-only dialogue corpus loaders + detokenization cleanup.

Capability of src/scripts/process_data.py: build train/valid dialogue
lists from four public corpora — DailyDialog (process_data.py:21),
EmpatheticDialogues with consecutive-same-speaker merging (53),
PersonaChat via its S3 JSON (107), BlendedSkillTalk interleaving free
and guided messages (144) — plus ``clean_token_list``, the GPT-2
detokenizer cleanup (capitalization, end-mark spacing, quote balancing;
process_data.py:186-220).

Corpus fetches need the HF ``datasets`` hub (or the PersonaChat URL);
in offline environments each loader accepts pre-fetched rows via the
``data`` argument, and the pure transformation logic is what the tests
cover.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

SPACE = "Ġ"  # GPT-2 BPE space marker
END_MARKS = [".", ",", "?", "!", "..."]
QUOTES = ['"', "'"]
ABBREVIATIONS = ["s", "d", "t", "m", "re", "ll", "ve",
                 "S", "D", "T", "M", "Re", "Ll", "Ve"]

Dialogues = List[List[str]]
LoadResult = Tuple[Dialogues, Dialogues, int, int]


def clean_token_list(tokens: Sequence[str]) -> List[str]:
    """Detokenization cleanup over GPT-2 token strings
    (process_data.py:186-220 behavior):

    - capitalize the first token,
    - glue end-marks and contraction suffixes to the previous word
      (strip their leading space marker),
    - glue an apostrophe to a following contraction suffix,
    - alternate double-quote attachment so quoted spans close tight,
    - capitalize the word after a sentence end-mark and ensure a space,
    - drop empty/bare-space tokens and guarantee a final end mark.
    """
    toks = list(tokens)
    if not toks:
        return ["."]
    toks[0] = toks[0].capitalize()

    quote_count = 0
    for i, token in enumerate(toks):
        if SPACE in token:
            body = token[1:]
            if body in END_MARKS or body in ABBREVIATIONS:
                toks[i] = body
            if body == QUOTES[1] and i < len(toks) - 1:
                nxt = toks[i + 1]
                if nxt in ABBREVIATIONS or (nxt[:1] == SPACE and nxt[1:] in ABBREVIATIONS):
                    toks[i] = body
        if token[:1] == SPACE and token[1:] in QUOTES:
            if quote_count % 2 == 1:
                toks[i] = token[1:]
                quote_count = 0
            else:
                if i < len(toks) - 1 and toks[i + 1][:1] == SPACE:
                    toks[i + 1] = toks[i + 1][1:]
                quote_count += 1
        if token in END_MARKS or token[1:] in END_MARKS:
            if i < len(toks) - 1:
                nxt = toks[i + 1]
                if nxt[:1] != SPACE:
                    toks[i + 1] = SPACE + nxt.capitalize()
                else:
                    toks[i + 1] = SPACE + nxt[1:].capitalize()

    out = [t for t in toks if t != SPACE and len(t) > 0]
    if not out:
        return ["."]
    if out[-1] not in END_MARKS:
        out.append(END_MARKS[0])
    return out


def clean_text(text: str, tokenizer) -> str:
    """Tokenize -> clean_token_list -> detokenize (the per-utterance
    normalization every loader applies, e.g. process_data.py:31-34).

    Detokenization goes through the byte table directly: cleanup can
    produce strings (capitalized words, stripped markers) that are not
    vocab entries but are still valid byte-level text."""
    ids = tokenizer.encode(text.strip())
    toks = [tokenizer.id_to_token[i] for i in ids]
    cleaned = clean_token_list(toks)
    data = bytearray()
    for ch in "".join(cleaned):
        b = tokenizer.byte_decoder.get(ch)
        if b is None:
            data.extend(ch.encode("utf-8"))
        else:
            data.append(b)
    return data.decode("utf-8", errors="replace")


def _split(dialogues: Dialogues, train_frac: float) -> LoadResult:
    cut = int(len(dialogues) * train_frac)
    train, valid = dialogues[:cut], dialogues[cut:]
    return train, valid, sum(map(len, train)), sum(map(len, valid))


def _fetch(name: str):
    try:
        from datasets import load_dataset

        return load_dataset(name)
    except Exception as e:  # offline or hub unavailable
        raise RuntimeError(
            f"corpus {name!r} needs the HF datasets hub; fetch it on a "
            f"networked machine and pass the rows via `data=`") from e


def load_daily(tokenizer, train_frac: float, data: Optional[Dialogues] = None) -> LoadResult:
    """DailyDialog: all splits concatenated then re-split by train_frac
    (process_data.py:21-50)."""
    if data is None:
        ds = _fetch("daily_dialog")
        data = list(ds["train"]["dialog"]) + list(ds["validation"]["dialog"]) \
            + list(ds["test"]["dialog"])
    cleaned = [[clean_text(u.replace("’", "'"), tokenizer) for u in d] for d in data]
    return _split(cleaned, train_frac)


def load_empathetic(tokenizer, train_frac: float,
                    data: Optional[Dict[str, list]] = None) -> LoadResult:
    """EmpatheticDialogues: rows with conv_id/speaker_idx/utterance;
    consecutive same-speaker turns merge into one (process_data.py:53-104);
    rows containing the ``_conv`` marker are dropped; ``_comma_`` becomes
    a comma."""
    if data is None:
        ds = _fetch("empathetic_dialogues")
        data = {k: (list(ds["train"][k]) + list(ds["validation"][k]) + list(ds["test"][k]))
                for k in ("utterance", "conv_id", "speaker_idx")}
    conv: Dict[str, List[str]] = {}
    last_speaker: Dict[str, int] = {}
    for utt, cid, spk in zip(data["utterance"], data["conv_id"], data["speaker_idx"]):
        if "_conv" in utt:
            continue
        text = clean_text(utt.replace("_comma_", ","), tokenizer)
        if cid not in conv:
            conv[cid] = [text]
        elif last_speaker[cid] != spk:
            conv[cid].append(text)
        else:
            conv[cid][-1] += f" {text}"
        last_speaker[cid] = spk
    return _split(list(conv.values()), train_frac)


def load_persona(tokenizer, train_frac: float,
                 data: Optional[list] = None) -> LoadResult:
    """PersonaChat: each record's final utterances[-1].history is the
    dialogue; ``__ SILENCE __`` turns are dropped (process_data.py:107-141)."""
    if data is None:
        import json
        import urllib.request

        url = ("https://s3.amazonaws.com/datasets.huggingface.co/personachat/"
               "personachat_self_original.json")
        try:
            with urllib.request.urlopen(url, timeout=30) as f:
                blob = json.loads(f.read().decode())
        except Exception as e:
            raise RuntimeError("personachat fetch needs network; pass data=") from e
        data = blob["train"] + blob["valid"]
    dialogues = []
    for obj in data:
        history = obj["utterances"][-1]["history"]
        dia = [clean_text(u, tokenizer) for u in history if u.strip() != "__ SILENCE __"]
        dialogues.append(dia)
    return _split(dialogues, train_frac)


def load_blended(tokenizer, train_frac: float,
                 data: Optional[Dict[str, list]] = None) -> LoadResult:
    """BlendedSkillTalk: previous_utterance seed + interleaved
    free/guided messages (process_data.py:144-183)."""
    if data is None:
        ds = _fetch("blended_skill_talk")
        data = {k: (list(ds["train"][k]) + list(ds["validation"][k]) + list(ds["test"][k]))
                for k in ("previous_utterance", "free_messages", "guided_messages")}
    dialogues = []
    for prev, free, guided in zip(data["previous_utterance"], data["free_messages"],
                                  data["guided_messages"]):
        free = [u.strip() for u in free if u.strip()]
        guided = [u.strip() for u in guided if u.strip()]
        dia = list(prev)
        for j, f in enumerate(free):
            dia.append(clean_text(f, tokenizer))
            if j < len(guided):
                dia.append(clean_text(guided[j], tokenizer))
        dialogues.append(dia)
    return _split(dialogues, train_frac)
