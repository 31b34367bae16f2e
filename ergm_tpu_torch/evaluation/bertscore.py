"""BERTScore (a copy of ``ergm_tpu/evaluation/bertscore.py`` with a
``device`` argument) — faithful implementation of the published algorithm
(Zhang et al., ICLR 2020), replacing round 1's greedy-cosine stand-in.

The reference loads HF ``evaluate.load("bertscore")``
(the reference's eval/evaluate.py:50-69), which wraps the official
``bert_score`` package. Its algorithm, reproduced here without the
download-time dependencies:

1. tokenize candidate/reference with the scorer model's own tokenizer,
   WITH special tokens (CLS/SEP or BOS/EOS),
2. embed with the encoder and select ONE hidden layer (the official
   per-model defaults live in a lookup table; e.g. roberta-large uses
   layer 17) — selectable here via ``layer``, default last,
3. L2-normalize token embeddings; cosine similarity matrix per pair,
4. greedy matching: precision = (idf-weighted) mean over candidate
   tokens of the max similarity to any reference token; recall the
   transpose; F1 the harmonic mean,
5. optional idf weighting: idf(w) = log((N+1)/(df(w)+1)) computed over
   the REFERENCE corpus, special tokens forced to 0 (the official
   implementation's plus-one-smoothed variant),
6. optional baseline rescaling: s' = (s - b) / (1 - b) with a
   per-metric baseline b (the official tool ships per-model baseline
   files; here the caller provides the numbers — there is no network).

The encoder runs through torch/transformers on ``BERTScorer(device=)``:
the card unless the caller passes ``device="cpu"`` (JAX keeps it on the
host CPU, SURVEY.md §7.4 "Host/device split for eval"). ``transformers``
is imported only when a ``BERTScorer`` is built.
"""

from __future__ import annotations

import math
import os
import warnings
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# The official bert_score package's per-model default layers
# (bert_score/utils.py model2layers — the table HF evaluate consults via
# the reference's eval/evaluate.py:50-69; lang="en" resolves to
# roberta-large, layer 17). Keys are normalized hub names.
OFFICIAL_MODEL_LAYERS: Dict[str, int] = {
    "bert-base-uncased": 9,
    "bert-large-uncased": 18,
    "bert-base-cased-finetuned-mrpc": 9,
    "bert-base-multilingual-cased": 9,
    "bert-base-chinese": 8,
    "roberta-base": 10,
    "roberta-large": 17,
    "roberta-large-mnli": 19,
    "xlnet-base-cased": 5,
    "xlnet-large-cased": 7,
    "xlm-mlm-en-2048": 6,
    "distilroberta-base": 5,
    "distilbert-base-uncased": 5,
    "albert-base-v2": 9,
    "albert-large-v2": 14,
}

# fallback when a local checkpoint dir carries a nonstandard name:
# (config.model_type, num_hidden_layers, hidden_size) -> official layer.
# Name matches win — e.g. roberta-large-mnli shares this signature with
# roberta-large but uses layer 19.
_SIGNATURE_LAYERS: Dict[Tuple[str, int, int], int] = {
    ("roberta", 24, 1024): 17,
    ("roberta", 12, 768): 10,
    ("bert", 24, 1024): 18,
    ("bert", 12, 768): 9,
    ("distilbert", 6, 768): 5,
}


def official_default_layer(model_dir: str, config) -> Optional[int]:
    """The layer the official scorer would pick for this checkpoint:
    exact (normalized) name match on the directory basename first, then
    the architecture-signature fallback. None = unknown model."""
    name = os.path.basename(os.path.normpath(str(model_dir))).lower()
    for key, layer in OFFICIAL_MODEL_LAYERS.items():
        if name == key or name == key.replace("-", "_"):
            return layer
    sig = (getattr(config, "model_type", ""),
           int(getattr(config, "num_hidden_layers", 0)),
           int(getattr(config, "hidden_size", 0)))
    return _SIGNATURE_LAYERS.get(sig)


def load_baseline_file(path: str, layer: int) -> Dict[str, float]:
    """Parse an official bert_score rescale-baseline csv
    (``LAYER,P,R,F1`` header; one row per layer) and return the
    baselines for ``layer``. The official files live at
    bert_score/rescale_baseline/<lang>/<model>.tsv in the package."""
    table: Dict[int, Tuple[float, float, float]] = {}
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.strip().split(",")]
            if len(parts) < 4:
                continue
            try:
                lyr = int(float(parts[0]))
            except ValueError:
                continue  # header row
            table[lyr] = (float(parts[1]), float(parts[2]), float(parts[3]))
    if not table:
        raise ValueError(f"no baseline rows parsed from {path!r} "
                         f"(expected 'LAYER,P,R,F1' csv rows)")
    if layer not in table:
        raise ValueError(f"baseline file {path!r} has no row for layer "
                         f"{layer} (rows: {sorted(table)})")
    p, r, f1 = table[layer]
    return {"precision": p, "recall": r, "f1": f1}


def compute_idf(references: Sequence[List[int]], special_ids: Sequence[int]) -> Dict[int, float]:
    """Plus-one-smoothed idf over reference token-id lists; special tokens 0."""
    n = len(references)
    df: Counter = Counter()
    for ref in references:
        df.update(set(ref))
    idf = {tid: math.log((n + 1) / (c + 1)) for tid, c in df.items()}
    for sid in special_ids:
        idf[sid] = 0.0
    return idf


def _pair_scores(
    c_emb: np.ndarray, r_emb: np.ndarray,
    c_w: np.ndarray, r_w: np.ndarray,
) -> Tuple[float, float, float]:
    """Greedy-matched (P, R, F1) for one pair from normalized embeddings
    [Lc, D]/[Lr, D] and per-token weights (uniform or idf)."""
    sim = c_emb @ r_emb.T  # [Lc, Lr]
    p_num = float((sim.max(axis=1) * c_w).sum())
    p_den = float(c_w.sum())
    r_num = float((sim.max(axis=0) * r_w).sum())
    r_den = float(r_w.sum())
    p = p_num / p_den if p_den > 0 else 0.0
    r = r_num / r_den if r_den > 0 else 0.0
    f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return p, r, f


class BERTScorer:
    """Scores candidate/reference pairs with a LOCAL HF encoder checkpoint.

    No silent degradation: a missing/broken model dir raises immediately
    (VERDICT r1: the metric must not vanish without a word).
    """

    def __init__(
        self,
        model_dir: str,
        layer: Optional[int] = None,
        idf: bool = False,
        baselines: Optional[Union[Dict[str, float], str]] = None,
        batch_size: int = 16,
        max_length: int = 512,
        device="cuda",
    ):
        import torch
        from transformers import AutoModel, AutoTokenizer

        self._torch = torch
        try:
            self.tokenizer = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
            self.model = AutoModel.from_pretrained(
                model_dir, local_files_only=True, output_hidden_states=True)
        except Exception as e:
            raise RuntimeError(
                f"BERTScore model could not be loaded from {model_dir!r}: {e}. "
                f"Provide a local HF encoder checkpoint (no downloads here) "
                f"or skip BERTScore explicitly.") from e
        from ergm_tpu_torch.core.device import resolve

        self.device = resolve(device)
        self.model.to(self.device).eval()
        n_layers = self.model.config.num_hidden_layers
        # hidden_states[0] is the embedding output; [n_layers] the last layer
        if layer is None:
            # out-of-box parity with the official scorer: use its
            # per-model default layer when the checkpoint is recognized
            # (e.g. roberta-large -> 17; VERDICT r2 missing #3)
            layer = official_default_layer(model_dir, self.model.config)
            if layer is None:
                layer = n_layers
                warnings.warn(
                    f"BERTScore model {model_dir!r} not in the official "
                    f"per-model layer table; using the LAST hidden layer "
                    f"({n_layers}) — scores will not match the official "
                    f"scorer's defaults for known models (pass layer= to "
                    f"override)")
        self.layer = layer
        if not 0 <= self.layer <= n_layers:
            raise ValueError(f"layer {self.layer} out of range [0, {n_layers}]")
        self.use_idf = idf
        if isinstance(baselines, str):
            # official rescale-baseline file: pick the row matching the
            # embedding layer, like bert_score does
            baselines = load_baseline_file(baselines, self.layer)
        self.baselines = baselines
        self.batch_size = batch_size
        self.max_length = max_length

    def _encode(self, texts: Sequence[str]) -> Tuple[List[np.ndarray], List[List[int]]]:
        """Returns (normalized per-token embeddings, token ids) per text."""
        torch = self._torch
        embs: List[np.ndarray] = []
        ids: List[List[int]] = []
        for s in range(0, len(texts), self.batch_size):
            chunk = list(texts[s:s + self.batch_size])
            enc = self.tokenizer(chunk, return_tensors="pt", padding=True,
                                 truncation=True, max_length=self.max_length)
            with torch.no_grad():
                out = self.model(**{k: v.to(self.device) for k, v in enc.items()})
            h = out.hidden_states[self.layer]  # [B, L, D]
            h = torch.nn.functional.normalize(h, dim=-1).float().cpu()
            mask = enc["attention_mask"].bool()
            for b in range(h.shape[0]):
                keep = mask[b]
                embs.append(h[b][keep].numpy())
                ids.append(enc["input_ids"][b][keep].tolist())
        return embs, ids

    def score(
        self, candidates: Sequence[str], references: Sequence[str],
    ) -> Dict[str, float]:
        """Corpus-mean P/R/F1 (rescaled when baselines were given)."""
        if len(candidates) != len(references):
            raise ValueError("candidates and references must align")
        if not candidates:
            return {"bs_precision": 0.0, "bs_recall": 0.0, "bs_f1": 0.0}
        c_embs, c_ids = self._encode(candidates)
        r_embs, r_ids = self._encode(references)

        if self.use_idf:
            special = set(self.tokenizer.all_special_ids)
            idf = compute_idf(r_ids, sorted(special))
            def weights(tok_ids):
                return np.asarray([idf.get(t, math.log(len(r_ids) + 1)) for t in tok_ids],
                                  np.float64)
        else:
            def weights(tok_ids):
                return np.ones(len(tok_ids), np.float64)

        ps, rs, fs = [], [], []
        for ce, re_, ci, ri in zip(c_embs, r_embs, c_ids, r_ids):
            p, r, f = _pair_scores(ce, re_, weights(ci), weights(ri))
            ps.append(p); rs.append(r); fs.append(f)
        out = {"bs_precision": float(np.mean(ps)),
               "bs_recall": float(np.mean(rs)),
               "bs_f1": float(np.mean(fs))}
        if self.baselines:
            for key, short in (("bs_precision", "precision"),
                               ("bs_recall", "recall"), ("bs_f1", "f1")):
                b = self.baselines.get(short, self.baselines.get(key))
                if b is not None and b < 1.0:
                    out[key] = (out[key] - b) / (1.0 - b)
        return out
