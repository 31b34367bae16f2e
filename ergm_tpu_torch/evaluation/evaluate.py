"""Evaluation metrics (a copy of ``ergm_tpu/evaluation/evaluate.py``; the
port imports nothing of ``ergm_tpu``) — the reference Evaluator
(eval/evaluate.py) with the API its caller actually needs.

The reference calls ``evaluate_all(hypotheses, references,
true_label_ids=..., losses=...)`` (src/main.py:378-383) but defines a
2-argument method (eval/evaluate.py:71) — a TypeError on the published
path (SURVEY.md §2.4.4). This Evaluator implements the intended
4-metric version: distinct-1/2, BERTScore, test PPL (from collected LM
losses, src/main.py:328-333), and emotion accuracy.

Offline-environment handling:
- distinct-n uses nltk word_tokenize when its punkt data is installed
  (eval/evaluate.py:37), else a built-in Treebank-style fallback,
- BERTScore (eval/evaluate.py:50-69 loads HF ``evaluate``'s bertscore)
  is computed by a native implementation of the BERTScore greedy-cosine
  matching over token embeddings; it needs a local embedding model
  (pass ``bert_model_dir`` pointing at an HF checkpoint on disk, or an
  ``embed_fn``). With neither, BERTScore fields are omitted with a
  warning instead of crashing — there is no model download here.
"""

from __future__ import annotations

import math
import re
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

# -- tokenization -----------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""(?:[a-z]+n't)|(?:'(?:ll|re|ve|s|d|m|t))|(?:\w+)|(?:[^\w\s])""",
    re.IGNORECASE,
)


def _fallback_word_tokenize(text: str) -> List[str]:
    """Treebank-ish tokenizer: splits contractions and punctuation like
    nltk.word_tokenize closely enough for distinct-n statistics."""
    return _TOKEN_RE.findall(text)


def word_tokenize(text: str) -> List[str]:
    try:
        from nltk.tokenize import word_tokenize as nltk_tok

        return nltk_tok(text)
    except (ImportError, LookupError):
        return _fallback_word_tokenize(text)


# -- metrics ---------------------------------------------------------------


def calculate_distinct(sentences: Sequence[str]):
    """Distinct-1/2 over the corpus, lowercased (eval/evaluate.py:26-48)."""
    if not sentences:
        return 0.0, 0.0
    total_words = total_bigrams = 0
    uniq_words, uniq_bigrams = set(), set()
    for sent in sentences:
        toks = word_tokenize(sent.lower())
        total_words += len(toks)
        uniq_words.update(toks)
        bgs = list(zip(toks, toks[1:]))
        total_bigrams += len(bgs)
        uniq_bigrams.update(bgs)
    d1 = len(uniq_words) / total_words if total_words else 0.0
    d2 = len(uniq_bigrams) / total_bigrams if total_bigrams else 0.0
    return d1, d2


def calculate_bleu(hypotheses: Sequence[str], references: Sequence[str],
                   max_n: int = 4) -> float:
    """Corpus BLEU-N with add-one smoothing on higher-order n-grams
    (dependency-free). Extends the reference's metric set per the
    project north star; the reference itself ships only distinct-n and
    BERTScore (eval/evaluate.py)."""
    if not hypotheses or not references:
        return 0.0
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = ref_len = 0
    for hyp, ref in zip(hypotheses, references):
        h = word_tokenize(hyp.lower())
        r = word_tokenize(ref.lower())
        hyp_len += len(h)
        ref_len += len(r)
        for n in range(1, max_n + 1):
            h_ngrams: dict = {}
            for i in range(len(h) - n + 1):
                g = tuple(h[i:i + n])
                h_ngrams[g] = h_ngrams.get(g, 0) + 1
            r_ngrams: dict = {}
            for i in range(len(r) - n + 1):
                g = tuple(r[i:i + n])
                r_ngrams[g] = r_ngrams.get(g, 0) + 1
            totals[n - 1] += max(len(h) - n + 1, 0)
            clipped[n - 1] += sum(min(c, r_ngrams.get(g, 0))
                                  for g, c in h_ngrams.items())
    if clipped[0] == 0:
        return 0.0  # no unigram overlap: BLEU is 0, unsmoothed
    precisions = []
    for n in range(max_n):
        if totals[n] == 0:
            precisions.append(0.0)
        elif clipped[n] == 0:
            precisions.append(1.0 / (2 * totals[n]))  # smooth higher orders only
        else:
            precisions.append(clipped[n] / totals[n])
    if min(precisions) == 0.0:
        return 0.0
    log_avg = sum(math.log(p) for p in precisions) / max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return bp * math.exp(log_avg)


def bertscore_from_embeddings(
    hyp_emb: np.ndarray, ref_emb: np.ndarray,
    hyp_mask: Optional[np.ndarray] = None, ref_mask: Optional[np.ndarray] = None,
):
    """BERTScore P/R/F1 for one pair given token embeddings [Lh, D]/[Lr, D].

    Greedy matching on cosine similarity (Zhang et al. 2020): precision =
    mean over hypothesis tokens of max-sim to any reference token; recall
    symmetric; F1 harmonic mean.
    """
    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    h, r = norm(hyp_emb), norm(ref_emb)
    sim = h @ r.T  # [Lh, Lr]
    if ref_mask is not None:
        sim = np.where(ref_mask[None, :] > 0, sim, -1e9)
    if hyp_mask is not None:
        sim_t = np.where(hyp_mask[:, None] > 0, sim, -1e9)
    else:
        sim_t = sim
    hyp_keep = hyp_mask.astype(bool) if hyp_mask is not None else np.ones(len(h), bool)
    ref_keep = ref_mask.astype(bool) if ref_mask is not None else np.ones(len(r), bool)
    p = float(sim.max(axis=1)[hyp_keep].mean()) if hyp_keep.any() else 0.0
    rc = float(sim_t.max(axis=0)[ref_keep].mean()) if ref_keep.any() else 0.0
    f1 = 2 * p * rc / (p + rc) if (p + rc) > 0 else 0.0
    return p, rc, f1


class Evaluator:
    """4-metric evaluator (the reference's intended surface).

    BERTScore: with ``bert_model_dir``, uses the faithful implementation
    (evaluation/bertscore.py — layer selection, idf weighting, baseline
    rescaling, matching the published algorithm the reference consumes
    via HF evaluate, the reference's eval/evaluate.py:50-69). The
    ``embed_fn`` path remains for injectable test embeddings.
    ``require_bertscore=True`` makes a missing model a hard error
    instead of a skipped metric. ``device``: where the BERTScore encoder
    runs (the card unless the caller asks for the CPU)."""

    def __init__(self, bert_model_dir: Optional[str] = None,
                 embed_fn: Optional[Callable[[List[str]], List[np.ndarray]]] = None,
                 bert_layer: Optional[int] = None,
                 bert_idf: bool = False,
                 bert_baselines: Optional[Dict[str, float]] = None,
                 require_bertscore: bool = False,
                 device="cuda"):
        self.embed_fn = embed_fn
        self.scorer = None
        self.require_bertscore = require_bertscore
        # an explicitly injected embed_fn wins over bert_model_dir (test
        # doubles must not be shadowed by — or fail on — a model dir)
        if bert_model_dir is not None and embed_fn is None:
            from ergm_tpu_torch.evaluation.bertscore import BERTScorer

            # raises loudly on a broken/missing checkpoint dir
            self.scorer = BERTScorer(bert_model_dir, layer=bert_layer,
                                     idf=bert_idf, baselines=bert_baselines, device=device)

    def calculate_distinct(self, sentences):
        return calculate_distinct(sentences)

    def calculate_bertscore(self, hypotheses, references) -> Optional[Dict[str, float]]:
        if self.scorer is not None:
            return self.scorer.score(list(hypotheses), list(references))
        if self.embed_fn is None:
            if self.require_bertscore:
                raise RuntimeError(
                    "BERTScore required but no model available: pass "
                    "bert_model_dir (local HF encoder checkpoint) or embed_fn")
            warnings.warn(
                "BERTScore SKIPPED: no embedding model available "
                "(pass bert_model_dir or embed_fn to Evaluator); the "
                "bs_precision/bs_recall/bs_f1 fields will be absent")
            return None
        if not hypotheses or not references:
            return {"bs_precision": 0.0, "bs_recall": 0.0, "bs_f1": 0.0}
        hyp_embs = self.embed_fn(list(hypotheses))
        ref_embs = self.embed_fn(list(references))
        ps, rs, fs = [], [], []
        for h, r in zip(hyp_embs, ref_embs):
            p, rc, f1 = bertscore_from_embeddings(np.asarray(h), np.asarray(r))
            ps.append(p); rs.append(rc); fs.append(f1)
        return {"bs_precision": float(np.mean(ps)),
                "bs_recall": float(np.mean(rs)),
                "bs_f1": float(np.mean(fs))}

    def evaluate_all(
        self,
        hypotheses: Sequence[str],
        references: Sequence[str],
        true_label_ids: Optional[Sequence[int]] = None,
        losses: Optional[Sequence[float]] = None,
        pred_label_ids: Optional[Sequence[int]] = None,
        loss_token_counts: Optional[Sequence[float]] = None,
    ) -> Dict[str, float]:
        """The signature src/main.py:378-383 actually calls. Adds
        ``pred_label_ids`` so emotion accuracy is computable (the
        reference collected true labels but produced no predictions),
        and ``loss_token_counts`` (supervised tokens per batch, aligned
        with ``losses``) so the statistically honest token-weighted PPL
        is reported next to the reference's equal-batch-weighted one
        (src/main.py:328-333 weights every batch the same regardless of
        token count)."""
        results: Dict[str, float] = {}
        d1, d2 = self.calculate_distinct(hypotheses)
        results["dist_1"], results["dist_2"] = d1, d2
        results["bleu"] = calculate_bleu(hypotheses, references)
        bs = self.calculate_bertscore(hypotheses, references)
        if bs is not None:
            results.update(bs)
        if losses is not None and len(losses):
            mean = float(np.mean(losses))
            ppl = math.exp(mean) if math.isfinite(mean) else float("inf")
            results["ppl"] = 1e8 if not math.isfinite(ppl) else ppl
            if loss_token_counts is not None and len(loss_token_counts) == len(losses):
                tok = float(np.sum(loss_token_counts))
                if tok > 0:
                    tw = float(np.dot(losses, loss_token_counts)) / tok
                    tw_ppl = math.exp(tw) if math.isfinite(tw) else float("inf")
                    results["ppl_token_weighted"] = \
                        1e8 if not math.isfinite(tw_ppl) else tw_ppl
        if true_label_ids is not None and pred_label_ids is not None and len(true_label_ids):
            t = np.asarray(true_label_ids)
            p = np.asarray(pred_label_ids)
            results["emotion_acc"] = float((t == p).mean() * 100.0)
            # per-class F1 + macro-F1 (beyond the reference's accuracy,
            # SURVEY.md §4 "exceed the reference"): accuracy alone hides
            # collapse onto the majority class on imbalanced MELD labels
            f1s = []
            for cls in range(int(max(t.max(), p.max())) + 1):
                tp = float(((p == cls) & (t == cls)).sum())
                fp = float(((p == cls) & (t != cls)).sum())
                fn = float(((p != cls) & (t == cls)).sum())
                denom = 2 * tp + fp + fn
                f1 = (2 * tp / denom) if denom > 0 else 0.0
                if (t == cls).any() or (p == cls).any():
                    results[f"emotion_f1_class{cls}"] = f1
                    f1s.append(f1)
            if f1s:
                results["emotion_macro_f1"] = float(np.mean(f1s))
        return results
