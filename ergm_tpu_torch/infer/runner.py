"""Inference/test runner (counterpart of ``ergm_tpu/infer/runner.py``) —
the reference ``Manager.test`` + evaluation dispatch (src/main.py:291-396),
batched and KV-cached, on the device the parameters are on.

Per validation batch:
- collects the LM-only loss for corpus PPL (src/main.py:328-333) through
  ``train/steps.py::make_eval_step`` (on the card: K5 for the causal
  self-attention at 128-multiple buckets, K6 for the LM loss),
- extracts per-sample prompts exactly like the reference: the first
  ``count(ids != eos)`` tokens (src/main.py:316) — note this includes
  the gold response; ``prompt_mode="history"`` instead prompts with only
  the masked-history prefix (labels == -100), the scientifically
  conventional choice — the reference behavior stays the default,
- generates continuations with the batched left-padded decoder
  (``infer/generate.py::generate_batch``) or beam search
  (``infer/beam.py::beam_search_batch``),
- collects emotion predictions from the prompt's final hidden state so
  emotion accuracy is actually computable (the reference gathered only
  true labels — SURVEY.md §2.4.4).

Sampling draws from one ``torch.Generator`` on the parameters' device,
seeded with ``seed`` and advancing across batches; JAX splits a key per
batch instead, so sampled text differs from JAX's (greedy text does not).

Over a mesh every rank runs this with the same arguments: the eval step
takes each data rank's rows of a batch and returns the global batch's
metrics, the decode goes through ``generate_batch(mesh=)`` /
``beam_search_batch(mesh=)``, and every rank returns the same results
(the caller writes them on rank 0).

Returns (hypotheses, references, true_labels, losses, pred_labels,
contexts, loss_tokens); text decoding uses the provided tokenizer, or a
space-joined-id fallback for synthetic corpora.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.data.dataset import IGNORE_INDEX, DialogueDataset, batches
from ergm_tpu_torch.infer.beam import beam_search_batch
from ergm_tpu_torch.infer.generate import generate_batch
from ergm_tpu_torch.train.steps import batch_to_device, make_eval_step

# run_test's samplers as generate_batch's ``sample_top_k``; JAX's
# "approx" (approx_max_k, a TPU speed option) is not ported
SAMPLE_TOP_K = {"full_sort": 0, "exact": 64}


class TestResults(NamedTuple):
    """run_test output. ``losses`` holds the per-batch mean LM loss (the
    reference's equal-batch-weighted PPL input, src/main.py:328-333);
    ``loss_tokens`` the supervised-token count per batch so the
    token-weighted corpus PPL is computable alongside."""

    hypotheses: List[str]
    references: List[str]
    true_labels: List[int]
    losses: List[float]
    pred_labels: List[int]
    contexts: List[str]
    loss_tokens: List[float]


def _decode(tokenizer, ids: List[int]) -> str:
    if tokenizer is None:
        return " ".join(str(i) for i in ids)
    return tokenizer.decode(ids, skip_special_tokens=True)


def run_test(
    params,
    config: ModelConfig,
    dataset: DialogueDataset,
    *,
    batch_size: int,
    eos_id: int,
    sp2_id: int,
    max_len: int,
    top_p: float,
    seed: int = 0,
    tokenizer=None,
    prompt_mode: str = "reference",
    use_modalities: bool = True,
    max_new_tokens: Optional[int] = None,
    num_beams: int = 1,
    sampler: str = "full_sort",
    mesh=None,
    draft_layers: int = 0,
    spec_gamma: int = 4,
    spec_mode: str = "auto",
    spec_ngram: int = 3,
) -> TestResults:
    """``num_beams > 1`` decodes with beam search instead of nucleus
    sampling (the capability src/model.py:739-745 plumbs but the
    reference never invokes).

    ``sampler``: "full_sort" (default: full-vocab sort, the reference's
    top-p math — the metric-reporting path) or "exact" (exact top-64
    nucleus). JAX's "approx" raises: the port uses the exact top-k.
    ``mesh``: the eval step and the decode over a mesh (``params`` this
    rank's shard, ``core.mesh.shard_params``)."""
    if sampler == "approx":
        raise ValueError("sampler='approx' (approximate top-k) is not ported: the port uses "
                         "the exact top-k; pass sampler='exact' or 'full_sort'")
    if sampler not in SAMPLE_TOP_K:
        raise ValueError(f"unknown sampler {sampler!r}")
    device = next(params.parameters()).device
    eval_step = make_eval_step(config, mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(seed)

    hyps: List[str] = []
    refs: List[str] = []
    true_labels: List[int] = []
    losses: List[float] = []
    loss_tokens: List[float] = []
    pred_labels: List[int] = []
    contexts: List[str] = []

    for batch in batches(dataset, batch_size, eos_id, max_len=max_len):
        metrics = eval_step(params, batch_to_device(batch, device, mesh=mesh))
        losses.append(float(metrics["lm_loss"]))
        loss_tokens.append(float(metrics["lm_tokens"]))

        prompts, tts, imgs, auds, caps = [], [], [], [], []
        for i in range(batch.input_ids.shape[0]):
            if not batch.valid[i]:
                continue
            ids = batch.input_ids[i]
            if prompt_mode == "history":
                hist = int(np.argmax(batch.labels[i] != IGNORE_INDEX))
                n = max(hist, 1)
            else:  # reference semantics: src/main.py:316
                n = int((ids != eos_id).sum())
                n = max(n, 1)
            prompts.append(ids[:n].tolist())
            tts.append(batch.token_type_ids[i][:n].tolist())
            imgs.append(batch.imgs[i])
            auds.append(batch.auds[i])
            if batch.caption_ids is not None:
                nc = int(batch.caption_mask[i].sum())
                caps.append(batch.caption_ids[i][:nc].tolist())
            else:
                caps.append(None)

            ref_ids = batch.labels[i][batch.labels[i] != IGNORE_INDEX]
            refs.append(_decode(tokenizer, ref_ids.tolist()))
            true_labels.append(int(batch.emotion_labels[i]))
            contexts.append(batch.contexts[i])

        cap_arg = caps if any(c is not None for c in caps) else None
        feats = dict(imgs=np.stack(imgs) if use_modalities else None,
                     auds=np.stack(auds) if use_modalities else None)
        if num_beams > 1:
            outs, emo_logits = beam_search_batch(
                params, config, prompts, num_beams=num_beams, max_len=max_len, eos_id=eos_id,
                sp2_id=sp2_id, token_types=tts, captions=cap_arg,
                max_new_tokens=max_new_tokens, mesh=mesh, **feats)
        else:
            outs, emo_logits = generate_batch(
                params, config, prompts, token_types=tts, captions=cap_arg, max_len=max_len,
                eos_id=eos_id, sp2_id=sp2_id, top_p=top_p, generator=generator,
                max_new_tokens=max_new_tokens, draft_layers=draft_layers,
                spec_gamma=spec_gamma, spec_mode=spec_mode, spec_ngram=spec_ngram,
                sample_top_k=SAMPLE_TOP_K[sampler], mesh=mesh, **feats)
        hyps.extend(_decode(tokenizer, o) for o in outs)
        pred_labels.extend(int(p) for p in np.argmax(emo_logits, axis=-1))

    return TestResults(hyps, refs, true_labels, losses, pred_labels,
                       contexts, loss_tokens)


def format_sample(context: str, ref: str, hypothesis: str) -> str:
    """The reference's print_custom block format (src/main.py:26-33)."""
    return (f"Context: {context}\n"
            f"GPT-2: {hypothesis}\n"
            f"Ref: {ref}\n"
            + "-" * 63 + "\n")


def write_generations(path: str, contexts, refs, hyps) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for c, r, h in zip(contexts, refs, hyps):
            f.write(format_sample(c, r, h))
