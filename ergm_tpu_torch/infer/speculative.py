"""Speculative decoding for a single request (counterpart of
``ergm_tpu/infer/speculative.py``).

Each macro step proposes ``gamma`` tokens, scores them with ONE target
forward over ``[pending, d_1..d_gamma]``, accepts a prefix by an exact
test and emits one correction (or bonus) token, so a step yields
1..gamma+1 tokens from the target's own distribution: greedy output is
token for token plain greedy decode's, and sampling keeps the
nucleus-filtered target distribution (the rejection-sampling identity,
Leviathan et al. 2023).

Two draft sources (``mode``):

- ``"draft"``: the first ``draft_layers`` blocks of the same model
  (``draft_params``, a view that shares every tensor), run
  autoregressively over a cache of their own.
- ``"ngram"``: prompt lookup. The proposals are the ``gamma`` tokens
  that followed the most recent earlier occurrence of the last
  ``ngram_n`` tokens of the buffer; no draft forward at all. A proposal
  is a delta distribution: accepted with probability p(x), residual p
  without x, renormalized.

The macro step runs as a host loop whose cursor is a Python int. One
small device-to-host copy a step brings back what the host needs to
advance it (greedy: the verify logits' argmax and the proposals;
sampling: the accepted count, the correction and the proposals); the
accept/emit/eos arithmetic runs on that copy, and the token buffer
stays on the host, where the n-gram match reads it.

Rollback moves only the cursor: a verify step writes gamma+1 entries at
``cache.index`` and the new index is ``old + n_emit``. The entries past
it stay in the cache tensors, and the unwritten-tail mask of
``gpt2._self_attention_cached`` (keys at or past ``index + L`` are
masked; kernel K2 reads keys up to ``index`` only) keeps them invisible
until the next step's write window overwrites them. That mask is what
makes the rollback safe.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.infer.generate import GenerateOutput, _gumbel, top_p_filter
from ergm_tpu_torch.models import gpt2


def draft_params(params: gpt2.GPT2, config: ModelConfig,
                 draft_layers: int) -> Tuple[gpt2.GPT2, ModelConfig]:
    """(draft model, draft config): the first ``draft_layers`` blocks of
    ``params``, sharing ``wte``, ``wpe``, ``ln_f`` and the heads. No
    tensor is copied; the draft's blocks keep their layer indices, so
    per-layer scales are the target's."""
    if not 0 < draft_layers < config.n_layer:
        raise ValueError(f"draft_layers must be in (0, {config.n_layer})")
    dcfg = config.replace(n_layer=draft_layers)
    draft = copy.copy(params)  # a new module object over the same submodules
    draft._modules = dict(params._modules, blocks=params.blocks[:draft_layers])
    draft.config = dcfg
    return draft, dcfg


def _filtered(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus-filtered probabilities [N, V] (the reference top-p math)."""
    return top_p_filter(torch.softmax(logits.float(), dim=-1), top_p)


def _sample(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row, ``jax.random.categorical`` over log(max(p, 1e-20))."""
    g = _gumbel(probs.shape, generator, probs.device)
    return torch.argmax(torch.log(torch.clamp_min(probs, 1e-20)) + g, dim=-1)


def _ngram_proposals(tok: np.ndarray, cur: int, ngram_n: int, gamma: int) -> np.ndarray:
    """The ``gamma`` tokens that followed the most recent earlier
    occurrence of ``tok[cur - ngram_n:cur]``; the continuation must start
    strictly before ``cur`` (which also excludes the query itself). A
    miss proposes ``tok[cur:cur + gamma]`` (the eos fill), which the
    verify step rejects. Slices clamp like ``lax.dynamic_slice``."""
    T = tok.shape[0]
    lo = min(max(cur - ngram_n, 0), T - ngram_n)
    nwin = T - ngram_n + 1
    m = np.ones(nwin, bool)
    for k in range(ngram_n):
        m &= tok[k:nwin + k] == tok[lo + k]
    m &= np.arange(nwin) + ngram_n < cur
    src = int(np.flatnonzero(m)[-1]) + ngram_n if m.any() else cur
    src = min(max(src, 0), T - gamma)
    return tok[src:src + gamma].copy()


def speculative_generate(*args, **kwargs) -> GenerateOutput:
    """Speculative counterpart of ``generate`` for one request
    (``input_ids`` [1, Lp]).

    Pass exactly one of ``input_len`` (a uniform prompt) or
    ``prompt_mask`` (a left-padded prompt; then ``max_new_tokens`` is
    required). ``max_len`` is the logical cap including the prompt.
    Greedy output equals plain greedy decode's token for token; sampling
    draws from the nucleus-filtered target distribution by exact
    rejection sampling, with ``generator`` (on the tensors' device; None
    seeds one with 0). Keyword arguments: ``max_len``, ``eos_id``,
    ``sp2_id``, ``draft_layers`` (3), ``gamma`` (4), ``mode``
    ("draft" or "ngram"), ``ngram_n`` (3), ``top_p`` (0.95),
    ``greedy``, ``generator``, ``token_type_ids``, ``prompt_mask``,
    ``max_new_tokens``, ``imgs``, ``auds``, ``caption_ids``,
    ``caption_mask``."""
    return _speculative_run(*args, **kwargs)[0]


def speculative_stats(*args, **kwargs):
    """``speculative_generate``'s output and (accepted draft tokens,
    macro steps, proposed draft tokens), as Python ints."""
    return _speculative_run(*args, **kwargs)


@torch.inference_mode()
def _speculative_run(
    params: gpt2.GPT2,
    config: ModelConfig,
    input_ids: torch.Tensor,
    input_len: Optional[int] = None,
    *,
    max_len: int,
    eos_id: int,
    sp2_id: int,
    draft_layers: int = 3,
    gamma: int = 4,
    mode: str = "draft",
    ngram_n: int = 3,
    top_p: float = 0.95,
    greedy: bool = False,
    generator: Optional[torch.Generator] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    prompt_mask: Optional[torch.Tensor] = None,
    max_new_tokens: Optional[int] = None,
    imgs: Optional[torch.Tensor] = None,
    auds: Optional[torch.Tensor] = None,
    caption_ids: Optional[torch.Tensor] = None,
    caption_mask: Optional[torch.Tensor] = None,
):
    if mode not in ("draft", "ngram"):
        raise ValueError(f"mode must be 'draft' or 'ngram', got {mode!r}")
    ngram = mode == "ngram"
    if ngram and not 0 < ngram_n <= 8:
        raise ValueError(f"ngram_n must be in [1, 8], got {ngram_n}")
    B = input_ids.shape[0]
    if B != 1:
        raise ValueError("speculative decode is a B=1 serving path; "
                         "batched serving uses generate()")
    if (input_len is None) == (prompt_mask is None):
        raise ValueError("pass exactly one of input_len / prompt_mask")
    masked = prompt_mask is not None
    if masked and max_new_tokens is None:
        raise ValueError("prompt_mask mode needs max_new_tokens")
    c = config
    device = input_ids.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dparams, dcfg = (None, None) if ngram else draft_params(params, c, draft_layers)
    cap = min(max_len, c.n_positions)

    if masked:
        Lp = input_ids.shape[1]
        pm = prompt_mask.float()
        row_len = int(pm.sum())
        max_new = int(max_new_tokens)
    else:
        input_ids = input_ids[:, :input_len]
        if token_type_ids is not None:
            token_type_ids = token_type_ids[:, :input_len]
        Lp = row_len = input_len
        max_new = int(max_new_tokens) if max_new_tokens is not None else max(cap - Lp, 1)
    # prompt + generable + one macro step of slack, so that the gamma+1
    # write window never runs past the end
    T = Lp + max_new + gamma + 1

    caption_len = caption_ids.shape[1] if caption_ids is not None else 0
    t_cache = gpt2.init_kv_cache(c, B, T, caption_len=caption_len, device=device)
    d_cache = None if ngram else gpt2.init_kv_cache(dcfg, B, T, caption_len=caption_len,
                                                   device=device)
    mask = None
    pre = {}
    if masked:
        mask = torch.zeros((B, T), dtype=torch.float32, device=device)
        mask[:, :Lp] = pm
        prompt_pos = torch.clamp_min(torch.cumsum(pm, dim=-1) - 1, 0).long()
        pre = dict(position_ids=prompt_pos, attention_mask=mask)
    common = dict(token_type_ids=token_type_ids, imgs=imgs, auds=auds,
                  caption_ids=caption_ids, encoder_attention_mask=caption_mask)
    t_out = gpt2.forward(params, c, input_ids, cache=t_cache, prefix_prefill=True,
                         compute_logits="last", **pre, **common)
    t_cache = t_out.cache
    if not ngram:
        d_cache = gpt2.forward(dparams, dcfg, input_ids, cache=d_cache, prefix_prefill=True,
                               compute_logits=False, **pre, **common).cache

    logits0 = t_out.logits[:, -1]
    first = int(torch.argmax(logits0, dim=-1) if greedy
                else _sample(_filtered(logits0, top_p), generator))
    tok = np.full(T, eos_id, np.int64)
    tok[:Lp] = input_ids[0].cpu().numpy()
    tok[Lp] = first
    if masked:
        mask[:, Lp] = 1.0
    done = first == eos_id or row_len + 1 >= cap or max_new <= 1
    cur = Lp + 1
    accepted = steps = 0

    # the pending token (and the n-gram proposals) go to the device
    # through one pinned buffer a step, without a blocking copy
    staging = torch.empty(gamma + 1, dtype=torch.long, pin_memory=device.type == "cuda")
    step_tt = torch.full((B, 1), sp2_id, dtype=torch.long, device=device)
    ver_tt = torch.full((B, gamma + 1), sp2_id, dtype=torch.long, device=device)
    rows = torch.arange(gamma, device=device)

    while not done and cur - Lp < max_new and row_len + cur - Lp < cap:
        # logical position of the pending token (physical slot cur - 1)
        base = row_len + (cur - 1 - Lp)
        if masked:
            # the in-flight window [cur-1, cur+gamma) is visible during this
            # macro step; only accepted slots persist into `mask`
            step_mask = mask.clone()
            step_mask[:, cur - 1:cur + gamma] = 1.0

            def step_kw(i, width):
                pos = torch.arange(base + i, base + i + width, device=device)[None, :]
                return dict(position_ids=torch.clamp_max(pos, c.n_positions - 1),
                            attention_mask=step_mask)
        else:
            def step_kw(i, width):
                return {}

        staging[0] = int(tok[cur - 1])
        if ngram:
            d_host = _ngram_proposals(tok, cur, ngram_n, gamma)
            staging[1:] = torch.from_numpy(d_host)
            ver_in = staging.to(device, non_blocking=True)[None]
            d_vec = ver_in[0, 1:]
            q_all = (None if greedy else
                     torch.nn.functional.one_hot(d_vec, c.vocab_size).float())
        else:
            # gamma proposals, then one cache-fill step so the draft cache
            # holds every proposal (needed when all gamma are accepted)
            x = staging[:1].to(device, non_blocking=True)[None]
            pending = x
            drafts, qs = [], []
            for g in range(gamma + 1):
                o = gpt2.forward(dparams, dcfg, x, token_type_ids=step_tt, cache=d_cache,
                                 compute_logits=g < gamma, encoder_attention_mask=caption_mask,
                                 **step_kw(g, 1))
                d_cache = o.cache
                if g == gamma:
                    break
                if greedy:
                    d = torch.argmax(o.logits[:, -1], dim=-1)
                else:
                    q = _filtered(o.logits[:, -1], top_p)
                    d = _sample(q, generator)
                    qs.append(q)
                drafts.append(d)
                x = d[:, None]
            d_vec = torch.cat(drafts)
            ver_in = torch.cat([pending, d_vec[None]], dim=1)
            q_all = None if greedy else torch.cat(qs)

        t_o = gpt2.forward(params, c, ver_in, token_type_ids=ver_tt, cache=t_cache,
                           encoder_attention_mask=caption_mask, **step_kw(0, gamma + 1))
        t_logits = t_o.logits[0]  # row i: the distribution after ver_in[i]
        if greedy:
            # the verify argmax and the proposals, one copy
            back = torch.cat([torch.argmax(t_logits, dim=-1), d_vec]).cpu().numpy()
            choice, d_host = back[:gamma + 1], back[gamma + 1:]
            ok = choice[:gamma] == d_host
            a = int(np.cumprod(ok).sum())  # leading accepts
            correction = int(choice[a])
        else:
            p_all = _filtered(t_logits, top_p)  # [gamma+1, V]
            p_d = p_all[rows, d_vec]
            q_d = q_all[rows, d_vec]
            u = torch.rand(gamma, generator=generator, device=device)
            ok = (u * q_d < p_d).long()  # accept with probability min(1, p/q)
            a_dev = torch.cumprod(ok, dim=0).sum()[None]
            # the residual at the first rejected position; with all accepted,
            # the bonus token comes from p_gamma (index_select: indexing by a
            # device scalar would wait for the device)
            p_a = p_all.index_select(0, torch.clamp_max(a_dev, gamma))[0]
            q_a = q_all.index_select(0, torch.clamp_max(a_dev, gamma - 1))[0] * (a_dev < gamma)
            resid = torch.clamp_min(p_a - q_a, 0.0)
            rsum = resid.sum()
            resid = torch.where(rsum > 0, resid / rsum, p_a)
            corr = _sample(resid[None], generator)
            back = torch.cat([a_dev, corr, d_vec]).cpu().numpy()
            a, correction, d_host = int(back[0]), int(back[1]), back[2:]

        # emit d_1..d_a and the correction; truncate at the first eos
        emit = np.append(d_host[:a], correction)
        eos_at = np.flatnonzero(emit == eos_id)
        hit_eos = eos_at.size > 0
        n_emit = int(eos_at[0]) + 1 if hit_eos else a + 1
        tok[cur:cur + n_emit] = emit[:n_emit]
        if masked:
            mask[:, cur:cur + n_emit] = 1.0
        # rollback: keep the entries of [pending, d_1..d_{n_emit-1}]
        t_cache = dataclasses.replace(t_o.cache, index=t_cache.index + n_emit)
        if not ngram:
            d_cache = dataclasses.replace(d_cache, index=d_cache.index - gamma - 1 + n_emit)
        cur += n_emit
        done = hit_eos
        accepted += a
        steps += 1

    stop = np.flatnonzero(tok[Lp:] == eos_id)
    length = Lp + int(stop[0]) + 1 if stop.size else cur
    length = min(length, Lp + max(cap - row_len, 0), Lp + max_new)
    out = GenerateOutput(tokens=torch.as_tensor(tok, device=device)[None],
                         lengths=torch.tensor([length], device=device),
                         emotion_logits=t_out.emotion_logits)
    return out, (accepted, steps, steps * gamma)
