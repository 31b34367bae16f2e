"""KV-cached nucleus-sampling generation (counterpart of
``ergm_tpu/infer/generate.py``).

The prompt is prefilled once into a fixed-size cache, then each new
token is one single-position step of a Python loop. Variable-length
prompts are LEFT-padded so every row's last real token sits at the same
slot; logical positions ride in explicit position ids and pads stay
masked out of attention. Generated tokens carry the sp2 token type;
rows stop at eos or at their logical cap.

Over a mesh (``generate_batch(mesh=...)``) one process drives one
device: the batch is padded to a multiple of the data axis, each data
rank decodes its rows on its model rank's heads (``gpt2.forward(mesh=)``),
and the tokens, lengths and emotion logits are all-gathered over the data
axis, so every rank returns the whole batch. Sampled rows draw the
one-process run's noise: each rank draws the global batch's Gumbel noise
from its generator (seeded alike on every rank) and keeps its rows.
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.mesh import ALL, DATA_AXIS, batch_rows, fill_rows, pad_rows
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.parallel.collectives import agree, all_gather_rows

# The loop reads the device's all-rows-done flag only every this many
# steps: a step after every row is done writes only eos where the
# buffer already holds eos, so the output is the same, and the host
# does not stall on the device each step.
_DONE_CHECK_EVERY = 8


def _gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u in [tiny, 1) (as
    ``jax.random.gumbel``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def row_noise(k: int, generator: Optional[torch.Generator], device,
              rows: Tuple[int, int, int]) -> torch.Tensor:
    """Gumbel noise for rows [lo, hi) of a batch of n real rows, ``rows =
    (lo, hi, n)``: the [n, k] draw of one process, zero for fill rows past
    n, so that every rank of a mesh advances its generator alike and each
    row meets the noise it meets in one process."""
    lo, hi, n = rows
    g = _gumbel((n, k), generator, device)
    if hi > n:
        g = torch.cat([g, g.new_zeros((hi - n, k))])
    return g[lo:hi]


def top_p_filter(probs: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep the smallest descending-sorted prefix whose cumulative
    probability exceeds ``top_p`` (the first token always), zero the rest,
    renormalize. The full-vocab form, for the exact parity mode."""
    sorted_idx = torch.argsort(probs, dim=-1, stable=True).flip(-1)
    sorted_probs = torch.gather(probs, -1, sorted_idx)
    remove = torch.cumsum(sorted_probs, dim=-1) > top_p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
    kept = torch.where(remove, 0.0, sorted_probs)
    kept = kept / torch.clamp_min(kept.sum(dim=-1, keepdim=True), 1e-20)
    return torch.zeros_like(probs).scatter(-1, sorted_idx, kept)


def sample_top_p(logits: torch.Tensor, generator: Optional[torch.Generator],
                 top_p: Union[float, torch.Tensor], top_k: int = 64,
                 gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample from the top-p nucleus of the ``top_k`` most probable tokens.
    ``top_p`` is one float or a [B, 1] tensor of per-row cutoffs (the
    server's rows each carry their own).

    The top-k comes from the exact ``torch.topk`` (JAX's TPU path uses an
    approximate top-k; off the TPU it is exact too). The cutoff is taken
    in sorted space with true probabilities (a full-vocab logsumexp) and
    the draw is Gumbel-max, ``argmax(log(kept) + g)``, which is what
    ``jax.random.categorical`` computes. ``gumbel`` [B, k] injects the
    noise (tests feed JAX's draws); otherwise it comes from ``generator``."""
    logits = logits.float()
    k = min(top_k, logits.shape[-1])
    lvals, idx = torch.topk(logits, k, dim=-1)
    vals = torch.exp(lvals - torch.logsumexp(logits, dim=-1, keepdim=True))
    remove = torch.cumsum(vals, dim=-1) > top_p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
    kept = torch.where(remove, 0.0, vals)
    if gumbel is None:
        gumbel = _gumbel(kept.shape, generator, kept.device)
    choice = torch.argmax(torch.log(torch.clamp_min(kept, 1e-20)) + gumbel, dim=-1)
    return torch.gather(idx, -1, choice[:, None])[:, 0]


class GenerateOutput(NamedTuple):
    tokens: torch.Tensor          # [B, T] physical buffer (prompt + continuation)
    lengths: torch.Tensor         # [B] physical length incl. the prompt slots
    emotion_logits: torch.Tensor  # [B, num_emotions] from the prompt's last token


@torch.inference_mode()
def generate(
    params: gpt2.GPT2,
    config: ModelConfig,
    input_ids: torch.Tensor,         # [B, Lp] prompts; left-padded if prompt_mask given
    input_len: Optional[int] = None,  # uniform true prompt length
    *,
    max_len: int,                    # physical buffer / logical cap
    eos_id: int,
    sp2_id: int,
    top_p: float = 0.95,
    generator: Optional[torch.Generator] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    prompt_mask: Optional[torch.Tensor] = None,  # [B, Lp] 1=real (left-pad mode)
    imgs: Optional[torch.Tensor] = None,
    auds: Optional[torch.Tensor] = None,
    caption_ids: Optional[torch.Tensor] = None,
    caption_mask: Optional[torch.Tensor] = None,  # [B, Lc] 1=real caption token
    greedy: bool = False,
    temperature: float = 1.0,
    logical_cap: Optional[int] = None,
    sample_top_k: int = 64,  # 0 => exact full-sort nucleus (parity mode)
    mesh=None,
    rows: Optional[Tuple[int, int, int]] = None,
) -> GenerateOutput:
    """Uniform mode: pass ``input_len`` (all rows share a true length).
    Batched mode: pass a left-pad ``prompt_mask``. ``max_len`` sizes the
    physical buffer; ``logical_cap`` (default max_len) bounds each row's
    logical length. ``generator`` (on the tensors' device) drives the
    sampling; None seeds a fresh one with 0.

    ``mesh``: the inputs are this rank's rows and ``params`` this rank's
    shard; ``rows = (lo, hi, n)`` places them in a batch of n real rows
    (default: ``batch_rows`` of every rank's rows, all real), whose noise
    the sampler draws (``row_noise``). The output is this rank's rows.
    Every rank of the mesh leaves the loop at one step (``agree``)."""
    device = input_ids.device
    if logical_cap is None:
        logical_cap = max_len
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if (input_len is None) == (prompt_mask is None):
        raise ValueError("pass exactly one of input_len / prompt_mask")
    if input_len is not None:
        input_ids = input_ids[:, :input_len]
        if token_type_ids is not None:
            token_type_ids = token_type_ids[:, :input_len]
        prompt_mask = torch.ones(input_ids.shape, dtype=torch.float32, device=device)
    B, Lp = input_ids.shape
    prompt_mask = prompt_mask.float()
    if mesh is not None and rows is None:
        n = B * mesh.axis_size(DATA_AXIS)
        rows = (*batch_rows(n, mesh), n)
    # every rank of the mesh leaves the loop at one step: one process's
    # step, so that sampling draws its noise in every step, across calls too
    everyone = None if mesh is None else mesh.group(ALL)

    caption_len = caption_ids.shape[1] if caption_ids is not None else 0
    cache = gpt2.init_kv_cache(config, B, max_len, caption_len=caption_len, device=device,
                               mesh=mesh)
    # full-width mask over the physical buffer; the tail starts masked
    mask = torch.zeros((B, max_len), dtype=torch.float32, device=device)
    mask[:, :Lp] = prompt_mask
    # logical positions: pads clipped to 0, real tokens 0..len-1
    prompt_pos = torch.clamp_min(torch.cumsum(prompt_mask, dim=-1) - 1, 0).long()
    row_len = prompt_mask.sum(dim=-1).long()

    out = gpt2.forward(params, config, input_ids, token_type_ids=token_type_ids,
                       position_ids=prompt_pos, attention_mask=mask, imgs=imgs, auds=auds,
                       caption_ids=caption_ids, encoder_attention_mask=caption_mask,
                       cache=cache, prefix_prefill=True, compute_logits="last", mesh=mesh)

    def noise(k):
        return None if rows is None else row_noise(k, generator, device, rows)

    def sample(logits):
        if greedy:
            return torch.argmax(logits, dim=-1)
        if temperature != 1.0:
            logits = logits / max(temperature, 1e-6)
        if sample_top_k:
            return sample_top_p(logits, generator, top_p, top_k=sample_top_k,
                                gumbel=noise(min(sample_top_k, logits.shape[-1])))
        filtered = top_p_filter(torch.softmax(logits.float(), dim=-1), top_p)
        g = noise(filtered.shape[-1])
        if g is None:
            g = _gumbel(filtered.shape, generator, device)
        return torch.argmax(torch.log(torch.clamp_min(filtered, 1e-20)) + g, dim=-1)

    first = sample(out.logits[:, -1, :])
    tokens = torch.full((B, max_len), eos_id, dtype=torch.long, device=device)
    tokens[:, :Lp] = input_ids
    full0 = row_len >= logical_cap  # rows already at the cap cannot grow
    done = (first == eos_id) | full0
    if Lp < max_len:
        tokens[:, Lp] = torch.where(full0, eos_id, first)
        mask[:, Lp] = 1.0
    cache = out.cache
    cur = min(Lp + 1, max_len)
    last = first[:, None]
    step_tt = torch.full((B, 1), sp2_id, dtype=torch.long, device=device)
    while cur < max_len:
        if (cur - Lp - 1) % _DONE_CHECK_EVERY == 0 and agree(bool(done.all()), everyone,
                                                             device):
            break
        # `last` sits at physical slot cur-1 -> logical row_len + (cur-1-Lp)
        step_pos = torch.clamp_max(row_len + (cur - 1 - Lp), config.n_positions - 1)[:, None]
        o = gpt2.forward(params, config, last, token_type_ids=step_tt, position_ids=step_pos,
                         attention_mask=mask, encoder_attention_mask=caption_mask, cache=cache,
                         mesh=mesh)
        nxt = sample(o.logits[:, -1, :])
        at_cap = (row_len + (cur - Lp)) >= logical_cap
        nxt = torch.where(done | at_cap, eos_id, nxt)
        tokens[:, cur] = nxt
        mask[:, cur] = 1.0
        done = done | (nxt == eos_id)
        cache, last, cur = o.cache, nxt[:, None], cur + 1

    # physical length: first eos at/after slot Lp (+1), else max_len
    pos = torch.arange(max_len, device=device)[None, :]
    is_stop = (tokens == eos_id) & (pos >= Lp)
    lengths = torch.where(is_stop.any(dim=-1), is_stop.int().argmax(dim=-1) + 1, max_len)
    return GenerateOutput(tokens=tokens, lengths=lengths, emotion_logits=out.emotion_logits)


def _bucket(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pack_ragged_batch(
    prompts: Sequence[Sequence[int]],
    *,
    eos_id: int,
    sp2_id: int,
    n_positions: int,
    max_len: int,
    token_types: Optional[Sequence[Sequence[int]]] = None,
    captions: Optional[Sequence[Optional[Sequence[int]]]] = None,
    prompt_bucket: int = 64,
    caption_bucket: int = 32,
    max_new_tokens: Optional[int] = None,
):
    """Left-pad prompts (every row's last real token at slot Lp-1),
    right-pad captions, and size the decode buffer.

    Returns (ids, mask, tts, cap_ids, cap_mask, buffer_len) as numpy
    arrays (cap_* are None when no sample carries a caption)."""
    B = len(prompts)
    lens = [len(p) for p in prompts]
    Lp = _bucket(max(lens), prompt_bucket)
    ids = np.full((B, Lp), eos_id, np.int32)
    mask = np.zeros((B, Lp), np.float32)
    tts = np.full((B, Lp), sp2_id, np.int32)
    for b, p in enumerate(prompts):
        ids[b, Lp - len(p):] = p
        mask[b, Lp - len(p):] = 1.0
        if token_types is not None:
            tts[b, Lp - len(p):] = token_types[b]
    cap_ids = cap_mask = None
    if captions is not None and any(c is not None and len(c) for c in captions):
        Lc = _bucket(max(len(c) if c else 1 for c in captions), caption_bucket)
        cap_ids = np.full((B, Lc), eos_id, np.int32)
        # caption-less rows keep an all-zero mask: the model zeroes their
        # cross-attention residual (gpt2._capless_row_gate)
        cap_mask = np.zeros((B, Lc), np.float32)
        for b, c in enumerate(captions):
            if c is not None and len(c):
                cap_ids[b, :len(c)] = c
                cap_mask[b, :len(c)] = 1.0
    cap = min(max_len, n_positions)
    new_cap = max_new_tokens if max_new_tokens is not None else max(cap - min(lens), 0)
    buffer_len = Lp + max(new_cap, 1)
    return ids, mask, tts, cap_ids, cap_mask, buffer_len


def generate_batch(
    params: gpt2.GPT2,
    config: ModelConfig,
    prompts: Sequence[Sequence[int]],
    *,
    max_len: int,
    eos_id: int,
    sp2_id: int,
    top_p: float = 0.95,
    generator: Optional[torch.Generator] = None,
    token_types: Optional[Sequence[Sequence[int]]] = None,
    imgs: Optional[np.ndarray] = None,
    auds: Optional[np.ndarray] = None,
    captions: Optional[Sequence[Optional[Sequence[int]]]] = None,
    greedy: bool = False,
    prompt_bucket: int = 64,
    caption_bucket: int = 32,
    max_new_tokens: Optional[int] = None,
    sample_top_k: int = 64,
    draft_layers: int = 0,
    spec_gamma: int = 4,
    spec_mode: str = "auto",
    spec_ngram: int = 3,
    mesh=None,
) -> Tuple[List[List[int]], np.ndarray]:
    """Batched decode over ragged prompts on the device of ``params``.

    Left-pads prompts to a bucketed width and returns per-sample
    continuation token lists (eos included when emitted) plus the
    emotion logits of each prompt's last token. ``captions``: per-sample
    caption ids, right-padded and masked.

    Routing, as JAX's (``ergm_tpu/infer/generate.py:422-469``):
    ``spec_mode="auto"`` takes ``"draft"`` when ``draft_layers`` is set,
    ``"ngram"`` (prompt lookup) for a greedy B=1 request, and ``"none"``
    otherwise. A B=1 request in a speculative mode goes to
    ``speculative.speculative_generate`` (a self-draft of the first
    ``draft_layers`` blocks, or n-gram proposals of ``spec_ngram``
    tokens; ``spec_gamma`` proposals a step; greedy output equals the
    plain route's, and sampling there is full-vocab nucleus, so
    ``sample_top_k`` does not apply). A larger batch in a speculative
    mode warns and takes the plain route: one ``generate`` for the whole
    batch.

    ``mesh`` (``core/mesh.py``; every rank calls this with the same
    arguments, ``params`` its shard, ``generator`` seeded alike): the
    batch is padded to a multiple of the data axis by repeating its last
    row, each data rank decodes its contiguous rows, and the results are
    all-gathered over the data axis; the fill rows are dropped and every
    rank returns the whole list. A request that would take a speculative
    route takes the plain one with JAX's warning: speculative decoding is
    a B=1 single-device path."""
    ids, mask, tts, cap_ids, cap_mask, buffer_len = pack_ragged_batch(
        prompts, eos_id=eos_id, sp2_id=sp2_id, n_positions=config.n_positions,
        max_len=max_len, token_types=token_types, captions=captions,
        prompt_bucket=prompt_bucket, caption_bucket=caption_bucket,
        max_new_tokens=max_new_tokens)
    B, Lp = ids.shape
    cap = min(max_len, config.n_positions)
    device = next(params.parameters()).device

    def dev(x, dtype=None):
        return None if x is None else torch.as_tensor(x, dtype=dtype, device=device)

    if spec_mode == "auto":
        # JAX's measured default: greedy B=1 takes prompt lookup, which
        # costs nothing to draft; sampled and batched requests stay plain
        if draft_layers:
            spec_mode = "draft"
        elif greedy and B == 1 and mesh is None:
            spec_mode = "ngram"
        else:
            spec_mode = "none"
    if spec_mode != "none" and (draft_layers or spec_mode == "ngram"):
        if B == 1 and mesh is None:
            from ergm_tpu_torch.infer import speculative  # it imports this module

            out = speculative.speculative_generate(
                params, config, dev(ids, torch.long), prompt_mask=dev(mask), max_len=cap,
                max_new_tokens=buffer_len - Lp, eos_id=eos_id, sp2_id=sp2_id, top_p=top_p,
                greedy=greedy, draft_layers=draft_layers, gamma=spec_gamma, mode=spec_mode,
                ngram_n=spec_ngram, generator=generator,
                token_type_ids=dev(tts, torch.long) if token_types is not None else None,
                imgs=dev(imgs), auds=dev(auds), caption_ids=dev(cap_ids, torch.long),
                caption_mask=dev(cap_mask))
            length = int(out.lengths[0])
            return ([out.tokens[0, Lp:length].tolist()],
                    out.emotion_logits.float().cpu().numpy())
        warnings.warn(f"speculative decode (draft_layers={draft_layers}, spec_mode={spec_mode}) "
                      f"is a B=1 single-device path; this call has B={B}"
                      f"{' and a mesh' if mesh is not None else ''}: falling back to standard "
                      f"batched decode")
    rows = None
    if mesh is not None:
        n = fill_rows(B, mesh)
        lo, hi = batch_rows(n, mesh)
        rows = (lo, hi, B)
        ids, mask, tts, cap_ids, cap_mask, imgs, auds = (
            None if x is None else pad_rows(x, n)[lo:hi]
            for x in (ids, mask, tts, cap_ids, cap_mask, imgs, auds))
    out = generate(
        params, config, dev(ids, torch.long), prompt_mask=dev(mask), max_len=buffer_len,
        eos_id=eos_id, sp2_id=sp2_id, top_p=top_p, generator=generator,
        token_type_ids=dev(tts, torch.long) if token_types is not None else None,
        imgs=dev(imgs), auds=dev(auds), caption_ids=dev(cap_ids, torch.long),
        caption_mask=dev(cap_mask), greedy=greedy,
        logical_cap=cap, sample_top_k=sample_top_k, mesh=mesh, rows=rows)
    return gathered_results(out, Lp, B, mesh)


def gathered_results(out, Lp: int, B: int, mesh) -> Tuple[List[List[int]], np.ndarray]:
    """Each of the first ``B`` rows' continuation (slots Lp to its length)
    and emotion logits; over a mesh every data rank's rows are gathered
    first."""
    group = None if mesh is None else mesh.group(DATA_AXIS)
    tokens = all_gather_rows(out.tokens, group).cpu().numpy()
    lengths = all_gather_rows(out.lengths, group).cpu().numpy()
    emo = all_gather_rows(out.emotion_logits.float(), group).cpu().numpy()
    return [tokens[b, Lp:lengths[b]].tolist() for b in range(B)], emo[:B]
