"""KV-cached beam search over ragged prompts (counterpart of
``ergm_tpu/infer/beam.py``).

The prompt is prefilled once at B rows; the cache is then repeated to
B*W rows (W beams a row) and each step is one single-token forward of
all beams, a ``top_k`` over each row's W*V candidates, and a reorder of
the hypotheses: the token buffer, the finished flags and every cache
tensor are gathered along the beam axis. Prompts use ``generate``'s
left-padded layout (each row's last real token at slot Lp-1, logical
positions in explicit position ids, pads masked).

Scoring follows HF's beam semantics: summed token log-probabilities;
finished beams (and rows at their logical cap) are frozen by allowing
only eos at zero added score; the final rank is score /
gen_len**length_penalty.

Over a mesh (``beam_search_batch(mesh=...)``) each data rank searches its
rows on its model rank's heads, as ``generate_batch`` decodes them; the
beam reorder stays within a rank's rows and heads.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.mesh import ALL, batch_rows, fill_rows, pad_rows
from ergm_tpu_torch.infer.generate import _DONE_CHECK_EVERY, gathered_results, pack_ragged_batch
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.parallel.collectives import agree

_NEG = -1e9
# the self-attention cache fields, [L, B*W, H, T, ...]: the ones a beam
# reorder must gather (the int8 scales included)
_SELF_FIELDS = ("k", "v", "k_scale", "v_scale")


class BeamOutput(NamedTuple):
    tokens: torch.Tensor          # [B, max_len] best hypothesis per row
    lengths: torch.Tensor         # [B] physical length (first eos at/after Lp, +1)
    emotion_logits: torch.Tensor  # [B, num_emotions] from the prompt's last token


@dataclasses.dataclass
class BeamState:
    """The loop's state: ``tokens`` [B, W, T], ``scores`` [B, W] summed
    log-probs, ``cache`` (B*W rows), ``mask`` [B*W, T] over the buffer,
    ``cur`` the physical slot to fill, ``last`` [B, W] the tokens at
    ``cur - 1``, ``finished`` [B, W]."""

    tokens: torch.Tensor
    scores: torch.Tensor
    cache: gpt2.KVCache
    mask: torch.Tensor
    cur: int
    last: torch.Tensor
    finished: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BeamRows:
    """What the steps of one search share: the prompt bucket ``Lp``, the
    vocabulary ``V``, the buffer length, eos, each row's logical cap and
    prompt length (``row_len`` [B], repeated per beam in ``row_len_bw``),
    the caption mask per beam, each row's first beam in the flat batch
    (``offsets`` [B, 1]), the frozen beams' log-probs ``eos_row`` [V]
    (0 for eos, -1e9 elsewhere) and the prefill's emotion logits."""

    Lp: int
    V: int
    max_len: int
    eos_id: int
    logical_cap: int
    row_len: torch.Tensor
    row_len_bw: torch.Tensor
    cap_mask: Optional[torch.Tensor]
    offsets: torch.Tensor
    eos_row: torch.Tensor
    emotion_logits: torch.Tensor


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row, ties to the lower index
    (``lax.top_k``'s order): frozen beams make many exact ties, and the
    order decides which hypotheses are kept."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_beams(cache: gpt2.KVCache, flat: torch.Tensor, lo: int, hi: int) -> None:
    """Reorder the self-attention cache IN PLACE: row r of every field
    takes row ``flat[r]``'s slots [lo, hi). The slots before ``lo`` (the
    prompt, repeated from one prefill row) are equal across a row's beams
    and the slots from ``hi`` on are unwritten, so only [lo, hi) moves.
    The caption cache (``ck``/``cv`` and their scales) is not gathered:
    beams only move within a row, whose W copies of it are equal."""
    for f in _SELF_FIELDS:
        x = getattr(cache, f)
        if x is not None:
            x[:, :, :, lo:hi] = x[:, :, :, lo:hi].index_select(1, flat)


@torch.inference_mode()
def beam_start(
    params: gpt2.GPT2,
    config: ModelConfig,
    input_ids: torch.Tensor,  # [B, Lp]; left-padded when prompt_mask given
    input_len: Optional[int] = None,
    *,
    num_beams: int,
    max_len: int,
    eos_id: int,
    token_type_ids: Optional[torch.Tensor] = None,
    prompt_mask: Optional[torch.Tensor] = None,  # [B, Lp] 1=real (left-pad mode)
    imgs: Optional[torch.Tensor] = None,
    auds: Optional[torch.Tensor] = None,
    caption_ids: Optional[torch.Tensor] = None,
    caption_mask: Optional[torch.Tensor] = None,
    logical_cap: Optional[int] = None,
    mesh=None,
) -> Tuple[BeamState, BeamRows]:
    """The prefill and the first expansion: returns the loop's state and
    what its steps share. ``mesh``: this rank's rows, ``params`` its shard."""
    if (input_len is None) == (prompt_mask is None):
        raise ValueError("pass exactly one of input_len / prompt_mask")
    if logical_cap is None:
        logical_cap = max_len
    device = input_ids.device
    if input_len is not None:
        input_ids = input_ids[:, :input_len]
        if token_type_ids is not None:
            token_type_ids = token_type_ids[:, :input_len]
        prompt_mask = torch.ones(input_ids.shape, dtype=torch.float32, device=device)
    B, Lp = input_ids.shape
    W = num_beams
    prompt_mask = prompt_mask.float()
    caption_len = caption_ids.shape[1] if caption_ids is not None else 0

    mask = torch.zeros((B, max_len), dtype=torch.float32, device=device)
    mask[:, :Lp] = prompt_mask
    prompt_pos = torch.clamp_min(torch.cumsum(prompt_mask, dim=-1) - 1, 0).long()
    row_len = prompt_mask.sum(dim=-1).long()

    cache = gpt2.init_kv_cache(config, B, max_len, caption_len=caption_len, device=device,
                               mesh=mesh)
    out = gpt2.forward(params, config, input_ids, token_type_ids=token_type_ids,
                       position_ids=prompt_pos, attention_mask=mask, imgs=imgs, auds=auds,
                       caption_ids=caption_ids, encoder_attention_mask=caption_mask,
                       cache=cache, prefix_prefill=True, compute_logits="last", mesh=mesh)
    logp0 = torch.log_softmax(out.logits[:, -1].float(), dim=-1)  # [B, V]
    V = logp0.shape[-1]

    # every tensor of the cache, the int8 scales included, goes to B*W rows
    cache = dataclasses.replace(out.cache, **{
        f.name: getattr(out.cache, f.name).repeat_interleave(W, dim=1)
        for f in dataclasses.fields(out.cache)
        if f.name != "index" and getattr(out.cache, f.name) is not None})

    # the first expansion: the top-W tokens of each row's prefill
    # distribution; rows already at their logical cap take eos
    top_scores, top_tok = _top_k(logp0, W)
    full0 = (row_len >= logical_cap)[:, None]
    top_tok = torch.where(full0, eos_id, top_tok)
    tokens = torch.full((B, W, max_len), eos_id, dtype=torch.long, device=device)
    tokens[:, :, :Lp] = input_ids[:, None, :]
    mask_bw = mask.repeat_interleave(W, dim=0)
    if Lp < max_len:
        tokens[:, :, Lp] = top_tok
        mask_bw[:, Lp] = 1.0
    eos_row = torch.full((V,), _NEG, device=device)
    eos_row[eos_id] = 0.0
    rows = BeamRows(Lp=Lp, V=V, max_len=max_len, eos_id=eos_id, logical_cap=logical_cap,
                    row_len=row_len, row_len_bw=row_len.repeat_interleave(W),
                    cap_mask=(None if caption_mask is None
                              else caption_mask.repeat_interleave(W, 0)),
                    offsets=(torch.arange(B, device=device) * W)[:, None], eos_row=eos_row,
                    emotion_logits=out.emotion_logits)
    state = BeamState(tokens=tokens, scores=top_scores, cache=cache, mask=mask_bw,
                      cur=min(Lp + 1, max_len), last=top_tok,
                      finished=(top_tok == eos_id) | full0)
    return state, rows


@torch.inference_mode()
def beam_step(params: gpt2.GPT2, config: ModelConfig, s: BeamState, rows: BeamRows,
              sp2_id: int, mesh=None) -> BeamState:
    """One step of every beam: a single-token forward, the top W of each
    row's W*V candidates, and the hypotheses reordered."""
    B, W = s.scores.shape
    V, Lp, cur = rows.V, rows.Lp, s.cur
    step_tt = torch.full((B * W, 1), sp2_id, dtype=torch.long, device=s.tokens.device)
    # s.last sits at physical slot cur-1 -> logical row_len + (cur-1-Lp)
    step_pos = torch.clamp_max(rows.row_len_bw + (cur - 1 - Lp), config.n_positions - 1)
    o = gpt2.forward(params, config, s.last.reshape(B * W, 1), token_type_ids=step_tt,
                     position_ids=step_pos[:, None], attention_mask=s.mask,
                     encoder_attention_mask=rows.cap_mask, cache=s.cache, mesh=mesh)
    logp = torch.log_softmax(o.logits[:, -1].float(), dim=-1).view(B, W, V)
    # finished beams and rows at their logical cap may only emit eos, at
    # no added cost
    at_cap = (rows.row_len + (cur - Lp)) >= rows.logical_cap
    freeze = s.finished | at_cap[:, None]
    logp = torch.where(freeze[..., None], rows.eos_row, logp)
    flat_scores, flat_idx = _top_k((s.scores[..., None] + logp).view(B, W * V), W)
    beam_idx = flat_idx // V  # [B, W]
    tok = flat_idx % V

    tokens = torch.gather(s.tokens, 1, beam_idx[..., None].expand(-1, -1, s.tokens.shape[-1]))
    tokens[:, :, cur] = tok
    finished = torch.gather(s.finished, 1, beam_idx) | (tok == rows.eos_id)
    _gather_beams(o.cache, (beam_idx + rows.offsets).view(-1), Lp, o.cache.index)
    s.mask[:, cur] = 1.0
    return BeamState(tokens=tokens, scores=flat_scores, cache=o.cache, mask=s.mask,
                     cur=cur + 1, last=tok, finished=finished)


@torch.inference_mode()
def beam_finish(s: BeamState, rows: BeamRows, length_penalty: float) -> BeamOutput:
    """Each row's best hypothesis by score / gen_len**length_penalty."""
    Lp, max_len = rows.Lp, rows.max_len
    pos = torch.arange(max_len, device=s.tokens.device)
    is_stop = (s.tokens == rows.eos_id) & (pos >= Lp)
    lengths = torch.where(is_stop.any(dim=-1), is_stop.int().argmax(dim=-1) + 1, max_len)
    gen_len = torch.clamp_min((lengths - Lp).float(), 1.0)
    best = torch.argmax(s.scores / gen_len ** length_penalty, dim=-1)  # [B]
    tokens = torch.gather(s.tokens, 1, best[:, None, None].expand(-1, 1, max_len))[:, 0]
    return BeamOutput(tokens=tokens, lengths=torch.gather(lengths, 1, best[:, None])[:, 0],
                      emotion_logits=rows.emotion_logits)


@torch.inference_mode()
def beam_search(
    params: gpt2.GPT2,
    config: ModelConfig,
    input_ids: torch.Tensor,
    input_len: Optional[int] = None,
    *,
    num_beams: int,
    max_len: int,
    eos_id: int,
    sp2_id: int,
    length_penalty: float = 1.0,
    token_type_ids: Optional[torch.Tensor] = None,
    prompt_mask: Optional[torch.Tensor] = None,
    imgs: Optional[torch.Tensor] = None,
    auds: Optional[torch.Tensor] = None,
    caption_ids: Optional[torch.Tensor] = None,
    caption_mask: Optional[torch.Tensor] = None,
    logical_cap: Optional[int] = None,
    mesh=None,
) -> BeamOutput:
    """Uniform mode: pass ``input_len``. Ragged mode: pass a left-pad
    ``prompt_mask`` (``generate``'s layout). ``max_len`` sizes the
    physical buffer; ``logical_cap`` (default ``max_len``) bounds each
    row's logical length. ``mesh``: this rank's rows, ``params`` its
    shard; every rank of the mesh leaves the loop at one step."""
    s, rows = beam_start(params, config, input_ids, input_len, num_beams=num_beams,
                         max_len=max_len, eos_id=eos_id, token_type_ids=token_type_ids,
                         prompt_mask=prompt_mask, imgs=imgs, auds=auds,
                         caption_ids=caption_ids, caption_mask=caption_mask,
                         logical_cap=logical_cap, mesh=mesh)
    group = None if mesh is None else mesh.group(ALL)
    while s.cur < max_len:
        # a step after every beam is finished keeps every hypothesis where
        # it is (each beam's only candidate is eos at no cost, and the
        # scores are in descending order), so the flag is read every
        # _DONE_CHECK_EVERY steps only
        if (s.cur - rows.Lp - 1) % _DONE_CHECK_EVERY == 0 and agree(
                bool(s.finished.all()), group, s.tokens.device):
            break
        s = beam_step(params, config, s, rows, sp2_id, mesh)
    return beam_finish(s, rows, length_penalty)


def beam_search_batch(
    params: gpt2.GPT2,
    config: ModelConfig,
    prompts: Sequence[Sequence[int]],
    *,
    num_beams: int,
    max_len: int,
    eos_id: int,
    sp2_id: int,
    token_types: Optional[Sequence[Sequence[int]]] = None,
    imgs: Optional[np.ndarray] = None,
    auds: Optional[np.ndarray] = None,
    captions: Optional[Sequence[Optional[Sequence[int]]]] = None,
    max_new_tokens: Optional[int] = None,
    length_penalty: float = 1.0,
    prompt_bucket: int = 64,
    caption_bucket: int = 32,
    mesh=None,
) -> Tuple[List[List[int]], np.ndarray]:
    """Batched beam decode over ragged prompts on the device of
    ``params`` (the beam counterpart of ``generate_batch``): one
    ``beam_search`` for the whole left-padded batch; returns each row's
    continuation ids (eos included when emitted) and emotion logits.
    ``mesh``: ``generate_batch``'s placement (fill rows, each data rank's
    rows, the results gathered; every rank returns the whole list)."""
    ids, mask, tts, cap_ids, cap_mask, buffer_len = pack_ragged_batch(
        prompts, eos_id=eos_id, sp2_id=sp2_id, n_positions=config.n_positions,
        max_len=max_len, token_types=token_types, captions=captions,
        prompt_bucket=prompt_bucket, caption_bucket=caption_bucket,
        max_new_tokens=max_new_tokens)
    B, Lp = ids.shape
    device = next(params.parameters()).device

    def dev(x, dtype=None):
        return None if x is None else torch.as_tensor(x, dtype=dtype, device=device)

    if mesh is not None:
        n = fill_rows(B, mesh)
        lo, hi = batch_rows(n, mesh)
        ids, mask, tts, cap_ids, cap_mask, imgs, auds = (
            None if x is None else pad_rows(x, n)[lo:hi]
            for x in (ids, mask, tts, cap_ids, cap_mask, imgs, auds))
    out = beam_search(
        params, config, dev(ids, torch.long), prompt_mask=dev(mask), num_beams=num_beams,
        max_len=buffer_len, logical_cap=min(max_len, config.n_positions), eos_id=eos_id,
        sp2_id=sp2_id, length_penalty=length_penalty,
        token_type_ids=dev(tts, torch.long) if token_types is not None else None,
        imgs=dev(imgs), auds=dev(auds), caption_ids=dev(cap_ids, torch.long),
        caption_mask=dev(cap_mask), mesh=mesh)
    return gathered_results(out, Lp, B, mesh)
