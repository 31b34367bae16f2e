"""Continuous-batching server (counterpart of ``ergm_tpu/infer/server.py``).

``generate`` decodes a batch until its LAST row finishes, and new
requests wait for the next batch. The server instead keeps a fixed set
of decode slots busy: requests join and leave at block boundaries.

- ONE KV cache per slot pool, ``[L, S, H, T, Dh]``, with per-slot write
  cursors (``cache.index`` is an [S] int32 tensor): slot i's tokens lie
  at physical positions ``[0, index[i])``, physical position == logical
  position. Each decode step writes every row's K/V at its own cursor
  and row i sees the keys at ``kpos <= index[i]``, so no attention mask
  is carried.
- **Grouped admission**: queued prompts are prefilled together, one
  left-padded 64-row prefill per prompt bucket (kernel K1 at buckets up
  to 128, K5 at 256 and 384), then joined: each row is left-aligned
  into ``[0, len)`` of its slot, which sets the slot's cursor and its
  per-row state (pending token, greedy/top-p/temperature, first token
  and its logprob, emotion logits, caption mask).
- **Decode blocks**: one block advances every slot ``sync_every`` steps
  (or fewer while draining) with no host read. Its tokens, the rows'
  first tokens and logprobs, and the emotion rows come back in ONE
  non-blocking copy into pinned memory, waited on once at harvest.
  Finished rows keep decoding junk until the block ends (their writes
  past capacity drop); the host discards tokens past eos and frees the
  slot. Quantized caches (int8, int4) decode STAGED: each step writes
  compute-dtype staging buffers at a uniform index, and one
  ``gpt2.flush_staging`` a block quantizes and commits them.
- **Capacity ladder**: a decode step reads the whole cache, so each
  pool's capacity sits on a ``cache_grow_step`` ladder tracking the
  longest active row plus one block of writes (``_Slot.phys_len``, the
  host's mirror of the cursors): pad-copied up a rung when needed,
  slice-copied down when the need halves.
- **Tiers**: ``long_slots`` gives long requests a pool of their own
  (its own cache and rung); ``kv_cache_dtype="auto"`` then serves the
  short pool from a compute-dtype cache and the long pool from an int8
  staged one.

Greedy output through the server is byte-identical to ``generate``.
Sampling shares ``generate``'s nucleus sampler: one device generator
drives the decode steps (seeded by ``reset``), and each admission group
draws its first tokens from ``fold_seed(lead request's seed, admission
counter)``; sampled streams depend on the schedule.

Not ported yet (``ROADMAP.md`` queue 1 item 5): sessions, chunked
prefill, speculative serving and the slot-axis mesh.
"""

from __future__ import annotations

import dataclasses
import numbers
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.rng import fold_seed
from ergm_tpu_torch.infer.generate import sample_top_p
from ergm_tpu_torch.models import gpt2

_NOT_PORTED = "is not ported to the PyTorch server yet (ROADMAP.md queue 1 item 5)"


@dataclass
class Request:
    """One generation request: prompt ids and optional tri-modal inputs."""
    prompt_ids: List[int]
    token_type_ids: Optional[List[int]] = None
    img: Optional[np.ndarray] = None
    aud: Optional[np.ndarray] = None
    caption_ids: Optional[List[int]] = None
    max_new_tokens: int = 128
    greedy: bool = False
    top_p: float = 0.95
    # logit divisor before the top-p cutoff; greedy rows ignore it
    temperature: float = 1.0
    seed: int = 0
    # token-id sequences that end generation when the emitted stream ends
    # with one (the match stays in the output, like eos); a flat [ids...]
    # is one sequence. Checked on the host at harvest.
    stop: Optional[List[List[int]]] = None
    # per-token logprobs of the emitted tokens under the full untempered
    # softmax
    logprobs: bool = False
    # called once per harvested block with (request_id, new_tokens, done);
    # in pipelined mode one block late
    stream_cb: Optional[Callable[[int, List[int], bool], None]] = None
    # multi-turn session continuation: not ported (submit raises)
    session_id: Optional[str] = None
    # tiered pools: "long" / "short" pins the pool; None routes by length
    pool: Optional[str] = None


_MAX_STOP_SEQS = 16
_MAX_STOP_LEN = 64


def _norm_stop(stop) -> Optional[List[List[int]]]:
    """A stop spec as [[ids...], ...]: a flat [ids...] (Python or numpy
    integers) is one sequence. Empty sequences, malformed shapes, more
    than 16 sequences or one of more than 64 tokens raise ValueError."""
    if isinstance(stop, np.ndarray):
        stop = stop.tolist()
    if not stop:
        return None
    if all(isinstance(t, numbers.Integral) and not isinstance(t, bool) for t in stop):
        stop = [[int(t) for t in stop]]
    if len(stop) > _MAX_STOP_SEQS:
        raise ValueError(f"too many stop sequences ({len(stop)} > {_MAX_STOP_SEQS})")
    out = []
    for seq in stop:
        if isinstance(seq, (int, bool, str)):
            raise ValueError("stop must be [ids...] or [[ids...], ...]")
        try:
            seq = [int(t) for t in seq]
        except (TypeError, ValueError):
            raise ValueError("stop must be [ids...] or [[ids...], ...]")
        if not seq:
            raise ValueError("empty stop sequence")
        if len(seq) > _MAX_STOP_LEN:
            raise ValueError(f"stop sequence too long ({len(seq)} > {_MAX_STOP_LEN} tokens)")
        out.append(seq)
    return out


def request_from_json(payload, tokenizer=None, *, default_max_new: int = 128,
                      default_top_p: float = 0.95, default_seed: int = 0) -> Request:
    """A Request from one user JSON object (the fields and defaults of
    ``ergm_tpu``'s serve mode and HTTP front end). Temperature 0 is greedy."""
    if "prompt" in payload:
        ids = [int(t) for t in payload["prompt"]]
    elif "text" in payload:
        if tokenizer is None:
            raise ValueError("text requests need a tokenizer (--tokenizer_dir)")
        ids = tokenizer.encode(payload["text"])
    else:
        raise ValueError("request needs 'prompt' or 'text'")
    caps = payload.get("caption_ids")
    if caps is None and payload.get("caption"):
        if tokenizer is None:
            raise ValueError("'caption' text needs a tokenizer; pass 'caption_ids' otherwise")
        caps = tokenizer.encode(payload["caption"])
    sid = payload.get("session_id")
    pool = payload.get("pool")
    if pool is not None and pool not in ("short", "long"):
        raise ValueError("pool must be 'short' or 'long'")
    temp = float(payload.get("temperature", 1.0))
    if temp < 0.0:
        raise ValueError("temperature must be >= 0")
    return Request(
        stop=_norm_stop(payload.get("stop")), logprobs=bool(payload.get("logprobs", False)),
        prompt_ids=ids, caption_ids=caps,
        max_new_tokens=int(payload.get("max_new_tokens", default_max_new)),
        greedy=bool(payload.get("greedy", False)) or temp == 0.0,
        temperature=temp if temp > 0.0 else 1.0,
        top_p=float(payload.get("top_p", default_top_p)),
        seed=int(payload.get("seed", default_seed)),
        session_id=str(sid) if sid is not None else None, pool=pool)


@dataclass
class Result:
    request_id: int
    tokens: List[int]            # continuation only (eos included if emitted)
    emotion_logits: np.ndarray   # [num_emotions] from the prompt's last token
    steps_waited: int            # server steps between submit and admission
    latency_s: float = 0.0       # submit -> finish wall clock
    logprobs: Optional[List[float]] = None  # parallel to tokens (Request.logprobs)


@dataclass
class _Slot:
    request_id: int = -1
    req: Optional[Request] = None
    generated: List[int] = field(default_factory=list)
    lps: List[float] = field(default_factory=list)
    has_first: bool = False      # the prefill's token was harvested
    submitted_step: int = 0
    submitted_wall: float = 0.0
    admitted_step: int = 0
    active: bool = False
    phys_len: int = 0            # host mirror of the device cursor
    admitted_block: int = 0      # first decode block the row rides in


def _bucket(n: int, multiple: int) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


class ContinuousServer:
    """Static-slot continuous batching.

    Usage::

        srv = ContinuousServer(params, cfg, slots=8, eos_id=..., sp2_id=...)
        rid = srv.submit(Request(prompt_ids=[...], max_new_tokens=32))
        results = srv.run_until_drained()   # or step() incrementally

    The server runs on the device of ``params``."""

    # every admission prefill has GROUP_CAP rows (pad rows cost one wasted
    # prefill row each), so K1's B >= 64 gate holds
    GROUP_CAP = 64

    def __init__(self, params: gpt2.GPT2, config: ModelConfig, *, slots: int,
                 eos_id: int, sp2_id: int, max_prompt: int = 256,
                 cache_len: Optional[int] = None, caption_len: int = 32,
                 prompt_bucket: int = 64, sync_every: int = 8,
                 mesh=None, cache_grow_step: int = 32,
                 pipeline: bool = False, spec_gamma: int = 0,
                 prefill_chunk: int = 0, long_slots: int = 0,
                 long_threshold: Optional[int] = None, adaptive_block: bool = True,
                 admit_policy: str = "fifo"):
        c = config
        if mesh is not None:
            raise NotImplementedError(f"the slot-axis mesh {_NOT_PORTED}")
        if spec_gamma:
            raise NotImplementedError(f"speculative serving (spec_gamma > 0) {_NOT_PORTED}")
        if prefill_chunk:
            raise NotImplementedError(f"chunked prefill (prefill_chunk > 0) {_NOT_PORTED}")
        self.params = params
        self.device = next(params.parameters()).device
        self.cfg = c
        self.S = slots
        self.eos_id = eos_id
        self.sp2_id = sp2_id
        self.prompt_bucket = prompt_bucket
        self.max_prompt = _bucket(max_prompt, prompt_bucket)
        self.T = min(cache_len or c.n_positions, c.n_positions)
        if self.max_prompt >= self.T:
            raise ValueError(f"max_prompt {self.max_prompt} must be < cache length {self.T}")
        self.caption_len = caption_len if c.use_cross_attention else 0
        self.sync_every = sync_every
        # drain-aware block length (_pick_block_len); synchronous mode only
        self.adaptive_block = adaptive_block and not pipeline
        if admit_policy not in ("fifo", "sorted"):
            raise ValueError(f"unknown admit_policy {admit_policy!r}")
        # "fifo" admits in arrival order; "sorted" admits length-sorted
        # cohorts (largest budget first) that finish together
        self.admit_policy = admit_policy
        ladder = sorted({sync_every, max(sync_every // 2, 1), max(sync_every // 4, 1)},
                        reverse=True)
        self._block_ladder = [n for n in ladder if n >= 1]
        if c.cross_kv_dtype == "int8":
            raise ValueError("cross_kv_dtype='int8' is a generate-path option; the server "
                             "serves the caption cache in the compute dtype (use 'auto' here)")
        self.grow_step = cache_grow_step
        self.pipeline = pipeline
        self.long_slots = int(long_slots)
        if self.long_slots:
            if not 0 < self.long_slots < slots:
                raise ValueError(f"long_slots {long_slots} must be in (0, slots)")
            self.long_threshold = int(long_threshold if long_threshold is not None
                                      else self.max_prompt)
            self.groups = ((0, slots - self.long_slots), (slots - self.long_slots,
                                                          self.long_slots))
        else:
            self.long_threshold = None
            self.groups = ((0, slots),)
        # kv_cache_dtype="auto" with tiers: the short pool in the compute
        # dtype, the long pool int8 staged; an explicit dtype holds for all
        if c.kv_cache_dtype == "auto" and len(self.groups) > 1:
            self.gcfgs = (c,) + (c.replace(kv_cache_dtype="int8"),) * (len(self.groups) - 1)
        else:
            self.gcfgs = tuple(c for _ in self.groups)
        # two pinned buffers for the per-block device-to-host copy, so a
        # pipelined block cannot overwrite the one still being harvested
        n = 2 * sync_every * slots + 2 * slots + slots * c.num_emotions
        pin = self.device.type == "cuda"
        self._host = [torch.empty(n, dtype=torch.float32, pin_memory=pin) for _ in range(2)]
        self._init_state(0)

    @property
    def phase_seconds(self) -> Dict[str, float]:
        """Host wall time per server phase since the last reset
        (``block_wait`` is the wait for a block's results; the rest are
        host work and enqueueing)."""
        return dict(self._phase)

    # -- physical cache capacity -------------------------------------------

    def _phys_for(self, need: int) -> int:
        """Smallest capacity rung >= ``need``: a multiple of ``grow_step``,
        capped at the logical cache length ``T``."""
        if not self.grow_step or self.grow_step >= self.T:
            return self.T
        return min(_bucket(need, self.grow_step), self.T)

    def _grow_cache(self, g: int, new_phys: int) -> None:
        """Pad-copy pool ``g``'s KV cache up to ``new_phys`` slots."""
        delta = new_phys - self.Tphys[g]
        if delta <= 0:
            return
        self.grows += 1
        t0 = time.time()
        self._resize(g, lambda a: F.pad(a, (0, 0, 0, delta)), new_phys)
        self._tick("grow", t0)

    def _shrink_cache(self, g: int, new_phys: int) -> None:
        """Slice-copy pool ``g``'s KV cache down to ``new_phys`` slots. Every
        active row's content lies in [0, its length); idle rows' stale
        cursors past the new capacity write nowhere until their next join."""
        if new_phys >= self.Tphys[g]:
            return
        self.shrinks += 1
        t0 = time.time()
        self._resize(g, lambda a: a[:, :, :, :new_phys].contiguous(), new_phys)
        self._tick("shrink", t0)

    def _resize(self, g: int, fn, new_phys: int) -> None:
        c = self.caches[g]
        repl = {f: fn(getattr(c, f)) for f in ("k", "v", "k_scale", "v_scale")
                if getattr(c, f) is not None}
        self.caches[g] = dataclasses.replace(c, **repl)
        self.Tphys[g] = new_phys

    def _slot_group(self, i: int) -> int:
        """Pool index of slot ``i`` (pools are contiguous ranges)."""
        return 1 if self.long_slots and i >= self.groups[1][0] else 0

    def _group_slots(self, g: int):
        off, size = self.groups[g]
        return range(off, off + size)

    def _capacity_need(self, g: int) -> int:
        """Capacity pool ``g`` needs this block: its longest active row's
        cursor (host mirror) plus one block of writes."""
        lens = [self.slots[i].phys_len for i in self._group_slots(g) if self.slots[i].active]
        return (max(lens) if lens else 0) + self.sync_every + 1

    # -- state ---------------------------------------------------------------

    @torch.inference_mode()
    def _init_state(self, seed: int) -> None:
        """(Re)initialize the queue, the results and all device state."""
        c, dev = self.cfg, self.device
        self.queue: List[tuple] = []
        self.results: Dict[int, Result] = {}
        self._phase: Dict[str, float] = {}
        self.slots = [_Slot() for _ in range(self.S)]
        self._next_id = 0
        self._admit_ctr = 0
        self.server_step = 0
        self.block_len_hist: Dict[int, int] = {}
        self.grows = 0
        self.shrinks = 0
        self._inflight = None
        self._block_ctr = 0
        t0 = self._phys_for(self.prompt_bucket + self.sync_every + 1)
        self.Tphys = [t0 for _ in self.groups]
        self.caches = [gpt2.init_kv_cache(self.gcfgs[g], size, t0, caption_len=self.caption_len,
                                          device=dev, per_row_index=True)
                       for g, (_off, size) in enumerate(self.groups)]
        S = self.S
        self.last = torch.full((S, 1), self.eos_id, dtype=torch.long, device=dev)
        self.cap_mask = torch.zeros((S, max(self.caption_len, 1)), device=dev)
        # the decode chain's sampler stream
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.greedy_row = torch.zeros((S,), dtype=torch.bool, device=dev)
        self.top_p_row = torch.full((S,), 0.95, device=dev)
        self.temp_row = torch.ones((S,), device=dev)
        self.first_tok = torch.full((S,), self.eos_id, dtype=torch.long, device=dev)
        self.first_lp = torch.zeros((S,), device=dev)
        self.emo_slot = torch.zeros((S, c.num_emotions), device=dev)
        self._sp2 = torch.full((S, 1), self.sp2_id, dtype=torch.long, device=dev)

    def _tick(self, name: str, t0: float) -> float:
        now = time.time()
        self._phase[name] = self._phase.get(name, 0.0) + (now - t0)
        return now

    def reset(self, seed: int = 0) -> None:
        """Drop all state (queue, results, slots, device buffers): a warm
        restart, keeping the built kernels."""
        self._init_state(seed)

    # -- public API ------------------------------------------------------------

    def submit(self, req: Request) -> int:
        """Queue a request; returns its id. The caller's Request is not
        changed (a normalized copy is queued)."""
        if req.session_id is not None:
            raise NotImplementedError(f"session continuation (Request.session_id) {_NOT_PORTED}")
        changes: dict = {"stop": _norm_stop(req.stop)}
        if req.temperature <= 0.0:  # temperature 0 is greedy
            if req.temperature < 0.0:
                raise ValueError("temperature must be >= 0")
            changes["greedy"] = True
            changes["temperature"] = 1.0
        req = dataclasses.replace(req, **changes)
        if len(req.prompt_ids) > self.max_prompt:
            raise ValueError(f"prompt length {len(req.prompt_ids)} exceeds max_prompt "
                             f"{self.max_prompt}")
        # the row occupies [0, prompt + max_new - 1) of its slot
        if len(req.prompt_ids) + req.max_new_tokens - 1 > self.T:
            raise ValueError(f"prompt ({len(req.prompt_ids)}) + max_new_tokens "
                             f"({req.max_new_tokens}) cannot fit the serving cache (cache_len "
                             f"{self.T}); raise cache_len or lower max_new_tokens")
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, req, self.server_step, time.time()))
        return rid

    def _fit_capacity(self) -> None:
        for g in range(len(self.groups)):
            need = self._phys_for(self._capacity_need(g))
            if need > self.Tphys[g]:
                self._grow_cache(g, need)
            elif need * 2 <= self.Tphys[g]:
                # hysteresis: shrink only once the need halves
                self._shrink_cache(g, need)

    @torch.inference_mode()
    def step(self) -> List[Result]:
        """One server iteration: admit into free slots, fit the capacity
        rung, run a decode block, harvest completions. Returns the results
        finished this call.

        With ``pipeline=True`` the block is dispatched FIRST, and the host
        harvests the previous block and stages admissions while it runs;
        a finished row then decodes one extra block before its slot frees."""
        if not self.pipeline:
            self._admit()
            if not any(s.active for s in self.slots):
                return []
            self._fit_capacity()
            return self._harvest(self._dispatch_block())
        nxt = self._dispatch_block() if any(s.active for s in self.slots) else None
        finished = self._harvest(self._inflight) if self._inflight is not None else []
        self._inflight = nxt
        # admissions enqueue after the in-flight block: they join the next one
        self._admit()
        if any(s.active for s in self.slots):
            self._fit_capacity()
        return finished

    def cancel(self, request_id: int) -> bool:
        """Abandon a request that is queued, decoding, or finished with an
        unread result. A dispatched block keeps stepping the row, whose
        tokens are skipped at harvest. False when the id is unknown."""
        for i, (rid, _req, _sub, _wall) in enumerate(self.queue):
            if rid == request_id:
                del self.queue[i]
                return True
        for s in self.slots:
            if s.active and s.request_id == request_id:
                s.active = False
                s.req = None
                s.request_id = -1
                s.generated = []
                s.lps = []
                return True
        return self.results.pop(request_id, None) is not None

    def busy(self) -> bool:
        """Queued requests or active rows (a pipelined in-flight block is
        harvested by ``flush``)."""
        return bool(self.queue or any(s.active for s in self.slots))

    @torch.inference_mode()
    def flush(self) -> List[Result]:
        """Harvest a still-in-flight pipelined block (no-op otherwise)."""
        if self._inflight is None:
            return []
        finished = self._harvest(self._inflight)
        self._inflight = None
        return finished

    def run_until_drained(self, max_iters: int = 10_000) -> Dict[int, Result]:
        for _ in range(max_iters):
            if not self.busy() and self._inflight is None:
                break
            self.step()
        self.flush()
        return self.results

    # -- admission -------------------------------------------------------------

    def _put(self, x: np.ndarray, dtype=None) -> torch.Tensor:
        """A host array on the device, copied without waiting for the
        device (pinned staging on the card)."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    @staticmethod
    def _pmask_from_len(length: torch.Tensor, pb: int) -> torch.Tensor:
        """[G] lengths -> [G, pb] left-pad masks."""
        j = torch.arange(pb, device=length.device)[None, :]
        return (j >= (pb - length)[:, None]).float()

    def _admit_group(self, entries: List[tuple], pb: int, g: int = 0) -> None:
        """entries: (slot_idx, rid, req, submit_step, submit_wall), all in
        pool ``g``. One 64-row prefill, then the join of its real rows."""
        t0 = time.time()
        c, cl = self.gcfgs[g], self.caption_len
        G = len(entries)
        gb = self.GROUP_CAP
        reqs = [e[2] for e in entries]
        ids = np.full((gb, pb), self.eos_id, np.int64)
        meta = np.zeros((3, G), np.int64)  # pool-local slot, global slot, length
        topp = np.full((gb,), 0.95, np.float32)
        temps = np.ones((gb,), np.float32)
        greedy = np.zeros((gb,), bool)
        any_tts = any(r.token_type_ids is not None for r in reqs)
        any_mod = any(r.img is not None or r.aud is not None for r in reqs)
        any_cap = bool(cl) and any(r.caption_ids for r in reqs)
        tts = np.full((gb, pb), self.sp2_id, np.int64) if any_tts else None
        img = np.zeros((gb, c.modality_dim), np.float32) if any_mod else None
        aud = np.zeros((gb, c.modality_dim), np.float32) if any_mod else None
        cap_ids = np.full((gb, cl), self.eos_id, np.int64) if any_cap else None
        cap_mask = np.zeros((gb, max(cl, 1)), np.float32)
        lengths = np.zeros((gb,), np.int64)  # pad rows: length 0
        off = self.groups[g][0]
        for r, (slot_idx, _rid, req, _sub, _wall) in enumerate(entries):
            Lp = len(req.prompt_ids)
            ids[r, pb - Lp:] = req.prompt_ids
            if req.token_type_ids is not None:
                tt = (list(req.token_type_ids) + [self.sp2_id] * Lp)[:Lp]
                tts[r, pb - Lp:] = tt
            if req.img is not None:
                img[r] = req.img
            if req.aud is not None:
                aud[r] = req.aud
            if cl and req.caption_ids:
                n = min(len(req.caption_ids), cl)
                cap_ids[r, :n] = req.caption_ids[:n]
                cap_mask[r, :n] = 1.0
            lengths[r] = Lp
            meta[:, r] = (slot_idx - off, slot_idx, Lp)
            topp[r], temps[r], greedy[r] = req.top_p, req.temperature, bool(req.greedy)
        self._admit_ctr += 1

        put = self._put
        length = put(lengths)
        pmask = self._pmask_from_len(length, pb)
        pos = torch.clamp_min(torch.cumsum(pmask, dim=-1) - 1, 0).long()
        cap_mask_d = put(cap_mask)
        out = gpt2.forward(
            self.params, c, put(ids),
            token_type_ids=put(tts) if tts is not None else torch.full(
                (gb, pb), self.sp2_id, dtype=torch.long, device=self.device),
            position_ids=pos, attention_mask=pmask,
            cache=gpt2.init_kv_cache(c, gb, pb, caption_len=cl, device=self.device),
            imgs=put(img) if img is not None else None,
            auds=put(aud) if aud is not None else None,
            caption_ids=put(cap_ids) if cap_ids is not None else None,
            encoder_attention_mask=cap_mask_d if any_cap else None,
            prefix_prefill=True, compute_logits="last")
        logits = out.logits[:, -1, :]
        first = torch.argmax(logits, dim=-1)
        topp_d, temps_d, greedy_d = put(topp), put(temps), put(greedy)
        if not greedy[:G].all():
            gen = torch.Generator(device=self.device).manual_seed(
                fold_seed(reqs[0].seed, self._admit_ctr))
            sampled = sample_top_p(logits / temps_d.clamp_min(1e-6)[:, None], gen,
                                   topp_d[:, None])
            first = torch.where(greedy_d, first, sampled)
        self._join(g, out, first, put(meta), pb, G, topp_d[:G], temps_d[:G], greedy_d[:G],
                   cap_mask_d[:G], logits[:G] if any(r.logprobs for r in reqs) else None)
        for slot_idx, rid, req, sub, wall in entries:
            s = self.slots[slot_idx]
            s.request_id, s.req = rid, req
            s.submitted_step, s.submitted_wall = sub, wall
            s.active = True
            s.admitted_step = self.server_step
            s.admitted_block = self._block_ctr
            s.generated, s.lps, s.has_first = [], [], False
            s.phys_len = len(req.prompt_ids)
        self._tick("admit", t0)

    def _join(self, g: int, out, first, meta, pb: int, G: int, topp, temps, greedy,
              cap_mask, logits) -> None:
        """Scatter the group's first ``G`` prefilled rows into their slots:
        each row's prompt, right-aligned at [pb - len, pb) of the prefill
        cache, is gathered to [0, len) of its slot; the slot's cursor and
        per-row state are set. ``logits`` (given when a row asks for
        logprobs) give the first tokens' logprobs."""
        temp, cache = out.cache, self.caches[g]
        local, glob, length = meta[0], meta[1], meta[2]
        src = torch.clamp(pb - length[:, None] + torch.arange(pb, device=self.device)[None, :],
                          0, pb - 1)
        for f in ("k", "v", "k_scale", "v_scale"):
            small = getattr(temp, f)
            if small is None:
                continue
            L, _, H, _, Dm = small.shape
            idx = src[None, :, None, :, None].expand(L, G, H, pb, Dm)
            getattr(cache, f)[:, local, :, :pb] = small[:, :G].gather(3, idx)
        cache.index[local] = length.to(cache.index.dtype)
        if self.caption_len and temp.ck is not None:
            cache.ck[:, local] = temp.ck[:, :G]
            cache.cv[:, local] = temp.cv[:, :G]
        first = first[:G]
        self.last[glob, 0] = first
        self.greedy_row[glob] = greedy
        self.top_p_row[glob] = topp
        self.temp_row[glob] = temps
        self.first_tok[glob] = first
        if logits is not None:
            lsm = torch.log_softmax(logits.float(), dim=-1)
            self.first_lp[glob] = lsm.gather(-1, first[:, None])[:, 0]
        # emotion logits are read at the prompt's last token
        self.emo_slot[glob] = out.emotion_logits[:G].float()
        if self.caption_len:
            self.cap_mask[glob] = cap_mask

    def _route(self, req: Request) -> int:
        """The pool a fresh admission prefers: the long pool iff the row's
        expected final length (prompt + max_new - 1) exceeds
        long_threshold, or the request pins a pool."""
        if not self.long_slots:
            return 0
        if req.pool == "long":
            return 1
        if req.pool == "short":
            return 0
        return 1 if len(req.prompt_ids) + req.max_new_tokens - 1 > self.long_threshold else 0

    def _take_free_slot(self, taken: set, g: int = 0) -> Optional[int]:
        """A free slot, preferring pool ``g``. Short requests overflow into
        idle long slots; long requests never take short slots (one long
        row would widen the rung every short slot reads). ``taken`` holds
        the slots already assigned in this admission pass."""
        pools = [g] + ([1] if self.long_slots and g == 0 else [])
        for p in pools:
            for i in self._group_slots(p):
                if not self.slots[i].active and i not in taken:
                    taken.add(i)
                    return i
        return None

    def _admit(self) -> None:
        if not self.queue:
            return
        if self.admit_policy == "sorted" and len(self.queue) > 1:
            self.queue.sort(key=lambda q: -q[1].max_new_tokens)  # stable
        by_pb: Dict[tuple, List[tuple]] = {}   # (prompt bucket, pool) -> entries
        deferred: List[tuple] = []
        taken: set = set()
        for rid, req, sub, wall in self.queue:
            slot_idx = self._take_free_slot(taken, self._route(req))
            if slot_idx is None:
                deferred.append((rid, req, sub, wall))
                continue
            pb = _bucket(len(req.prompt_ids), self.prompt_bucket)
            by_pb.setdefault((pb, self._slot_group(slot_idx)), []).append(
                (slot_idx, rid, req, sub, wall))
        self.queue = deferred
        if not by_pb:
            return
        # joins write the [0, pb) window: capacity must cover it first
        for g in range(len(self.groups)):
            need = self._capacity_need(g)
            pbs = [pb for (pb, pg) in by_pb if pg == g]
            if pbs:
                need = max(need, max(pbs) + self.sync_every + 1)
            need = self._phys_for(need)
            if need > self.Tphys[g]:
                self._grow_cache(g, need)
        for (pb, g), entries in by_pb.items():
            for i in range(0, len(entries), self.GROUP_CAP):
                self._admit_group(entries[i:i + self.GROUP_CAP], pb, g)

    # -- decode ----------------------------------------------------------------

    def _pick_block_len(self) -> int:
        """``sync_every``, except while draining (no queue): the smallest
        ladder length covering the longest remaining budget (stop
        sequences only end rows earlier)."""
        if not self.adaptive_block or self.queue:
            return self.sync_every
        max_rem = 0
        for s in self.slots:
            if s.active:
                r = s.req.max_new_tokens - len(s.generated)
                if not s.has_first:
                    r -= 1  # the prefill token arrives at this harvest
                max_rem = max(max_rem, r)
        if max_rem <= 0:
            # every active row only awaits its prefill token
            return self._block_ladder[-1]
        for n in reversed(self._block_ladder):  # smallest first
            if n >= max_rem:
                return n
        return self.sync_every

    def _rows(self, x: torch.Tensor, inc: List[int]) -> torch.Tensor:
        """The rows of the pools ``inc`` of a per-slot tensor."""
        if len(inc) == len(self.groups):
            return x
        return torch.cat([x[self.groups[g][0]:sum(self.groups[g])] for g in inc])

    def _decode(self, all_greedy: bool, actives: tuple, want_lp: bool, K: int):
        """Enqueue K decode steps over the pools with an active row (the
        others pass through untouched). Returns the [K, S] tokens and,
        with ``want_lp``, their [K, S] logprobs; no host read."""
        c, cl = self.cfg, self.caption_len
        inc = [g for g in range(len(self.groups)) if actives[g]]
        staged = [g for g in inc if self.gcfgs[g].kv_cache_dtype in ("int8", "int4")]
        caches = list(self.caches)
        for g in staged:
            shape = (c.n_layer, self.groups[g][1], c.n_head, K, c.head_dim)
            caches[g] = dataclasses.replace(
                caches[g], sk=torch.zeros(shape, dtype=c.compute_dtype, device=self.device),
                sv=torch.zeros(shape, dtype=c.compute_dtype, device=self.device))
        if not all_greedy:
            topp, temp = self._rows(self.top_p_row, inc), self._rows(self.temp_row, inc)
            greedy = self._rows(self.greedy_row, inc)
        toks = torch.empty((K, self.S), dtype=torch.long, device=self.device)
        lps = torch.zeros((K, self.S), device=self.device) if want_lp else None
        last = self.last
        for i in range(K):
            parts = []
            for g in inc:
                off, Sg = self.groups[g]
                pos = torch.clamp_max(caches[g].index, c.n_positions - 1).long()[:, None]
                out = gpt2.forward(
                    self.params, self.gcfgs[g], last[off:off + Sg],
                    token_type_ids=self._sp2[off:off + Sg], position_ids=pos, cache=caches[g],
                    stage_index=i if g in staged else None,
                    encoder_attention_mask=self.cap_mask[off:off + Sg] if cl else None)
                parts.append(out.logits[:, -1, :])
                caches[g] = out.cache
            logits = parts[0] if len(parts) == 1 else torch.cat(parts)
            nxt = torch.argmax(logits, dim=-1)
            if not all_greedy:
                sampled = sample_top_p(logits / temp.clamp_min(1e-6)[:, None], self.gen,
                                       topp[:, None])
                nxt = torch.where(greedy, nxt, sampled)
            if want_lp:
                lp = torch.log_softmax(logits.float(), dim=-1).gather(-1, nxt[:, None])[:, 0]
            if len(inc) == len(self.groups):
                full = nxt
                if want_lp:
                    lps[i] = lp
            else:  # excluded pools keep their pending token
                full, row0 = last[:, 0].clone(), 0
                for g in inc:
                    off, Sg = self.groups[g]
                    full[off:off + Sg] = nxt[row0:row0 + Sg]
                    if want_lp:
                        lps[i, off:off + Sg] = lp[row0:row0 + Sg]
                    row0 += Sg
            toks[i] = full
            last = full[:, None]
        for g in staged:
            caches[g] = gpt2.flush_staging(caches[g], K, self.gcfgs[g])
        self.caches, self.last = caches, last
        return toks, lps

    def _dispatch_block(self):
        """Enqueue one decode block and its one device-to-host copy;
        returns the in-flight handle. The cursor mirrors advance here (the
        device cursors move whether or not the host has harvested)."""
        all_greedy = all(s.req.greedy for s in self.slots if s.active)
        want_lp = any(s.active and s.req.logprobs for s in self.slots)
        actives = tuple(any(self.slots[i].active for i in self._group_slots(g))
                        for g in range(len(self.groups)))
        t0 = time.time()
        n = self._pick_block_len()
        toks, lps = self._decode(all_greedy, actives, want_lp, n)
        parts = [toks.flatten().float(), self.first_tok.float(), self.emo_slot.flatten()]
        if want_lp:
            parts += [lps.flatten(), self.first_lp]
        packed = torch.cat(parts)
        event = None
        if self.device.type == "cuda":
            host = self._host[self._block_ctr % 2][:packed.numel()]
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = packed
        self.block_len_hist[n] = self.block_len_hist.get(n, 0) + 1
        self._tick("block_dispatch", t0)
        block_id = self._block_ctr
        self._block_ctr += 1
        self.server_step += 1
        for s in self.slots:
            if s.active:
                s.phys_len += n
        return block_id, n, want_lp, host, event

    def _harvest(self, inflight) -> List[Result]:
        """Wait for one block's copy (its one host round trip) and do the
        token bookkeeping. Rows admitted after the block was dispatched
        (pipelined mode) are skipped: their tokens start in the next one."""
        block_id, n, want_lp, host, event = inflight
        t0 = time.time()
        if event is not None:
            event.synchronize()
        arr = host.numpy()
        S, E = self.S, self.cfg.num_emotions
        toks_h = arr[:n * S].reshape(n, S).astype(np.int64)
        first_h = arr[n * S:n * S + S].astype(np.int64)
        emo_h = arr[n * S + S:n * S + S + S * E].reshape(S, E).copy()
        lps_h = flp_h = None
        if want_lp:
            o = n * S + S + S * E
            lps_h = arr[o:o + n * S].reshape(n, S).copy()
            flp_h = arr[o + n * S:o + n * S + S].copy()
        t0 = self._tick("block_wait", t0)
        finished = []
        for i, s in enumerate(self.slots):
            if not s.active or s.admitted_block > block_id:
                continue
            n_before = len(s.generated)
            track_lp = s.req.logprobs and lps_h is not None
            if not s.has_first:
                s.generated = [int(first_h[i])]
                s.lps = [float(flp_h[i])] if track_lp else []
                s.has_first = True
            for k in range(n):
                if self._done(s):
                    break
                s.generated.append(int(toks_h[k, i]))
                if track_lp:
                    s.lps.append(float(lps_h[k, i]))
            done = self._done(s)
            if s.req.stream_cb is not None:
                new = s.generated[n_before:]
                if new or done:
                    s.req.stream_cb(s.request_id, new, done)
            if done:
                finished.append(self._finish(i, emo_h[i]))
        self._tick("harvest", t0)
        return finished

    def _done(self, s: _Slot) -> bool:
        if not s.generated:
            return False
        if (s.generated[-1] == self.eos_id or len(s.generated) >= s.req.max_new_tokens
                or len(s.req.prompt_ids) + len(s.generated) >= self.cfg.n_positions):
            return True
        if s.req.stop:
            g = s.generated
            for seq in s.req.stop:
                if len(g) >= len(seq) and g[-len(seq):] == seq:
                    return True
        return False

    def _finish(self, slot_idx: int, emotion: np.ndarray) -> Result:
        s = self.slots[slot_idx]
        res = Result(request_id=s.request_id, tokens=list(s.generated), emotion_logits=emotion,
                     steps_waited=s.admitted_step - s.submitted_step,
                     latency_s=time.time() - s.submitted_wall,
                     logprobs=list(s.lps[:len(s.generated)]) if s.req.logprobs else None)
        self.results[s.request_id] = res
        s.active = False
        s.req = None
        s.generated, s.lps, s.has_first = [], [], False
        return res
