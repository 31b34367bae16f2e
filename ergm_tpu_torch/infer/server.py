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
- **The extension program** (``_admit_ext_group``): ONE multi-token
  forward over a pool's rows, ``EXT_BUCKET``-quantized wide, against the
  live cache, each extending row's delta attending to its retained
  history under per-row cursors (query j sees kpos <= start + j). It
  serves **sessions** (a finished request with a ``session_id`` parks
  its slot with its K/V; the next turn, whose prompt extends the parked
  history, prefills only the delta; parked slots are evicted LRU) and
  **chunked prefill** (``prefill_chunk``: chunk 1 of a long prompt rides
  the normal admission group, the rest one chunk a server step).
- **Speculative serving** (``spec_gamma``): each macro step of a block
  drafts gamma tokens a slot by prompt lookup over a device token buffer
  [S, T], verifies them in one forward of gamma + 1 positions, and
  moves each cursor back to its accepted prefix: 1..gamma+1 tokens of
  the exact greedy stream a macro step. Blocks with a sampled or
  logprob row run the plain decode block.

Greedy output through the server is byte-identical to ``generate``.
Sampling shares ``generate``'s nucleus sampler: one device generator
drives the decode steps (seeded by ``reset``), and each admission group
draws its first tokens from ``fold_seed(lead request's seed, admission
counter)`` (an extension from the sum of its rows' seeds); sampled
streams depend on the schedule.

**The slot axis over a mesh** (``mesh=``, JAX's ``_state_shardings``):
one process drives one device, every rank holds ``slots / dp`` of every
per-slot device tensor (each pool's contiguous share of its slots: the
caches, with this model rank's heads under a model axis, the cursors,
``last``, ``cap_mask``, the per-row sampling state, the first tokens and
logprobs, the emotion rows and the token buffer), and the host schedule
runs in lockstep: only rank 0 takes ``submit``/``cancel``/``reset`` from
outside, and at the top of each ``step``/``flush`` it broadcasts them
with the action; every rank then runs the same deterministic scheduler
over the whole slot table (no decision reads the wall clock), prefills
only the admission rows whose slots it owns, and all-gathers each
block's per-slot results over the data axis before its harvest, so
every rank's bookkeeping stays identical. The other ranks follow with
``run_until_drained`` (until rank 0's ends) or ``follow`` (until
``stop_followers``). Sampled rows draw the noise of one process's rows.
"""

from __future__ import annotations

import dataclasses
import numbers
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.mesh import DATA_AXIS
from ergm_tpu_torch.core.rng import fold_seed
from ergm_tpu_torch.infer.generate import _gumbel, sample_top_p
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.parallel.collectives import HEARTBEAT_S, all_gather_rows

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
    # multi-turn continuation: a finished request parks its slot's K/V
    # under this id, and a later request with the same id whose prompt
    # extends the parked history (prompt + reply) prefills only the delta
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
    # a finished slot whose request carried a session_id keeps its K/V
    # for the session's next turn instead of freeing
    parked: bool = False
    session: Optional[str] = None
    token_log: List[int] = field(default_factory=list)  # consumed + emitted
    last_use: int = 0            # block counter, for LRU eviction
    # chunked prefill in progress: [0, phys_len) holds a partial prompt;
    # the slot is neither free nor decoding
    prefilling: bool = False


def _bucket(n: int, multiple: int) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


class ContinuousServer:
    """Static-slot continuous batching.

    Usage::

        srv = ContinuousServer(params, cfg, slots=8, eos_id=..., sp2_id=...)
        rid = srv.submit(Request(prompt_ids=[...], max_new_tokens=32))
        results = srv.run_until_drained()   # or step() incrementally

    The server runs on the device of ``params``; ``mesh``: over a mesh,
    ``params`` this rank's shard (see the module docstring)."""

    # every admission prefill has GROUP_CAP rows (pad rows cost one wasted
    # prefill row each), so K1's B >= 64 gate holds
    GROUP_CAP = 64
    # the width quantum of an extension forward (session deltas, chunks)
    EXT_BUCKET = 16

    def __init__(self, params: gpt2.GPT2, config: ModelConfig, *, slots: int,
                 eos_id: int, sp2_id: int, max_prompt: int = 256,
                 cache_len: Optional[int] = None, caption_len: int = 32,
                 prompt_bucket: int = 64, sync_every: int = 8,
                 mesh=None, cache_grow_step: int = 32,
                 pipeline: bool = False, spec_gamma: int = 0, spec_ngram: int = 3,
                 prefill_chunk: int = 0, long_slots: int = 0,
                 long_threshold: Optional[int] = None, adaptive_block: bool = True,
                 admit_policy: str = "fifo"):
        c = config
        self.mesh = mesh
        self.dp = 1 if mesh is None else mesh.axis_size(DATA_AXIS)
        self.dr = 0 if mesh is None else mesh.index(DATA_AXIS)
        self._data_group = None if mesh is None else mesh.group(DATA_AXIS)
        # lockstep over a world: rank 0's submissions, cancellations and
        # resets since the last broadcast, in order
        self._shared = mesh is not None and dist.is_available() and dist.is_initialized()
        self.primary = not self._shared or dist.get_rank() == 0
        self._outbox: List[tuple] = []
        self._synced_at = time.monotonic()
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
        # chunked prefill: a prompt longer than prefill_chunk admits in
        # chunks, one a server step, so concurrent streams wait for at most
        # one chunk-wide forward between blocks; prompts and session
        # deltas may then exceed max_prompt
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk:
            if self.prefill_chunk < self.EXT_BUCKET:
                raise ValueError(f"prefill_chunk must be >= {self.EXT_BUCKET}")
            if self.prefill_chunk > self.max_prompt:
                raise ValueError(f"prefill_chunk {self.prefill_chunk} must be <= max_prompt "
                                 f"{self.max_prompt} (the first chunk rides the prefill path)")
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
        dp = self.dp
        if dp > 1:  # JAX's rules (ergm_tpu/infer/server.py:597-627)
            if slots % dp:
                raise ValueError(f"slots={slots} must be divisible by the mesh data axis ({dp}) "
                                 f"to shard the serving batch over it; pick divisible slots or "
                                 f"a smaller data axis")
            if any(size % dp for _off, size in self.groups):
                raise ValueError(f"each slot pool must be divisible by the mesh data axis ({dp}); "
                                 f"got pool sizes {[size for _o, size in self.groups]}")
        # this rank's share of each pool, [off / dp, (off + size) / dp) of its
        # per-slot tensors, and the global slot of each of every rank's rows
        self.lgroups = tuple((off // dp, size // dp) for off, size in self.groups)
        self.S_local = slots // dp
        self._glob = np.zeros((dp, self.S_local), np.int64)
        for (off, size), (loff, lsize) in zip(self.groups, self.lgroups):
            for r in range(dp):
                self._glob[r, loff:loff + lsize] = off + r * lsize + np.arange(lsize)
        # kv_cache_dtype="auto" with tiers: the short pool in the compute
        # dtype, the long pool int8 staged; an explicit dtype holds for all.
        # Under spec_gamma "auto" is the compute dtype on every pool.
        if c.kv_cache_dtype == "auto" and len(self.groups) > 1 and not spec_gamma:
            self.gcfgs = (c,) + (c.replace(kv_cache_dtype="int8"),) * (len(self.groups) - 1)
        else:
            self.gcfgs = tuple(c for _ in self.groups)
        self.spec_gamma = int(spec_gamma)
        self.spec_ngram = int(spec_ngram)
        if self.spec_gamma:
            if pipeline:
                raise ValueError("spec_gamma with pipeline=True is unsupported: the host cursor "
                                 "mirror is exact only after a harvest, which pipelining defers "
                                 "past the next dispatch")
            if self.spec_ngram < 1:
                raise ValueError("spec_ngram must be >= 1")
            if self.spec_ngram + self.spec_gamma >= self.T:
                raise ValueError("spec_ngram + spec_gamma must be < cache_len")
            if any(gc.kv_cache_dtype in ("int8", "int4") for gc in self.gcfgs):
                # a macro step writes each row's accepted prefix, of its own
                # length, which the uniform-index staging cannot express
                raise ValueError("spec_gamma > 0 requires kv_cache_dtype='auto' in the server: "
                                 "the speculative decode path has no staged quantized-cache "
                                 "write")
        # two pinned buffers for the per-block device-to-host copy, so a
        # pipelined block cannot overwrite the one still being harvested
        n = (sync_every * slots * max(2, self.spec_gamma + 2) + 2 * slots
             + slots * c.num_emotions)
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

    def _owner(self, i: int) -> int:
        """The data rank that holds slot ``i``."""
        off, size = self.groups[self._slot_group(i)]
        return (i - off) // (size // self.dp)

    def _local(self, i: int) -> int:
        """Slot ``i``'s row in its owner's per-slot tensors."""
        g = self._slot_group(i)
        off, size = self.groups[g]
        return self.lgroups[g][0] + (i - off) % (size // self.dp)

    def _capacity_need(self, g: int) -> int:
        """Capacity pool ``g`` needs this block: its longest active row's
        cursor (host mirror) plus one block of writes (a speculative block
        writes gamma + 1 positions a macro step, rejected ones included),
        and no less than its parked histories and partial prompts, which a
        shrink must not cut."""
        rows = [self.slots[i] for i in self._group_slots(g)]
        lens = [s.phys_len for s in rows if s.active]
        kept = [len(s.token_log) for s in rows if s.parked]
        kept += [s.phys_len for s in rows if s.prefilling]
        return max((max(lens) if lens else 0) + self._per_block_writes() + 1,
                   max(kept) if kept else 0)

    def _per_block_writes(self) -> int:
        return self.sync_every * (self.spec_gamma + 1 if self.spec_gamma else 1)

    # -- state ---------------------------------------------------------------

    @torch.inference_mode()
    def _init_state(self, seed: int) -> None:
        """(Re)initialize the queue, the results and all device state."""
        c, dev = self.cfg, self.device
        self.queue: List[tuple] = []
        self.results: Dict[int, Result] = {}
        self._phase: Dict[str, float] = {}
        self.slots = [_Slot() for _ in range(self.S)]
        self.sessions: Dict[str, int] = {}  # session_id -> its PARKED slot
        # slot -> in-progress chunked admission: the delta ids/tts (from the
        # absolute position ``base``), the consumed ``off``, the request
        self._chunks: Dict[int, dict] = {}
        self.ext_programs = 0  # extension forwards run
        self.evictions = 0     # parked sessions evicted for other requests
        self.spec_proposed = self.spec_accepted = self.spec_macro = 0
        self._next_id = 0
        self._admit_ctr = 0
        self.server_step = 0
        self.block_len_hist: Dict[int, int] = {}
        self.grows = 0
        self.shrinks = 0
        self._inflight = None
        self._block_ctr = 0
        t0 = self._phys_for(self.prompt_bucket + self._per_block_writes() + 1)
        self.Tphys = [t0 for _ in self.groups]
        self.caches = [gpt2.init_kv_cache(self.gcfgs[g], size, t0, caption_len=self.caption_len,
                                          device=dev, per_row_index=True, mesh=self.mesh)
                       for g, (_off, size) in enumerate(self.lgroups)]
        S = self.S_local
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
        # speculative serving: tokens[s, p] is the token consumed at position
        # p of slot s (the join writes the prompt, extensions their deltas,
        # macro steps the pending token and the proposals), at the logical
        # length T
        self.tokens = (torch.full((S, self.T), self.eos_id, dtype=torch.long, device=dev)
                       if self.spec_gamma else None)

    def _tick(self, name: str, t0: float) -> float:
        now = time.time()
        self._phase[name] = self._phase.get(name, 0.0) + (now - t0)
        return now

    def reset(self, seed: int = 0) -> None:
        """Drop all state (queue, results, slots, device buffers): a warm
        restart, keeping the built kernels. Over a mesh rank 0's reset
        reaches the other ranks with its next action."""
        self._init_state(seed)
        if self._shared and self.primary:
            self._outbox.append(("reset", seed))

    # -- lockstep over a mesh --------------------------------------------------

    def _sync(self, action: str = "") -> str:
        """Over a mesh: rank 0 broadcasts its queued operations and the
        ``action`` the ranks take next ("step", "flush", "done" at the end
        of its ``run_until_drained``, "idle" from ``heartbeat``, "stop");
        the others replay the operations in order and return the action.
        Without a world it returns ``action``."""
        if not self._shared:
            return action
        self._synced_at = time.monotonic()
        box = [(self._outbox, action) if self.primary else None]
        dist.broadcast_object_list(box, src=0)
        ops, action = box[0]
        self._outbox = []
        if not self.primary:
            for op, arg in ops:
                if op == "reset":
                    self._init_state(arg)
                elif op == "submit":
                    self.queue.append(arg)
                    self._next_id = max(self._next_id, arg[0] + 1)
                else:
                    self._cancel(arg)
        return action

    def _follow_until(self, ends: tuple) -> str:
        """A follower's loop: carry out rank 0's actions until one in ``ends``."""
        while True:
            action = self._sync()
            if action in ends:
                return action
            if action == "step":
                self._step()
            elif action == "flush":
                self._flush()

    def follow(self) -> None:
        """The loop of a rank other than 0 over a mesh: step, flush and
        replay rank 0's operations in lockstep until rank 0 calls
        ``stop_followers``."""
        if self.primary:
            raise RuntimeError("follow() runs on the ranks other than 0")
        self._follow_until(("stop",))

    def heartbeat(self) -> None:
        """Rank 0 while it has nothing to step: once ``HEARTBEAT_S`` has
        passed since its last broadcast, an "idle" action that carries its
        queued operations and that the followers answer with nothing, so
        that no follower waits in a collective long enough to reach the
        process group's timeout. The clock decides only when operations
        travel: every rank applies them before its next step. A no-op
        without a world."""
        if self._shared and self.primary and time.monotonic() - self._synced_at >= HEARTBEAT_S:
            self._sync("idle")

    def stop_followers(self) -> None:
        """Rank 0: ends the other ranks' ``follow`` (a no-op without a
        world)."""
        if self._shared and self.primary:
            self._sync("stop")

    # -- public API ------------------------------------------------------------

    def _session_delta(self, req: Request) -> Optional[int]:
        """The length of the delta ``req`` would prefill (its new tokens
        and the re-fed parked final token) when it continues a PARKED
        session, its prompt extending the session's history; else None."""
        sid = req.session_id
        if not sid or sid not in self.sessions:
            return None
        log = self.slots[self.sessions[sid]].token_log
        if not log or len(req.prompt_ids) < len(log) or list(req.prompt_ids[:len(log)]) != log:
            return None
        return len(req.prompt_ids) - len(log) + 1

    def submit(self, req: Request) -> int:
        """Queue a request; returns its id. The caller's Request is not
        changed (a normalized copy is queued). Over a mesh only rank 0
        takes requests."""
        if not self.primary:
            raise RuntimeError("over a mesh only rank 0 takes requests; the other ranks follow "
                               "(run_until_drained or follow)")
        changes: dict = {"stop": _norm_stop(req.stop)}
        if req.temperature <= 0.0:  # temperature 0 is greedy
            if req.temperature < 0.0:
                raise ValueError("temperature must be >= 0")
            changes["greedy"] = True
            changes["temperature"] = 1.0
        req = dataclasses.replace(req, **changes)
        if len(req.prompt_ids) > self.max_prompt and not self.prefill_chunk:
            # a session continuation prefills only its delta, so the history
            # may exceed max_prompt while a matching parked session exists
            # (it is protected from eviction while this request is queued);
            # with chunked prefill any prompt admits in chunks
            d = self._session_delta(req)
            if d is None or d > self.max_prompt:
                raise ValueError(f"prompt length {len(req.prompt_ids)} exceeds max_prompt "
                                 f"{self.max_prompt}" + (" (no matching parked session to "
                                                         "extend)" if req.session_id else ""))
        # the row occupies [0, prompt + max_new - 1) of its slot
        if len(req.prompt_ids) + req.max_new_tokens - 1 > self.T:
            raise ValueError(f"prompt ({len(req.prompt_ids)}) + max_new_tokens "
                             f"({req.max_new_tokens}) cannot fit the serving cache (cache_len "
                             f"{self.T}); raise cache_len or lower max_new_tokens")
        rid = self._next_id
        self._next_id += 1
        entry = (rid, req, self.server_step, time.time())
        self.queue.append(entry)
        if self._shared:  # the callback stays with rank 0
            self._outbox.append(("submit", (rid, dataclasses.replace(req, stream_cb=None),
                                            *entry[2:])))
        return rid

    def _fit_capacity(self) -> None:
        for g in range(len(self.groups)):
            need = self._phys_for(self._capacity_need(g))
            if need > self.Tphys[g]:
                self._grow_cache(g, need)
            elif need * 2 <= self.Tphys[g]:
                # hysteresis: shrink only once the need halves
                self._shrink_cache(g, need)

    def step(self) -> List[Result]:
        """One server iteration: admit into free slots, fit the capacity
        rung, run a decode block, harvest completions. Returns the results
        finished this call.

        With ``pipeline=True`` the block is dispatched FIRST, and the host
        harvests the previous block and stages admissions while it runs;
        a finished row then decodes one extra block before its slot frees.

        Over a mesh rank 0's step is every rank's: the others carry out
        rank 0's next action instead (its results, or [])."""
        if not self.primary:
            return self._follow_one()
        self._sync("step")
        return self._step()

    def _follow_one(self) -> List[Result]:
        """A rank other than 0 carries out rank 0's next action: the
        results of its step or flush, or []."""
        action = self._sync()
        if action == "step":
            return self._step()
        return self._flush() if action == "flush" else []

    @torch.inference_mode()
    def _step(self) -> List[Result]:
        if not self.pipeline:
            self._admit()
            self._advance_chunks(drain=not any(s.active for s in self.slots))
            if not any(s.active for s in self.slots):
                return []
            self._fit_capacity()
            return self._harvest(self._dispatch_block())
        nxt = self._dispatch_block() if any(s.active for s in self.slots) else None
        finished = self._harvest(self._inflight) if self._inflight is not None else []
        self._inflight = nxt
        # admissions enqueue after the in-flight block: they join the next one
        self._admit()
        self._advance_chunks(drain=not any(s.active for s in self.slots))
        if any(s.active for s in self.slots):
            self._fit_capacity()
        return finished

    def cancel(self, request_id: int) -> bool:
        """Abandon a request that is queued, in a chunked admission,
        decoding, or finished with an unread result. A dispatched block
        keeps stepping the row, whose tokens are skipped at harvest. False
        when the id is unknown. Over a mesh only rank 0 takes it."""
        if not self.primary:
            raise RuntimeError("over a mesh only rank 0 cancels requests")
        if self._shared:
            self._outbox.append(("cancel", request_id))
        return self._cancel(request_id)

    def _cancel(self, request_id: int) -> bool:
        for i, (rid, _req, _sub, _wall) in enumerate(self.queue):
            if rid == request_id:
                del self.queue[i]
                return True
        for slot, st in list(self._chunks.items()):
            if st["rid"] == request_id:
                del self._chunks[slot]
                s = self.slots[slot]
                s.prefilling, s.req, s.request_id, s.phys_len = False, None, -1, 0
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

    def in_flight(self) -> bool:
        """A dispatched pipelined block awaits its harvest (``flush``)."""
        return self._inflight is not None

    def busy(self) -> bool:
        """Queued requests, chunked admissions in progress (their slots are
        neither active nor queued) or active rows; a pipelined in-flight
        block is harvested by ``flush``."""
        return bool(self.queue or self._chunks or any(s.active for s in self.slots))

    def flush(self) -> List[Result]:
        """Harvest a still-in-flight pipelined block (no-op otherwise)."""
        if not self.primary:
            return self._follow_one()
        self._sync("flush")
        return self._flush()

    @torch.inference_mode()
    def _flush(self) -> List[Result]:
        if self._inflight is None:
            return []
        finished = self._harvest(self._inflight)
        self._inflight = None
        return finished

    def run_until_drained(self, max_iters: int = 10_000) -> Dict[int, Result]:
        """Step until nothing is queued or decoding. Over a mesh the other
        ranks follow rank 0's run to its end (and return the same results)."""
        if not self.primary:
            self._follow_until(("done", "stop"))
            return self.results
        for _ in range(max_iters):
            if not self.busy() and self._inflight is None:
                break
            self.step()
        self.flush()
        self._sync("done")
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
        pool ``g``. One 64-row prefill, then the join of its real rows.
        Over a data axis each rank prefills the entries whose slots it
        owns, padded to the same multiple of 8 on every rank and to at
        least 64 rows over the axis (the kernels' gates read the global
        batch); a rank that owns none skips the forward."""
        t0 = time.time()
        c, cl = self.gcfgs[g], self.caption_len
        reqs = [e[2] for e in entries]
        owners = [self._owner(e[0]) for e in entries]
        # (the entry's row in one process's group, the entry) of this rank
        mine = [(r, e) for r, e in enumerate(entries) if owners[r] == self.dr]
        G = len(mine)
        gb = max(-(-self.GROUP_CAP // self.dp),
                 _bucket(max(owners.count(r) for r in range(self.dp)), 8))
        self._admit_ctr += 1
        if G:
            self._prefill_group(mine, reqs, pb, g, gb)
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

    def _prefill_group(self, mine: List[tuple], reqs: List[Request], pb: int, g: int,
                       gb: int) -> None:
        """The prefill of this rank's entries ``mine`` ((row in the whole
        group, entry) pairs) at ``gb`` rows, and their join."""
        c, cl = self.gcfgs[g], self.caption_len
        G = len(mine)
        # the noise row of each prefill row: its entry's row in one process's
        # group (pad rows their own), so that sampled first tokens meet one
        # process's draws
        noise_rows = np.minimum(np.arange(gb), self.GROUP_CAP - 1)
        noise_rows[:G] = [r for r, _e in mine]
        ids = np.full((gb, pb), self.eos_id, np.int64)
        meta = np.zeros((3, G), np.int64)  # the slot's row in the pool's cache, its row, length
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
        for r, (_row, (slot_idx, _rid, req, _sub, _wall)) in enumerate(mine):
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
            local = self._local(slot_idx)
            meta[:, r] = (local - self.lgroups[g][0], local, Lp)
            topp[r], temps[r], greedy[r] = req.top_p, req.temperature, bool(req.greedy)

        put = self._put
        length = put(lengths)
        pmask = self._pmask_from_len(length, pb)
        pos = torch.clamp_min(torch.cumsum(pmask, dim=-1) - 1, 0).long()
        cap_mask_d = put(cap_mask)
        ids_d = put(ids)
        out = gpt2.forward(
            self.params, c, ids_d,
            token_type_ids=put(tts) if tts is not None else torch.full(
                (gb, pb), self.sp2_id, dtype=torch.long, device=self.device),
            position_ids=pos, attention_mask=pmask,
            cache=gpt2.init_kv_cache(c, gb, pb, caption_len=cl, device=self.device,
                                     mesh=self.mesh),
            imgs=put(img) if img is not None else None,
            auds=put(aud) if aud is not None else None,
            caption_ids=put(cap_ids) if cap_ids is not None else None,
            encoder_attention_mask=cap_mask_d if any_cap else None,
            prefix_prefill=True, compute_logits="last", mesh=self.mesh)
        logits = out.logits[:, -1, :]
        first = torch.argmax(logits, dim=-1)
        topp_d, temps_d, greedy_d = put(topp), put(temps), put(greedy)
        if not greedy[:G].all():
            gen = torch.Generator(device=self.device).manual_seed(
                fold_seed(reqs[0].seed, self._admit_ctr))
            k = min(64, logits.shape[-1])
            noise = _gumbel((self.GROUP_CAP, k), gen, self.device)[put(noise_rows)]
            sampled = sample_top_p(logits / temps_d.clamp_min(1e-6)[:, None], None,
                                   topp_d[:, None], gumbel=noise)
            first = torch.where(greedy_d, first, sampled)
        self._join(g, out, first, put(meta), pb, G, topp_d[:G], temps_d[:G], greedy_d[:G],
                   cap_mask_d[:G], logits[:G] if any(r.logprobs for r in reqs) else None,
                   ids_d[:G])

    def _join(self, g: int, out, first, meta, pb: int, G: int, topp, temps, greedy,
              cap_mask, logits, ids) -> None:
        """Scatter the group's first ``G`` prefilled rows into their slots
        (``meta``: each row's row in the pool's cache and in the per-slot
        tensors, its length): each row's prompt, right-aligned at
        [pb - len, pb) of the prefill cache, is gathered to [0, len) of its
        slot; the slot's cursor and per-row state are set. ``logits`` (given when a row asks for
        logprobs) give the first tokens' logprobs; ``ids`` [G, pb], the
        prompts, go to the speculative token buffer."""
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
        if self.tokens is not None:
            # left-aligned prompt ids at [0, len); the duplicated tail is
            # junk above the cursor, which a lookup never matches
            self.tokens[glob, :pb] = ids.gather(1, src)

    def _admit_ext_group(self, entries: List[dict], pbd: int, g: int = 0) -> None:
        """One extension forward over pool ``g``'s Sg rows, ``pbd``
        positions wide, against the LIVE pool cache (``_extend_fn`` and
        ``_admit_ext_group`` of ``ergm_tpu``). entries: dicts with slot,
        start, ids, tts, req, rid, sub, wall, final. Each extending row's
        delta is written at [start, start + len) and attends to the row's
        retained history (kpos <= start + j); its cursor moves to start +
        len. The other rows run junk at their own cursor (above their
        content, overwritten by later steps, dropped past capacity) and
        keep their cursor. The last hidden row of each delta gives the
        row's first token (greedy or sampled), its logprob and emotion
        logits; the per-slot rows update on the device. A session
        continuation re-feeds the parked final token, whose K/V write was
        not guaranteed at park time, then the new tokens; a chunked
        admission feeds its next slice. A non-final chunk leaves the slot
        prefilling (its first token is mid-prompt junk that the next chunk
        replaces); the final one activates it."""
        t0 = time.time()
        loff, Sg = self.lgroups[g]
        ids = np.full((Sg, pbd), self.eos_id, np.int64)
        tts = np.full((Sg, pbd), self.sp2_id, np.int64)
        meta = np.zeros((4, Sg), np.int64)  # extends, start, delta length, greedy
        topp = np.full((Sg,), 0.95, np.float32)
        temps = np.ones((Sg,), np.float32)
        mine = [e for e in entries if self._owner(e["slot"]) == self.dr]
        for e in mine:
            i, d = self._local(e["slot"]) - loff, len(e["ids"])
            ids[i, :d] = e["ids"]
            if e["tts"] is not None:
                tts[i, :d] = e["tts"][:d]
            meta[:, i] = (1, e["start"], d, int(bool(e["req"].greedy)))
            topp[i], temps[i] = e["req"].top_p, e["req"].temperature
        self._admit_ctr += 1
        put = self._put
        seed = (None if all(e["req"].greedy for e in entries)
                else fold_seed(sum(e["req"].seed for e in entries), self._admit_ctr))
        if mine:  # a rank that owns none of the rows skips the forward
            self._extend(g, put(ids), put(tts), put(meta), put(topp), put(temps), seed,
                         any(e["req"].logprobs for e in entries))
        else:
            self.ext_programs += 1
        for e in entries:
            s = self.slots[e["slot"]]
            s.request_id, s.req = e["rid"], e["req"]
            s.submitted_step, s.submitted_wall = e["sub"], e["wall"]
            if e["final"]:
                s.active, s.prefilling = True, False
                s.admitted_step = self.server_step
                s.admitted_block = self._block_ctr
                s.generated, s.lps, s.has_first = [], [], False
                s.phys_len = len(e["req"].prompt_ids)
                self._chunks.pop(e["slot"], None)
            else:
                s.prefilling = True
                s.phys_len = e["start"] + len(e["ids"])
        self._tick("admit_ext", t0)

    def _extend(self, g: int, ids_d, tts_d, meta_d, topp_d, temps_d, seed: Optional[int],
                want_lp: bool) -> None:
        """The extension program (``_extend_fn`` of ``ergm_tpu``) over pool
        ``g``, from device inputs: ``meta_d`` [4, Sg] holds each row's
        extends flag, start, delta length and greedy flag; sampled rows
        draw from ``fold_seed``'s ``seed``. No host read."""
        c, cl = self.gcfgs[g], self.caption_len
        off, Sg = self.lgroups[g]
        pbd = ids_d.shape[1]
        self.ext_programs += 1
        ext, start, dlen, greedy_d = meta_d[0] > 0, meta_d[1], meta_d[2], meta_d[3] > 0
        cache = self.caches[g]
        orig = cache.index
        vis = torch.where(ext, start.to(orig.dtype), orig)
        pos = torch.clamp_max(vis.long()[:, None] + torch.arange(pbd, device=self.device)[None, :],
                              c.n_positions - 1)
        out = gpt2.forward(
            self.params, c, ids_d, token_type_ids=tts_d, position_ids=pos,
            cache=dataclasses.replace(cache, index=vis),
            encoder_attention_mask=self.cap_mask[off:off + Sg] if cl else None,
            seq_lengths=dlen.clamp(1, pbd), compute_logits=False, mesh=self.mesh)
        self.caches[g] = dataclasses.replace(
            out.cache, index=torch.where(ext, (start + dlen).to(orig.dtype), orig))
        # the last hidden row of each ragged delta: lm_head on [Sg, D] only
        jlast = (dlen - 1).clamp(0, pbd - 1)
        h_last = out.hidden[torch.arange(Sg, device=self.device), jlast][:, None, :]
        logits = gpt2.lm_logits(self.params, h_last)[:, 0]
        first = torch.argmax(logits, dim=-1)
        if seed is not None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            # one process's [pool, k] draw; this rank's rows of the pool
            noise = _gumbel((Sg * self.dp, min(64, logits.shape[-1])), gen, self.device)
            sampled = sample_top_p(logits / temps_d.clamp_min(1e-6)[:, None], None,
                                   topp_d[:, None], gumbel=noise[self.dr * Sg:(self.dr + 1) * Sg])
            first = torch.where(greedy_d, first, sampled)

        def upd(x, new):  # the pool's rows of a per-slot tensor, where extending
            rows = x[off:off + Sg]
            keep = ext.view(-1, *([1] * (rows.dim() - 1)))
            rows.copy_(torch.where(keep, new.to(rows.dtype), rows))

        upd(self.last, first[:, None])
        upd(self.greedy_row, greedy_d)
        upd(self.top_p_row, topp_d)
        upd(self.temp_row, temps_d)
        upd(self.first_tok, first)
        if want_lp:
            lsm = torch.log_softmax(logits.float(), dim=-1)
            upd(self.first_lp, lsm.gather(-1, first[:, None])[:, 0])
        upd(self.emo_slot, out.emotion_logits.float())
        if self.tokens is not None:
            # the deltas into the token buffer, each at [start, start + len)
            tok = self.tokens[off:off + Sg]
            rel = torch.arange(self.T, device=self.device)[None, :] - start[:, None]
            inwin = ext[:, None] & (rel >= 0) & (rel < dlen[:, None])
            tok.copy_(torch.where(inwin, ids_d.gather(1, rel.clamp(0, pbd - 1)), tok))

    def _grow_for(self, ext_groups: Dict[tuple, List[dict]], pbs=()) -> None:
        """Grow each pool's rung to cover its active rows, the admission
        windows [0, pb) of ``pbs`` ((pb, pool) pairs) and the extensions'
        writes, plus one block of writes, before any program runs."""
        extra = self._per_block_writes() + 1
        for g in range(len(self.groups)):
            need = self._capacity_need(g)
            for pb, pg in pbs:
                if pg == g:
                    need = max(need, pb + extra)
            for (_pbd, pg), entries in ext_groups.items():
                if pg == g:
                    need = max(need, max(e["start"] + len(e["ids"]) for e in entries) + extra)
            need = self._phys_for(need)
            if need > self.Tphys[g]:
                self._grow_cache(g, need)

    def _advance_chunks(self, drain: bool) -> None:
        """Feed the next slice of every chunked admission in progress: ONE
        chunk a server step (the interference bound: concurrent streams see
        at most one chunk-wide forward between blocks), or, with ``drain``
        (nothing decoding), every chunk until all are done."""
        while self._chunks:
            by_pbd: Dict[tuple, List[dict]] = {}  # (pbd, pool) -> entries
            for slot, st in list(self._chunks.items()):
                if st.pop("skip_once", None):
                    # chunk 1 of a fresh admission ran this step
                    continue
                ids, off = st["ids"], st["off"]
                dlen = min(self.prefill_chunk, len(ids) - off)
                e = {"slot": slot, "start": st["base"] + off, "ids": ids[off:off + dlen],
                     "tts": st["tts"][off:off + dlen] if st["tts"] is not None else None,
                     "req": st["req"], "rid": st["rid"], "sub": st["sub"], "wall": st["wall"],
                     "final": off + dlen == len(ids)}
                st["off"] = off + dlen
                by_pbd.setdefault((_bucket(dlen, self.EXT_BUCKET), self._slot_group(slot)),
                                  []).append(e)
            self._grow_for(by_pbd)
            for (pbd, g), entries in by_pbd.items():
                self._admit_ext_group(entries, pbd, g)
            if not drain:
                break

    def _route(self, req: Request) -> int:
        """The pool a fresh admission prefers: the long pool iff the row's
        expected final length (prompt + max_new - 1) exceeds
        long_threshold, or the request pins a pool. Session rows stay in
        the pool that admitted their first turn."""
        if not self.long_slots:
            return 0
        if req.pool == "long":
            return 1
        if req.pool == "short":
            return 0
        return 1 if len(req.prompt_ids) + req.max_new_tokens - 1 > self.long_threshold else 0

    def _take_free_slot(self, protected: set, taken: set, g: int = 0) -> Optional[int]:
        """A free slot, preferring pool ``g``, else the least recently used
        parked one that no queued request's session names (``protected``).
        Short requests overflow into idle long slots; long requests never
        take short slots (one long row would widen the rung every short
        slot reads). ``taken`` holds the slots already assigned in this
        admission pass."""
        pools = [g] + ([1] if self.long_slots and g == 0 else [])
        for p in pools:
            for i in self._group_slots(p):
                s = self.slots[i]
                if not (s.active or s.parked or s.prefilling) and i not in taken:
                    taken.add(i)
                    return i
        for p in pools:
            cands = [(self.slots[i].last_use, i) for i in self._group_slots(p)
                     if self.slots[i].parked and self.slots[i].session not in protected
                     and i not in taken]
            if cands:
                i = min(cands)[1]
                self._unpark(i)
                self.evictions += 1
                taken.add(i)
                return i
        return None

    def _session_ext_entry(self, slot_idx, rid, req, sub, wall, log) -> dict:
        """A continuation's extension entry: the re-fed parked final token
        (token type sp2: it was generated), then the prompt's new tokens
        with their request token types."""
        delta = [log[-1]] + list(req.prompt_ids[len(log):])
        dtts = None
        if req.token_type_ids is not None:
            tt = list(req.token_type_ids)[-(len(delta) - 1):] if len(delta) > 1 else []
            dtts = [self.sp2_id] + tt
            dtts += [self.sp2_id] * (len(delta) - len(dtts))
        return {"slot": slot_idx, "start": len(log) - 1, "ids": delta, "tts": dtts, "req": req,
                "rid": rid, "sub": sub, "wall": wall, "final": True}

    def _admit(self) -> None:
        if not self.queue:
            return
        if self.admit_policy == "sorted" and len(self.queue) > 1:
            self.queue.sort(key=lambda q: -q[1].max_new_tokens)  # stable
        by_pb: Dict[tuple, List[tuple]] = {}   # (prompt bucket, pool) -> fresh entries
        by_ext: Dict[tuple, List[dict]] = {}   # (delta bucket, pool) -> continuations
        deferred: List[tuple] = []
        claimed: set = set()  # sessions extended in this pass
        taken: set = set()
        chunk_first: List[tuple] = []  # (slot, request) of chunked fresh admissions
        protected = {q[1].session_id for q in self.queue if q[1].session_id}
        for rid, req, sub, wall in self.queue:
            sid = req.session_id
            if sid and (sid in claimed or any((s.active or s.prefilling) and s.req is not None
                                              and s.req.session_id == sid for s in self.slots)):
                # the session's previous turn is still running: wait for the park
                deferred.append((rid, req, sub, wall))
                continue
            d = self._session_delta(req)
            if d is not None and (d <= self.max_prompt or self.prefill_chunk):
                slot_idx = self.sessions[sid]
                s = self.slots[slot_idx]
                log = list(s.token_log)
                self._unpark(slot_idx)  # claimed by the continuation
                claimed.add(sid)
                taken.add(slot_idx)
                e = self._session_ext_entry(slot_idx, rid, req, sub, wall, log)
                if self.prefill_chunk and d > self.prefill_chunk:
                    # a long continuation delta admits in chunks too
                    self._chunks[slot_idx] = {"rid": rid, "req": req, "sub": sub, "wall": wall,
                                              "ids": e["ids"], "tts": e["tts"], "off": 0,
                                              "base": e["start"]}
                    s.prefilling, s.req = True, req
                    continue
                by_ext.setdefault((_bucket(d, self.EXT_BUCKET), self._slot_group(slot_idx)),
                                  []).append(e)
                continue
            if sid and sid in self.sessions:
                # the prompt left the parked history: its K/V is useless
                self._unpark(self.sessions[sid])
            slot_idx = self._take_free_slot(protected, taken, self._route(req))
            if slot_idx is None:
                deferred.append((rid, req, sub, wall))
                continue
            grp = self._slot_group(slot_idx)
            Lp = len(req.prompt_ids)
            if self.prefill_chunk and Lp > self.prefill_chunk:
                # chunk 1 rides the admission group (the modality injection,
                # the caption K/V and K1); the rest rides extensions
                C = self.prefill_chunk
                full_tt = (None if req.token_type_ids is None
                           else (list(req.token_type_ids) + [self.sp2_id] * Lp)[:Lp])
                pseudo = dataclasses.replace(
                    req, prompt_ids=list(req.prompt_ids[:C]),
                    token_type_ids=None if full_tt is None else full_tt[:C])
                self._chunks[slot_idx] = {"rid": rid, "req": req, "sub": sub, "wall": wall,
                                          "ids": list(req.prompt_ids), "tts": full_tt, "off": C,
                                          "base": 0, "skip_once": True}
                chunk_first.append((slot_idx, req))
                by_pb.setdefault((_bucket(C, self.prompt_bucket), grp), []).append(
                    (slot_idx, rid, pseudo, sub, wall))
                continue
            by_pb.setdefault((_bucket(Lp, self.prompt_bucket), grp), []).append(
                (slot_idx, rid, req, sub, wall))
        self.queue = deferred
        if not by_pb and not by_ext:
            return
        # joins write the [0, pb) window, extensions up to the whole
        # continuation: capacity must cover both first
        self._grow_for(by_ext, by_pb.keys())
        for (pb, g), entries in by_pb.items():
            for i in range(0, len(entries), self.GROUP_CAP):
                self._admit_group(entries[i:i + self.GROUP_CAP], pb, g)
        for (pbd, g), entries in by_ext.items():
            self._admit_ext_group(entries, pbd, g)
        for slot_idx, req in chunk_first:
            # the group prefilled chunk 1 and activated the slot: back to
            # prefilling, with the real request, until the last chunk
            s = self.slots[slot_idx]
            s.active, s.prefilling, s.req = False, True, req

    # -- decode ----------------------------------------------------------------

    def _pick_block_len(self) -> int:
        """``sync_every``, except while draining (no queue): the smallest
        ladder length covering the longest remaining budget (stop
        sequences only end rows earlier)."""
        if not self.adaptive_block or self.queue or self._chunks:
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
        return torch.cat([x[self.lgroups[g][0]:sum(self.lgroups[g])] for g in inc])

    def _decode_noise(self, inc: List[int], k: int) -> torch.Tensor:
        """A decode step's Gumbel noise for this rank's rows of the pools
        ``inc``: one process's [rows of inc, k] draw from the decode
        generator, each rank keeping its rows."""
        full = _gumbel((sum(self.groups[g][1] for g in inc), k), self.gen, self.device)
        if self.dp == 1:
            return full
        parts, row0 = [], 0
        for g in inc:
            size = self.groups[g][1]
            n = size // self.dp
            parts.append(full[row0 + self.dr * n:row0 + (self.dr + 1) * n])
            row0 += size
        return torch.cat(parts)

    def _decode(self, all_greedy: bool, actives: tuple, want_lp: bool, K: int):
        """Enqueue K decode steps over the pools with an active row (the
        others pass through untouched). Returns the [K, S] tokens and,
        with ``want_lp``, their [K, S] logprobs; no host read."""
        c, cl = self.cfg, self.caption_len
        inc = [g for g in range(len(self.groups)) if actives[g]]
        staged = [g for g in inc if self.gcfgs[g].kv_cache_dtype in ("int8", "int4")]
        caches = list(self.caches)
        for g in staged:
            shape = (c.n_layer, *caches[g].k.shape[1:3], K, c.head_dim)
            caches[g] = dataclasses.replace(
                caches[g], sk=torch.zeros(shape, dtype=c.compute_dtype, device=self.device),
                sv=torch.zeros(shape, dtype=c.compute_dtype, device=self.device))
        if not all_greedy:
            topp, temp = self._rows(self.top_p_row, inc), self._rows(self.temp_row, inc)
            greedy = self._rows(self.greedy_row, inc)
        toks = torch.empty((K, self.S_local), dtype=torch.long, device=self.device)
        lps = torch.zeros((K, self.S_local), device=self.device) if want_lp else None
        last = self.last
        for i in range(K):
            parts = []
            for g in inc:
                off, Sg = self.lgroups[g]
                pos = torch.clamp_max(caches[g].index, c.n_positions - 1).long()[:, None]
                out = gpt2.forward(
                    self.params, self.gcfgs[g], last[off:off + Sg],
                    token_type_ids=self._sp2[off:off + Sg], position_ids=pos, cache=caches[g],
                    stage_index=i if g in staged else None,
                    encoder_attention_mask=self.cap_mask[off:off + Sg] if cl else None,
                    mesh=self.mesh)
                parts.append(out.logits[:, -1, :])
                caches[g] = out.cache
            logits = parts[0] if len(parts) == 1 else torch.cat(parts)
            nxt = torch.argmax(logits, dim=-1)
            if not all_greedy:
                sampled = sample_top_p(logits / temp.clamp_min(1e-6)[:, None], None,
                                       topp[:, None],
                                       gumbel=self._decode_noise(inc, min(64, logits.shape[-1])))
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
                    off, Sg = self.lgroups[g]
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

    def _spec_decode(self, actives: tuple):
        """``sync_every`` MACRO steps over the pools with an active row
        (``_spec_decode_fn`` of ``ergm_tpu``), with no host read. Each
        drafts ``spec_gamma`` tokens a slot from the most recent earlier
        occurrence of its last ``spec_ngram`` consumed tokens in the token
        buffer (the pending token repeated when there is none), verifies
        [pending, proposals] in ONE forward of gamma + 1 positions, accepts
        the longest prefix of proposals equal to the verify argmaxes y,
        and moves the cursor to index + accepted + 1: the emitted tokens
        are y[:accepted + 1]. Returns the [M, S, gamma + 1] argmaxes and
        the [M, S] counts."""
        c, cl, dev = self.cfg, self.caption_len, self.device
        M, G, N, T = self.sync_every, self.spec_gamma, self.spec_ngram, self.T
        W = T - N - G  # candidate window starts
        out_toks = torch.zeros((M, self.S_local, G + 1), dtype=torch.long, device=dev)
        out_cnt = torch.zeros((M, self.S_local), dtype=torch.long, device=dev)
        tpos = torch.arange(T, device=dev)[None, :]
        wpos = torch.arange(W, device=dev)[None, :]
        for m in range(M):
            for g in (g for g in range(len(self.groups)) if actives[g]):
                off, Sg = self.lgroups[g]
                cache = self.caches[g]
                tok = self.tokens[off:off + Sg]
                last = self.last[off:off + Sg]
                idx = cache.index.long()
                # the pending token at its position
                tok.scatter_(1, idx.clamp(0, T - 1)[:, None], last)
                key = tok.gather(1, (idx[:, None] - (N - 1) + torch.arange(N, device=dev)[None, :])
                                 .clamp(0, T - 1))
                eq = torch.ones((Sg, W), dtype=torch.bool, device=dev)
                for j in range(N):
                    eq &= tok[:, j:j + W] == key[:, j:j + 1]
                # the window must end strictly before this occurrence
                eq &= (wpos + N - 1 < idx[:, None]) & (idx >= N)[:, None]
                found = eq.any(dim=1)
                # the most recent match: the first maximum of the reversed row
                t_star = torch.where(found, W - 1 - torch.argmax(eq.flip(1).int(), dim=1), 0)
                props = tok.gather(1, t_star[:, None] + N + torch.arange(G, device=dev)[None, :])
                props = torch.where(found[:, None], props, last)
                # the proposals after the pending token (past T: dropped)
                rel = tpos - idx[:, None] - 1
                inwin = (rel >= 0) & (rel < G)
                tok.copy_(torch.where(inwin, props.gather(1, rel.clamp(0, G - 1)), tok))
                pos = torch.clamp_max(idx[:, None] + torch.arange(G + 1, device=dev)[None, :],
                                      c.n_positions - 1)
                out = gpt2.forward(
                    self.params, self.gcfgs[g], torch.cat([last, props], dim=1),
                    token_type_ids=self._sp2[off:off + Sg].expand(Sg, G + 1), position_ids=pos,
                    cache=cache, encoder_attention_mask=self.cap_mask[off:off + Sg] if cl else None,
                    mesh=self.mesh)
                y = torch.argmax(out.logits, dim=-1)  # [Sg, G + 1]
                match = props == y[:, :G]
                a = torch.where(match.all(dim=1), G, torch.argmin(match.int(), dim=1))
                cnt = a + 1
                # the cursor back to the accepted prefix (the K/V above it is
                # invisible junk, overwritten later)
                self.caches[g] = dataclasses.replace(out.cache,
                                                     index=(idx + cnt).to(cache.index.dtype))
                last.copy_(y.gather(1, a[:, None]))
                out_toks[m, off:off + Sg] = y
                out_cnt[m, off:off + Sg] = cnt
        return out_toks, out_cnt

    def _dispatch_block(self):
        """Enqueue one decode block and its one device-to-host copy;
        returns the in-flight handle. A plain block advances the cursor
        mirrors here (the device cursors move whether or not the host has
        harvested); a speculative one advances each row by its own count,
        so its mirrors move at harvest (spec mode is synchronous only).
        Blocks are speculative when every active row is greedy and none
        wants logprobs."""
        all_greedy = all(s.req.greedy for s in self.slots if s.active)
        want_lp = any(s.active and s.req.logprobs for s in self.slots)
        spec = bool(self.spec_gamma) and all_greedy and not want_lp
        actives = tuple(any(self.slots[i].active for i in self._group_slots(g))
                        for g in range(len(self.groups)))
        t0 = time.time()
        if spec:
            n = self.sync_every
            toks, cnts = self._spec_decode(actives)
            self.spec_macro += n
            parts = [toks.flatten().float(), cnts.flatten().float()]
        else:
            n = self._pick_block_len()
            toks, lps = self._decode(all_greedy, actives, want_lp, n)
            parts = [toks.flatten().float()]
        parts += [self.first_tok.float(), self.emo_slot.flatten()]
        if want_lp:
            parts += [lps.flatten(), self.first_lp]
        # every data rank's rows, rank by rank (``_harvest`` maps them back)
        packed = all_gather_rows(torch.cat(parts), self._data_group)
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
        if not spec:
            for s in self.slots:
                if s.active:
                    s.phys_len += n
        return block_id, n, spec, want_lp, host, event

    def _harvest(self, inflight) -> List[Result]:
        """Wait for one block's copy (its one host round trip) and do the
        token bookkeeping. Rows admitted after the block was dispatched
        (pipelined mode) are skipped: their tokens start in the next one."""
        block_id, n, spec, want_lp, host, event = inflight
        t0 = time.time()
        if event is not None:
            event.synchronize()
        toks_h, cnts_h, first_h, emo_h, lps_h, flp_h = self._unpack(host.numpy(), n, spec,
                                                                    want_lp)
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
            if spec:
                for m in range(n):
                    cnt = int(cnts_h[m, i])
                    s.phys_len += cnt
                    self.spec_proposed += self.spec_gamma
                    self.spec_accepted += cnt - 1
                    for k in range(cnt):
                        if self._done(s):
                            break
                        s.generated.append(int(toks_h[m, i, k]))
            else:
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

    def _unpack(self, arr: np.ndarray, n: int, spec: bool, want_lp: bool) -> tuple:
        """A block's host copy (each data rank's part in turn) as per-slot
        arrays over the whole slot table: tokens ([n, S], or [n, S, gamma +
        1] with the [n, S] counts), first tokens, emotion rows and, with
        ``want_lp``, the logprobs and first logprobs."""
        S, E, G1 = self.S_local, self.cfg.num_emotions, self.spec_gamma + 1
        out = None
        for r, part in enumerate(arr.reshape(self.dp, -1)):
            if spec:
                toks = part[:n * S * G1].reshape(n, S, G1).astype(np.int64)
                cnts = part[n * S * G1:n * S * (G1 + 1)].reshape(n, S).astype(np.int64)
                o = n * S * (G1 + 1)
            else:
                toks, cnts = part[:n * S].reshape(n, S).astype(np.int64), None
                o = n * S
            got = [toks, cnts, part[o:o + S].astype(np.int64),
                   part[o + S:o + S + S * E].reshape(S, E).copy(), None, None]
            if want_lp:
                o += S + S * E
                got[4] = part[o:o + n * S].reshape(n, S).copy()
                got[5] = part[o + n * S:o + n * S + S].copy()
            if self.dp == 1:
                return tuple(got)
            if out is None:  # the slot axis is axis 1 of the per-step arrays, 0 of the others
                out = [None if x is None else np.empty(
                    (x.shape[0], self.S, *x.shape[2:]) if i in (0, 1, 4) else
                    (self.S, *x.shape[1:]), x.dtype) for i, x in enumerate(got)]
            cols = self._glob[r]
            for i, x in enumerate(got):
                if x is not None:
                    if i in (0, 1, 4):
                        out[i][:, cols] = x
                    else:
                        out[i][cols] = x
        return tuple(out)

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
        if s.req.session_id:
            # park: keep the slot's K/V for the session's next turn. The
            # last emitted token's K/V write is not guaranteed (it may be
            # pending when the block ends), so the continuation re-feeds it:
            # token_log is everything consumed or emitted, and the cache
            # surely holds token_log[:-1]
            sid = s.req.session_id
            old = self.sessions.get(sid)
            if old is not None and old != slot_idx:
                self._unpark(old)  # the same session finished again elsewhere
            s.parked, s.session = True, sid
            s.token_log = list(s.req.prompt_ids) + list(s.generated)
            s.phys_len = len(s.token_log)
            s.last_use = self._block_ctr
            self.sessions[sid] = slot_idx
        s.req = None
        s.generated, s.lps, s.has_first = [], [], False
        return res

    def _unpark(self, slot_idx: int) -> None:
        s = self.slots[slot_idx]
        if s.session is not None:
            self.sessions.pop(s.session, None)
        s.parked, s.session, s.token_log = False, None, []
