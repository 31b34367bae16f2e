"""Interactive dialogue REPL over the KV-cached decoder (counterpart of
``ergm_tpu/infer/interact.py``).

An addition beyond the reference CLI (its modes are train/infer only,
src/main.py:341): type utterances, the model replies; the dialogue
window is re-assembled per turn with the same convention as training
data (``data/assembly.py``: bos + alternating sp1/sp2 turns), so a
trained checkpoint behaves as in evaluation. ``max_turns`` truncates the
history window (the flag the reference parses but never uses —
SURVEY.md §2.4.8). Replies are sampled from one ``torch.Generator`` on
the parameters' device, seeded with ``seed`` and advancing across turns
(JAX splits a key per turn, so sampled replies differ from JAX's).

Over a mesh (``mesh=``, ``params`` each rank's shard) every rank runs the
REPL: rank 0 reads each line and broadcasts it, every rank decodes the
turn through ``generate_batch(mesh=)``, and rank 0 prints. While rank 0
waits for a line it broadcasts an idle mark every ``HEARTBEAT_S``, so that
the other ranks never wait in the broadcast for as long as the process
group's timeout.
"""

from __future__ import annotations

import io
import queue
import sys
import threading
from typing import List, Optional

import torch
import torch.distributed as dist

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.tokens import SpecialTokens
from ergm_tpu_torch.data.assembly import build_window
from ergm_tpu_torch.parallel.collectives import HEARTBEAT_S
from ergm_tpu_torch.infer.generate import generate_batch


class DialogueSession:
    def __init__(self, params, config: ModelConfig, st: SpecialTokens,
                 tokenizer=None, max_len: int = 1024, max_turns: Optional[int] = None,
                 top_p: float = 0.95, seed: int = 0, mesh=None,
                 draft_layers: int = 0, spec_gamma: int = 4):
        self.mesh = mesh
        self.params = params
        self.draft_layers = draft_layers
        self.spec_gamma = spec_gamma
        self.config = config
        self.st = st
        self.tokenizer = tokenizer
        self.max_len = min(max_len, config.n_positions)
        self.max_turns = max_turns
        self.top_p = top_p
        device = next(params.parameters()).device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.turns: List[List[int]] = []  # token ids per utterance

    def _encode(self, text: str) -> List[int]:
        if self.tokenizer is None:
            raise ValueError("interactive mode needs a tokenizer "
                             "(pass --tokenizer_dir)")
        return self.tokenizer.encode(text)

    def _decode(self, ids: List[int]) -> str:
        return self.tokenizer.decode(ids, skip_special_tokens=True)

    def _window(self):
        turns = self.turns
        # window for a NEXT (model) turn: treat it like predicting
        # utterance len(turns); build_window targets an existing index, so
        # append a placeholder and strip its tokens.
        fake = turns + [[]]
        w = build_window(fake, len(fake) - 1, self.st,
                         max_turns=self.max_turns, max_len=self.max_len)
        flat, tts = [], []
        # token types follow the window-parity rule the dataset uses
        # (data/dataset.py token_types)
        for c, turn in enumerate(w):
            sp = self.st.sp1_id if c % 2 == 0 else self.st.sp2_id
            flat.extend(turn)
            tts.extend([sp] * len(turn))
        return flat[:-1], tts[:-1]  # drop the placeholder's trailing eos

    def reply(self, user_text: str, max_new_tokens: int = 64) -> str:
        self.turns.append(self._encode(user_text))
        prompt, tts = self._window()
        outs, _ = generate_batch(
            self.params, self.config, [prompt], token_types=[tts],
            max_len=self.max_len,
            eos_id=self.st.eos_id, sp2_id=self.st.sp2_id, top_p=self.top_p,
            generator=self.generator, max_new_tokens=max_new_tokens,
            draft_layers=self.draft_layers, spec_gamma=self.spec_gamma, mesh=self.mesh)
        reply_ids = [t for t in outs[0] if t != self.st.eos_id]
        self.turns.append(reply_ids)
        return self._decode(reply_ids)


def _in_world() -> bool:
    return dist.is_available() and dist.is_initialized()


def _lines(stdin, mesh):
    """The input lines; over a mesh rank 0 reads them and every rank gets
    each (the end too) by a broadcast."""
    if mesh is None or not _in_world():
        yield from stdin
        return
    if dist.get_rank() != 0:
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0)
            kind, line = box[0]
            if kind == "end":
                return
            if kind == "line":
                yield line
    # rank 0: a reader thread waits on the input, so that this one can
    # broadcast the idle mark meanwhile
    lines: "queue.Queue" = queue.Queue()

    def read():
        try:
            for line in stdin:
                lines.put(line)
        finally:
            lines.put(None)

    threading.Thread(target=read, name="ergm-repl-reader", daemon=True).start()
    while True:
        try:
            line = lines.get(timeout=HEARTBEAT_S)
        except queue.Empty:
            dist.broadcast_object_list([("idle", None)], src=0)
            continue
        dist.broadcast_object_list([("end" if line is None else "line", line)], src=0)
        if line is None:
            return
        yield line


def run_repl(params, config, st, tokenizer, *, max_len=1024, max_turns=None,
             top_p=0.95, seed=0, stdin=None, stdout=None, mesh=None,
             draft_layers=0, spec_gamma=4):
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    if mesh is not None and _in_world() and dist.get_rank() != 0:
        stdout = io.StringIO()  # rank 0 prints
    session = DialogueSession(params, config, st, tokenizer,
                              max_len=max_len, max_turns=max_turns,
                              top_p=top_p, seed=seed, mesh=mesh,
                              draft_layers=draft_layers,
                              spec_gamma=spec_gamma)
    print("Interactive dialogue (empty line or Ctrl-D to quit).", file=stdout)
    for line in _lines(stdin, mesh):
        text = line.strip()
        if not text:
            break
        try:
            reply = session.reply(text)
        except Exception as e:  # surface, keep the session alive
            print(f"[error: {e}]", file=stdout)
            continue
        print(f"model> {reply}", file=stdout)
    print("bye.", file=stdout)
