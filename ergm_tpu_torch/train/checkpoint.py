"""Checkpoint save and restore with ``torch.save`` (counterpart of
``ergm_tpu/train/checkpoint.py``, which uses orbax).

Best-valid-PPL checkpoints keep the reference's names,
``best_ckpt_epoch={E}_valid_ppl={P:.4f}``: a directory holding
``state.pt`` with the parameters, the optimizer state (with a gradient
accumulation in progress), the step count, the epoch and the best PPL.
A save writes a temporary file and renames it, so a crash never leaves
half a checkpoint behind.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

from ergm_tpu_torch.train.steps import TrainState

_CKPT_RE = re.compile(r"best_ckpt_epoch=(\d+)_valid_ppl=([\d.eE+-]+?)/?$")
STATE_FILE = "state.pt"
PREEMPT_NAME = "preempt_ckpt"


def _save(path: str, state: TrainState, epoch: int, best_ppl: float,
          drop_partial: bool = False) -> str:
    os.makedirs(path, exist_ok=True)
    payload = {
        "params": state.params.state_dict(),
        "opt_state": state.opt_state.state_dict(drop_partial=drop_partial),
        "step": int(state.step),
        "epoch": int(epoch),
        "best_ppl": float(best_ppl),
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int, best_ppl: float,
                    keep_best: Optional[int] = None) -> str:
    """Save a best-PPL checkpoint. ``keep_best``: retain only the N
    lowest-PPL checkpoints, deleting the others after the save."""
    name = f"best_ckpt_epoch={epoch}_valid_ppl={best_ppl:.4f}"
    path = _save(os.path.join(os.path.abspath(ckpt_dir), name), state, epoch, best_ppl)
    if keep_best is not None:
        _prune_checkpoints(ckpt_dir, keep_best, protect=name)
    return path


def _prune_checkpoints(ckpt_dir: str, keep_best: int, protect: Optional[str] = None) -> None:
    entries = []
    for entry in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(entry)
        if m:
            entries.append((float(m.group(2)), entry))
    entries.sort()  # lowest ppl first
    for _, entry in entries[keep_best:]:
        if entry != protect:  # never delete the checkpoint just written
            shutil.rmtree(os.path.join(ckpt_dir, entry), ignore_errors=True)


def save_preempt_checkpoint(ckpt_dir: str, state: TrainState, epoch: int,
                            best_ppl: float) -> str:
    """Emergency save on SIGTERM under a fixed name (each preemption
    overwrites the last), never matched by the best-PPL pruning or
    ``find_checkpoint``'s scan: resume it with ``ckpt_name="preempt"``.
    ``epoch`` is the last COMPLETED epoch: resume re-runs the interrupted
    one from its start. So a partial gradient accumulation is dropped
    (zero gradients, micro-step 0), as JAX's ``_save_preempt`` drops it:
    its batches come round again."""
    return _save(os.path.join(os.path.abspath(ckpt_dir), PREEMPT_NAME), state, epoch, best_ppl,
                 drop_partial=True)


def clear_preempt_checkpoint(ckpt_dir: str) -> None:
    """Remove a stale preemption checkpoint (on clean completion: resuming
    it later would silently revert the parameters)."""
    path = os.path.join(os.path.abspath(ckpt_dir), PREEMPT_NAME)
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)


def _load(path: str, device) -> Dict[str, Any]:
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location=device,
                      weights_only=True)


def restore_checkpoint(path: str, template_state: TrainState) -> Dict[str, Any]:
    """Restore into ``template_state`` (its parameters' device). Returns
    a dict with 'state', 'epoch', 'best_ppl'."""
    device = next(template_state.params.parameters()).device
    payload = _load(path, device)
    template_state.params.load_state_dict(payload["params"])
    template_state.opt_state.load_state_dict(payload["opt_state"])
    template_state.step = int(payload["step"])
    return {"state": template_state, "epoch": int(payload["epoch"]),
            "best_ppl": float(payload["best_ppl"])}


def restore_params(path: str, template_params) -> Any:
    """Parameters only, onto the template: entries missing from the file
    keep their template values (the reference's ``strict=False`` load).
    ``path`` is a checkpoint directory or a file of a ``state_dict``."""
    device = next(template_params.parameters()).device
    if os.path.isdir(path):
        source = _load(path, device)["params"]
    else:
        source = torch.load(path, map_location=device, weights_only=True)
        source = source.get("params", source)
    own = template_params.state_dict()
    template_params.load_state_dict(
        {k: v.to(own[k].dtype) for k, v in source.items() if k in own}, strict=False)
    return template_params


def find_checkpoint(ckpt_dir: str, name: Optional[str] = None) -> Optional[str]:
    """Resolve a checkpoint path: an explicit name, the sentinel "preempt"
    (the SIGTERM checkpoint), or the best (lowest valid PPL) when name is
    None or "best"."""
    if name == "preempt":
        name = PREEMPT_NAME
    if name == "best":
        name = None
    if name is not None:
        p = os.path.join(ckpt_dir, name)
        return p if os.path.isdir(p) else None
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for entry in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(entry)
        if m:
            ppl = float(m.group(2))
            if best is None or ppl < best[0]:
                best = (ppl, os.path.join(ckpt_dir, entry))
    return best[1] if best else None
