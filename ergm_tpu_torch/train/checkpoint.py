"""Checkpoint save and restore with ``torch.save`` (counterpart of
``ergm_tpu/train/checkpoint.py``, which uses orbax).

Best-valid-PPL checkpoints keep the reference's names,
``best_ckpt_epoch={E}_valid_ppl={P:.4f}``: a directory holding
``state.pt`` with the parameters, the optimizer state (with a gradient
accumulation in progress), the step count, the epoch and the best PPL.
A save writes a temporary file and renames it, so a crash never leaves
half a checkpoint behind.

Over a mesh (``mesh=``) every rank takes part in a save (the collectives
that gather the model axis's shards and ZeRO-1's moment slices into the
single-card format) and only the primary rank writes; a restore reads
the single-card file on every rank and keeps each rank's part. So a
checkpoint saved over a mesh resumes on one card, and the other way
round.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ergm_tpu_torch.core.mesh import gather_model, split_model
from ergm_tpu_torch.parallel.distributed import is_primary
from ergm_tpu_torch.train.steps import TrainState

_CKPT_RE = re.compile(r"best_ckpt_epoch=(\d+)_valid_ppl=([\d.eE+-]+?)/?$")
STATE_FILE = "state.pt"
PREEMPT_NAME = "preempt_ckpt"


def _gathered(state: TrainState, drop_partial: bool, mesh) -> tuple:
    """(params, opt_state) state dicts in the single-card format: the
    model axis's shards and ZeRO-1's moment slices gathered (collectives:
    every rank of the mesh calls this)."""
    params = state.params.state_dict()
    opt = state.opt_state.state_dict(drop_partial=drop_partial)
    if mesh is None:
        return params, opt
    cfg = state.params.config
    names = [n for n, _ in state.params.named_parameters()]
    params = {n: gather_model(n, t, cfg, mesh) for n, t in params.items()}
    zero = state.opt_state.zero
    for i, name in enumerate(names):
        entry = opt["state"][i]
        for key in ("exp_avg", "exp_avg_sq"):
            part = entry[key] if zero is None else zero.whole(entry[key], zero.dims[i])
            entry[key] = gather_model(name, part, cfg, mesh)
        if "acc_grad" in entry:
            entry["acc_grad"] = gather_model(name, entry["acc_grad"], cfg, mesh)
    return params, opt


def _save(path: str, state: TrainState, epoch: int, best_ppl: float,
          drop_partial: bool = False, mesh=None) -> str:
    params, opt = _gathered(state, drop_partial, mesh)
    if is_primary():
        os.makedirs(path, exist_ok=True)
        payload = {
            "params": params,
            "opt_state": opt,
            "step": int(state.step),
            "epoch": int(epoch),
            "best_ppl": float(best_ppl),
        }
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
    if dist.is_available() and dist.is_initialized():
        dist.barrier()  # the file is there before any rank reads it
    return path


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int, best_ppl: float,
                    keep_best: Optional[int] = None, mesh=None) -> str:
    """Save a best-PPL checkpoint. ``keep_best``: retain only the N
    lowest-PPL checkpoints, deleting the others after the save."""
    name = f"best_ckpt_epoch={epoch}_valid_ppl={best_ppl:.4f}"
    path = _save(os.path.join(os.path.abspath(ckpt_dir), name), state, epoch, best_ppl,
                 mesh=mesh)
    if keep_best is not None and is_primary():
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
                            best_ppl: float, mesh=None) -> str:
    """Emergency save on SIGTERM under a fixed name (each preemption
    overwrites the last), never matched by the best-PPL pruning or
    ``find_checkpoint``'s scan: resume it with ``ckpt_name="preempt"``.
    ``epoch`` is the last COMPLETED epoch: resume re-runs the interrupted
    one from its start. So a partial gradient accumulation is dropped
    (zero gradients, micro-step 0), as JAX's ``_save_preempt`` drops it:
    its batches come round again."""
    return _save(os.path.join(os.path.abspath(ckpt_dir), PREEMPT_NAME), state, epoch, best_ppl,
                 drop_partial=True, mesh=mesh)


def clear_preempt_checkpoint(ckpt_dir: str) -> None:
    """Remove a stale preemption checkpoint (on clean completion: resuming
    it later would silently revert the parameters)."""
    path = os.path.join(os.path.abspath(ckpt_dir), PREEMPT_NAME)
    if os.path.isdir(path) and is_primary():
        shutil.rmtree(path, ignore_errors=True)


def _load(path: str, device) -> Dict[str, Any]:
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location=device,
                      weights_only=True)


def _split(payload: Dict[str, Any], state: TrainState, mesh) -> None:
    """The single-card payload cut IN PLACE to this rank's parts."""
    cfg = state.params.config
    payload["params"] = {n: split_model(n, t, cfg, mesh) for n, t in payload["params"].items()}
    zero = state.opt_state.zero
    names = [n for n, _ in state.params.named_parameters()]
    for i, name in enumerate(names):
        entry = payload["opt_state"]["state"][i]
        for key in ("exp_avg", "exp_avg_sq"):
            part = split_model(name, entry[key], cfg, mesh)
            entry[key] = part if zero is None else zero.local_of(part, i)
        if "acc_grad" in entry:
            entry["acc_grad"] = split_model(name, entry["acc_grad"], cfg, mesh)


def restore_checkpoint(path: str, template_state: TrainState, mesh=None) -> Dict[str, Any]:
    """Restore into ``template_state`` (its parameters' device; over a
    ``mesh`` its shards). Returns a dict with 'state', 'epoch', 'best_ppl'."""
    device = next(template_state.params.parameters()).device
    payload = _load(path, device)
    if mesh is not None:
        _split(payload, template_state, mesh)
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
