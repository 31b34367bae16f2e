"""Train and eval steps (counterpart of ``ergm_tpu/train/steps.py``).

One step: the forward with labels and without dense logits, the joint
LM + emotion loss with fill rows (``valid`` False) masked out of both
losses and the metrics, the backward, and AdamW with the schedule
applied per update. The metrics stay on the device as a dict of 0-d
tensors; the Trainer fetches them once per block.

Where JAX threads a key and folds in the step, the port takes an integer
seed and folds in the update count (``core/rng.py``): each step's
dropout masks are a function of (seed, step, layer, site).
"""

from __future__ import annotations

from typing import Callable, Dict, Union

import torch

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.device import resolve
from ergm_tpu_torch.core.rng import fold_seed
from ergm_tpu_torch.models import gpt2

Schedule = Union[float, Callable[[int], float]]


class AdamW:
    """The optimizer recipe of JAX's ``optax.adamw(schedule, b1=0.9,
    b2=0.999, eps=1e-8, weight_decay=0.01)``: ``init`` builds a
    ``torch.optim.AdamW`` over the parameters and ``lr(i)`` is the rate
    of update i."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01):
        self.schedule = schedule
        self.kw = dict(betas=(b1, b2), eps=eps, weight_decay=weight_decay)

    def lr(self, update: int) -> float:
        return float(self.schedule(update)) if callable(self.schedule) else float(self.schedule)

    def init(self, params: gpt2.GPT2) -> torch.optim.AdamW:
        return torch.optim.AdamW(params.parameters(), lr=self.lr(0), **self.kw)


class TrainState:
    """Parameters (fp32 master weights), optimizer and update count."""

    def __init__(self, params: gpt2.GPT2, opt_state: torch.optim.Optimizer, step: int = 0):
        self.params, self.opt_state, self.step = params, opt_state, step


def create_train_state(params: gpt2.GPT2, tx: AdamW) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0)


def _losses_and_metrics(params, config: ModelConfig, batch: Dict[str, torch.Tensor],
                        deterministic: bool, seed=None):
    valid = batch["valid"]
    labels = torch.where(valid[:, None], batch["labels"], -100)
    out = gpt2.forward(
        params, config, batch["input_ids"], token_type_ids=batch["token_type_ids"],
        imgs=batch.get("imgs"), auds=batch.get("auds"), caption_ids=batch.get("caption_ids"),
        encoder_attention_mask=batch.get("caption_mask"), labels=labels,
        deterministic=deterministic, dropout_seed=seed,
        # bucket-padded batches: the emotion head reads the last real token
        seq_lengths=batch.get("seq_lengths"),
        # the loss never needs dense [B, L, V] logits
        compute_logits=False)
    lm_loss = out.lm_loss
    emo_logits = out.emotion_logits
    logz = torch.logsumexp(emo_logits, dim=-1)
    gold = emo_logits.gather(-1, batch["emotion_labels"].long()[:, None])[:, 0]
    w = valid.float()
    emo_loss = ((logz - gold) * w).sum() / torch.clamp_min(w.sum(), 1.0)
    loss = lm_loss + emo_loss
    with torch.no_grad():
        preds = emo_logits.argmax(dim=-1)
        # supervised-token count for the token-weighted corpus PPL
        lm_tokens = (labels[:, 1:] != -100).sum().float()
        metrics = {
            "loss": loss.detach(),
            "lm_loss": lm_loss.detach(),
            "lm_loss_sum": lm_loss.detach() * lm_tokens,
            "lm_tokens": lm_tokens,
            "emotion_loss": emo_loss.detach(),
            "emotion_correct": ((preds == batch["emotion_labels"]) & valid).sum(),
            "num_examples": valid.sum(),
        }
    return loss, metrics


def _check_device(params: gpt2.GPT2, device: torch.device) -> None:
    where = next(params.parameters()).device
    if where.type != device.type:
        raise ValueError(f"the parameters are on {where}, the step runs on {device}; move them "
                         f"or pass device={str(where)!r}")


def make_train_step(config: ModelConfig, tx: AdamW, device="cuda"):
    """Returns ``step(state, batch, seed) -> (state, metrics)``, which
    updates ``state`` in place. Runs on the card unless ``device="cpu"``.

    Every parameter without a gradient this step (e.g. the cross-attention
    on a caption-less batch) takes a zero gradient, as in JAX, so AdamW's
    moments and weight decay advance for it too."""
    device = resolve(device)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        _check_device(state.params, device)
        step_seed = fold_seed(seed, state.step)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss, metrics = _losses_and_metrics(state.params, config, batch, deterministic=False,
                                            seed=step_seed)
        loss.backward()
        params = list(state.params.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics["grad_norm"] = torch.nn.utils.get_total_norm([p.grad for p in params])
        lr = tx.lr(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(config: ModelConfig):
    @torch.no_grad()
    def eval_step(params: gpt2.GPT2, batch: Dict[str, torch.Tensor]) -> dict:
        _, metrics = _losses_and_metrics(params, config, batch, deterministic=True)
        return metrics

    return eval_step


def batch_to_device(batch, device="cuda", include_modalities: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """``data.dataset.Batch`` -> a dict of tensors on ``device`` (the card
    unless ``device="cpu"``); integer arrays become int64."""
    device = resolve(device)
    arrays = {
        "input_ids": batch.input_ids,
        "token_type_ids": batch.token_type_ids,
        "labels": batch.labels,
        "emotion_labels": batch.emotion_labels,
        "valid": batch.valid,
        "seq_lengths": batch.attention_mask.sum(axis=-1).astype("int64"),
    }
    if include_modalities:
        arrays["imgs"] = batch.imgs
        arrays["auds"] = batch.auds
    if batch.caption_ids is not None:
        arrays["caption_ids"] = batch.caption_ids
        arrays["caption_mask"] = batch.caption_mask
    out = {}
    for k, v in arrays.items():
        t = torch.as_tensor(v)
        if t.dtype in (torch.int32, torch.int64):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out
