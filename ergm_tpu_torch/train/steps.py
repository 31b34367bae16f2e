"""Train and eval steps (counterpart of ``ergm_tpu/train/steps.py``).

One step: the forward with labels and without dense logits, the joint
LM + emotion loss with fill rows (``valid`` False) masked out of both
losses and the metrics, the backward, and AdamW with the schedule
applied per update (optionally over accumulated micro-batches). The
metrics stay on the device as a dict of 0-d tensors; the Trainer fetches
them once per block.

Where JAX threads a key and folds in the step, the port takes an integer
seed and folds in the step count (``core/rng.py``), which counts
micro-batches under accumulation as JAX's ``state.step`` does: each
step's dropout masks are a function of (seed, step, layer, site).

Over a mesh (``core/mesh.py``) each rank runs its rows of the global
batch (and its tensor-parallel shard, ``models/gpt2.py``). The losses
are means over the global batch whose gradients are each rank's part
(``parallel.collectives.global_mean``), so the gradients are SUMMED over
the data axis, once per update (after the accumulation, not per
micro-batch), and the update equals one device's over the global batch.
ZeRO-1 (``opt_shardings``) keeps each data rank's slice of the moments
and all-gathers the updated parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.device import resolve
from ergm_tpu_torch.core.mesh import (DATA_AXIS, MODEL_AXIS, Zero1, batch_rows,
                                      param_partition_spec)
from ergm_tpu_torch.core.rng import fold_seed
from ergm_tpu_torch.models import gpt2

Schedule = Union[float, Callable[[int], float]]


class AdamWState:
    """What the optimizer carries between steps: per parameter the first
    moment ``mu`` (in ``mu_dtype``) and the second moment ``nu`` (fp32),
    the update count, and under gradient accumulation the running mean of
    the micro-batch gradients ``acc`` with the micro-step ``mini_step``
    (optax's ``MultiStepsState``). ``state_dict`` keeps
    ``torch.optim.AdamW``'s layout (``exp_avg``, ``exp_avg_sq``, ``step``
    per parameter) and adds ``acc_grad`` and ``mini_step``. Under ZeRO-1
    (``core.mesh.shard_opt_state``) ``mu`` and ``nu`` hold this data
    rank's slices and ``zero`` says where they lie."""

    def __init__(self, params: List[torch.Tensor], mu_dtype: Optional[torch.dtype],
                 accumulate: bool):
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.acc = [torch.zeros_like(p) for p in params] if accumulate else None
        self.mini_step = 0
        self.zero: Optional[Zero1] = None

    def state_dict(self, drop_partial: bool = False) -> dict:
        """``drop_partial``: as if the accumulation had just been applied
        (zero ``acc``, micro-step 0), as JAX's preemption save writes it."""
        state = {}
        for i, (mu, nu) in enumerate(zip(self.mu, self.nu)):
            state[i] = {"step": torch.tensor(float(self.count)), "exp_avg": mu, "exp_avg_sq": nu}
            if self.acc is not None:
                state[i]["acc_grad"] = (torch.zeros_like(self.acc[i]) if drop_partial
                                        else self.acc[i])
        return {"state": state, "mini_step": 0 if drop_partial else self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copies into this state's tensors, which keep their dtypes and device."""
        state = sd["state"]
        for i, (mu, nu) in enumerate(zip(self.mu, self.nu)):
            mu.copy_(state[i]["exp_avg"])
            nu.copy_(state[i]["exp_avg_sq"])
            if self.acc is not None:
                self.acc[i].copy_(state[i]["acc_grad"])
        self.count = int(state[0]["step"]) if state else 0
        self.mini_step = int(sd.get("mini_step", 0))


class AdamW:
    """JAX's optimizer, ``optax.adamw(schedule, b1, b2, eps, weight_decay,
    mu_dtype=mu_dtype)``, wrapped in ``optax.MultiSteps(every_k_schedule=
    accumulate)`` when ``accumulate > 1``; ``lr(i)`` is the rate of update i.

    The update follows optax's arithmetic in in-place ``torch._foreach_*``
    operations (one parameter-sized fp32 list of scratch, two with
    ``mu_dtype``): mu and nu in fp32, bias-corrected, ``mu_hat /
    (sqrt(nu_hat) + eps)``, plus ``weight_decay * param`` (decoupled),
    times ``-lr``; the decay is applied as ``param * (1 - lr *
    weight_decay)`` before the Adam step, as ``torch.optim.AdamW`` does.
    With ``mu_dtype`` (bfloat16), mu is stored in that dtype: the new mu is
    computed in fp32 from the stored one, the update uses that fp32 value,
    and only the stored copy is rounded. ``b1 * mu`` is taken in mu's dtype
    with ``b1`` rounded to it, as JAX's weakly typed scalar gives it.

    Accumulation: each micro-batch's gradients join a running mean; the
    parameters and moments change only on every ``accumulate``-th
    micro-batch, and ``lr`` is indexed by the update count."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 mu_dtype: Optional[torch.dtype] = None, accumulate: int = 1):
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mu_dtype = mu_dtype
        self.accumulate = max(int(accumulate), 1)

    def lr(self, update: int) -> float:
        return float(self.schedule(update)) if callable(self.schedule) else float(self.schedule)

    def init(self, params: gpt2.GPT2) -> AdamWState:
        return AdamWState(list(params.parameters()), self.mu_dtype, self.accumulate > 1)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamWState, reduce=None) -> None:
        """Applies one micro-batch's gradients to ``params`` and ``state`` in
        place. ``reduce`` (a mesh's): called on the gradients an update is
        about to apply (after the accumulation), in place. Under ZeRO-1
        the update runs on this rank's slices, then gathers the params."""
        if state.acc is not None:
            n = state.mini_step
            # Welford's running mean, as MultiSteps(use_grad_mean=True)
            delta = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(state.acc, delta)
            del delta
            state.mini_step = (n + 1) % self.accumulate
            if state.mini_step:
                return
            grads = state.acc
        if reduce is not None:
            reduce(grads)
        whole = params
        if state.zero is not None:
            params, grads = state.zero.local(params), state.zero.local(grads)
        b1, b2 = self.b1, self.b2
        lr, count = self.lr(state.count), state.count + 1
        # the moments in place: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2
        if self.mu_dtype is not None:
            torch._foreach_mul_(state.mu, float(torch.tensor(b1, dtype=self.mu_dtype)))
            mu = [m.float() for m in state.mu]
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_copy_(state.mu, mu)  # only the stored copy is rounded
        else:
            mu = state.mu
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        bc1 = float(1.0 - np.float32(b1) ** np.float32(count))
        bc2 = float(1.0 - np.float32(b2) ** np.float32(count))
        # p - lr (mu_hat / (sqrt(nu_hat) + eps) + wd p), as p (1 - lr wd) - lr / bc1 mu / denom
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_mul_(params, 1.0 - lr * self.weight_decay)
        torch._foreach_addcdiv_(params, mu, denom, value=-lr / bc1)
        state.count = count
        if state.zero is not None:
            state.zero.gather(whole)
        if state.acc is not None:
            torch._foreach_zero_(state.acc)


class TrainState:
    """Parameters (fp32 master weights), optimizer state and micro-step count."""

    def __init__(self, params: gpt2.GPT2, opt_state: AdamWState, step: int = 0):
        self.params, self.opt_state, self.step = params, opt_state, step


def create_train_state(params: gpt2.GPT2, tx: AdamW) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0)


def _losses_and_metrics(params, config: ModelConfig, batch: Dict[str, torch.Tensor],
                        deterministic: bool, seed=None, mesh=None):
    """The joint loss and the step's metrics. Over a mesh ``batch`` is this
    rank's rows, the losses are global means (their gradients this rank's
    part) and the metrics are the global batch's."""
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
        compute_logits=False, mesh=mesh)
    lm_loss = out.lm_loss
    emo_logits = out.emotion_logits
    logz = torch.logsumexp(emo_logits, dim=-1)
    gold = emo_logits.gather(-1, batch["emotion_labels"].long()[:, None])[:, 0]
    w = valid.float()
    s_emo = ((logz - gold) * w).sum()
    with torch.no_grad():
        preds = emo_logits.argmax(dim=-1)
        # supervised-token count for the token-weighted corpus PPL
        lm_tokens = (labels[:, 1:] != -100).sum().float()
        correct = ((preds == batch["emotion_labels"]) & valid).sum()
        n_valid = valid.sum()
        if mesh is not None:
            # one all-reduce for the emotion loss's sum and every count
            sums = torch.stack([s_emo.detach().float(), w.sum(), correct.float(), lm_tokens])
            if mesh.group(DATA_AXIS) is not None:
                dist.all_reduce(sums, group=mesh.group(DATA_AXIS))
            s_all, n_valid, correct, lm_tokens = sums.unbind()
    if mesh is None:
        emo_loss = s_emo / torch.clamp_min(w.sum(), 1.0)
    else:  # the global mean; its gradient this rank's part (global_mean's rule)
        denom = torch.clamp_min(n_valid, 1.0)
        emo_loss = s_all / denom + (s_emo - s_emo.detach()) / denom
    loss = lm_loss + emo_loss
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "lm_loss": lm_loss.detach(),
            "lm_loss_sum": lm_loss.detach() * lm_tokens,
            "lm_tokens": lm_tokens,
            "emotion_loss": emo_loss.detach(),
            "emotion_correct": correct,
            "num_examples": n_valid,
        }
    return loss, metrics


def _check_device(params: gpt2.GPT2, device: torch.device) -> None:
    where = next(params.parameters()).device
    if where.type != device.type:
        raise ValueError(f"the parameters are on {where}, the step runs on {device}; move them "
                         f"or pass device={str(where)!r}")


_BUCKET_BYTES = 64 << 20


def all_reduce_(tensors: List[torch.Tensor], group) -> None:
    """Sums each tensor over ``group`` IN PLACE, in flat buckets of about
    64 MB (one dtype each)."""
    bucket, size = [], 0

    def flush():
        if bucket:
            flat = torch._utils._flatten_dense_tensors(bucket)
            dist.all_reduce(flat, group=group)
            for t, f in zip(bucket, torch._utils._unflatten_dense_tensors(flat, bucket)):
                t.copy_(f)
            bucket.clear()

    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or size + t.nbytes > _BUCKET_BYTES):
            flush()
            size = 0
        bucket.append(t)
        size += t.nbytes
    flush()


def global_norm(grads: List[torch.Tensor], sharded: List[bool], model_group) -> torch.Tensor:
    """The norm of the whole gradient: the model-split parts' squares summed
    over the model axis, the replicated ones counted once."""
    sq = torch.stack([n.float() ** 2 for n in torch._foreach_norm(grads)])
    mask = torch.tensor(sharded, device=sq.device)
    split = (sq * mask).sum()
    if model_group is not None:
        dist.all_reduce(split, group=model_group)
    return torch.sqrt(split + (sq * ~mask).sum())


def make_train_step(config: ModelConfig, tx: AdamW, device="cuda", mesh=None,
                    opt_shardings=None):
    """Returns ``step(state, batch, seed) -> (state, metrics)``, which
    updates ``state`` in place. Runs on the card unless ``device="cpu"``.

    Every parameter without a gradient this step (e.g. the cross-attention
    on a caption-less batch) takes a zero gradient, as in JAX, so AdamW's
    moments and weight decay advance for it too.

    ``mesh``: ``batch`` is this rank's rows of the global batch (and
    ``state.params`` its shard); the gradients are summed over the data
    axis once per update and ``grad_norm`` is the norm of the whole
    gradient an update applies (NaN on the micro-batches of an
    accumulation that apply none). ``opt_shardings``: the ZeRO-1 dims
    (``core.mesh.zero1_sharding_tree``) that ``state.opt_state`` was
    sharded with (``core.mesh.shard_opt_state``)."""
    device = resolve(device)
    data_group = None if mesh is None else mesh.group(DATA_AXIS)
    model_group = None if mesh is None or mesh.axis_size(MODEL_AXIS) <= 1 \
        else mesh.group(MODEL_AXIS)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        _check_device(state.params, device)
        if opt_shardings is not None and (state.opt_state.zero is None
                                          or state.opt_state.zero.dims != list(opt_shardings)):
            raise ValueError("opt_shardings given, but the optimizer state is not sharded with "
                             "them (core.mesh.shard_opt_state)")
        step_seed = fold_seed(seed, state.step)
        named = list(state.params.named_parameters())
        params = [p for _, p in named]
        for p in params:
            p.grad = None
        loss, metrics = _losses_and_metrics(state.params, config, batch, deterministic=False,
                                            seed=step_seed, mesh=mesh)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if mesh is None:
            metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
            tx.update(params, grads, state.opt_state)
        else:
            sharded = [model_group is not None and MODEL_AXIS in param_partition_spec(n)
                       for n, _ in named]
            metrics["grad_norm"] = torch.full((), float("nan"), device=device)

            def reduce(gs):
                if data_group is not None:
                    all_reduce_(gs, data_group)
                metrics["grad_norm"] = global_norm(gs, sharded, model_group)

            tx.update(params, grads, state.opt_state, reduce=reduce)
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(config: ModelConfig, mesh=None):
    """``eval(params, batch) -> metrics``; over a ``mesh`` ``batch`` is this
    rank's rows and the metrics are the global batch's."""
    @torch.no_grad()
    def eval_step(params: gpt2.GPT2, batch: Dict[str, torch.Tensor]) -> dict:
        _, metrics = _losses_and_metrics(params, config, batch, deterministic=True, mesh=mesh)
        return metrics

    return eval_step


def batch_to_device(batch, device="cuda", mesh=None, include_modalities: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """``data.dataset.Batch`` -> a dict of tensors on ``device`` (the card
    unless ``device="cpu"``); integer arrays become int64. With a ``mesh``
    ``batch`` is the global batch and this rank takes its rows
    (``core.mesh.batch_rows``)."""
    device = resolve(device)
    lo, hi = batch_rows(len(batch.valid), mesh)
    arrays = {
        "input_ids": batch.input_ids,
        "token_type_ids": batch.token_type_ids,
        "labels": batch.labels,
        "emotion_labels": batch.emotion_labels,
        "valid": batch.valid,
        "seq_lengths": torch.as_tensor(batch.attention_mask).sum(-1).long(),
    }
    if include_modalities:
        arrays["imgs"] = batch.imgs
        arrays["auds"] = batch.auds
    if batch.caption_ids is not None:
        arrays["caption_ids"] = batch.caption_ids
        arrays["caption_mask"] = batch.caption_mask
    out = {}
    for k, v in arrays.items():
        # a pinned batch (data/loader.py) copies asynchronously; the cast
        # to int64 runs after the copy
        t = torch.as_tensor(v)[lo:hi].to(device, non_blocking=True)
        if t.dtype in (torch.int32, torch.int64):
            t = t.long()
        out[k] = t
    return out
