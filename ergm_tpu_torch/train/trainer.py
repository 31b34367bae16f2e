"""Trainer (counterpart of ``ergm_tpu/train/trainer.py``).

Dataset meta -> model config -> parameters (fresh init, a params file,
or the caller's) -> AdamW on the power-2 polynomial warmup schedule
(``adam_mu_dtype``; ``grad_accum_steps`` micro-batches an update) ->
epoch loop with per-epoch validation, best-PPL checkpoints, resume, a
SIGTERM preemption save and TensorBoard scalars with the reference's
tag names. Batches come from one loader per split (``data/loader.py``):
collated in this process, or with ``num_workers > 0`` in worker
processes that start once, serve every epoch (the same batches) and stop
when ``train`` returns. The epoch line reports tok/s, the step p50 and
MFU against the card's dense bf16 peak.

Inside a ``torch.distributed`` world (``parallel/distributed.py``, one
process per device) it trains over the mesh of ``cfg.mesh_shape`` /
``cfg.mesh_axis_names``: each data rank collates and runs its rows of
each global batch, a model axis splits the parameters (Megatron), and
``shard_opt_state`` shards AdamW's moments over the data axis (ZeRO-1).
The step's metrics are the global batch's, so every rank computes the
epoch line a single card would; the primary rank alone prints it,
writes TensorBoard and writes checkpoints (in the single-card format).
Several hosts (``LOCAL_WORLD_SIZE`` ranks each) shard the dataset per
host as JAX does, each host's batch being ``batch_size`` rows.
"""

from __future__ import annotations

import math
import os
import signal
import sys
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ergm_tpu_torch.core.config import ModelConfig, TrainConfig
from ergm_tpu_torch.core.device import resolve
from ergm_tpu_torch.core.mesh import (DATA_AXIS, MODEL_AXIS, make_mesh, shard_opt_state,
                                      shard_params, zero1_sharding_tree)
from ergm_tpu_torch.data.assembly import read_meta
from ergm_tpu_torch.data.dataset import DialogueDataset
from ergm_tpu_torch.data.loader import close, make_loader
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.parallel.distributed import is_primary
from ergm_tpu_torch.train import checkpoint as ckpt_lib
from ergm_tpu_torch.train.schedule import polynomial_warmup_schedule
from ergm_tpu_torch.train.steps import (AdamW, batch_to_device, create_train_state,
                                        make_eval_step, make_train_step)
from ergm_tpu_torch.utils.flops import device_peak_tflops, model_flops_per_token


def _in_world() -> bool:
    return dist.is_available() and dist.is_initialized()


def _quiet(*args, **kwargs) -> None:
    """The print of a rank other than the primary."""


def _summary_writer(logdir: str):
    """tensorboardX's writer where it is installed, else PyTorch's (which
    needs the tensorboard package)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        from torch.utils.tensorboard import SummaryWriter
    return SummaryWriter(logdir)


class Trainer:
    def __init__(self, cfg: TrainConfig, model_config: Optional[ModelConfig] = None,
                 params: Optional[gpt2.GPT2] = None, limit: Optional[int] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve(device)
        self.log = print if is_primary() else _quiet
        self.st = read_meta(cfg.data_dir)
        if model_config is None:
            drops = {k: getattr(cfg, k) for k in ("attn_pdrop", "resid_pdrop", "embd_pdrop")
                     if getattr(cfg, k) is not None}
            if cfg.remat_policy:
                drops["remat_policy"] = cfg.remat_policy
            model_config = ModelConfig.from_model_type(
                cfg.model_type, vocab_size=self.st.vocab_size, dtype=cfg.dtype,
                remat=cfg.remat, **drops)
        self.max_len = min(cfg.max_len, model_config.n_positions)
        self.mcfg = model_config
        self._layout()

        self.log(f"Loading {cfg.train_prefix} & {cfg.valid_prefix} data from {cfg.data_dir}...")
        ds_kw = dict(data_dir=cfg.data_dir, sp1_id=self.st.sp1_id, sp2_id=self.st.sp2_id,
                     eos_id=self.st.eos_id, max_len=self.max_len, limit=limit)
        self.train_set = DialogueDataset(cfg.train_prefix, **ds_kw)
        self.valid_set = DialogueDataset(cfg.valid_prefix, **ds_kw)
        # each host iterates its equal-length shard (dataset.host_shard_order),
        # so the schedule counts per_host // batch_size steps an epoch
        per_host = len(self.train_set) // self.host_count
        if per_host < cfg.batch_size:
            raise ValueError(f"train set has {len(self.train_set)} examples -> {per_host} per "
                             f"host (hosts={self.host_count}) < batch_size {cfg.batch_size}; "
                             f"training drops partial batches, so no step would ever run")
        self.train_loader = self._loader(self.train_set, shuffle=True, drop_remainder=True)
        self.valid_loader = self._loader(self.valid_set, shuffle=False)
        num_batches = max(per_host // cfg.batch_size, 1)
        accum = max(int(cfg.grad_accum_steps or 1), 1)
        # the schedule advances per optimizer update
        self.total_train_steps = max(cfg.num_epochs * num_batches // accum, 1)
        self.warmup_steps = int(cfg.warmup_ratio * self.total_train_steps)
        self.tx = AdamW(polynomial_warmup_schedule(cfg.lr, self.warmup_steps,
                                                   self.total_train_steps, power=2.0),
                        b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                        mu_dtype=getattr(torch, cfg.adam_mu_dtype) if cfg.adam_mu_dtype else None,
                        accumulate=accum)

        if params is None:
            # every rank draws the same init from the seed
            params = gpt2.init_params(torch.Generator().manual_seed(cfg.seed), self.mcfg,
                                      device=self.device)
            if cfg.init_params:
                self.log(f"Initializing params from {cfg.init_params}")
                params = ckpt_lib.restore_params(cfg.init_params, params)
        params = params.to(self.device)
        if self.mesh is not None:
            params = shard_params(params, self.mesh)
        self.state = create_train_state(params, self.tx)
        opt_shardings = None
        if (cfg.shard_opt_state and self.mesh is not None
                and self.mesh.axis_size(DATA_AXIS) > 1):
            # ZeRO-1: each data rank keeps its slice of AdamW's moments
            opt_shardings = zero1_sharding_tree(self.state.params, self.mesh)
            shard_opt_state(self.state.opt_state, self.mesh, opt_shardings)
        self.train_step = make_train_step(self.mcfg, self.tx, device=self.device,
                                          mesh=self.mesh, opt_shardings=opt_shardings)
        self.eval_step = make_eval_step(self.mcfg, mesh=self.mesh)
        self.seed = cfg.seed  # the dropout seed; each step folds in its update count

        self.best_ppl = float(sys.float_info.max)
        self.last_epoch = 0
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
        if cfg.ckpt_name is not None:
            path = ckpt_lib.find_checkpoint(cfg.ckpt_dir, cfg.ckpt_name)
            if path:
                self.log(f"Resuming from checkpoint: {path}")
                restored = ckpt_lib.restore_checkpoint(path, self.state, mesh=self.mesh)
                self.state = restored["state"]
                self.best_ppl = restored["best_ppl"]
                self.last_epoch = restored["epoch"]
            else:
                self.log(f"Cannot find the specified checkpoint under {cfg.ckpt_dir}; "
                         "training starts from scratch.")

        self.writer = None
        if cfg.output_dir and is_primary():
            logdir = os.path.join(cfg.output_dir, "tb")
            try:
                self.writer = _summary_writer(logdir)
            except Exception as e:  # noqa: BLE001 — JAX's message for any failure
                # scalars silently vanishing in a prod run is worse than
                # noise: say exactly what was lost and why
                warnings.warn(
                    f"TensorBoard logging DISABLED ({type(e).__name__}: {e}); "
                    f"Loss/PPL/Accuracy scalars will not be written to "
                    f"{logdir}")

    # -- helpers ---------------------------------------------------------

    def _layout(self) -> None:
        """The mesh of ``cfg.mesh_shape`` over the world (None for a single
        process, after JAX's shape checks), this host's shard of the
        dataset and this rank's rows of each host batch."""
        cfg = self.cfg
        mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
        world = dist.get_world_size() if _in_world() else 1
        if mesh.size != world:
            raise ValueError(f"mesh {mesh.shape} uses {mesh.size} of the world's {world} ranks; "
                             f"every rank must be in the mesh")
        self.mesh = mesh if _in_world() else None
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        self.host_count = max(world // max(local, 1), 1)
        self.host_index = (dist.get_rank() // local) if _in_world() else 0
        dp = mesh.axis_size(DATA_AXIS)
        if dp % self.host_count or local % mesh.axis_size(MODEL_AXIS):
            raise ValueError(f"mesh {mesh.shape} over {self.host_count} hosts of {local} ranks: "
                             f"the data axis must split evenly over the hosts and the model "
                             f"axis stay within one")
        per_host = dp // self.host_count  # data ranks on this host
        if cfg.batch_size % per_host:
            raise ValueError(
                f"batch_size={cfg.batch_size} must be divisible by the mesh data axis "
                f"({per_host} devices a host); pick a divisible batch size or a smaller "
                f"mesh_shape")
        n = cfg.batch_size // per_host
        d = mesh.index(DATA_AXIS) % per_host
        self.rows = (d * n, (d + 1) * n)
        self.dp = dp

    def _scalars(self, split: str, epoch: int, loss: float, ppl: float, acc: float):
        if self.writer is not None:
            self.writer.add_scalar(f"Loss/{split}", loss, epoch)
            self.writer.add_scalar(f"PPL/{split}", ppl, epoch)
            self.writer.add_scalar(f"Accuracy/{split}", acc, epoch)
            self.writer.flush()

    @staticmethod
    def _fetch(metrics_list):
        return [{k: float(v) for k, v in m.items()} for m in metrics_list]

    @staticmethod
    def _epoch_metrics(all_metrics):
        losses = [m["loss"] for m in all_metrics]
        lm = [m["lm_loss"] for m in all_metrics]
        correct = sum(int(m["emotion_correct"]) for m in all_metrics)
        total = sum(int(m["num_examples"]) for m in all_metrics)
        avg_loss = float(np.mean(losses)) if losses else float("nan")
        ppl = math.exp(float(np.mean(lm))) if lm else float("nan")
        if math.isnan(ppl) or math.isinf(ppl):
            ppl = 1e8  # the reference's NaN guard
        acc = 100.0 * correct / max(total, 1)
        return avg_loss, ppl, acc

    @staticmethod
    def _token_weighted_ppl(all_metrics) -> float:
        """exp of the per-TOKEN mean CE (the reference's PPL weights batches
        equally regardless of token count; both are reported)."""
        tok = sum(m.get("lm_tokens", 0.0) for m in all_metrics)
        tot = sum(m.get("lm_loss_sum", 0.0) for m in all_metrics)
        if tok <= 0:
            return float("nan")
        ppl = math.exp(tot / tok)
        return 1e8 if (math.isnan(ppl) or math.isinf(ppl)) else ppl

    @staticmethod
    def _throughput(step_stats, peak_tflops):
        """(tok/s, step-p50 ms, MFU or None) from per-block (seconds,
        tokens, flops, steps) tuples; the slowest block (the first, with
        the kernel build and warm-up) is left out of the rate when more
        than one ran."""
        if not step_stats:
            return float("nan"), float("nan"), None
        stats = sorted(step_stats, key=lambda s: s[0] / max(s[3], 1))
        if len(stats) > 1:
            stats = stats[:-1]
        secs = sum(s[0] for s in stats)
        toks = sum(s[1] for s in stats)
        flops = sum(s[2] for s in stats)
        tok_s = toks / secs if secs > 0 else float("nan")
        mid = stats[len(stats) // 2]
        p50_ms = 1e3 * mid[0] / max(mid[3], 1)
        mfu = (flops / 1e12) / secs / peak_tflops if peak_tflops and secs > 0 else None
        return tok_s, p50_ms, mfu

    def _loader(self, dataset, shuffle: bool, drop_remainder: bool = False):
        """The split's loader for every epoch (the reference's num_workers
        flag); the epoch loop sets ``sampler.seed`` before each epoch."""
        cfg = self.cfg
        return make_loader(dataset, batch_size=cfg.batch_size, eos_id=self.st.eos_id,
                           shuffle=shuffle, seed=cfg.seed, max_len=self.max_len,
                           pad_multiple=cfg.pad_multiple, drop_remainder=drop_remainder,
                           length_grouped=cfg.length_grouped, num_workers=cfg.num_workers,
                           pin_memory=self.device.type == "cuda" and cfg.num_workers > 0,
                           host_index=self.host_index, host_count=self.host_count,
                           rows=None if self.mesh is None else self.rows)

    # -- preemption ------------------------------------------------------

    def _install_preempt_handler(self):
        """The first SIGTERM sets a flag checked at step-block boundaries;
        a second one falls through to the default handler. Returns the
        previous handler, or None when not installed."""
        if not self.cfg.save_on_preempt:
            return None
        if threading.current_thread() is not threading.main_thread():
            return None

        def _on_term(sig, frame):
            if self._preempted:
                signal.signal(sig, signal.SIG_DFL)
                os.kill(os.getpid(), sig)
                return
            self._preempted = True
            print("SIGTERM: will save a preemption checkpoint at the next step-block boundary "
                  "(send again to exit immediately)")

        return signal.signal(signal.SIGTERM, _on_term)

    def _preempt_agreed(self) -> bool:
        """Every rank's agreement on the preempt flag: SIGTERM may reach the
        ranks at different instants and the save is a collective, so all
        enter it in the same step block or none does (one all-reduce a
        block, only when a handler may be installed)."""
        if not self.cfg.save_on_preempt or not _in_world():
            return self._preempted
        flag = torch.tensor([float(self._preempted)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def _save_preempt(self) -> float:
        path = ckpt_lib.save_preempt_checkpoint(self.cfg.ckpt_dir, self.state, self.last_epoch,
                                                self.best_ppl, mesh=self.mesh)
        self.log(f"Preemption checkpoint saved: {path} (resume with --ckpt_name=preempt)")
        return self.best_ppl

    # -- loops -----------------------------------------------------------

    def train(self):
        self._preempted = False
        prev_handler = self._install_preempt_handler()
        try:
            return self._train_loop()
        finally:
            close(self.train_loader)
            close(self.valid_loader)
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _train_loop(self):
        cfg = self.cfg
        self.log("Training starts.")
        start_epoch = self.last_epoch + 1
        world = dist.get_world_size() if _in_world() else 1
        peak = (device_peak_tflops(torch.cuda.get_device_name(self.device))
                if self.device.type == "cuda" else None)
        if peak is not None:
            peak *= world  # MFU over every rank's card
        # launches are asynchronous: wait for the device once per block of
        # steps (on its last metrics) and fetch the epoch's metrics once
        fetch_every = max(int(os.environ.get("ERGM_METRIC_FETCH_EVERY", "8")), 1)
        for epoch in range(start_epoch, start_epoch + cfg.num_epochs):
            t0 = time.time()
            metrics_dev, step_stats = [], []
            bt0 = time.time()
            bn = btok = bflops = 0
            real_tok = padded_tok = 0
            self.train_loader.sampler.seed = cfg.seed + epoch
            for batch in self.train_loader:
                dev_batch = batch_to_device(batch, self.device)
                self.state, metrics = self.train_step(self.state, dev_batch, self.seed)
                metrics_dev.append(metrics)
                b, l = batch.input_ids.shape
                # this rank's rows; the step ran the global batch, over the
                # mesh's data axis (tok/s and MFU count global tokens)
                b *= self.dp if self.mesh is not None else 1
                bn += 1
                btok += b * l
                real_tok += int(batch.attention_mask.sum())
                padded_tok += batch.input_ids.shape[0] * l
                bflops += model_flops_per_token(self.mcfg, l) * b * l
                if bn == fetch_every:
                    float(metrics["loss"])  # waits for the block's steps
                    step_stats.append((time.time() - bt0, btok, bflops, bn))
                    bt0 = time.time()
                    bn = btok = bflops = 0
                    if self._preempt_agreed():
                        return self._save_preempt()
            if bn:
                float(metrics["loss"])
                step_stats.append((time.time() - bt0, btok, bflops, bn))
            train_metrics = self._fetch(metrics_dev)
            loss, ppl, acc = self._epoch_metrics(train_metrics)
            tw_ppl = self._token_weighted_ppl(train_metrics)
            dt = time.time() - t0
            tok_s, p50_ms, mfu = self._throughput(step_stats, peak)
            perf = f"{tok_s:,.0f} tok/s | step p50 {p50_ms:.0f} ms"
            if mfu is not None:
                perf += f" | MFU {100 * mfu:.1f}%"
            if padded_tok:
                perf += f" | pad eff {100 * real_tok / padded_tok:.0f}%"
            self.log(f"Epoch {epoch}: Train Loss: {loss:.4f} | Train PPL: {ppl:.4f} "
                  f"(token-weighted {tw_ppl:.4f}) | Train Emotion Acc: {acc:.2f}% | "
                  f"{dt:.1f}s | {perf}")
            self._scalars("train", epoch, loss, ppl, acc)

            self.last_epoch = epoch
            tv = time.time()
            v_loss, v_ppl, v_acc = self.validation()
            v_dt = time.time() - tv
            if v_ppl < self.best_ppl:
                self.best_ppl = v_ppl
                tc = time.time()
                path = ckpt_lib.save_checkpoint(cfg.ckpt_dir, self.state, epoch, v_ppl,
                                                keep_best=cfg.keep_best, mesh=self.mesh)
                self.log(f"Best checkpoint saved: {path} ({time.time() - tc:.1f}s)")
            self.log(f"Best valid PPL: {self.best_ppl:.4f}")
            self.log(f"Valid Loss: {v_loss:.4f} | Valid PPL: {v_ppl:.4f} "
                  f"(token-weighted {self._last_valid_tw_ppl:.4f}) | "
                  f"Valid Emotion Acc: {v_acc:.2f}% | {v_dt:.1f}s")
            self._scalars("valid", epoch, v_loss, v_ppl, v_acc)
            if self._preempt_agreed():
                return self._save_preempt()
        self.log("Training finished!")
        if cfg.save_on_preempt:
            # a stale emergency checkpoint resumed later would silently
            # revert this run's result
            ckpt_lib.clear_preempt_checkpoint(cfg.ckpt_dir)
        return self.best_ppl

    def validation(self):
        metrics_dev = []
        for batch in self.valid_loader:
            metrics_dev.append(self.eval_step(self.state.params,
                                              batch_to_device(batch, self.device)))
        metrics = self._fetch(metrics_dev)
        self._last_valid_tw_ppl = self._token_weighted_ppl(metrics)
        return self._epoch_metrics(metrics)
