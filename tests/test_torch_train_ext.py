"""The training options the CLI reaches, in the port against ergm_tpu and
optax on the CPU: AdamW with a bfloat16 first moment, gradient
accumulation with ``optax.MultiSteps`` semantics, remat "dots", the
preemption save under accumulation, and TensorBoard's absence.

Bars: the optimizer on the same gradients against optax over 8 updates
1e-6 (``mu_dtype``) and over 4 accumulated micro-steps 1e-5; the default
path against ``torch.optim.AdamW`` 1e-7; a model's train steps under
accumulation against JAX's within PARITY.md's 2e-3.
"""
import os
import signal

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ergm_tpu.train import steps as jsteps
from ergm_tpu.train.schedule import polynomial_warmup_schedule as jax_schedule
from ergm_tpu_torch.core.config import ModelConfig, TrainConfig
from ergm_tpu_torch.data.dataset import batches
from ergm_tpu_torch.data.synthetic import write_synthetic_dataset
from ergm_tpu_torch.models.convert import params_from_numpy
from ergm_tpu_torch.train import steps as tsteps
from ergm_tpu_torch.train import trainer as trainer_mod
from ergm_tpu_torch.train.schedule import polynomial_warmup_schedule
from ergm_tpu_torch.train.trainer import Trainer

from test_torch_train import TINY, _batch, _init, _jax_batch, _torch_batch

torch.set_num_threads(1)

SHAPES = {"a": (64, 32), "b": (32,), "c": (5, 7, 3)}


def _opt_inputs(steps, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 0.02, s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(0, 1, s) * rng.uniform(1e-3, 1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _optax_run(tx, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    trace = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, upd)
        trace.append({k: np.asarray(v) for k, v in p.items()})
    return trace


def _port_run(tx, params, grads):
    ps = [torch.tensor(v) for v in params.values()]
    state = tsteps.AdamWState(ps, tx.mu_dtype, tx.accumulate > 1)
    trace = []
    for g in grads:
        tx.update(ps, [torch.tensor(v) for v in g.values()], state)
        trace.append({k: p.numpy().copy() for k, p in zip(params, ps)})
    return trace, state


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adamw_matches_optax(mu_dtype):
    """8 updates on the same gradients and warmup schedule: parameters
    within 1e-6 of optax.adamw(mu_dtype=...); mu stored in its dtype, nu
    in fp32."""
    params, grads = _opt_inputs(8)
    want = _optax_run(optax.adamw(jax_schedule(1e-3, 2, 8), b1=0.9, b2=0.999, eps=1e-8,
                                  weight_decay=0.01,
                                  mu_dtype=getattr(jnp, mu_dtype) if mu_dtype else None),
                      params, grads)
    tx = tsteps.AdamW(polynomial_warmup_schedule(1e-3, 2, 8),
                      mu_dtype=getattr(torch, mu_dtype) if mu_dtype else None)
    got, state = _port_run(tx, params, grads)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0, err_msg=f"{step} {k}")
    assert state.count == 8
    assert {m.dtype for m in state.mu} == {getattr(torch, mu_dtype or "float32")}
    assert {n.dtype for n in state.nu} == {torch.float32}


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_accumulation_matches_multisteps(mu_dtype):
    """k=2 over 4 micro-steps against optax.MultiSteps: within 1e-5; the
    parameters change only on every second micro-step."""
    params, grads = _opt_inputs(4, seed=1)
    inner = optax.adamw(jax_schedule(1e-3, 1, 2), b1=0.9, b2=0.999, eps=1e-8,
                        weight_decay=0.01, mu_dtype=getattr(jnp, mu_dtype) if mu_dtype else None)
    want = _optax_run(optax.MultiSteps(inner, every_k_schedule=2), params, grads)
    tx = tsteps.AdamW(polynomial_warmup_schedule(1e-3, 1, 2), accumulate=2,
                      mu_dtype=getattr(torch, mu_dtype) if mu_dtype else None)
    got, state = _port_run(tx, params, grads)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=0, err_msg=f"{step} {k}")
    for k in SHAPES:
        np.testing.assert_array_equal(got[0][k], params[k])  # no update yet
        np.testing.assert_array_equal(got[2][k], got[1][k])
        assert not np.array_equal(got[3][k], got[2][k])
    assert (state.count, state.mini_step) == (2, 0)


def test_default_path_equals_torch_adamw():
    """mu_dtype=None, no accumulation: torch.optim.AdamW's parameters
    within 1e-7 after 8 updates on the same schedule."""
    params, grads = _opt_inputs(8, seed=2)
    sched = polynomial_warmup_schedule(1e-3, 2, 8)
    got, _ = _port_run(tsteps.AdamW(sched), params, grads)
    ps = [torch.tensor(v) for v in params.values()]
    opt = torch.optim.AdamW(ps, lr=sched(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    for i, g in enumerate(grads):
        for p, gv in zip(ps, g.values()):
            p.grad = torch.tensor(gv)
        opt.param_groups[0]["lr"] = sched(i)
        opt.step()
    for k, p in zip(SHAPES, ps):
        np.testing.assert_allclose(got[-1][k], p.detach().numpy(), atol=1e-7, rtol=0, err_msg=k)


def test_train_steps_accumulate_as_jax():
    """4 micro-batches at k=2 through make_train_step against JAX's with
    optax.MultiSteps: losses and each micro-batch's own gradient norm per
    step within 2e-3, the parameters after within 2e-3; the warmup's first
    update runs at lr(0) = 0 in both (the schedule counts updates), and
    the step counts micro-batches."""
    kw = TINY
    tree = _init(kw, seed=4)
    rng = np.random.default_rng(4)
    batches = [_batch(rng, 4, 32, 8) for _ in range(4)]
    tx = optax.MultiSteps(optax.adamw(jax_schedule(5e-3, 1, 2), b1=0.9, b2=0.999, eps=1e-8,
                                      weight_decay=0.01), every_k_schedule=2)
    from ergm_tpu.core.config import ModelConfig as JaxModelConfig

    state = jsteps.create_train_state(jax.tree_util.tree_map(jnp.asarray, tree), tx)
    jstep = jsteps.make_train_step(JaxModelConfig(**kw), tx)
    jl, jn = [], []
    for b in batches:
        state, m = jstep(state, _jax_batch(b), jax.random.PRNGKey(0))
        jl.append(float(m["loss"]))
        jn.append(float(m["grad_norm"]))

    cfg = ModelConfig(**kw)
    ttx = tsteps.AdamW(polynomial_warmup_schedule(5e-3, 1, 2), accumulate=2)
    tstate = tsteps.create_train_state(params_from_numpy(tree, cfg, device="cpu"), ttx)
    tstep = tsteps.make_train_step(cfg, ttx, device="cpu")
    first = {n: p.detach().clone() for n, p in tstate.params.named_parameters()}
    tl, tn = [], []
    for i, b in enumerate(batches):
        tstate, m = tstep(tstate, _torch_batch(b), 0)
        tl.append(float(m["loss"]))
        tn.append(float(m["grad_norm"]))
        if i == 1:  # update 0 at lr 0: nothing moved
            for n, p in tstate.params.named_parameters():
                assert torch.equal(p, first[n]), n
    np.testing.assert_allclose(tl, jl, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(tn, jn, atol=2e-3, rtol=2e-3)
    assert (tstate.step, tstate.opt_state.count, tstate.opt_state.mini_step) == (4, 2, 0)
    from test_torch_train import _jax_grads_by_name

    want = _jax_grads_by_name(state.params, kw["n_layer"])
    for n, p in tstate.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=2e-3, rtol=0, err_msg=n)


def test_dots_keeps_the_weight_products():
    """Under remat "dots" the backward's recompute runs no weight product
    (aten.addmm) again; "full" runs every one twice. Gradients equal
    no-remat's (tests/test_torch_train.py holds them at 1e-6 with dropout)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func is torch.ops.aten.addmm.default
            return func(*args, **(kwargs or {}))

    tree = _init(TINY, seed=5)
    b = _torch_batch(_batch(np.random.default_rng(5), 2, 128, 8))
    counts = {}
    for policy in ("none", "dots", "full"):
        cfg = ModelConfig(**TINY, remat=policy != "none",
                          remat_policy="full" if policy == "none" else policy)
        params = params_from_numpy(tree, cfg, device="cpu")
        with Count() as c:
            loss, _ = tsteps._losses_and_metrics(params, cfg, b, deterministic=False, seed=3)
            loss.backward()
        counts[policy] = c.n
    assert counts["dots"] == counts["none"] < counts["full"], counts


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    write_synthetic_dataset(str(d), prefixes=("train", "valid"), num_dialogues=5,
                            turns_per_dialogue=4, base_vocab_size=128)
    return str(d)


def _trainer(data_dir, tmp_path, **over):
    from ergm_tpu_torch.data.assembly import read_meta

    cfg = TrainConfig(data_dir=data_dir, ckpt_dir=os.path.join(str(tmp_path), "ckpt"),
                      output_dir="", batch_size=4, num_epochs=1, lr=1e-3, max_len=64,
                      seed=0, dtype="float32", warmup_ratio=0.1, grad_accum_steps=2)
    vocab = read_meta(data_dir).vocab_size
    mcfg = ModelConfig(vocab_size=vocab, n_positions=64, n_embd=32, n_layer=2, n_head=4,
                       use_cross_attention=False, dtype="float32")
    return Trainer(cfg.replace(**over), model_config=mcfg, device="cpu")


def test_preempt_save_drops_a_partial_accumulation(data_dir, tmp_path, monkeypatch):
    """SIGTERM after one micro-batch: the preemption checkpoint holds zero
    accumulated gradients and micro-step 0, and resumes so."""
    monkeypatch.setenv("ERGM_METRIC_FETCH_EVERY", "1")
    tr = _trainer(data_dir, tmp_path)
    orig = Trainer._install_preempt_handler

    def install_then_sigterm(self):
        prev = orig(self)
        assert prev is not None  # installed: the main thread
        os.kill(os.getpid(), signal.SIGTERM)
        return prev

    monkeypatch.setattr(Trainer, "_install_preempt_handler", install_then_sigterm)
    tr.train()
    assert tr.state.step == 1 and tr.state.opt_state.mini_step == 1
    assert any(float(a.abs().max()) > 0 for a in tr.state.opt_state.acc)
    monkeypatch.setattr(Trainer, "_install_preempt_handler", orig)
    tr2 = _trainer(data_dir, tmp_path, ckpt_name="preempt")
    assert tr2.state.step == 1 and tr2.last_epoch == 0
    assert tr2.state.opt_state.mini_step == 0
    assert all(float(a.abs().max()) == 0 for a in tr2.state.opt_state.acc)


def test_epoch_checkpoint_keeps_the_accumulation(data_dir, tmp_path):
    """An epoch of an odd number of micro-batches ends mid-accumulation:
    the best-PPL checkpoint carries the accumulated gradients and the
    micro-step, and a resume restores them. The schedule's horizon
    counts updates."""
    tr = _trainer(data_dir, tmp_path)
    n = len(tr.train_set) // 4
    assert n % 2 == 1 and tr.total_train_steps == n // 2
    tr.train()
    opt = tr.state.opt_state
    assert (tr.state.step, opt.count, opt.mini_step) == (n, n // 2, 1)
    tr2 = _trainer(data_dir, tmp_path, ckpt_name="best")
    opt2 = tr2.state.opt_state
    assert (tr2.state.step, opt2.count, opt2.mini_step) == (n, n // 2, 1)
    for a, b in zip(opt.acc, opt2.acc):
        assert torch.equal(a, b)
    for a, b in zip(opt.mu, opt2.mu):
        assert torch.equal(a, b)


def test_mu_dtype_and_workers_reach_the_trainer(data_dir, tmp_path):
    """adam_mu_dtype and num_workers are taken, not refused: the first
    moment is stored in bfloat16 and the worker loader gives the plain
    iterator's batches."""
    tr = _trainer(data_dir, tmp_path, adam_mu_dtype="bfloat16", num_workers=2,
                  grad_accum_steps=1)
    assert {m.dtype for m in tr.state.opt_state.mu} == {torch.bfloat16}
    tr.train_loader.sampler.seed = 3
    got = list(tr.train_loader)
    want = list(batches(tr.train_set, 4, tr.st.eos_id, shuffle=True, seed=3,
                        max_len=tr.max_len, drop_remainder=True))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.input_ids, b.input_ids)


def test_tensorboard_absent_warns_as_jax(data_dir, tmp_path, monkeypatch):
    """Without tensorboardX or tensorboard (the card's machine): JAX's
    warning, and training goes on."""
    def missing(logdir):
        raise ImportError("No module named 'tensorboardX'")

    monkeypatch.setattr(trainer_mod, "_summary_writer", missing)
    with pytest.warns(UserWarning, match=r"TensorBoard logging DISABLED \(ImportError: No "
                                         r"module named 'tensorboardX'\); Loss/PPL/Accuracy "
                                         r"scalars will not be written to "):
        tr = _trainer(data_dir, tmp_path, output_dir=str(tmp_path / "out"))
    assert tr.writer is None
