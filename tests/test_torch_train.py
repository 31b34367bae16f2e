"""Port parity of the training slice: ergm_tpu_torch's config, schedule,
loss, gradients, train step and Trainer against ergm_tpu's, on the same
seeded numpy inputs and the same JAX init (carried over with
``params_from_numpy``), fp32 on the CPU. JAX's Pallas kernels run in
interpret mode, the port's kernels as their plain versions.

Bars: joint loss 1e-5 and every parameter's gradient 1e-4 for one
forward and backward; 8 optimizer steps track within 2e-3 per step and
the logits after them within 5e-3 (PARITY.md's recipe bars); an epoch's
train loss within 2e-3.
"""
import dataclasses
import math
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ergm_tpu.core.config import ModelConfig as JaxModelConfig
from ergm_tpu.core.config import TrainConfig as JaxTrainConfig
from ergm_tpu.data.synthetic import write_synthetic_dataset
from ergm_tpu.models import gpt2 as jg
from ergm_tpu.train import steps as jsteps
from ergm_tpu.train.schedule import polynomial_warmup_schedule as jax_schedule
from ergm_tpu_torch.core.config import ModelConfig, TrainConfig
from ergm_tpu_torch.data.dataset import collate
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.models.convert import params_from_numpy
from ergm_tpu_torch.train import checkpoint as ckpt
from ergm_tpu_torch.train import steps as tsteps
from ergm_tpu_torch.train.schedule import polynomial_warmup_schedule
from ergm_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

# tri-modal: image/audio projections (modality_dim != n_embd) and captions
TINY = dict(n_layer=2, n_embd=64, n_head=2, vocab_size=256, n_positions=128, modality_dim=768,
            dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)


def _init(kw, seed=0):
    """A perturbed JAX init as a numpy tree (biases and LayerNorm scales
    not trivial)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jg.init_params(jax.random.PRNGKey(seed), JaxModelConfig(**kw)))


def _batch(rng, B, L, Lc, vocab=256):
    ids = rng.integers(0, vocab, (B, L))
    labels = ids.copy()
    labels[:, :L // 4] = -100
    cap_mask = (np.arange(Lc)[None] < rng.integers(1, Lc + 1, (B, 1))).astype(np.float32)
    return dict(input_ids=ids, token_type_ids=rng.integers(0, vocab, (B, L)), labels=labels,
                emotion_labels=rng.integers(0, 7, (B,)),
                valid=np.arange(B) < B - 1,  # the last row is fill
                seq_lengths=rng.integers(L // 2, L + 1, (B,)),
                imgs=rng.standard_normal((B, 768)).astype(np.float32),
                auds=rng.standard_normal((B, 768)).astype(np.float32),
                caption_ids=rng.integers(0, vocab, (B, Lc)), caption_mask=cap_mask)


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: (torch.as_tensor(v).long() if np.asarray(v).dtype.kind in "iu"
                else torch.as_tensor(v)) for k, v in b.items()}


def _jax_grads_by_name(tree, n_layer):
    """JAX's gradient tree as the port's parameter names."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            elif prefix.startswith("blocks."):
                for li in range(n_layer):
                    flat[f"blocks.{li}.{prefix[len('blocks.'):]}{k}"] = np.asarray(v[li])
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    walk(tree, "")
    return flat


def test_train_config_fields_match_jax():
    want = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    got = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert got == want


@pytest.mark.parametrize("lr,warmup,total", [(2e-5, 3, 30), (5e-4, 2, 8), (1e-4, 0, 5),
                                             (3e-3, 10, 11)])
def test_schedule_matches_jax(lr, warmup, total):
    """Every step 0 .. total + 2, in float32 on both sides."""
    j, t = jax_schedule(lr, warmup, total), polynomial_warmup_schedule(lr, warmup, total)
    want = np.array([float(j(s)) for s in range(total + 3)], np.float32)
    got = np.array([t(s) for s in range(total + 3)], np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("entry", ["params_from_numpy", "init_params", "init_kv_cache",
                                   "make_train_step", "batch_to_device", "Trainer"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without a device, each entry point asks for the card and
    fails where there is none, instead of landing quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {**TINY, "n_layer": 1}
    cfg = ModelConfig(**kw)
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "params_from_numpy":
            params_from_numpy(jax.tree_util.tree_map(
                np.asarray, jg.init_params(jax.random.PRNGKey(0), JaxModelConfig(**kw))), cfg)
        elif entry == "init_params":
            tg.init_params(torch.Generator().manual_seed(0), cfg)
        elif entry == "init_kv_cache":
            tg.init_kv_cache(cfg, 2, 8)
        elif entry == "make_train_step":
            tsteps.make_train_step(cfg, tsteps.AdamW(1e-3))
        elif entry == "batch_to_device":
            tsteps.batch_to_device(_example_batch())
        else:
            Trainer(TrainConfig(data_dir="unused"), model_config=cfg)


def _example_batch():
    from ergm_tpu_torch.data.dataset import Example
    ex = Example(input_ids=[1, 2, 3], token_type_ids=[4, 4, 4], labels=[-100, 2, 3],
                 img=np.zeros(8, np.float32), aud=np.zeros(8, np.float32), context="",
                 emotion_label=1)
    return collate([ex], eos_id=0, batch_size=2, pad_multiple=8, max_len=16)


@pytest.mark.parametrize("impl", ["chunked", "fused"])
def test_joint_loss_and_gradients_match_jax(impl):
    """The train step's joint loss (fill rows masked, seq_lengths, captions,
    image and audio features) and every parameter's gradient against
    ``jax.value_and_grad`` of JAX's ``_losses_and_metrics``."""
    kw = {**TINY, "lm_loss_impl": impl, "loss_chunk": 32}
    tree = _init(kw)
    b = _batch(np.random.default_rng(0), 3, 128, 16)
    jcfg = JaxModelConfig(**kw)
    (jl, jm), jgr = jax.jit(jax.value_and_grad(
        lambda p: jsteps._losses_and_metrics(p, jcfg, _jax_batch(b), True, None),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
    params = params_from_numpy(tree, ModelConfig(**kw), device="cpu")
    tl, tm = tsteps._losses_and_metrics(params, ModelConfig(**kw), _torch_batch(b), True)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    for k in ("lm_loss", "emotion_loss", "lm_tokens", "emotion_correct", "num_examples"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5, k
    want = _jax_grads_by_name(jgr, kw["n_layer"])
    for name, p in params.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("policy", ["mlp", "mlp_only", "full", "dots"])
def test_remat_gradients_equal_no_remat_with_dropout(policy):
    """Every dropout site at 0.1 (attention probabilities through K5's
    route): rematerialised sublayers draw the same masks, so the
    gradients equal those without remat."""
    kw = {**TINY, "n_head": 1, "embd_pdrop": 0.1, "attn_pdrop": 0.1, "resid_pdrop": 0.1,
          "attention_impl": "block"}
    tree = _init(kw, seed=1)
    b = _torch_batch(_batch(np.random.default_rng(1), 2, 128, 16))
    grads = []
    for remat in (False, True):
        cfg = ModelConfig(**kw, remat=remat, remat_policy=policy)
        params = params_from_numpy(tree, cfg, device="cpu")
        loss, _ = tsteps._losses_and_metrics(params, cfg, b, deterministic=False, seed=99)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in params.named_parameters()})
    base = tsteps._losses_and_metrics(params_from_numpy(tree, ModelConfig(**kw), device="cpu"),
                                      ModelConfig(**kw), b, deterministic=True)[0]
    assert abs(float(loss.detach()) - float(base.detach())) > 1e-4  # dropout is on
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=1e-5, msg=name)


def test_eight_train_steps_track_jax():
    """8 AdamW updates on the warmup schedule (update 0 at lr 0) with fresh
    batches: per-step joint losses within 2e-3 of JAX's make_train_step,
    the logits of a held-out batch afterwards within 5e-3."""
    kw = TINY
    tree = _init(kw, seed=2)
    rng = np.random.default_rng(2)
    batches = [_batch(rng, 4, 32, 8) for _ in range(8)]
    lr, warmup, total = 5e-4, 2, 8

    tx = optax.adamw(jax_schedule(lr, warmup, total), b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.01)
    jcfg = JaxModelConfig(**kw)
    state = jsteps.create_train_state(jax.tree_util.tree_map(jnp.asarray, tree), tx)
    jstep = jsteps.make_train_step(jcfg, tx)
    jl = []
    for b in batches:
        state, m = jstep(state, _jax_batch(b), jax.random.PRNGKey(0))
        jl.append(float(m["loss"]))

    cfg = ModelConfig(**kw)
    ttx = tsteps.AdamW(polynomial_warmup_schedule(lr, warmup, total))
    tstate = tsteps.create_train_state(params_from_numpy(tree, cfg, device="cpu"), ttx)
    tstep = tsteps.make_train_step(cfg, ttx, device="cpu")
    tl = []
    for b in batches:
        tstate, m = tstep(tstate, _torch_batch(b), 0)
        tl.append(float(m["loss"]))
        assert math.isfinite(float(m["grad_norm"]))
    np.testing.assert_allclose(tl, jl, atol=2e-3, rtol=2e-3)
    assert tstate.step == 8

    held = _batch(np.random.default_rng(99), 2, 24, 8)
    jo = jg.forward(state.params, jcfg, jnp.asarray(held["input_ids"]),
                    token_type_ids=jnp.asarray(held["token_type_ids"]),
                    caption_ids=jnp.asarray(held["caption_ids"]))
    with torch.no_grad():
        to = tg.forward(tstate.params, cfg, torch.as_tensor(held["input_ids"]),
                        token_type_ids=torch.as_tensor(held["token_type_ids"]),
                        caption_ids=torch.as_tensor(held["caption_ids"]))
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits), atol=5e-3, rtol=5e-3)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    write_synthetic_dataset(str(d), prefixes=("train", "valid"), num_dialogues=6,
                            turns_per_dialogue=4, base_vocab_size=128)
    return str(d)


def _small(vocab, pkg_config):
    return pkg_config(vocab_size=vocab, n_positions=64, n_embd=32, n_layer=2, n_head=4,
                      use_cross_attention=False, dtype="float32", embd_pdrop=0.0,
                      attn_pdrop=0.0, resid_pdrop=0.0)


def _train_cfgs(data_dir, tmp_path, **over):
    kw = dict(data_dir=data_dir, batch_size=4, num_epochs=1, lr=1e-3, max_len=64, seed=0,
              dtype="float32", warmup_ratio=0.1, mesh_shape=(1,))
    kw.update(over)
    return (JaxTrainConfig(ckpt_dir=os.path.join(str(tmp_path), "jax_ckpt"),
                           output_dir=os.path.join(str(tmp_path), "jax_out"), **kw),
            TrainConfig(ckpt_dir=os.path.join(str(tmp_path), "ckpt"),
                        output_dir=os.path.join(str(tmp_path), "out"), **kw))


def _epoch_losses(text):
    return [float(x) for x in re.findall(r"Epoch \d+: Train Loss: ([0-9.]+)", text)]


def test_trainer_epoch_matches_jax(data_dir, tmp_path, capsys):
    """One epoch of the port's Trainer against JAX's on the synthetic data,
    both from the same JAX init: the epoch's train loss within 2e-3, and
    the epoch line carries tok/s and the step p50."""
    from ergm_tpu.data.assembly import read_meta
    from ergm_tpu.train.trainer import Trainer as JaxTrainer

    vocab = read_meta(data_dir).vocab_size
    jcfg, tcfg = _train_cfgs(data_dir, tmp_path)
    tree = jax.tree_util.tree_map(np.asarray, jg.init_params(
        jax.random.PRNGKey(0), _small(vocab, JaxModelConfig)))
    JaxTrainer(jcfg, model_config=_small(vocab, JaxModelConfig),
               params=jax.tree_util.tree_map(jnp.asarray, tree)).train()
    want = _epoch_losses(capsys.readouterr().out)
    mcfg = _small(vocab, ModelConfig)
    tr = Trainer(tcfg, model_config=mcfg, params=params_from_numpy(tree, mcfg, device="cpu"),
                 device="cpu")
    best = tr.train()
    out = capsys.readouterr().out
    got = _epoch_losses(out)
    assert len(got) == len(want) == 1
    assert abs(got[0] - want[0]) <= 2e-3
    assert math.isfinite(best) and "tok/s" in out and "step p50" in out
    assert any(n.startswith("best_ckpt_epoch=1_valid_ppl=") for n in os.listdir(tcfg.ckpt_dir))


def test_checkpoint_naming_keep_best_and_resume(data_dir, tmp_path):
    """Reference names, keep_best pruning, find_checkpoint's best and
    preempt lookups, and a resume that restores the state exactly."""
    from ergm_tpu_torch.data.assembly import read_meta

    vocab = read_meta(data_dir).vocab_size
    _, tcfg = _train_cfgs(data_dir, tmp_path, num_epochs=2, keep_best=1)
    tr = Trainer(tcfg, model_config=_small(vocab, ModelConfig), device="cpu")
    tr.train()
    names = [n for n in os.listdir(tcfg.ckpt_dir) if n.startswith("best_ckpt_epoch=")]
    assert len(names) == 1 and re.fullmatch(r"best_ckpt_epoch=\d+_valid_ppl=\d+\.\d{4}", names[0])
    assert ckpt.find_checkpoint(tcfg.ckpt_dir) == os.path.join(tcfg.ckpt_dir, names[0])
    assert ckpt.find_checkpoint(tcfg.ckpt_dir, "preempt") is None  # cleared on completion

    ckpt.save_preempt_checkpoint(tcfg.ckpt_dir, tr.state, tr.last_epoch, tr.best_ppl)
    assert ckpt.find_checkpoint(tcfg.ckpt_dir, "preempt").endswith(ckpt.PREEMPT_NAME)
    assert ckpt.find_checkpoint(tcfg.ckpt_dir) == os.path.join(tcfg.ckpt_dir, names[0])

    tr2 = Trainer(tcfg.replace(ckpt_name="preempt"), model_config=_small(vocab, ModelConfig),
                  device="cpu")
    assert tr2.state.step == tr.state.step and tr2.last_epoch == tr.last_epoch
    assert tr2.best_ppl == pytest.approx(tr.best_ppl)
    for (n, a), b in zip(tr.state.params.state_dict().items(),
                         tr2.state.params.state_dict().values()):
        assert torch.equal(a, b), n
    s1 = tr.state.opt_state.state_dict()["state"]
    s2 = tr2.state.opt_state.state_dict()["state"]
    assert all(torch.equal(s1[i]["exp_avg"], s2[i]["exp_avg"]) for i in s1)


def test_training_slice_imports_no_jax():
    """The training modules and chip_smoke.py never load JAX or ergm_tpu
    (checked in a fresh interpreter: this process has JAX loaded)."""
    import subprocess
    import sys

    code = ("import sys, chip_smoke, ergm_tpu_torch.train.trainer, ergm_tpu_torch.ops.fused_ce, "
            "ergm_tpu_torch.ops.block_attention, ergm_tpu_torch.data.synthetic; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ergm_tpu')]; "
            "assert not bad, bad")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=120)
