"""The port's multi-device training (``ergm_tpu_torch/core/mesh.py``,
``parallel/``, ``fused_lm_loss_sharded``, the tensor-parallel forward,
the mesh train step, ZeRO-1, checkpoints, the loader and the CLI) on the
CPU, over gloo worlds of spawned processes (``torch_parallel_worker``).

Each world is spawned once, by a module fixture that returns every
rank's results; the tests below each assert one of them. Bars: against
one process over the global batch, loss 1e-5 and every gradient 1e-4
for one forward and backward, 8 AdamW steps within 2e-3 (PARITY.md:
43-49); checkpoints bit for bit; the xl head geometry over model=4
within rel 1e-6 of JAX's single-device loss on the same weights, as
JAX's own test holds it. The partition and ZeRO-1 rules equal JAX's
name by name on conftest's 8 virtual devices.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ergm_tpu.core import mesh as jmesh
from ergm_tpu.core.config import ModelConfig as JaxModelConfig
from ergm_tpu.models import gpt2 as jg
from ergm_tpu_torch.core import mesh as tmesh
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.data.dataset import DialogueDataset, Subset, batches, host_shard_order
from ergm_tpu_torch.data.loader import make_loader
from ergm_tpu_torch.data.synthetic import write_synthetic_dataset
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.parallel import distributed
from ergm_tpu_torch.train import checkpoint as ckpt
from ergm_tpu_torch.train import steps

import torch_parallel_worker as W

torch.set_num_threads(1)

XL = dict(n_layer=2, vocab_size=128, n_positions=64, dtype="float32", embd_pdrop=0.0,
          attn_pdrop=0.0, resid_pdrop=0.0, use_cross_attention=True)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """The 2-rank world's results, after the single process saved the
    checkpoint the world restores."""
    root = str(tmp_path_factory.mktemp("two"))
    cfg = ModelConfig(**W.TINY)
    _, state, _ = W.train(W.init(cfg), cfg, W.batches(0, W.STEPS)[:2])
    ckpt.save_checkpoint(f"{root}/single", state, 1, 10.0)
    return W.run_world(2, W.two_ranks, root), root


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """JAX's single-device loss at gpt2-xl's head geometry, then the 4-rank
    world on the same weights."""
    root = tmp_path_factory.mktemp("four")
    jcfg = JaxModelConfig.from_model_type("gpt2-xl", **XL)
    params = jg.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    ids = jnp.asarray(rng.integers(0, 128, (4, 32)), jnp.int32)
    emo = jnp.asarray(rng.integers(0, 7, (4,)), jnp.int32)
    single = float(jax.jit(lambda p: jg.forward(p, jcfg, ids, labels=ids,
                                                emotion_labels=emo).loss)(params))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(root / "xl.npz", **flat)
    del params, flat
    kw = dataclasses.asdict(ModelConfig.from_model_type("gpt2-xl", **XL))
    return single, W.run_world(4, W.four_ranks, str(root / "xl.npz"), kw)


# -- the rules, against JAX's -------------------------------------------------


def _jax_names(tree):
    """{port name: JAX path tuple} over a JAX parameter tree (stacked
    blocks name layer 0)."""
    out = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        name = ".".join(keys)
        out[name.replace("blocks.", "blocks.0.", 1) if keys[0] == "blocks" else name] = keys
    return out


RULES = dict(n_layer=2, n_embd=64, n_head=4, vocab_size=128, n_positions=32, dtype="float32")


@functools.lru_cache(maxsize=None)
def _jax_tree(int8=False):
    """JAX's parameter tree as shapes (``eval_shape``: nothing compiles)."""
    def build():
        tree = jg.init_params(jax.random.PRNGKey(0), JaxModelConfig(**RULES))
        if int8:
            tree = jg.quantize_params_int8(tree, JaxModelConfig(**RULES, weight_dtype="int8"))
        return tree
    return jax.eval_shape(build)


@pytest.mark.parametrize("int8", [False, True])
def test_partition_specs_match_jax(int8):
    """Every parameter path of gpt2 (fp, and int8 serving params) gets JAX's
    spec, less the leading layer axis of JAX's stacked blocks."""
    tree = _jax_tree(int8)
    names = _jax_names(tree)
    assert any(n.endswith("kernel_q") for n in names) == int8
    for name, keys in names.items():
        want = tuple(jmesh.param_partition_spec(keys))
        if keys[0] == "blocks":
            want = want[1:]
        assert tuple(tmesh.param_partition_spec(name)) == want, name


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_zero1_dims_match_jax(dp):
    """The ZeRO-1 dim of every AdamW moment equals the dim JAX's
    ``zero1_sharding_tree`` puts ``data`` on (None: replicated)."""
    opt = jax.eval_shape(optax.adamw(1e-3).init, _jax_tree())
    shardings = jmesh.zero1_sharding_tree(opt, jmesh.make_mesh((dp,), ("data",)))
    mu = shardings[0].mu
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(mu)[0]:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        spec = list(sh.spec)
        d = spec.index("data") if "data" in spec else None
        if keys[0] == "blocks":
            d = None if d is None else d - 1
            for li in range(RULES["n_layer"]):
                want[".".join(("blocks", str(li)) + keys[1:])] = d
        else:
            want[".".join(keys)] = d
    params = tg.init_params(torch.Generator().manual_seed(0), ModelConfig(**RULES), device="cpu")
    got = dict(zip([n for n, _ in params.named_parameters()],
                   tmesh.zero1_sharding_tree(params, tmesh.make_mesh((dp,), ("data",),
                                                                     world_size=dp))))
    assert got == want


def test_make_mesh_shapes_and_errors_match_jax():
    """JAX's ``test_make_mesh_shapes`` over 8 ranks: -1 absorbs the world,
    a smaller shape takes a prefix, two -1 and too large a shape raise."""
    assert tmesh.make_mesh((-1,), ("data",), world_size=8).shape == {"data": 8}
    assert tmesh.make_mesh((2, 2), ("data", "model"), world_size=8).shape == \
        dict(jmesh.make_mesh((2, 2), ("data", "model")).shape)
    assert tmesh.make_mesh((1,), ("data",), world_size=8).shape == {"data": 1}
    for shape, names in (((-1, -1), ("a", "b")), ((16,), ("data",))):
        with pytest.raises(ValueError) as port:
            tmesh.make_mesh(shape, names, world_size=8)
        with pytest.raises(ValueError) as jax_err:
            jmesh.make_mesh(shape, names)
        assert str(port.value) == str(jax_err.value)


def test_logical_to_sharding_drops_unknown_axes():
    m = tmesh.make_mesh((4,), ("data",), world_size=4)
    assert tmesh.logical_to_sharding(m, tmesh.P(None, "model")) == tmesh.P(None, None)
    assert tmesh.logical_to_sharding(m, tmesh.P(None, ("model",))) == tmesh.P(None, None)


@pytest.mark.parametrize("n,parts,want", [(25, 8, [4, 3, 3, 3, 3, 3, 3, 3]),
                                          (25, 4, [7, 6, 6, 6]), (12, 2, [6, 6])])
def test_head_groups_split_unevenly(n, parts, want):
    assert [hi - lo for lo, hi in tmesh.head_groups(n, parts)] == want


def test_qkv_split_keeps_q_k_and_v_by_head_group():
    """Rank r's c_attn columns are its heads' q, k and v columns, never a
    contiguous run across q and k."""
    cfg = ModelConfig(n_layer=1, n_embd=1600, n_head=25, vocab_size=8, dtype="float32")
    dim, idx = tmesh.tp_layout("blocks.0.attn.c_attn.kernel", (1600, 4800), cfg, 8)
    assert dim == 1
    first = idx[0].numpy()
    cols = np.arange(4 * 64)
    np.testing.assert_array_equal(first, np.concatenate([cols, 1600 + cols, 3200 + cols]))
    assert sorted(np.concatenate([i.numpy() for i in idx]).tolist()) == list(range(4800))


# -- data parallelism (2 ranks) ----------------------------------------------


@pytest.mark.parametrize("case", list(W.DP_CASES))
def test_data_parallel_loss_and_gradients(two, case):
    (r0, r1), _ = two
    single, meshed = r0["dp"][case]["loss"]
    assert abs(single - meshed) <= 1e-5
    assert max(r0["dp"][case]["grad_err"], r1["dp"][case]["grad_err"]) <= 1e-4


@pytest.mark.parametrize("case", list(W.DP_CASES))
def test_data_parallel_adamw_steps(two, case):
    (r0, _), _ = two
    single, meshed = r0["dp"][case]["steps"]
    assert len(single) == W.STEPS
    assert max(abs(a - b) for a, b in zip(single, meshed)) <= 2e-3
    assert r0["dp"][case]["param_err"] <= 2e-3


def test_sharded_loss_is_the_mean_over_the_global_count(two):
    """The ranks hold 96 + 96 and 8 + 0 targets: ``fused_lm_loss_sharded``
    gives the single process's loss, a mean of per-rank means does not."""
    r0 = two[0][0]["dp"]["fused"]
    assert abs(r0["lm_sharded"] - r0["lm_single"]) <= 1e-5
    assert abs(r0["mean_of_means"] - r0["lm_single"]) > 1e-3


def test_data_parallel_metrics_are_the_global_batchs(two):
    m = two[0][0]["dp"]["fused"]["metrics"]
    b = W.batches(0, 1)[0]
    labels = torch.where(b["valid"][:, None], b["labels"], -100)
    assert m["num_examples"] == W.B - 1
    assert m["lm_tokens"] == int((labels[:, 1:] != -100).sum()) == 2 * 96 + 8


# -- tensor parallelism (2 ranks, dropout on) --------------------------------


def test_tensor_parallel_loss(two):
    single, meshed = two[0][0]["tp"]["loss"]
    assert abs(single - meshed) <= 1e-5


@pytest.mark.parametrize("kind", ["ln_1.scale", "ln_2.bias", "wte.embedding", "wpe.embedding",
                                  "emotion_head.kernel", "attn.c_proj.bias", "mlp.c_proj.bias",
                                  "cross_attn.c_proj.bias", "attn.c_attn.kernel",
                                  "attn.c_attn.bias", "attn.c_proj.kernel", "mlp.c_fc.kernel",
                                  "mlp.c_proj.kernel", "cross_attn.q_attn.kernel",
                                  "cross_attn.c_attn.kernel", "cross_attn.c_proj.kernel"])
def test_tensor_parallel_gradients(two, kind):
    """Every gradient against one process, replicated (a missing f would
    leave LayerNorms and embeddings a rank's part; a doubled g would double
    them) and split (each rank's part of the whole) alike."""
    errs = [err for r in two[0] for name, err in r["tp"]["errors"].items()
            if name.endswith(kind)]
    assert errs and max(errs) <= 1e-4


def test_tensor_parallel_splits_what_jax_splits(two):
    split = two[0][0]["tp"]["split"]
    assert all(tmesh.MODEL_AXIS in tmesh.param_partition_spec(n) for n in split)
    assert any(n.endswith("c_attn.kernel") for n in split)


# -- the 4-rank world ----------------------------------------------------------


def test_xl_head_geometry_over_model_4_matches_jax(four):
    """25 heads x 64 over model=4 (7/6/6/6), the port's loss on JAX's
    weights within rel 1e-6 of JAX's single device, finite gradients."""
    single, ranks = four
    for r, res in enumerate(ranks):
        assert res["xl"]["heads"] == (7 if r == 0 else 6)
        assert res["xl"]["loss"] == pytest.approx(single, rel=1e-6)
        assert res["xl"]["finite"]


def test_data_and_model_axes_with_zero1_match_one_process(four):
    res = four[1][0]["dp2xmp2"]
    assert abs(res["loss"][0] - res["loss"][1]) <= 1e-5
    assert max(r["dp2xmp2"]["grad_err"] for r in four[1]) <= 1e-4
    assert max(r["dp2xmp2"]["param_err"] for r in four[1]) <= 1e-5
    assert res["zero_sharded"] > 0


def test_sharded_loss_raises_on_a_model_axis(four):
    assert all(r["sharded_raises"] for r in four[1])


def test_site_masks_differ_across_data_and_agree_across_model(four):
    ranks = four[1]
    masks, coords = ranks[0]["masks"], [r["coords"] for r in ranks]
    for i in range(4):
        for j in range(4):
            same = np.array_equal(masks[i], masks[j])
            assert same == (coords[i][0] == coords[j][0]), (coords[i], coords[j])
    assert 0.3 < masks[0].mean() < 0.7


# -- checkpoints across meshes ---------------------------------------------


def test_world_checkpoint_resumes_bit_for_bit(two):
    """The world's own save, restored in the world: the next step's loss and
    parameters equal the world that never stopped, bit for bit."""
    c = two[0][0]["ckpt"]
    got = c["resumed"]["world"]
    assert got["loss"] == c["loss3"]
    for name, want in c["ahead"].items():
        np.testing.assert_array_equal(got["after"][name], want)


def test_world_checkpoint_restores_in_one_process(two):
    """The world's ZeRO-1 save is the single-card format: one process
    restores the world's parameters bit for bit and steps on within 1e-5."""
    (r0, _), root = two
    cfg = ModelConfig(**W.TINY)
    _, state, tx = W.train(W.init(cfg, seed=9), cfg, [])
    ckpt.restore_checkpoint(ckpt.find_checkpoint(f"{root}/world"), state)
    for name, p in state.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), r0["ckpt"]["p2"][name])
    step = steps.make_train_step(cfg, tx, device="cpu")
    state, m = step(state, W.batches(0, W.STEPS)[2], 7)
    assert abs(float(m["loss"]) - r0["ckpt"]["loss3"]) <= 1e-5
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), r0["ckpt"]["ahead"][name], atol=1e-5)


def test_single_checkpoint_restores_in_the_world(two):
    """A one-process save restored by the ZeRO-1 world: gathered back, its
    parameters and moments equal the file bit for bit; the world's next
    step is the one process's within 1e-5."""
    (r0, _), root = two
    got = r0["ckpt"]["resumed"]["single"]
    payload = torch.load(os.path.join(ckpt.find_checkpoint(f"{root}/single"), ckpt.STATE_FILE),
                         weights_only=True)
    for name, t in payload["params"].items():
        np.testing.assert_array_equal(got["params"][name], t.numpy())
    for i, entry in payload["opt_state"]["state"].items():
        np.testing.assert_array_equal(got["mu"][i], entry["exp_avg"].numpy())
        np.testing.assert_array_equal(got["nu"][i], entry["exp_avg_sq"].numpy())
    cfg = ModelConfig(**W.TINY)
    single, _, _ = W.train(W.init(cfg), cfg, W.batches(0, W.STEPS)[:3])
    assert abs(got["loss"] - single[2]) <= 1e-5
    assert got["step"] == 3


# -- the loader ---------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    st = write_synthetic_dataset(str(root), prefixes=("train",), num_dialogues=6,
                                 turns_per_dialogue=4, base_vocab_size=120, captions="target",
                                 seed=5)
    ds = DialogueDataset("train", str(root), sp1_id=st.sp1_id, sp2_id=st.sp2_id,
                         eos_id=st.eos_id, max_len=128)
    return ds, st


@pytest.mark.parametrize("dp", [2, 4])
def test_data_ranks_rows_put_together_are_the_batches(dataset, dp):
    """Each data rank's loader collates its rows of every batch; put
    together they are the single process's batches, field by field (the
    last batch short, with fill rows)."""
    ds, st = dataset
    kw = dict(batch_size=8, eos_id=st.eos_id, shuffle=True, seed=3, max_len=128, pad_multiple=32)
    whole = list(make_loader(ds, **kw))
    parts = [list(make_loader(ds, **kw, rows=(r * 8 // dp, (r + 1) * 8 // dp)))
             for r in range(dp)]
    assert len(whole) == 3 and all(len(p) == len(whole) for p in parts)
    for i, b in enumerate(whole):
        for field in ("input_ids", "labels", "token_type_ids", "attention_mask", "imgs",
                      "valid", "caption_ids", "caption_mask", "emotion_labels"):
            got = np.concatenate([np.asarray(getattr(p[i], field)) for p in parts])
            np.testing.assert_array_equal(got, np.asarray(getattr(b, field)), err_msg=field)


def test_two_hosts_take_host_shard_order(dataset):
    """host_count=2: each host batches its strided shard of the epoch's
    global shuffle, in order, the two shards disjoint."""
    ds, st = dataset
    seen = []
    for host in range(2):
        loader = make_loader(ds, batch_size=4, eos_id=st.eos_id, shuffle=True, seed=11,
                             max_len=128, host_index=host, host_count=2, drop_remainder=True)
        order = host_shard_order(len(ds), host, 2, shuffle=True, seed=11)
        want = list(batches(Subset(ds, order), 4, st.eos_id, max_len=128,
                            drop_remainder=True))
        got = list(loader)
        assert len(got) == len(want) == len(order) // 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a.input_ids), b.input_ids)
        seen.append(set(order.tolist()))
    assert not seen[0] & seen[1]


# -- the launcher and the CLI ---------------------------------------------------


def test_initialize_is_a_noop_for_one_process():
    info = distributed.initialize()
    assert info["process_count"] == 1 and info["global_devices"] == 1
    assert distributed.is_primary()


def test_initialize_from_env(monkeypatch):
    """JAX's three cases: no environment -> None; the full one -> a world of
    hosts x local ranks at the coordinator (NCCL for a card, gloo for the
    CPU); a partial one -> JAX's error."""
    assert distributed.initialize_from_env({}) is None
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    env = {"ERGM_COORDINATOR": "10.0.0.1:1234", "ERGM_NUM_PROCESSES": "4",
           "ERGM_PROCESS_ID": "2", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}
    info = distributed.initialize_from_env(env, device="cpu")
    assert calls == [("gloo", {"init_method": "tcp://10.0.0.1:1234", "world_size": 8,
                               "rank": 5})]
    assert (info["process_index"], info["process_count"], info["local_devices"]) == (2, 4, 2)
    assert distributed.backend_for("cuda:1") == "nccl"
    with pytest.raises(ValueError, match="Partial multi-host"):
        distributed.initialize_from_env({"ERGM_COORDINATOR": "x:1"})


_TINY_CLI = """
import sys
import ergm_tpu_torch.core.config as c
c.GPT2_SIZES["tiny"] = dict(n_layer=2, n_embd=64, n_head=2)
from ergm_tpu_torch.cli.main import main
if __name__ == "__main__":
    main(sys.argv[1:])
"""


def test_cli_trains_over_a_two_rank_world(tmp_path, monkeypatch, capsys):
    """``--mode=train --mesh_shape=2 --shard_opt_state --gpu=cpu`` starts
    two gloo processes itself; rank 0 alone prints, and its epoch line
    equals a single run's (dropout 0; the single run in this process)."""
    from ergm_tpu_torch.cli import main as cli
    from ergm_tpu_torch.core import config as port_config

    write_synthetic_dataset(str(tmp_path / "tiny"), prefixes=("train", "valid"),
                            num_dialogues=8, turns_per_dialogue=4, base_vocab_size=200, seed=3)
    script = tmp_path / "run_cli.py"
    script.write_text(_TINY_CLI)
    argv = ["--mode=train", f"--data_dir={tmp_path}", "--model_type=tiny", "--batch_size=4",
            "--num_epochs=1", "--gpu=cpu", "--dtype=float32", "--output_dir=", "--max_len=128",
            "--lr=1e-3", "--attn_pdrop=0", "--resid_pdrop=0", "--embd_pdrop=0"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.dirname(__file__)),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, str(script), *argv, "--mesh_shape=2",
                          "--shard_opt_state", f"--ckpt_dir={tmp_path}/ck_world"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "world: 2 ranks" in out.stdout and "backend gloo" in out.stdout
    world = [ln for ln in out.stdout.splitlines() if ln.startswith("Epoch 1:")]
    assert len(world) == 1, out.stdout  # rank 0 alone prints
    monkeypatch.setitem(port_config.GPT2_SIZES, "tiny", dict(n_layer=2, n_embd=64, n_head=2))
    capsys.readouterr()
    cli.main([*argv, f"--ckpt_dir={tmp_path}/ck_single"])
    single = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Epoch 1:")]
    # loss, PPLs and accuracy; the wall time and throughput differ
    assert world[0].split(" | ")[:3] == single[0].split(" | ")[:3]


@pytest.mark.parametrize("mode,flags", [("infer", ["--mesh_shape=2", "--ckpt_name=x",
                                                   "--batch_size=3"]),
                                        ("serve", ["--mesh_shape=2,2", "--mesh_axes=data,model",
                                                   "--batch_size=5"]),
                                        ("serve", ["--shard_opt_state", "--mesh_shape=3"])])
def test_cli_inference_over_several_devices_raises(mode, flags):
    """Inference and serving take a mesh now (tests/test_torch_mesh_infer.py);
    an explicit one whose data axis does not divide the batch (the serving
    slots) raises JAX's error before any process starts."""
    from ergm_tpu_torch.cli import main as cli

    with pytest.raises(ValueError, match="must be divisible by the mesh data axis"):
        cli.main([f"--mode={mode}", "--gpu=cpu", *flags])
