"""Port parity at the large GPT-2 family's widths: gpt2-large (n_embd
1,280, 20 heads, n_inner 5,120) and gpt2-xl (1,600, 25 heads, 6,400),
against ergm_tpu on the same seeded numpy inputs, fp32 on the CPU. JAX's
Pallas kernels run in interpret mode, the port's as their plain versions.

Kernel K6's plain version against JAX's K6 at D = 1,280 and 1,600 (JAX
tiles the vocabulary by width there: 1,024 and 512 columns), NLL 1e-5 and
gradients rtol 1e-4 / atol 1e-5 (JAX's own bars); one layer of each model
at its published width over a 512-token vocabulary, weights from
``models.seeded.seeded_tree``: one training step's joint loss within 1e-5
and every gradient within 1e-4, and greedy serving (int8 KV and caption
caches) replayed teacher-forced, the port's tokens equal to
JAX's wherever JAX's top-2 margin exceeds 1e-3; the command line's
``--model_type`` recipes give JAX's configs. The same for one layer at
Cerebras-GPT-2.7B's head width (80) with a narrowed D, built through the
constructor as 2.7B's config is. The full-width agreements at gpt2-large's
and Cerebras-GPT-2.7B's widths are held on the card by ``chip_smoke.py``
against ``tests/fixtures/large_agreement.json`` and
``tests/fixtures/cerebras_2p7b_agreement.json``; here only the fixtures'
form is checked.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ergm_tpu.cli import main as jcli
from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.infer import generate as jgen
from ergm_tpu.models import gpt2 as jg
from ergm_tpu.ops.fused_ce import fused_softmax_xent as jax_xent
from ergm_tpu.train import steps as jsteps
from ergm_tpu_torch.cli import main as tcli
from ergm_tpu_torch.core.config import GPT2_SIZES, ModelConfig
from ergm_tpu_torch.infer import generate as tgen
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.models import seeded
from ergm_tpu_torch.models.convert import params_from_numpy
from ergm_tpu_torch.ops import fused_ce as tce
from ergm_tpu_torch.train import steps as tsteps
from test_torch_generate import EOS, MARGIN, SP2, _check_tokens, _margin, _replay
from test_torch_train import _batch, _jax_batch, _jax_grads_by_name, _torch_batch

torch.set_num_threads(1)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "large_agreement.json")
FAMILY = ["gpt2-large", "gpt2-xl"]
# Cerebras-GPT-2.7B's head width (80) and MLP ratio (n_inner = 4 D) at a
# narrowed D, through the constructor as models/seeded.py's 2.7B config
CEREBRAS_NARROW = "cerebras-2.7b-heads"
NARROW = dict(n_embd=320, n_head=4, n_inner=1280)


def _one_layer(model_type, **kw):
    """The model's published width (``CEREBRAS_NARROW``: 2.7B's head width at
    a narrowed D) at one layer over a 512-token vocabulary, fp32, dropout 0:
    (JAX's config, the port's)."""
    kw = dict(n_layer=1, vocab_size=512, n_positions=128, dtype="float32", embd_pdrop=0.0,
              attn_pdrop=0.0, resid_pdrop=0.0, **kw)
    if model_type == CEREBRAS_NARROW:
        return JaxConfig(**NARROW, **kw), ModelConfig(**NARROW, **kw)
    return (JaxConfig.from_model_type(model_type, **kw),
            ModelConfig.from_model_type(model_type, **kw))


@pytest.mark.parametrize("d", [1280, 1600])
def test_plain_k6_matches_jax_at_family_widths(d):
    """Forward and both gradients, an ignored label, ragged vocabulary blocks
    on JAX's side (1,100 columns over blocks of 1,024 or 512)."""
    rng = np.random.default_rng(d)
    n, v = 24, 1100
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (3.0 / d ** 0.5 * rng.standard_normal((v, d))).astype(np.float32)
    lbl = rng.integers(0, v, (n,)).astype(np.int32)
    lbl[5] = -100
    g = rng.standard_normal((n,)).astype(np.float32)
    g[5] = 0.0

    def loss(h, w):
        return jnp.sum(jax_xent(h, w, jnp.asarray(lbl), 8, None, True) * jnp.asarray(g))

    want = np.asarray(jax_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lbl), 8, None, True))
    jh, jw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_(True) for x in (h, w))
    nll = tce.fused_softmax_xent(th, tw, torch.from_numpy(lbl))
    (nll * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-5)


def test_k6_takes_the_family_widths():
    """The card's width rule: every D, as JAX's kernel takes any D, so each
    GPT-2 preset's n_embd and Cerebras-GPT's 2,560, 4,096 and 5,120 (past
    the 2,048 cap K6 had before); the kernels run D at the next multiple of
    64."""
    presets = [ModelConfig.from_model_type(m).n_embd
               for m in ("distilgpt2", "gpt2", "gpt2-medium", *FAMILY)]
    widths = (1, 32, 64, 96, 100, 192, 1632, 2048, 2112, 2560, 2600, 4096, 5120)
    for dtype in (torch.float32, torch.bfloat16):
        assert all(tce.kernel_takes(torch.zeros((1, d), dtype=dtype))
                   for d in (*presets, *widths))
    assert not tce.kernel_takes(torch.zeros((1, 2560), dtype=torch.float16))
    assert [tce.padded_width(d) for d in widths] == [64, 64, 64, 128, 128, 192, 1664, 2048,
                                                     2112, 2560, 2624, 4096, 5120]


@pytest.mark.parametrize("model_type", FAMILY)
def test_seeded_tree_has_jax_layout(model_type):
    """``seeded_tree`` lays out JAX's init tree: the same keys, shapes and
    dtype, and one seed gives one tree."""
    jc, tc = _one_layer(model_type, modality_dim=768)
    want = jax.eval_shape(lambda: jg.init_params(jax.random.PRNGKey(0), jc))
    tree = seeded.seeded_tree(tc, 3)
    assert (jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want))
    for got, w in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
        assert got.shape == w.shape and got.dtype == np.float32 == w.dtype
    again = seeded.seeded_tree(tc, 3)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(tree),
                                                      jax.tree_util.tree_leaves(again)))


@pytest.mark.parametrize("model_type", [*FAMILY, CEREBRAS_NARROW])
def test_train_step_matches_jax(model_type):
    """The train step's joint loss and every parameter's gradient at the
    model's width, through K6's plain version (``lm_loss_impl="fused"``:
    JAX's K6 in interpret mode, tiled by width) with captions, image and
    audio features and a fill row."""
    jc, tc = _one_layer(model_type, modality_dim=768, lm_loss_impl="fused")
    tree = seeded.seeded_tree(tc, 5)
    b = _batch(np.random.default_rng(5), 2, 64, 8, vocab=512)
    (jl, _), jgr = jax.jit(jax.value_and_grad(
        lambda p: jsteps._losses_and_metrics(p, jc, _jax_batch(b), True, None),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
    params = params_from_numpy(tree, tc, device="cpu")
    tl, _ = tsteps._losses_and_metrics(params, tc, _torch_batch(b), True)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    want = _jax_grads_by_name(jgr, 1)
    for name, p in params.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("model_type", [*FAMILY, CEREBRAS_NARROW])
def test_greedy_tokens_match_jax(model_type):
    """Greedy serving at the model's width (int8 KV and caption caches):
    JAX's tokens replayed teacher-forced through both
    packages agree wherever JAX's margin exceeds 1e-3, the port's own
    ``generate`` by the margin rule, the emotion logits within 1e-3."""
    kw = dict(kv_cache_dtype="int8", cross_kv_dtype="int8", modality_dim=768)
    jc, tc = _one_layer(model_type, **kw)
    tree = seeded.seeded_tree(tc, 7)
    pj = jg.params_for_inference(jax.tree_util.tree_map(jnp.asarray, tree), jc)
    pt = tg.params_for_inference(params_from_numpy(tree, tc, device="cpu"), tc)
    B, Lp, Lc, new = 4, 16, 8, 8
    max_len = Lp + new
    rng = np.random.default_rng(7)
    ids, tts = rng.integers(0, 512, (B, Lp)), rng.integers(0, 512, (B, Lp))
    imgs, auds = (rng.standard_normal((B, 768)).astype(np.float32) for _ in range(2))
    caps = rng.integers(0, 512, (B, Lc))
    jout = jax.jit(lambda p: jgen.generate(
        p, jc, jnp.asarray(ids), Lp, max_len=max_len, eos_id=EOS, sp2_id=SP2,
        token_type_ids=jnp.asarray(tts), imgs=jnp.asarray(imgs), auds=jnp.asarray(auds),
        caption_ids=jnp.asarray(caps), greedy=True))(pj)
    jtok, jlen = np.asarray(jout.tokens), np.asarray(jout.lengths)
    args = (ids, np.ones((B, Lp), np.float32), tts, imgs, auds, caps, None, jtok, max_len)
    jl, tl = _replay("jax", pj, jc, *args), _replay("torch", pt, tc, *args)
    compared = 0
    for s in range(Lp, max_len):
        live = (s < jlen) & (_margin(jl[s]) > MARGIN)
        assert (jl[s].argmax(-1)[live] == jtok[live, s]).all()
        assert (tl[s].argmax(-1)[live] == jtok[live, s]).all()
        compared += int(live.sum())
    assert compared >= B * new // 2
    tout = tgen.generate(pt, tc, torch.as_tensor(ids), Lp, max_len=max_len, eos_id=EOS,
                         sp2_id=SP2, token_type_ids=torch.as_tensor(tts),
                         imgs=torch.as_tensor(imgs), auds=torch.as_tensor(auds),
                         caption_ids=torch.as_tensor(caps), greedy=True)
    _check_tokens(jtok, tout.tokens.numpy(), jl, Lp, jlen)
    np.testing.assert_allclose(tout.emotion_logits.numpy(), np.asarray(jout.emotion_logits),
                               atol=1e-3, rtol=0)


# ergm_tpu's single-card recipes for the family (README: gpt2-large B=12 with
# full remat and a bf16 first moment; gpt2-xl B=4 with the same flags)
RECIPES = {"gpt2-large": ["--batch_size=12"], "gpt2-xl": ["--batch_size=4"]}


@pytest.mark.parametrize("model_type", FAMILY)
def test_cli_recipe_gives_jax_configs(model_type):
    """``--model_type`` with the recipe's flags: the run config and the
    model config the Trainer builds from it equal JAX's, field for field."""
    argv = ["--mode=train", f"--model_type={model_type}", "--remat_policy=full",
            "--adam_mu_dtype=bfloat16", *RECIPES[model_type]]
    cfgs = [pkg.args_to_config(pkg.build_argparser().parse_args(argv)) for pkg in (jcli, tcli)]
    assert dataclasses.asdict(cfgs[1]) == dataclasses.asdict(cfgs[0])
    models = []
    for cls, cfg in zip((JaxConfig, ModelConfig), cfgs):
        models.append(dataclasses.asdict(cls.from_model_type(
            cfg.model_type, vocab_size=50271, dtype=cfg.dtype, remat=cfg.remat,
            remat_policy=cfg.remat_policy)))
    assert models[1] == models[0]
    want = {"gpt2-large": (36, 20, 1280), "gpt2-xl": (48, 25, 1600)}[model_type]
    assert (models[1]["n_layer"], models[1]["n_head"], models[1]["n_embd"]) == want
    assert models[1]["lm_loss_impl"] == "auto" and models[1]["remat_policy"] == "full"


def test_agreement_fixture_matches_its_recipe():
    """The committed fixture was written for ``seeded.AGREEMENT`` as it
    stands (a change there needs ``scripts/large_agreement.py`` run again),
    at gpt2-large's width, with a token, a margin and a length for every
    decision of every row and finite losses."""
    with open(FIXTURE) as f:
        fx = json.load(f)
    a = seeded.AGREEMENT
    assert fx["agreement"] == a
    assert {k: fx["config"][k] for k in ("n_embd", "n_head", "n_layer")} == {
        "n_embd": 1280, "n_head": 20, "n_layer": a["n_layer"]}
    assert np.asarray(fx["tokens"]).shape == np.asarray(fx["margins"]).shape == (
        a["rows"], a["new"])
    assert len(fx["lengths"]) == a["rows"] and len(fx["lm_losses"]) == a["steps"]
    assert np.asarray(fx["emotion_logits"]).shape == (a["rows"], 7)
    assert all(np.isfinite(fx["lm_losses"])) and os.path.getsize(FIXTURE) < 100_000


def test_gpt2_agreement_fixture_matches_its_recipe():
    """The gpt2 fixture (``scripts/large_agreement.py --recipe=gpt2``) was
    written for ``seeded.GPT2_AGREEMENT`` as it stands: gpt2's published
    width at all 12 of its layers, the large recipe's rows, steps and
    sizes, a token, a margin and a length for every decision of every row
    and finite losses."""
    path = os.path.join(os.path.dirname(FIXTURE), "gpt2_agreement.json")
    with open(path) as f:
        fx = json.load(f)
    a = seeded.GPT2_AGREEMENT
    assert fx["agreement"] == a
    assert {k: v for k, v in a.items() if k not in ("model_type", "n_layer")} == {
        k: v for k, v in seeded.AGREEMENT.items() if k not in ("model_type", "n_layer")}
    assert {k: fx["config"][k] for k in ("n_embd", "n_head", "n_layer")} == {
        "n_embd": 768, "n_head": 12, "n_layer": 12}
    assert np.asarray(fx["tokens"]).shape == np.asarray(fx["margins"]).shape == (
        a["rows"], a["new"])
    assert len(fx["lengths"]) == a["rows"] and len(fx["lm_losses"]) == a["steps"]
    assert np.asarray(fx["emotion_logits"]).shape == (a["rows"], 7)
    assert all(np.isfinite(fx["lm_losses"])) and os.path.getsize(path) < 100_000


def test_cerebras_agreement_fixture_matches_its_recipe():
    """The Cerebras fixture (``scripts/large_agreement.py
    --recipe=cerebras-2.7b``) was written for ``seeded.CEREBRAS_2P7B_AGREEMENT``
    as it stands: Cerebras-GPT-2.7B's published widths (n_embd 2,560, 32
    heads of 80, n_inner 10,240, n_positions 2,048) through the
    constructor, not a preset, at 2 of its 32 layers, the large recipe's
    rows, steps and sizes, a token, a margin and a length for every
    decision of every row and finite losses."""
    path = os.path.join(os.path.dirname(FIXTURE), "cerebras_2p7b_agreement.json")
    with open(path) as f:
        fx = json.load(f)
    a = seeded.CEREBRAS_2P7B_AGREEMENT
    assert fx["agreement"] == a
    assert {k: v for k, v in a.items() if k not in ("model_type", "n_layer", "widths")} == {
        k: v for k, v in seeded.AGREEMENT.items() if k not in ("model_type", "n_layer")}
    assert a["widths"] == seeded.CEREBRAS_2P7B == {"n_embd": 2560, "n_head": 32,
                                                   "n_inner": 10240, "n_positions": 2048}
    cfg = seeded.agreement_config(ModelConfig, a)
    assert a["model_type"] not in GPT2_SIZES and cfg.head_dim == 80 and cfg.n_layer == 2
    assert {k: fx["config"][k] for k in ("n_embd", "n_head", "n_layer", "n_inner",
                                         "n_positions")} == {
        "n_embd": 2560, "n_head": 32, "n_layer": 2, "n_inner": 10240, "n_positions": 2048}
    assert np.asarray(fx["tokens"]).shape == np.asarray(fx["margins"]).shape == (
        a["rows"], a["new"])
    assert len(fx["lengths"]) == a["rows"] and len(fx["lm_losses"]) == a["steps"]
    assert np.asarray(fx["emotion_logits"]).shape == (a["rows"], 7)
    assert all(np.isfinite(fx["lm_losses"])) and os.path.getsize(path) < 100_000
