"""Port parity: ergm_tpu_torch.models.gpt2 against ergm_tpu.models.gpt2.

Same parameters (a JAX init, perturbed so biases and LayerNorm scales
are not trivial, converted with ``params_from_numpy``) and same inputs
(numpy, from a seed) through both packages, fp32, on the CPU. The JAX
side runs its prefill-attention Pallas kernel in interpret mode; the
port runs the kernel's plain version.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.models import gpt2 as jg
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

# passes K1's gate (Dh=64, D % 128 == 0) and has img/aud projections
TINY = dict(n_layer=2, n_embd=128, n_head=2, vocab_size=256, n_positions=64,
            modality_dim=768, dtype="float32")
INT8 = dict(kv_cache_dtype="int8", cross_kv_dtype="int8", weight_dtype="int8_lm_head")


def _params(cfg_kw, seed=0):
    """(JAX serving params, port serving model) from one perturbed init."""
    jc, tc = JaxConfig(**cfg_kw), ModelConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jg.init_params(jax.random.PRNGKey(seed), jc))
    pj = jg.params_for_inference(jax.tree_util.tree_map(jnp.asarray, tree), jc)
    pt = tg.params_for_inference(params_from_numpy(tree, tc, device="cpu"), tc)
    return jc, tc, pj, pt, tree


def test_config_fields_match_jax():
    """The port's ModelConfig has exactly JAX's field names and defaults."""
    want = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    assert got == want
    for name in ("gpt2", "gpt2-xl"):
        j, t = JaxConfig.from_model_type(name), ModelConfig.from_model_type(name)
        assert (t.head_dim, t.inner_dim) == (j.head_dim, j.inner_dim)


def test_quantize_kv_byte_identical():
    """int8 codes and bf16 scales of the KV quantizer equal JAX's bit for
    bit, including an all-zero row and half-way rounding cases."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 5, 64)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0
    x[1, 1, 1, :4] = [127.0, 0.5, -0.5, 1.5]  # scale 1: codes on the .5 edges
    jq, js = jg._quantize_kv(jnp.asarray(x))
    tq, ts = tg._quantize_kv(torch.from_numpy(x))
    assert ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, np.float32))


@pytest.mark.parametrize("weight_dtype", ["int8_lm_head", "int8"])
def test_quantize_params_int8_identical(weight_dtype):
    """Weight codes and scales equal JAX's for both int8 serving modes;
    full int8 quantizes every dense kernel but the emotion head's."""
    _, tc, pj, pt, _ = _params({**TINY, "weight_dtype": weight_dtype})
    np.testing.assert_array_equal(pt.wte.embedding_q.numpy(),
                                  np.asarray(pj["wte"]["embedding_q"]))
    np.testing.assert_array_equal(pt.wte.embedding_scale.numpy(),
                                  np.asarray(pj["wte"]["embedding_scale"]))
    np.testing.assert_array_equal(tg.wte_dense(pt.wte, torch.float32).numpy(),
                                  np.asarray(jg.wte_dense(pj["wte"], jnp.float32)))
    assert pt.emotion_head.kernel is not None and pt.emotion_head.kernel_q is None
    for li, blk in enumerate(pt.blocks):
        for path in ("attn.c_attn", "attn.c_proj", "cross_attn.q_attn", "cross_attn.c_attn",
                     "mlp.c_fc", "mlp.c_proj"):
            mod, node = blk.get_submodule(path), pj["blocks"]
            for part in path.split("."):
                node = node[part]
            if weight_dtype == "int8":
                np.testing.assert_array_equal(mod.kernel_q.numpy(),
                                              np.asarray(node["kernel_q"][li]))
                np.testing.assert_array_equal(mod.kernel_scale.numpy(),
                                              np.asarray(node["kernel_scale"][li]))
            else:
                assert mod.kernel_q is None and "kernel" in node
    if weight_dtype == "int8":
        np.testing.assert_array_equal(pt.img_proj.kernel_q.numpy(),
                                      np.asarray(pj["img_proj"]["kernel_q"]))


def _inputs(rng, B, L, Lc, T, steps, vocab, ragged):
    """Prompt, features, caption and per-step tokens; ``ragged`` left-pads
    the prompts and leaves every fifth row without a caption."""
    pm = np.ones((B, L), np.float32)
    cm = np.ones((B, Lc), np.float32)
    if ragged:
        for b in range(B):
            pm[b, :rng.integers(0, L // 2)] = 0.0
            cm[b, rng.integers(1, Lc):] = 0.0
        cm[::5] = 0.0
    mask = np.zeros((B, T), np.float32)
    mask[:, :L] = pm
    return dict(
        ids=rng.integers(0, vocab, (B, L)), tts=rng.integers(0, vocab, (B, L)),
        imgs=rng.standard_normal((B, 768)).astype(np.float32),
        auds=rng.standard_normal((B, 768)).astype(np.float32),
        caps=rng.integers(0, vocab, (B, Lc)), cap_mask=cm, mask=mask,
        pos=np.maximum(np.cumsum(pm, -1) - 1, 0).astype(np.int64),
        row_len=pm.sum(-1).astype(np.int64), seq_lengths=pm.sum(-1).astype(np.int64),
        steps=rng.integers(0, vocab, (steps, B, 1)))


def _run(side, params, cfg, x, B, L, Lc, T, sp2=5):
    """Prefill with a cache (prefix_prefill), then cached single-token
    steps. Returns (prefill last logits, emotion logits, [step logits])."""
    if side == "jax":
        arr, mod = jnp.asarray, jg
        run = jax.jit(lambda p, **kw: jg.forward(p, cfg, **kw),
                      static_argnames=("prefix_prefill", "compute_logits"))
    else:
        arr, mod = torch.as_tensor, tg

        def run(p, **kw):
            with torch.inference_mode():
                return tg.forward(p, cfg, **kw)
    cache = mod.init_kv_cache(cfg, B, T, caption_len=Lc,
                              **({} if side == "jax" else {"device": "cpu"}))
    o = run(params, input_ids=arr(x["ids"]), token_type_ids=arr(x["tts"]),
            position_ids=arr(x["pos"]), attention_mask=arr(x["mask"]), imgs=arr(x["imgs"]),
            auds=arr(x["auds"]), caption_ids=arr(x["caps"]),
            encoder_attention_mask=arr(x["cap_mask"]), seq_lengths=arr(x["seq_lengths"]),
            cache=cache, prefix_prefill=True, compute_logits="last")
    first, emo, cache = np.asarray(o.logits[:, -1]), np.asarray(o.emotion_logits), o.cache
    mask, steps = x["mask"].copy(), []
    for s, tok in enumerate(x["steps"]):
        mask[:, L + s] = 1.0
        o = run(params, input_ids=arr(tok), token_type_ids=arr(np.full((B, 1), sp2)),
                position_ids=arr((x["row_len"] + s)[:, None]), attention_mask=arr(mask),
                encoder_attention_mask=arr(x["cap_mask"]), cache=cache)
        cache = o.cache
        steps.append(np.asarray(o.logits[:, -1]))
    return first, emo, steps


# Measured maxima of |port - JAX| (fp32, CPU): auto caches 9.5e-7 at
# prefill, 8.3e-7 on decode steps, 4.9e-7 on emotion logits; int8 caches
# 8.1e-7 at prefill (it attends over the fresh k/v) and 1.3e-4 on decode
# steps, where an int8 code can flip at a rounding edge; per-layer
# scaling 8.9e-7.
@pytest.mark.parametrize("quant,bar", [
    ({}, 1e-4), (INT8, 1e-3), ({"scale_attn_by_inverse_layer_idx": True}, 1e-4)])
def test_forward_prefill_and_decode_match_jax(quant, bar):
    """Batched prefill through K1's route on both sides (B=64), with
    left-padded prompts and caption-less rows, then cached decode steps.
    Per-layer attention scaling makes the scale a tensor, which K1's
    wrapper folds into q as JAX folds a traced one."""
    kw = {**TINY, **quant}
    jc, tc, pj, pt, _ = _params(kw)
    B, L, Lc, steps = 64, 16, 8, 3
    T = L + steps + 1
    x = _inputs(np.random.default_rng(1), B, L, Lc, T, steps, kw["vocab_size"], ragged=True)
    jf, je, js = _run("jax", pj, jc, x, B, L, Lc, T)
    tf, te, ts = _run("torch", pt, tc, x, B, L, Lc, T)
    assert np.abs(tf - jf).max() <= bar
    assert np.abs(te - je).max() <= bar
    for a, b in zip(ts, js):
        assert np.isfinite(a).all() and np.abs(a - b).max() <= bar


@pytest.mark.parametrize("cross_kv_dtype", ["auto", "int8"])
def test_multi_token_cached_step_matches_jax(cross_kv_dtype):
    """A 3-token step over a filled cache (not a prompt prefill): the
    self-attention's tail mask with L > 1 and the multi-token branch of
    the cached cross-attention. Measured max 5.4e-7 for both cross caches."""
    kw = {**TINY, **INT8, "cross_kv_dtype": cross_kv_dtype}
    jc, tc, pj, pt, _ = _params(kw, seed=4)
    B, L, Lc, T = 4, 8, 8, 16
    x = _inputs(np.random.default_rng(4), B, L, Lc, T, 0, kw["vocab_size"], ragged=True)
    x["cap_mask"][0] = 1.0
    x["steps"] = np.zeros((0, B, 1), np.int64)
    nxt = np.random.default_rng(5).integers(0, 256, (B, 3))
    outs = []
    for side, params, cfg, arr, mod in (("jax", pj, jc, jnp.asarray, jg),
                                        ("torch", pt, tc, torch.as_tensor, tg)):
        cache = mod.init_kv_cache(cfg, B, T, caption_len=Lc,
                                  **({} if side == "jax" else {"device": "cpu"}))
        mask = x["mask"].copy()
        with torch.inference_mode():
            o = mod.forward(params, cfg, arr(x["ids"]), position_ids=arr(x["pos"]),
                            attention_mask=arr(mask), caption_ids=arr(x["caps"]),
                            encoder_attention_mask=arr(x["cap_mask"]), cache=cache,
                            prefix_prefill=True, compute_logits="last")
            mask[:, L:L + 3] = 1.0
            o = mod.forward(params, cfg, arr(nxt),
                            position_ids=arr(x["row_len"][:, None] + np.arange(3)),
                            attention_mask=arr(mask), encoder_attention_mask=arr(x["cap_mask"]),
                            cache=o.cache)
        outs.append(np.asarray(o.logits))
    assert np.abs(outs[0] - outs[1]).max() <= 1e-3


def test_long_cache_int8_decode_matches_jax():
    """T >= 512 decode takes the scale-factored int8 branch on both sides
    (small batch: plain prefill attention). Measured max 6.0e-7."""
    kw = {**TINY, **INT8}
    jc, tc, pj, pt, _ = _params(kw, seed=2)
    B, L, Lc, steps, T = 2, 8, 8, 2, 512
    x = _inputs(np.random.default_rng(2), B, L, Lc, T, steps, kw["vocab_size"], ragged=True)
    x["cap_mask"][:] = 1.0
    jf, je, js = _run("jax", pj, jc, x, B, L, Lc, T)
    tf, te, ts = _run("torch", pt, tc, x, B, L, Lc, T)
    assert np.abs(tf - jf).max() <= 1e-3
    for a, b in zip(ts, js):
        assert np.abs(a - b).max() <= 1e-3


def test_uncached_forward_matches_jax():
    """The no-cache forward (full logits, cross-attention over caption
    embeddings, token types) without a mask: modality injection at slots
    0 and 1."""
    jc, tc, pj, pt, _ = _params(TINY, seed=3)
    rng = np.random.default_rng(3)
    ids, tts = rng.integers(0, 256, (2, 12)), rng.integers(0, 256, (2, 12))
    imgs, auds = (rng.standard_normal((2, 768)).astype(np.float32) for _ in range(2))
    caps = rng.integers(0, 256, (2, 6))
    jo = jg.forward(pj, jc, jnp.asarray(ids), token_type_ids=jnp.asarray(tts),
                    imgs=jnp.asarray(imgs), auds=jnp.asarray(auds), caption_ids=jnp.asarray(caps))
    with torch.inference_mode():
        to = pt(torch.as_tensor(ids), token_type_ids=torch.as_tensor(tts),  # GPT2.__call__
                imgs=torch.as_tensor(imgs), auds=torch.as_tensor(auds),
                caption_ids=torch.as_tensor(caps))
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(to.emotion_logits.numpy(), np.asarray(jo.emotion_logits),
                               atol=1e-4, rtol=0)


def test_init_params_shapes_and_stats():
    """init_params: JAX's shapes, zero biases, unit LN scales, N(0, 0.02)
    kernels and N(0, 0.02/sqrt(2 L)) residual projections."""
    kw = {**TINY, "vocab_size": 2048}
    cfg = ModelConfig(**kw)
    model = tg.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu").requires_grad_(False)
    tree = jax.tree_util.tree_map(np.asarray, jg.init_params(jax.random.PRNGKey(0),
                                                             JaxConfig(**kw)))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    # params_from_numpy loads strictly: JAX's leaves must fill exactly these shapes
    want = {k: tuple(v.shape)
            for k, v in params_from_numpy(tree, cfg, device="cpu").state_dict().items()}
    assert got == want
    assert float(model.blocks[1].mlp.c_fc.bias.abs().max()) == 0.0
    assert float(model.blocks[0].ln_2.scale.min()) == 1.0
    assert abs(float(model.wte.embedding.std()) - 0.02) < 1e-3
    assert abs(float(model.blocks[0].mlp.c_proj.kernel.std()) - 0.01) < 1e-3
