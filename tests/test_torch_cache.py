"""Port parity for the serving cache forms: int4 storage, per-row cursors
and the staged block decode with ``flush_staging``.

The same numpy-seeded weights (a JAX init, perturbed so biases and
LayerNorm scales are not trivial) and the same cache contents go through
``ergm_tpu.models.gpt2`` and ``ergm_tpu_torch.models.gpt2``, fp32, on the
CPU. Codes are compared bit for bit, logits within 1e-4.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.infer import generate as jgen
from ergm_tpu.models import gpt2 as jg
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.infer import generate as tgen
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.models.convert import params_from_numpy

torch.set_num_threads(1)
TINY = dict(n_layer=2, n_embd=128, n_head=2, vocab_size=256, n_positions=64,
            modality_dim=768, dtype="float32", use_cross_attention=False)
EOS, SP2 = 7, 5
# the rows' cursors: ragged, one at the last slot, one past capacity
B, T = 4, 24
CURSORS = np.array([3, 11, T - 1, T + 5], np.int32)


@functools.lru_cache(maxsize=None)
def _models(kv):
    kw = {**TINY, "kv_cache_dtype": kv}
    jc, tc = JaxConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jg.init_params(jax.random.PRNGKey(0), jc))
    pj = jg.params_for_inference(jax.tree_util.tree_map(jnp.asarray, tree), jc)
    pt = tg.params_for_inference(params_from_numpy(tree, tc, device="cpu"), tc)
    return jc, tc, pj, pt


def _filled_caches(jc, tc, seed):
    """A JAX and a port cache with per-row cursors ``CURSORS`` holding the
    same random contents (random codes and scales when quantized)."""
    rng = np.random.default_rng(seed)
    jcache = jg.init_kv_cache(jc, B, T, per_row_index=True)
    tcache = tg.init_kv_cache(tc, B, T, device="cpu", per_row_index=True)
    fields = {}
    for f in ("k", "v", "k_scale", "v_scale"):
        x = getattr(jcache, f)
        if x is None:
            continue
        if x.dtype == jnp.int8:
            lim = 7 if jc.kv_cache_dtype == "int4" else 127
            val = rng.integers(-lim, lim + 1, x.shape).astype(np.int8)
            if jc.kv_cache_dtype == "int4":  # random packed codes
                val = np.asarray(jg._pack_int4(jnp.asarray(
                    rng.integers(-7, 8, x.shape[:-1] + (2 * x.shape[-1],)).astype(np.int8))))
        elif f.endswith("scale"):
            val = np.asarray(jnp.asarray(rng.uniform(0.01, 0.1, x.shape), jnp.bfloat16))
        else:
            val = rng.standard_normal(x.shape).astype(np.float32)
        fields[f] = val
        getattr(tcache, f).copy_(torch.from_numpy(np.array(val, np.float32)
                                                  if val.dtype != np.int8 else val))
    jcache = jcache._replace(index=jnp.asarray(CURSORS),
                             **{f: jnp.asarray(v, getattr(jcache, f).dtype)
                                for f, v in fields.items()})
    tcache.index = torch.from_numpy(CURSORS.copy())
    return jcache, tcache


@functools.lru_cache(maxsize=None)
def _jax_step(jc):
    return jax.jit(lambda p, c, ids, pos, si: jg.forward(
        p, jc, ids, token_type_ids=jnp.full_like(ids, SP2), position_ids=pos, cache=c,
        stage_index=si))


def _step_inputs(rng, index):
    ids = rng.integers(0, 256, (B, 1))
    pos = np.minimum(np.asarray(index), TINY["n_positions"] - 1)[:, None]
    return ids, pos


def _torch_step(tc, pt, cache, ids, pos, stage_index=None):
    with torch.inference_mode():
        return tg.forward(pt, tc, torch.as_tensor(ids), token_type_ids=torch.full((B, 1), SP2),
                          position_ids=torch.as_tensor(pos), cache=cache,
                          stage_index=stage_index)


def _assert_cache_equal(jcache, tcache):
    for f in ("k", "v", "k_scale", "v_scale"):
        j, t = getattr(jcache, f), getattr(tcache, f)
        if j is None:
            assert t is None
            continue
        j = np.asarray(j, np.float32) if j.dtype != jnp.int8 else np.asarray(j)
        t = t.float().numpy() if t.dtype != torch.int8 else t.numpy()
        if t.dtype == np.int8:
            np.testing.assert_array_equal(t, j, err_msg=f)
        else:
            np.testing.assert_allclose(t, j, atol=1e-6, rtol=0, err_msg=f)


def test_int4_pack_unpack_matches_jax_on_every_pair():
    """All 225 pairs of codes in [-7, 7] pack to JAX's byte and unpack to
    the pair (the low nibble holds the first half of the row)."""
    q = np.arange(-7, 8, dtype=np.int8)
    pairs = np.stack(np.meshgrid(q, q, indexing="ij"), -1).reshape(-1, 2)
    jp = np.asarray(jg._pack_int4(jnp.asarray(pairs)))
    tp = tg._pack_int4(torch.from_numpy(pairs))
    assert tp.dtype == torch.int8 and tp.shape == (225, 1)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tg._unpack_int4(tp).numpy(), pairs)
    np.testing.assert_array_equal(np.asarray(jg._unpack_int4(jnp.asarray(jp))), pairs)


def test_quantize_kv_int4_matches_jax():
    """4-bit codes (packed) and bf16 scales equal JAX's bit for bit,
    including an all-zero row and half-way rounding cases."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 5, 64)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0
    x[1, 1, 1, :4] = [7.0, 0.5, -0.5, 2.5]  # scale 1: codes on the .5 edges
    jq, js = jg._quantize_kv(jnp.asarray(x), 4)
    tq, ts = tg._quantize_kv(torch.from_numpy(x), 4)
    assert tq.shape == (3, 4, 5, 32) and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, np.float32))


def test_per_row_cursor_step_matches_jax():
    """One single-token step under per-row cursors on a compute-dtype
    cache (a quantized one decodes staged): row b writes at index[b] (the
    row past capacity writes nowhere) and sees kpos <= index[b]. Logits
    within 1e-4 of JAX's; the caches, every other slot untouched, equal
    JAX's."""
    jc, tc, pj, pt = _models("auto")
    jcache, tcache = _filled_caches(jc, tc, seed=2)
    before = {f: getattr(tcache, f).clone() for f in ("k", "v")}
    ids, pos = _step_inputs(np.random.default_rng(3), CURSORS)
    jo = _jax_step(jc)(pj, jcache, jnp.asarray(ids), jnp.asarray(pos), None)
    to = _torch_step(tc, pt, tcache, ids, pos)
    assert np.abs(to.logits.numpy() - np.asarray(jo.logits)).max() <= 1e-4
    np.testing.assert_array_equal(to.cache.index.numpy(), CURSORS + 1)
    _assert_cache_equal(jo.cache, tcache)
    # every row inside capacity wrote in every layer; the row past it nowhere
    for f, old in before.items():
        changed = (getattr(tcache, f) != old).flatten(2, 4).any(-1)  # [L, B]
        assert changed[:, :3].all() and not changed[:, 3].any()


@pytest.mark.parametrize("kv,staged", [("int8", False), ("auto", True)])
def test_per_row_step_refuses_unserved_forms(kv, staged):
    """Under per-row cursors a quantized cache decodes staged and a
    compute-dtype cache per step; the other two forms raise."""
    jc, tc, pj, pt = _models(kv)
    _, tcache = _filled_caches(jc, tc, seed=2)
    if staged:
        shape = (jc.n_layer, B, jc.n_head, 4, jc.head_dim)
        tcache.sk, tcache.sv = torch.zeros(shape), torch.zeros(shape)
    ids, pos = _step_inputs(np.random.default_rng(3), CURSORS)
    with pytest.raises(ValueError, match="decodes staged"):
        _torch_step(tc, pt, tcache, ids, pos, stage_index=0 if staged else None)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_staged_block_and_flush_match_jax(kv):
    """A staged block of K=4 steps (writes at the uniform step index, the
    split softmax over the flushed prefix and the staging tail, the
    quantize-dequantize round trip of the tail), then ``flush_staging``:
    each step's logits within 1e-4 of JAX's, and the committed codes and
    scales equal JAX's bit for bit, the writes of the row that runs past
    capacity dropped."""
    jc, tc, pj, pt = _models(kv)
    jcache, tcache = _filled_caches(jc, tc, seed=4)
    K = 4
    start = np.array([3, 11, T - 2, T + 5], np.int32)  # row 2 straddles the end
    jcache = jcache._replace(index=jnp.asarray(start))
    tcache.index = torch.from_numpy(start.copy())
    shape = (jc.n_layer, B, jc.n_head, K, jc.head_dim)
    jcache = jcache._replace(sk=jnp.zeros(shape), sv=jnp.zeros(shape))
    tcache.sk, tcache.sv = torch.zeros(shape), torch.zeros(shape)
    rng = np.random.default_rng(5)
    for i in range(K):
        ids, pos = _step_inputs(rng, start + i)
        jo = _jax_step(jc)(pj, jcache, jnp.asarray(ids), jnp.asarray(pos), jnp.int32(i))
        to = _torch_step(tc, pt, tcache, ids, pos, stage_index=i)
        assert np.abs(to.logits.numpy() - np.asarray(jo.logits)).max() <= 1e-4, i
        jcache, tcache = jo.cache, to.cache
    np.testing.assert_allclose(tcache.sk.numpy(), np.asarray(jcache.sk), atol=1e-6, rtol=0)
    _assert_cache_equal(jcache, tcache)  # the steps wrote the staging buffers only
    # the flush from the same staged values (the two forwards' values differ
    # by ~1e-7, which can move a code at a rounding edge)
    tcache.sk, tcache.sv = (torch.from_numpy(np.array(x)) for x in (jcache.sk, jcache.sv))
    jflushed = jax.jit(lambda c: jg.flush_staging(c, K, jc))(jcache)
    with torch.inference_mode():
        tflushed = tg.flush_staging(tcache, K, tc)
    assert tflushed.sk is None and jflushed.sk is None
    _assert_cache_equal(jflushed, tflushed)


@pytest.mark.parametrize("T_cache", [40, 512])
def test_int4_generate_matches_jax(T_cache):
    """Greedy ``generate`` over an int4 cache equals JAX's token for token:
    the quantized prefill write and the dequantize-then-attend branch, and
    at T=512 the scale-factored branch (K2's gate declines int4)."""
    jc, tc, pj, pt = _models("int4")
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 256, (2, 9))
    jo = jgen.generate(pj, jc, jnp.asarray(ids), 9, max_len=T_cache, eos_id=EOS, sp2_id=SP2,
                       greedy=True, logical_cap=9 + 12, rng=jax.random.PRNGKey(0))
    to = tgen.generate(pt, tc, torch.as_tensor(ids), 9, max_len=T_cache, eos_id=EOS,
                       sp2_id=SP2, greedy=True, logical_cap=9 + 12)
    n = 9 + 12
    np.testing.assert_array_equal(to.tokens[:, :n].numpy(), np.asarray(jo.tokens)[:, :n])
