"""Port parity: ergm_tpu_torch.infer.generate against ergm_tpu.infer.generate.

The sampler is compared token for token with JAX's own Gumbel draws
injected. The slice as a whole (the serving config: int8 KV and cross
caches, int8 lm_head; fp32 on the CPU) is compared teacher-forced: JAX's
greedy tokens are fed step by step through both packages with
generate's positions, sp2 token types and masks, and the port's argmax
must equal JAX's token wherever JAX's top-2 logit margin exceeds 1e-3.
Random-init margins can be near zero, and teacher forcing keeps one such
flip from derailing the rest.
"""
import functools
import os
import subprocess
import sys

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
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = dict(n_layer=2, n_embd=128, n_head=2, vocab_size=256, n_positions=64,
             modality_dim=768, dtype="float32", kv_cache_dtype="int8",
             cross_kv_dtype="int8", weight_dtype="int8_lm_head")
EOS, SP2 = 7, 5
MARGIN = 1e-3


@pytest.fixture(scope="module")
def models():
    jc, tc = JaxConfig(**SLICE), ModelConfig(**SLICE)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jg.init_params(jax.random.PRNGKey(0), jc))
    pj = jg.params_for_inference(jax.tree_util.tree_map(jnp.asarray, tree), jc)
    pt = tg.params_for_inference(params_from_numpy(tree, tc, device="cpu"), tc)
    return jc, tc, pj, pt


@pytest.mark.parametrize("top_p,k", [(0.5, 8), (0.8, 64), (0.95, 256)])
def test_sample_top_p_matches_jax_with_injected_gumbel(top_p, k):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((32, 256)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(k)
    want = jgen.sample_top_p(jnp.asarray(logits), key, top_p, top_k=k, approx=False)
    # jax.random.categorical draws exactly these (B, k) Gumbels from `key`
    g = np.array(jax.random.gumbel(key, (32, k)))
    got = tgen.sample_top_p(torch.from_numpy(logits), None, top_p, top_k=k,
                            gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_p_filter_matches_jax():
    rng = np.random.default_rng(2)
    probs = np.array(jax.nn.softmax(jnp.asarray(rng.standard_normal((8, 256)) * 2), -1),
                     np.float32)
    want = jgen.top_p_filter(jnp.asarray(probs), 0.8)
    got = tgen.top_p_filter(torch.from_numpy(probs), 0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_forward(cfg):
    return jax.jit(lambda p, **kw: jg.forward(p, cfg, **kw),
                   static_argnames=("prefix_prefill", "compute_logits"))


def _replay(side, params, cfg, ids, prompt_mask, tts, imgs, auds, caps, cap_mask,
            tokens, max_len):
    """generate()'s prefill and decode loop (ergm_tpu/infer/generate.py:
    156-235) with the token at slot s forced to ``tokens[:, s]``. Returns
    {slot: [B, V] logits that predict that slot}."""
    if side == "jax":
        arr, fwd = jnp.asarray, _jax_forward(cfg)
        cache = jg.init_kv_cache(cfg, ids.shape[0], max_len, caption_len=caps.shape[1])
    else:
        arr = torch.as_tensor

        def fwd(p, **kw):
            with torch.inference_mode():
                return tg.forward(p, cfg, **kw)
        cache = tg.init_kv_cache(cfg, ids.shape[0], max_len, caption_len=caps.shape[1],
                                 device="cpu")
    B, Lp = ids.shape
    mask = np.zeros((B, max_len), np.float32)
    mask[:, :Lp] = prompt_mask
    pos = np.maximum(np.cumsum(prompt_mask, -1) - 1, 0).astype(np.int64)
    row_len = prompt_mask.sum(-1).astype(np.int64)
    opt = lambda x: None if x is None else arr(x)  # noqa: E731
    o = fwd(params, input_ids=arr(ids), token_type_ids=opt(tts), position_ids=arr(pos),
            attention_mask=arr(mask), imgs=arr(imgs), auds=arr(auds), caption_ids=arr(caps),
            encoder_attention_mask=opt(cap_mask), cache=cache, prefix_prefill=True,
            compute_logits="last")
    out = {Lp: np.asarray(o.logits[:, -1])}
    mask[:, Lp] = 1.0
    for cur in range(Lp + 1, max_len):
        step_pos = np.minimum(row_len + (cur - 1 - Lp), cfg.n_positions - 1)[:, None]
        o = fwd(params, input_ids=arr(tokens[:, cur - 1:cur].astype(np.int64)),
                token_type_ids=arr(np.full((B, 1), SP2)), position_ids=arr(step_pos),
                attention_mask=arr(mask), encoder_attention_mask=opt(cap_mask), cache=o.cache)
        out[cur] = np.asarray(o.logits[:, -1])
        mask[:, cur] = 1.0
    return out


def _margin(logits):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _check_tokens(want, got, jax_logits, Lp, lengths):
    """``got`` equals ``want`` on each row up to the row's first slot whose
    JAX margin is at most MARGIN; with no such slot, through the row's end."""
    for b in range(want.shape[0]):
        for s in range(Lp, lengths[b]):
            if _margin(jax_logits[s][b:b + 1])[0] <= MARGIN:
                break
            assert got[b, s] == want[b, s], (b, s)
        else:
            assert (got[b, Lp:lengths[b]] == want[b, Lp:lengths[b]]).all(), b


def test_generate_slice_teacher_forced_matches_jax(models):
    """The serving slice at B=64 (K1's route on both sides): a uniform
    128-style prompt, image and audio features, a caption, greedy."""
    jc, tc, pj, pt = models
    B, Lp, Lc, new = 64, 16, 8, 8
    max_len = Lp + new
    rng = np.random.default_rng(3)
    ids, tts = rng.integers(0, 256, (B, Lp)), rng.integers(0, 256, (B, Lp))
    imgs, auds = (rng.standard_normal((B, 768)).astype(np.float32) for _ in range(2))
    caps = rng.integers(0, 256, (B, Lc))
    jout = jax.jit(lambda p: jgen.generate(
        p, jc, jnp.asarray(ids), Lp, max_len=max_len, eos_id=EOS, sp2_id=SP2,
        token_type_ids=jnp.asarray(tts), imgs=jnp.asarray(imgs), auds=jnp.asarray(auds),
        caption_ids=jnp.asarray(caps), greedy=True))(pj)
    jtok, jlen = np.asarray(jout.tokens), np.asarray(jout.lengths)

    args = (ids, np.ones((B, Lp), np.float32), tts, imgs, auds, caps, None, jtok, max_len)
    jl = _replay("jax", pj, jc, *args)
    tl = _replay("torch", pt, tc, *args)
    compared = 0
    for s in range(Lp, max_len):
        live = (s < jlen) & (_margin(jl[s]) > MARGIN)  # rows still sampling at slot s
        assert (jl[s].argmax(-1)[live] == jtok[live, s]).all()  # the replay is generate's
        assert (tl[s].argmax(-1)[live] == jtok[live, s]).all()
        compared += int(live.sum())
    assert compared >= 0.9 * B * new  # measured: 511 of 512 (row, slot) pairs

    tout = tgen.generate(pt, tc, torch.as_tensor(ids), Lp, max_len=max_len, eos_id=EOS,
                         sp2_id=SP2, token_type_ids=torch.as_tensor(tts),
                         imgs=torch.as_tensor(imgs), auds=torch.as_tensor(auds),
                         caption_ids=torch.as_tensor(caps), greedy=True)
    _check_tokens(jtok, tout.tokens.numpy(), jl, Lp, jlen)
    np.testing.assert_allclose(tout.emotion_logits.numpy(), np.asarray(jout.emotion_logits),
                               atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def ragged():
    """Eight ragged requests with token types, caption-less rows, image
    and audio features."""
    rng = np.random.default_rng(4)
    B = 8
    prompts = [rng.integers(8, 256, int(n)).tolist() for n in rng.integers(3, 21, B)]
    return dict(
        prompts=prompts,
        token_types=[rng.integers(0, 256, len(p)).tolist() for p in prompts],
        captions=[None if b % 3 == 1 else rng.integers(8, 256, int(rng.integers(2, 9))).tolist()
                  for b in range(B)],
        imgs=rng.standard_normal((B, 768)).astype(np.float32),
        auds=rng.standard_normal((B, 768)).astype(np.float32))


def _pack(req, max_len):
    return jgen.pack_ragged_batch(
        req["prompts"], eos_id=EOS, sp2_id=SP2, n_positions=SLICE["n_positions"],
        max_len=max_len, token_types=req["token_types"], captions=req["captions"],
        prompt_bucket=16, caption_bucket=8, max_new_tokens=6)


def _batch_replay(pj, jc, req, results, max_len):
    """JAX's logits along ``results``' tokens, with the packed batch's
    layout. Returns (buffer [B, T], logits by slot, Lp, row ends)."""
    ids, mask, tts, cap_ids, cap_mask, buffer_len = _pack(req, max_len)
    Lp = ids.shape[1]
    buf = np.full((len(results), buffer_len), EOS, np.int64)
    for b, r in enumerate(results):
        buf[b, Lp:Lp + len(r)] = r
    jl = _replay("jax", pj, jc, ids, mask, tts, req["imgs"], req["auds"], cap_ids, cap_mask,
                 buf, buffer_len)
    return buf, jl, Lp, np.array([Lp + len(r) for r in results])


# max_len=24 caps the longest rows' logical length below the buffer:
# their last slots are forced eos on both sides
@pytest.mark.parametrize("max_len", [64, 24])
def test_generate_batch_ragged_matches_jax(models, ragged, max_len):
    """Greedy ragged batch: same lengths, same tokens under the margin rule."""
    jc, tc, pj, pt = models
    kw = dict(max_len=max_len, eos_id=EOS, sp2_id=SP2, token_types=ragged["token_types"],
              imgs=ragged["imgs"], auds=ragged["auds"], captions=ragged["captions"],
              greedy=True, prompt_bucket=16, caption_bucket=8, max_new_tokens=6)
    jres, jemo = jgen.generate_batch(pj, jc, ragged["prompts"], **kw)
    tres, temo = tgen.generate_batch(pt, tc, ragged["prompts"], **kw)
    assert [len(r) for r in tres] == [len(r) for r in jres]
    np.testing.assert_allclose(temo, jemo, atol=1e-3, rtol=0)
    want, jl, Lp, ends = _batch_replay(pj, jc, ragged, jres, max_len)
    got = want.copy()
    for b, r in enumerate(tres):
        got[b, Lp:Lp + len(r)] = r
    _check_tokens(want, got, jl, Lp, ends)


@pytest.mark.parametrize("sample_top_k,temperature", [(64, 1.0), (0, 1.0), (64, 0.7)])
def test_sampled_tokens_lie_in_jax_nucleus(models, ragged, sample_top_k, temperature):
    """The RNG streams differ, so sampled output is checked by what it
    must satisfy: a fixed generator repeats its draw, and each sampled
    token lies in the top-p nucleus (within the top-k) of JAX's tempered
    distribution along the same tokens."""
    jc, tc, pj, pt = models
    ids, mask, tts, cap_ids, cap_mask, buffer_len = _pack(ragged, 64)
    t = torch.as_tensor
    outs = [tgen.generate(
        pt, tc, t(ids).long(), prompt_mask=t(mask), max_len=buffer_len, eos_id=EOS,
        sp2_id=SP2, top_p=0.8, generator=torch.Generator().manual_seed(3),
        token_type_ids=t(tts).long(), imgs=t(ragged["imgs"]), auds=t(ragged["auds"]),
        caption_ids=t(cap_ids).long(), caption_mask=t(cap_mask), temperature=temperature,
        logical_cap=64, sample_top_k=sample_top_k) for _ in range(2)]
    assert torch.equal(outs[0].tokens, outs[1].tokens)
    tok, lengths = outs[0].tokens.numpy(), outs[0].lengths.numpy()
    Lp = ids.shape[1]
    _, jl, _, _ = _batch_replay(pj, jc, ragged, [tok[b, Lp:lengths[b]].tolist()
                                                for b in range(len(tok))], 64)
    checked = 0
    for b in range(len(tok)):
        for s in range(Lp, lengths[b]):
            logits = jl[s][b].astype(np.float64) / temperature
            order = np.argsort(-logits)
            probs = np.exp(logits[order] - logits.max())
            probs /= probs.sum()
            keep = np.cumsum(probs) - probs <= 0.8 + 1e-4  # mass ranked above; first kept
            if sample_top_k:
                keep[sample_top_k:] = False
            assert tok[b, s] in set(order[keep].tolist()), (b, s)
            checked += 1
    assert checked >= 3 * len(tok)


def test_port_imports_no_jax():
    """The port never loads JAX (checked in a fresh interpreter: this
    process has JAX loaded by the test setup)."""
    code = ("import sys, ergm_tpu_torch, ergm_tpu_torch.models.gpt2, "
            "ergm_tpu_torch.models.convert, ergm_tpu_torch.infer.generate, "
            "ergm_tpu_torch.infer.speculative, ergm_tpu_torch.infer.beam, "
            "ergm_tpu_torch.ops.prefill_attention; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ergm_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
