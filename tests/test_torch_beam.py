"""Port parity: ergm_tpu_torch.infer.beam against ergm_tpu.infer.beam.

Beam-1 equals greedy and a beam as wide as the vocabulary finds the
brute-force optimum at horizon 2 (port against port). Against JAX, the
best hypothesis of each row (tokens and length) must equal JAX's under a
margin rule: a row is compared when every decision it went through was
taken by a candidate gap above 1e-3 (the gap between the W-th and the
(W+1)-th candidate score at each step, and between the best and the
second final score), and reported otherwise. The gaps are read on the
port's side, whose fp32 scores are JAX's to ~1e-5. Emotion logits equal
JAX's within 1e-4.
"""
import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.infer import beam as jbeam
from ergm_tpu.models import gpt2 as jg
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.infer import beam
from ergm_tpu_torch.infer.generate import generate
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.models.convert import params_from_numpy
from test_torch_generate import EOS, SLICE, SP2

torch.set_num_threads(1)
T = torch.as_tensor
MARGIN = 1e-3
TINY = dict(vocab_size=16, n_positions=32, n_embd=16, n_layer=2, n_head=2,
            use_cross_attention=False, dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
            resid_pdrop=0.0)
TINY_EOS, TINY_SP2 = 15, 3


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(**TINY)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jg.init_params(jax.random.PRNGKey(42), JaxConfig(**TINY)))
    return cfg, params_from_numpy(tree, cfg, device="cpu")


def _tt(ids):
    return torch.zeros_like(ids)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_beam1_equals_greedy(tiny, kv):
    """One beam is greedy decode, with the int8 cache's scales carried
    through the expand and every reorder."""
    cfg, p = tiny
    cfg = cfg.replace(kv_cache_dtype=kv)
    ids = T([[1, 4, 2, 7]])
    g = generate(p, cfg, ids, 4, max_len=9, eos_id=TINY_EOS, sp2_id=TINY_SP2, greedy=True,
                 token_type_ids=_tt(ids))
    out = beam.beam_search(p, cfg, ids, 4, num_beams=1, max_len=9, eos_id=TINY_EOS,
                           sp2_id=TINY_SP2, token_type_ids=_tt(ids))
    assert torch.equal(out.tokens, g.tokens) and int(out.lengths[0]) == int(g.lengths[0])


def test_beam_finds_brute_force_optimum(tiny):
    """num_beams = vocab_size is exhaustive for horizon 2: the winner is
    the enumerated argmax of the summed log-probabilities."""
    cfg, p = tiny
    prompt, Lp, horizon = [2, 9, 5], 3, 2
    ids = T([prompt])
    bo = beam.beam_search(p, cfg, ids, Lp, num_beams=cfg.vocab_size, max_len=Lp + horizon,
                          eos_id=TINY_EOS, sp2_id=TINY_SP2, token_type_ids=_tt(ids),
                          length_penalty=0.0)
    V = cfg.vocab_size
    seqs = np.array(list(itertools.product(range(V), repeat=horizon)))
    full = np.concatenate([np.tile(prompt, (len(seqs), 1)), seqs], axis=1)
    tt = np.concatenate([np.zeros((len(seqs), Lp)), np.full((len(seqs), horizon), TINY_SP2)],
                        axis=1)
    with torch.inference_mode():
        lp = torch.log_softmax(tg.forward(p, cfg, T(full), token_type_ids=T(tt).long()).logits,
                               -1).numpy()
    n = np.arange(len(seqs))
    scores = lp[n, Lp - 1, seqs[:, 0]] + (seqs[:, 0] != TINY_EOS) * lp[n, Lp, seqs[:, 1]]
    best = seqs[np.argmax(scores)].tolist()
    got = bo.tokens[0, Lp:Lp + horizon].tolist()
    n_got = int(bo.lengths[0]) - Lp
    assert got[:n_got] == best[:n_got], (got, best)


def test_top_k_breaks_ties_as_lax_top_k():
    """Frozen beams tie exactly (score + 0 for eos, score - 1e9 for the
    rest): the kept candidates and their order are lax.top_k's."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 5, (6, 4 * 16)).astype(np.float32) - 1e9 * rng.integers(0, 2, (6, 64))
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 4)
    got_v, got_i = beam._top_k(T(x), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_gather_moves_every_self_attention_field():
    """A reorder moves the int8 codes AND their scales of the generated
    slots [lo, hi) to the chosen beams' rows; the prompt slots, the
    unwritten tail and the caption cache stay as they are."""
    cfg = ModelConfig(**SLICE)
    B, W, Tm, lo, hi = 2, 3, 12, 5, 9
    cache = tg.init_kv_cache(cfg, B * W, Tm, caption_len=4, device="cpu")
    g = torch.Generator().manual_seed(0)
    for f in ("k", "v", "k_scale", "v_scale", "ck", "cv", "ck_scale", "cv_scale"):
        x = getattr(cache, f)
        x.copy_(torch.randint(-100, 100, x.shape, generator=g).to(x.dtype))
    before = {f: getattr(cache, f).clone() for f in ("k", "v", "k_scale", "v_scale", "ck", "cv")}
    flat = T([2, 2, 0, 4, 3, 3])
    beam._gather_beams(cache, flat, lo, hi)
    for f, old in before.items():
        new = getattr(cache, f)
        if f.startswith("c"):
            assert torch.equal(new, old), f
            continue
        assert torch.equal(new[:, :, :, lo:hi], old[:, flat][:, :, :, lo:hi]), f
        assert torch.equal(new[:, :, :, :lo], old[:, :, :, :lo]), f
        assert torch.equal(new[:, :, :, hi:], old[:, :, :, hi:]), f


@pytest.fixture(scope="module")
def slice_models():
    """The serving slice at a tiny size (int8 KV and cross caches, int8
    lm_head, fp32), the same weights in both packages."""
    jc, tc = JaxConfig(**SLICE), ModelConfig(**SLICE)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jg.init_params(jax.random.PRNGKey(0), jc))
    pj = jg.params_for_inference(jax.tree_util.tree_map(jnp.asarray, tree), jc)
    pt = tg.params_for_inference(params_from_numpy(tree, tc, device="cpu"), tc)
    return jc, tc, pj, pt


class _Gaps:
    """Records, for each row, the smallest gap of the decisions the port
    takes: W-th against (W+1)-th candidate at every expansion, and best
    against second final score."""

    def __init__(self, monkeypatch, B: int):
        self.min = np.full(B, np.inf)
        real_top_k, real_finish = beam._top_k, beam.beam_finish

        def top_k(x, k):
            vals = torch.sort(x, dim=-1, descending=True).values
            gap = (vals[:, k - 1] - vals[:, k]).numpy()
            self.min = np.minimum(self.min, gap)
            return real_top_k(x, k)

        def finish(s, rows, length_penalty):
            out = real_finish(s, rows, length_penalty)
            stop = (s.tokens == rows.eos_id) & (torch.arange(s.tokens.shape[-1]) >= rows.Lp)
            lengths = torch.where(stop.any(-1), stop.int().argmax(-1) + 1, s.tokens.shape[-1])
            final = s.scores / torch.clamp_min((lengths - rows.Lp).float(), 1.0) ** length_penalty
            top2 = torch.sort(final, dim=-1, descending=True).values[:, :2]
            self.min = np.minimum(self.min, (top2[:, 0] - top2[:, 1]).numpy())
            return out

        monkeypatch.setattr(beam, "_top_k", top_k)
        monkeypatch.setattr(beam, "beam_finish", finish)

    def decided(self) -> np.ndarray:
        return self.min > MARGIN


def _continuations(out, Lp):
    tokens, lengths = np.asarray(out.tokens), np.asarray(out.lengths)
    return [tokens[b, Lp:lengths[b]].tolist() for b in range(len(tokens))]


def _check_rows(gaps, want, got):
    """Rows decided by gaps above MARGIN must continue as JAX's; returns
    their count."""
    decided = gaps.decided()
    for b in np.flatnonzero(~decided):
        print(f"row {b}: decided by a candidate gap of {gaps.min[b]:.2e}; not asserted")
    for b in np.flatnonzero(decided):
        assert got[b] == want[b], b
    return int(decided.sum())


def test_beam_search_matches_jax(slice_models, monkeypatch):
    """Uniform prompts with image and audio features and a caption, int8
    caches, 3 beams, length penalty 1."""
    jc, tc, pj, pt = slice_models
    B, Lp, Lc, new, W = 6, 12, 8, 8, 3
    rng = np.random.default_rng(8)
    ids, tts = rng.integers(0, 256, (B, Lp)), rng.integers(0, 256, (B, Lp))
    imgs, auds = (rng.standard_normal((B, 768)).astype(np.float32) for _ in range(2))
    caps = rng.integers(0, 256, (B, Lc))
    kw = dict(num_beams=W, max_len=Lp + new, eos_id=EOS, sp2_id=SP2)
    jout = jax.jit(lambda p: jbeam.beam_search(
        p, jc, jnp.asarray(ids), Lp, token_type_ids=jnp.asarray(tts), imgs=jnp.asarray(imgs),
        auds=jnp.asarray(auds), caption_ids=jnp.asarray(caps), **kw))(pj)
    gaps = _Gaps(monkeypatch, B)
    tout = beam.beam_search(pt, tc, T(ids), Lp, token_type_ids=T(tts), imgs=T(imgs),
                            auds=T(auds), caption_ids=T(caps), **kw)
    n = _check_rows(gaps, _continuations(jout, Lp), _continuations(tout, Lp))
    assert n >= B // 2, gaps.min
    np.testing.assert_allclose(tout.emotion_logits.numpy(), np.asarray(jout.emotion_logits),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("max_len", [64, 20])
def test_beam_search_batch_ragged_matches_jax(slice_models, monkeypatch, max_len):
    """Eight ragged requests (caption-less rows among them, token types,
    image and audio features), int8 caches, 4 beams; at max_len=20 the
    longest rows reach their logical cap inside the buffer."""
    jc, tc, pj, pt = slice_models
    rng = np.random.default_rng(4)
    B = 8
    prompts = [rng.integers(8, 256, int(n)).tolist() for n in rng.integers(3, 21, B)]
    kw = dict(num_beams=4, max_len=max_len, eos_id=EOS, sp2_id=SP2,
              token_types=[rng.integers(0, 256, len(q)).tolist() for q in prompts],
              captions=[None if b % 3 == 1
                        else rng.integers(8, 256, int(rng.integers(2, 9))).tolist()
                        for b in range(B)],
              imgs=rng.standard_normal((B, 768)).astype(np.float32),
              auds=rng.standard_normal((B, 768)).astype(np.float32),
              max_new_tokens=6, length_penalty=0.8, prompt_bucket=16, caption_bucket=8)
    jres, jemo = jbeam.beam_search_batch(pj, jc, prompts, **kw)
    gaps = _Gaps(monkeypatch, B)
    tres, temo = beam.beam_search_batch(pt, tc, prompts, **kw)
    n = _check_rows(gaps, jres, tres)
    assert n >= B // 2, gaps.min
    np.testing.assert_allclose(temo, jemo, atol=1e-4, rtol=0)
