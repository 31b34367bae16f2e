"""The port's multi-token steps under per-row cursors and the server
features built on them: session continuation, chunked prefill and
speculative serving (``ergm_tpu_torch/models/gpt2.py``,
``ergm_tpu_torch/infer/server.py``).

The per-row forward is held to ``ergm_tpu``'s on the same numpy-seeded
weights and cache contents (logits, and the written cache bytes, on
compute-dtype, int8 and int4 caches). The server's greedy tokens are held
to the port's ``generate`` on the full prompt (the counterparts of
``ergm_tpu``'s tests/test_server.py), and, once per feature, to
``ergm_tpu``'s server on the same weights. A tiny fp32 model on the CPU.
"""
import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.infer import server as jserver
from ergm_tpu.models import gpt2 as jg
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.infer.server import ContinuousServer, Request
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.models.convert import params_from_numpy

from test_torch_cache import (B, CURSORS, TINY, _assert_cache_equal, _filled_caches,
                              _models)
from test_torch_server import EOS, SP2, VOCAB, _params, make_cfg, oracle_greedy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = make_cfg()
    return cfg, _params(cfg)


def server(params, cfg, **kw):
    base = dict(slots=2, eos_id=EOS, sp2_id=SP2, max_prompt=32, prompt_bucket=16,
                sync_every=3)
    base.update(kw)
    return ContinuousServer(params, cfg, **base)


def _rand(rng, n):
    return rng.integers(0, 50, (n,)).tolist()


def _greedy(srv, prompt, n, **kw):
    """Submit one greedy request, drain, return its Result."""
    rid = srv.submit(Request(prompt_ids=prompt, max_new_tokens=n, greedy=True, **kw))
    return srv.run_until_drained()[rid]


# --- the per-row multi-token forward ------------------------------------------


@pytest.mark.parametrize("kv", ["auto", "int8", "int4"])
def test_per_row_multi_token_step_matches_jax(kv):
    """A 5-token step under per-row cursors (the verify window and the
    extension's form): row b writes at [index[b], index[b] + 5) and query
    j sees kpos <= index[b] + j. The row at T-1 writes T-1 once and drops
    four entries that all land on T-1; the row past capacity writes
    nothing. Logits within 1e-4 of JAX's (1e-3 quantized); the written
    caches equal JAX's (codes and scales bit for bit)."""
    L = 5
    jc, tc, pj, pt = _models(kv)
    jcache, tcache = _filled_caches(jc, tc, seed=2)
    before = {f: getattr(tcache, f).clone() for f in ("k", "v")}
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 256, (B, L))
    pos = np.minimum(CURSORS[:, None] + np.arange(L)[None, :], TINY["n_positions"] - 1)
    jo = jax.jit(lambda p, c, i, ps: jg.forward(p, jc, i, token_type_ids=jnp.full_like(i, SP2),
                                                position_ids=ps, cache=c))(
        pj, jcache, jnp.asarray(ids), jnp.asarray(pos))
    with torch.inference_mode():
        to = gpt2.forward(pt, tc, torch.as_tensor(ids), token_type_ids=torch.full((B, L), SP2),
                          position_ids=torch.as_tensor(pos), cache=tcache)
    tol = 1e-4 if kv == "auto" else 1e-3
    assert np.abs(to.logits.numpy() - np.asarray(jo.logits)).max() <= tol
    np.testing.assert_array_equal(to.cache.index.numpy(), CURSORS + L)
    _assert_cache_equal(jo.cache, tcache)
    T = tcache.k.shape[3]
    for f, old in before.items():
        new = getattr(tcache, f)
        changed = (new != old).any(-1).any(2)  # [layers, B, T]
        for b, cur in enumerate(CURSORS):
            want = torch.zeros(T, dtype=torch.bool)
            want[min(cur, T):min(cur + L, T)] = True
            assert torch.equal(changed[:, b], want.expand_as(changed[:, b])), (f, b)


def test_per_row_step_refuses_a_staged_window():
    """A quantized cache stages single-token steps only: a multi-token
    step with staging buffers set raises."""
    jc, tc, pj, pt = _models("int8")
    _, tcache = _filled_caches(jc, tc, seed=2)
    shape = (tc.n_layer, B, tc.n_head, 4, tc.head_dim)
    tcache.sk, tcache.sv = torch.zeros(shape), torch.zeros(shape)
    with pytest.raises(ValueError, match="decodes staged"), torch.inference_mode():
        gpt2.forward(pt, tc, torch.zeros((B, 3), dtype=torch.long), cache=tcache, stage_index=0)


# --- sessions -----------------------------------------------------------------


def test_session_continuation_matches_full_prefill(setup):
    """Turn 2 sends the whole dialogue with the same session_id: only the
    delta prefills against the parked slot's K/V, and the tokens and
    emotion logits equal a full-prompt ``generate``'s; turn 3's history
    exceeds max_prompt and still admits (only the delta prefills)."""
    cfg, params = setup
    rng = np.random.default_rng(21)
    srv = server(params, cfg)
    p1 = _rand(rng, 11)
    res1 = _greedy(srv, p1, 8, session_id="alice")
    assert srv.slots[srv.sessions["alice"]].parked
    p2 = p1 + res1.tokens + _rand(rng, 7)
    res2 = _greedy(srv, p2, 8, session_id="alice")
    assert "admit_ext" in srv.phase_seconds and srv.ext_programs == 1
    want, emo = oracle_greedy(params, cfg, p2, 8)
    assert res2.tokens == want
    np.testing.assert_allclose(res2.emotion_logits, emo, atol=1e-3)
    p3 = p2 + res2.tokens + _rand(rng, 5)
    assert len(p3) > 32
    assert _greedy(srv, p3, 6, session_id="alice").tokens == oracle_greedy(params, cfg, p3, 6)[0]


def test_session_prefix_mismatch_falls_back(setup):
    """A prompt that left the parked history does not reuse its K/V: the
    parked slot is freed, the prompt full-prefills, and the session parks
    again with the new history."""
    cfg, params = setup
    rng = np.random.default_rng(22)
    srv = server(params, cfg)
    _greedy(srv, _rand(rng, 9), 6, session_id="bob")
    p2 = _rand(rng, 13)
    res2 = _greedy(srv, p2, 6, session_id="bob")
    assert res2.tokens == oracle_greedy(params, cfg, p2, 6)[0] and srv.ext_programs == 0
    assert srv.slots[srv.sessions["bob"]].token_log == p2 + res2.tokens


def test_session_eviction_under_slot_pressure(setup):
    """Fresh traffic evicts a parked session (LRU); the evicted session's
    next turn full-prefills and stays exact."""
    cfg, params = setup
    rng = np.random.default_rng(23)
    srv = server(params, cfg)
    p1 = _rand(rng, 8)
    res1 = _greedy(srv, p1, 6, session_id="carol")
    for _ in range(4):
        srv.submit(Request(prompt_ids=_rand(rng, 7), max_new_tokens=6, greedy=True))
    srv.run_until_drained()
    assert "carol" not in srv.sessions
    p2 = p1 + res1.tokens + _rand(rng, 4)
    assert _greedy(srv, p2, 6, session_id="carol").tokens == oracle_greedy(params, cfg, p2, 6)[0]


def test_logprobs_session_extension(setup):
    """The extension carries the first token's logprob: every emitted
    token's logprob equals a plain forward's log-softmax."""
    cfg, params = setup
    rng = np.random.default_rng(37)
    srv = server(params, cfg)
    p1 = _rand(rng, 10)
    res1 = _greedy(srv, p1, 5, session_id="lp")
    p2 = p1 + res1.tokens + _rand(rng, 4)
    res2 = _greedy(srv, p2, 5, session_id="lp", logprobs=True)
    assert srv.ext_programs == 1
    toks, lps = res2.tokens, res2.logprobs
    assert toks == oracle_greedy(params, cfg, p2, 5)[0] and len(lps) == len(toks)
    seq = torch.tensor([p2 + toks])
    with torch.inference_mode():
        lsm = torch.log_softmax(gpt2.forward(params, cfg, seq, token_type_ids=torch.full_like(
            seq, SP2)).logits[0].float(), dim=-1)
    for k, t in enumerate(toks):
        assert abs(lps[k] - float(lsm[len(p2) - 1 + k, t])) < 1e-3, k


def test_tiered_pool_hint_and_sessions(setup):
    """pool='long' pins a short first turn into the long pool (int8 staged
    under kv_cache_dtype='auto'); its continuation extends there, writing
    the int8 cache directly while the pool's decode blocks stage, and its
    tokens equal ``generate``'s on an int8 cache. A short-pool session
    beside it stays exact on the compute-dtype cache."""
    cfg, params = setup
    rng = np.random.default_rng(32)
    srv = server(params, cfg, slots=3, max_prompt=96, sync_every=4, cache_grow_step=16,
                 long_slots=1, long_threshold=48)
    assert [c.kv_cache_dtype for c in srv.gcfgs] == ["auto", "int8"]
    opener, short = _rand(rng, 10), _rand(rng, 7)
    r1 = srv.submit(Request(prompt_ids=opener, max_new_tokens=6, greedy=True, session_id="s",
                            pool="long"))
    r2 = srv.submit(Request(prompt_ids=short, max_new_tokens=6, greedy=True, session_id="t"))
    res = srv.run_until_drained()
    assert srv.slots[2].parked and srv.slots[2].session == "s"
    turn_s = opener + res[r1].tokens + _rand(rng, 8)
    turn_t = short + res[r2].tokens + _rand(rng, 5)
    r1 = srv.submit(Request(prompt_ids=turn_s, max_new_tokens=6, greedy=True, session_id="s"))
    r2 = srv.submit(Request(prompt_ids=turn_t, max_new_tokens=6, greedy=True, session_id="t"))
    res = srv.run_until_drained()
    assert srv.ext_programs == 2
    assert res[r1].tokens == oracle_greedy(params, cfg.replace(kv_cache_dtype="int8"),
                                           turn_s, 6)[0]
    assert res[r2].tokens == oracle_greedy(params, cfg, turn_t, 6)[0]


# --- chunked prefill ------------------------------------------------------------


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_chunked_prefill_matches_generate(setup, pipeline):
    """Long prompts admit in 32-token chunks (chunk 1 through the admission
    group, the rest through extensions), short ones on the normal path,
    in the synchronous and the pipelined order: tokens and emotion logits
    equal ``generate``'s."""
    cfg, params = setup
    rng = np.random.default_rng(30)
    prompts = [_rand(rng, n) for n in (70, 9, 100, 33, 5)]
    srv = server(params, cfg, slots=3 - pipeline, max_prompt=128, prefill_chunk=32,
                 pipeline=pipeline)
    rids = [srv.submit(Request(prompt_ids=p, max_new_tokens=8, greedy=True)) for p in prompts]
    results = srv.run_until_drained()
    for rid, p in zip(rids, prompts):
        want, emo = oracle_greedy(params, cfg, p, 8)
        assert results[rid].tokens == want, len(p)
        np.testing.assert_allclose(results[rid].emotion_logits, emo, atol=1e-3)
    assert srv.ext_programs >= 5


def test_chunked_prefill_interleaves_with_decode(setup):
    """A long prompt arriving while a stream decodes admits one chunk a
    server step; both streams stay exact."""
    cfg, params = setup
    rng = np.random.default_rng(31)
    short, long_p = _rand(rng, 7), _rand(rng, 90)
    srv = server(params, cfg, slots=3, max_prompt=128, prefill_chunk=32)
    r_short = srv.submit(Request(prompt_ids=short, max_new_tokens=20, greedy=True))
    srv.step()
    r_long = srv.submit(Request(prompt_ids=long_p, max_new_tokens=8, greedy=True))
    srv.step()
    assert any(s.prefilling for s in srv.slots) and srv.ext_programs == 0
    srv.step()
    assert any(s.prefilling for s in srv.slots) and srv.ext_programs == 1
    results = srv.run_until_drained()
    assert results[r_short].tokens == oracle_greedy(params, cfg, short, 20)[0]
    assert results[r_long].tokens == oracle_greedy(params, cfg, long_p, 8)[0]
    assert not any(s.prefilling for s in srv.slots)


def test_chunked_prefill_lifts_max_prompt(setup):
    """With chunks, a prompt past max_prompt admits; without, submit
    refuses it."""
    cfg, params = setup
    p = _rand(np.random.default_rng(32), 120)
    with pytest.raises(ValueError, match="max_prompt"):
        server(params, cfg, max_prompt=48).submit(Request(prompt_ids=p))
    srv = server(params, cfg, max_prompt=48, prefill_chunk=32)
    assert _greedy(srv, p, 6).tokens == oracle_greedy(params, cfg, p, 6)[0]


def test_chunked_prefill_trimodal():
    """Chunk 1 carries the image and audio injection and writes the
    caption K/V; later chunks cross-attend to that cache."""
    cfg = make_cfg(use_cross_attention=True)
    params = _params(cfg, seed=1)
    rng = np.random.default_rng(33)
    prompt = _rand(rng, 60)
    img = rng.standard_normal(cfg.modality_dim).astype(np.float32)
    aud = rng.standard_normal(cfg.modality_dim).astype(np.float32)
    caps = _rand(rng, 6)
    srv = server(params, cfg, max_prompt=96, caption_len=8, prefill_chunk=32)
    res = _greedy(srv, prompt, 8, img=img, aud=aud, caption_ids=caps)
    cap_ids = torch.full((1, 8), EOS)
    cap_ids[0, :6] = torch.tensor(caps)
    cap_mask = torch.zeros((1, 8))
    cap_mask[0, :6] = 1.0
    want, _ = oracle_greedy(params, cfg, prompt, 8, imgs=torch.from_numpy(img[None]),
                            auds=torch.from_numpy(aud[None]), caption_ids=cap_ids,
                            caption_mask=cap_mask)
    assert res.tokens == want and srv.ext_programs == 1


def test_chunked_session_continuation(setup):
    """A continuation whose delta exceeds the chunk (and max_prompt)
    admits it in chunks against the parked K/V; exact, and parked again."""
    cfg, params = setup
    rng = np.random.default_rng(34)
    srv = server(params, cfg, max_prompt=48, prefill_chunk=32)
    p1 = _rand(rng, 11)
    res1 = _greedy(srv, p1, 6, session_id="erin")
    p2 = p1 + res1.tokens + _rand(rng, 70)
    res2 = _greedy(srv, p2, 8, session_id="erin")
    want, emo = oracle_greedy(params, cfg, p2, 8)
    assert res2.tokens == want and srv.ext_programs == 3
    np.testing.assert_allclose(res2.emotion_logits, emo, atol=1e-3)
    assert srv.slots[srv.sessions["erin"]].parked


def test_busy_covers_chunked_admission(setup):
    """A chunk-prefilling slot is neither active nor queued: ``busy()``
    stays True while chunks are left, and a busy()-gated loop drains."""
    cfg, params = setup
    rng = np.random.default_rng(36)
    short, long_p = _rand(rng, 6), _rand(rng, 110)
    srv = server(params, cfg, max_prompt=128, sync_every=2, prefill_chunk=16)
    r_short = srv.submit(Request(prompt_ids=short, max_new_tokens=2, greedy=True))
    r_long = srv.submit(Request(prompt_ids=long_p, max_new_tokens=4, greedy=True))
    results, chunks_only = {}, False
    for _ in range(200):
        if not srv.busy():
            break
        chunks_only |= bool(srv._chunks and not srv.queue
                            and not any(s.active for s in srv.slots))
        results.update({r.request_id: r for r in srv.step()})
    assert chunks_only and set(results) == {r_short, r_long}
    assert results[r_long].tokens == oracle_greedy(params, cfg, long_p, 4)[0]


def test_cancel_prefilling_slot(setup):
    """``cancel`` of a request mid chunked admission frees its slot."""
    cfg, params = setup
    rng = np.random.default_rng(38)
    keep, chunked = _rand(rng, 9), _rand(rng, 80)
    srv = server(params, cfg, max_prompt=96, prefill_chunk=32)
    r_keep = srv.submit(Request(prompt_ids=keep, max_new_tokens=12, greedy=True))
    srv.step()
    r_chunk = srv.submit(Request(prompt_ids=chunked, max_new_tokens=4, greedy=True))
    srv.step()
    assert srv._chunks and srv.busy()
    assert srv.cancel(r_chunk) and not srv.cancel(r_chunk)
    assert not srv._chunks and not any(s.prefilling for s in srv.slots)
    results = srv.run_until_drained()
    assert set(results) == {r_keep}
    assert results[r_keep].tokens == oracle_greedy(params, cfg, keep, 12)[0]


# --- speculative serving ----------------------------------------------------------


def test_spec_serving_matches_generate(setup):
    """Prompt-lookup drafts verified in one forward a macro step, per-row
    cursor advance: staggered admissions, repetitive prompts (proposals
    accepted) and random ones, and a row whose budget fills the cache,
    equal ``generate``'s tokens and emotion logits."""
    cfg, params = setup
    rng = np.random.default_rng(5)
    rep = _rand(rng, 4) * 5
    prompts = [_rand(rng, n) for n in (5, 11, 17)] + [rep, rep[:12] + rep[:8]]
    srv = server(params, cfg, spec_gamma=4, spec_ngram=3)
    r0 = srv.submit(Request(prompt_ids=prompts[0], max_new_tokens=10, greedy=True))
    srv.step()
    rids = [r0] + [srv.submit(Request(prompt_ids=p, max_new_tokens=10, greedy=True))
                   for p in prompts[1:]]
    results = srv.run_until_drained()
    for rid, p in zip(rids, prompts):
        want, emo = oracle_greedy(params, cfg, p, 10)
        assert results[rid].tokens == want
        np.testing.assert_allclose(results[rid].emotion_logits, emo, atol=1e-4)
    assert srv.spec_accepted > 0 and srv.spec_proposed > 0 and srv.spec_macro > 0
    srv.reset()
    p = _rand(rng, 17)
    budget = cfg.n_positions - 17 + 1
    assert _greedy(srv, p, budget).tokens == oracle_greedy(params, cfg, p, budget)[0]


def test_spec_serving_mixed_sampler_fallback(setup):
    """A sampled row sends blocks to the plain decode (the token buffer
    goes stale); greedy rows stay exact once speculative blocks resume."""
    cfg, params = setup
    rng = np.random.default_rng(9)
    g1, g2 = _rand(rng, 5) * 4, _rand(rng, 13)
    srv = server(params, cfg, sync_every=2, spec_gamma=3, spec_ngram=2)
    ra = srv.submit(Request(prompt_ids=g1, max_new_tokens=12, greedy=True))
    rb = srv.submit(Request(prompt_ids=_rand(rng, 7), max_new_tokens=4, top_p=0.9, seed=3))
    srv.step()
    assert srv.spec_macro == 0
    rc = srv.submit(Request(prompt_ids=g2, max_new_tokens=8, greedy=True))
    results = srv.run_until_drained()
    assert srv.spec_macro > 0
    assert results[ra].tokens == oracle_greedy(params, cfg, g1, 12)[0]
    assert results[rc].tokens == oracle_greedy(params, cfg, g2, 8)[0]
    assert 1 <= len(results[rb].tokens) <= 4


@pytest.mark.parametrize("kw,match", [
    (dict(pipeline=True), "pipeline"),
    (dict(kv_cache_dtype="int8"), "spec_gamma"),
    (dict(kv_cache_dtype="int4"), "spec_gamma"),
    (dict(spec_ngram=0), "spec_ngram"),
], ids=["spec_pipeline_conflict", "spec_gamma_rejects_int8", "spec_gamma_rejects_int4",
        "spec_ngram"])
def test_spec_gamma_rejections(setup, kw, match):
    """spec_gamma refuses the pipelined order, quantized caches (no staged
    write of accepted prefixes) and an empty n-gram; under tiers,
    kv_cache_dtype='auto' resolves to the compute dtype on every pool."""
    cfg, params = setup
    kv = kw.pop("kv_cache_dtype", "auto")
    with pytest.raises(ValueError, match=match):
        server(params, cfg.replace(kv_cache_dtype=kv), spec_gamma=3, **kw)
    tiered = server(params, cfg, slots=4, long_slots=2, spec_gamma=3)
    assert [c.kv_cache_dtype for c in tiered.gcfgs] == ["auto", "auto"]


def test_stop_sequences_spec_mode(setup):
    """A stop sequence that matches inside a macro step cuts the stream
    there; nothing streams past it, and the slot serves the next request."""
    cfg, params = setup
    rng = np.random.default_rng(41)
    p = _rand(rng, 9)
    full, _ = oracle_greedy(params, cfg, p, 10)
    assert len(full) >= 5
    srv = server(params, cfg, sync_every=4, spec_gamma=3, spec_ngram=2)
    chunks = []
    r_mid = srv.submit(Request(prompt_ids=p, max_new_tokens=10, greedy=True, stop=full[2:4],
                               stream_cb=lambda rid, new, done: chunks.append(list(new))))
    r_none = srv.submit(Request(prompt_ids=p, max_new_tokens=10, greedy=True,
                                stop=[[VOCAB - 1]]))
    res = srv.run_until_drained()
    # the stream ends where it first ends with the stop sequence
    end = next(e for e in range(2, len(full) + 1) if full[e - 2:e] == full[2:4])
    assert res[r_mid].tokens == full[:end] and res[r_none].tokens == full
    assert sum(chunks, []) == full[:end]
    assert _greedy(srv, p, 6).tokens == full[:6]


def test_spec_session_and_chunks_feed_the_token_buffer(setup):
    """Extensions write their deltas into the speculative token buffer: a
    repetitive session turn and a repetitive chunked prompt get proposals
    accepted, and stay exact."""
    cfg, params = setup
    rng = np.random.default_rng(24)
    unit = _rand(rng, 4)
    srv = server(params, cfg, max_prompt=128, spec_gamma=2, spec_ngram=2, prefill_chunk=32)
    p1 = (unit * 3)[:10]
    res1 = _greedy(srv, p1, 8, session_id="dave")
    p2 = p1 + res1.tokens + unit
    accepted = srv.spec_accepted
    assert _greedy(srv, p2, 8, session_id="dave").tokens == oracle_greedy(params, cfg, p2, 8)[0]
    long_rep = (unit * 30)[:90]
    assert _greedy(srv, long_rep, 10).tokens == oracle_greedy(params, cfg, long_rep, 10)[0]
    assert srv.spec_accepted > accepted and srv.ext_programs >= 3
    tok = srv.tokens[srv.sessions["dave"]]
    assert tok[:len(p2)].tolist() == p2


# --- against ergm_tpu's server ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _twin_models(cross: bool):
    """A JAX and a port model on the same numpy-seeded weights (fp32)."""
    kw = dict(vocab_size=VOCAB, n_positions=128, n_embd=32, n_layer=2, n_head=4,
              use_cross_attention=cross, dtype="float32")
    jc, tc = JaxConfig(**kw), ModelConfig(**kw)
    tree = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: jg.init_params(k, jc))(jax.random.PRNGKey(3)))
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    pt = gpt2.params_for_inference(params_from_numpy(tree, tc, device="cpu"), tc)
    return (jc, pj), (tc, pt)


def _sessions_run(mod, cfg, params):
    """Two sessions pinned to the long pool of a tiered server (int8
    staged): turn 1 each, then each continuation extending its parked
    slot while the other decodes."""
    srv = mod.ContinuousServer(params, cfg, slots=3, eos_id=EOS, sp2_id=SP2, max_prompt=32,
                               prompt_bucket=16, sync_every=4, cache_len=96, cache_grow_step=0,
                               adaptive_block=False, long_slots=2, long_threshold=40)
    rng = np.random.default_rng(60)
    turns = {"s": _rand(rng, 10), "t": _rand(rng, 12)}
    out = []
    for k in range(2):
        rids = {sid: srv.submit(mod.Request(prompt_ids=p, max_new_tokens=6, greedy=True,
                                            session_id=sid, pool="long"))
                for sid, p in turns.items()}
        res = srv.run_until_drained()
        out += [res[r].tokens for r in rids.values()]
        turns = {sid: turns[sid] + res[r].tokens + _rand(rng, 5 + k) for sid, r in rids.items()}
    return out


def _chunked_run(mod, cfg, params):
    """Trimodal prompts admitted in 16-token chunks, pipelined."""
    srv = mod.ContinuousServer(params, cfg, slots=2, eos_id=EOS, sp2_id=SP2, max_prompt=32,
                               prompt_bucket=16, sync_every=4, cache_len=96, cache_grow_step=0,
                               adaptive_block=False, caption_len=8, prefill_chunk=16,
                               pipeline=True)
    rng = np.random.default_rng(61)
    rids = [srv.submit(mod.Request(
        prompt_ids=_rand(rng, n), max_new_tokens=6, greedy=True, caption_ids=_rand(rng, 5),
        img=rng.standard_normal(cfg.modality_dim).astype(np.float32),
        aud=rng.standard_normal(cfg.modality_dim).astype(np.float32))) for n in (40, 9, 30)]
    res = srv.run_until_drained()
    return [res[r].tokens for r in rids]


def _spec_run(mod, cfg, params):
    """Repetitive and random prompts through speculative blocks."""
    srv = mod.ContinuousServer(params, cfg, slots=2, eos_id=EOS, sp2_id=SP2, max_prompt=32,
                               prompt_bucket=16, sync_every=3, cache_len=96, cache_grow_step=0,
                               spec_gamma=3, spec_ngram=2)
    rng = np.random.default_rng(62)
    rep = _rand(rng, 4) * 4
    rids = [srv.submit(mod.Request(prompt_ids=p, max_new_tokens=10, greedy=True))
            for p in (rep, _rand(rng, 11), rep[:10] + rep[:6])]
    res = srv.run_until_drained()
    return [res[r].tokens for r in rids], srv.spec_accepted


@pytest.mark.parametrize("feature", ["sessions", "chunked", "spec"])
def test_features_match_jax_server(feature):
    """The port's server and ``ergm_tpu``'s on the same weights give the
    same greedy tokens: sessions (one in the int8 staged long pool of a
    tiered server), chunked prefill (trimodal, pipelined) and speculative
    serving (the same accepted count too). One capacity rung keeps JAX's
    compiles few."""
    run = {"sessions": _sessions_run, "chunked": _chunked_run, "spec": _spec_run}[feature]
    (jc, pj), (tc, pt) = _twin_models(feature == "chunked")
    port = types.SimpleNamespace(ContinuousServer=ContinuousServer, Request=Request)
    assert run(port, tc, pt) == run(jserver, jc, pj)
