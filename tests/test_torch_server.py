"""The port's continuous-batching server (``ergm_tpu_torch/infer/server.py``).

Load-bearing property, as for ``ergm_tpu``'s server (tests/test_server.py):
greedy decode THROUGH THE SERVER (requests joining mid-stream into slots
with per-row cursors, across capacity grows and shrinks, tiers and the
pipelined order, on compute-dtype, int8 and int4 caches) emits
byte-identical continuations to the port's ``generate`` on the same
prompts. Two tests also hold the port's server to ``ergm_tpu``'s on the
same numpy-seeded weights. A tiny fp32 model on the CPU.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.infer import server as jserver
from ergm_tpu.models import gpt2 as jg
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.mesh import make_mesh
from ergm_tpu_torch.infer.generate import generate
from ergm_tpu_torch.infer.server import (ContinuousServer, Request, _norm_stop,
                                         request_from_json)
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.models.convert import params_from_numpy

torch.set_num_threads(1)
VOCAB, EOS, SP2 = 64, 60, 61


def make_cfg(**kw):
    base = dict(vocab_size=VOCAB, n_positions=256, n_embd=32, n_layer=2, n_head=4,
                use_cross_attention=False, dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
                resid_pdrop=0.0)
    base.update(kw)
    return ModelConfig(**base)


def _params(cfg, seed=0):
    return gpt2.params_for_inference(
        gpt2.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu"), cfg)


@pytest.fixture(scope="module")
def setup():
    cfg = make_cfg()
    return cfg, _params(cfg)


def server(params, cfg, **kw):
    base = dict(slots=2, eos_id=EOS, sp2_id=SP2, max_prompt=32, prompt_bucket=16,
                sync_every=4)
    base.update(kw)
    return ContinuousServer(params, cfg, **base)


def oracle_greedy(params, cfg, prompt, max_new, **kw):
    """The port's ``generate`` greedy continuation of one prompt."""
    ids = torch.tensor([prompt])
    out = generate(params, cfg, ids, len(prompt),
                   max_len=min(len(prompt) + max_new, cfg.n_positions), eos_id=EOS,
                   sp2_id=SP2, greedy=True, token_type_ids=torch.full_like(ids, SP2), **kw)
    return (out.tokens[0, len(prompt):int(out.lengths[0])].tolist(),
            out.emotion_logits[0].numpy())


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 50, (n,)).tolist() for n in lens]


def _record_pools(srv):
    """{request id: the config of the pool its row was admitted to} (with
    tiers under kv_cache_dtype="auto" the long pool's cache is int8)."""
    pools, real = {}, srv._admit_group

    def admit(entries, pb, g=0):
        pools.update({e[1]: srv.gcfgs[g] for e in entries})
        return real(entries, pb, g)
    srv._admit_group = admit
    return pools


def _check(params, cfg, srv, reqs, emo_tol=None):
    """Submit greedy ``reqs`` [(prompt, budget)], drain, compare each with
    ``generate``; returns the results."""
    rids = [srv.submit(Request(prompt_ids=p, max_new_tokens=b, greedy=True)) for p, b in reqs]
    results = srv.run_until_drained()
    assert set(results) >= set(rids)
    for rid, (p, b) in zip(rids, reqs):
        want, emo = oracle_greedy(params, cfg, p, b)
        assert results[rid].tokens == want, (p, results[rid].tokens, want)
        if emo_tol is not None:
            np.testing.assert_allclose(results[rid].emotion_logits, emo, atol=emo_tol)
    return [results[r] for r in rids]


@pytest.mark.parametrize("kv", ["auto", "int8", "int4"])
def test_greedy_matches_generate(setup, kv):
    """6 requests through 2 slots on each cache form (int8 and int4 take
    the staged block decode): byte-identical to ``generate`` on the same
    cache form, emotion logits too; later requests queue."""
    cfg, params = setup
    cfg = cfg.replace(kv_cache_dtype=kv)
    prompts = _prompts(0, (5, 11, 17, 8, 23, 14))
    res = _check(params, cfg, server(params, cfg), [(p, 8) for p in prompts], emo_tol=1e-4)
    assert any(r.steps_waited > 0 for r in res)


def test_tight_cache_preserves_greedy(setup):
    """Rows running close to the cache capacity (finished rows junk-writing
    past their content and past capacity) stay byte-identical."""
    cfg, params = setup
    prompts = _prompts(1, (7, 13, 9, 19))
    _check(params, cfg, server(params, cfg, cache_len=40), [(p, 16) for p in prompts],
           emo_tol=1e-4)


@pytest.mark.parametrize("kv", ["auto", "int8", "int4"])
def test_cache_growth_preserves_greedy(setup, kv):
    """The capacity ladder: start at the smallest rung, pad-copy up as the
    longest row needs it, slice-copy down once the need halves; invisible
    in the tokens."""
    cfg, params = setup
    cfg = cfg.replace(kv_cache_dtype=kv)
    prompts = _prompts(10, (7, 12, 9, 31, 6, 11, 13, 8))
    srv = server(params, cfg, cache_len=96, cache_grow_step=16)
    assert srv.Tphys == [32] and srv.T == 96
    budgets = [16, 16, 16, 48, 16, 16, 16, 16]
    _check(params, cfg, srv, list(zip(prompts, budgets)), emo_tol=1e-4)
    assert srv.grows > 0 and srv.shrinks > 0


def test_trimodal_greedy_matches_generate():
    """Image, audio and caption inputs; a caption-less, feature-less
    request shares the group (the caption gate and zero features)."""
    cfg = make_cfg(use_cross_attention=True)
    params = _params(cfg, seed=1)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 50, (9,)).tolist()
    img = rng.standard_normal(cfg.modality_dim).astype(np.float32)
    aud = rng.standard_normal(cfg.modality_dim).astype(np.float32)
    caps = rng.integers(0, 50, (6,)).tolist()
    srv = server(params, cfg, caption_len=8)
    rid = srv.submit(Request(prompt_ids=prompt, img=img, aud=aud, caption_ids=caps,
                             max_new_tokens=8, greedy=True))
    rid2 = srv.submit(Request(prompt_ids=prompt, max_new_tokens=8, greedy=True))
    results = srv.run_until_drained()
    cap_ids = torch.full((1, 8), EOS)
    cap_ids[0, :6] = torch.tensor(caps)
    cap_mask = torch.zeros((1, 8))
    cap_mask[0, :6] = 1.0
    want, _ = oracle_greedy(params, cfg, prompt, 8, imgs=torch.from_numpy(img[None]),
                            auds=torch.from_numpy(aud[None]), caption_ids=cap_ids,
                            caption_mask=cap_mask)
    assert results[rid].tokens == want
    assert results[rid2].tokens == oracle_greedy(params, cfg, prompt, 8)[0]


def test_sampling_completes_and_is_in_vocab(setup):
    cfg, params = setup
    prompts = _prompts(3, (8, 8, 8, 8))
    srv = server(params, cfg)
    rids = [srv.submit(Request(prompt_ids=p, max_new_tokens=12, top_p=0.9, seed=n))
            for n, p in enumerate(prompts)]
    results = srv.run_until_drained()
    for rid in rids:
        toks = results[rid].tokens
        assert 1 <= len(toks) <= 12 and all(0 <= t < VOCAB for t in toks)
        if EOS in toks:
            assert toks.index(EOS) == len(toks) - 1


def test_incremental_submission(setup):
    """A request submitted mid-stream joins without disturbing the row in
    flight."""
    cfg, params = setup
    p1, p2 = _prompts(4, (10, 15))
    srv = server(params, cfg, sync_every=2)
    r1 = srv.submit(Request(prompt_ids=p1, max_new_tokens=12, greedy=True))
    srv.step()
    srv.step()
    r2 = srv.submit(Request(prompt_ids=p2, max_new_tokens=6, greedy=True))
    results = srv.run_until_drained()
    assert results[r1].tokens == oracle_greedy(params, cfg, p1, 12)[0]
    assert results[r2].tokens == oracle_greedy(params, cfg, p2, 6)[0]


def test_rejections(setup):
    """Prompts past max_prompt (a session's history too, when no parked
    session matches it) and budgets past the cache are refused at submit;
    chunk sizes outside [EXT_BUCKET, max_prompt] at construction; so are
    slots (and pools) that the slot-axis mesh's data axis does not divide,
    with JAX's messages (a mesh laid out without a world)."""
    cfg, params = setup
    srv = server(params, cfg, slots=1, max_prompt=16, cache_len=64)
    with pytest.raises(ValueError, match="max_prompt"):
        srv.submit(Request(prompt_ids=list(range(40))))
    with pytest.raises(ValueError, match="no matching parked session"):
        srv.submit(Request(prompt_ids=list(range(40)), session_id="s"))
    with pytest.raises(ValueError, match="cache"):
        srv.submit(Request(prompt_ids=[1] * 7, max_new_tokens=60))
    srv.submit(Request(prompt_ids=[1] * 7, max_new_tokens=16, greedy=True))
    assert len(srv.run_until_drained()) == 1
    dp2 = make_mesh((2,), ("data",), world_size=2, rank=0)
    with pytest.raises(ValueError, match="slots=3 must be divisible by the mesh data axis"):
        server(params, cfg, slots=3, mesh=dp2)
    with pytest.raises(ValueError, match=r"pool sizes \[3, 1\]"):
        server(params, cfg, slots=4, long_slots=1, mesh=dp2)
    for chunk in (8, 48):
        with pytest.raises(ValueError, match="prefill_chunk"):
            server(params, cfg, prefill_chunk=chunk)
    with pytest.raises(ValueError, match="cross_kv_dtype"):
        server(params, cfg.replace(cross_kv_dtype="int8"))
    with pytest.raises(ValueError, match="admit_policy"):
        server(params, cfg, admit_policy="nope")


def test_pipelined_mode_matches_generate(setup):
    """Dispatch block n+1 before harvesting block n, with requests
    submitted mid-stream: still byte-identical."""
    cfg, params = setup
    prompts = _prompts(11, (5, 11, 17, 8, 23, 14))
    srv = server(params, cfg, pipeline=True)
    r0 = srv.submit(Request(prompt_ids=prompts[0], max_new_tokens=8, greedy=True))
    srv.step()
    srv.step()
    rids = [r0] + [srv.submit(Request(prompt_ids=p, max_new_tokens=8, greedy=True))
                   for p in prompts[1:]]
    results = srv.run_until_drained()
    for rid, p in zip(rids, prompts):
        want, emo = oracle_greedy(params, cfg, p, 8)
        assert results[rid].tokens == want
        np.testing.assert_allclose(results[rid].emotion_logits, emo, atol=1e-4)


@pytest.mark.parametrize("pipeline", [False, True])
def test_stream_callback(setup, pipeline):
    """Block-granular chunks concatenate to the final tokens, done=True
    exactly once, in both orders."""
    cfg, params = setup
    prompts = _prompts(3, (6, 13, 21))
    srv = server(params, cfg, pipeline=pipeline)
    chunks: dict = {}

    def cb(rid, new, done):
        chunks.setdefault(rid, []).append((list(new), done))

    rids = [srv.submit(Request(prompt_ids=p, max_new_tokens=7, greedy=True, stream_cb=cb))
            for p in prompts]
    results = srv.run_until_drained()
    assert set(chunks) == set(rids)
    for rid in rids:
        assert [t for new, _ in chunks[rid] for t in new] == results[rid].tokens
        dones = [done for _, done in chunks[rid]]
        assert dones[-1] and not any(dones[:-1])
        assert all(len(new) <= 4 + 1 for new, _ in chunks[rid])


@pytest.mark.parametrize("seed,kw", [
    (0, dict(slots=3, sync_every=3)),
    (2, dict(slots=3, sync_every=4, pipeline=True)),
    (4, dict(slots=4, sync_every=3, long_slots=2, long_threshold=24)),
    (7, dict(slots=4, sync_every=4, long_slots=2, long_threshold=24, pipeline=True)),
])
def test_randomized_admission_stress(setup, seed, kw):
    """A random schedule of submissions and server iterations (idle turns,
    grows and shrinks among them) stays byte-identical to ``generate``."""
    cfg, params = setup
    rng = np.random.default_rng(100 + seed)
    reqs = [(rng.integers(0, 50, (int(rng.integers(3, 29)),)).tolist(),
             int(rng.integers(1, 15))) for _ in range(10)]
    srv = server(params, cfg, cache_grow_step=16, **kw)
    pools = _record_pools(srv)
    rids, pending = {}, list(reqs)
    while pending or rids.keys() - srv.results.keys():
        k = int(rng.integers(0, 4))
        for p, budget in pending[:k]:
            rids[srv.submit(Request(prompt_ids=p, max_new_tokens=budget, greedy=True))] = (
                p, budget)
        pending = pending[k:]
        for _ in range(int(rng.integers(0, 3))):
            srv.step()
    results = srv.run_until_drained()
    for rid, (p, budget) in rids.items():
        assert results[rid].tokens == oracle_greedy(params, pools[rid], p, budget)[0]


def test_cancel_in_every_state(setup):
    """``cancel`` abandons a queued, an active and a finished request,
    frees the slot, and leaves the surviving streams exact."""
    cfg, params = setup
    keep1, keep2, act, queued = _prompts(38, (9, 13, 11, 7))
    srv = server(params, cfg, sync_every=3)
    r_keep1 = srv.submit(Request(prompt_ids=keep1, max_new_tokens=12, greedy=True))
    r_act = srv.submit(Request(prompt_ids=act, max_new_tokens=12, greedy=True))
    srv.step()
    r_q = srv.submit(Request(prompt_ids=queued, max_new_tokens=4, greedy=True))
    assert srv.cancel(r_q) and not srv.cancel(r_q)
    assert srv.cancel(r_act)
    r_keep2 = srv.submit(Request(prompt_ids=keep2, max_new_tokens=6, greedy=True))
    results = srv.run_until_drained()
    assert set(results) == {r_keep1, r_keep2}
    assert results[r_keep1].tokens == oracle_greedy(params, cfg, keep1, 12)[0]
    assert results[r_keep2].tokens == oracle_greedy(params, cfg, keep2, 6)[0]
    assert srv.cancel(r_keep1) and r_keep1 not in srv.results


def test_tiered_pools_isolate_long_rows(setup):
    """A long row grows only the long pool's rung; both pools exact."""
    cfg, params = setup
    shorts = _prompts(30, (7, 12, 9))
    long_p = _prompts(31, (120,))[0]
    srv = server(params, cfg, slots=4, max_prompt=128, cache_grow_step=16, long_slots=1,
                 long_threshold=64)
    pools = _record_pools(srv)
    r_long = srv.submit(Request(prompt_ids=long_p, max_new_tokens=24, greedy=True))
    r_shorts = [srv.submit(Request(prompt_ids=p, max_new_tokens=8, greedy=True))
                for p in shorts]
    results, split = {}, False
    for _ in range(100):
        if not srv.busy():
            break
        for r in srv.step():
            results[r.request_id] = r
        split |= srv.Tphys[1] >= 128 and srv.Tphys[0] <= 32
    assert split, srv.Tphys
    assert srv._slot_group(3) == 1 and pools[r_long].kv_cache_dtype == "int8"
    assert results[r_long].tokens == oracle_greedy(params, pools[r_long], long_p, 24)[0]
    for rid, p in zip(r_shorts, shorts):
        assert results[rid].tokens == oracle_greedy(params, pools[rid], p, 8)[0]


def test_tiered_short_overflow_and_long_defers(setup):
    """Short requests overflow into an idle long slot; long requests never
    take a short slot (the second one waits)."""
    cfg, params = setup
    shorts = _prompts(31, (6, 9))
    longs = _prompts(32, (70, 70))
    srv = server(params, cfg, max_prompt=96, sync_every=2, cache_grow_step=16, long_slots=1,
                 long_threshold=48)
    pools = _record_pools(srv)
    rids = [srv.submit(Request(prompt_ids=p, max_new_tokens=4, greedy=True)) for p in shorts]
    srv.step()
    assert all(s.active for s in srv.slots)
    assert [pools[r].kv_cache_dtype for r in rids] == ["auto", "int8"]
    results = srv.run_until_drained()
    for rid, p in zip(rids, shorts):
        assert results[rid].tokens == oracle_greedy(params, pools[rid], p, 4)[0]
    srv.reset()
    rids = [srv.submit(Request(prompt_ids=p, max_new_tokens=4, greedy=True)) for p in longs]
    srv.step()
    assert [i for i, s in enumerate(srv.slots) if s.active] == [1]
    results = srv.run_until_drained()
    assert results[rids[1]].steps_waited > 0
    for rid, p in zip(rids, longs):
        assert results[rid].tokens == oracle_greedy(params, pools[rid], p, 4)[0]


def test_kv_auto_mixed_pools_parity(setup):
    """kv_cache_dtype='auto' with tiers: the short pool decodes a
    compute-dtype cache, the long pool an int8 staged one, in the same
    block; each row equals ``generate`` on its pool's cache form."""
    cfg, params = setup
    srv = server(params, cfg, slots=4, long_slots=2, long_threshold=24)
    assert [c.kv_cache_dtype for c in srv.gcfgs] == ["auto", "int8"]
    assert srv.caches[1].k.dtype == torch.int8 and srv.caches[0].k.dtype == torch.float32
    rids = {}
    for p in _prompts(21, (6, 11)):
        rids[srv.submit(Request(prompt_ids=p, max_new_tokens=6, greedy=True))] = (p, "auto")
    for p in _prompts(22, (30, 27)):
        rids[srv.submit(Request(prompt_ids=p, max_new_tokens=6, greedy=True))] = (p, "int8")
    results = srv.run_until_drained()
    for rid, (p, kv) in rids.items():
        want, _ = oracle_greedy(params, cfg.replace(kv_cache_dtype=kv), p, 6)
        assert results[rid].tokens == want, kv


def test_temperature_near_zero_matches_greedy(setup):
    """A temperature-1e-4 sampled row (top_p 1) equals greedy, beside a
    hot row in the same blocks; greedy rows ignore temperature."""
    cfg, params = setup
    p, q = _prompts(33, (9, 13))
    srv = server(params, cfg, slots=3)
    r_cold = srv.submit(Request(prompt_ids=p, max_new_tokens=8, temperature=1e-4, top_p=1.0,
                                seed=5))
    r_hot = srv.submit(Request(prompt_ids=q, max_new_tokens=8, temperature=3.0, top_p=1.0,
                               seed=7))
    r_greedy = srv.submit(Request(prompt_ids=p, max_new_tokens=8, greedy=True,
                                  temperature=9.0))
    results = srv.run_until_drained()
    want = oracle_greedy(params, cfg, p, 8)[0]
    assert results[r_cold].tokens == want and results[r_greedy].tokens == want
    toks = results[r_hot].tokens
    assert 1 <= len(toks) <= 8 and all(0 <= t < VOCAB for t in toks)


def test_request_parsing_and_normalization(setup):
    """request_from_json: temperature (0 is greedy, negative refused),
    logprobs, stop; submit copies and normalizes the request."""
    r = request_from_json({"prompt": [1, 2], "temperature": 0.7})
    assert r.temperature == pytest.approx(0.7) and not r.greedy
    r0 = request_from_json({"prompt": [1, 2], "temperature": 0})
    assert r0.greedy and r0.temperature == 1.0
    with pytest.raises(ValueError):
        request_from_json({"prompt": [1, 2], "temperature": -0.5})
    assert request_from_json({"prompt": [1], "logprobs": True}).logprobs
    assert not request_from_json({"prompt": [1]}).logprobs
    assert request_from_json({"prompt": [1, 2], "stop": [5, 6]}).stop == [[5, 6]]
    assert request_from_json({"prompt": [1, 2], "stop": [[5], [6, 7]]}).stop == [[5], [6, 7]]
    assert request_from_json({"prompt": [1, 2]}).stop is None
    with pytest.raises(ValueError):
        request_from_json({"prompt": [1, 2], "stop": [[]]})
    with pytest.raises(ValueError, match="ids"):
        _norm_stop([5, [6, 7]])
    with pytest.raises(ValueError, match="ids"):
        _norm_stop([["a", "b"]])
    with pytest.raises(ValueError, match="too many"):
        _norm_stop([[1]] * 17)
    with pytest.raises(ValueError, match="too long"):
        _norm_stop([list(range(65))])
    assert _norm_stop([[1]] * 16) == [[1]] * 16
    assert _norm_stop([np.int64(5), np.int64(6)]) == [[5, 6]]
    assert _norm_stop(np.array([5, 6])) == [[5, 6]]

    cfg, params = setup
    p = _prompts(42, (7,))[0]
    srv = server(params, cfg, sync_every=3)
    req = Request(prompt_ids=p, max_new_tokens=6, temperature=0.0, stop=[63, 62])
    rid = srv.submit(req)
    assert req.temperature == 0.0 and req.greedy is False and req.stop == [63, 62]
    assert srv.run_until_drained()[rid].tokens == oracle_greedy(params, cfg, p, 6)[0]
    with pytest.raises(ValueError, match="temperature"):
        srv.submit(Request(prompt_ids=p, max_new_tokens=4, temperature=-0.5))


def test_stop_sequences(setup):
    """A stop sequence ends the stream where it matches (kept in the
    output, like eos); nothing past it is emitted or streamed."""
    cfg, params = setup
    p = _prompts(35, (9,))[0]
    full, _ = oracle_greedy(params, cfg, p, 8)
    assert len(full) >= 4

    def cut(stream, seqs):
        for e in range(1, len(stream) + 1):
            if any(e >= len(q) and stream[e - len(q):e] == q for q in seqs):
                return stream[:e]
        return stream

    srv = server(params, cfg, slots=3)
    chunks = []
    r_two = srv.submit(Request(prompt_ids=p, max_new_tokens=8, greedy=True, stop=full[1:3]))
    r_first = srv.submit(Request(prompt_ids=p, max_new_tokens=8, greedy=True,
                                 stop=[[full[0]]],
                                 stream_cb=lambda rid, new, done: chunks.append(list(new))))
    r_none = srv.submit(Request(prompt_ids=p, max_new_tokens=8, greedy=True,
                                stop=[[VOCAB - 1]]))
    res = srv.run_until_drained()
    assert res[r_two].tokens == cut(full, [full[1:3]])
    assert res[r_first].tokens == full[:1]
    assert res[r_none].tokens == full
    assert sum(chunks, []) == full[:1]


def test_logprobs_match_oracle(setup):
    """Emitted-token logprobs equal a plain forward's log-softmax at each
    position; rows that did not ask get None and the same tokens."""
    cfg, params = setup
    p, q = _prompts(36, (9, 12))
    srv = server(params, cfg)
    r_lp = srv.submit(Request(prompt_ids=p, max_new_tokens=6, greedy=True, logprobs=True))
    r_plain = srv.submit(Request(prompt_ids=q, max_new_tokens=6, greedy=True))
    res = srv.run_until_drained()
    assert res[r_plain].logprobs is None
    assert res[r_plain].tokens == oracle_greedy(params, cfg, q, 6)[0]
    toks, lps = res[r_lp].tokens, res[r_lp].logprobs
    assert toks == oracle_greedy(params, cfg, p, 6)[0] and len(lps) == len(toks)
    seq = torch.tensor([p + toks])
    with torch.inference_mode():
        lsm = torch.log_softmax(gpt2.forward(params, cfg, seq, token_type_ids=torch.full_like(
            seq, SP2)).logits[0].float(), dim=-1)
    for k, t in enumerate(toks):
        assert abs(lps[k] - float(lsm[len(p) - 1 + k, t])) < 1e-3, k


def test_sorted_admission_policy(setup):
    """'sorted' admits by budget, largest first: the same tokens as fifo
    (and as ``generate``), in another admission order."""
    cfg, params = setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 50, (int(n),)).tolist() for n in rng.integers(4, 12, (8,))]
    budgets = [3, 9, 4, 8, 3, 9, 4, 8]

    def run(policy):
        res = _check(params, cfg, server(params, cfg, admit_policy=policy),
                     list(zip(prompts, budgets)))
        return [r.tokens for r in res], [r.steps_waited for r in res]

    (sorted_toks, sorted_wait), (fifo_toks, fifo_wait) = run("sorted"), run("fifo")
    assert sorted_toks == fifo_toks and sorted_wait != fifo_wait


# --- against ergm_tpu's server ----------------------------------------------


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_greedy_matches_jax_server(kv):
    """The port's server and ``ergm_tpu``'s on the same numpy-seeded
    weights (fp32; the compute-dtype cache and the int8 staged cache):
    the same greedy tokens, byte for byte, with staggered admissions
    through 2 slots. One capacity rung and one block length keep JAX's
    compiles to one program each."""
    kw = dict(vocab_size=VOCAB, n_positions=128, n_embd=32, n_layer=2, n_head=4,
              use_cross_attention=False, dtype="float32", kv_cache_dtype=kv)
    jc, tc = JaxConfig(**kw), ModelConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray, jg.init_params(jax.random.PRNGKey(3), jc))
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    pt = gpt2.params_for_inference(params_from_numpy(tree, tc, device="cpu"), tc)
    reqs = [(p, b) for p, b in zip(_prompts(50, (5, 11, 16, 8, 3, 14)), (8, 6, 9, 4, 7, 8))]
    skw = dict(slots=2, eos_id=EOS, sp2_id=SP2, max_prompt=16, prompt_bucket=16,
               sync_every=4, cache_len=48, cache_grow_step=0, adaptive_block=False)
    out = []
    for mod, params, cfg in ((jserver, pj, jc), (None, pt, tc)):
        Srv, Req = ((mod.ContinuousServer, mod.Request) if mod is not None
                    else (ContinuousServer, Request))
        srv = Srv(params, cfg, **skw)
        rids = [srv.submit(Req(prompt_ids=p, max_new_tokens=b, greedy=True)) for p, b in reqs]
        res = srv.run_until_drained()
        out.append([(res[r].tokens, res[r].steps_waited) for r in rids])
    assert out[1] == out[0]
