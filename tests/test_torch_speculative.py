"""Port parity: ergm_tpu_torch.infer.speculative.

Greedy speculative output must equal the port's plain greedy ``generate``
token for token, in fp32, for any draft depth, gamma and n-gram length
(acceptance changes how fast tokens come, never which). Against JAX, the
tokens must equal ``ergm_tpu``'s under the margin rule of
``tests/test_torch_generate.py`` (compared up to a row's first slot whose
JAX top-2 logit margin is at most 1e-3). Sampling mode is held to the
rejection-sampling identity statistically: the marginal of the first
speculated token over fixed seeds against the exact marginal of direct
nucleus sampling, on a 16-token vocabulary.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.infer.speculative import speculative_generate as jax_spec
from ergm_tpu.models import gpt2 as jg
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.infer import generate as tgen
from ergm_tpu_torch.infer import speculative
from ergm_tpu_torch.infer.generate import generate
from ergm_tpu_torch.infer.speculative import (draft_params, speculative_generate,
                                              speculative_stats)
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.models.convert import params_from_numpy
from test_torch_generate import EOS as SLICE_EOS
from test_torch_generate import SLICE
from test_torch_generate import SP2 as SLICE_SP2
from test_torch_generate import _check_tokens, _replay

torch.set_num_threads(1)
VOCAB, EOS, SP2 = 64, 60, 61
T = torch.as_tensor


def make_cfg(**kw):
    base = dict(vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=3, n_head=4,
                use_cross_attention=False, dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
                resid_pdrop=0.0)
    base.update(kw)
    return ModelConfig(**base)


def port_params(cfg, seed):
    """The port's model with ``ergm_tpu``'s random init for ``seed``."""
    jc = JaxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    tree = jax.tree_util.tree_map(np.asarray, jg.init_params(jax.random.PRNGKey(seed), jc))
    return params_from_numpy(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def setup():
    cfg = make_cfg()
    ids = T(np.random.default_rng(3).integers(0, 50, (1, 8)))
    return cfg, port_params(cfg, 0), ids


def _plain(p, cfg, ids, n, cap, **kw):
    return generate(p, cfg, ids, n, max_len=cap, eos_id=EOS, sp2_id=SP2, greedy=True, **kw)


def _same(ref, got, n_ref=None, n_got=None):
    """Equal continuations: the tokens after each side's prompt, through
    each side's length."""
    rl, gl = int(ref.lengths[0]), int(got.lengths[0])
    a = ref.tokens[0, n_ref:rl] if n_ref is not None else ref.tokens[0, :rl]
    b = got.tokens[0, n_got:gl] if n_got is not None else got.tokens[0, :gl]
    assert a.tolist() == b.tolist(), (ref.tokens, got.tokens)


def test_draft_params_shares_every_tensor(setup):
    cfg, p, _ = setup
    dp, dcfg = draft_params(p, cfg, 2)
    assert dcfg.n_layer == 2 and len(dp.blocks) == 2 and len(p.blocks) == 3
    assert dp.wte is p.wte and dp.wpe is p.wpe and dp.ln_f is p.ln_f
    assert dp.emotion_head is p.emotion_head
    assert all(a is b for a, b in zip(dp.blocks, p.blocks))
    with pytest.raises(ValueError):
        draft_params(p, cfg, cfg.n_layer)


@pytest.mark.parametrize("gamma", [1, 2, 4])
@pytest.mark.parametrize("draft_layers", [1, 2])
def test_greedy_draft_equals_plain_greedy(setup, gamma, draft_layers):
    cfg, p, ids = setup
    got = speculative_generate(p, cfg, ids, 8, max_len=24, eos_id=EOS, sp2_id=SP2,
                               draft_layers=draft_layers, gamma=gamma, greedy=True)
    _same(_plain(p, cfg, ids, 8, 24), got)


@pytest.mark.parametrize("gamma", [1, 3])
@pytest.mark.parametrize("ngram_n", [1, 2, 3])
def test_greedy_ngram_equals_plain_greedy(setup, gamma, ngram_n):
    cfg, p, ids = setup
    got = speculative_generate(p, cfg, ids, 8, max_len=24, eos_id=EOS, sp2_id=SP2,
                               mode="ngram", ngram_n=ngram_n, gamma=gamma, greedy=True)
    _same(_plain(p, cfg, ids, 8, 24), got)


@pytest.mark.parametrize("mode", ["draft", "ngram"])
def test_masked_leftpad_equals_uniform(setup, mode):
    """The left-padded prompt (a bucket of 12 holding 6 tokens) gives the
    uniform prompt's continuation, and both give plain greedy's."""
    cfg, p, _ = setup
    true_len, bucket, cap = 6, 12, 20
    prompt = np.random.default_rng(5).integers(0, 50, true_len)
    kw = dict(max_len=cap, eos_id=EOS, sp2_id=SP2, mode=mode, ngram_n=2, draft_layers=2,
              gamma=3, greedy=True)
    ref = speculative_generate(p, cfg, T(prompt[None]), true_len, **kw)
    pad = np.full((1, bucket), EOS)
    pad[0, bucket - true_len:] = prompt
    mask = np.zeros((1, bucket), np.float32)
    mask[0, bucket - true_len:] = 1.0
    got = speculative_generate(p, cfg, T(pad), prompt_mask=T(mask),
                               max_new_tokens=cap - true_len, **kw)
    _same(ref, got, true_len, bucket)
    _same(_plain(p, cfg, T(prompt[None]), true_len, cap), ref)


@pytest.mark.parametrize("mode", ["draft", "ngram"])
def test_greedy_spec_with_modalities_and_captions(mode):
    """Image and audio features and a caption ride through the draft and
    the verify forwards; the emotion logits are the prefill's."""
    cfg = make_cfg(use_cross_attention=True)
    p = port_params(cfg, 1)
    rng = np.random.default_rng(0)
    ids = T(rng.integers(0, 50, (1, 8)))
    kw = dict(imgs=T(rng.standard_normal((1, cfg.modality_dim)).astype(np.float32)),
              auds=T(rng.standard_normal((1, cfg.modality_dim)).astype(np.float32)),
              caption_ids=T(rng.integers(0, 50, (1, 6))), caption_mask=torch.ones(1, 6))
    ref = _plain(p, cfg, ids, 8, 20, **kw)
    got = speculative_generate(p, cfg, ids, 8, max_len=20, eos_id=EOS, sp2_id=SP2, mode=mode,
                               draft_layers=2, gamma=3, ngram_n=2, greedy=True, **kw)
    _same(ref, got)
    np.testing.assert_allclose(got.emotion_logits.numpy(), ref.emotion_logits.numpy(),
                               atol=1e-6, rtol=0)


def test_full_depth_draft_accepts_everything(setup):
    """A draft that computes what the target computes (the target's last
    block zeroed to an identity residual, the draft its first two)
    proposes the target's own greedy tokens: every proposal is accepted,
    and the output is still plain greedy's."""
    cfg, _, ids = setup
    p = port_params(cfg, 0)
    with torch.no_grad():
        last = p.blocks[-1]
        for dense in (last.attn.c_proj, last.mlp.c_proj):
            dense.kernel.zero_()
            dense.bias.zero_()
    out, (accepted, steps, proposed) = speculative_stats(
        p, cfg, ids, 8, max_len=40, eos_id=EOS, sp2_id=SP2, draft_layers=2, gamma=3,
        greedy=True)
    assert steps >= 2 and accepted == proposed == 3 * steps
    _same(_plain(p, cfg, ids, 8, 40), out)


def test_stats_count_macro_steps(setup):
    cfg, p, ids = setup
    out, (accepted, steps, proposed) = speculative_stats(
        p, cfg, ids, 8, max_len=24, eos_id=EOS, sp2_id=SP2, draft_layers=2, gamma=3,
        greedy=True)
    assert steps >= 1 and proposed == 3 * steps and 0 <= accepted <= proposed
    # every macro step emits at least one token
    assert int(out.lengths[0]) - 8 >= min(steps, 24 - 8)


def test_spec_mode_validation(setup):
    cfg, p, ids = setup
    kw = dict(max_len=20, eos_id=EOS, sp2_id=SP2)
    with pytest.raises(ValueError, match="mode"):
        speculative_generate(p, cfg, ids, 8, mode="nope", **kw)
    with pytest.raises(ValueError, match="ngram_n"):
        speculative_generate(p, cfg, ids, 8, mode="ngram", ngram_n=0, **kw)
    with pytest.raises(ValueError, match="B=1"):
        speculative_generate(p, cfg, ids.repeat(2, 1), 8, **kw)


def test_generate_batch_routing(setup, monkeypatch):
    """JAX's policy: ``auto`` sends greedy B=1 to n-gram drafting and
    ``draft_layers`` to the layer draft; sampled or batched requests stay
    plain (a batch in a speculative mode warns and falls back). Every
    route gives plain greedy's tokens."""
    cfg, p, _ = setup
    modes = []
    real = speculative.speculative_generate

    def spy(*a, **k):
        modes.append(k["mode"])
        return real(*a, **k)

    monkeypatch.setattr(speculative, "speculative_generate", spy)
    prompt = [3, 7, 11, 2, 9]
    kw = dict(max_len=30, eos_id=EOS, sp2_id=SP2, max_new_tokens=8)
    plain, plain_emo = tgen.generate_batch(p, cfg, [prompt], greedy=True, spec_mode="none", **kw)
    assert modes == []
    auto, auto_emo = tgen.generate_batch(p, cfg, [prompt], greedy=True, **kw)
    assert modes == ["ngram"] and auto == plain
    np.testing.assert_allclose(auto_emo, plain_emo, atol=1e-6, rtol=0)
    drafted, _ = tgen.generate_batch(p, cfg, [prompt], greedy=True, draft_layers=2,
                                     spec_gamma=3, **kw)
    lookup, _ = tgen.generate_batch(p, cfg, [prompt], greedy=True, spec_mode="ngram",
                                    spec_ngram=2, spec_gamma=3, **kw)
    assert modes == ["ngram", "draft", "ngram"] and drafted == lookup == plain
    tgen.generate_batch(p, cfg, [prompt], greedy=False, **kw)
    tgen.generate_batch(p, cfg, [prompt, prompt], greedy=True, **kw)
    assert len(modes) == 3
    with pytest.warns(UserWarning, match="B=1"):
        pair, _ = tgen.generate_batch(p, cfg, [prompt, prompt[:3]], greedy=True,
                                      draft_layers=2, **kw)
    assert len(modes) == 3 and pair[0] == plain[0]


# -- sampling: the rejection-sampling identity ------------------------------

SMALL = dict(vocab_size=16, n_embd=16, n_head=2, n_layer=2)
S_EOS, S_SP2, PROMPT, TOP_P, DRAWS = 15, 14, [1, 5, 9, 2], 0.9, 400


def _exact_second_token(p, cfg):
    """The exact distribution of the second generated token under direct
    nucleus sampling: sum over the first token x of p(x) p(. | x), each
    p(. | x) from a cached step as ``generate`` takes it. A first eos ends
    the row, whose second slot then holds the eos fill."""
    def filt(logits):
        return tgen.top_p_filter(torch.softmax(logits[0, -1].float(), -1), TOP_P)

    with torch.inference_mode():
        cache = tg.init_kv_cache(cfg, 1, len(PROMPT) + 1, device="cpu")
        o = tg.forward(p, cfg, T([PROMPT]), cache=cache, prefix_prefill=True)
        p1 = filt(o.logits)
        out = torch.zeros(cfg.vocab_size, dtype=torch.float64)
        out[S_EOS] += p1[S_EOS]
        for x in range(cfg.vocab_size):
            if x != S_EOS and p1[x] > 0:
                # each step overwrites the same slot of the prefilled cache
                step = tg.forward(p, cfg, T([[x]]), token_type_ids=T([[S_SP2]]), cache=o.cache)
                out += p1[x] * filt(step.logits)
    return out.numpy()


@pytest.mark.parametrize("mode", ["draft", "ngram"])
def test_sampling_marginal_matches_direct_nucleus(mode):
    """Over 400 fixed seeds, the token at the first speculated slot (the
    second generated) follows the exact nucleus-sampling marginal:
    Pearson's chi-square over the outcomes with an expected count of at
    least 5 (the rest pooled) stays under its 0.999 quantile, and the
    total variation distance under 0.15 (``tests/test_speculative.py``'s
    bar; sampling noise alone gives about 0.09 at 400 draws here)."""
    from scipy.stats import chi2

    cfg = make_cfg(**SMALL)
    p = port_params(cfg, 2)
    with torch.no_grad():  # a target far from its one-layer draft
        for dense in (p.blocks[1].attn.c_proj, p.blocks[1].mlp.c_proj):
            dense.kernel.mul_(30.0)
    want = _exact_second_token(p, cfg)
    counts = np.zeros(cfg.vocab_size)
    for s in range(DRAWS):
        out = speculative_generate(
            p, cfg, T([PROMPT]), len(PROMPT), max_len=7, eos_id=S_EOS, sp2_id=S_SP2,
            top_p=TOP_P, mode=mode, draft_layers=1, ngram_n=2, gamma=2,
            generator=torch.Generator().manual_seed(1000 + s))
        counts[int(out.tokens[0, len(PROMPT) + 1])] += 1
    expected = want * DRAWS
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    obs, exp = obs[exp > 0], exp[exp > 0]
    stat = float(((obs - exp) ** 2 / exp).sum())
    assert stat < chi2.ppf(0.999, len(obs) - 1), (stat, counts, expected)
    assert 0.5 * np.abs(counts / DRAWS - want).sum() < 0.15


# -- against JAX -------------------------------------------------------------


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


@pytest.mark.parametrize("mode", ["draft", "ngram"])
def test_speculative_matches_jax(slice_models, mode):
    """One request with image and audio features and a caption, greedy:
    the port's tokens equal JAX's under the margin rule."""
    jc, tc, pj, pt = slice_models
    Lp, Lc, new = 16, 8, 12
    rng = np.random.default_rng(6)
    ids, tts = rng.integers(0, 256, (1, Lp)), rng.integers(0, 256, (1, Lp))
    imgs, auds = (rng.standard_normal((1, 768)).astype(np.float32) for _ in range(2))
    caps = rng.integers(0, 256, (1, Lc))
    kw = dict(max_len=Lp + new, eos_id=SLICE_EOS, sp2_id=SLICE_SP2, mode=mode, draft_layers=1,
              gamma=3, ngram_n=2, greedy=True)
    jout = jax.jit(lambda p: jax_spec(
        p, jc, jnp.asarray(ids), Lp, token_type_ids=jnp.asarray(tts), imgs=jnp.asarray(imgs),
        auds=jnp.asarray(auds), caption_ids=jnp.asarray(caps), rng=jax.random.PRNGKey(0),
        **kw))(pj)
    jtok, jlen = np.asarray(jout.tokens), np.asarray(jout.lengths)
    tout = speculative_generate(pt, tc, T(ids), Lp, token_type_ids=T(tts), imgs=T(imgs),
                                auds=T(auds), caption_ids=T(caps), **kw)
    assert int(tout.lengths[0]) == int(jlen[0])
    jl = _replay("jax", pj, jc, ids, np.ones((1, Lp), np.float32), tts, imgs, auds, caps, None,
                 jtok, Lp + new)
    _check_tokens(jtok, tout.tokens.numpy(), jl, Lp, jlen)
    np.testing.assert_allclose(tout.emotion_logits.numpy(), np.asarray(jout.emotion_logits),
                               atol=1e-4, rtol=0)


def test_trained_model_ngram_accepts_and_greedy_matches_jax():
    """A model trained (with torch's Adam) to repeat a period-4 loop: the
    lookup draft hits, so acceptance approaches gamma; and the trained
    weights, carried to ``ergm_tpu`` through the HF state dict, give JAX's
    greedy tokens exactly (trained margins are wide)."""
    from ergm_tpu.infer.generate import generate as jax_generate
    from ergm_tpu.models.convert import hf_to_params as jax_hf_to_params
    from ergm_tpu_torch.models.convert import params_to_hf

    cfg = make_cfg(n_layer=2)
    p = port_params(cfg, 0)
    seq = T(np.tile([7, 12, 23, 31], 10)[None])
    # sp2 token types everywhere: generated tokens carry sp2
    tts = torch.full_like(seq, SP2)
    opt = torch.optim.Adam(p.parameters(), lr=1e-2)
    for _ in range(150):
        loss = tg.forward(p, cfg, seq, token_type_ids=tts, labels=seq).loss
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert loss.item() < 0.5, loss.item()

    out, (accepted, steps, _) = speculative_stats(
        p, cfg, seq[:, :16], 16, max_len=40, eos_id=EOS, sp2_id=SP2,
        token_type_ids=tts[:, :16], mode="ngram", ngram_n=3, gamma=4, greedy=True)
    assert accepted / steps > 2.0, (accepted, steps)

    jc = JaxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    pj = jax_hf_to_params(params_to_hf(p, cfg), jc)
    want = jax.jit(lambda q: jax_generate(
        q, jc, jnp.asarray(seq[:, :16].numpy()), 16, max_len=40, eos_id=EOS, sp2_id=SP2,
        token_type_ids=jnp.asarray(tts[:, :16].numpy()), greedy=True,
        rng=jax.random.PRNGKey(0)))(pj)
    n = int(want.lengths[0])
    assert int(out.lengths[0]) == n
    assert out.tokens[0, :n].tolist() == np.asarray(want.tokens[0, :n]).tolist()
    assert out.tokens[0, 16:n].tolist() == np.tile([7, 12, 23, 31], 6)[:n - 16].tolist()
