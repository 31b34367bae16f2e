"""Port parity for the decode-step kernels K2, K3 and K4.

Each kernel's plain version (what the port's wrapper runs on a CPU
tensor) against JAX's Pallas kernel in interpret mode, at JAX's own
test shapes and bars; the gates against JAX's; and the decode step with
JAX's switches on (``ERGM_CROSS_KERNEL=1``, ``decode_fused_mlp=True``,
``ERGM_DECODE_KERNEL=1``) against JAX with the same switches, with spies
showing which ops functions the port's step called. fp32, on the CPU.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.infer import generate as jgen
from ergm_tpu.models import gpt2 as jg
from ergm_tpu.ops import cross_decode as jcd
from ergm_tpu.ops import decode_attention as jda
from ergm_tpu.ops import fused_decode as jfd
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.infer import generate as tgen
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.ops import attention as tatt
from ergm_tpu_torch.ops import cross_decode as tcd
from ergm_tpu_torch.ops import decode_attention as tda
from ergm_tpu_torch.ops import fused_decode as tfd
from test_torch_generate import _check_tokens, _margin, _replay
from test_torch_gpt2 import INT8, TINY, _inputs, _params

torch.set_num_threads(1)
SWITCHES = ("ERGM_CROSS_KERNEL", "ERGM_DECODE_KERNEL")


@pytest.fixture
def switches(monkeypatch):
    """Sets JAX's decode-kernel switches for one test; JAX reads them while
    tracing, so its compiled functions are dropped before and after."""
    def set_all(on: bool):
        for name in SWITCHES:
            if on:
                monkeypatch.setenv(name, "1")
            else:
                monkeypatch.delenv(name, raising=False)
        jax.clear_caches()
    yield set_all
    jax.clear_caches()


# --- K2: int8 decode attention ------------------------------------------


def _k2_inputs(B, H, T, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, 1, 64)).astype(np.float32),
            rng.integers(-127, 128, (B, H, T, 64)).astype(np.int8),
            rng.integers(-127, 128, (B, H, T, 64)).astype(np.int8),
            rng.uniform(0.001, 0.02, (B, H, T, 1)).astype(np.float32),
            rng.uniform(0.001, 0.02, (B, H, T, 1)).astype(np.float32))


@pytest.mark.parametrize("B,H,T,index", [(8, 2, 256, 100), (16, 4, 256, 255), (8, 2, 512, 17)])
def test_k2_plain_matches_jax_kernel(B, H, T, index):
    """JAX's test shapes (tests/test_decode_attention.py:17-19) and bar."""
    x = _k2_inputs(B, H, T)
    want = jda.decode_mha_int8(*map(jnp.asarray, x), index, 0.125, n_head=H)
    got = tda.decode_mha_int8(*map(torch.from_numpy, x), index, 0.125, n_head=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4, atol=3e-4)


def test_k2_plain_with_leftpad_mask_matches_dequantized_attention():
    """With a left-pad ``kv_mask``: the factored math against attention
    over the dequantized cache (the T < 512 branch's formulation) with the
    same mask and the ``t <= index`` tail, measured 1.5e-8."""
    B, H, T, index = 8, 2, 512, 300
    q, kq, vq, ks, vs = map(torch.from_numpy, _k2_inputs(B, H, T, seed=1))
    mask = torch.ones((B, T))
    for b, pad in enumerate(np.random.default_rng(2).integers(0, 200, B)):
        mask[b, :pad] = 0.0
    got = tda.decode_mha_int8(q, kq, vq, ks, vs, index, 0.125, mask, n_head=H)
    tail = (torch.arange(T) <= index).float()[None, :]
    want = tatt.multihead_attention(q, kq.float() * ks, vq.float() * vs, causal=False,
                                    kv_mask=mask * tail, scale=0.125)
    np.testing.assert_allclose(got.numpy(), want.transpose(1, 2).reshape(B, -1).numpy(),
                               rtol=0, atol=1e-6)


def test_k2_plan_splits_a_row_over_a_cluster():
    """K2's launch plan on a 132-SM card: the long-history batch keeps one
    CTA a row, a single request over a long cache spreads over 8, too few
    keys are not split; and for every slot count the kernel takes, 1 to 8
    CTAs whose 16-key slices cover the row's keys, at most MAX_KEYS each."""
    assert tda.plan(64, 12, 512, 400) == 1
    assert tda.plan(1, 12, 1024, 1000) == 8
    assert tda.plan(256, 12, 256, 200) == 1
    assert tda.plan(1, 12, 1024, 5) == 1
    assert tda.slice_keys(512, 400, 4) == 112 and tda.slice_keys(512, 15, 8) == 16
    for B, H in ((1, 1), (1, 12), (8, 12), (64, 12), (256, 12)):
        for T in (1, 17, 256, 512, 1024, 4096, tda.MAX_T):
            for index in {0, T // 3, T - 1}:
                c = tda.plan(B, H, T, index)
                share = tda.slice_keys(T, index, c)
                assert 1 <= c <= tda.MAX_CLUSTER and share % 16 == 0
                assert share <= tda.MAX_KEYS and c * share >= min(T, index + 1)


# --- K3: fused cross sublayer -------------------------------------------


@pytest.fixture(scope="module")
def cross_setup():
    """Port and JAX params, h [8, 1, 128] and a quantized cross cache whose
    two layers differ, so the layer offset is tested."""
    jc, tc, pj, pt, _ = _params({**TINY, "cross_kv_dtype": "int8"}, seed=5)
    B, Lc, D, H = 8, 8, 128, 2
    rng = np.random.default_rng(5)
    h = rng.standard_normal((B, 1, D)).astype(np.float32)
    codes, scales = [], []
    for _ in range(2 * jc.n_layer):  # k and v of each layer
        q, s = jg._quantize_kv(jnp.asarray(rng.standard_normal((B, Lc, H, D // H)),
                                           jnp.float32))
        codes.append(np.asarray(q).reshape(B, Lc, D))
        scales.append(np.asarray(s, np.float32)[..., 0])
    ck, cv = np.stack(codes[0::2]), np.stack(codes[1::2])
    ks, vs = np.stack(scales[0::2]), np.stack(scales[1::2])
    return jc, tc, pj, pt, h, (ck, cv, ks, vs)


def _cross_mask(mode, B, Lc):
    if mode == "none":
        return None
    if mode == "partial":
        m = np.random.default_rng(1).integers(0, 2, (B, Lc)).astype(np.float32)
        m[:, 0] = 1.0
        return m
    m = np.ones((B, Lc), np.float32)
    m[3] = 0.0
    return m


@pytest.mark.parametrize("li", [0, 1])
@pytest.mark.parametrize("mask_mode", ["none", "partial", "empty_row"])
def test_k3_plain_matches_jax_kernel(cross_setup, mask_mode, li):
    """JAX's mask modes and bar (tests/test_cross_decode.py:61-107). JAX's
    kernel takes its 128-lane padded scales; the port the unpadded ones."""
    jc, tc, pj, pt, h, (ck, cv, ks, vs) = cross_setup
    B, Lc = ck.shape[1], ck.shape[2]
    mask = _cross_mask(mask_mode, B, Lc)
    pad = ((0, 0), (0, 0), (0, 0), (0, jg._cross_scale_pad(jc) - jc.n_head))
    want = jcd.fused_cross_decode(
        jnp.asarray(h), jcd.prep_params(pj["blocks"], jc, jnp.float32), jnp.int32(li), 0.125,
        tuple(map(jnp.asarray, (ck, cv, np.pad(ks, pad), np.pad(vs, pad)))),
        jnp.ones((B, Lc), jnp.float32) if mask is None else jnp.asarray(mask), jc)
    got = tcd.fused_cross_decode(
        torch.from_numpy(h), pt.blocks[li], li, 0.125,
        tuple(map(torch.from_numpy, (ck, cv, ks, vs))),
        None if mask is None else torch.from_numpy(mask), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


# --- K4: fused LN2 + MLP ------------------------------------------------


@pytest.mark.parametrize("act", ["gelu_new", "gelu"])
@pytest.mark.parametrize("B", [8, 64])
def test_k4_plain_matches_jax_kernel(act, B):
    """JAX's shapes and bar (tests/test_fused_decode.py:19-47), and the beam
    path's 64 rows (the card kernel's one-row-block plan)."""
    d, f = 128, 512
    jc = JaxConfig.from_model_type("gpt2", n_layer=2, n_embd=d, n_head=4, vocab_size=120,
                                   n_positions=64, activation=act)
    tc = ModelConfig.from_model_type("gpt2", n_layer=2, n_embd=d, n_head=4, vocab_size=120,
                                     n_positions=64, activation=act)
    rng = np.random.default_rng(0)
    h = rng.standard_normal((B, 1, d)).astype(np.float32)
    w = dict(scale=rng.standard_normal(d), bias=rng.standard_normal(d),
             fc_k=rng.standard_normal((d, f)) * 0.05, fc_b=rng.standard_normal(f) * 0.05,
             pr_k=rng.standard_normal((f, d)) * 0.05, pr_b=rng.standard_normal(d) * 0.05)
    w = {k: v.astype(np.float32) for k, v in w.items()}
    j = {k: jnp.asarray(v) for k, v in w.items()}
    want = jfd.fused_ln_mlp(jnp.asarray(h), {"scale": j["scale"], "bias": j["bias"]},
                            {"c_fc": {"kernel": j["fc_k"], "bias": j["fc_b"]},
                             "c_proj": {"kernel": j["pr_k"], "bias": j["pr_b"]}}, jc)
    ln, mlp = tg.LayerNorm(d), tg.MLP(d, f)
    with torch.no_grad():
        for param, key in ((ln.scale, "scale"), (ln.bias, "bias"), (mlp.c_fc.kernel, "fc_k"),
                           (mlp.c_fc.bias, "fc_b"), (mlp.c_proj.kernel, "pr_k"),
                           (mlp.c_proj.bias, "pr_b")):
            param.copy_(torch.from_numpy(w[key]))
        got = tfd.fused_ln_mlp(torch.from_numpy(h), ln, mlp, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# The shapes the card kernel's plans were chosen at: gpt2 at B = 256 and
# the beam path's 64 rows, gpt2-large's F = 5,120 and Cerebras-GPT-2.7B's F
# = 10,240 at B = 64, the tensor-parallel 32 rows x 1,536 columns
PLAN_SHAPES = ((256, 768, 3072), (64, 768, 3072), (64, 1280, 5120), (64, 2560, 10240),
               (32, 768, 1536))
# The CTAs of the product an NVIDIA H100 80GB HBM3 (132 SMs) holds at once
# in clusters of 1..8 (``tfd.capacity`` on the card: 132, 66, 39, 30, 22,
# 17, 15 and 15 clusters): sizes that do not divide its GPCs leave SMs idle
H100_CAPACITY = (132, 132, 117, 120, 110, 102, 105, 120)


def _ctas(M, K, N, p):
    """What each CTA of plan ``p`` covers, as ``dense_kernel`` in
    csrc/dense_hopper.cuh decodes blockIdx and its cluster rank: (rows
    [r0, r1), columns [n0, n1), chunks [c0, c1), cluster id, rank in the
    cluster)."""
    nk, tiles = K // tfd.CHUNK, N // p.nt
    out = []
    for y in range(-(-M // tfd.TILE_ROWS)):
        for x in range(tiles * p.splits):
            kidx, tile = x % p.splits, x // p.splits
            c0, c1 = kidx * nk // p.splits, (kidx + 1) * nk // p.splits
            csize = p.splits * p.cn
            out.append(((y * tfd.TILE_ROWS, min(M, (y + 1) * tfd.TILE_ROWS)),
                        (tile * p.nt, (tile + 1) * p.nt), (c0, c1),
                        (y, x // csize), x % csize))
    return out


def _most_in_one_wave(M, K, N, ln, cap=H100_CAPACITY):
    """The most CTAs any valid plan of the product takes within one wave
    (0 when none fits)."""
    mt = -(-M // tfd.TILE_ROWS)
    return max([N // nt * s * mt for nt in (64, 128) if N % nt == 0
                for s in range(1, min(tfd.MAX_CLUSTER, K // tfd.CHUNK) + 1)
                for cn in (range(1, tfd.MAX_CLUSTER // s + 1) if ln else (1,))
                if (N // nt) % cn == 0 and N // nt * s * mt <= cap[s * cn - 1]], default=0)


def _check_plan(M, K, N, ln, cap=H100_CAPACITY):
    p = tfd.plan(M, K, N, ln, cap)
    work = _ctas(M, K, N, p)
    seen = {}
    for (r0, r1), (n0, n1), (c0, c1), cluster, rank in work:
        for col in range(n0, n1, 64):
            for c in range(c0, c1):
                seen[(r0, col, c)] = seen.get((r0, col, c), 0) + 1
    want = {(r0, col, c) for r0 in range(0, M, tfd.TILE_ROWS) for col in range(0, N, 64)
            for c in range(K // tfd.CHUNK)}
    assert set(seen) == want and set(seen.values()) == {1}, (M, K, N, p)
    clusters = {}
    for _, (n0, _), (c0, c1), cluster, rank in work:
        clusters.setdefault(cluster, []).append(rank)
        assert c1 > c0  # every CTA has chunks
    assert all(sorted(r) == list(range(p.splits * p.cn)) for r in clusters.values())
    assert p.nt in (64, 128) and N % p.nt == 0 and (N // p.nt) % p.cn == 0
    assert 1 <= p.splits * p.cn <= tfd.MAX_CLUSTER and (ln or p.cn == 1)
    return p, len(work)


@pytest.mark.parametrize("M,D,F", PLAN_SHAPES)
def test_k4_plan_fills_one_wave_at_the_paths_shapes(M, D, F):
    """At each listed shape both products' plans cover every output column
    and every 64-deep chunk of K exactly once, within the portable cluster
    size, in one wave of CTAs on an H100 (no more CTAs than it holds at
    once in clusters of the plan's size) that no other plan's one wave
    outnumbers, and fill at least half of its SMs."""
    for K, N, ln in ((D, F, True), (F, D, False)):
        p, n = _check_plan(M, K, N, ln)
        assert 66 <= n <= H100_CAPACITY[p.splits * p.cn - 1], (M, K, N, p, n)
        assert n == _most_in_one_wave(M, K, N, ln), (M, K, N, p, n)


def test_k4_plan_covers_the_gates_domain():
    """Across the gate's domain (rows a multiple of 8, D and F multiples of
    128, or of 64 on a tensor-parallel rank) every plan covers each column
    and K chunk once, within the cluster size, and fits one wave where any
    plan can, with the most CTAs any one-wave plan has."""
    for M in (8, 16, 24, 56, 64, 72, 128, 136, 200, 256, 264, 512):
        for D, F in ((128, 512), (256, 64), (640, 2560), (768, 1536), (1024, 4096),
                     (1280, 5120), (2560, 10240), (5120, 20480)):
            for K, N, ln in ((D, F, True), (F, D, False)):
                p, n = _check_plan(M, K, N, ln)
                most = _most_in_one_wave(M, K, N, ln)
                if most:
                    assert n == most <= H100_CAPACITY[p.splits * p.cn - 1], (M, K, N, p, n)


# --- gates ----------------------------------------------------------------


def test_gates_match_jax(cross_setup, switches):
    """Each gate says what JAX's says where both are defined; the rules
    that only the TPU has (padded scales, VMEM budgets, T % 256, an even
    head count) are left out."""
    jc, tc, pj, pt, h, (ck, cv, ks, vs) = cross_setup
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    pad = ((0, 0), (0, 0), (0, 0), (0, jg._cross_scale_pad(jc) - jc.n_head))
    jstacks = tuple(map(jnp.asarray, (ck, cv, np.pad(ks, pad), np.pad(vs, pad))))
    tstacks = tuple(map(torch.from_numpy, (ck, cv, ks, vs)))
    _, _, jq, tq, _ = _params({**TINY, "cross_kv_dtype": "int8", "weight_dtype": "int8"}, seed=5)
    for on in (False, True):
        switches(on)
        cases = [  # (JAX args, port args)
            ((jh, pj["blocks"], jstacks), (th, pt.blocks[0], tstacks)),
            ((jh, pj["blocks"], jstacks[:2]), (th, pt.blocks[0], tstacks[:2])),
            ((jnp.concatenate([jh, jh], 1), pj["blocks"], jstacks),
             (torch.cat([th, th], 1), pt.blocks[0], tstacks)),
            ((jh, jq["blocks"], jstacks), (th, tq.blocks[0], tstacks)),
        ]
        for (a, b, c), (x, y, z) in cases:
            assert tcd.supported(x, y, z, tc) == jcd.supported(a, b, c, jc, True)
        for B, T, cfg in ((8, 512, tc), (16, 1024, tc), (8, 512, tc.replace(n_embd=64))):
            jcfg = jc.replace(n_embd=cfg.n_embd)
            assert tda.supported(B, T, cfg) == jda.supported(B, T, jcfg)
    assert tcd.supported(th, pt.blocks[0], tstacks, tc)  # the last round had the switches on

    big = dict(n_layer=2, n_head=4, vocab_size=120, n_positions=64)
    for act in ("gelu_new", "gelu", "relu"):
        for B, L, d, f in ((8, 1, 128, 512), (4, 1, 128, 512), (8, 2, 128, 512),
                           (8, 1, 96, 512), (8, 1, 128, 320)):
            jc2 = JaxConfig.from_model_type("gpt2", n_embd=d, n_inner=f, activation=act, **big)
            tc2 = ModelConfig.from_model_type("gpt2", n_embd=d, n_inner=f, activation=act,
                                              **big)
            jmlp = {"c_fc": {"kernel": jnp.zeros((d, f))}, "c_proj": {"kernel": jnp.zeros((f, d))}}
            want = jfd.supported(jnp.zeros((B, L, d)), jmlp, jc2)
            assert tfd.supported(torch.zeros((B, L, d)), tg.MLP(d, f), tc2) == want
    qmlp = tq.blocks[0].mlp
    assert qmlp.c_fc.kernel_q is not None and not tfd.supported(th, qmlp, tc)
    assert not jfd.supported(jh, jq["blocks"]["mlp"], jc)


# --- the decode step with the switches on -------------------------------


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


def _spies(monkeypatch):
    calls = {}
    _spy(monkeypatch, tcd, "fused_cross_decode", calls)
    _spy(monkeypatch, tfd, "fused_ln_mlp", calls)
    _spy(monkeypatch, tda, "decode_mha_int8", calls)
    return calls


def _decode(side, params, cfg, x, B, L, Lc, T):
    """Prefill, then single-token steps; returns [prefill logits, step
    logits...] and the ops calls of each step."""
    mod, arr = (jg, jnp.asarray) if side == "jax" else (tg, torch.as_tensor)
    fwd = (jax.jit(lambda p, **kw: jg.forward(p, cfg, **kw),
                   static_argnames=("prefix_prefill", "compute_logits"))
           if side == "jax" else lambda p, **kw: tg.forward(p, cfg, **kw))
    with torch.inference_mode():
        cache = mod.init_kv_cache(cfg, B, T, caption_len=Lc,
                                  **({} if side == "jax" else {"device": "cpu"}))
        o = fwd(params, input_ids=arr(x["ids"]), token_type_ids=arr(x["tts"]),
                position_ids=arr(x["pos"]), attention_mask=arr(x["mask"]),
                imgs=arr(x["imgs"]), auds=arr(x["auds"]), caption_ids=arr(x["caps"]),
                encoder_attention_mask=arr(x["cap_mask"]), cache=cache, prefix_prefill=True,
                compute_logits="last")
        out, mask = [np.asarray(o.logits[:, -1])], x["mask"].copy()
        for s, tok in enumerate(x["steps"]):
            mask[:, L + s] = 1.0
            o = fwd(params, input_ids=arr(tok), token_type_ids=arr(np.full((B, 1), 5)),
                    position_ids=arr((x["row_len"] + s)[:, None]), attention_mask=arr(mask),
                    encoder_attention_mask=arr(x["cap_mask"]), cache=o.cache)
            out.append(np.asarray(o.logits[:, -1]))
    return out


# Measured maxima of |port - JAX|: 1.3e-4 at T=24 and 6.3e-7 at T=512
# (an int8 code can flip at a rounding edge between the two packages)
@pytest.mark.parametrize("T", [24, 512])
def test_decode_steps_with_switches_match_jax(switches, monkeypatch, T):
    """Prefill plus three decode steps, int8 KV and cross caches, a
    left-padded batch of 16 with caption-less rows. With the switches on
    each step calls K3 and K4 once per layer; at T=512 also K2 (the long
    cache's branch); the prefill calls none of them."""
    kw = {**TINY, **INT8, "decode_fused_mlp": True}
    jc, tc, pj, pt, _ = _params(kw, seed=6)
    B, L, Lc, steps = 16, 16, 8, 3
    x = _inputs(np.random.default_rng(6), B, L, Lc, T, steps, kw["vocab_size"], ragged=True)
    switches(True)
    want = _decode("jax", pj, jc, x, B, L, Lc, T)
    calls = _spies(monkeypatch)
    got = _decode("torch", pt, tc, x, B, L, Lc, T)
    n = tc.n_layer * steps
    assert calls == {"fused_cross_decode": n, "fused_ln_mlp": n,
                     **({"decode_mha_int8": n} if T >= 512 else {})}
    for a, b in zip(got, want):
        assert np.isfinite(a).all() and np.abs(a - b).max() <= 1e-3


@pytest.mark.parametrize("case", ["switches_off", "int8_weights"])
def test_decode_step_routes_nothing_without_switches(switches, monkeypatch, case):
    """Switches off: no decode step calls K2, K3 or K4. int8 weights with
    the switches on: K3's and K4's gates refuse them, as JAX's do; K2
    reads no weight and has no such rule (nor has JAX's), so it still
    serves the long cache."""
    kw = {**TINY, **INT8, "decode_fused_mlp": case != "switches_off"}
    if case == "int8_weights":
        kw["weight_dtype"] = "int8"
    tc, pt = _params(kw, seed=7)[1::2]
    B, L, Lc, T = 8, 8, 8, 512
    x = _inputs(np.random.default_rng(7), B, L, Lc, T, 2, kw["vocab_size"], ragged=True)
    switches(case != "switches_off")
    calls = _spies(monkeypatch)
    _decode("torch", pt, tc, x, B, L, Lc, T)
    assert calls == ({} if case == "switches_off" else {"decode_mha_int8": 2 * tc.n_layer})


def test_greedy_generate_with_switches_matches_jax(switches, monkeypatch):
    """Greedy ``generate`` with K3 and K4 switched on in both packages:
    the port's tokens equal JAX's wherever JAX's top-2 margin exceeds
    1e-3 (the rule of tests/test_torch_generate.py)."""
    kw = {**TINY, **INT8, "decode_fused_mlp": True}
    jc, tc, pj, pt, _ = _params(kw, seed=8)
    B, Lp, Lc, new = 16, 12, 8, 8
    max_len = Lp + new
    rng = np.random.default_rng(8)
    ids, tts = rng.integers(0, 256, (B, Lp)), rng.integers(0, 256, (B, Lp))
    imgs, auds = (rng.standard_normal((B, 768)).astype(np.float32) for _ in range(2))
    caps = rng.integers(0, 256, (B, Lc))
    switches(True)
    jout = jax.jit(lambda p: jgen.generate(
        p, jc, jnp.asarray(ids), Lp, max_len=max_len, eos_id=7, sp2_id=5,
        token_type_ids=jnp.asarray(tts), imgs=jnp.asarray(imgs), auds=jnp.asarray(auds),
        caption_ids=jnp.asarray(caps), greedy=True))(pj)
    jtok, jlen = np.asarray(jout.tokens), np.asarray(jout.lengths)
    jl = _replay("jax", pj, jc, ids, np.ones((B, Lp), np.float32), tts, imgs, auds, caps,
                 None, jtok, max_len)
    calls = _spies(monkeypatch)
    tout = tgen.generate(pt, tc, torch.as_tensor(ids), Lp, max_len=max_len, eos_id=7,
                         sp2_id=5, token_type_ids=torch.as_tensor(tts),
                         imgs=torch.as_tensor(imgs), auds=torch.as_tensor(auds),
                         caption_ids=torch.as_tensor(caps), greedy=True)
    assert calls["fused_cross_decode"] == calls["fused_ln_mlp"] > 0
    _check_tokens(jtok, tout.tokens.numpy(), jl, Lp, jlen)
    assert (_margin(jl[Lp]) > 1e-3).mean() >= 0.9  # the comparison is not vacuous
