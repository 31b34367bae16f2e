"""Port parity of kernel K5: ergm_tpu_torch.ops.block_attention's plain
version against ergm_tpu.ops.block_attention.block_mha in Pallas
interpret mode, on the same seeded numpy inputs, fp32 on the CPU; and,
for the shapes JAX sends to its library flash kernel (K7), against what
JAX runs there off the TPU (``multihead_attention`` -> ``xla_attention``).

Bars: forward 2e-5, gradients 5e-5, the bars of JAX's own kernel test
(tests/test_block_attention.py). Dropout uses one counter hash on both
sides, so the same seed drops the same probabilities.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from ergm_tpu.ops import attention as jat
from ergm_tpu.ops import block_attention as jba
from ergm_tpu.ops import flash_attention as jfa
from ergm_tpu_torch.core import device as tdevice
from ergm_tpu_torch.ops import attention as tat
from ergm_tpu_torch.ops import block_attention as tba
from ergm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

B, H, L, D = 2, 2, 256, 64
SEED = 1234


def _inputs(rng, lk=L, d=D):
    q = rng.standard_normal((B, H, L, d)).astype(np.float32)
    k = rng.standard_normal((B, H, lk, d)).astype(np.float32)
    v = rng.standard_normal((B, H, lk, d)).astype(np.float32)
    g = rng.standard_normal((B, H, L, d)).astype(np.float32)  # the output's cotangent
    kv_mask = rng.integers(0, 2, (B, lk)).astype(np.int32)
    kv_mask[:, :8] = 1  # early keys real: every causal row sees one
    q_mask = np.ones((B, L), np.int32)
    q_mask[0, -32:] = 0
    q_mask[1, -100:] = 0
    return q, k, v, g, kv_mask, q_mask


def _jax(q, k, v, g, causal, kv_mask, q_mask, rate):
    def f(q, k, v):
        return jba.block_mha(q, k, v, causal=causal, kv_mask=jnp.asarray(kv_mask),
                             q_mask=None if q_mask is None else jnp.asarray(q_mask),
                             dropout_rate=rate,
                             dropout_seed=jnp.int32(SEED) if rate else None, interpret=True)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(o)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch(q, k, v, g, causal, kv_mask, q_mask, rate):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = tba.block_mha(qt, kt, vt, causal=causal, kv_mask=torch.from_numpy(kv_mask),
                      q_mask=None if q_mask is None else torch.from_numpy(q_mask),
                      dropout_rate=rate, dropout_seed=SEED if rate else None)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(g))
    return [o.detach().numpy()] + [x.numpy() for x in grads]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal,lk", [(True, L), (False, 128)])
def test_plain_k5_matches_jax(causal, lk, rate):
    """Causal (L=256) and non-causal (Lk=128), kv and q masks, dropout 0
    and 0.1 on the same seed: output within 2e-5, dQ, dK, dV within 5e-5."""
    q, k, v, g, kv_mask, q_mask = _inputs(np.random.default_rng(0 if causal else 1), lk)
    want = _jax(q, k, v, g, causal, kv_mask, q_mask, rate)
    got = _torch(q, k, v, g, causal, kv_mask, q_mask, rate)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=2e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("d", [24, 128])
def test_plain_k5_matches_jax_at_head_widths(d):
    """The kernels' other head widths (24: padded to 32 on the card; 128,
    the widest): causal, kv and q masks, dropout 0.1, against JAX's
    interpret-mode kernel at the same width: output within 2e-5, dQ, dK,
    dV within 5e-5."""
    q, k, v, g, kv_mask, q_mask = _inputs(np.random.default_rng(10 + d), d=d)
    want = _jax(q, k, v, g, True, kv_mask, q_mask, 0.1)
    got = _torch(q, k, v, g, True, kv_mask, q_mask, 0.1)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=2e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("d", [8, 24, 40, 100])
def test_head_width_padding_is_exact(d):
    """What ``block_mha`` does on the card at a head width it has no kernel
    for: q, k and v zero-padded to ``head_width(d)`` (32, 32, 64; 128 for
    JAX's flash width 100, where ``flash_mha`` pads so in fp32, without
    dropout) through the plain version with
    the true width's scale, causal with masks and dropout 0.1 inside the
    block gate, give the unpadded problem's output in their first d
    columns, zeros in the rest, and its gradients through the padding."""
    width = tba.head_width(d)
    x = torch.zeros(1, d)
    assert width in tba.HEAD_DIMS and width >= d
    assert tba.kernel_takes(x) if d % 8 == 0 else tfa.flash_kernel_takes(x)
    rate = 0.1 if tba.head_ok(d) else 0.0
    q, k, v, g, kv_mask, q_mask = (torch.from_numpy(x) for x in _inputs(
        np.random.default_rng(20 + d), d=d))
    kw = dict(causal=True, scale=d ** -0.5, q_mask=q_mask, kv_mask=kv_mask, dropout_rate=rate,
              dropout_seed=SEED)
    runs = []
    for pad in (False, True):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = tba.block_mha_reference(*(F.pad(x, (0, width - d)) if pad else x for x in xs), **kw)
        if pad:
            assert o.shape[-1] == width and float(o.detach()[..., d:].abs().max()) == 0.0
            o = o[..., :d]
        runs.append([o, *torch.autograd.grad(o, xs, g)])
    for a, b in zip(*runs):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("d", [8, 32, 64, 128, 136, 100, 200, 256])
def test_auto_routes_follow_the_kernels_head_widths(monkeypatch, d):
    """On the card (stood in here by ``core.device.on_card``), ``auto``
    sends self-attention inside JAX's block gate to K5 at its head widths
    (a multiple of 8 up to 128) and every dropout-free shape of JAX's
    flash gate to K7 at the library kernel's head widths (any below 128,
    any multiple of 128: 100 reaches K7 on both shapes through the flash
    gate, 256 too); beyond both (136, 200) it takes the plain math,
    where an explicit ``block`` or ``flash`` raises and ``pallas`` takes the
    plain math. An explicit ``block`` raises at 100 and 256, outside the
    block gate's widths. float16, which the kernel does not take, gets
    the plain math."""
    calls = []
    for mod, name in ((tba, "block_mha"), (tfa, "flash_mha")):
        def spy(*args, _real=getattr(mod, name), **kw):
            calls.append(args[0].shape)
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(tdevice, "on_card", lambda x: True)
    rng = np.random.default_rng(d)
    block = torch.from_numpy(rng.standard_normal((1, 2, 128, d)).astype(np.float32))
    flash = torch.from_numpy(rng.standard_normal((1, 1, 1152, d)).astype(np.float32))
    for x in (block, flash):
        tat.multihead_attention(x, x, x, causal=True, impl="auto")
    kernel = tba.head_ok(d) or tfa.flash_head_ok(d)
    assert kernel == (d not in (136, 200))
    assert len(calls) == (2 if kernel else 0)
    if not tba.head_ok(d):
        with pytest.raises(ValueError, match="multiple of 8 up to 128"):
            tat.multihead_attention(block, block, block, causal=True, impl="block")
    if not kernel:
        with pytest.raises(ValueError, match="below 128 or a multiple of 128"):
            tat.multihead_attention(flash, flash, flash, causal=True, impl="flash")
        tat.multihead_attention(block, block, block, causal=True, impl="pallas")
        assert not calls
    else:
        half = block.half()
        tat.multihead_attention(half, half, half, causal=True, impl="auto")
        assert len(calls) == 2


def test_padded_queries_give_zero_output_and_gradient():
    """Rows with q_mask 0 output exactly 0 and pass exactly 0 to dQ."""
    q, k, v, g, kv_mask, q_mask = _inputs(np.random.default_rng(2))
    o, dq, _, _ = _torch(q, k, v, g, True, kv_mask, q_mask, 0.1)
    pad = q_mask == 0
    assert np.abs(o.transpose(0, 2, 1, 3)[pad]).max() == 0.0
    assert np.abs(dq.transpose(0, 2, 1, 3)[pad]).max() == 0.0
    assert np.abs(o.transpose(0, 2, 1, 3)[~pad]).max() > 0.1


def test_keep_mask_matches_dropout_rate():
    """The hash keeps about 1 - rate of the probabilities, and another seed
    keeps others."""
    a = tat.dropout_keep(SEED, 2, 3, 128, 128, 0.1)
    b = tat.dropout_keep(SEED + 1, 2, 3, 128, 128, 0.1)
    assert abs(float(a.float().mean()) - 0.9) < 0.01
    assert float((a != b).float().mean()) > 0.1


def test_dead_rows_match_jax_forward():
    """Causal rows whose every visible key is masked spread uniformly over
    all keys, as JAX's kernel does (forward only: JAX's hand-written
    backward and the true gradient differ on those rows)."""
    q, k, v, g, kv_mask, _ = _inputs(np.random.default_rng(3))
    kv_mask[:, :5] = 0
    want = _jax(q, k, v, g, True, kv_mask, None, 0.0)[0]
    got = _torch(q, k, v, g, True, kv_mask, None, 0.0)[0]
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_multihead_attention_routes_to_k5(monkeypatch):
    """On K5's gate, ``multihead_attention`` takes K5's route (``block``
    and ``pallas``; ``auto`` for CUDA tensors only) and passes q_mask,
    dropout and seed through; outside the gate it takes the plain math."""
    calls = []
    real = tba.block_mha

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(tba, "block_mha", spy)
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 128, 64)).astype(np.float32))
               for _ in range(3))
    qm = torch.ones((1, 128))
    for impl in ("block", "pallas"):
        tat.multihead_attention(q, k, v, causal=True, q_mask=qm, impl=impl, dropout_rate=0.1,
                                deterministic=False, seed=7)
    assert len(calls) == 2
    assert calls[0]["dropout_rate"] == 0.1 and calls[0]["dropout_seed"] == 7
    assert calls[0]["q_mask"] is qm
    tat.multihead_attention(q, k, v, causal=True, impl="auto")  # CPU: plain math
    tat.multihead_attention(q[:, :, :96], k[:, :, :96], v[:, :, :96], causal=True,
                            impl="block")  # L=96: outside the gate
    monkeypatch.setenv("ERGM_ATTN_IMPL", "xla")
    tat.multihead_attention(q, k, v, causal=True, impl="block")
    assert len(calls) == 2

    # JAX's flash gate (L > 1024): pallas and flash reach K7 (flash_mha),
    # not K5, without dropout; with dropout active, under xla, and under
    # block (which pins JAX's block gate) the plain math runs
    flash_calls = []
    real_flash = tfa.flash_mha

    def flash_spy(*args, **kw):
        flash_calls.append(kw)
        return real_flash(*args, **kw)

    monkeypatch.setattr(tfa, "flash_mha", flash_spy)
    monkeypatch.delenv("ERGM_ATTN_IMPL")
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 1152, 64)).astype(np.float32))
               for _ in range(3))
    for impl in ("flash", "pallas"):
        tat.multihead_attention(q, k, v, causal=True, kv_mask=torch.ones((1, 1152)), impl=impl)
    assert len(calls) == 2 and len(flash_calls) == 2 and "dropout_rate" not in flash_calls[-1]
    for impl in ("flash", "pallas"):
        tat.multihead_attention(q, k, v, causal=True, impl=impl, dropout_rate=0.1,
                                deterministic=False, seed=7)
    tat.multihead_attention(q, k, v, causal=True, impl="block")
    monkeypatch.setenv("ERGM_ATTN_IMPL", "xla")
    tat.multihead_attention(q, k, v, causal=True, impl="flash")
    assert len(calls) == 2 and len(flash_calls) == 2


def _leftpad(b, lk, pads):
    m = np.ones((b, lk), np.int32)
    for i, p in enumerate(pads):
        m[i, :p] = 0
    return m


@pytest.mark.parametrize("lq,lk,d", [(1152, 1152, D), (128, 256, D), (128, 256, 100),
                                     (128, 256, 200), (128, 256, 256)])
def test_plain_k5_matches_jax_on_flash_shapes(lq, lk, d):
    """K7's shapes, causal at offset 0 with a left-pad key mask: the port's
    fp32 route there, ``flash_mha`` on the CPU (K5's plain version, which
    the card's f32 kernels run; padded query rows masked as their keys are) against
    what JAX's ``multihead_attention(impl="pallas")`` runs off the TPU,
    the plain math, at head widths 64 and JAX's flash widths past the
    block gate (100, 256; 200, where the card takes the plain math too).
    Real rows' outputs within 2e-5; dQ, dK and dV against ``jax.vjp``
    within 5e-5, with the cotangent zero on padded rows (JAX's flash
    kernel leaves junk there, K5 zeros)."""
    rng = np.random.default_rng(5 + d)
    b = 1 if lq > 1024 else 2
    q = rng.standard_normal((b, 2, lq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, 2, lk, d)).astype(np.float32) for _ in range(2))
    kv_mask = _leftpad(b, lk, [37, 0][:b])
    q_mask = kv_mask[:, :lq]
    g = rng.standard_normal((b, 2, lq, d)).astype(np.float32) * q_mask[:, None, :, None]
    assert jba.block_attention_supported(q, k, v, causal=True) is False

    def f(q, k, v):
        return jat.multihead_attention(q, k, v, causal=True, kv_mask=jnp.asarray(kv_mask),
                                       q_mask=jnp.asarray(q_mask), impl="pallas")
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(o)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_mha(qt, kt, vt, causal=True, kv_mask=torch.from_numpy(kv_mask),
                        q_mask=torch.from_numpy(q_mask))
    got = [out.detach().numpy()] + [x.numpy() for x in torch.autograd.grad(
        out, (qt, kt, vt), torch.from_numpy(g))]
    real = q_mask.astype(bool)[:, None, :, None]
    np.testing.assert_allclose(got[0] * real, want[0] * real, atol=2e-5, rtol=2e-5)
    for a, b_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b_, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lq,lk,offset,dropout", [
    (128, 128, 0, False), (1152, 1152, 0, False), (2048, 4096, 0, False), (128, 384, 0, False),
    (384, 128, 0, False), (128, 256, 3, False), (64, 64, 0, False), (256, 200, 0, False),
    (1152, 1152, 0, True)])
def test_flash_gate_matches_jax_gate(monkeypatch, causal, lq, lk, offset, dropout):
    """``flash_supported`` is JAX's ``flash_attention_supported`` without
    its TPU check (JAX's gate read as if on a TPU)."""
    monkeypatch.setattr(jfa.jax, "default_backend", lambda: "tpu")
    q = np.zeros((1, 1, lq, D), np.float32)
    k = np.zeros((1, 1, lk, D), np.float32)
    want = jfa.flash_attention_supported(q, k, k, causal=causal, causal_offset=offset,
                                         dropout_active=dropout)
    got = tfa.flash_supported(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                              causal=causal, causal_offset=offset, dropout_active=dropout)
    assert got == want


def _library_takes(d: int) -> bool:
    """The head-width rule of JAX's library TPU flash kernel
    (``jax/experimental/pallas/ops/tpu/flash_attention.py``'s forward
    body: ``divmod(head_dim, MIN_BLOCK_SIZE)`` with a remainder raises
    ``NotImplementedError`` unless the width is below the block)."""
    from jax.experimental.pallas.ops.tpu import flash_attention as fa

    repeats, rem = divmod(d, fa.MIN_BLOCK_SIZE)
    return not (rem and repeats)


@pytest.mark.parametrize("d", [24, 100, 128, 136, 200, 256, 384])
def test_flash_head_widths_match_jax_library(monkeypatch, d):
    """``flash_supported`` at a flash-gate shape is JAX's
    ``flash_attention_supported`` (read as if on a TPU) together with the
    library kernel's head-width rule: where JAX's flash route runs, the
    port's does; where the library raises (136, 200), the port's gate
    refuses and the plain math runs."""
    monkeypatch.setattr(jfa.jax, "default_backend", lambda: "tpu")
    q = np.zeros((1, 1, 1152, d), np.float32)
    want = jfa.flash_attention_supported(q, q, q, causal=True) and _library_takes(d)
    x = torch.from_numpy(q)
    assert tfa.flash_supported(x, x, x, causal=True) == want == tfa.flash_head_ok(d)
    assert want == (d not in (136, 200))


def _library_flash(q, k, v, g, causal, q_mask, kv_mask, dtype):
    """JAX's library TPU flash kernel itself, in Pallas's TPU interpret
    mode, with segment ids as ``ergm_tpu``'s ``flash_mha`` builds them and
    128-blocks: [o, dQ, dK, dV] as float32 numpy."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu import flash_attention as fa

    blocks = fa.BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1,
                           block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128,
                           block_q_dkv=128, block_k_major_dq=128, block_k_dq=128, block_q_dq=128)
    seg = fa.SegmentIds(q=jnp.asarray(q_mask), kv=jnp.asarray(kv_mask))

    def f(q, k, v):
        return fa.flash_attention(q, k, v, segment_ids=seg, causal=causal,
                                  sm_scale=q.shape[-1] ** -0.5, block_sizes=blocks)
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
        grads = vjp(jnp.asarray(g, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,lq,lk", [(True, 256, 256), (False, 128, 256)])
def test_flash_reference_matches_jax_library_kernel(causal, lq, lk, dtype):
    """``flash_mha_reference`` (block_k = 128), the plain version of the
    one-pass kernels, against JAX's library flash kernel in TPU interpret
    mode at Dh = 256: causal [1, 2, 256, 256] with a left-pad mask (queries
    masked as their keys), and non-causal Lq = 128 over Lk = 256 with the
    same key mask. Compared on rows with at least one visible real key
    (JAX's segment ids give other rows junk, the port zeros or a uniform
    spread), the cotangent zero elsewhere: fp32 outputs within 2e-5 and
    gradients within 5e-5; bf16 within 2e-2 + 1e-2 |JAX|."""
    rng = np.random.default_rng(6 if causal else 7)
    d = 256
    q = rng.standard_normal((1, 2, lq, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, lk, d)).astype(np.float32) for _ in range(2))
    kv_mask = _leftpad(1, lk, [37])
    q_mask = kv_mask[:, :lq] if causal else np.ones((1, lq), np.int32)
    seen = kv_mask[:, None, :].astype(bool)
    if causal:
        seen = seen & (np.arange(lk)[None, None, :] <= np.arange(lq)[None, :, None])
    rows = (q_mask.astype(bool) & seen.any(-1))[:, None, :, None]
    g = rng.standard_normal((1, 2, lq, d)).astype(np.float32) * rows
    want = _library_flash(q, k, v, g, causal, q_mask, kv_mask, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    xs = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_mha_reference(*xs, causal=causal, q_mask=torch.from_numpy(q_mask),
                                kv_mask=torch.from_numpy(kv_mask), block_k=128)
    grads = torch.autograd.grad(o, xs, torch.from_numpy(g).to(tdt))
    got = [x.detach().float().numpy() for x in (o, *grads)]
    for i, (a, b_) in enumerate(zip(got, want)):
        if i < 2:  # the output and dQ: rows with a visible real key
            a, b_ = a * rows, b_ * rows
        if dtype == "float32":
            tol = 2e-5 if i == 0 else 5e-5
            np.testing.assert_allclose(a, b_, atol=tol, rtol=tol)
        else:
            assert np.all(np.abs(a - b_) <= 2e-2 + 1e-2 * np.abs(b_)), (i, np.abs(a - b_).max())
