"""Port parity: the prefill-attention kernel's plain version
(ergm_tpu_torch/ops/prefill_attention.py) against JAX's Pallas kernel
(run in interpret mode off the TPU) and JAX's plain attention math.

The CUDA kernel itself runs only on a GPU: tests/test_torch_cuda.py
holds its test. fp32 throughout, at the JAX kernel's own 2e-5 bar
(tests/test_prefill_attention.py)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ergm_tpu.ops import prefill_attention as jpa
from ergm_tpu.ops.attention import attention_bias_from_mask, xla_attention
from ergm_tpu_torch.ops import attention as tatt
from ergm_tpu_torch.ops import prefill_attention as tpa

torch.set_num_threads(1)
DH = 64
TOL = 2e-5


def _merged(x):  # [B, H, L, Dh] -> [B, L, H*Dh]
    b, h, l, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b, l, h * d))


def _inputs(seed, B, H, L, Lk, mask_mode):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, L, DH), (B, H, Lk, DH), (B, H, Lk, DH)))
    mask = None
    if mask_mode == "leftpad":
        mask = np.ones((B, Lk), np.float32)
        for b in range(B):
            mask[b, :rng.integers(0, Lk // 2)] = 0.0
    elif mask_mode == "ragged":
        mask = np.ones((B, Lk), np.float32)
        for b in range(B):
            mask[b, int(rng.integers(1, Lk)):] = 0.0
    return q, k, v, mask


def _port(q, k, v, mask, H, causal, scale=1.0 / DH ** 0.5):
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    out = tpa.prefill_mha(t(_merged(q)), t(_merged(k)), t(_merged(v)), t(mask),
                          n_head=H, scale=scale, causal=causal)
    return out.numpy()


def _real_rows(x, mask, causal):
    """Fully padded QUERY rows are junk on every path (uniform weights
    over -1e9 keys): compare real rows only."""
    if mask is None or not causal:
        return x
    return x * mask[:, :, None]


@pytest.mark.parametrize("mask_mode", ["none", "leftpad"])
@pytest.mark.parametrize("B,H,L", [(8, 2, 16), (16, 4, 32)])
def test_causal_matches_jax(B, H, L, mask_mode):
    q, k, v, mask = _inputs(0, B, H, L, L, mask_mode)
    scale = 1.0 / DH ** 0.5
    got = _real_rows(_port(q, k, v, mask, H, True), mask, True)
    jm = None if mask is None else jnp.asarray(mask)
    kern = jpa.prefill_mha(jnp.asarray(_merged(q)), jnp.asarray(_merged(k)),
                           jnp.asarray(_merged(v)), jm, n_head=H, scale=scale)
    np.testing.assert_allclose(got, _real_rows(np.asarray(kern), mask, True),
                               rtol=TOL, atol=TOL)
    bias = attention_bias_from_mask(jm) if jm is not None else None
    plain = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                          bias=bias, scale=scale)
    np.testing.assert_allclose(got, _real_rows(_merged(np.asarray(plain)), mask, True),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mask_mode", ["none", "ragged"])
def test_rectangular_noncausal_matches_jax(mask_mode):
    """The cross-prefill form: Lk != Lq, causal=False, caption mask."""
    B, H, L, Lk = 8, 2, 16, 8
    q, k, v, mask = _inputs(2, B, H, L, Lk, mask_mode)
    got = _port(q, k, v, mask, H, False)
    want = jpa.prefill_mha(jnp.asarray(_merged(q)), jnp.asarray(_merged(k)),
                           jnp.asarray(_merged(v)), None if mask is None else jnp.asarray(mask),
                           n_head=H, scale=1.0 / DH ** 0.5, causal=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_tensor_scale_folds_into_q():
    """A tensor scale (scale_attn_by_inverse_layer_idx) folds into q, as
    JAX folds a traced one."""
    q, k, v, _ = _inputs(1, 8, 2, 16, 16, "none")
    want = _port(q, k, v, None, 2, True, scale=0.125)
    got = _port(q, k, v, None, 2, True, scale=torch.tensor(0.125))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_xla_attention_decode_offset_matches_jax():
    """The plain math with a causal offset and a key bias (the cached
    decode step's form)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, 2, 1, DH)).astype(np.float32)
    k, v = (rng.standard_normal((4, 2, 12, DH)).astype(np.float32) for _ in range(2))
    mask = (rng.random((4, 12)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                         bias=attention_bias_from_mask(jnp.asarray(mask)), causal_offset=7)
    got = tatt.multihead_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   kv_mask=torch.from_numpy(mask), causal_offset=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_gate_matches_jax():
    """Same routing as JAX wherever JAX's VMEM tile budget admits the shape."""
    from ergm_tpu.core.config import ModelConfig as JaxConfig
    from ergm_tpu_torch.core.config import ModelConfig

    for kw in (dict(), dict(n_embd=128, n_head=2), dict(n_embd=128, n_head=4),
               dict(n_embd=1600, n_head=25)):
        jc, tc = JaxConfig(**kw), ModelConfig(**kw)
        for B in (1, 8, 12, 64, 256):
            for L in (8, 12, 16, 128):
                for det in (True, False):
                    assert tpa.supported(B, L, tc, det) == jpa.supported(B, L, jc, det)


@pytest.mark.parametrize("Lq,Lk", [(512, 32), (64, 136)])
def test_cross_form_at_long_queries_and_keys_matches_jax(Lq, Lk):
    """The cross form where the card's kernel walks its keys twice (136
    keys: past the 128 whose scores stay in registers, and not a multiple
    of its 64-key tile) and over the longest query bucket (512 rows: four
    query blocks): the plain version against JAX's kernel in interpret
    mode, a ragged caption mask with one caption wholly masked."""
    B, H = 8, 2
    q, k, v, mask = _inputs(4, B, H, Lq, Lk, "ragged")
    mask[3] = 0.0
    got = _port(q, k, v, mask, H, False)
    want = jpa.prefill_mha(jnp.asarray(_merged(q)), jnp.asarray(_merged(k)),
                           jnp.asarray(_merged(v)), jnp.asarray(mask), n_head=H,
                           scale=1.0 / DH ** 0.5, causal=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def _walk(cta, grid_size, B, H, L, causal):
    """The items CTA ``cta`` of ``grid_size`` takes, in order, as the bf16
    kernel in csrc/prefill_attention.cu decodes them (``hop::Item``):
    (b, h, first query row); ranks run over every (b, h), the last query
    block first when causal."""
    nqb = -(-L // tpa.ITEM_ROWS)
    out = []
    for idx in range(cta, tpa.items(B, H, L), grid_size):
        bh, rank = idx % (B * H), idx // (B * H)
        out.append((bh // H, bh % H, ((nqb - 1 - rank) if causal else rank) * tpa.ITEM_ROWS))
    return out


@pytest.mark.parametrize("B,H,L,causal,sms", [
    (256, 12, 128, True, 132), (64, 20, 128, False, 132), (4, 2, 512, True, 132),
    (8, 2, 200, True, 7), (1, 1, 8, False, 132), (16, 4, 512, False, 132)])
def test_kernel_walk_covers_every_item_once(B, H, L, causal, sms):
    """The card kernel's persistent grid (``grid``; ``_walk``, the kernel's
    decode of an item): the CTAs' walks cover each (batch row, head, block
    of 128 query rows) exactly once, with no more CTAs than SMs or items,
    the last query block first when causal."""
    g = tpa.grid(B, H, L, sms)
    seen = [x for c in range(g) for x in _walk(c, g, B, H, L, causal)]
    want = {(b, h, q0) for b in range(B) for h in range(H) for q0 in range(0, L, 128)}
    assert len(seen) == len(want) == tpa.items(B, H, L) and set(seen) == want
    assert g == min(sms, len(want))
    if causal and L > 128:
        assert _walk(0, g, B, H, L, causal)[0][2] == (L - 1) // 128 * 128
