"""Port parity of kernel K7: ergm_tpu_torch.ops.flash_attention against
ergm_tpu's flash route, on the same seeded numpy inputs on the CPU.

``flash_mha`` on the CPU runs the plain version of what the card runs:
in bf16 ``flash_mha_reference``, the arithmetic of JAX's library flash
kernel (one pass over key blocks, p rounded before P·V), held here to that
kernel itself in Pallas's TPU interpret mode; in fp32 K5's plain version.
The rounding of p follows the key block, so the plain version's default
block, the kernels' tile, is fixed at the 128 keys JAX's kernel runs here.
Bars: fp32 outputs 2e-5 and gradients 5e-5 (JAX's kernel tests); bf16
2e-2 + 1e-2 |JAX|.
"""
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from ergm_tpu.ops import attention as jat
from ergm_tpu.ops import block_attention as jba
from ergm_tpu.ops import flash_attention as jfa
from ergm_tpu_torch.ops import attention as tat
from ergm_tpu_torch.ops import block_attention as tba
from ergm_tpu_torch.ops import flash_attention as tfa
from test_torch_block_attention import _leftpad, _library_flash

torch.set_num_threads(1)

PAD = 37  # the left pad of the causal cases: rows before it are padded


def _case(d: int, causal: bool, lq: int, lk: int):
    """Seeded [1, 2, lq, d] inputs, the key mask (left pad PAD), the query
    mask (the key mask when causal) and the rows compared: real rows with a
    visible real key (JAX's segment ids give the others junk); the
    cotangent is zero elsewhere."""
    rng = np.random.default_rng(100 + d + 2 * causal)
    q = rng.standard_normal((1, 2, lq, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, lk, d)).astype(np.float32) for _ in range(2))
    kv_mask = _leftpad(1, lk, [PAD])
    q_mask = kv_mask[:, :lq] if causal else np.ones((1, lq), np.int32)
    seen = kv_mask[:, None, :].astype(bool)
    if causal:
        seen = seen & (np.arange(lk)[None, None, :] <= np.arange(lq)[None, :, None])
    rows = (q_mask.astype(bool) & seen.any(-1))[:, None, :, None]
    g = rng.standard_normal((1, 2, lq, d)).astype(np.float32) * rows
    return q, k, v, g, q_mask, kv_mask, rows


@functools.lru_cache(maxsize=None)
def _jax_run(d: int, causal: bool, lq: int, lk: int, dtype: str):
    """JAX's library flash kernel (TPU interpret mode, 128-blocks) on
    ``_case``: [o, dQ, dK, dV] as float32 numpy (cached: one interpret run
    a case per process)."""
    q, k, v, g, q_mask, kv_mask, _ = _case(d, causal, lq, lk)
    return _library_flash(q, k, v, g, causal, q_mask, kv_mask, getattr(jnp, dtype))


def _port_run(fn, d, causal, lq, lk, dtype, **kw):
    q, k, v, g, q_mask, kv_mask, _ = _case(d, causal, lq, lk)
    tdt = getattr(torch, dtype)
    xs = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    o = fn(*xs, causal=causal, q_mask=torch.from_numpy(q_mask),
           kv_mask=torch.from_numpy(kv_mask), **kw)
    grads = torch.autograd.grad(o, xs, torch.from_numpy(g).to(tdt))
    return [x.detach().float().numpy() for x in (o, *grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,lq,lk", [(True, 256, 256), (False, 128, 256)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_mha_matches_jax_library_kernel(d, causal, lq, lk, dtype):
    """``flash_mha`` on the CPU at the one-pass kernels' own widths 64 and
    128 against JAX's library flash kernel in TPU interpret mode (128-blocks):
    causal [1, 2, 256, d] with a left-pad mask (queries masked as their
    keys), and non-causal Lq = 128 over Lk = 256 with the same key mask; in
    bf16 the plain version's default key block is the kernels' tile, 128,
    JAX's block here. Outputs and dQ on rows with a visible real key: fp32
    within 2e-5 / 5e-5, bf16 within 2e-2 + 1e-2 |JAX|."""
    assert tfa.FLASH_TILES[d] == 128 and tfa.flash_route(d, torch.bfloat16)
    want = _jax_run(d, causal, lq, lk, dtype)
    got = _port_run(tfa.flash_mha, d, causal, lq, lk, dtype)
    rows = _case(d, causal, lq, lk)[-1]
    for i, (a, b_) in enumerate(zip(got, want)):
        if i < 2:  # the output and dQ: rows with a visible real key
            a, b_ = a * rows, b_ * rows
        if dtype == "float32":
            tol = 2e-5 if i == 0 else 5e-5
            np.testing.assert_allclose(a, b_, atol=tol, rtol=tol)
        else:
            assert np.all(np.abs(a - b_) <= 2e-2 + 1e-2 * np.abs(b_)), (i, np.abs(a - b_).max())


def test_k7_rounds_where_jax_library_kernel_rounds():
    """bf16 [1, 2, 256, 64], causal, left pads: the port's plain K7 version
    at JAX's block (128 keys) rounds p where JAX's library kernel does, so
    at most 1% of the real rows' output elements differ from it (0.1% was
    measured); K5's two-pass arithmetic, which rounds p after normalising
    and which served this route before, differs on far more (40% measured),
    which this bar would refuse."""
    want = _jax_run(64, True, 256, 256, "bfloat16")[0]
    rows = np.broadcast_to(_case(64, True, 256, 256)[-1], want.shape)
    shares = {}
    for name, fn in (("flash", tfa.flash_mha_reference), ("two-pass", tba.block_mha_reference)):
        kw = {"block_k": 128} if name == "flash" else {}
        got = _port_run(fn, 64, True, 256, 256, "bfloat16", **kw)[0]
        shares[name] = float((got != want)[rows].mean())
    assert shares["flash"] <= 0.01, shares
    assert shares["two-pass"] > 0.1, shares


@pytest.mark.parametrize("d", [24, 100])
def test_flash_head_width_padding_is_exact(d):
    """What ``flash_mha`` does on the card at a width below its kernels'
    (24 -> 64, 100 -> 128 in bf16): q, k and v zero-padded, through the
    one-pass plain version with the true width's scale, give the unpadded
    problem's output in their first d columns, zeros in the rest, and its
    gradients through the padding (fp32, so that the products' summation
    order alone separates the two: within 1e-6)."""
    width = tfa.head_width(d, torch.bfloat16)
    assert width == (64 if d <= 64 else 128)
    q, k, v, g, q_mask, kv_mask, _ = (torch.from_numpy(x) for x in _case(d, True, 256, 256))
    kw = dict(causal=True, scale=d ** -0.5, q_mask=q_mask, kv_mask=kv_mask, block_k=128)
    runs = []
    for pad in (False, True):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = tfa.flash_mha_reference(*(F.pad(x, (0, width - d)) if pad else x for x in xs), **kw)
        if pad:
            assert o.shape[-1] == width and float(o.detach()[..., d:].abs().max()) == 0.0
            o = o[..., :d]
        runs.append([o, *torch.autograd.grad(o, xs, g)])
    for a, b in zip(*runs):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mha_on_cpu_runs_the_plain_version_of_the_card(dtype):
    """On CPU tensors ``flash_mha`` runs ``kernel_reference``: the one-pass
    arithmetic in bf16 at the kernels' key tile, K5's plain version in
    fp32 (the card's f32 kernels), equal bit for bit."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 2, 256, 100), generator=g).to(dtype) for _ in range(3))
    got = tfa.flash_mha(q, k, v, causal=True)
    want = (tfa.flash_mha_reference(q, k, v, causal=True, block_k=128)
            if dtype == torch.bfloat16 else tba.block_mha_reference(q, k, v, causal=True))
    assert torch.equal(got, want)


# (lq, lk, d, causal, offset, impl, dropout): shapes of both of JAX's gates
# at the library kernel's head widths
ROUTES = [
    (128, 128, 64, True, 0, "pallas", False), (128, 128, 64, True, 0, "pallas", True),
    (1152, 1152, 64, True, 0, "pallas", False), (1152, 1152, 64, True, 0, "pallas", True),
    (256, 256, 64, True, 0, "flash", False), (256, 256, 64, True, 0, "block", False),
    (1152, 1152, 64, True, 0, "block", False), (1152, 1152, 64, True, 0, "flash", True),
    (128, 384, 64, True, 0, "pallas", False), (128, 384, 64, True, 3, "pallas", False),
    (256, 256, 100, True, 0, "pallas", False), (256, 256, 256, True, 0, "pallas", False),
    (256, 256, 32, False, 0, "pallas", True), (256, 512, 64, False, 0, "pallas", False),
    (128, 2048, 128, False, 0, "pallas", False), (1152, 1152, 64, False, 0, "xla", False),
]


@pytest.mark.parametrize("lq,lk,d,causal,offset,impl,dropout", ROUTES)
def test_multihead_attention_routes_as_jax(monkeypatch, lq, lk, d, causal, offset, impl,
                                           dropout):
    """``multihead_attention`` sends each shape to ``block_mha`` (K5),
    ``flash_mha`` (K7) or the plain math exactly as ``ergm_tpu``'s sends it
    to ``block_mha``, ``flash_mha`` or ``xla_attention`` (JAX's gates read
    as if on a TPU), counted through the CPU path; ``flash_mha`` gets the
    masks and scale and never a dropout."""
    import jax

    monkeypatch.setattr(jfa.jax, "default_backend", lambda: "tpu")
    routes = {"jax": [], "port": []}

    def spy(side, name, shape_of=lambda x: x.shape):
        def fn(q, *args, **kw):
            routes[side].append((name, kw))
            return (jnp.zeros if side == "jax" else torch.zeros)(shape_of(q))
        return fn

    monkeypatch.setattr(jba, "block_mha", spy("jax", "block"))
    monkeypatch.setattr(jfa, "flash_mha", spy("jax", "flash"))
    monkeypatch.setattr(jat, "xla_attention", spy("jax", "xla"))
    monkeypatch.setattr(tba, "block_mha", spy("port", "block"))
    monkeypatch.setattr(tfa, "flash_mha", spy("port", "flash"))
    monkeypatch.setattr(tat, "xla_attention", spy("port", "xla"))
    q = np.zeros((1, 1, lq, d), np.float32)
    k = np.zeros((1, 1, lk, d), np.float32)
    qm, km = np.ones((1, lq), np.int32), np.ones((1, lk), np.int32)
    drop = dict(dropout_rate=0.1, deterministic=False) if dropout else {}
    jat.multihead_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), causal=causal,
                            q_mask=jnp.asarray(qm), kv_mask=jnp.asarray(km), scale=0.25,
                            causal_offset=offset, impl=impl,
                            rng=jax.random.PRNGKey(0) if dropout else None, **drop)
    tat.multihead_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                            causal=causal, q_mask=torch.from_numpy(qm),
                            kv_mask=torch.from_numpy(km), scale=0.25, causal_offset=offset,
                            impl=impl, seed=7 if dropout else None, **drop)
    assert [r[0] for r in routes["port"]] == [r[0] for r in routes["jax"]], routes
    name, kw = routes["port"][0]
    if name == "flash":
        assert kw["scale"] == 0.25 and kw["q_mask"] is not None and "dropout_rate" not in kw
    if name == "block":
        assert kw["dropout_rate"] == (0.1 if dropout else 0.0)
