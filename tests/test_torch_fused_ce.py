"""Port parity of kernel K6: ergm_tpu_torch.ops.fused_ce's plain version
against ergm_tpu.ops.fused_ce in Pallas interpret mode, on the same
seeded numpy inputs, fp32 on the CPU.

Bars: NLL 1e-5; gradients rtol 1e-4 / atol 1e-5, the bars of JAX's own
kernel test (tests/test_fused_ce.py).
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from ergm_tpu.ops.fused_ce import fused_lm_loss as jax_fused_lm_loss
from ergm_tpu.ops.fused_ce import fused_softmax_xent as jax_xent
from ergm_tpu_torch.core import device as tdevice
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.models.gpt2 import chunked_lm_loss
from ergm_tpu_torch.ops import fused_ce as tce

torch.set_num_threads(1)


@pytest.mark.parametrize("n,v,d", [(16, 300, 32), (24, 97, 64), (16, 300, 100), (16, 300, 776)])
def test_plain_k6_forward_matches_jax(n, v, d):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((v, d)).astype(np.float32)
    lbl = rng.integers(0, v, (n,)).astype(np.int32)
    lbl[5] = -100  # ignored: NLL logZ on both sides
    want = np.asarray(jax_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lbl), 8, 128, True))
    got = tce.fused_softmax_xent(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(lbl))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_k6_gradients_match_jax():
    """dh and dW against JAX's backward kernels, with an ignored label whose
    row gets zero gradient (JAX's callers zero its cotangent)."""
    rng = np.random.default_rng(1)
    n, v, d = 16, 300, 32
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((v, d)).astype(np.float32)
    lbl = rng.integers(0, v, (n,)).astype(np.int32)
    lbl[3] = -100
    g = rng.standard_normal((n,)).astype(np.float32)
    g[3] = 0.0

    def fused(h, w):
        return jnp.sum(jax_xent(h, w, jnp.asarray(lbl), 8, 128, True) * jnp.asarray(g))

    jh, jw = jax.grad(fused, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_(True) for x in (h, w))
    nll = tce.fused_softmax_xent(th, tw, torch.from_numpy(lbl))
    (nll * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-5)
    assert float(th.grad[3].abs().max()) == 0.0


@pytest.mark.parametrize("d", [100, 776, 2112, 2560])
def test_plain_k6_gradients_match_jax_at_other_widths(d):
    """dh and dW against JAX's backward kernels at widths JAX takes as one
    block and the card runs padded (100 -> 128, 776 -> 832) or as they are
    past 2,048 (2,112; Cerebras-GPT-2.7B's 2,560, where the f32 backward
    splits D into two column groups)."""
    rng = np.random.default_rng(d)
    n, v = 16, 300
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (3.0 / d ** 0.5 * rng.standard_normal((v, d))).astype(np.float32)
    lbl = rng.integers(0, v, (n,)).astype(np.int32)
    lbl[3] = -100
    g = rng.standard_normal((n,)).astype(np.float32)
    g[3] = 0.0

    def fused(h, w):
        return jnp.sum(jax_xent(h, w, jnp.asarray(lbl), 8, 128, True) * jnp.asarray(g))

    jh, jw = jax.grad(fused, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_(True) for x in (h, w))
    nll = tce.fused_softmax_xent(th, tw, torch.from_numpy(lbl))
    (nll * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [36, 100, 2112, 2560, 2600])
def test_width_padding_is_exact(d):
    """What ``fused_softmax_xent`` does on the card at a width the kernels
    do not take as it is: h and W zero-padded to ``padded_width(d)`` (64,
    128, 2,624) through the plain version give the unpadded NLL and,
    through the padding, its gradients; 2,112 and 2,560, multiples of 64,
    run as they are."""
    width = tce.padded_width(d)
    assert width % tce.DIM_STEP == 0 and d <= width < d + tce.DIM_STEP
    assert (width == d) == (d % tce.DIM_STEP == 0)
    rng = np.random.default_rng(d)
    h, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((24, d), (300, d)))
    lbl = torch.from_numpy(rng.integers(0, 300, (24,)))
    lbl[4] = -100
    g = torch.from_numpy(rng.standard_normal((24,)).astype(np.float32))
    runs = []
    for pad in (False, True):
        hh, ww = (x.clone().requires_grad_(True) for x in (h, w))
        nll = tce.fused_softmax_xent_reference(*(F.pad(x, (0, width - d)) if pad else x
                                                 for x in (hh, ww)), lbl)
        runs.append([nll, *torch.autograd.grad((nll * g).sum(), (hh, ww))])
    for a, b in zip(*runs):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [32, 96, 100, 2048, 2112, 2560])
def test_auto_lm_loss_routes_k6_by_width(monkeypatch, d):
    """On the card (stood in here by ``core.device.on_card``), the LM loss
    under ``auto`` takes K6 at every width, as JAX's kernel (2,112 and
    2,560 too, past the old 2,048 cap); float16, which K6 does not take
    and no path of ``ergm_tpu`` reaches, the chunked loss."""
    calls = []
    real = tce.fused_lm_loss

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tce, "fused_lm_loss", spy)
    monkeypatch.setattr(tdevice, "on_card", lambda x: True)
    rng = np.random.default_rng(d)
    cfg = ModelConfig(n_embd=d, vocab_size=40, lm_loss_impl="auto")
    wte = torch.from_numpy(rng.standard_normal((40, d)).astype(np.float32))
    params = types.SimpleNamespace(wte=types.SimpleNamespace(embedding_q=None, embedding=wte))
    hidden = torch.from_numpy(rng.standard_normal((2, 6, d)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 40, (2, 6)))
    want = chunked_lm_loss(hidden, wte, labels, chunk=cfg.loss_chunk)
    got = tg.lm_loss(hidden, params, cfg, labels)
    assert len(calls) == 1
    assert abs(float(got) - float(want)) <= 1e-5
    tg.lm_loss(hidden.half(), params, cfg, labels)
    assert len(calls) == 1


def test_ignored_labels_get_zero_gradient_without_masking():
    """A negative label's row passes no gradient even when the caller
    does not zero its cotangent."""
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32))
    lbl = torch.tensor([1, -100, 3, 4, -1, 6, 7, 8])
    tce.fused_softmax_xent(h, w, lbl).sum().backward()
    assert float(h.grad[1].abs().max()) == 0.0 and float(h.grad[4].abs().max()) == 0.0
    assert float(h.grad[0].abs().max()) > 0.0


def test_fused_lm_loss_matches_chunked_and_jax():
    """fused_lm_loss == the port's chunked_lm_loss == JAX's fused_lm_loss
    (shift, mask, mean), and the first two share their gradients."""
    rng = np.random.default_rng(3)
    B, L, D, V = 2, 24, 32, 150
    hidden = rng.standard_normal((B, L, D)).astype(np.float32)
    wte = rng.standard_normal((V, D)).astype(np.float32)
    labels = rng.integers(0, V, (B, L)).astype(np.int32)
    labels[:, :7] = -100
    want = float(jax_fused_lm_loss(jnp.asarray(hidden), jnp.asarray(wte), jnp.asarray(labels),
                                   block_n=8, block_v=128, interpret=True))
    grads = []
    for fn in (tce.fused_lm_loss, lambda h, w, l: chunked_lm_loss(h, w, l, chunk=8)):
        h = torch.from_numpy(hidden).requires_grad_(True)
        w = torch.from_numpy(wte).requires_grad_(True)
        loss = fn(h, w, torch.from_numpy(labels).long())
        loss.backward()
        assert abs(float(loss.detach()) - want) <= 1e-5
        grads.append((h.grad.numpy(), w.grad.numpy()))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("V,chunk", [(50271, 8192), (50271, 4096), (50271, 16384), (8192, 8192),
                                     (8193, 8192), (300, 8192), (5003, 2048)])
def test_vocab_chunks_cover_a_ragged_vocab(V, chunk):
    """The bf16 backward's chunk plan: in order, contiguous, every chunk
    but the last exactly ``chunk`` wide (a whole number of the kernels'
    256-column tiles), the last ending at V."""
    chunks = tce.vocab_chunks(V, chunk)
    assert chunks[0][0] == 0 and sum(w for _, w in chunks) == V
    for (a, wa), (b, _) in zip(chunks, chunks[1:]):
        assert b == a + wa and wa == chunk
    assert 1 <= chunks[-1][1] <= chunk and chunks[-1][0] + chunks[-1][1] == V


def test_vocab_chunks_refuse_a_partial_tile():
    with pytest.raises(ValueError):
        tce.vocab_chunks(1000, 300)
