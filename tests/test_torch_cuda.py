"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither JAX nor ``ergm_tpu``, so it also runs where
JAX is absent. On a machine with an NVIDIA GPU:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX). Tests
marked ``cuda`` skip without a card."""
import numpy as np
import pytest
import torch

from ergm_tpu_torch.ops import prefill_attention as tpa

torch.set_num_threads(1)


def _merged(rng, B, L, D):
    return torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))


def test_wrapper_never_falls_back():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    a device the kernel does not serve is refused, not computed plainly."""
    x = torch.empty((8, 16, 128), device="meta")
    with pytest.raises(ValueError, match="meta"):
        tpa.prefill_mha(x, x, x, None, n_head=2, scale=0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,Lk", [(True, 96), (False, 40), (False, 512)])
def test_prefill_kernel_matches_reference(dtype, tol, causal, Lk):
    """K1 against its plain version: causal with a left-pad mask, and the
    rectangular cross form with a ragged caption mask, including the
    largest key count the kernel takes. fp32 with TF32 off at JAX's 2e-5
    bar; bf16 within output rounding plus summation order (2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, L = 16, 4, (96 if causal else 64)
    rng = np.random.default_rng(4)
    q, k, v = (_merged(rng, B, n, H * 64).to("cuda", dtype) for n in (L, Lk, Lk))
    mask = np.ones((B, Lk), np.float32)
    for b in range(B):
        if causal:
            mask[b, :rng.integers(0, Lk // 2)] = 0.0
        else:
            mask[b, int(rng.integers(1, Lk)):] = 0.0
    m = torch.from_numpy(mask).cuda()
    before = tpa.LAUNCHES
    got = tpa.prefill_mha(q, k, v, m, n_head=H, scale=0.125, causal=causal)
    want = tpa.prefill_mha_reference(q, k, v, m, n_head=H, scale=0.125, causal=causal)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES == before + 1
    rows = m[:, :, None] if causal else 1.0  # padded query rows are junk on both
    err = ((got.float() - want.float()) * rows).abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
def test_prefill_kernel_reads_strided_views():
    """q, k and v as column slices of one fused qkv projection (the model's
    layout) give the same result as contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(5)
    qkv = _merged(rng, 8, 32, 3 * 128).to("cuda", torch.bfloat16)
    q, k, v = qkv.split(128, dim=-1)
    got = tpa.prefill_mha(q, k, v, None, n_head=2, scale=0.125)
    want = tpa.prefill_mha(q.contiguous(), k.contiguous(), v.contiguous(), None,
                           n_head=2, scale=0.125)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_prefill_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.zeros((8, 16, 128), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        tpa.prefill_mha(x, x, x, None, n_head=2, scale=0.125)
    y = torch.zeros((8, 16, 96), device="cuda")
    with pytest.raises(ValueError):
        tpa.prefill_mha(y, y, y, None, n_head=2, scale=0.125)  # head dim 48
    long_k = torch.zeros((8, 520, 128), device="cuda")
    with pytest.raises(ValueError):
        tpa.prefill_mha(torch.zeros((8, 16, 128), device="cuda"), long_k, long_k, None,
                        n_head=2, scale=0.125, causal=False)
