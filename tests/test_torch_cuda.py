"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither JAX nor ``ergm_tpu``, so it also runs where
JAX is absent. On a machine with an NVIDIA GPU:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX). Tests
marked ``cuda`` skip without a card."""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.ops import block_attention as tba
from ergm_tpu_torch.ops import cross_decode as tcd
from ergm_tpu_torch.ops import decode_attention as tda
from ergm_tpu_torch.ops import flash_attention as tfa
from ergm_tpu_torch.ops import fused_ce as tce
from ergm_tpu_torch.ops import fused_decode as tfd
from ergm_tpu_torch.ops import prefill_attention as tpa

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _tf32_restored():
    """Tests here turn TF32 (and cuBLAS's reduced-precision bf16 reductions)
    off for their bars; each test leaves the process's settings as it found
    them."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = saved


def _merged(rng, B, L, D):
    return torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))


def _block(d, n_head, dtype, device, activation="gelu_new", seed=0, std=0.05):
    """A decoder block with N(0, std) weights and biases and N(1, 0.1)
    LayerNorm scales, in ``dtype`` on ``device``."""
    cfg = ModelConfig(n_layer=2, n_embd=d, n_head=n_head, vocab_size=64, n_positions=16,
                      dtype="bfloat16" if dtype == torch.bfloat16 else "float32",
                      activation=activation)
    blk = tg.Block(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            x = torch.randn(p.shape, generator=g)
            p.copy_(1.0 + 0.1 * x if name.endswith("ln_2.scale") or name.endswith("ln_cross.scale")
                    else std * x)
    return cfg, blk.to(device, dtype).requires_grad_(False)


def _cross_stacks(rng, L, B, Lc, D, H, device):
    codes = [torch.from_numpy(rng.integers(-127, 128, (L, B, Lc, D)).astype(np.int8))
             for _ in range(2)]
    scales = [torch.from_numpy(rng.uniform(0.001, 0.02, (L, B, Lc, H)).astype(np.float32))
              for _ in range(2)]
    return tuple(x.to(device) for x in (*codes, *scales))


def _k2_inputs(rng, B, H, T, dtype, device):
    q = torch.from_numpy(rng.standard_normal((B, H, 1, 64)).astype(np.float32))
    kq, vq = (torch.from_numpy(rng.integers(-127, 128, (B, H, T, 64)).astype(np.int8))
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.001, 0.02, (B, H, T, 1)).astype(np.float32))
              for _ in range(2))
    return (q.to(device, dtype), kq.to(device), vq.to(device), ks.to(device, torch.bfloat16),
            vs.to(device, torch.bfloat16))


def _within(got, want, dtype, tol):
    """fp32: |got - want| <= tol. bf16: one output rounding plus the
    summation order, |got - want| <= 2e-2 + 1e-2 |want|."""
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return err.max().item() <= tol, err.max().item()
    return bool((err <= 2e-2 + 1e-2 * want.float().abs()).all()), err.max().item()


def test_wrapper_never_falls_back():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    a device the kernel does not serve is refused, not computed plainly."""
    x = torch.empty((8, 16, 128), device="meta")
    with pytest.raises(ValueError, match="meta"):
        tpa.prefill_mha(x, x, x, None, n_head=2, scale=0.125)


@pytest.mark.parametrize("kernel", ["fused_ln_mlp", "fused_cross_decode", "decode_mha_int8"])
def test_decode_wrappers_never_fall_back(kernel):
    """K2, K3 and K4 refuse a tensor on a device they do not serve."""
    cfg, blk = _block(128, 2, torch.float32, "meta")
    h = torch.empty((8, 1, 128), device="meta")
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="meta"):
        if kernel == "fused_ln_mlp":
            tfd.fused_ln_mlp(h, blk.ln_2, blk.mlp, cfg)
        elif kernel == "fused_cross_decode":
            stacks = _cross_stacks(rng, 2, 8, 4, 128, 2, "meta")
            tcd.fused_cross_decode(h, blk, 0, 0.125, stacks, None, cfg)
        else:
            q, kq, vq, ks, vs = _k2_inputs(rng, 8, 2, 512, torch.float32, "meta")
            tda.decode_mha_int8(q, kq, vq, ks, vs, 100, 0.125, n_head=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,L,Lk", [(True, 96, 96), (True, 128, 128), (True, 256, 256),
                                         (False, 64, 40), (False, 128, 32), (False, 128, 256),
                                         (False, 64, 512)])
def test_prefill_kernel_matches_reference(dtype, tol, causal, L, Lk):
    """K1 against its plain version: causal with a left-pad mask (the
    bf16 kernel's register path at 128 keys, two query blocks and the
    two-pass path at 256), and the rectangular cross form with a ragged
    caption mask (register path up to 128 keys, two-pass beyond, up to the
    largest key count the kernel takes). Compared on real rows. fp32 with
    TF32 off at JAX's 2e-5 bar; bf16 within output rounding plus
    summation order (2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H = 16, 4
    rng = np.random.default_rng(4)
    q, k, v = (_merged(rng, B, n, H * 64).to("cuda", dtype) for n in (L, Lk, Lk))
    mask = np.ones((B, Lk), np.float32)
    for b in range(B):
        if causal:
            mask[b, :rng.integers(0, Lk // 2)] = 0.0
        else:
            mask[b, int(rng.integers(1, Lk)):] = 0.0
    m = torch.from_numpy(mask).cuda()
    before = (tpa.LAUNCHES, tpa.CROSS_LAUNCHES)
    got = tpa.prefill_mha(q, k, v, m, n_head=H, scale=0.125, causal=causal)
    want = tpa.prefill_mha_reference(q, k, v, m, n_head=H, scale=0.125, causal=causal)
    torch.cuda.synchronize()
    assert (tpa.LAUNCHES, tpa.CROSS_LAUNCHES) == (before[0] + 1, before[1] + (not causal))
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
    # bf16 operands go in by TMA: row strides must be multiples of 16 bytes
    z = torch.zeros((8, 16, 132), device="cuda", dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="multiples of 8"):
        tpa.prefill_mha(z, z, z, None, n_head=2, scale=0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, None)])
@pytest.mark.parametrize("act", ["gelu_new", "gelu"])
@pytest.mark.parametrize("B", [8, 24, 256, 264])
def test_fused_ln_mlp_kernel_matches_reference(dtype, tol, act, B):
    """K4 against its plain version; fp32 with TF32 off at JAX's 2e-5
    bar. h is a strided view, as the model's residual stream can be. B
    past a 256-row tile (264) and under one (8, 24) leaves rows for the
    kernel to zero-fill. One call starts two kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, blk = _block(256, 4, dtype, "cuda", activation=act, seed=1)
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((B, 1, 2 * 256)).astype(np.float32))
    h = h.to("cuda", dtype)[..., :256]
    before = tfd.LAUNCHES
    got = tfd.fused_ln_mlp(h, blk.ln_2, blk.mlp, cfg)
    want = tfd.fused_ln_mlp_reference(h, blk.ln_2, blk.mlp, cfg)
    torch.cuda.synchronize()
    assert tfd.LAUNCHES == before + 1 and got.shape == want.shape
    assert tfd.KERNELS_PER_CALL == 2
    ok, err = _within(got, want, dtype, tol)
    assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("causal,B,H,L,Lk", [
    (True, 8, 2, 40, 40), (True, 8, 2, 200, 200),  # ragged L: a part of a query block
    (True, 4, 2, 512, 512),                         # four query blocks, two passes
    (False, 8, 2, 72, 8), (False, 8, 2, 128, 40),   # key counts under and past a tile
    (False, 8, 2, 136, 136), (False, 4, 2, 512, 512),  # two passes, Lk not a tile multiple
    (False, 16, 4, 512, 32),                        # the cross form at Lq = 512
    (True, 64, 20, 128, 128), (False, 64, 20, 128, 32),  # gpt2-large's width
])
def test_prefill_kernel_at_every_walk(causal, B, H, L, Lk):
    """K1's bf16 kernel against its plain version at the shapes its walks
    take apart: a ragged last query block, key counts that are not a
    multiple of the tile (8, 40, 136), the one-pass (<= 128 keys) and two-
    pass walks, q a column slice of a fused [B, L, 3D] projection (row
    stride 3D) and k, v of a fused [B, Lk, 2D] one. The causal form has left
    pads and is compared on real rows; the cross form has a ragged caption
    mask with one caption wholly masked (JAX's uniform row). Two calls are
    bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(L + Lk + int(causal))
    D = H * 64
    qkv = _merged(rng, B, L, 3 * D).to("cuda", torch.bfloat16)
    kv = _merged(rng, B, Lk, 2 * D).to("cuda", torch.bfloat16)
    q = qkv[..., :D]
    k, v = (qkv[..., D:2 * D], qkv[..., 2 * D:]) if causal else kv.split(D, dim=-1)
    mask = np.ones((B, Lk), np.float32)
    for b in range(B):
        if causal:
            mask[b, :rng.integers(0, Lk // 2)] = 0.0
        else:
            mask[b, int(rng.integers(1, Lk + 1)):] = 0.0
    if not causal:
        mask[B // 2] = 0.0
    m = torch.from_numpy(mask).cuda()
    got = tpa.prefill_mha(q, k, v, m, n_head=H, scale=0.125, causal=causal)
    again = tpa.prefill_mha(q, k, v, m, n_head=H, scale=0.125, causal=causal)
    want = tpa.prefill_mha_reference(q, k, v, m, n_head=H, scale=0.125, causal=causal)
    torch.cuda.synchronize()
    # the grid, items and key tile the C side launched with, as it reports them
    items = -(-L // 128) * B * H
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert list(tpa.LAST_GRID) == [min(items, sms), items, 32 if Lk <= 32 else 64]
    rows = m[:, :L, None] if causal else 1.0
    ok, err = _within(got * rows, want * rows, torch.bfloat16, None)
    assert ok, err
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu_new", "gelu"])
@pytest.mark.parametrize("B,D", [(8, 768), (32, 768), (64, 768), (256, 768), (264, 256),
                                 (64, 1280), (64, 2560)])
def test_fused_ln_mlp_kernel_at_every_plan(act, B, D):
    """K4's bf16 kernels against their plain version at the rows of every
    path (8, the tensor-parallel 32, the beam path's 64, the headline 256,
    past one 256-row tile) and at F = 3,072, 5,120 and 10,240 (gpt2,
    gpt2-large, Cerebras-GPT-2.7B: F = 4D): the bf16 bar, two kernels a
    call, the planner's plans, and two calls bitwise equal. The weights
    are N(0, 0.02), GPT-2's initialisation and chip_smoke.py's: at the
    0.05 of the narrow tests the outputs at D = 2,560 reach |40|, and a
    one-ulp flip of the rounded down projection where h cancels it puts
    the plain version itself past the bar against a float64 evaluation
    of the same rounding points. The plain version's cuBLAS products
    reduce in f32 (PyTorch lets cuBLAS round split-K partials to bf16 by
    default, which at K = 10,240 moves its output by more than the
    kernel's summation order does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg, blk = _block(D, D // 64, torch.bfloat16, "cuda", activation=act, seed=11, std=0.02)
    rng = np.random.default_rng(B + D)
    h = torch.from_numpy(rng.standard_normal((B, 1, D)).astype(np.float32)).to("cuda",
                                                                               torch.bfloat16)
    got = tfd.fused_ln_mlp(h, blk.ln_2, blk.mlp, cfg)
    again = tfd.fused_ln_mlp(h, blk.ln_2, blk.mlp, cfg)
    want = tfd.fused_ln_mlp_reference(h, blk.ln_2, blk.mlp, cfg)
    torch.cuda.synchronize()
    assert tfd.KERNELS_PER_CALL == 2 and got.shape == want.shape
    cap = tfd.capacity(h.device)
    F = 4 * D
    up, down = tfd.plan(B, D, F, True, cap), tfd.plan(B, F, D, False, cap)
    assert tfd.LAST_PLANS == (up, down)
    # the grids and clusters the C side launched with, as it reports them
    mt = -(-B // tfd.TILE_ROWS)
    assert list(tfd.LAST_GRID) == [2, F // up.nt * up.splits, mt, up.splits * up.cn,
                                   D // down.nt * down.splits, mt, down.splits]
    ok, err = _within(got, want, torch.bfloat16, None)
    assert ok, err
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [32, 64])
def test_fused_ln_mlp_partial_kernel_repeats(B):
    """K4's tensor-parallel form in bf16 on one rank's 1,536 of gpt2's 3,072
    columns (the 32 rows of a data rank, and 64): the f32 partial within
    the bar of its plain version, two calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, blk = _block(768, 12, torch.bfloat16, "cuda", seed=12)
    part, _ = _rank_parts(blk, cfg, 2)[0]
    h = torch.from_numpy(np.random.default_rng(B).standard_normal((B, 1, 768)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    got = tfd.fused_ln_mlp_partial(h, part.ln_2, part.mlp, cfg)
    again = tfd.fused_ln_mlp_partial(h, part.ln_2, part.mlp, cfg)
    want = tfd.fused_ln_mlp_partial_reference(h, part.ln_2, part.mlp, cfg)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and tfd.KERNELS_PER_CALL == 2
    ok, err = _within(got, want, torch.bfloat16, None)
    assert ok, err
    assert torch.equal(got, again)


_THREAD_FIRST = {
    "prefill_mha": "qkv = torch.randn((64, 128, 3 * 768), device='cuda').bfloat16()\n"
                   "args = qkv.split(768, dim=-1)\n"
                   "from ergm_tpu_torch.ops import prefill_attention as m\n"
                   "run = lambda: m.prefill_mha(*args, None, n_head=12, scale=0.125)\n"
                   "plain = lambda: m.prefill_mha_reference(*args, None, n_head=12, "
                   "scale=0.125)\n",
    "fused_ln_mlp": "from ergm_tpu_torch.core.config import ModelConfig\n"
                    "from ergm_tpu_torch.models import gpt2\n"
                    "from ergm_tpu_torch.ops import fused_decode as m\n"
                    "cfg = ModelConfig(n_layer=1, n_embd=768, n_head=12, vocab_size=64, "
                    "n_positions=16, dtype='bfloat16')\n"
                    "blk = gpt2.Block(cfg)\n"
                    "torch.manual_seed(0)\n"
                    "for p in blk.parameters():\n"
                    "    torch.nn.init.normal_(p, 0.0, 0.02)\n"
                    "blk = blk.to('cuda', torch.bfloat16)\n"
                    "h = torch.randn((64, 1, 768), device='cuda').bfloat16()\n"
                    "run = lambda: m.fused_ln_mlp(h, blk.ln_2, blk.mlp, cfg)\n"
                    "plain = lambda: m.fused_ln_mlp_reference(h, blk.ln_2, blk.mlp, cfg)\n",
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(_THREAD_FIRST))
def test_kernel_as_a_threads_first_cuda_work(kernel):
    """K1 and K4 (whose bf16 kernels encode TMA tensor maps) called from a
    new thread whose first CUDA work the call is, as the HTTP front end's
    driver thread calls them, in a fresh process: the call binds the
    device's context itself, and its result is the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import os
    import subprocess
    import sys

    code = ("import threading, torch\n" + _THREAD_FIRST[kernel] +
            "box = {}\n"
            "def work():\n"
            "    box['got'] = run()\n"
            "    torch.cuda.synchronize()\n"
            "t = threading.Thread(target=work)\n"
            "t.start()\n"
            "t.join()\n"
            "want = plain()\n"
            "err = (box['got'].float() - want.float()).abs()\n"
            "assert bool((err <= 2e-2 + 1e-2 * want.float().abs()).all()), err.max()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, None)])
@pytest.mark.parametrize("mask_mode", ["none", "ragged", "empty_row"])
@pytest.mark.parametrize("B,Lc", [(1, 21), (16, 21), (256, 21), (300, 21), (16, 150)])
def test_cross_decode_kernel_matches_reference(dtype, tol, mask_mode, B, Lc):
    """K3 against its plain version over layer 1 of a two-layer stacked
    int8 cache with an odd caption length, at batches under and past a
    256-row tile, and a caption longer than the attention's 64-token tile.
    One call starts three kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    D, H = 256, 4
    cfg, blk = _block(D, H, dtype, "cuda", seed=2)
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.standard_normal((B, 1, D)).astype(np.float32)).to("cuda", dtype)
    stacks = _cross_stacks(rng, 2, B, Lc, D, H, "cuda")
    mask = None
    if mask_mode != "none":
        m = (np.arange(Lc)[None] < rng.integers(1, Lc + 1, (B, 1))).astype(np.float32)
        if mask_mode == "empty_row":
            m[min(3, B - 1)] = 0.0
        mask = torch.from_numpy(m).cuda()
    before = tcd.LAUNCHES
    got = tcd.fused_cross_decode(h, blk, 1, 0.125, stacks, mask, cfg)
    want = tcd.fused_cross_decode_reference(h, blk, 1, 0.125, stacks, mask, cfg)
    torch.cuda.synchronize()
    assert tcd.LAUNCHES == before + 1 and got.shape == want.shape
    assert tcd.KERNELS_PER_CALL == 3
    ok, err = _within(got, want, dtype, tol)
    assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_ln_mlp", "fused_cross_decode"])
def test_decode_kernels_repeat_bitwise(kernel):
    """K4 and K3 in bf16 at the slice's width (D = 768, B = 256, where the
    projections split K over clusters of 4 to 8 CTAs): two calls on the
    same inputs are bitwise equal, since the split partials are added in
    a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    B, D, H = 256, 768, 12
    cfg, blk = _block(D, H, torch.bfloat16, "cuda", seed=3)
    rng = np.random.default_rng(6)
    h = torch.from_numpy(rng.standard_normal((B, 1, D)).astype(np.float32)).to("cuda",
                                                                               torch.bfloat16)
    if kernel == "fused_ln_mlp":
        run = lambda: tfd.fused_ln_mlp(h, blk.ln_2, blk.mlp, cfg)  # noqa: E731
    else:
        stacks = _cross_stacks(rng, 2, B, 32, D, H, "cuda")
        mask = torch.from_numpy((np.arange(32)[None] < rng.integers(0, 33, (B, 1)))
                                .astype(np.float32)).cuda()
        run = lambda: tcd.fused_cross_decode(h, blk, 1, 0.125, stacks, mask, cfg)  # noqa: E731
    first, second = run(), run()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(first).all()) and torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4), (torch.bfloat16, None)])
@pytest.mark.parametrize("B,H,T,index,leftpad,cluster", [
    (8, 4, 512, 400, True, None), (8, 4, 768, 767, False, None), (8, 4, 1024, 5, True, None),
    (1, 12, 1024, 1000, True, None),  # a single request: the row split 8 ways
    (64, 12, 512, 400, True, None),   # the long-history shape
    (2, 2, 8192, 8191, True, None),   # the most slots: 1024 keys a CTA
    (8, 4, 512, 0, False, None),      # index 0
    (8, 4, 512, 0, False, 8),         # index 0 over 8 CTAs: 7 empty
    (8, 4, 512, 112, True, 8),        # 16-key slices: index at the first key of the last
    (8, 4, 512, 127, True, 8),        # ... and at the last key of the last
    (8, 4, 512, 15, False, 8),        # one slice of keys: ranks 1..7 empty
    (4, 2, 1024, 1000, 300, 8),       # a left pad of 300 covers slices 0 and 1 (128 keys)
])
def test_decode_attention_kernel_matches_reference(dtype, tol, B, H, T, index, leftpad,
                                                   cluster):
    """K2 against its plain version, reading layer 1 of a stacked cache in
    place, with q as a strided view of a fused projection; keys split over
    the wrapper's cluster (``plan``) or the one given. ``leftpad``: random
    left pads up to min(index, 200), or that many padded slots in every
    row."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    q, kq, vq, ks, vs = _k2_inputs(rng, B, H, T, dtype, "cuda")
    qkv = torch.cat([q, q, q], dim=-1)  # [B, H, 1, 192]
    q = qkv[..., 64:128]
    stack = [torch.stack([torch.zeros_like(x), x]) for x in (kq, vq, ks, vs)]
    mask = None
    if leftpad is not False:
        pads = (rng.integers(0, min(index, 200) + 1, B) if leftpad is True
                else np.full(B, leftpad))
        mask = torch.from_numpy((np.arange(T)[None] >= pads[:, None]).astype(np.float32)).cuda()
    before = tda.LAUNCHES
    got = tda.decode_mha_int8(q, *(x[1] for x in stack), index, 0.125, mask, n_head=H,
                              cluster=cluster)
    want = tda.decode_mha_int8_reference(q, kq, vq, ks, vs, index, 0.125, mask, n_head=H)
    torch.cuda.synchronize()
    assert tda.LAUNCHES == before + 1 and got.shape == (B, H * 64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert tda.LAST_CLUSTER == (cluster or tda.plan(B, H, T, index, sms))
    assert bool(torch.isfinite(got).all())
    ok, err = _within(got, want, dtype, tol)
    assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,index", [(64, 512, 400), (1, 1024, 1000), (256, 256, 200)])
def test_decode_attention_repeats_bitwise_in_one_launch(B, T, index):
    """K2 in bf16 at the long-history, single-request and headline-cache
    shapes: two calls are bitwise equal (the cluster adds its partials in
    rank order), and a call is one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    H = 12
    rng = np.random.default_rng(7)
    q, kq, vq, ks, vs = _k2_inputs(rng, B, H, T, torch.bfloat16, "cuda")
    pads = rng.integers(0, 200, B)
    mask = torch.from_numpy((np.arange(T)[None] >= pads[:, None]).astype(np.float32)).cuda()
    before = tda.LAUNCHES
    first = tda.decode_mha_int8(q, kq, vq, ks, vs, index, 0.125, mask, n_head=H)
    second = tda.decode_mha_int8(q, kq, vq, ks, vs, index, 0.125, mask, n_head=H)
    torch.cuda.synchronize()
    assert tda.LAUNCHES == before + 2
    assert bool(torch.isfinite(first).all()) and torch.equal(first, second)


@pytest.mark.cuda
def test_decode_kernels_reject_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, blk = _block(128, 2, torch.float32, "cuda")
    h16 = torch.zeros((8, 1, 128), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        tfd.fused_ln_mlp(h16, blk.ln_2, blk.mlp, cfg)
    with pytest.raises(ValueError):  # two tokens per row
        tfd.fused_ln_mlp(torch.zeros((8, 2, 128), device="cuda"), blk.ln_2, blk.mlp, cfg)
    stacks = _cross_stacks(np.random.default_rng(0), 2, 8, 4, 128, 2, "cuda")
    h = torch.zeros((8, 1, 128), device="cuda")
    with pytest.raises(ValueError):  # the unquantized cache
        tcd.fused_cross_decode(h, blk, 0, 0.125, stacks[:2], None, cfg)
    with pytest.raises(ValueError):  # no such layer
        tcd.fused_cross_decode(h, blk, 2, 0.125, stacks, None, cfg)
    q, kq, vq, ks, vs = _k2_inputs(np.random.default_rng(0), 8, 2, 512, torch.float32, "cuda")
    with pytest.raises(ValueError):  # index past the cache
        tda.decode_mha_int8(q, kq, vq, ks, vs, 512, 0.125, n_head=2)
    with pytest.raises(ValueError):  # a bf16 cache instead of int8 codes
        tda.decode_mha_int8(q, kq.bfloat16(), vq, ks, vs, 100, 0.125, n_head=2)
    with pytest.raises(ValueError):  # past the portable cluster size
        tda.decode_mha_int8(q, kq, vq, ks, vs, 100, 0.125, n_head=2, cluster=9)
    # bf16 rows off a 16-byte boundary: the decode GEMM's copies need it
    cfg16, blk16 = _block(128, 2, torch.bfloat16, "cuda")
    skew = torch.zeros((8, 1, 129), device="cuda", dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        tfd.fused_ln_mlp(skew, blk16.ln_2, blk16.mlp, cfg16)
    stacks16 = _cross_stacks(np.random.default_rng(0), 2, 8, 4, 128, 2, "cuda")
    with pytest.raises(ValueError, match="16-byte"):
        tcd.fused_cross_decode(skew, blk16, 0, 0.125, stacks16, None, cfg16)


@pytest.mark.parametrize("kernel", ["block_mha", "fused_softmax_xent", "flash_mha"])
def test_training_wrappers_never_fall_back(kernel):
    """K5, K6 and K7 refuse a tensor on a device they do not serve."""
    with pytest.raises(ValueError, match="meta"):
        if kernel in ("block_mha", "flash_mha"):
            x = torch.empty((2, 2, 128, 64), device="meta")
            (tba.block_mha if kernel == "block_mha" else tfa.flash_mha)(x, x, x, causal=True)
        else:
            tce.fused_softmax_xent(torch.empty((8, 128), device="meta"),
                                   torch.empty((32, 128), device="meta"),
                                   torch.empty((8,), dtype=torch.int64, device="meta"))


def _bf16_grad_ratio(got, plain, exact):
    """How far a bf16 gradient is from its bar; above 1 fails. ``exact`` is
    the same math in f32 on the same (bf16-valued) inputs. The kernel's
    error against it may be at most twice the plain bf16 version's, over
    the whole tensor (rms) and in each row (rms over the last dim, plus
    0.1 rms(exact) for rows the plain version gets exactly): the kernels
    round ds and padj where the plain autograd rounds dP and the output,
    and K5's delta = rowsum(dO∘O) carries O's rounding."""
    g, p, x = got.float(), plain.float(), exact.float()
    assert bool(torch.isfinite(g).all())
    ek, ep = g - x, p - x
    whole = ek.pow(2).mean().sqrt() / (2 * ep.pow(2).mean().sqrt()).clamp_min(1e-30)
    rows = ek.pow(2).mean(-1).sqrt() / (2 * ep.pow(2).mean(-1).sqrt()
                                        + 0.1 * x.pow(2).mean().sqrt())
    return max(whole.item(), rows.max().item())


def _grads_within(got, want, dtype, f32_tol, exact=()):
    """fp32: elementwise atol = rtol = ``f32_tol`` (JAX's kernel tests) of
    the plain version; bf16: ``_bf16_grad_ratio`` against ``exact``."""
    for a, b, x in zip(got, want, exact if dtype == torch.bfloat16 else want):
        if dtype == torch.float32:
            err = (a - b).abs()
            assert bool((err <= f32_tol + f32_tol * b.abs()).all()), err.max().item()
        else:
            ratio = _bf16_grad_ratio(a, b, x)
            assert ratio <= 1.0, ratio


def _k5_case(dtype, causal, Lk, rate, masks, seed=0, d=64, L=256, plain=tba.block_mha_reference,
             kernel=tba.block_mha):
    """(kernel, plain, plain in f32) runs, each [o, dQ, dK, dV], at head
    width d; the f32 run only for bf16 inputs. ``kernel``: K5's
    ``block_mha`` or K7's ``flash_mha`` (no dropout)."""
    g = torch.Generator().manual_seed(seed)
    B, H = 2, 4
    q, k, v, do = (torch.randn(s, generator=g).to("cuda", dtype)
                   for s in ((B, H, L, d), (B, H, Lk, d), (B, H, Lk, d), (B, H, L, d)))
    qm = km = None
    if masks:
        km = (torch.rand((B, Lk), generator=g) > 0.3).int().cuda()
        km[:, :3] = 0 if causal else 1  # causal: rows before the first real key
        qm = torch.ones((B, L), dtype=torch.int32, device="cuda")
        qm[1, -40:] = 0
    runs = [(kernel, dtype), (plain, dtype)]
    if dtype == torch.bfloat16:
        runs.append((plain, torch.float32))
    drop = dict(dropout_rate=rate, dropout_seed=77 if rate else None) if rate else {}
    outs = []
    for fn, dt in runs:
        qq, kk, vv = (x.to(dt).clone().requires_grad_(True) for x in (q, k, v))
        o = fn(qq, kk, vv, causal=causal, scale=d ** -0.5, q_mask=qm, kv_mask=km, **drop)
        outs.append([o, *torch.autograd.grad(o, (qq, kk, vv), do.to(dt))])
    torch.cuda.synchronize()
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 8, 24, 32, 40, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal,Lk,masks", [(True, 256, True), (True, 256, False),
                                             (False, 128, True)])
def test_block_attention_kernel_matches_reference(dtype, rate, causal, Lk, masks, d):
    """K5 forward and backward against the plain version: causal with q/kv
    masks (including rows before the first real key), without masks, and
    the rectangular non-causal form, dropout off and on with one seed, at
    the head widths the kernels are built for (32, 64, 96, 128) and ones
    the wrapper pads (8, 24, 40). fp32 with TF32 off at JAX's bars (2e-5
    forward, 5e-5 gradients); bf16 output within 2e-2 + 1e-2 |plain|,
    gradients as ``_grads_within``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    f0, b0 = tba.LAUNCHES, tba.BWD_LAUNCHES
    (o, *grads), (o_ref, *grads_ref), *exact = _k5_case(dtype, causal, Lk, rate, masks, d=d)
    assert o.shape[-1] == d and all(x.shape[-1] == d for x in grads)
    assert (tba.LAUNCHES, tba.BWD_LAUNCHES) == (f0 + 1, b0 + 1)
    ok, err = _within(o, o_ref, dtype, 2e-5)
    assert ok, err
    exact = exact[0][1:] if exact else ()
    _grads_within(grads, grads_ref, dtype, 5e-5, exact)
    if exact:  # the bar sees the last keys, which few queries reach
        late = grads[1].clone()
        late[:, :, -32:] = 0
        assert _bf16_grad_ratio(late, grads_ref[1], exact[1]) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_attention_head_stride_draws_the_whole_problems_masks(dtype):
    """K5 on a shard of rows and heads (rows 2-3 and heads 3-5 of a [4, 8]
    problem, uneven as a tensor-parallel head group can be) with the
    folded seed and the whole problem's head stride: forward and backward
    equal its plain version's at those arguments, and that plain version
    equals the whole problem's output on the shard (the same dropout
    masks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(4)
    B, H, L, rate, seed = 4, 8, 256, 0.1, 91
    q, k, v, do = (torch.randn((B, H, L, 64), generator=g).to("cuda", dtype) for _ in range(4))
    b0, h0, h1 = 2, 3, 6
    part = [x[b0:, h0:h1].contiguous() for x in (q, k, v, do)]
    fold = seed + b0 * H + h0
    outs = []
    for fn in (tba.block_mha, tba.block_mha_reference):
        qq, kk, vv = (x.clone().requires_grad_(True) for x in part[:3])
        o = fn(qq, kk, vv, causal=True, scale=0.125, dropout_rate=rate, dropout_seed=fold,
               dropout_head_stride=H)
        outs.append([o, *torch.autograd.grad(o, (qq, kk, vv), part[3])])
    qg = q.clone().requires_grad_(True)  # the shard's plain run took the same (grad) route
    whole = tba.block_mha_reference(qg, k, v, causal=True, scale=0.125, dropout_rate=rate,
                                    dropout_seed=seed)[b0:, h0:h1].detach()
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        ok, err = _within(got, want, dtype, 2e-5 if dtype == torch.float32 else 5e-5)
        assert ok, err
    assert torch.equal(outs[1][0], whole)


@pytest.mark.cuda
def test_sharded_lm_loss_on_one_rank_equals_fused_lm_loss():
    """``fused_lm_loss_sharded`` over a one-rank mesh (no world: no
    collective) gives ``fused_lm_loss``'s value and gradients bit for bit,
    through K6 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.core.mesh import Mesh, make_mesh

    g = torch.Generator().manual_seed(6)
    h = torch.randn((2, 128, 256), generator=g).cuda()
    w = torch.randn((1000, 256), generator=g).cuda() * 0.1
    lbl = torch.randint(0, 1000, (2, 128), generator=g).cuda()
    lbl[0, :40] = -100
    outs = []
    for fn in (lambda a, b: tce.fused_lm_loss(a, b, lbl),
               lambda a, b: tce.fused_lm_loss_sharded(a, b, lbl, make_mesh((1,), ("data",)))):
        hh, ww = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
        f0 = tce.LAUNCHES
        loss = fn(hh, ww)
        assert tce.LAUNCHES == f0 + 1
        outs.append([loss, *torch.autograd.grad(loss, (hh, ww))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="pure 'data' mesh"):
        tce.fused_lm_loss_sharded(h, w, lbl, Mesh({"data": 1, "model": 2}, 0, {}))


@pytest.mark.cuda
def test_block_attention_dq_takes_delta_from_pn_dpn():
    """bf16, nearly uniform rows over values with a large common part (a
    model at init): ds = pn (dpn - delta) cancels most of dpn, so delta
    must be JAX's rowsum(pn * dpn) in f32. rowsum(dO * O) with O rounded to
    bf16 puts O's rounding into every ds of a row: dQ 5.0% (relative rms)
    from the f64 math against JAX's arithmetic's 0.23% at these inputs.
    Bar: 1%."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator().manual_seed(11)
    B, H, L, D = 2, 2, 256, 64
    q = (0.02 * torch.randn(B, H, L, D, generator=g)).bfloat16()
    k = (0.02 * torch.randn(B, H, L, D, generator=g)).bfloat16()
    v = (1.0 + 0.05 * torch.randn(B, H, L, D, generator=g)).bfloat16()
    do = torch.randn(B, H, L, D, generator=g).bfloat16()
    xs = [x.to("cuda").requires_grad_(True) for x in (q, k, v)]
    o = tba.block_mha(*xs, causal=True, scale=0.125)
    dq = torch.autograd.grad(o, xs[0], do.to("cuda"))[0].double().cpu()
    qq, kk, vv, dd = (t.double() for t in (q, k, v, do))
    mask = torch.ones(L, L, dtype=torch.bool).tril()
    pn = torch.softmax(torch.where(mask, qq @ kk.transpose(-1, -2) * 0.125, -1e30), -1)
    dpn = dd @ vv.transpose(-1, -2)
    want = torch.where(mask, pn * (dpn - (pn * dpn).sum(-1, keepdim=True)), 0.0) @ kk * 0.125
    rel = ((dq - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item()
    assert rel <= 1e-2, rel


@pytest.mark.cuda
def test_block_attention_kernel_reads_strided_views():
    """q, k, v as head views of one fused [B, L, 3*D] projection give the
    same output and gradients as contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator().manual_seed(5)
    qkv = torch.randn((2, 128, 3 * 128), generator=g).to("cuda", torch.bfloat16)
    heads = [x.view(2, 128, 2, 64).transpose(1, 2) for x in qkv.split(128, dim=-1)]
    do = torch.randn((2, 2, 128, 64), generator=g).to("cuda", torch.bfloat16)
    res = []
    for xs in (heads, [x.contiguous() for x in heads]):
        xs = [x.detach().requires_grad_(True) for x in xs]
        o = tba.block_mha(*xs, causal=True, dropout_rate=0.1, dropout_seed=3)
        res.append([o, *torch.autograd.grad(o, xs, do)])
    torch.cuda.synchronize()
    for a, b in zip(*res):
        assert torch.equal(a, b)


def _k5_kernels(run) -> list:
    """The kernels of ``csrc/block_attention.cu`` that ``run`` launches,
    by their demangled names, from a torch.profiler trace of two calls (the
    profiler may miss the first kernels after it starts)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "ergm_block::" in e.name})


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 24, 32, 40, 64, 96, 128])
def test_block_attention_bf16_runs_the_hopper_kernels(d):
    """K5's bf16 forward and backward, at every head width of the block
    gate's classes (padded to 32, 64, 96 and 128), launch the wgmma + TMA
    kernels of ``blk::`` at the padded width, and no other bf16 kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn((2, 2, 256, d), generator=g).to("cuda", torch.bfloat16)
                   for _ in range(4))
    xs = [x.requires_grad_(True) for x in (q, k, v)]

    def run():
        o = tba.block_mha(*xs, causal=True, dropout_rate=0.1, dropout_seed=5)
        torch.autograd.grad(o, xs, do)

    names = _k5_kernels(run)
    w = tba.head_width(d)
    want = [f"blk::{k}<ergm_block::blk::Shape<{w}," for k in
            ("bwd_dkdv_kernel", "bwd_dq_kernel", "fwd_kernel")]
    kernels = [n for n in names if "prep_kernel" not in n]
    assert len(kernels) == 3 and all(x in n for x, n in zip(want, kernels)), names


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_block_attention_bf16_repeats_bitwise(d, rate):
    """K5's bf16 forward and backward give the same bits twice (no
    atomics), dropout off and on, causal with masks and rectangular."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for causal, Lk in ((True, 256), (False, 384)):
        first, second = (_k5_case(torch.bfloat16, causal, Lk, rate, True, d=d)[0]
                         for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 96, 128])
def test_block_attention_items_past_the_sm_count(d):
    """The kernels that run one CTA an SM walk their items (a 128-row tile
    of one head): 17 batch rows x 2 heads x 4 tiles = 136 items, more than
    an H100's 132 SMs and not a multiple of them, so some CTAs take a second
    item. bf16, causal, dropout, with masks: output and gradients against
    the plain version, and a second run bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(d + 3)
    B, H, L = 17, 2, 512
    q, k, v, do = (torch.randn((B, H, L, d), generator=g) for _ in range(4))
    km = (torch.rand((B, L), generator=g) > 0.2).int()
    km[:, :5] = 0
    km = km.cuda()
    runs = []
    for fn, dt in ((tba.block_mha, torch.bfloat16), (tba.block_mha, torch.bfloat16),
                   (tba.block_mha_reference, torch.bfloat16),
                   (tba.block_mha_reference, torch.float32)):
        xs = [x.to("cuda", dt).requires_grad_(True) for x in (q, k, v)]
        o = fn(*xs, causal=True, scale=d ** -0.5, q_mask=km, kv_mask=km, dropout_rate=0.1,
               dropout_seed=13)
        runs.append([o, *torch.autograd.grad(o, xs, do.to("cuda", dt))])
    torch.cuda.synchronize()
    (o, *grads), again, (o_ref, *grads_ref), (_, *exact) = runs
    assert all(torch.equal(a, b) for a, b in zip([o, *grads], again))
    ok, err = _within(o, o_ref, torch.bfloat16, None)
    assert ok, err
    _grads_within(grads, grads_ref, torch.bfloat16, None, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_block_attention_long_queries_over_short_keys(d, rate):
    """Non-causal Lq = 1,024 over Lk = 128 (one key tile for every query
    tile, eight query tiles for every key tile), with masks, bf16 against
    the plain version: output within 2e-2 + 1e-2 |plain|, gradients as
    ``_grads_within``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    (o, *grads), (o_ref, *grads_ref), (_, *exact) = _k5_case(
        torch.bfloat16, False, 128, rate, True, d=d, L=1024)
    ok, err = _within(o, o_ref, torch.bfloat16, None)
    assert ok, err
    _grads_within(grads, grads_ref, torch.bfloat16, None, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_block_attention_batch_row_without_keys(dtype, causal):
    """A batch row whose keys are all masked: JAX spreads each of its real
    query rows uniformly over all Lk keys (output the mean of V), and its
    padded rows give 0; the other row is untouched. Forward and backward
    against the plain version at each head width class, dropout on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    for d in (32, 64, 96, 128):
        g = torch.Generator().manual_seed(d)
        B, H, L = 2, 2, 256
        q, k, v, do = (torch.randn((B, H, L, d), generator=g).to("cuda", dtype)
                       for _ in range(4))
        km = torch.ones((B, L), dtype=torch.int32, device="cuda")
        km[1] = 0
        qm = torch.ones((B, L), dtype=torch.int32, device="cuda")
        qm[1, -30:] = 0
        runs = [(tba.block_mha, dtype), (tba.block_mha_reference, dtype)]
        if dtype == torch.bfloat16:
            runs.append((tba.block_mha_reference, torch.float32))
        outs = []
        for fn, dt in runs:
            xs = [x.to(dt).detach().requires_grad_(True) for x in (q, k, v)]
            o = fn(*xs, causal=causal, scale=d ** -0.5, q_mask=qm, kv_mask=km,
                   dropout_rate=0.1, dropout_seed=9)
            outs.append([o, *torch.autograd.grad(o, xs, do.to(dt))])
        torch.cuda.synchronize()
        (o, *grads), (o_ref, *grads_ref), *exact = outs
        ok, err = _within(o, o_ref, dtype, 2e-5)
        assert ok, (d, err)
        assert bool((o[1].transpose(0, 1)[qm[1] == 0] == 0).all())
        _grads_within(grads, grads_ref, dtype, 5e-5, exact[0][1:] if exact else ())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96, 128])
def test_block_attention_head_stride_at_every_width(d):
    """bf16 K5 on a shard of rows and heads with the whole problem's head
    stride (8 heads, the shard's 3) and the folded seed, at the widths
    whose tiles differ from 64's (the 64-byte swizzle at 32 and 96, 64-row
    dQ and dK/dV tiles at 96 and 128), against its plain version at those
    arguments: output within 2e-2 + 1e-2 |plain|, gradients as
    ``_grads_within``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(d + 1)
    B, H, L, seed = 4, 8, 256, 91
    q, k, v, do = (torch.randn((B, H, L, d), generator=g) for _ in range(4))
    part = [x[2:, 3:6].contiguous() for x in (q, k, v, do)]
    outs = []
    for fn, dt in ((tba.block_mha, torch.bfloat16), (tba.block_mha_reference, torch.bfloat16),
                   (tba.block_mha_reference, torch.float32)):
        xs = [x.to("cuda", dt).requires_grad_(True) for x in part[:3]]
        o = fn(*xs, causal=True, scale=d ** -0.5, dropout_rate=0.1, dropout_seed=seed + 2 * H + 3,
               dropout_head_stride=H)
        outs.append([o, *torch.autograd.grad(o, xs, part[3].to("cuda", dt))])
    torch.cuda.synchronize()
    (o, *grads), (o_ref, *grads_ref), (_, *exact) = outs
    ok, err = _within(o, o_ref, torch.bfloat16, None)
    assert ok, err
    _grads_within(grads, grads_ref, torch.bfloat16, None, exact)


_FIRST_WORK = {
    "block_mha": "x = [torch.randn((1, 2, 256, 64), device='cuda').bfloat16().requires_grad_() "
                 "for _ in range(3)]\n"
                 "from ergm_tpu_torch.ops.block_attention import block_mha\n"
                 "y = block_mha(*x, causal=True)",
    "flash_mha": "x = [torch.randn((1, 2, 2048, 64), device='cuda').bfloat16().requires_grad_() "
                 "for _ in range(3)]\n"
                 "from ergm_tpu_torch.ops.flash_attention import flash_mha\n"
                 "y = flash_mha(*x, causal=True)",
    "fused_softmax_xent": "x = [torch.randn((256, 128), device='cuda').bfloat16().requires_grad_(), "
                          "torch.randn((1000, 128), device='cuda').bfloat16().requires_grad_()]\n"
                          "from ergm_tpu_torch.ops.fused_ce import fused_softmax_xent\n"
                          "y = fused_softmax_xent(*x, torch.randint(0, 1000, (256,), device='cuda'))",
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(_FIRST_WORK))
def test_backward_as_the_autograd_threads_first_cuda_work(kernel):
    """A bf16 backward whose kernels encode TMA tensor maps (K5, K7, K6)
    as the first CUDA work of PyTorch's autograd thread, in a fresh process
    with nothing else in the graph: the driver's encoder needs a context
    current on that thread, which the kernels bind themselves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import os
    import subprocess
    import sys

    code = ("import torch\n" + _FIRST_WORK[kernel] + "\n"
            "g = torch.autograd.grad(y, x, torch.ones_like(y))\n"
            "torch.cuda.synchronize()\n"
            "assert all(bool(torch.isfinite(t.float()).all()) for t in g)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]


def _k5_gate_case(dtype, L, Lk, causal, rate, model_masks=False):
    """K5 on JAX's block gate's shapes and K7 (``flash_mha``, held to
    ``flash_attention.kernel_reference``) on its flash gate's: q a head
    view of a fused [B, L, 3D]
    projection, k and v of a fused [B, Lk, 2D] one (read in place), a
    left-pad key mask (batch row 1 starts at key 37, so its causal rows
    before it see no real key and spread over all keys) and a ragged tail
    of padded query rows in batch row 0; with ``model_masks`` the query
    mask is the key mask, as the model passes them (the rows before key 37
    are padded, not dead). Returns the (kernel, plain, plain in f32 for
    bf16) runs, each [o, dQ, dK, dV], the module that ran
    (block_attention or flash_attention) and q_mask."""
    g = torch.Generator().manual_seed(L + 3 * Lk + int(causal))
    B, H = 2, 2
    qkv = torch.randn((B, L, 3 * H * 64), generator=g)
    kv = torch.randn((B, Lk, 2 * H * 64), generator=g)
    heads = [x.view(B, -1, H, 64).transpose(1, 2)
             for x in (qkv[..., :H * 64], *kv.split(H * 64, dim=-1))]
    do = torch.randn((B, H, L, 64), generator=g)
    km = torch.ones((B, Lk), dtype=torch.int32)
    km[1, :37] = 0
    qm = torch.ones((B, L), dtype=torch.int32)
    qm[0, L - 20:] = 0
    if model_masks:
        qm = km[:, :L].clone()
    km, qm = km.cuda(), qm.cuda()
    mod = tba if tba.supported(heads[0], heads[1], heads[2], causal=causal) else tfa
    if mod is tba:
        kernel, plain = tba.block_mha, tba.block_mha_reference
        drop = dict(dropout_rate=rate, dropout_seed=11 if rate else None)
    else:
        kernel, plain, drop = tfa.flash_mha, tfa.kernel_reference, {}
    runs = [(kernel, dtype), (plain, dtype)]
    if dtype == torch.bfloat16:
        runs.append((plain, torch.float32))
    outs = []
    for fn, dt in runs:
        xs = [x.to("cuda", dt).detach().requires_grad_(True) for x in heads]
        o = fn(*xs, causal=causal, scale=0.125, q_mask=qm, kv_mask=km, **drop)
        outs.append([o, *torch.autograd.grad(o, xs, do.to("cuda", dt))])
    torch.cuda.synchronize()
    return outs, mod, qm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,Lk,causal,rate", [
    (128, 128, True, 0.1), (128, 128, False, 0.0), (512, 512, True, 0.0), (512, 512, True, 0.1),
    (512, 512, False, 0.1), (1024, 1024, True, 0.1), (1024, 1024, False, 0.0),
    (2048, 2048, True, 0.0), (2048, 2048, False, 0.0), (128, 384, True, 0.0),
    (128, 384, False, 0.0), (128, 384, False, 0.1)])
def test_block_attention_kernel_across_gates(dtype, L, Lk, causal, rate):
    """K5 inside JAX's block gate (L <= 1024, dropout 0 and 0.1) and K7
    inside its flash gate (L = 2048; causal Lq = 128 over Lk = 384 at
    offset 0, where query i sees keys <= i; no dropout there), against the
    plain version, with strided views, a left-pad key mask and padded
    query rows. fp32 with TF32 off at JAX's bars (2e-5 forward, 5e-5
    gradients); bf16 output within 2e-2 + 1e-2 |plain|, gradients as
    ``_grads_within``; where Lq == Lk, dK without its last 64 keys must
    fail that bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    f0 = {m: (m.LAUNCHES, m.BWD_LAUNCHES) for m in (tba, tfa)}
    ((o, *grads), (o_ref, *grads_ref), *exact), mod, qm = _k5_gate_case(dtype, L, Lk, causal,
                                                                          rate)
    for m in (tba, tfa):
        n = int(m is mod)
        assert (m.LAUNCHES, m.BWD_LAUNCHES) == (f0[m][0] + n, f0[m][1] + n)
    assert (mod is tfa) == (L > 1024 or (causal and L != Lk))
    ok, err = _within(o, o_ref, dtype, 2e-5)
    assert ok, err
    assert bool((o.transpose(1, 2)[qm == 0] == 0).all())  # padded rows are zeros
    exact = exact[0][1:] if exact else ()
    _grads_within(grads, grads_ref, dtype, 5e-5, exact)
    if exact and L == Lk:
        late = grads[1].clone()
        late[:, :, -64:] = 0
        assert _bf16_grad_ratio(late, grads_ref[1], exact[1]) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("L", [512, 2048])
def test_block_attention_kernel_model_masks(L):
    """The model's masks (query mask = key mask, left-padded): padded rows
    before the first real key output zeros and pass zero gradients without
    walking every key. bf16, causal, no dropout, in both gates (K5 at 512,
    K7 at 2,048)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ((o, *grads), (o_ref, *grads_ref), (_, *exact)), _, qm = _k5_gate_case(
        torch.bfloat16, L, L, True, 0.0, model_masks=True)
    ok, err = _within(o, o_ref, torch.bfloat16, None)
    assert ok, err
    assert bool((o.transpose(1, 2)[qm == 0] == 0).all())
    assert bool((grads[0].transpose(1, 2)[qm == 0] == 0).all())
    _grads_within(grads, grads_ref, torch.bfloat16, None, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("impl", ["flash", "auto", "pallas"])
def test_flash_gate_routes_to_the_kernel(impl, d):
    """At L = 2048 (JAX's flash gate) ``multihead_attention`` launches K7
    (``flash_mha``: the one-pass kernels, 100 padded to 128) on the card
    without dropout and never K5, within the bf16 bar of
    ``flash_mha_reference``; with dropout active it takes the plain math,
    as JAX does."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.ops.attention import multihead_attention
    x = torch.randn((1, 2, 2048, d), device="cuda", dtype=torch.bfloat16)
    f0, k5 = tfa.LAUNCHES, tba.LAUNCHES
    got = multihead_attention(x, x, x, causal=True, impl=impl)
    assert (tfa.LAUNCHES, tba.LAUNCHES) == (f0 + 1, k5)
    want = tfa.flash_mha_reference(x, x, x, causal=True)
    ok, err = _within(got, want, torch.bfloat16, None)
    assert ok, err
    multihead_attention(x, x, x, causal=True, impl=impl, dropout_rate=0.1,
                        deterministic=False, seed=3)
    assert (tfa.LAUNCHES, tba.LAUNCHES) == (f0 + 1, k5)


@pytest.mark.cuda
def test_long_prompt_prefill_launches_k5():
    """The cached prefill of a 384-token prompt at B = 64 (a 2-layer gpt2
    at full width, fp32, left pads) takes K5 once per layer under "auto",
    as JAX routes it, and its last-position logits match the plain math's
    ("xla") within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, L = 64, 384
    cfg = ModelConfig.from_model_type("gpt2", n_layer=2, vocab_size=1024, n_positions=512,
                                      dtype="float32")
    params = tg.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(7)
    ids = torch.as_tensor(rng.integers(0, 1024, (B, L)), device="cuda")
    mask = (torch.arange(L)[None] >= torch.as_tensor(rng.integers(0, 200, (B, 1)))).float()
    mask = mask.cuda()
    logits = {}
    for impl in ("auto", "xla"):
        c = cfg.replace(attention_impl=impl)
        before = tba.LAUNCHES
        with torch.inference_mode():
            out = tg.forward(params, c, ids, attention_mask=mask,
                             cache=tg.init_kv_cache(c, B, L), prefix_prefill=True,
                             compute_logits="last")
        torch.cuda.synchronize()
        assert tba.LAUNCHES - before == (cfg.n_layer if impl == "auto" else 0)
        logits[impl] = out.logits.float()
    err = (logits["auto"] - logits["xla"]).abs().max().item()
    assert err <= 1e-3, err


@pytest.mark.cuda
def test_block_attention_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x16 = torch.zeros((2, 2, 128, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        tba.block_mha(x16, x16, x16, causal=True)
    for d in (136, 200):  # past 128, not a multiple of 128: outside both of JAX's gates
        x = torch.zeros((2, 2, 128, d), device="cuda")
        with pytest.raises(ValueError, match="multiple of 8 up to 128"):
            tba.block_mha(x, x, x, causal=True)
    for d in (20, 256):  # JAX's flash widths, outside its block gate: K7's
        x = torch.zeros((2, 2, 128, d), device="cuda")
        with pytest.raises(ValueError, match="multiple of 8 up to 128"):
            tba.block_mha(x, x, x, causal=True)
    short = torch.zeros((2, 2, 96, 64), device="cuda")
    with pytest.raises(ValueError):  # outside the gates: L=96
        tba.block_mha(short, short, short, causal=True)
    with pytest.raises(ValueError):
        tfa.flash_mha(short, short, short, causal=True)
    long = torch.zeros((1, 2, 2048, 64), device="cuda")
    with pytest.raises(ValueError, match="outside the kernel's gate"):  # K7's shape
        tba.block_mha(long, long, long, causal=True)
    with pytest.raises(TypeError):
        tfa.flash_mha(long.half(), long.half(), long.half(), causal=True)
    for d in (136, 200):
        x = torch.zeros((1, 2, 2048, d), device="cuda")
        with pytest.raises(ValueError, match="below 128 or a multiple of 128"):
            tfa.flash_mha(x, x, x, causal=True)
    with pytest.raises(ValueError, match="outside the kernel's gate"):  # causal Lq > Lk
        tfa.flash_mha(long, long[:, :, :128], long[:, :, :128], causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 128, 24, 256, 384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,L,Lk,masks", [(True, 256, 256, True), (True, 256, 256, False),
                                               (False, 256, 128, True), (True, 128, 384, True)])
def test_flash_kernel_at_jax_library_widths(dtype, causal, L, Lk, masks, d):
    """K7 (``flash_mha``) at the library kernel's head widths, without
    dropout: 64 and 128 (bf16: the one-pass kernels' own widths), 24 and
    100 (padded to 64 and 128 in bf16, to K5's 32 and 128 in fp32), 256 and
    384 (bf16: the one-pass kernels) held to ``flash_mha_reference``, JAX's
    library arithmetic, and 512 (bf16: the ``wide::`` kernels, column groups
    of 128) and fp32 (K5's f32 kernels) to ``block_mha_reference``
    (``flash_attention.kernel_reference``), forward and backward, with q/kv masks
    and rows before the first real key, without masks, the rectangular
    non-causal form, and causal Lq = 128 over Lk = 384 at offset 0 with a q
    mask other than the key mask (the dead rows walk every key, past the
    last query). fp32 with TF32 off at JAX's bars (2e-5 forward, 5e-5
    gradients); bf16 output within 2e-2 + 1e-2 |plain|, gradients as
    ``_grads_within``, a bar that dK without the last 32 keys a real row
    sees fails; the bf16 backward repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = tfa.kernel_reference
    f0, b0, k5 = tfa.LAUNCHES, tfa.BWD_LAUNCHES, tba.LAUNCHES
    (o, *grads), (o_ref, *grads_ref), *exact = _k5_case(dtype, causal, Lk, 0.0, masks, d=d, L=L,
                                                        plain=plain, kernel=tfa.flash_mha)
    assert o.shape[-1] == d and all(x.shape[-1] == d for x in grads)
    assert (tfa.LAUNCHES, tfa.BWD_LAUNCHES, tba.LAUNCHES) == (f0 + 1, b0 + 1, k5)
    ok, err = _within(o, o_ref, dtype, 2e-5)
    assert ok, err
    exact = exact[0][1:] if exact else ()
    _grads_within(grads, grads_ref, dtype, 5e-5, exact)
    if exact:
        hi = min(L, Lk) if causal else Lk  # the last keys a real row sees
        late = grads[1].clone()
        late[:, :, hi - 32:hi] = 0
        assert _bf16_grad_ratio(late, grads_ref[1], exact[1]) > 1.0
        (o2, *grads2), *_ = _k5_case(dtype, causal, Lk, 0.0, masks, d=d, L=L, plain=plain,
                                     kernel=tfa.flash_mha)
        assert torch.equal(o, o2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [20, 100, 136, 200, 256, 384])
def test_auto_never_raises_past_the_block_gate(d):
    """``auto`` takes K7 wherever JAX's flash gate reaches a kernel (the
    flash domain: any head width below 128, any multiple of 128) and the plain
    math elsewhere, with and without dropout, on a block-gate shape and a
    flash-gate one, and never raises; an explicit ``flash`` raises at a
    width above 128 that is not a multiple of 128 (JAX's library kernel
    raises there) and runs the kernel elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.ops.attention import multihead_attention
    g = torch.Generator().manual_seed(d)
    kernel = tfa.flash_head_ok(d)
    for L in (256, 2048):
        x = torch.randn((1, 2, L, d), generator=g).to("cuda", torch.bfloat16)
        f0, k5 = tfa.LAUNCHES, tba.LAUNCHES
        got = multihead_attention(x, x, x, causal=True, impl="auto")
        assert (tfa.LAUNCHES, tba.LAUNCHES) == (f0 + kernel, k5)
        want = (tfa.kernel_reference if kernel else tba.block_mha_reference)(
            x, x, x, causal=True, scale=d ** -0.5)
        ok, err = _within(got, want, torch.bfloat16, None)
        assert ok, err
        multihead_attention(x, x, x, causal=True, impl="auto", dropout_rate=0.1,
                            deterministic=False, seed=3)
        assert (tfa.LAUNCHES, tba.LAUNCHES) == (f0 + kernel, k5 + tba.head_ok(d) * (L <= 1024))
        if kernel:
            multihead_attention(x, x, x, causal=True, impl="flash")
        else:
            with pytest.raises(ValueError, match="below 128 or a multiple of 128"):
                multihead_attention(x, x, x, causal=True, impl="flash")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,N,V,D", [(torch.float32, 300, 1000, 256),
                                         (torch.bfloat16, 300, 5003, 768),
                                         (torch.bfloat16, 200, 1000, 256),
                                         (torch.float32, 300, 3001, 1280),
                                         (torch.bfloat16, 300, 5003, 1280),
                                         (torch.float32, 200, 2181, 1600),
                                         (torch.bfloat16, 333, 5003, 1600),
                                         (torch.bfloat16, 300, 5003, 32),
                                         (torch.float32, 300, 1000, 32),
                                         (torch.bfloat16, 300, 5003, 96),
                                         (torch.float32, 200, 2181, 96),
                                         (torch.bfloat16, 333, 5003, 100),
                                         (torch.float32, 300, 1000, 100),
                                         (torch.bfloat16, 300, 5003, 776),
                                         (torch.float32, 300, 1000, 776),
                                         (torch.bfloat16, 200, 2181, 8),
                                         (torch.bfloat16, 200, 2181, 2048),
                                         (torch.bfloat16, 200, 2181, 2112),
                                         (torch.float32, 200, 1000, 2112),
                                         (torch.bfloat16, 200, 2181, 2560),
                                         (torch.float32, 200, 1000, 2560),
                                         (torch.bfloat16, 130, 2181, 4096),
                                         (torch.float32, 100, 1000, 4096)])
def test_fused_xent_kernel_matches_reference(dtype, N, V, D):
    """K6 forward and backward against the plain version, with ignored
    labels, N not a multiple of the 128-row tile and V not a multiple of
    the 256-column tile or of the chunk (bf16: through autograd in one
    chunk, then with 2048-column chunks, so three of them, the last
    ragged), on logits of std 3 (a trained LM head's spread, where the
    softmax term is a large share of each gradient). fp32 with TF32 off:
    NLL 1e-5, gradients rtol 1e-4 / atol 1e-5 (JAX's bars); bf16: NLL 1e-4
    (the logits are exact bf16 products summed in f32 on both sides),
    gradients as ``_grads_within``, a bar that the gold term alone fails.
    bf16 also at D = 256, which the 192-column dh and dW tiles overhang;
    both types at gpt2-large's and gpt2-xl's widths, 1,280 and 1,600 (the
    f32 route's 256-column slices, the last one 0 or 64 wide, and 7 and 9
    overhanging dh and dW tiles); and at widths under one 64-deep stage or
    192-column tile (8, 32, 96: run at 64, 64, 128), not a multiple of 8
    (100: at 128), gpt2's width plus 8 (776: at 832), 2,048, and past it,
    where the f32 backward splits D into column groups of 2,048 (2,112;
    Cerebras-GPT-2.7B's 2,560; GPT-J's 4,096)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(6)
    h = torch.randn((N, D), generator=g).to("cuda", dtype)
    w = (3.0 / D ** 0.5 * torch.randn((V, D), generator=g)).to("cuda", dtype)
    lbl = torch.randint(0, V, (N,), generator=g).cuda()
    lbl[::7] = -100
    cot = torch.randn((N,), generator=g).cuda()
    counts = (tce.LAUNCHES, tce.BWD_LAUNCHES)
    res = []
    for fn, dt in ((tce.fused_softmax_xent, dtype), (tce.fused_softmax_xent_reference, dtype),
                   (tce.fused_softmax_xent_reference, torch.float32)):
        hh, ww = (x.to(dt).clone().requires_grad_(True) for x in (h, w))
        nll = fn(hh, ww, lbl)
        res.append([nll, *torch.autograd.grad((nll * cot).sum(), (hh, ww))])
    torch.cuda.synchronize()
    assert (tce.LAUNCHES, tce.BWD_LAUNCHES) == tuple(c + 1 for c in counts)
    (nll, dh, dw), (nll_ref, dh_ref, dw_ref), (_, dh_x, dw_x) = res
    assert dh.dtype == dtype and dw.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    assert bool(((nll - nll_ref).abs() <= tol + tol * nll_ref.abs()).all())
    if dtype == torch.float32:
        torch.testing.assert_close(dh, dh_ref, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(dw, dw_ref, rtol=1e-4, atol=1e-5)
    else:
        _grads_within([dh, dw], [dh_ref, dw_ref], dtype, None, [dh_x, dw_x])
        lbl32 = lbl.to(torch.int32)
        width = tce.padded_width(D)  # the launches take D a multiple of 64
        hp, wp = (F.pad(x, (0, width - D)) for x in (h, w))
        _, logz = tce.launch_fwd(hp, wp, lbl32)
        chunked = [x[:, :D] for x in tce.launch_bwd(hp, wp, lbl32, logz, cot, chunk=2048)]
        _grads_within(chunked, [dh_ref, dw_ref], dtype, None, [dh_x, dw_x])
        gw = torch.where(lbl >= 0, cot, 0.0)[:, None]
        gold_dh = -gw * w.float()[lbl.clamp_min(0)]
        gold_dw = torch.zeros((V, D), device="cuda").index_add_(0, lbl.clamp_min(0),
                                                                -gw * h.float())
        assert _bf16_grad_ratio(gold_dh, dh_ref, dh_x) > 1.0
        assert _bf16_grad_ratio(gold_dw, dw_ref, dw_x) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,D", [(256, 256), (1024, 256), (8192, 256), (1024, 1600),
                                     (1024, 100), (8192, 32), (1024, 776), (1024, 2560),
                                     (8192, 4096)])
def test_fused_xent_backward_is_deterministic(chunk, D):
    """The bf16 backward (no atomics; chunks in order on the stream) gives
    bitwise the same dh and dW on a second run, and gradients within
    ``_bf16_grad_ratio``'s bar whatever the chunk width: one chunk,
    several, and a last chunk of 133 columns; also at gpt2-xl's width and
    at 100, 32 and 776 (padded to 128, 64 and 832, as ``fused_softmax_xent``
    runs them), and at 2,560 and 4,096 (14 and 22 dh/dW tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator().manual_seed(7)
    N, V = 333, 2181
    width = tce.padded_width(D)
    h = F.pad(torch.randn((N, D), generator=g).to("cuda", torch.bfloat16), (0, width - D))
    w = F.pad((3.0 / D ** 0.5 * torch.randn((V, D), generator=g)).to("cuda", torch.bfloat16),
              (0, width - D))
    lbl = torch.randint(0, V, (N,), generator=g).cuda().to(torch.int32)
    lbl[::5] = -100
    cot = torch.randn((N,), generator=g).cuda()
    _, logz = tce.launch_fwd(h, w, lbl)
    first = tce.launch_bwd(h, w, lbl, logz, cot, chunk=chunk)
    second = tce.launch_bwd(h, w, lbl, logz, cot, chunk=chunk)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    hh, ww = (x.float().requires_grad_(True) for x in (h, w))
    nll = tce.fused_softmax_xent_reference(hh, ww, lbl)
    exact = torch.autograd.grad((nll * cot).sum(), (hh, ww))
    plain = [x.to(torch.bfloat16) for x in exact]  # one output rounding
    for got, p, x in zip(first, plain, exact):
        ratio = _bf16_grad_ratio(got, p, x)
        assert ratio <= 1.0, ratio


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_training_routes_raise_instead_of_plain_math(impl):
    """On the card the LM loss and self-attention take K6 and K5 wherever
    the kernels take the shape: at D=96 and 2,112 and head dim 48 (once
    refused, now inside their domain) under ``auto`` and the explicit route
    alike, each result within its plain version's bar. Past the domain
    (head dim 136, float16) ``auto`` gives the plain result with no launch,
    and an explicit ``block`` or ``flash`` raises rather than compute the
    plain math on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.ops.attention import multihead_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(5)
    for d in (96, 2112):
        cfg = ModelConfig(n_layer=1, n_embd=d, n_head=2, vocab_size=64, n_positions=16,
                          dtype="float32", lm_loss_impl=impl)
        params = tg.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
        hidden = torch.randn((2, 8, d), generator=g).cuda()
        labels = torch.randint(0, 64, (2, 8), generator=g).cuda()
        want = tg.chunked_lm_loss(hidden, params.wte.embedding, labels, chunk=cfg.loss_chunk)
        f0 = tce.LAUNCHES
        got = tg.lm_loss(hidden, params, cfg, labels)
        assert tce.LAUNCHES == f0 + 1
        assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
        with torch.no_grad():  # an eval step in bf16
            got = tg.lm_loss(hidden.bfloat16(), params, cfg, labels)
        assert tce.LAUNCHES == f0 + 2
        assert abs(float(got) - float(want)) <= 1e-2 * abs(float(want))
    x = torch.randn((2, 2, 128, 48), generator=g).cuda()
    f0 = tba.LAUNCHES
    got = multihead_attention(x, x, x, causal=True, impl=impl if impl == "auto" else "block")
    assert tba.LAUNCHES == f0 + 1
    ok, err = _within(got, tba.block_mha_reference(x, x, x, causal=True), torch.float32, 2e-5)
    assert ok, err
    wide = torch.randn((2, 2, 128, 136), generator=g).cuda()
    long = torch.randn((1, 1, 2048, 136), generator=g).cuda()
    half = x.half()
    if impl == "auto":
        for y in (wide, long, half):
            got = multihead_attention(y, y, y, causal=True, impl="auto")
            want = multihead_attention(y, y, y, causal=True, impl="xla")
            assert tba.LAUNCHES == f0 + 1 and torch.equal(got, want)
    else:
        for y, route, widths in ((wide, "block", "multiple of 8 up to 128"),
                                 (long, "flash", "below 128 or a multiple of 128"),
                                 (half, "block", "multiple of 8 up to 128")):
            with pytest.raises(ValueError, match=widths):
                multihead_attention(y, y, y, causal=True, impl=route)
        with pytest.raises(TypeError):
            tce.fused_softmax_xent(half[0, 0], half[0, 0], torch.zeros((128,), dtype=torch.int64,
                                                                       device="cuda"))


@pytest.mark.cuda
def test_fused_xent_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    lbl = torch.zeros((8,), dtype=torch.int64, device="cuda")
    for d in (2112, 4096):  # above 2048, refused before K6 took every width: taken
        f0 = tce.LAUNCHES
        nll = tce.fused_softmax_xent(torch.zeros((8, d), device="cuda"),
                                     torch.zeros((16, d), device="cuda"), lbl)
        torch.testing.assert_close(nll, torch.full((8,), math.log(16.0), device="cuda"))
        assert tce.LAUNCHES == f0 + 1
    with pytest.raises(TypeError):  # mixed dtypes
        tce.fused_softmax_xent(torch.zeros((8, 128), device="cuda"),
                               torch.zeros((16, 128), device="cuda", dtype=torch.bfloat16), lbl)
    with pytest.raises(TypeError):  # float16
        tce.fused_softmax_xent(torch.zeros((8, 96), device="cuda", dtype=torch.float16),
                               torch.zeros((16, 96), device="cuda", dtype=torch.float16), lbl)


def _spec_model(n_layer=3):
    """A small fp32 model on the card with a caption sublayer and head dim
    64 (K5's), random weights from seed 0; TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(n_layer=n_layer, n_embd=128, n_head=2, vocab_size=512, n_positions=256,
                      modality_dim=128, dtype="float32")
    return cfg, tg.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["draft", "ngram"])
def test_greedy_spec_equals_plain_greedy_on_card(mode):
    """A B=1 request with a 128-token prompt and a caption, fp32: the
    speculative tokens are plain greedy's, and the prefill takes K5 once
    per layer of the target (and of the 2-layer draft)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.infer.generate import generate
    from ergm_tpu_torch.infer.speculative import speculative_generate

    cfg, p = _spec_model()
    rng = np.random.default_rng(9)
    ids = torch.as_tensor(rng.integers(0, 500, (1, 128)), device="cuda")
    kw = dict(max_len=160, eos_id=511, sp2_id=510, greedy=True,
              caption_ids=torch.as_tensor(rng.integers(0, 500, (1, 16)), device="cuda"))
    ref = generate(p, cfg, ids, 128, **kw)
    before = tba.LAUNCHES
    got = speculative_generate(p, cfg, ids, 128, mode=mode, draft_layers=2, gamma=4,
                               ngram_n=2, **kw)
    torch.cuda.synchronize()
    assert tba.LAUNCHES - before == cfg.n_layer + (2 if mode == "draft" else 0)
    n = int(ref.lengths[0])
    assert int(got.lengths[0]) == n
    assert got.tokens[0, :n].tolist() == ref.tokens[0, :n].tolist()


@pytest.mark.cuda
def test_beam_reorder_carries_int8_scales_on_card():
    """The beam reorder moves the int8 codes and their scales of the
    generated slots on the card (index_select over strided views), and
    one beam over an int8 cache is greedy decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.infer import beam
    from ergm_tpu_torch.infer.generate import generate

    cfg, p = _spec_model(n_layer=2)
    cfg = cfg.replace(kv_cache_dtype="int8", cross_kv_dtype="int8")
    cache = tg.init_kv_cache(cfg, 6, 40, caption_len=8)
    g = torch.Generator(device="cuda").manual_seed(1)
    for f in ("k", "v", "k_scale", "v_scale"):
        x = getattr(cache, f)
        x.copy_(torch.randint(-100, 100, x.shape, generator=g, device="cuda").to(x.dtype))
    before = {f: getattr(cache, f).clone().cpu() for f in ("k", "v", "k_scale", "v_scale")}
    flat = torch.tensor([2, 2, 0, 4, 3, 3], device="cuda")
    beam._gather_beams(cache, flat, 10, 30)
    for f, old in before.items():
        want = old.clone()
        want[:, :, :, 10:30] = old[:, flat.cpu()][:, :, :, 10:30]
        assert torch.equal(getattr(cache, f).cpu(), want), f

    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 500, (2, 24)), device="cuda")
    kw = dict(max_len=40, eos_id=511, sp2_id=510)
    out = beam.beam_search(p, cfg, ids, 24, num_beams=1, **kw)
    ref = generate(p, cfg, ids, 24, greedy=True, **kw)
    assert torch.equal(out.tokens, ref.tokens) and torch.equal(out.lengths, ref.lengths)


@pytest.mark.cuda
def test_int4_pack_on_card():
    """int4 packing and unpacking on the card equal the CPU's (held to
    JAX's in tests/test_torch_cache.py) for all 225 pairs of codes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q = torch.arange(-7, 8, dtype=torch.int8)
    pairs = torch.stack(torch.meshgrid(q, q, indexing="ij"), -1).reshape(-1, 2)
    packed = tg._pack_int4(pairs)
    assert torch.equal(tg._pack_int4(pairs.cuda()).cpu(), packed)
    assert torch.equal(tg._unpack_int4(packed.cuda()).cpu(), pairs)


def _server_setup(kv="auto", **kw):
    from ergm_tpu_torch.infer.server import ContinuousServer

    cfg, p = _spec_model(n_layer=2)
    cfg = cfg.replace(kv_cache_dtype=kv)
    base = dict(slots=2, eos_id=511, sp2_id=510, max_prompt=32, prompt_bucket=16, sync_every=4)
    return cfg, p, ContinuousServer(p, cfg, **{**base, **kw})


def _card_greedy(p, cfg, prompt, n):
    from ergm_tpu_torch.infer.generate import generate

    ids = torch.tensor([prompt], device="cuda")
    out = generate(p, cfg, ids, len(prompt), max_len=len(prompt) + n, eos_id=511, sp2_id=510,
                   greedy=True, token_type_ids=torch.full_like(ids, 510))
    return out.tokens[0, len(prompt):int(out.lengths[0])].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["auto", "int8", "int4"])
def test_server_greedy_equals_generate_on_card(kv):
    """The server on the card (fp32, TF32 off; K1 in each 64-row admission
    prefill, int8 and int4 staged): 5 requests through 2 slots give
    ``generate``'s greedy tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.infer.server import Request

    cfg, p, srv = _server_setup(kv)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 500, (n,)).tolist() for n in (5, 11, 17, 8, 23)]
    before = tpa.LAUNCHES
    rids = [srv.submit(Request(prompt_ids=q, max_new_tokens=8, greedy=True)) for q in prompts]
    res = srv.run_until_drained()
    assert (tpa.LAUNCHES - before) % cfg.n_layer == 0 and tpa.LAUNCHES > before
    for rid, q in zip(rids, prompts):
        assert res[rid].tokens == _card_greedy(p, cfg, q, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_server_row_past_capacity_on_card(kv):
    """A finished row keeps stepping until its cursor passes the cache's
    40 slots: its writes drop without a device assert, and the rows
    around it keep ``generate``'s tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.infer.server import Request

    cfg, p, srv = _server_setup(kv, cache_len=40, cache_grow_step=0)
    rng = np.random.default_rng(13)
    short_run, long_run = rng.integers(0, 500, (30,)).tolist(), rng.integers(0, 500, (5,)).tolist()
    r_a = srv.submit(Request(prompt_ids=short_run, max_new_tokens=2, greedy=True))
    r_b = srv.submit(Request(prompt_ids=long_run, max_new_tokens=30, greedy=True))
    res = srv.run_until_drained()
    torch.cuda.synchronize()
    assert int(srv.caches[0].index.max()) > srv.Tphys[0] == 40
    assert res[r_a].tokens == _card_greedy(p, cfg, short_run, 2)
    assert res[r_b].tokens == _card_greedy(p, cfg, long_run, 30)


@pytest.mark.cuda
def test_server_block_dispatch_has_no_host_sync():
    """Every block dispatch (tiered pools: a compute-dtype pool and an int8
    staged one; greedy, sampled and logprob rows) runs under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on a host
    read of a device value."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.infer.server import Request

    cfg, p, srv = _server_setup(slots=4, long_slots=2, long_threshold=24, cache_grow_step=16)
    dispatch, calls = srv._dispatch_block, []

    def guarded():
        torch.cuda.set_sync_debug_mode("error")
        try:
            calls.append(1)
            return dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    srv._dispatch_block = guarded
    rng = np.random.default_rng(14)
    reqs = [Request(prompt_ids=rng.integers(0, 500, (n,)).tolist(), max_new_tokens=6,
                    greedy=g, logprobs=lp, seed=i)
            for i, (n, g, lp) in enumerate([(6, True, False), (30, False, True),
                                            (11, False, False), (27, True, True)])]
    rids = [srv.submit(r) for r in reqs]
    res = srv.run_until_drained()
    assert len(calls) > 1 and set(res) == set(rids)
    assert [c.kv_cache_dtype for c in srv.gcfgs] == ["auto", "int8"]
    assert all(len(res[r].logprobs) == len(res[r].tokens) for r in rids[1::2])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_extension_rows_past_capacity_on_card(kv):
    """A 6-token step under per-row cursors (the extension's and the verify
    window's form) whose rows cross the cache's end (at T-3, at T-1, past
    T): no device assert, and the cache and logits equal the same step's
    on the CPU (fp32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import copy

    cfg, p = _spec_model(n_layer=2)
    cfg = cfg.replace(kv_cache_dtype=kv, use_cross_attention=False)
    p_cpu = copy.deepcopy(p).to("cpu")
    B, T, L = 4, 40, 6
    cursors = torch.tensor([5, T - 3, T - 1, T + 4], dtype=torch.int32)
    rng = np.random.default_rng(15)
    ids = torch.as_tensor(rng.integers(0, 500, (B, L)))
    pos = torch.clamp_max(cursors.long()[:, None] + torch.arange(L)[None, :], cfg.n_positions - 1)
    init = {}  # the same contents on both
    for f, x in vars(tg.init_kv_cache(cfg, B, T, device="cpu")).items():
        if f in ("k", "v"):
            init[f] = (torch.as_tensor(rng.integers(-100, 100, x.shape), dtype=torch.int8)
                       if x.dtype == torch.int8 else torch.as_tensor(rng.standard_normal(x.shape),
                                                                     dtype=x.dtype))
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p)):
        cache = tg.init_kv_cache(cfg, B, T, device=dev, per_row_index=True)
        for f, x in init.items():
            getattr(cache, f).copy_(x)
        if cache.k_scale is not None:
            cache.k_scale.fill_(0.02)
            cache.v_scale.fill_(0.03)
        cache.index = cursors.to(dev)
        with torch.inference_mode():
            o = tg.forward(params, cfg, ids.to(dev), position_ids=pos.to(dev), cache=cache,
                           token_type_ids=torch.full_like(ids, 510).to(dev))
        torch.cuda.synchronize()
        fields = ("k", "v", "k_scale", "v_scale")
        out[dev] = (o.logits.cpu(), {f: getattr(cache, f).cpu() for f in fields
                                     if getattr(cache, f) is not None}, o.cache.index.cpu())
    (lc, cc, ic), (lg, cg, ig) = out["cpu"], out["cuda"]
    assert torch.equal(ig, cursors + L)
    assert (lg - lc).abs().max() <= 1e-3
    for f in cc:
        if cc[f].dtype == torch.int8:
            assert (cg[f].int() - cc[f].int()).abs().max() <= 1, f  # a rounding edge at most
        else:
            assert torch.allclose(cg[f].float(), cc[f].float(), atol=1e-4), f


def _sync_guarded(srv, *names):
    """Wraps the server's methods ``names`` to run under
    ``torch.cuda.set_sync_debug_mode("error")``; returns the call counts."""
    calls = {n: 0 for n in names}
    for name in names:
        real = getattr(srv, name)

        def guarded(*args, _real=real, _name=name, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                calls[_name] += 1
                return _real(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        setattr(srv, name, guarded)
    return calls


@pytest.mark.cuda
def test_spec_and_extension_dispatch_have_no_host_sync():
    """Speculative blocks and the extension program (session deltas and
    prompt chunks) run under ``torch.cuda.set_sync_debug_mode("error")``, which raises on a host
    read of a device value; their greedy tokens equal ``generate``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.infer.server import Request

    cfg, p, srv = _server_setup(max_prompt=64, spec_gamma=3, spec_ngram=2, prefill_chunk=16)
    calls = _sync_guarded(srv, "_dispatch_block", "_extend")
    rng = np.random.default_rng(16)
    unit = rng.integers(0, 500, (5,)).tolist()
    p1, long_p = unit * 3, rng.integers(0, 500, (50,)).tolist()
    r1 = srv.submit(Request(prompt_ids=p1, max_new_tokens=8, greedy=True, session_id="s"))
    r2 = srv.submit(Request(prompt_ids=long_p, max_new_tokens=8, greedy=True))
    res = srv.run_until_drained()
    p2 = p1 + res[r1].tokens + unit
    r3 = srv.submit(Request(prompt_ids=p2, max_new_tokens=8, greedy=True, session_id="s"))
    res = srv.run_until_drained()
    assert calls["_dispatch_block"] > 1 and calls["_extend"] >= 3
    assert srv.spec_macro > 0 and srv.spec_accepted > 0
    for rid, q in ((r2, long_p), (r3, p2)):
        assert res[rid].tokens == _card_greedy(p, cfg, q, 8)


@pytest.mark.cuda
def test_session_tokens_equal_full_prefill_on_card():
    """fp32 on the card: a three-turn session (the deltas through the
    extension, the second through two chunks) gives a fresh full-prompt
    ``generate``'s tokens at every turn."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.infer.server import Request

    cfg, p, srv = _server_setup(max_prompt=32, prefill_chunk=16)
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, 500, (12,)).tolist()
    for turn, new in enumerate((0, 30, 7)):
        prompt = prompt + rng.integers(0, 500, (new,)).tolist()
        rid = srv.submit(Request(prompt_ids=prompt, max_new_tokens=8, greedy=True,
                                 session_id="s"))
        got = srv.run_until_drained()[rid].tokens
        assert got == _card_greedy(p, cfg, prompt, 8), turn
        prompt = prompt + got
    assert srv.ext_programs == 3


# -- the feature-extraction path: K5 non-causal at B=1, the audio encoder,
# -- text features


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [128, 256, 1024, 1152])
def test_block_attention_noncausal_unmasked_b1(dtype, L):
    """The audio encoder's attention: K5 with ``causal=False``, no masks,
    at B=1, through ``multihead_attention``'s ``auto`` route (the block
    gate up to 1,024 frames, K7 through the flash gate at 1,152), against
    the plain version: fp32 with TF32 off within 2e-5, bf16 within 2e-2 +
    1e-2 |plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.ops.attention import multihead_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(L)
    # head views of one [1, L, 3 * 768] projection, as the encoder hands them over
    qkv = torch.randn((1, L, 3 * 768), generator=g, device="cuda").to(dtype)
    q, k, v = (x.view(1, L, 12, 64).transpose(1, 2) for x in qkv.split(768, dim=-1))
    block = tba.supported(q, k, v, causal=False)
    assert block == (L <= 1024)
    f0 = (tba.LAUNCHES, tfa.LAUNCHES)
    out = multihead_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert (tba.LAUNCHES, tfa.LAUNCHES) == (f0[0] + block, f0[1] + (not block))
    ref = (tba.block_mha_reference if block else tfa.kernel_reference)(q, k, v, causal=False,
                                                                         scale=0.125)
    ok, err = _within(out, ref, dtype, 2e-5)
    assert ok, err


def _tiny_audio():
    from ergm_tpu_torch.tools.audio import AudioEncoderConfig, init_audio_params

    cfg = AudioEncoderConfig(conv_dim=(64, 64), conv_stride=(5, 2), conv_kernel=(10, 3),
                             hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    return cfg, init_audio_params(torch.Generator().manual_seed(0), cfg, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1290, 1490])
def test_audio_encoder_card_matches_cpu_with_tf32_default(n):
    """The fp32 audio encoder (Dh 64) on the card against the CPU, entered
    with cuDNN's TF32 at its default (on): the encoder turns it off for its
    convolutions itself, so the features hold 1e-4. 1,290 samples give 128
    frames (K5, 2 launches), 1,490 give 148 (the plain math)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import copy

    from ergm_tpu_torch.tools.audio import audio_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    cfg, cpu = _tiny_audio()
    card = copy.deepcopy(cpu).to("cuda")
    wav = torch.from_numpy(np.random.default_rng(n).standard_normal((1, n)).astype(np.float32))
    frames = cfg.frames_for_samples(n)
    f0 = tba.LAUNCHES
    with torch.inference_mode():
        got = audio_encoder(card, cfg, wav.cuda()).cpu()
        want = audio_encoder(cpu, cfg, wav)
    assert torch.backends.cudnn.allow_tf32 is True
    assert tba.LAUNCHES - f0 == (cfg.num_layers if frames % 128 == 0 else 0)
    assert got.shape == (1, frames, 128)
    err = (got - want).abs().max().item()
    assert err <= 1e-4, err


@pytest.mark.cuda
def test_text_features_launch_k5_per_bucket():
    """``extract_text_features`` on the card: batches bucketed to 64, 128,
    192 and 256 tokens; K5 launches n_layer times for the 128 and 256
    buckets only, and the fp32 features equal the CPU's within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import copy

    from ergm_tpu_torch.tools.text_features import extract_text_features

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(n_layer=2, n_embd=128, n_head=2, vocab_size=300, n_positions=256,
                      dtype="float32", use_cross_attention=False)
    cpu = tg.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(0)
    launches = []
    for longest in (50, 100, 150, 250):  # buckets 64, 128, 192, 256
        utts = [rng.integers(0, 300, int(n)).tolist()
                for n in [longest] + rng.integers(1, longest, 4).tolist()]
        f0 = tba.LAUNCHES
        got = extract_text_features(card, cfg, utts, batch_size=8)
        launches.append(tba.LAUNCHES - f0)
        want = extract_text_features(cpu, cfg, utts, batch_size=8)
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        assert err <= 1e-4, (longest, err)
    assert launches == [0, cfg.n_layer, 0, cfg.n_layer]


@pytest.mark.cuda
def test_cli_gpu_index_runs_trainer_and_server_on_the_card(tmp_path, monkeypatch):
    """``--gpu=0``: the Trainer's parameters and the server's KV cache lie
    on cuda:0; ``--num_workers=2`` hands the trainer pinned batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import json

    from ergm_tpu_torch.cli import main as cli
    from ergm_tpu_torch.cli.load_data import main as load_data
    from ergm_tpu_torch.core import config as config_mod
    from ergm_tpu_torch.infer import server as server_mod
    from ergm_tpu_torch.train import steps as steps_mod
    from ergm_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setitem(config_mod.GPT2_SIZES, "tiny", dict(n_layer=2, n_head=2, n_embd=128))
    data = tmp_path / "data"
    load_data(["--source=synthetic", f"--data_dir={data}", "--model_type=tiny",
               "--num_dialogues=4", "--turns=3"])
    seen = {"pinned": []}
    real_train, real_init = trainer_mod.Trainer.train, server_mod.ContinuousServer.__init__
    real_to_device = steps_mod.batch_to_device

    def train(self):
        seen["trainer"] = next(self.state.params.parameters()).device
        return real_train(self)

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        seen["cache"] = self.caches[0].k.device

    def to_device(batch, *args, **kwargs):
        seen["pinned"].append(torch.as_tensor(batch.input_ids).is_pinned())
        return real_to_device(batch, *args, **kwargs)

    monkeypatch.setattr(trainer_mod.Trainer, "train", train)
    monkeypatch.setattr(server_mod.ContinuousServer, "__init__", init)
    monkeypatch.setattr(trainer_mod, "batch_to_device", to_device)
    common = [f"--data_dir={data}", "--model_type=tiny", "--batch_size=4", "--max_len=128",
              "--gpu=0", f"--ckpt_dir={tmp_path / 'ck'}", f"--output_dir={tmp_path / 'out'}"]
    cli.main(["--mode=train", "--num_epochs=1", "--num_workers=2", *common])
    assert seen["trainer"] == torch.device("cuda:0")
    assert seen["pinned"] and all(seen["pinned"])
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(json.dumps({"prompt": [5, 6, 7, i], "max_new_tokens": 4,
                                        "greedy": True}) + "\n" for i in range(3)))
    cli.main(["--mode=serve", "--ckpt_name=best", f"--requests_file={reqs}", *common])
    assert seen["cache"] == torch.device("cuda:0")
    assert len(reqs.with_name("reqs.jsonl.responses.jsonl").read_text().splitlines()) == 3


@pytest.mark.cuda
def test_dots_remat_loss_equals_mlp_on_card():
    """bf16 on the card, dropout 0.1 through K5: the losses under remat
    "dots" and "mlp" are equal bit for bit (the forward is the same and the
    masks are seeded), the gradients within the bf16 bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ergm_tpu_torch.train import steps as steps_mod

    base = ModelConfig(n_layer=2, n_embd=128, n_head=2, vocab_size=300, n_positions=256,
                       dtype="bfloat16", remat=True, attn_pdrop=0.1, resid_pdrop=0.1,
                       embd_pdrop=0.1)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 300, (4, 256))
    batch = {"input_ids": ids, "token_type_ids": rng.integers(0, 300, (4, 256)),
             "labels": ids, "emotion_labels": rng.integers(0, 7, (4,)),
             "valid": np.ones((4,), bool)}
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    out = {}
    for policy in ("mlp", "dots"):
        cfg = base.replace(remat_policy=policy)
        params = tg.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
        f0, b0 = tba.LAUNCHES, tba.BWD_LAUNCHES
        loss, _ = steps_mod._losses_and_metrics(params, cfg, batch, deterministic=False, seed=5)
        loss.backward()
        torch.cuda.synchronize()
        # "dots" recomputes each block, K5's forward included
        assert (tba.LAUNCHES - f0, tba.BWD_LAUNCHES - b0) == (
            cfg.n_layer * (2 if policy == "dots" else 1), cfg.n_layer)
        out[policy] = (loss.item(), [p.grad.float() for p in params.parameters()
                                     if p.grad is not None])
    assert out["dots"][0] == out["mlp"][0]
    for a, b in zip(out["dots"][1], out["mlp"][1]):
        assert _within(a, b, torch.bfloat16, None)[0]


# -- inference over a mesh: K1-K4 on a model rank's heads, K3's and K4's
# tensor-parallel (partial) forms ---------------------------------------------


def _rank_parts(blk, cfg, parts: int):
    """Each model rank's part of ``blk`` (``core.mesh.split_model``) and its
    head range."""
    from ergm_tpu_torch.core import mesh as tmesh

    out = []
    for r in range(parts):
        mesh = tmesh.make_mesh((1, parts), ("data", "model"), world_size=parts, rank=r)
        part = tg.Block(cfg)
        with torch.no_grad():
            for name, p in blk.named_parameters():
                mod, leaf = name.rsplit(".", 1)
                setattr(part.get_submodule(mod), leaf, torch.nn.Parameter(
                    tmesh.split_model(f"blocks.0.{name}", p.detach(), cfg, mesh).clone(),
                    requires_grad=False))
        out.append((part.to(p.device, p.dtype).requires_grad_(False),
                    tmesh.local_heads(cfg.n_head, mesh)))
    return out


def _rank_stacks(stacks, h0: int, h1: int):
    """Heads [h0, h1) of a stacked int8 cross cache."""
    ck, cv, ks, vs = stacks
    return (ck[..., h0 * 64:h1 * 64].contiguous(), cv[..., h0 * 64:h1 * 64].contiguous(),
            ks[..., h0:h1].contiguous(), vs[..., h0:h1].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, None)])
@pytest.mark.parametrize("parts", [2, 3])
def test_k4_partial_form_matches_its_plain_version_and_sums_to_the_kernel(dtype, tol, parts):
    """K4's partial form on each model rank's F/parts columns (1,536 and
    1,024 of gpt2's 3,072): the f32 partial against its plain version
    (fp32 at K4's 2e-5, bf16 within its bar), and the partials summed, then
    bias and residual, against the unsplit kernel: two summation orders
    of the same f32 products, each within 2e-5 of the plain version's, so
    within 4e-5 of each other in fp32 (bf16: its bar)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, D = 64, 768
    cfg, blk = _block(D, 12, dtype, "cuda", seed=7)
    h = torch.from_numpy(np.random.default_rng(7).standard_normal((B, 1, D)).astype(
        np.float32)).to("cuda", dtype)
    before = (tfd.LAUNCHES, tfd.TP_LAUNCHES)
    total = 0
    for part, _ in _rank_parts(blk, cfg, parts):
        got = tfd.fused_ln_mlp_partial(h, part.ln_2, part.mlp, cfg)
        want = tfd.fused_ln_mlp_partial_reference(h, part.ln_2, part.mlp, cfg)
        assert got.dtype == torch.float32 and got.shape == (B, 1, D)
        ok, err = _within(got, want, dtype, tol)
        assert ok, err
        total = total + got
    whole = tfd.fused_ln_mlp(h, blk.ln_2, blk.mlp, cfg)
    got = tfd.finish_partial(h, total, blk.mlp.c_proj.bias)
    torch.cuda.synchronize()
    assert (tfd.LAUNCHES, tfd.TP_LAUNCHES) == (before[0] + parts + 1, before[1] + parts)
    ok, err = _within(got, whole, dtype, None if tol is None else 2 * tol)
    assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, None)])
@pytest.mark.parametrize("D,H,parts", [(768, 12, 2), (768, 12, 3), (1600, 25, 2)])
def test_k3_partial_form_matches_its_plain_version_and_sums_to_the_kernel(dtype, tol, D, H,
                                                                          parts):
    """K3's partial form on each model rank's heads (gpt2's 6/6 and 4/4/4,
    gpt2-xl's 13/12, whose q projection is 832 columns wide): the f32
    partial against its plain version, and the partials summed, then bias,
    capless-row gate and residual, against the whole sublayer (the kernel
    where D % 128 == 0, else its plain version); fp32 at K3's 2e-4 (twice
    that for the sum against the whole: two summation orders, each within
    the bar of the plain version), bf16 within its bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Lc = 64, 21
    cfg, blk = _block(D, H, dtype, "cuda", seed=8)
    rng = np.random.default_rng(8)
    h = torch.from_numpy(rng.standard_normal((B, 1, D)).astype(np.float32)).to("cuda", dtype)
    stacks = _cross_stacks(rng, 2, B, Lc, D, H, "cuda")
    m = (np.arange(Lc)[None] < rng.integers(1, Lc + 1, (B, 1))).astype(np.float32)
    m[3] = 0.0  # a caption-less row
    mask = torch.from_numpy(m).cuda()
    before = tcd.TP_LAUNCHES
    total = 0
    for part, (h0, h1) in _rank_parts(blk, cfg, parts):
        local = _rank_stacks(stacks, h0, h1)
        got = tcd.fused_cross_decode_partial(h, part, 1, 0.125, local, mask, cfg)
        want = tcd.fused_cross_decode_partial_reference(h, part, 1, 0.125, local, mask, cfg)
        assert got.dtype == torch.float32 and got.shape == (B, 1, D)
        ok, err = _within(got, want, dtype, tol)
        assert ok, err
        total = total + got
    whole = (tcd.fused_cross_decode if D % 128 == 0 else tcd.fused_cross_decode_reference)(
        h, blk, 1, 0.125, stacks, mask, cfg)
    got = tfd.finish_partial(h, total, blk.cross_attn.c_proj.bias, mask)
    torch.cuda.synchronize()
    assert tcd.TP_LAUNCHES == before + parts
    ok, err = _within(got, whole, dtype, None if tol is None else 2 * tol)
    assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H", [6, 13])
@pytest.mark.parametrize("causal", [True, False])
def test_prefill_kernel_on_a_model_ranks_heads(dtype, tol, H, causal):
    """K1 on a model rank's heads: gpt2's 6 of 12 (384 wide) and gpt2-xl's
    13 of 25 (832 wide, not a multiple of 128), causal with left pads and
    the cross form over a ragged 32-token caption, q a strided view of a
    fused projection."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, L = 32, 128
    Lk = L if causal else 32
    rng = np.random.default_rng(9)
    qkv = _merged(rng, B, L, 3 * H * 64).to("cuda", dtype)
    q = qkv[..., :H * 64]
    k, v = ((qkv[..., H * 64:2 * H * 64], qkv[..., 2 * H * 64:]) if causal else
            tuple(_merged(rng, B, Lk, H * 64).to("cuda", dtype) for _ in range(2)))
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
    assert tpa.LAUNCHES == before + 1 and got.shape == (B, L, H * 64)
    rows = m[:, :, None] if causal else 1.0
    err = ((got.float() - want.float()) * rows).abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4), (torch.bfloat16, None)])
@pytest.mark.parametrize("B,T,index", [(32, 512, 400), (8, 1024, 1000)])
def test_decode_attention_kernel_on_a_model_ranks_heads(dtype, tol, B, T, index):
    """K2 on 6 heads (gpt2's over model=2) at a data rank's rows: its plan
    sees the local batch and heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    H = 6
    rng = np.random.default_rng(10)
    q, kq, vq, ks, vs = _k2_inputs(rng, B, H, T, dtype, "cuda")
    pads = rng.integers(0, min(index, 200) + 1, B)
    mask = torch.from_numpy((np.arange(T)[None] >= pads[:, None]).astype(np.float32)).cuda()
    got = tda.decode_mha_int8(q, kq, vq, ks, vs, index, 0.125, mask, n_head=H)
    want = tda.decode_mha_int8_reference(q, kq, vq, ks, vs, index, 0.125, mask, n_head=H)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert tda.LAST_CLUSTER == tda.plan(B, H, T, index, sms)
    ok, err = _within(got, want, dtype, tol)
    assert ok, err
