"""Masked attention for the shapes of JAX's library flash kernel, forward
and backward: kernel K7 of the port.

Counterpart of ``ergm_tpu/ops/flash_attention.py`` (``flash_mha``), which
wraps JAX's library TPU flash kernel for what JAX's block kernel refuses:
L > 1024, causal Lq < Lk at offset 0, and every head width outside the
block gate's (``flash_supported``, the gate; no dropout). The library
kernel's forward is one pass over key blocks with an online softmax, and
it rounds p = exp(s - m_running) to the input type before the P·V
product, before it is normalised; its backward takes delta = rowsum(o·dO)
in f32 and recomputes p from the saved statistics.

On CUDA tensors ``flash_mha`` is a ``torch.autograd.Function`` whose
forward and backward launch the hand-written kernels of
``csrc/block_attention.cu`` through ``ergm_flash_mha_fwd`` /
``ergm_flash_mha_bwd`` (see the note at the top of that file), or raise:
in bf16 the one-pass ``flash::`` kernels, which compute what the library
kernel computes (``flash_mha_reference``), at head widths 64, 128, 256
and 384, and the ``wide::`` kernels at a multiple of 128 past 384; in f32
K5's f32 kernels. On CPU tensors it runs ``kernel_reference``, the plain
version of what the card runs at that width and dtype.

Head widths: those the library kernel takes, any below 128 and any
multiple of 128 (``flash_head_ok``). Below 128 ``flash_mha`` pads q, k and
v with zero columns to the width it runs (``head_width``: 64 or 128 in
bf16, K5's ``HEAD_DIMS`` in f32) and slices the output back, with the
softmax scale of the true width: the zero columns add nothing to q·kᵀ,
and their output and gradient columns are dropped. The masking is the
port's, as in K5: padded query rows give zeros and no gradient, real rows
that see no real key (dead) spread over every key, and a masked score's
ds is 0 (JAX's segment ids differ on those rows only).
"""

from __future__ import annotations

from typing import Optional

import torch

from ergm_tpu_torch.ops import block_attention as ba
from ergm_tpu_torch.ops.attention import _NEG_INF, matmul_f32

# The one-pass kernels' head widths (bf16) and the keys of their forward's
# tile there: the key block of their plain version, on which the forward's
# rounding depends
FLASH_TILES = {64: 128, 128: 128, 256: 64, 384: 32}
# Launches since the last reset: forward calls, and backward calls (each
# runs the dQ kernel, then the dK/dV kernel). A run sets them to 0 and reads
# them back to show that its path went through the kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0


def flash_head_ok(D: int) -> bool:
    """The head widths of JAX's flash domain, those its library kernel
    takes, which the kernels take: any below 128 and any multiple of 128."""
    return 1 <= D < 128 or (D >= 128 and D % 128 == 0)


def flash_kernel_takes(q) -> bool:
    """Whether the kernels take q inside JAX's flash gate: ``flash_head_ok``
    and the dtype (float32 or bfloat16)."""
    return flash_head_ok(q.shape[-1]) and q.dtype in ba.DTYPE_CODE


def flash_supported(q, k, v, *, causal: bool, causal_offset=0,
                    dropout_active: bool = False) -> bool:
    """JAX's flash gate (``flash_attention_supported``) without its TPU
    check: no dropout, Lq >= 128, Lq and Lk multiples of 128 of any size,
    and when causal Lq <= Lk with an offset of 0 (query i sees keys <= i);
    and the head widths JAX's library kernel takes (``flash_head_ok``: JAX's
    gate passes the others, where the library raises)."""
    lq, lk = q.shape[2], k.shape[2]
    if (dropout_active or not flash_head_ok(q.shape[-1]) or lq < 128 or lq % 128
            or lk % 128):
        return False
    return not (causal and (lq > lk or int(causal_offset) != 0))


def head_width(D: int, dtype) -> int:
    """The width the kernels run head width ``D`` at: in bf16 64 up to 64,
    128 up to 128 (the one-pass kernels' widths); in f32 the least of K5's
    ``HEAD_DIMS`` at or above it; past 128 ``D`` itself."""
    if dtype != torch.bfloat16:
        return ba.head_width(D)
    return D if D > 128 else (64 if D <= 64 else 128)


def flash_route(D: int, dtype) -> bool:
    """Whether the card runs head width ``D`` in ``dtype`` on the one-pass
    kernels, the arithmetic of JAX's library flash kernel
    (``flash_mha_reference``): bf16 up to 128 (padded), at 256 and at 384.
    f32, and bf16 at a multiple of 128 past 384 (``wide::``), run K5's
    two-pass arithmetic (``block_mha_reference``)."""
    return dtype == torch.bfloat16 and head_width(D, dtype) in FLASH_TILES


class _FlashReference(torch.autograd.Function):
    """JAX's library flash kernel's arithmetic in plain torch, key block by
    key block: forward ``flash_attention.py::_flash_attention_kernel_single_batch``,
    backward its dK/dV and dQ kernels with di = rowsum(o * dO) taken
    outside them (``_flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, qm, km, scale, causal, block_k):
        B, H, lq, D = q.shape
        lk = k.shape[2]
        m = torch.full((B, H, lq, 1), float("-inf"), device=q.device)
        l = torch.zeros((B, H, lq, 1), device=q.device)
        acc = torch.zeros((B, H, lq, D), device=q.device)
        for c0 in range(0, lk, block_k):
            s, _ = _flash_scores(q, k, km, scale, causal, c0, block_k)
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_next)
            alpha = torch.exp(m - m_next)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + matmul_f32(p.to(q.dtype), v[:, :, c0:c0 + block_k])
            m = m_next
        o = torch.where(qm[:, None, :, None].bool(), acc / torch.clamp_min(l, 1e-30), 0.0)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, m, l, qm, km)
        ctx.args = (scale, causal, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l, qm, km = ctx.saved_tensors
        scale, causal, block_k = ctx.args
        do = do.to(q.dtype)
        delta = (o.float() * do.float()).sum(-1, keepdim=True)
        inv = torch.where(qm[:, None, :, None].bool(), 1.0 / torch.clamp_min(l, 1e-30), 0.0)
        dq = torch.zeros(q.shape, device=q.device)
        dk, dv = [], []
        for c0 in range(0, k.shape[2], block_k):
            s, vis = _flash_scores(q, k, km, scale, causal, c0, block_k)
            p = torch.exp(s - m) * inv
            dv.append(matmul_f32(p.to(q.dtype).transpose(-1, -2), do))
            dp = matmul_f32(do, v[:, :, c0:c0 + block_k].transpose(-1, -2))
            # masked scores are constants of the forward: their ds is 0
            ds = (torch.where(vis, p * (dp - delta), 0.0) * scale).to(q.dtype)
            dq += matmul_f32(ds, k[:, :, c0:c0 + block_k])
            dk.append(matmul_f32(ds.transpose(-1, -2), q))
        return (dq.to(q.dtype), torch.cat(dk, 2).to(q.dtype), torch.cat(dv, 2).to(q.dtype),
                None, None, None, None, None)


def _flash_scores(q, k, km, scale, causal, c0, block_k):
    """The f32 scores of q against keys [c0, c0 + block_k), the where's
    fill on the keys a query does not see, and which it sees."""
    lq = q.shape[2]
    s = matmul_f32(q, k[:, :, c0:c0 + block_k].transpose(-1, -2)) * scale
    vis = km[:, None, None, c0:c0 + block_k].bool()
    if causal:
        cols = torch.arange(c0, c0 + block_k, device=q.device)
        vis = vis & (cols[None, :] <= torch.arange(lq, device=q.device)[:, None])
    return torch.where(vis, s, _NEG_INF), vis


def flash_mha_reference(q, k, v, *, causal: bool, scale: Optional[float] = None, q_mask=None,
                        kv_mask=None, block_k: Optional[int] = None):
    """The plain version of the one-pass kernels (``flash_route``), the
    arithmetic of JAX's library flash kernel, differentiable: one pass over
    key blocks of ``block_k`` with an online softmax, the running max m
    and sum l in f32, p = exp(s - m) rounded to q's dtype before the P·V
    product (before it is normalised), the f32 sum rescaled as m moves and
    normalised once at the end. The backward recomputes p from the saved
    m and l, takes delta = rowsum(o·dO) in f32 and rounds ds = p (dP -
    delta) scale before dQ = ds·K and dK = dsᵀ·Q, and p before dV = pᵀ·dO.
    The port's masking (the module's note). ``block_k`` defaults to the
    kernels' tile at the width they run q's at (FLASH_TILES; 128
    elsewhere): the rounding of p follows the key block."""
    D, lk = q.shape[-1], k.shape[2]
    if block_k is None:
        block_k = FLASH_TILES.get(head_width(D, torch.bfloat16), 128)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if lk % block_k:
        raise ValueError(f"flash_mha_reference: Lk = {lk} is not a multiple of {block_k}")
    qm, km = ba.masks(q, k, q_mask, kv_mask)
    return _FlashReference.apply(q, k, v, qm, km, float(scale), bool(causal), int(block_k))


def kernel_reference(q, k, v, *, causal: bool, scale: Optional[float] = None, q_mask=None,
                     kv_mask=None):
    """The plain version of what ``flash_mha`` runs on the card for q's
    width and dtype: ``flash_mha_reference`` on the one-pass route
    (``flash_route``), else ``block_mha_reference``."""
    if flash_route(q.shape[-1], q.dtype):
        return flash_mha_reference(q, k, v, causal=causal, scale=scale, q_mask=q_mask,
                                   kv_mask=kv_mask)
    return ba.block_mha_reference(q, k, v, causal=causal, scale=scale, q_mask=q_mask,
                                  kv_mask=kv_mask)


def launch_bwd(q, k, v, o, ml, qm, kbits, dead, do, scale, causal):
    """The backward kernels (dQ, then dK/dV) on the forward's saved tensors
    and the output's cotangent ``do``: (dq, dk, dv) in q's dtype, each a
    [B, H, L, Dh] view of [B, L, H, Dh] memory."""
    grads = ba.run_bwd("ergm_flash_mha_bwd", "flash_mha", q, k, v, o, ml, qm, kbits, dead, do,
                       scale, causal)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return grads


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, qm, km, scale, causal):
        o, ml, kbits, dead = ba.run_fwd("ergm_flash_mha_fwd", "flash_mha", q, k, v, qm, km,
                                        scale, causal)
        global LAUNCHES
        LAUNCHES += 1
        ctx.save_for_backward(q, k, v, o, ml, qm, kbits, dead)
        ctx.args = (scale, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = launch_bwd(*ctx.saved_tensors, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              scale: Optional[float] = None, q_mask: Optional[torch.Tensor] = None,
              kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable masked attention over q [B, H, Lq, Dh], k/v
    [B, H, Lk, Dh] (strided views with a contiguous head dim are read in
    place) inside JAX's flash gate (``flash_supported``). ``q_mask`` [B, Lq]
    and ``kv_mask`` [B, Lk]: 1 = real. ``scale`` defaults to 1/sqrt(Dh).
    Returns [B, H, Lq, Dh]; on the card a view of [B, Lq, H, Dh'] memory
    (Dh' the width it runs, ``head_width``)."""
    B, H, lq, D = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return kernel_reference(q, k, v, causal=causal, scale=float(scale), q_mask=q_mask,
                                kv_mask=kv_mask)
    if k.shape[-1] != D or v.shape[-1] != D or not flash_head_ok(D):
        raise ValueError(f"flash_mha: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}; the kernels take one head width, below 128 or a "
                         f"multiple of 128")
    if not flash_supported(q, k, v, causal=causal):
        raise ValueError(f"flash_mha: q {tuple(q.shape)}, k {tuple(k.shape)} (causal={causal}) "
                         f"is outside the kernel's gate")
    width = head_width(D, q.dtype)
    q, k, v, qm, km = ba.operands("flash_mha", q, k, v, q_mask, kv_mask, width)
    o = _FlashAttention.apply(q, k, v, qm, km, float(scale), bool(causal))
    return o if width == D else o[..., :D]
