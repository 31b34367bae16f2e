"""Attention math of the port (counterpart of ``ergm_tpu/ops/attention.py``).

``xla_attention`` is the plain attention: f32 logits, a ``where``-style
causal mask with ``causal_offset``, an additive -1e9 key bias, an f32
softmax, optional attention-probability dropout, and the probabilities
cast to v's dtype before the PV product. It is the CPU path and the
oracle of the port's kernels.

Dropout draws its keep mask from ``dropout_keep``: the counter hash that
JAX's block-attention kernel uses in interpret mode
(``ergm_tpu/ops/block_attention.py::_keep_mask``). The mask is a function
of (seed, batch row, head, query, key) alone, so kernel K5, this plain
path and JAX's interpret-mode K5 drop the same probabilities, a backward
or a rematerialised forward regenerates them from the seed, and no mask
is stored. The TPU's hardware random stream cannot be matched anyway.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from ergm_tpu_torch.core import device as core_device

_NEG_INF = -1e9
_U32 = 1 << 32
_GOLDEN = 2654435761
_HASH_MUL = (0x7FEB352D, 0x846CA68B)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and an f32 result (JAX's
    ``preferred_element_type=float32``). Batch dims must match, or ``b``
    is a matrix applied to every row of ``a``.

    On the GPU, bf16 operands go to cuBLAS with an f32 output when no
    gradient is needed (that call has no derivative); elsewhere the
    operands are upcast first, which forms the same exact products and
    gives JAX's gradients (f32 cotangent, cast back to the operand's
    dtype)."""
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.is_cuda and a.dtype == torch.bfloat16 and not grad:
        if b.dim() == 2:
            out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
            return out.view(*a.shape[:-1], b.shape[-1])
        batch = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.view(*batch, a.shape[-2], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def attention_bias_from_mask(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, Lk] 0/1 mask -> additive [B, 1, 1, Lk] bias."""
    bias = (1.0 - mask.to(dtype)) * _NEG_INF
    return bias[:, None, None, :]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), in two halves so
    that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & (_U32 - 1)


def dropout_threshold(rate: float) -> int:
    """The uint32 keep threshold: keep iff hash >= threshold."""
    return int(min(rate * float(_U32), float(_U32 - 1)))


def dropout_keep(seed: int, batch: int, n_head: int, lq: int, lk: int, rate: float,
                 device=None, head_stride: Optional[int] = None) -> torch.Tensor:
    """Bool keep mask [B, H, Lq, Lk] of attention-probability dropout:
    ``mix = seed + b*S + h`` with the head stride S (default H),
    ``x = r*Lk + c + mix*2654435761`` (mod 2**32), three xorshift-multiply
    rounds, keep iff ``x >= rate*2**32``. A shard of rows from b0 and
    heads from h0 of a problem with H_global heads draws the whole
    problem's masks with ``seed + b0*H_global + h0`` and S = H_global."""
    stride = n_head if head_stride is None else int(head_stride)
    b = torch.arange(batch, dtype=torch.int64, device=device)[:, None, None, None]
    h = torch.arange(n_head, dtype=torch.int64, device=device)[None, :, None, None]
    r = torch.arange(lq, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(lk, dtype=torch.int64, device=device)[None, :]
    mix = (int(seed) + b * stride + h) % _U32
    x = (r * lk + c + _mul32(mix, _GOLDEN)) & (_U32 - 1)
    x = x ^ (x >> 16)
    x = _mul32(x, _HASH_MUL[0])
    x = x ^ (x >> 15)
    x = _mul32(x, _HASH_MUL[1])
    x = x ^ (x >> 16)
    return x >= dropout_threshold(rate)


def xla_attention(
    q: torch.Tensor,  # [B, H, Lq, D]
    k: torch.Tensor,  # [B, H, Lk, D]
    v: torch.Tensor,  # [B, H, Lk, D]
    *,
    causal: bool,
    bias: Optional[torch.Tensor] = None,  # additive, broadcastable to [B, H, Lq, Lk]
    scale: Union[float, torch.Tensor, None] = None,
    causal_offset: int = 0,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    seed: Optional[int] = None,
    dropout_head_stride: Optional[int] = None,
) -> torch.Tensor:
    """Plain attention; query i sees keys <= i + ``causal_offset`` when
    causal. Dropout applies when not ``deterministic``, ``dropout_rate``
    > 0 and a ``seed`` is given, as JAX's (which needs an rng); its
    mask's head stride is ``dropout_head_stride`` (``dropout_keep``)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = matmul_f32(q, k.transpose(-1, -2)) * scale
    if causal:
        lq, lk = q.shape[-2], k.shape[-2]
        qpos = torch.arange(lq, device=q.device)[:, None] + causal_offset
        kpos = torch.arange(lk, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, _NEG_INF)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    if not deterministic and dropout_rate > 0.0 and seed is not None:
        B, H, lq, lk = probs.shape
        keep = dropout_keep(seed, B, H, lq, lk, dropout_rate, device=probs.device,
                            head_stride=dropout_head_stride)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    return torch.matmul(probs.to(v.dtype), v)


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Lk] 1=real key
    q_mask: Optional[torch.Tensor] = None,   # [B, Lq] 1=real query (K5 only)
    extra_bias: Optional[torch.Tensor] = None,
    scale: Union[float, torch.Tensor, None] = None,
    causal_offset: int = 0,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    seed: Optional[int] = None,
    dropout_head_stride: Optional[int] = None,
) -> torch.Tensor:
    """Attention dispatch, in JAX's order.

    ``impl``: ``pallas`` and ``block`` take kernel K5
    (``ops/block_attention.py::block_mha``) inside JAX's block gate
    (``block_attention.supported``); otherwise, with no dropout active,
    ``pallas`` and ``flash`` take kernel K7
    (``ops/flash_attention.py::flash_mha``) inside JAX's flash gate
    (``flash_attention.flash_supported``: the shapes JAX sends to its
    library flash kernel, L > 1024 or causal Lq < Lk at offset 0, and every
    shape whose head width the block gate refuses, at the library kernel's
    head widths). ``auto`` is ``pallas`` for CUDA tensors
    (``core.device.on_card``), as JAX takes the Pallas kernels on the TPU,
    and the plain math elsewhere; on the CPU ``pallas``, ``block`` and
    ``flash`` run the kernels' plain versions. ``xla`` and every shape
    outside the gates take the plain math. On the card the kernels take, in
    float32 and bfloat16, the block gate's head widths (a multiple of 8 up
    to 128, ``block_attention.kernel_takes``) and the library kernel's (any
    below 128 and any multiple of 128, ``flash_attention.flash_kernel_takes``):
    outside them an explicit ``block`` or ``flash`` raises and ``pallas``
    takes the plain math, also at a width above 128 that is not a multiple
    of 128, where JAX's library kernel raises. The ``ERGM_ATTN_IMPL``
    environment variable overrides ``impl``. With an ``extra_bias``, only
    the plain math applies; ``q_mask`` reaches the kernels only (padded
    query rows give zero output and gradient there). ``dropout_head_stride``:
    the dropout hash's head stride (``dropout_keep``; a tensor-parallel
    shard of heads passes the model's head count with a folded ``seed``)."""
    from ergm_tpu_torch.ops import block_attention, flash_attention

    impl = os.environ.get("ERGM_ATTN_IMPL", impl)
    if impl not in ("auto", "pallas", "block", "flash", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    card = core_device.on_card(q)
    if impl == "auto":
        impl = "pallas" if card else "xla"
    dropout_active = (not deterministic) and dropout_rate > 0.0 and seed is not None
    # the gates below own the shapes; this adds what they pass and the
    # kernels do not take (float16; a flash width past 128 that is not a
    # multiple of 128): the plain math under pallas, and the raise of an
    # explicit block or flash
    if extra_bias is None and card and impl != "xla":
        takes = {"block": block_attention.kernel_takes(q),
                 "flash": flash_attention.flash_kernel_takes(q)}
        if impl == "pallas":
            if not (takes["block"] or takes["flash"]):
                impl = "xla"
        elif not takes[impl]:
            widths = ("a multiple of 8 up to 128" if impl == "block"
                      else "below 128 or a multiple of 128")
            raise ValueError(f"multihead_attention: impl={impl!r} on the card takes head widths "
                             f"{widths} in float32 or bfloat16, got q {tuple(q.shape)} {q.dtype}")
    if extra_bias is None and impl != "xla":
        block = impl in ("pallas", "block") and block_attention.supported(
            q, k, v, causal=causal, causal_offset=causal_offset)
        flash = not block and impl in ("pallas", "flash") and flash_attention.flash_supported(
            q, k, v, causal=causal, causal_offset=causal_offset, dropout_active=dropout_active)
        if block or flash:
            if isinstance(scale, torch.Tensor):
                q = q * scale.to(q.dtype)  # a tensor scale folds into q, as JAX folds a traced one
                scale = 1.0
            if flash:
                return flash_attention.flash_mha(q, k, v, causal=causal, scale=scale,
                                                 q_mask=q_mask, kv_mask=kv_mask)
            return block_attention.block_mha(
                q, k, v, causal=causal, scale=scale, q_mask=q_mask, kv_mask=kv_mask,
                dropout_rate=dropout_rate if dropout_active else 0.0,
                dropout_seed=seed if dropout_active else None,
                dropout_head_stride=dropout_head_stride)
    bias = attention_bias_from_mask(kv_mask) if kv_mask is not None else None
    if extra_bias is not None:
        bias = extra_bias if bias is None else bias + extra_bias
    return xla_attention(q, k, v, causal=causal, bias=bias, scale=scale,
                         causal_offset=causal_offset, dropout_rate=dropout_rate,
                         deterministic=deterministic, seed=seed,
                         dropout_head_stride=dropout_head_stride)
