"""Attention math of the port (counterpart of ``ergm_tpu/ops/attention.py``).

``xla_attention`` is the plain attention: f32 logits, a ``where``-style
causal mask with ``causal_offset``, an additive -1e9 key bias, an f32
softmax, and the probabilities cast to v's dtype before the PV product.
It is the CPU path and the oracle of the port's kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_NEG_INF = -1e9


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and an f32 result (JAX's
    ``preferred_element_type=float32``). Batch dims must match.

    On the GPU, bf16 operands go to cuBLAS with an f32 output; elsewhere
    the operands are upcast first, which forms the same exact products."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        batch = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.view(*batch, a.shape[-2], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def attention_bias_from_mask(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, Lk] 0/1 mask -> additive [B, 1, 1, Lk] bias."""
    bias = (1.0 - mask.to(dtype)) * _NEG_INF
    return bias[:, None, None, :]


def xla_attention(
    q: torch.Tensor,  # [B, H, Lq, D]
    k: torch.Tensor,  # [B, H, Lk, D]
    v: torch.Tensor,  # [B, H, Lk, D]
    *,
    causal: bool,
    bias: Optional[torch.Tensor] = None,  # additive, broadcastable to [B, H, Lq, Lk]
    scale: Union[float, torch.Tensor, None] = None,
    causal_offset: int = 0,
) -> torch.Tensor:
    """Plain attention; query i sees keys <= i + ``causal_offset`` when causal."""
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
    return torch.matmul(probs.to(v.dtype), v)


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Lk] 1=real key
    extra_bias: Optional[torch.Tensor] = None,
    scale: Union[float, torch.Tensor, None] = None,
    causal_offset: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention dispatch. Only the plain route is ported: ``auto`` and
    ``xla`` take it; the block and flash kernels are not ported yet."""
    if impl not in ("auto", "xla"):
        raise NotImplementedError(f"attention impl {impl!r} is not ported yet")
    bias = attention_bias_from_mask(kv_mask) if kv_mask is not None else None
    if extra_bias is not None:
        bias = extra_bias if bias is None else bias + extra_bias
    return xla_attention(q, k, v, causal=causal, bias=bias, scale=scale,
                         causal_offset=causal_offset)
