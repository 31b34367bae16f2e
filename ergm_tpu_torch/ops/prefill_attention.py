"""Batched-rows prefill attention: kernel K1 of the port.

Counterpart of ``ergm_tpu/ops/prefill_attention.py``. ``prefill_mha``
takes merged-layout operands, q [B, L, H*64] and k/v [B, Lk, H*64], in
the causal form (self-attention prefill) or the rectangular
non-causal form (cross-attention prefill over the caption). On a CUDA
tensor it launches the hand-written kernel in
``csrc/prefill_attention.cu`` (see the note at the top of that file),
or raises; on a CPU tensor it runs ``prefill_mha_reference``, the same
math in plain torch ops.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from ergm_tpu_torch.ops import _build
from ergm_tpu_torch.ops.attention import attention_bias_from_mask, xla_attention

HEAD_DIM = 64
MAX_KEYS = 512
ITEM_ROWS = 128  # query rows a bf16 kernel item (one CTA's step of the walk)
# Kernel launches since the last reset, of both forms and of the cross
# form alone; a run sets them to 0 and reads them back to show that its
# path went through the kernel.
LAUNCHES = 0
CROSS_LAUNCHES = 0
# What the last launch reported (three ints: the bf16 kernel's grid, the
# items it walks and its key tile; zeros in fp32)
LAST_GRID = None
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supported(B: int, L: int, config, deterministic: bool) -> bool:
    """JAX's shape/config gate. The TPU's VMEM tile budget (``_pick_bt``)
    is not carried over: the CUDA kernel takes any batch."""
    c = config
    if c.head_dim != HEAD_DIM or (c.n_head * c.head_dim) % 128:
        return False
    if not deterministic and c.attn_pdrop > 0:
        return False
    if L > MAX_KEYS or L % 8:
        return False
    return B % 8 == 0


def items(B: int, H: int, L: int) -> int:
    """The bf16 kernel's work items: (batch row, head, block of 128 query
    rows)."""
    return -(-L // ITEM_ROWS) * B * H


def grid(B: int, H: int, L: int, sms: int) -> int:
    """CTAs of the bf16 kernel: one an SM, each walking items blockIdx.x,
    blockIdx.x + grid, ... (no more CTAs than items)."""
    return min(items(B, H, L), sms)


def _split(x: torch.Tensor, n_head: int) -> torch.Tensor:  # [B, L, D] -> [B, H, L, Dh]
    b, l, d = x.shape
    return x.view(b, l, n_head, d // n_head).transpose(1, 2)


def _fold_scale(qm, scale):
    """JAX folds a traced scale into q in q's dtype; a float stays a
    float, applied to the f32 scores."""
    if isinstance(scale, torch.Tensor):
        return qm * scale.to(qm.dtype), 1.0
    return qm, float(scale)


def prefill_mha_reference(qm, km, vm, kv_mask, *, n_head, scale, causal=True):
    """The plain version: ``xla_attention`` over split heads."""
    qm, scale = _fold_scale(qm, scale)
    bias = attention_bias_from_mask(kv_mask) if kv_mask is not None else None
    out = xla_attention(_split(qm, n_head), _split(km, n_head), _split(vm, n_head),
                        causal=causal, bias=bias, scale=scale)
    b, h, l, d = out.shape
    return out.transpose(1, 2).reshape(b, l, h * d)


def _check(qm, km, vm, kv_mask, n_head):
    for name, x in (("q", qm), ("k", km), ("v", vm)):
        if x.device.type != "cuda" or x.device != qm.device:
            raise ValueError(f"prefill_mha: {name} is on {x.device}, q on {qm.device}")
        if x.dtype not in _DTYPE_CODE or x.dtype != qm.dtype:
            raise TypeError(f"prefill_mha: {name} is {x.dtype}; float32 or bfloat16, "
                            f"all alike, are supported")
        if x.dim() != 3 or x.shape[-1] != n_head * HEAD_DIM or x.shape[0] != qm.shape[0]:
            raise ValueError(f"prefill_mha: {name} has shape {tuple(x.shape)}; want "
                             f"[{qm.shape[0]}, rows, {n_head * HEAD_DIM}]")
        if x.stride(-1) != 1 or max(x.stride(0), x.stride(1)) >= 2 ** 31:
            raise ValueError(f"prefill_mha: {name} needs a contiguous feature axis and "
                             f"strides below 2**31, got {x.stride()}")
        # the bf16 kernel reads each operand by TMA at its own strides
        if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or x.stride(0) % 8
                                          or x.stride(1) % 8):
            raise ValueError(f"prefill_mha: {name} needs a 16-byte aligned start and batch "
                             f"and row strides that are multiples of 8 elements, got "
                             f"strides {x.stride()}")
    if km.shape != vm.shape or not 1 <= km.shape[1] <= MAX_KEYS or qm.shape[1] < 1:
        raise ValueError(f"prefill_mha: k {tuple(km.shape)} / v {tuple(vm.shape)} need "
                         f"1..{MAX_KEYS} keys and equal shapes")
    if kv_mask is not None and (kv_mask.shape != km.shape[:2] or kv_mask.device != qm.device):
        raise ValueError(f"prefill_mha: mask {tuple(kv_mask.shape)} on {kv_mask.device} "
                         f"does not match keys {tuple(km.shape[:2])} on {qm.device}")


def prefill_mha(qm: torch.Tensor, km: torch.Tensor, vm: torch.Tensor,
                kv_mask: Optional[torch.Tensor], *, n_head: int,
                scale: Union[float, torch.Tensor], causal: bool = True) -> torch.Tensor:
    """(Rectangular) attention over merged-layout q [B, L, D] and k/v
    [B, Lk, D] (D = n_head * 64). ``kv_mask``: [B, Lk], 1 = real key, or
    None. ``causal=False`` is the cross-prefill form. q, k and v may be
    strided views (e.g. slices of one fused qkv projection) as long as
    their feature axis is contiguous. Returns [B, L, D] merged."""
    qm, scale = _fold_scale(qm, scale)
    if qm.device.type == "cpu":
        return prefill_mha_reference(qm, km, vm, kv_mask, n_head=n_head, scale=scale,
                                     causal=causal)
    _check(qm, km, vm, kv_mask, n_head)
    B, L, D = qm.shape
    Lk = km.shape[1]
    mask = None if kv_mask is None else kv_mask.to(torch.float32).contiguous()
    out = torch.empty((B, L, D), dtype=qm.dtype, device=qm.device)
    lib = _build.load()
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(qm.device):  # the C side launches on the current device
        err = lib.ergm_prefill_mha(
            qm.data_ptr(), km.data_ptr(), vm.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[qm.dtype], B, L, Lk, n_head,
            qm.stride(0), qm.stride(1), km.stride(0), km.stride(1),
            vm.stride(0), vm.stride(1), ctypes.c_float(scale), int(causal),
            grid(B, n_head, L, _build.sm_count(qm.device)), info,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"prefill_mha kernel launch failed: cudaError {err}")
    global LAUNCHES, CROSS_LAUNCHES, LAST_GRID
    LAST_GRID = info
    LAUNCHES += 1
    CROSS_LAUNCHES += not causal
    return out
