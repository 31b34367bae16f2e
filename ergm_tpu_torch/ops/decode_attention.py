"""Single-token attention over an int8 KV cache: kernel K2 of the port.

Counterpart of ``ergm_tpu/ops/decode_attention.py``. ``decode_mha_int8``
attends one query token per row over one layer's int8 cache with the
per-(token, head) scales factored out of both products: the math of the
model's T >= 512 decode branch, which routes through it under
``ERGM_DECODE_KERNEL=1``. On a CUDA tensor it launches the hand-written
kernel in ``csrc/decode_attention.cu``, or raises; on a CPU tensor it runs
``decode_mha_int8_reference``, that branch in plain torch ops.

The kernel is bound by the cache bytes it reads. It splits a row's keys
over a thread-block cluster of ``plan(...)`` CTAs, which exchange their
softmax statistics and partial outputs through distributed shared memory,
so that one launch computes the row with p rounded where the model rounds
it; its products run on the tensor cores, the int8 codes converted by byte
permutes. The note at the top of the source gives the design and its
times on an H100.

Beyond JAX's kernel it takes a ``kv_mask`` (the left-pad mask of a
ragged batch), which the model branch applies too.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Union

import torch

from ergm_tpu_torch.ops import _build
from ergm_tpu_torch.ops.attention import matmul_f32

HEAD_DIM = 64
# A row's keys are split over a thread-block cluster of at most
# MAX_CLUSTER CTAs (the portable size), each holding at most MAX_KEYS keys
# of codes, scores and scales in shared memory: the cache slots the kernel
# takes.
MAX_CLUSTER, MAX_KEYS = 8, 1024
MAX_T = MAX_CLUSTER * MAX_KEYS
# The cluster size: enough CTAs to keep about CTAS_PER_SM on each
# streaming multiprocessor (so the cache reads of some overlap the
# arithmetic of others), each with at least MIN_KEYS keys to be worth its
# launch and its share of the cluster's exchanges.
CTAS_PER_SM, MIN_KEYS = 4, 64
# Kernel launches since the last reset; a run sets it to 0 and reads it
# back to show that its path went through the kernel.
LAUNCHES = 0
# the cluster size of the last launch
LAST_CLUSTER = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supported(B: int, T: int, config) -> bool:
    """JAX's gate (``decode_attention.py:181-192``): opt-in through
    ``ERGM_DECODE_KERNEL`` ("0" or "false" or unset is off) and head_dim
    64. JAX's TPU tiling rules (T % 256, an even head count, its batch
    tile) are not carried over; the kernel's own limit is ``MAX_T``. The
    kernel reads int8 codes: an int4 cache takes the plain version."""
    if os.environ.get("ERGM_DECODE_KERNEL", "0") in ("0", "false"):
        return False
    return (config.kv_cache_dtype != "int4" and config.head_dim == HEAD_DIM
            and 1 <= T <= MAX_T)


def plan(B: int, H: int, T: int, index: int, sms: int = 132) -> int:
    """The CTAs (a cluster) that a row's keys 0..index are split over on a
    card with ``sms`` streaming multiprocessors: about CTAS_PER_SM a
    multiprocessor over the grid's B * H rows, at most MAX_CLUSTER and at
    most one per MIN_KEYS keys, but enough that no CTA holds more than
    MAX_KEYS."""
    n = min(T, index + 1)
    want = -(-CTAS_PER_SM * sms // (B * H))
    return max(-(-n // MAX_KEYS), min(MAX_CLUSTER, want, -(-n // MIN_KEYS)))


def slice_keys(T: int, index: int, cluster: int) -> int:
    """Keys each CTA of a ``cluster`` takes (the kernel's rule): the row's
    n = min(T, index + 1) keys in equal shares, rounded up to whole 16-key
    steps; the last ranks may hold fewer, or none."""
    share = -(-min(T, index + 1) // cluster)
    return -(-share // 16) * 16


def decode_mha_int8_reference(q, kq, vq, ks, vs, index: int, scale,
                              kv_mask: Optional[torch.Tensor] = None, *, n_head: int):
    """The plain version: the model's scale-factored int8 branch. Keys
    0..index are visible, times ``kv_mask`` when given. p * v_scale is
    rounded to q's dtype before the PV product, as the branch does.
    Returns merged [B, H*64]."""
    B, H, T, Dh = kq.shape
    dt = q.dtype
    tail = (torch.arange(T, device=q.device) <= index).float()[None, :]
    m = tail if kv_mask is None else kv_mask * tail
    s = matmul_f32(q.to(dt), kq.to(dt).transpose(-1, -2)) * scale
    s = s * ks[..., 0].float()[:, :, None, :]
    s = s + (1.0 - m).float()[:, None, None, :] * -1e9
    probs = torch.softmax(s, dim=-1)
    pv = (probs * vs[..., 0].float()[:, :, None, :]).to(dt)
    out = torch.matmul(pv, vq.to(dt))  # [B, H, 1, Dh]
    return out.transpose(1, 2).reshape(B, H * Dh)


def _check(q, kq, vq, ks, vs, index, kv_mask, n_head):
    if q.device.type != "cuda":
        raise ValueError(f"decode_mha_int8: q is on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_mha_int8: q is {q.dtype}; float32 or bfloat16 are supported")
    B, H, T = kq.shape[0], kq.shape[1], kq.shape[2]
    if (q.dim() != 4 or tuple(q.shape) != (B, H, 1, HEAD_DIM) or q.stride(-1) != 1
            or H != n_head):
        raise ValueError(f"decode_mha_int8: q {tuple(q.shape)} does not match "
                         f"[{B}, {n_head}, 1, {HEAD_DIM}] with a contiguous last axis")
    for name, x, dtypes, last in (("kq", kq, (torch.int8,), HEAD_DIM),
                                  ("vq", vq, (torch.int8,), HEAD_DIM),
                                  ("ks", ks, tuple(_DTYPE_CODE), 1),
                                  ("vs", vs, (ks.dtype,), 1)):
        if (x.device != q.device or x.dtype not in dtypes or not x.is_contiguous()
                or tuple(x.shape) != (B, H, T, last)):
            raise ValueError(f"decode_mha_int8: {name} must be a contiguous "
                             f"{'/'.join(map(str, dtypes))} [{B}, {H}, {T}, {last}] tensor on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)}")
    if not 0 <= index < T or T > MAX_T:
        raise ValueError(f"decode_mha_int8: index {index} with {T} slots (at most {MAX_T})")
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError("decode_mha_int8: kq and vq must start on a 16-byte boundary")
    if kv_mask is not None and (kv_mask.dim() != 2 or tuple(kv_mask.shape) != (B, T)
                                or kv_mask.device != q.device):
        raise ValueError(f"decode_mha_int8: kv_mask {tuple(kv_mask.shape)} on "
                         f"{kv_mask.device} does not match [{B}, {T}] on {q.device}")


def decode_mha_int8(q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor, ks: torch.Tensor,
                    vs: torch.Tensor, index: int, scale: Union[float, torch.Tensor],
                    kv_mask: Optional[torch.Tensor] = None, *, n_head: int,
                    cluster: Optional[int] = None) -> torch.Tensor:
    """Scale-factored int8 decode attention, merged output.

    q: [B, H, 1, 64] (any batch and head strides); kq/vq: [B, H, T, 64]
    int8, one layer of the stacked cache (``cache.k[li]``, read in place);
    ks/vs: [B, H, T, 1] f32 or bf16 scales; index: tokens 0..index are
    visible; kv_mask: [B, T] 0/1 or None; scale: float or 0-dim tensor;
    cluster: the CTAs a row's keys are split over on the card (default
    ``plan``). Returns [B, H*64] in q's dtype."""
    if q.device.type == "cpu":
        return decode_mha_int8_reference(q, kq, vq, ks, vs, index, scale, kv_mask,
                                         n_head=n_head)
    _check(q, kq, vq, ks, vs, index, kv_mask, n_head)
    B, H, T = kq.shape[0], kq.shape[1], kq.shape[2]
    if cluster is None:
        cluster = plan(B, H, T, index,
                       torch.cuda.get_device_properties(q.device).multi_processor_count)
    if not 1 <= cluster <= MAX_CLUSTER or slice_keys(T, index, cluster) > MAX_KEYS:
        raise ValueError(f"decode_mha_int8: a cluster of {cluster} CTAs for keys 0..{index} "
                         f"(1 to {MAX_CLUSTER} CTAs of at most {MAX_KEYS} keys)")
    m = None
    if kv_mask is not None:
        m = kv_mask.to(torch.float32)
        if m.stride(-1) != 1:
            m = m.contiguous()
    out = torch.empty((B, H * HEAD_DIM), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):  # the C side launches on the current device
        err = lib.ergm_decode_mha_int8(
            q.data_ptr(), q.stride(0), q.stride(1), kq.data_ptr(), vq.data_ptr(),
            ks.data_ptr(), vs.data_ptr(), None if m is None else m.data_ptr(),
            0 if m is None else m.stride(0), out.data_ptr(), _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[ks.dtype], B, H, T, int(index), ctypes.c_float(float(scale)), cluster,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode_mha_int8 kernel launch failed: cudaError {err}")
    global LAUNCHES, LAST_CLUSTER
    LAUNCHES += 1
    LAST_CLUSTER = cluster
    return out
