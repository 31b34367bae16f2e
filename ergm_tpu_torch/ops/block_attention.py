"""Masked attention with probability dropout, forward and backward:
kernel K5 of the port.

Counterpart of ``ergm_tpu/ops/block_attention.py`` (``block_mha``), inside
JAX's block gate (``supported``): whole-sequence problems up to 1,024
tokens. The training path's self-attention runs here: causal, q/kv 0/1
masks, zero output and gradient for padded query rows, and
attention-probability dropout whose keep mask comes from the counter hash
of ``ops/attention.py::dropout_keep``. On CUDA tensors ``block_mha`` is a
``torch.autograd.Function`` whose forward and backward launch the
hand-written kernels of ``csrc/block_attention.cu`` (see the note at the
top of that file), or raise; on CPU tensors it runs
``block_mha_reference``, the same math in differentiable plain torch. The
shapes JAX sends to its library flash kernel (K7) go to
``ops/flash_attention.py``.

Head widths, in float32 and bfloat16: the card takes every head width of
JAX's block gate, a multiple of 8 up to 128 (``head_ok``). The kernels are
built for ``HEAD_DIMS``; ``block_mha`` pads q, k and v with zero columns
to the next of them (``head_width``) and slices the output back, with the
softmax scale of the true width: the zero columns add nothing to q·kᵀ,
and their output and gradient columns are dropped.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ergm_tpu_torch.ops import _build
from ergm_tpu_torch.ops.attention import _NEG_INF, dropout_keep, dropout_threshold, matmul_f32

HEAD_DIMS = (32, 64, 96, 128)  # the head widths the CUDA kernels are built for
# Launches since the last reset: forward kernels, and backward calls (each
# runs the dQ kernel, then the dK/dV kernel). A run sets them to 0 and
# reads them back to show that its path went through the kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def head_ok(D: int) -> bool:
    """The head widths of JAX's block gate, which the kernels take: a
    multiple of 8 up to 128."""
    return 8 <= D <= 128 and D % 8 == 0


def kernel_takes(q) -> bool:
    """Whether the kernels take q inside JAX's block gate: its head width
    and dtype (float32 or bfloat16; float16, which JAX's kernels take and
    no path of ``ergm_tpu`` reaches, is not ported)."""
    return head_ok(q.shape[-1]) and q.dtype in DTYPE_CODE


def head_width(D: int) -> int:
    """The width the kernels run head width ``D`` at: below 128 the least
    of HEAD_DIMS at or above it, else ``D`` itself."""
    return D if D > 128 else next(w for w in HEAD_DIMS if w >= D)


def supported(q, k, v, *, causal: bool, causal_offset=0) -> bool:
    """JAX's block gate (``block_attention_supported``): whole-sequence
    problems with Dh <= 128 a multiple of 8, Lq and Lk multiples of 128
    up to 1024, Lq == Lk and no offset when causal. The kernels take its
    every head width; on the card float16 raises."""
    B, H, lq, D = q.shape
    lk = k.shape[2]
    if not head_ok(D) or lq % 128 or lk % 128 or lq < 128 or lq > 1024 or lk > 1024:
        return False
    return not (causal and (lq != lk or int(causal_offset) != 0))


def masks(q, k, q_mask, kv_mask):
    """The 0/1 int32 query and key masks [B, Lq] and [B, Lk] the kernels
    read (all ones where a mask is None)."""
    B, lq, lk = q.shape[0], q.shape[2], k.shape[2]
    qm = (torch.ones((B, lq), dtype=torch.int32, device=q.device) if q_mask is None
          else (q_mask != 0).to(torch.int32).contiguous())
    km = (torch.ones((B, lk), dtype=torch.int32, device=q.device) if kv_mask is None
          else (kv_mask != 0).to(torch.int32).contiguous())
    return qm, km


def block_mha_reference(q, k, v, *, causal: bool, scale: Optional[float] = None, q_mask=None,
                        kv_mask=None, dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None,
                        dropout_head_stride: Optional[int] = None):
    """The plain version, differentiable: JAX's ``_fwd_kernel`` over the
    whole row (``_probs`` then dropout), f32 scores and softmax, the
    probabilities rounded to q's dtype before the PV product, f32
    accumulation, the output rounded to q's dtype. ``scale`` defaults to
    1/sqrt(Dh), as ``block_mha``'s."""
    B, H, lq, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lk = k.shape[2]
    qm, km = masks(q, k, q_mask, kv_mask)
    s = matmul_f32(q, k.transpose(-1, -2)) * scale
    mask = km[:, None, None, :].bool()
    if causal:
        mask = mask & (torch.arange(lk, device=q.device)[None, :]
                       <= torch.arange(lq, device=q.device)[:, None])
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    pn = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    pn = torch.where(qm[:, None, :, None].bool(), pn, 0.0)
    if dropout_rate > 0.0:
        keep = dropout_keep(dropout_seed, B, H, lq, lk, dropout_rate, device=q.device,
                            head_stride=dropout_head_stride)
        pn = torch.where(keep, pn / (1.0 - dropout_rate), 0.0)
    return matmul_f32(pn.to(q.dtype), v).to(q.dtype)


def _check(name, x, like, shape, who):
    """Raises unless ``x`` is what the kernels of ``who`` read: on q's card,
    q's dtype (float32 or bfloat16), ``shape``, a contiguous head dim and
    16-byte aligned rows."""
    if x.device.type != "cuda" or x.device != like.device:
        raise ValueError(f"{who}: {name} is on {x.device}, q on {like.device}")
    if x.dtype != like.dtype or x.dtype not in DTYPE_CODE:
        raise TypeError(f"{who}: {name} is {x.dtype}; float32 or bfloat16, all alike, "
                        f"are supported")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, want {tuple(shape)}")
    vec = 16 // x.element_size()  # the kernel loads rows 16 bytes at a time
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(s % vec for s in x.stride()[:3]):
        raise ValueError(f"{who}: {name} needs a contiguous head dim and 16-byte aligned "
                         f"rows, got strides {x.stride()}")


def _heads_layout(B, H, L, D, dtype, device):
    """A [B, H, L, D] view of [B, L, H, D] memory: the merged layout the
    model reads next, so merging the heads back copies nothing."""
    return torch.empty((B, L, H, D), dtype=dtype, device=device).transpose(1, 2)


def _dropout_args(rate: float, seed: int, head_stride: int):
    """(on, 1 - rate, 1 / (1 - rate), threshold, seed mod 2**32, head
    stride): the two f32 factors are JAX's, the Python floats of its
    kernel rounded to f32."""
    on = rate > 0.0
    return (int(on), ctypes.c_float(1.0 - rate),
            ctypes.c_float(1.0 / (1.0 - rate) if on else 1.0),
            ctypes.c_uint(dropout_threshold(rate)), ctypes.c_uint(int(seed) % (1 << 32)),
            int(head_stride))


def _strides(*xs):
    vals = [s for x in xs for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def operands(who, q, k, v, q_mask, kv_mask, width):
    """q, k and v zero-padded to ``width`` (differentiably: the padding's
    gradient is dropped) and checked as the kernels of ``who`` read them,
    with the 0/1 masks: (q, k, v, qm, km)."""
    B, H, lq, D = q.shape
    lk = k.shape[2]
    if width != D:
        q, k, v = (F.pad(x, (0, width - D)) for x in (q, k, v))
    _check("q", q, q, (B, H, lq, width), who)
    _check("k", k, q, (B, H, lk, width), who)
    _check("v", v, q, (B, H, lk, width), who)
    for name, m, n in (("q_mask", q_mask, lq), ("kv_mask", kv_mask, lk)):
        if m is not None and (tuple(m.shape) != (B, n) or m.device != q.device):
            raise ValueError(f"{who}: {name} {tuple(m.shape)} on {m.device}, want "
                             f"[{B}, {n}] on {q.device}")
    return (q, k, v, *masks(q, k, q_mask, kv_mask))


def run_fwd(entry, who, q, k, v, qm, km, scale, causal, *extra):
    """Runs the forward C entry point ``entry`` of the kernels of ``who``
    (``extra``: its arguments after ``causal``): (o, ml, kbits, dead), the
    output, a [B, H, L, Dh] view of [B, L, H, Dh] memory, and what the
    backward reads. ``kbits`` (the key mask as bits) and ``dead`` (where
    each batch row's dead rows end: real causal rows before the first real
    key) are written by the forward's pre-pass."""
    B, H, L, D = q.shape
    Lk = k.shape[2]
    o = _heads_layout(B, H, L, D, q.dtype, q.device)
    ml = torch.empty((2, B, H, L), dtype=torch.float32, device=q.device)
    kbits = torch.empty((B, Lk // 32), dtype=torch.int32, device=q.device)
    dead = torch.empty((B,), dtype=torch.int32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ml.data_ptr(),
            qm.data_ptr(), km.data_ptr(), kbits.data_ptr(), dead.data_ptr(),
            DTYPE_CODE[q.dtype], D, B, H, L, Lk, _strides(q, k, v, o), ctypes.c_float(scale),
            int(causal), *extra, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{who} forward kernel launch failed: cudaError {err}")
    return o, ml, kbits, dead


def run_bwd(entry, who, q, k, v, o, ml, qm, kbits, dead, do, scale, causal, *extra):
    """Runs the backward C entry point ``entry`` of the kernels of ``who``
    (dQ, then dK/dV; ``extra``: its arguments after ``causal``) on the
    forward's saved tensors and the output's cotangent ``do``: (dq, dk, dv)
    in q's dtype, each a [B, H, L, Dh] view of [B, L, H, Dh] memory."""
    B, H, L, D = q.shape
    Lk = k.shape[2]
    if do.stride(-1) != 1 or do.data_ptr() % 16 or any(s % 8 for s in do.stride()[:3]):
        do = do.contiguous()
    dq = _heads_layout(B, H, L, D, q.dtype, q.device)
    dk = _heads_layout(B, H, Lk, D, q.dtype, q.device)
    dv = _heads_layout(B, H, Lk, D, q.dtype, q.device)
    # each row's (m, 1/l, delta): written by the dQ kernel, read by dK/dV
    stat = torch.empty((B, H, L, 4), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ml.data_ptr(), stat.data_ptr(),
            qm.data_ptr(), kbits.data_ptr(), dead.data_ptr(), DTYPE_CODE[q.dtype], D,
            B, H, L, Lk, _strides(q, k, v, o, do, dq, dk, dv), ctypes.c_float(scale),
            int(causal), *extra, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{who} backward kernel launch failed: cudaError {err}")
    return dq, dk, dv


def launch_bwd(q, k, v, o, ml, qm, kbits, dead, do, scale, causal, rate, seed,
               head_stride=None):
    """The backward kernels (dQ, then dK/dV) on the forward's saved tensors
    and the output's cotangent ``do``: (dq, dk, dv) in q's dtype, each a
    [B, H, L, Dh] view of [B, L, H, Dh] memory. ``head_stride``: the
    dropout hash's (default H)."""
    H = q.shape[1]
    grads = run_bwd("ergm_block_mha_bwd", "block_mha", q, k, v, o, ml, qm, kbits, dead, do,
                    scale, causal,
                    *_dropout_args(rate, seed, H if head_stride is None else head_stride))
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return grads


class _BlockAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, qm, km, scale, causal, rate, seed, head_stride):
        o, ml, kbits, dead = run_fwd("ergm_block_mha_fwd", "block_mha", q, k, v, qm, km, scale,
                                     causal, *_dropout_args(rate, seed, head_stride))
        global LAUNCHES
        LAUNCHES += 1
        ctx.save_for_backward(q, k, v, o, ml, qm, kbits, dead)
        ctx.args = (scale, causal, rate, seed, head_stride)
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = launch_bwd(*ctx.saved_tensors, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def block_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              scale: Optional[float] = None, q_mask: Optional[torch.Tensor] = None,
              kv_mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
              dropout_seed: Optional[int] = None,
              dropout_head_stride: Optional[int] = None) -> torch.Tensor:
    """Differentiable masked attention over q [B, H, Lq, Dh], k/v
    [B, H, Lk, Dh] (strided views with a contiguous head dim are read in
    place). ``q_mask`` [B, Lq] and ``kv_mask`` [B, Lk]: 1 = real.
    ``dropout_seed``: an integer, needed when ``dropout_rate`` > 0;
    ``dropout_head_stride``: the hash's head stride (default H, see
    ``attention.dropout_keep``: a shard of heads and rows draws the whole
    problem's masks with a folded seed and the global head count). The
    card takes the shapes of JAX's block gate (``supported``), at every
    head width a multiple of 8 up to 128 (padded to ``head_width(Dh)``).
    Returns [B, H, Lq, Dh]; on the card a view of [B, Lq, H, Dh'] memory
    (Dh' the padded width)."""
    B, H, lq, D = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if q.device.type == "cpu":
        return block_mha_reference(q, k, v, causal=causal, scale=float(scale), q_mask=q_mask,
                                   kv_mask=kv_mask, dropout_rate=dropout_rate,
                                   dropout_seed=dropout_seed,
                                   dropout_head_stride=dropout_head_stride)
    if k.shape[-1] != D or v.shape[-1] != D or not head_ok(D):
        raise ValueError(f"block_mha: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}; the kernels take one head width, a multiple of 8 "
                         f"up to 128")
    if not supported(q, k, v, causal=causal):
        raise ValueError(f"block_mha: q {tuple(q.shape)}, k {tuple(k.shape)} (causal={causal}) "
                         f"is outside the kernel's gate (JAX's block gate; flash_mha takes "
                         f"JAX's flash gate)")
    width = head_width(D)
    q, k, v, qm, km = operands("block_mha", q, k, v, q_mask, kv_mask, width)
    o = _BlockAttention.apply(q, k, v, qm, km, float(scale), bool(causal), float(dropout_rate),
                              int(dropout_seed or 0),
                              H if dropout_head_stride is None else int(dropout_head_stride))
    return o if width == D else o[..., :D]
