"""Masked attention with probability dropout, forward and backward:
kernel K5 of the port, which also serves the shapes of JAX's library
flash kernel (K7).

Counterpart of ``ergm_tpu/ops/block_attention.py`` (``block_mha``) and,
inside ``flash_supported``, of ``ergm_tpu/ops/flash_attention.py``
(``flash_mha``): the TPU needs a second kernel where the block kernel's
VMEM runs out, a tiled CUDA kernel does not. The training path's
self-attention runs here: causal, q/kv 0/1 masks, zero output and
gradient for padded query rows, and attention-probability dropout whose
keep mask comes from the counter hash of ``ops/attention.py::dropout_keep``.
On CUDA tensors ``block_mha`` is a ``torch.autograd.Function`` whose
forward and backward launch the hand-written kernels of
``csrc/block_attention.cu`` (see the note at the top of that file), or
raise; on CPU tensors it runs ``block_mha_reference``, the same math in
differentiable plain torch.

Head widths, in float32 and bfloat16: the card takes every head width of
JAX's block gate, a multiple of 8 up to 128 (``head_ok``, with dropout),
and every width of JAX's flash domain, the widths JAX's library kernel
takes: any below 128 and any multiple of 128 (``flash_head_ok``, without
dropout). The kernels are built for ``HEAD_DIMS``; below 128
``block_mha`` pads q, k and v with zero columns to the next of them
(``head_width``) and slices the output back, with the softmax scale of
the true width: the zero columns add nothing to q·kᵀ, and their output
and gradient columns are dropped. A multiple of 128 above it runs as it
is (the note at the top of the CUDA source): in bf16 at 256 and 384 on
the one-pass kernels (``flash_route``), which compute what JAX's library
flash kernel computes (``flash_mha_reference``), else in column groups
of 128. Above 128, a width that is not a multiple of 128 is in neither
domain (JAX's library kernel raises there).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ergm_tpu_torch.ops import _build
from ergm_tpu_torch.ops.attention import _NEG_INF, dropout_keep, dropout_threshold, matmul_f32

HEAD_DIMS = (32, 64, 96, 128)  # the head widths the CUDA kernels are built for
# The one-pass kernels' head widths (flash_route) and the keys of a tile
# there, their plain version's block
FLASH_TILES = {256: 64, 384: 32}
# Launches since the last reset: forward kernels, and backward calls (each
# runs the dQ kernel, then the dK/dV kernel). A run sets them to 0 and
# reads them back to show that its path went through the kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def head_ok(D: int) -> bool:
    """The head widths of JAX's block gate, which the kernels take: a
    multiple of 8 up to 128."""
    return 8 <= D <= 128 and D % 8 == 0


def flash_head_ok(D: int) -> bool:
    """The head widths of JAX's flash domain, those its library kernel
    takes, which the kernels take without dropout: any below 128 and any
    multiple of 128."""
    return 1 <= D < 128 or (D >= 128 and D % 128 == 0)


def kernel_takes(q) -> bool:
    """Whether the kernels take q inside JAX's block gate: its head width
    and dtype (float32 or bfloat16; float16, which JAX's kernels take and
    no path of ``ergm_tpu`` reaches, is not ported)."""
    return head_ok(q.shape[-1]) and q.dtype in _DTYPE_CODE


def flash_kernel_takes(q) -> bool:
    """Whether the kernels take q inside JAX's flash gate: ``flash_head_ok``
    and the dtype."""
    return flash_head_ok(q.shape[-1]) and q.dtype in _DTYPE_CODE


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


def _masks(q, k, q_mask, kv_mask):
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
    qm, km = _masks(q, k, q_mask, kv_mask)
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


def flash_route(D: int, dtype) -> bool:
    """Whether the card runs head width ``D`` in ``dtype`` on the one-pass
    kernels, the arithmetic of JAX's library flash kernel
    (``flash_mha_reference``): bf16 at Dh = 256 and 384. Every other width
    and dtype runs K5's two-pass arithmetic (``block_mha_reference``)."""
    return D in FLASH_TILES and dtype == torch.bfloat16


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
    The port's masking: padded query rows give zeros and no gradient, real
    rows that see no real key (dead) spread over every key, and a masked
    score's ds is 0 (JAX's segment ids differ on those rows only).
    ``block_k`` defaults to the kernels' tile at q's width (FLASH_TILES;
    64 elsewhere)."""
    D, lk = q.shape[-1], k.shape[2]
    if block_k is None:
        block_k = FLASH_TILES.get(D, 64)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if lk % block_k:
        raise ValueError(f"flash_mha_reference: Lk = {lk} is not a multiple of {block_k}")
    qm, km = _masks(q, k, q_mask, kv_mask)
    return _FlashReference.apply(q, k, v, qm, km, float(scale), bool(causal), int(block_k))


def kernel_reference(q, k, v, **kw):
    """The plain version of what ``block_mha`` runs on the card for q's
    width and dtype: ``flash_mha_reference`` on the one-pass route
    (``flash_route``), else ``block_mha_reference``."""
    if flash_route(q.shape[-1], q.dtype) and not kw.get("dropout_rate"):
        return flash_mha_reference(q, k, v, causal=kw["causal"], scale=kw.get("scale"),
                                   q_mask=kw.get("q_mask"), kv_mask=kw.get("kv_mask"))
    return block_mha_reference(q, k, v, **kw)


def _check(name, x, like, shape):
    if x.device.type != "cuda" or x.device != like.device:
        raise ValueError(f"block_mha: {name} is on {x.device}, q on {like.device}")
    if x.dtype != like.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"block_mha: {name} is {x.dtype}; float32 or bfloat16, all alike, "
                        f"are supported")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"block_mha: {name} has shape {tuple(x.shape)}, want {tuple(shape)}")
    vec = 16 // x.element_size()  # the kernel loads rows 16 bytes at a time
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(s % vec for s in x.stride()[:3]):
        raise ValueError(f"block_mha: {name} needs a contiguous head dim and 16-byte aligned "
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


def launch_bwd(q, k, v, o, ml, qm, kbits, dead, do, scale, causal, rate, seed,
               head_stride=None):
    """The backward kernels (dQ, then dK/dV) on the forward's saved tensors
    and the output's cotangent ``do``: (dq, dk, dv) in q's dtype, each a
    [B, H, L, Dh] view of [B, L, H, Dh] memory. ``head_stride``: the
    dropout hash's (default H)."""
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
        err = lib.ergm_block_mha_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ml.data_ptr(), stat.data_ptr(),
            qm.data_ptr(), kbits.data_ptr(), dead.data_ptr(), _DTYPE_CODE[q.dtype], D,
            B, H, L, Lk,
            _strides(q, k, v, o, do, dq, dk, dv), ctypes.c_float(scale), int(causal),
            *_dropout_args(rate, seed, H if head_stride is None else head_stride),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"block_mha backward kernel launch failed: cudaError {err}")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv


class _BlockAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, qm, km, scale, causal, rate, seed, head_stride):
        B, H, L, D = q.shape
        Lk = k.shape[2]
        o = _heads_layout(B, H, L, D, q.dtype, q.device)
        ml = torch.empty((2, B, H, L), dtype=torch.float32, device=q.device)
        # the key mask as bits and where each batch row's dead rows end (real
        # causal rows before the first real key): the forward's pre-pass
        # writes them, the backward reads them
        kbits = torch.empty((B, Lk // 32), dtype=torch.int32, device=q.device)
        dead = torch.empty((B,), dtype=torch.int32, device=q.device)
        lib = _build.load()
        with torch.cuda.device(q.device):
            err = lib.ergm_block_mha_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ml.data_ptr(),
                qm.data_ptr(), km.data_ptr(), kbits.data_ptr(), dead.data_ptr(),
                _DTYPE_CODE[q.dtype], D, B, H, L, Lk, _strides(q, k, v, o), ctypes.c_float(scale),
                int(causal), *_dropout_args(rate, seed, head_stride),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"block_mha forward kernel launch failed: cudaError {err}")
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
    card takes the shapes of either gate (``supported``, or
    ``flash_supported`` without dropout), at every head width a multiple
    of 8 up to 128 and, without dropout, at the widths of ``flash_head_ok``
    (padded to ``head_width(Dh)``). Returns [B, H, Lq, Dh]; on the card a
    view of [B, Lq, H, Dh'] memory (Dh' the padded width)."""
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
    if k.shape[-1] != D or v.shape[-1] != D or not (head_ok(D) or flash_head_ok(D)):
        raise ValueError(f"block_mha: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}; the kernels take one head width, a multiple of 8 "
                         f"up to 128, or without dropout any below 128 or a multiple of 128")
    if not (supported(q, k, v, causal=causal)
            or flash_supported(q, k, v, causal=causal, dropout_active=dropout_rate > 0.0)):
        raise ValueError(f"block_mha: q {tuple(q.shape)}, k {tuple(k.shape)} (causal={causal}, "
                         f"dropout {dropout_rate}) is outside the kernel's gates")
    width = head_width(D)
    if width != D:  # differentiable: the padding's gradient is dropped
        q, k, v = (F.pad(x, (0, width - D)) for x in (q, k, v))
    _check("q", q, q, (B, H, lq, width))
    _check("k", k, q, (B, H, lk, width))
    _check("v", v, q, (B, H, lk, width))
    for name, m, n in (("q_mask", q_mask, lq), ("kv_mask", kv_mask, lk)):
        if m is not None and (tuple(m.shape) != (B, n) or m.device != q.device):
            raise ValueError(f"block_mha: {name} {tuple(m.shape)} on {m.device}, want "
                             f"[{B}, {n}] on {q.device}")
    qm, km = _masks(q, k, q_mask, kv_mask)
    o = _BlockAttention.apply(q, k, v, qm, km, float(scale), bool(causal), float(dropout_rate),
                              int(dropout_seed or 0),
                              H if dropout_head_stride is None else int(dropout_head_stride))
    return o if width == D else o[..., :D]
