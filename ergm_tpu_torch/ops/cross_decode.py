"""Fused cross-attention sublayer of a decode step: kernel K3 of the port.

Counterpart of ``ergm_tpu/ops/cross_decode.py``. ``fused_cross_decode``
takes the hidden states of a single-token step, h [B, 1, D], and layer
``li`` of the int8 cross cache, and returns
``h + gate(c_proj(attn(q_attn(ln_cross(h)))))``. On a CUDA tensor it
launches the hand-written kernel in ``csrc/cross_decode.cu`` (see the
note at the top of that file), or raises; on a CPU tensor it runs
``fused_cross_decode_reference``, the model's own unfused sublayer.

``cross_attention_decode`` is the attention step of that sublayer in
plain torch ops; the model's single-token cross branch calls it for
every cross cache (int8 or not).

The tensor-parallel form (``group``: a model axis's process group) runs
on a model rank's heads: ``q_attn`` [D, H_local * 64], ``c_proj``
[H_local * 64, D] and a cross cache of those heads. The kernel writes
c_proj's f32 partial product (``fused_cross_decode_partial``; plain
version ``fused_cross_decode_partial_reference``), and K4's
``reduce_partial`` sums the partials over the group BEFORE the bias, the
capless-row gate and the residual, which it then adds in the order the
kernel's own epilogue uses.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import torch

from ergm_tpu_torch.core.mesh import head_groups
from ergm_tpu_torch.ops import _build
from ergm_tpu_torch.ops.fused_decode import reduce_partial

# Caption keys the kernel takes: its scores for one row sit in shared memory.
MAX_CAPTION = 1024
# Kernel launches since the last reset; a run sets it to 0 and reads it
# back to show that its path went through the kernel. TP_LAUNCHES counts
# the launches of the tensor-parallel form among them.
LAUNCHES = 0
TP_LAUNCHES = 0
# CUDA kernels the last call started (three: q projection, attention, c_proj)
KERNELS_PER_CALL = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supported(h: torch.Tensor, blk, stacks: Optional[Sequence[torch.Tensor]], config,
              parts: int = 1) -> bool:
    """JAX's gate (``cross_decode.py:207-235``): opt-in through
    ``ERGM_CROSS_KERNEL`` (unset, "0" or "false" is off), single-token
    rows, a quantized cross cache (four stacks: codes and scales),
    full-precision weights, D = n_head * head_dim with D % 128 and
    head_dim % 8. JAX's padded-scale and VMEM checks are TPU workarounds
    and are not carried over; the kernel's own limit is ``MAX_CAPTION``.
    Over a model axis of ``parts`` ranks the gate reads the model's
    config and says no on every rank where some rank's head width is not
    a multiple of 64, the kernel's column tile."""
    ov = os.environ.get("ERGM_CROSS_KERNEL")
    if ov is None or ov in ("0", "false"):
        return False
    if stacks is None or len(stacks) != 4:
        return False
    if h.dim() != 3 or h.shape[1] != 1:
        return False
    ca = blk.cross_attn
    if ca.q_attn.kernel_q is not None or ca.c_proj.kernel_q is not None:
        return False
    D = h.shape[-1]
    if D != config.n_head * config.head_dim or D % 128 or config.head_dim % 8:
        return False
    if any((hi - lo) * config.head_dim % 64 for lo, hi in head_groups(config.n_head, parts)):
        return False
    return stacks[0].shape[2] <= MAX_CAPTION


def cross_attention_decode(qf: torch.Tensor, cached_kv: Sequence[torch.Tensor],
                           enc_mask: Optional[torch.Tensor], scale, n_head: int) -> torch.Tensor:
    """Single-token attention over the merged cross cache: qf [B, D], ck/cv
    [B, Lc, D] (int8 with per-(token, head) f32 scales [B, Lc, H] when
    ``cached_kv`` has four entries). Reduces within the merged minor dim;
    the int8 scales factor out of both reductions. Returns [B, D] in qf's
    dtype."""
    B, D = qf.shape
    ck, cv = cached_kv[0], cached_kv[1]
    Lc = ck.shape[1]
    s = (ck.float() * qf.float()[:, None, :]).view(B, Lc, n_head, D // n_head).sum(-1) * scale
    if len(cached_kv) == 4:
        s = s * cached_kv[2].float()
    if enc_mask is not None:
        s = s + (1.0 - enc_mask.float())[:, :, None] * -1e9
    pr = torch.softmax(s, dim=1)  # over Lc
    if len(cached_kv) == 4:
        pr = pr * cached_kv[3].float()
    w = pr[..., None].expand(B, Lc, n_head, D // n_head).reshape(B, Lc, D)
    return (cv.float() * w).sum(dim=1).to(qf.dtype)


def fused_cross_decode_reference(h, blk, li, scale, stacks, mask, config, group=None):
    """The plain version: the model's unfused cross sublayer over layer
    ``li`` of the stacked cache, plus the residual; with ``group``, the
    plain partial forms through ``reduce_partial``."""
    from ergm_tpu_torch.models import gpt2  # gpt2 imports this module

    if group is not None:
        return reduce_partial(
            h, fused_cross_decode_partial_reference(h, blk, li, scale, stacks, mask, config),
            blk.cross_attn.c_proj.bias, group, mask)
    ca = blk.cross_attn
    x = gpt2.layer_norm(h, blk.ln_cross, config.layer_norm_epsilon)
    qf = gpt2.dense(x, ca.q_attn)[:, 0, :]
    out = cross_attention_decode(qf, [s[li] for s in stacks], mask, scale, config.n_head)
    return h + gpt2._capless_row_gate(gpt2.dense(out[:, None, :], ca.c_proj), mask)


def fused_cross_decode_partial_reference(h, blk, li, scale, stacks, mask, config):
    """The plain version of the partial form: this rank's heads through
    ln_cross, ``q_attn`` and the attention, then its rows of ``c_proj`` as
    an f32 product [B, 1, D] without the bias, the gate or the residual."""
    from ergm_tpu_torch.models import gpt2  # gpt2 imports this module

    ca = blk.cross_attn
    x = gpt2.layer_norm(h, blk.ln_cross, config.layer_norm_epsilon)
    qf = gpt2.dense(x, ca.q_attn)[:, 0, :]
    out = cross_attention_decode(qf, [s[li] for s in stacks], mask, scale,
                                 qf.shape[-1] // config.head_dim)
    w = gpt2.dense_weight(ca.c_proj, h.dtype)
    return gpt2.matmul_f32(out, w)[:, None, :]


def _check(h, blk, stacks, mask, li, config, partial=False):
    if h.device.type != "cuda":
        raise ValueError(f"fused_cross_decode: h is on {h.device}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_cross_decode: h is {h.dtype}; float32 or bfloat16 are "
                        f"supported")
    if h.dim() != 3 or h.shape[1] != 1 or h.stride(-1) != 1:
        raise ValueError(f"fused_cross_decode: h has shape {tuple(h.shape)} and strides "
                         f"{h.stride()}; want [B, 1, D] with a contiguous feature axis")
    B, _, D = h.shape
    ca = blk.cross_attn
    Dh = config.head_dim
    Dl = ca.q_attn.kernel.shape[1] if ca.q_attn.kernel is not None else -1
    H = Dl // Dh
    if D % 64 or Dh % 8 or Dl % 64 or Dl < Dh or (not partial and Dl != D):
        raise ValueError(f"fused_cross_decode: D={D}, heads' width {Dl}, head_dim={Dh}; want "
                         f"D and the heads' width multiples of 64 (equal unless partial) "
                         f"and head_dim % 8 == 0")
    for name, x, shape in (("ln_cross.scale", blk.ln_cross.scale, (D,)),
                           ("ln_cross.bias", blk.ln_cross.bias, (D,)),
                           ("q_attn.kernel", ca.q_attn.kernel, (D, Dl)),
                           ("q_attn.bias", ca.q_attn.bias, (Dl,)),
                           ("c_proj.kernel", ca.c_proj.kernel, (Dl, D)),
                           ("c_proj.bias", ca.c_proj.bias, (D,))):
        if (x is None or x.device != h.device or x.dtype != h.dtype or not x.is_contiguous()
                or tuple(x.shape) != shape):
            raise ValueError(f"fused_cross_decode: {name} must be a contiguous {h.dtype} "
                             f"{shape} tensor on {h.device}")
    _build.check_aligned("fused_cross_decode",
                         {"h": h, "ln_cross.scale": blk.ln_cross.scale,
                          "ln_cross.bias": blk.ln_cross.bias, "q_attn.kernel": ca.q_attn.kernel,
                          "q_attn.bias": ca.q_attn.bias, "c_proj.kernel": ca.c_proj.kernel,
                          "c_proj.bias": ca.c_proj.bias}, h.stride(0))
    if len(stacks) != 4:
        raise ValueError("fused_cross_decode: needs the quantized cache (ck, cv, ck_scale, "
                         "cv_scale)")
    L, Lc = stacks[0].shape[0], stacks[0].shape[2]
    for name, x, dtype, shape in (("ck", stacks[0], torch.int8, (L, B, Lc, Dl)),
                                  ("cv", stacks[1], torch.int8, (L, B, Lc, Dl)),
                                  ("ck_scale", stacks[2], torch.float32, (L, B, Lc, H)),
                                  ("cv_scale", stacks[3], torch.float32, (L, B, Lc, H))):
        if (x.device != h.device or x.dtype != dtype or not x.is_contiguous()
                or tuple(x.shape) != shape):
            raise ValueError(f"fused_cross_decode: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {h.device}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if not 0 <= li < L or not 1 <= Lc <= MAX_CAPTION:
        raise ValueError(f"fused_cross_decode: layer {li} of {L}, {Lc} caption keys "
                         f"(1..{MAX_CAPTION})")
    if mask is not None and (tuple(mask.shape) != (B, Lc) or mask.device != h.device):
        raise ValueError(f"fused_cross_decode: mask {tuple(mask.shape)} on {mask.device} "
                         f"does not match [{B}, {Lc}] on {h.device}")


def fused_cross_decode(h: torch.Tensor, blk, li: int, scale,
                       stacks: Sequence[torch.Tensor], mask: Optional[torch.Tensor],
                       config, group=None) -> torch.Tensor:
    """One cross sublayer step: returns ``h + cross_attn(ln_cross(h))``.

    ``h``: [B, 1, D]; ``blk``: the layer's ``Block`` (``ln_cross`` and
    ``cross_attn``); ``stacks``: the FULL stacked (ck, cv, ck_scale,
    cv_scale), [L, B, Lc, D] int8 and [L, B, Lc, H] f32, of which layer
    ``li`` is read in place; ``mask``: [B, Lc] 0/1, or None when every
    caption key is real; ``scale``: float or 0-dim tensor. The caller
    checks ``supported`` first. ``group``: the model axis's process group
    when ``blk`` and ``stacks`` hold this rank's heads (the
    tensor-parallel form)."""
    if group is not None:
        return reduce_partial(
            h, fused_cross_decode_partial(h, blk, li, scale, stacks, mask, config),
            blk.cross_attn.c_proj.bias, group, mask)
    if h.device.type == "cpu":
        return fused_cross_decode_reference(h, blk, li, scale, stacks, mask, config)
    return _launch(h, blk, li, scale, stacks, mask, config, partial=False)


def fused_cross_decode_partial(h: torch.Tensor, blk, li: int, scale,
                               stacks: Sequence[torch.Tensor], mask: Optional[torch.Tensor],
                               config) -> torch.Tensor:
    """This model rank's f32 partial [B, 1, D] of the sublayer's c_proj (no
    bias, gate or residual) from its heads: the kernel on a CUDA tensor,
    the plain version on a CPU one."""
    if h.device.type == "cpu":
        return fused_cross_decode_partial_reference(h, blk, li, scale, stacks, mask, config)
    return _launch(h, blk, li, scale, stacks, mask, config, partial=True)


def _launch(h, blk, li, scale, stacks, mask, config, partial: bool) -> torch.Tensor:
    _check(h, blk, stacks, mask, li, config, partial)
    B, _, D = h.shape
    ck, cv, ks, vs = stacks
    Lc, Dl = ck.shape[2], ck.shape[3]
    m = None if mask is None else mask.to(torch.float32).contiguous()
    qa = torch.empty((B, Dl), dtype=h.dtype, device=h.device)  # q, then the attention output
    out = torch.empty((B, 1, D), dtype=torch.float32 if partial else h.dtype, device=h.device)
    ca = blk.cross_attn
    lib = _build.load()
    started = ctypes.c_int(0)
    with torch.cuda.device(h.device):  # the C side launches on the current device
        err = lib.ergm_fused_cross_decode(
            h.data_ptr(), h.stride(0), blk.ln_cross.scale.data_ptr(),
            blk.ln_cross.bias.data_ptr(), ctypes.c_float(config.layer_norm_epsilon),
            ca.q_attn.kernel.data_ptr(), ca.q_attn.bias.data_ptr(),
            ca.c_proj.kernel.data_ptr(), None if partial else ca.c_proj.bias.data_ptr(),
            ck[li].data_ptr(), cv[li].data_ptr(), ks[li].data_ptr(), vs[li].data_ptr(),
            None if m is None else m.data_ptr(), qa.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[h.dtype], B, Lc, Dl // config.head_dim, config.head_dim, D,
            int(partial), ctypes.c_float(float(scale)), ctypes.byref(started),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_cross_decode kernel launch failed: cudaError {err}")
    global LAUNCHES, TP_LAUNCHES, KERNELS_PER_CALL
    KERNELS_PER_CALL = started.value
    LAUNCHES += 1
    TP_LAUNCHES += partial
    return out
