"""Fused LN2 + MLP + residual of a decode step: kernel K4 of the port.

Counterpart of ``ergm_tpu/ops/fused_decode.py``. ``fused_ln_mlp`` takes
the hidden states of a single-token step, h [B, 1, D], and returns
``h + c_proj(act(c_fc(LN2(h))))``. On a CUDA tensor it launches the
hand-written kernel in ``csrc/fused_decode.cu`` (see the note at the top
of that file), or raises; on a CPU tensor it runs
``fused_ln_mlp_reference``, the port's unfused layer_norm / dense /
activation composition.

The tensor-parallel form (``group``: a model axis's process group) runs
on a model rank's F/parts columns of ``c_fc`` and rows of ``c_proj``:
the kernel writes the down projection's f32 partial product
(``fused_ln_mlp_partial``; plain version ``fused_ln_mlp_partial_reference``),
``reduce_partial`` sums the partials over the group and ``finish_partial``
adds the bias and the residual in the order the kernel's own epilogue
uses, so that the one difference from the one-card kernel is the order
of the summation. K3's tensor-parallel form finishes through the same
two functions, with its capless-row gate.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ergm_tpu_torch.core.mesh import head_groups
from ergm_tpu_torch.ops import _build
from ergm_tpu_torch.parallel.collectives import reduce_from_model

# Kernel launches since the last reset; a run sets it to 0 and reads it
# back to show that its path went through the kernel. TP_LAUNCHES counts
# the launches of the tensor-parallel form among them.
LAUNCHES = 0
TP_LAUNCHES = 0
# CUDA kernels the last call started (two: the up and the down projection)
KERNELS_PER_CALL = 0
# The plans the last bf16 call ran with (``plan``): its up and down projections
LAST_PLANS = None
# What the C side reported of the last call's launches (seven ints: the
# kernels started, then each launch's grid x, grid y and cluster size)
LAST_GRID = None
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 product's grid (csrc/dense_hopper.cuh): a CTA covers NT columns
# (64 or 128) of up to TILE_ROWS rows and a contiguous share of K's
# CHUNK-deep chunks; K splits over a cluster of at most MAX_CLUSTER CTAs.
CHUNK, TILE_ROWS, MAX_CLUSTER = 64, 256, 8


class Plan(NamedTuple):
    """One product's grid: ``nt`` columns a CTA, K split ``splits`` ways (a
    column tile's CTAs, one cluster), ``cn`` column tiles a cluster (the
    LayerNorm statistics are shared over it)."""
    nt: int
    splits: int
    cn: int


def _rows_padded(rows: int) -> int:
    """The rows a CTA's A stage holds: 64, 128 or 256."""
    return 64 if rows <= 64 else 128 if rows <= 128 else 256


@functools.lru_cache(maxsize=256)
def plan(M: int, K: int, N: int, ln: bool, capacity: tuple) -> Plan:
    """The grid of one bf16 product out[M, N] = A[M, K] @ W[K, N] (``ln``:
    with the LayerNorm prologue) on a card that holds ``capacity[c - 1]``
    CTAs at once in clusters of c. Among the plans that take one wave
    (column tiles x splits x row tiles within the capacity of their
    cluster size) it takes the one with the most CTAs; ties go to the
    fewest bytes a CTA streams (its A and W chunks), then to fewer splits,
    then to the wider cluster (the LayerNorm statistics shared over more
    CTAs). Where no plan takes one wave, the fewest CTAs."""
    mt = -(-M // TILE_ROWS)
    pad = _rows_padded(min(M, TILE_ROWS))
    nk = K // CHUNK
    cands = []
    for nt in (64, 128):
        if N % nt:
            continue
        tiles = N // nt
        for splits in range(1, min(MAX_CLUSTER, nk) + 1):
            nbytes = -(-nk // splits) * CHUNK * 2 * (nt + pad)  # a CTA's most chunks
            for cn in range(1, MAX_CLUSTER // splits + 1) if ln else (1,):
                if tiles % cn == 0:
                    n = tiles * splits * mt
                    cands.append((n <= capacity[splits * cn - 1], n, nbytes, splits, -cn,
                                  Plan(nt, splits, cn)))
    if not cands:
        raise ValueError(f"fused_ln_mlp: no plan for M={M}, K={K}, N={N}")
    wave = [c for c in cands if c[0]]
    if wave:
        return min(wave, key=lambda c: (-c[1], *c[2:5]))[5]
    return min(cands, key=lambda c: c[1:5])[5]


@functools.cache
def capacity(device: torch.device) -> tuple:
    """How many CTAs of the bf16 product (one an SM) ``device`` holds at
    once in clusters of 1..MAX_CLUSTER (``cudaOccupancyMaxActiveClusters``
    times the size): a cluster's CTAs share a GPC, so a size that does
    not divide the GPCs' SM counts leaves SMs idle."""
    lib = _build.load()
    out = []
    with torch.cuda.device(device):
        for c in range(1, MAX_CLUSTER + 1):
            n = ctypes.c_int(0)
            err = lib.ergm_fused_ln_mlp_clusters(c, ctypes.byref(n))
            if err:
                raise RuntimeError(f"fused_ln_mlp: cluster occupancy query failed: cudaError {err}")
            out.append(c * n.value)
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _plans(B: int, D: int, F: int, index: int) -> tuple:
    """The up and down projections' plans on CUDA device ``index``, and
    the same packed as the C side reads them (one lookup a call)."""
    cap = capacity(torch.device("cuda", index))
    up, down = plan(B, D, F, True, cap), plan(B, F, D, False, cap)
    return (up, down), (ctypes.c_int * 5)(up.nt, up.splits, up.cn, down.nt, down.splits)


def supported(h: torch.Tensor, mlp, config, batch: Optional[int] = None, parts: int = 1) -> bool:
    """JAX's gate (``fused_decode.py:139-160``): single-token rows, a GELU
    activation, full-precision weights, D % 128, F % 128 and B % 8. The
    TPU's VMEM budget is not carried over: the CUDA kernel streams its
    weights through shared memory at any size.

    Over a mesh ``batch`` is the global batch and ``parts`` the model
    axis: the gate reads the model's F, and says no on every rank where
    some rank's F_local (``head_groups``) is not a multiple of 64, the
    kernel's column tile, so that no two ranks of a group part ways."""
    if h.dim() != 3 or h.shape[1] != 1:
        return False
    if config.activation not in ("gelu_new", "gelu"):
        return False
    if mlp.c_fc.kernel_q is not None or mlp.c_proj.kernel_q is not None:
        return False
    D, B = h.shape[-1], h.shape[0] if batch is None else batch
    F = config.inner_dim if parts > 1 else mlp.c_fc.kernel.shape[-1]
    if any((hi - lo) % 64 for lo, hi in head_groups(F, parts)):
        return False
    return D % 128 == 0 and F % 128 == 0 and B % 8 == 0


def fused_ln_mlp_reference(h, ln, mlp, config, group=None):
    """The plain version: the model's own unfused decode tail; with
    ``group``, the plain partial forms through ``reduce_partial``."""
    from ergm_tpu_torch.models import gpt2  # gpt2 imports this module

    if group is not None:
        return reduce_partial(h, fused_ln_mlp_partial_reference(h, ln, mlp, config),
                              mlp.c_proj.bias, group)
    x = gpt2.layer_norm(h, ln, config.layer_norm_epsilon)
    return h + gpt2.dense(gpt2._activation(config.activation)(gpt2.dense(x, mlp.c_fc)),
                          mlp.c_proj)


def fused_ln_mlp_partial_reference(h, ln, mlp, config):
    """The plain version of the partial form: this rank's columns through
    LN2, ``c_fc`` and the GELU, then its rows of ``c_proj`` as an f32
    product [B, 1, D] without the bias."""
    from ergm_tpu_torch.models import gpt2  # gpt2 imports this module

    x = gpt2.layer_norm(h, ln, config.layer_norm_epsilon)
    a = gpt2._activation(config.activation)(gpt2.dense(x, mlp.c_fc))
    w = gpt2.dense_weight(mlp.c_proj, h.dtype)
    return gpt2.matmul_f32(a.reshape(-1, a.shape[-1]), w).view(h.shape[0], 1, w.shape[1])


def finish_partial(h: torch.Tensor, total: torch.Tensor, bias: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``round(h + round(round(total + bias) * has_caption))`` from the
    summed f32 partials: the rounding points of the kernels' epilogues.
    ``mask`` is K3's caption mask [B, Lc] (None: no gate, as K4)."""
    from ergm_tpu_torch.models import gpt2  # gpt2 imports this module

    return h + gpt2._capless_row_gate((total + bias.float()).to(h.dtype), mask)


def reduce_partial(h: torch.Tensor, partial: torch.Tensor, bias: torch.Tensor, group,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tensor-parallel form's end: each model rank's f32 partial summed
    over ``group`` (Megatron's g), then ``finish_partial``."""
    return finish_partial(h, reduce_from_model(partial, group), bias, mask)


def _check(h, tensors):
    if h.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp: h is on {h.device}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_ln_mlp: h is {h.dtype}; float32 or bfloat16 are supported")
    if h.dim() != 3 or h.shape[1] != 1 or h.stride(-1) != 1:
        raise ValueError(f"fused_ln_mlp: h has shape {tuple(h.shape)} and strides "
                         f"{h.stride()}; want [B, 1, D] with a contiguous feature axis")
    for name, x in tensors.items():
        if x is None or x.device != h.device or x.dtype != h.dtype or not x.is_contiguous():
            raise ValueError(f"fused_ln_mlp: {name} must be a contiguous {h.dtype} tensor "
                             f"on {h.device}")
    _build.check_aligned("fused_ln_mlp", {"h": h, **tensors}, h.stride(0))


def fused_ln_mlp(h: torch.Tensor, ln, mlp, config, group=None) -> torch.Tensor:
    """``h + mlp(layer_norm(h, ln))`` for a decode step, h [B, 1, D];
    returns the same shape. ``ln`` is a ``LayerNorm`` and ``mlp`` an ``MLP``
    module of the port. The caller checks ``supported`` first. ``group``:
    the model axis's process group when ``mlp`` holds this rank's part
    (the tensor-parallel form)."""
    if group is not None:
        return reduce_partial(h, fused_ln_mlp_partial(h, ln, mlp, config), mlp.c_proj.bias,
                              group)
    if h.device.type == "cpu":
        return fused_ln_mlp_reference(h, ln, mlp, config)
    return _launch(h, ln, mlp, config, partial=False)


def fused_ln_mlp_partial(h: torch.Tensor, ln, mlp, config) -> torch.Tensor:
    """This model rank's f32 partial [B, 1, D] of the MLP's down projection
    (no bias, no residual): the kernel on a CUDA tensor, the plain version
    on a CPU one."""
    if h.device.type == "cpu":
        return fused_ln_mlp_partial_reference(h, ln, mlp, config)
    return _launch(h, ln, mlp, config, partial=True)


def _launch(h, ln, mlp, config, partial: bool) -> torch.Tensor:
    B, _, D = h.shape
    fc, pr = mlp.c_fc, mlp.c_proj
    _check(h, {"ln.scale": ln.scale, "ln.bias": ln.bias, "c_fc.kernel": fc.kernel,
               "c_fc.bias": fc.bias, "c_proj.kernel": pr.kernel,
               **({} if partial else {"c_proj.bias": pr.bias})})
    F = fc.kernel.shape[1]
    if (fc.kernel.shape != (D, F) or pr.kernel.shape != (F, D) or D % 64 or F % 64
            or config.activation not in ("gelu_new", "gelu")):
        raise ValueError(f"fused_ln_mlp: c_fc {tuple(fc.kernel.shape)}, c_proj "
                         f"{tuple(pr.kernel.shape)} and {config.activation!r} do not fit "
                         f"D={D} (D and F multiples of 64, a GELU)")
    act = torch.empty((B, F), dtype=h.dtype, device=h.device)  # stays in L2 between launches
    out = torch.empty((B, 1, D), dtype=torch.float32 if partial else h.dtype, device=h.device)
    lib = _build.load()
    info = (ctypes.c_int * 7)()
    plans, packed = _plans(B, D, F, h.device.index)
    with torch.cuda.device(h.device):  # the C side launches on the current device
        err = lib.ergm_fused_ln_mlp(
            h.data_ptr(), h.stride(0), ln.scale.data_ptr(), ln.bias.data_ptr(),
            ctypes.c_float(config.layer_norm_epsilon), fc.kernel.data_ptr(),
            fc.bias.data_ptr(), pr.kernel.data_ptr(), None if partial else pr.bias.data_ptr(),
            act.data_ptr(), out.data_ptr(), _DTYPE_CODE[h.dtype], B, D, F,
            int(config.activation == "gelu_new"), int(partial), packed, info,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_ln_mlp kernel launch failed: cudaError {err}")
    global LAUNCHES, TP_LAUNCHES, KERNELS_PER_CALL, LAST_PLANS, LAST_GRID
    KERNELS_PER_CALL = info[0]
    LAST_PLANS = plans if h.dtype == torch.bfloat16 else None
    LAST_GRID = info
    LAUNCHES += 1
    TP_LAUNCHES += partial
    return out
