"""Fused LN2 + MLP + residual of a decode step: kernel K4 of the port.

Counterpart of ``ergm_tpu/ops/fused_decode.py``. ``fused_ln_mlp`` takes
the hidden states of a single-token step, h [B, 1, D], and returns
``h + c_proj(act(c_fc(LN2(h))))``. On a CUDA tensor it launches the
hand-written kernel in ``csrc/fused_decode.cu`` (see the note at the top
of that file), or raises; on a CPU tensor it runs
``fused_ln_mlp_reference``, the port's unfused layer_norm / dense /
activation composition.
"""

from __future__ import annotations

import ctypes

import torch

from ergm_tpu_torch.ops import _build

# Kernel launches since the last reset; a run sets it to 0 and reads it
# back to show that its path went through the kernel.
LAUNCHES = 0
# CUDA kernels the last call started (two: the up and the down projection)
KERNELS_PER_CALL = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supported(h: torch.Tensor, mlp, config) -> bool:
    """JAX's gate (``fused_decode.py:139-160``): single-token rows, a GELU
    activation, full-precision weights, D % 128, F % 128 and B % 8. The
    TPU's VMEM budget is not carried over: the CUDA kernel streams its
    weights through shared memory at any size."""
    if h.dim() != 3 or h.shape[1] != 1:
        return False
    if config.activation not in ("gelu_new", "gelu"):
        return False
    if mlp.c_fc.kernel_q is not None or mlp.c_proj.kernel_q is not None:
        return False
    D, F, B = h.shape[-1], mlp.c_fc.kernel.shape[-1], h.shape[0]
    return D % 128 == 0 and F % 128 == 0 and B % 8 == 0


def fused_ln_mlp_reference(h, ln, mlp, config):
    """The plain version: the model's own unfused decode tail."""
    from ergm_tpu_torch.models import gpt2  # gpt2 imports this module

    x = gpt2.layer_norm(h, ln, config.layer_norm_epsilon)
    return h + gpt2.dense(gpt2._activation(config.activation)(gpt2.dense(x, mlp.c_fc)),
                          mlp.c_proj)


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


def fused_ln_mlp(h: torch.Tensor, ln, mlp, config) -> torch.Tensor:
    """``h + mlp(layer_norm(h, ln))`` for a decode step, h [B, 1, D];
    returns the same shape. ``ln`` is a ``LayerNorm`` and ``mlp`` an ``MLP``
    module of the port. The caller checks ``supported`` first."""
    if h.device.type == "cpu":
        return fused_ln_mlp_reference(h, ln, mlp, config)
    B, _, D = h.shape
    fc, pr = mlp.c_fc, mlp.c_proj
    _check(h, {"ln.scale": ln.scale, "ln.bias": ln.bias, "c_fc.kernel": fc.kernel,
               "c_fc.bias": fc.bias, "c_proj.kernel": pr.kernel, "c_proj.bias": pr.bias})
    F = fc.kernel.shape[1]
    if (fc.kernel.shape != (D, F) or pr.kernel.shape != (F, D) or D % 64 or F % 64
            or config.activation not in ("gelu_new", "gelu")):
        raise ValueError(f"fused_ln_mlp: c_fc {tuple(fc.kernel.shape)}, c_proj "
                         f"{tuple(pr.kernel.shape)} and {config.activation!r} do not fit "
                         f"D={D} (D and F multiples of 64, a GELU)")
    act = torch.empty((B, F), dtype=h.dtype, device=h.device)  # stays in L2 between launches
    out = torch.empty((B, 1, D), dtype=h.dtype, device=h.device)
    lib = _build.load()
    started = ctypes.c_int(0)
    with torch.cuda.device(h.device):  # the C side launches on the current device
        err = lib.ergm_fused_ln_mlp(
            h.data_ptr(), h.stride(0), ln.scale.data_ptr(), ln.bias.data_ptr(),
            ctypes.c_float(config.layer_norm_epsilon), fc.kernel.data_ptr(),
            fc.bias.data_ptr(), pr.kernel.data_ptr(), pr.bias.data_ptr(), act.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[h.dtype], B, D, F,
            int(config.activation == "gelu_new"), ctypes.byref(started),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_ln_mlp kernel launch failed: cudaError {err}")
    global LAUNCHES, KERNELS_PER_CALL
    KERNELS_PER_CALL = started.value
    LAUNCHES += 1
    return out
