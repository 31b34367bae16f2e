"""Softmax cross-entropy over the tied vocab projection without [N, V]
logits: kernel K6 of the port.

Counterpart of ``ergm_tpu/ops/fused_ce.py``. ``fused_softmax_xent``
returns each token's NLL under softmax(h Wᵀ); its gradient flows to h
and W. On CUDA tensors it is a ``torch.autograd.Function`` whose forward
(per-token NLL and logZ) and backward are the hand-written kernels of
``csrc/fused_ce.cu`` (see the note at the top of that file), or raise.
In bf16 the backward walks the vocabulary in chunks of ``CHUNK``
columns (``vocab_chunks``; ``launch_bwd`` takes another width as
``chunk``), three tensor-core products per chunk: the
recomputed (p − onehot)·g rounded into a scratch buffer, dh += padj·W_c
into an f32 sum, and dW_c = padjᵀ·h. On CPU tensors it runs
``fused_softmax_xent_reference``, the dense f32 logsumexp − gold with
autograd. ``fused_lm_loss`` is the shifted, masked mean of
``chunked_lm_loss`` through it; ``fused_lm_loss_sharded`` the same mean
over a data-parallel mesh, each data rank running the kernel on its own
rows.

Widths: the card takes every hidden width D, as JAX's kernel does (GPT-2's
family, Cerebras-GPT-2.7B's 2,560, GPT-J's 4,096). The kernels take D a
multiple of 64, whole 64-deep stages of their
products (a partial last stage ran the products 1.3-1.5x slower on an
H100, PERF.md); for another D ``fused_softmax_xent`` pads h and W with
zero columns to the next multiple of 64 (``padded_width``): the zero
columns add nothing to the logits, and the gradients of the padding are
sliced away.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ergm_tpu_torch.ops import _build

# Calls since the last reset: forward and backward (each backward call
# launches its chunks' kernels).
LAUNCHES = 0
BWD_LAUNCHES = 0
# the kernels see hidden widths a multiple of DIM_STEP (their products'
# stage depth); the wrapper pads every other width to it
DIM_STEP = 64
# vocab columns per backward chunk by default (a multiple of the kernels'
# 256-column tile); its bf16 scratch is [N rounded up to 128, CHUNK],
# 403 MB at N = 24,576
CHUNK = 8192
_TILE_V = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def kernel_takes(hidden: torch.Tensor) -> bool:
    """Whether the kernels take ``hidden`` [N, D]: every width D (run at
    ``padded_width(D)``), as JAX's kernel, in float32 or bfloat16 (float16,
    which no path of ``ergm_tpu`` reaches, is not ported)."""
    return hidden.dtype in _DTYPE_CODE


def padded_width(D: int) -> int:
    """The width the kernels run ``D`` at: the next multiple of DIM_STEP."""
    return -(-D // DIM_STEP) * DIM_STEP


def vocab_chunks(V: int, chunk: int) -> list:
    """The backward's vocab chunks, (first row, width) in order: whole
    chunks of ``chunk`` columns, then the rest up to V."""
    if chunk <= 0 or chunk % _TILE_V:
        raise ValueError(f"chunk={chunk}: a positive multiple of {_TILE_V} is needed")
    return [(v0, min(chunk, V - v0)) for v0 in range(0, V, chunk)]


def fused_softmax_xent_reference(hidden: torch.Tensor, wte: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """The plain version: dense f32 logits, logsumexp − gold. A negative
    label has no gold logit (its NLL is logZ, as in the kernel) and no
    gradient."""
    logits = hidden.float() @ wte.float().t()
    logz = torch.logsumexp(logits, dim=-1)
    valid = labels >= 0
    gold = logits.gather(1, labels.clamp_min(0).long()[:, None])[:, 0]
    nll = logz - torch.where(valid, gold, 0.0)
    return torch.where(valid, nll, nll.detach())


def _check(hidden, wte, labels):
    for name, x in (("hidden", hidden), ("wte", wte), ("labels", labels)):
        if x.device.type != "cuda" or x.device != hidden.device:
            raise ValueError(f"fused_softmax_xent: {name} is on {x.device}, hidden on "
                             f"{hidden.device}")
    if hidden.dtype not in _DTYPE_CODE or wte.dtype != hidden.dtype:
        raise TypeError(f"fused_softmax_xent: hidden {hidden.dtype}, wte {wte.dtype}; float32 "
                        f"or bfloat16, both alike, are supported")
    if hidden.dim() != 2 or wte.dim() != 2 or wte.shape[1] != hidden.shape[1]:
        raise ValueError(f"fused_softmax_xent: hidden {tuple(hidden.shape)}, wte "
                         f"{tuple(wte.shape)}; want [N, D] and [V, D]")
    if labels.shape != hidden.shape[:1]:
        raise ValueError(f"fused_softmax_xent: labels {tuple(labels.shape)}, want "
                         f"[{hidden.shape[0]}]")


def _call(name, *args):
    err = getattr(_build.load(), name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _rows_padded(n: int) -> int:
    return -(-n // 128) * 128


def launch_fwd(hidden, wte, labels):
    """The forward kernels on checked contiguous operands whose D is a
    multiple of DIM_STEP: (nll, logz) [N] f32."""
    global LAUNCHES
    N, D = hidden.shape
    V = wte.shape[0]
    dev = hidden.device
    nll = torch.empty((N,), dtype=torch.float32, device=dev)
    logz = torch.empty((N,), dtype=torch.float32, device=dev)
    # the bf16 route's (max, sum, gold) partial per token and 256 vocab columns
    part = (torch.empty((3, -(-V // _TILE_V), _rows_padded(N)), dtype=torch.float32, device=dev)
            if hidden.dtype == torch.bfloat16 else None)
    with torch.cuda.device(dev):
        _call("ergm_xent_fwd", hidden.data_ptr(), wte.data_ptr(), labels.data_ptr(),
              nll.data_ptr(), logz.data_ptr(), None if part is None else part.data_ptr(),
              _DTYPE_CODE[hidden.dtype], N, V, D)
    LAUNCHES += 1
    return nll, logz


def launch_bwd(hidden, wte, labels, logz, g, chunk: int = CHUNK):
    """The backward kernels: (dh, dW) in hidden's and wte's dtype from the
    per-token cotangent ``g`` [N] f32 (D a multiple of DIM_STEP). bf16:
    vocab chunks of ``chunk`` columns in order, three products each; f32:
    one dh and one dW kernel."""
    global BWD_LAUNCHES
    N, D = hidden.shape
    V = wte.shape[0]
    dh, dw = torch.empty_like(hidden), torch.empty_like(wte)
    ptrs = (hidden.data_ptr(), wte.data_ptr(), labels.data_ptr(), logz.data_ptr(), g.data_ptr())
    with torch.cuda.device(hidden.device):
        if hidden.dtype == torch.float32:
            _call("ergm_xent_bwd_f32", *ptrs, dh.data_ptr(), 0, N, V, D)
            _call("ergm_xent_bwd_f32", *ptrs, dw.data_ptr(), 1, N, V, D)
        else:
            chunks = vocab_chunks(V, chunk)
            width = min(chunk, -(-V // _TILE_V) * _TILE_V)  # no wider than the vocab needs
            padj = torch.empty((_rows_padded(N), width), dtype=torch.bfloat16,
                               device=hidden.device)
            acc = (torch.empty((N, D), dtype=torch.float32, device=hidden.device)
                   if len(chunks) > 1 else None)
            for i, (v0, w) in enumerate(chunks):
                _call("ergm_xent_bwd_chunk", *ptrs, padj.data_ptr(),
                      None if acc is None else acc.data_ptr(), dh.data_ptr(), dw.data_ptr(),
                      N, V, D, v0, w, width, int(i == 0),
                      int(i == len(chunks) - 1))
    BWD_LAUNCHES += 1
    return dh, dw


class _FusedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, wte, labels):
        nll, logz = launch_fwd(hidden, wte, labels)
        ctx.save_for_backward(hidden, wte, labels, logz)
        return nll

    @staticmethod
    def backward(ctx, g):
        hidden, wte, labels, logz = ctx.saved_tensors
        dh, dw = launch_bwd(hidden, wte, labels, logz, g.float().contiguous())
        return dh, dw, None


def fused_softmax_xent(hidden: torch.Tensor, wte: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL [N] f32 of ``labels`` under softmax(hidden @ wteᵀ).

    hidden [N, D], wte [V, D] (one float dtype), labels [N] (negative =
    ignored: NLL logZ, zero gradient; callers mask). Differentiable in
    hidden and wte; dh comes back in hidden's dtype, dW in wte's. On the
    card D runs at ``padded_width(D)``."""
    if hidden.device.type == "cpu":
        return fused_softmax_xent_reference(hidden, wte, labels)
    _check(hidden, wte, labels)
    D = hidden.shape[1]
    width = padded_width(D)
    hidden, wte = hidden.contiguous(), wte.contiguous()
    if width != D:  # differentiable: the padding's gradient is dropped
        hidden, wte = F.pad(hidden, (0, width - D)), F.pad(wte, (0, width - D))
    if hidden.data_ptr() % 16 or wte.data_ptr() % 16:
        raise ValueError("fused_softmax_xent: the kernels load rows 16 bytes at a time; hidden "
                         "and wte must start 16-byte aligned")
    return _FusedXent.apply(hidden, wte, labels.to(torch.int32).contiguous())


def masked_nll_sums(hidden: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                    ignore_index: int = -100) -> tuple:
    """(sum of the shifted targets' NLL, their count) through
    ``fused_softmax_xent``: position t is scored against labels[t+1]."""
    B, L, D = hidden.shape
    shifted = torch.cat([labels[:, 1:], torch.full((B, 1), ignore_index, dtype=labels.dtype,
                                                   device=labels.device)], dim=1).reshape(-1)
    nll = fused_softmax_xent(hidden.reshape(B * L, D), wte, shifted)
    mask = (shifted != ignore_index).float()
    return (nll * mask).sum(), mask.sum()


def fused_lm_loss(hidden: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Shifted LM cross-entropy through ``fused_softmax_xent``, the
    semantics of ``chunked_lm_loss``: position t is scored against
    labels[t+1], mean over non-ignored targets."""
    s, n = masked_nll_sums(hidden, wte, labels, ignore_index)
    return s / torch.clamp_min(n, 1.0)


def fused_lm_loss_sharded(hidden: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                          mesh, ignore_index: int = -100,
                          data_axis: str = "data") -> torch.Tensor:
    """``fused_lm_loss`` under data parallelism (``ergm_tpu/ops/
    fused_ce.py:310``): ``hidden`` and ``labels`` are this data rank's
    rows, ``wte`` the replicated table. Each rank runs the kernel on its
    rows for the masked NLL sum s and count n; (s, n) are all-reduced
    over the data group and the value is S / max(N, 1), the mean over the
    global count of targets. Its gradient is this rank's part, ds / N
    (``parallel.collectives.global_mean``): the data-parallel gradient
    reduction sums the ranks'. A mesh with another axis of size > 1
    raises JAX's ``ValueError`` (the chunked loss serves tensor
    parallelism)."""
    from ergm_tpu_torch.parallel.collectives import global_mean

    nontrivial = [a for a in mesh.axis_names if a != data_axis and mesh.shape[a] > 1]
    if data_axis not in mesh.axis_names or nontrivial:
        raise ValueError(
            f"fused_lm_loss_sharded needs a pure '{data_axis}' mesh; "
            f"got axes {dict(mesh.shape)} (use the chunked loss under TP)")
    s, n = masked_nll_sums(hidden, wte, labels, ignore_index)
    return global_mean(s, n, mesh.group(data_axis))
